"""Cluster object sources: the informer plane abstraction.

The reference's watch manager sits on controller-runtime dynamic informers
(pkg/watch/manager.go); here the equivalent seam is list + subscribe per
GVK.  Implementations:

- ``FakeCluster``: in-memory store with watch fan-out and replay on
  subscribe (the envtest equivalent for tests, and the watch source of the
  resident snapshot when the CLI runs over ``--manifests``).
- ``FileSource``: one-shot source reading YAML manifests from a directory
  or files (offline/demo runs).
- ``KubeCluster`` (``sync/kube.py``): the same surface over a live
  apiserver.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from gatekeeper_tpu_torch.utils.unstructured import (gvk_of, load_yaml_file,
                                                     name_of, namespace_of)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    obj: dict

    @property
    def gvk(self):
        return gvk_of(self.obj)


class FakeCluster:
    """In-memory API server: typed store + watch fan-out with replay.

    Mirrors the semantics the watch manager depends on (manager.go:147-202):
    a new subscriber for an already-stored GVK receives synthetic ADDED
    events replaying current state.
    """

    def __init__(self):
        self._objects: dict[tuple, dict] = {}  # (gvk, ns, name) -> obj
        self._subscribers: dict[tuple, list] = {}  # gvk -> [callback]
        self._lock = threading.RLock()

    def _key(self, obj: dict) -> tuple:
        return (gvk_of(obj), namespace_of(obj), name_of(obj))

    def apply(self, obj: dict) -> None:
        with self._lock:
            key = self._key(obj)
            existed = key in self._objects
            self._objects[key] = obj
            event = Event(MODIFIED if existed else ADDED, obj)
            subs = list(self._subscribers.get(key[0], ()))
        for cb in subs:
            cb(event)

    def delete(self, obj: dict) -> None:
        with self._lock:
            key = self._key(obj)
            if key not in self._objects:
                return
            stored = self._objects.pop(key)
            subs = list(self._subscribers.get(key[0], ()))
        for cb in subs:
            cb(Event(DELETED, stored))

    def list(self, gvk: Optional[tuple] = None) -> list:
        with self._lock:
            return [o for (g, _ns, _n), o in self._objects.items()
                    if gvk is None or g == gvk]

    def get(self, gvk: tuple, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._objects.get((gvk, namespace, name))

    def subscribe(self, gvk: tuple, callback: Callable[[Event], None],
                  replay: bool = True, from_rv: str = "",
                  seed_known=None) -> Callable[[], None]:
        """Register a watcher; replays current state as ADDED events
        (watch.replay semantics).  ``from_rv``/``seed_known`` (the
        warm-resume surface of a live-apiserver source): an in-memory store
        has no watch cache, so the resume degrades to the full replay —
        which the snapshot's no-op-patch detection absorbs — plus a
        synthetic DELETED for every ``seed_known`` key the store no longer
        holds (the vanished-object diff a real relist recovery yields)."""
        with self._lock:
            self._subscribers.setdefault(gvk, []).append(callback)
            current = [o for (g, _ns, _n), o in self._objects.items()
                       if g == gvk] if replay else []
            held = {(ns, n) for (g, ns, n) in self._objects
                    if g == gvk}
        for obj in current:
            callback(Event(ADDED, obj))
        for ns, name in (seed_known or ()):
            if (ns, name) not in held:
                group, version, kind = gvk
                callback(Event(DELETED, {
                    "apiVersion": f"{group}/{version}" if group
                    else version,
                    "kind": kind,
                    "metadata": {"name": name,
                                 **({"namespace": ns} if ns else {})},
                }))

        def cancel():
            with self._lock:
                subs = self._subscribers.get(gvk, [])
                if callback in subs:
                    subs.remove(callback)

        return cancel


class FileSource:
    """Read-only source over a manifest directory (gator-style offline)."""

    def __init__(self, *paths: str):
        self.objects: list[dict] = []
        for path in paths:
            if os.path.isdir(path):
                for root, dirs, files in os.walk(path):
                    # sorted at every level: a boot interns templates in
                    # load order, and a compile-cache hit needs the same
                    # order in every process that shares the cache
                    dirs.sort()
                    for f in sorted(files):
                        if f.endswith((".yaml", ".yml")):
                            self.objects.extend(
                                load_yaml_file(os.path.join(root, f)))
            else:
                self.objects.extend(load_yaml_file(path))

    def list(self, gvk: Optional[tuple] = None) -> list:
        return [o for o in self.objects
                if gvk is None or gvk_of(o) == gvk]

    def populate(self, cluster: FakeCluster) -> None:
        for obj in self.objects:
            cluster.apply(obj)
