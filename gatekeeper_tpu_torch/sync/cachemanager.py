"""CacheManager: source-of-truth for what is synced into the eval plane.

Reference: pkg/cachemanager/cachemanager.go — Config + SyncSet sources
aggregate GVK wishes (GVKAggregator), the watch set swaps transactionally,
objects flow ``AddObject -> client.AddData`` with excluder filtering and
readiness observation, and excluder changes wipe + replay
(manageCache/wipeCacheIfNeeded, cachemanager.go:410-540).
"""

from __future__ import annotations

import threading
from typing import Optional

from gatekeeper_tpu_torch.sync.aggregator import GVKAggregator
from gatekeeper_tpu_torch.sync.process import ProcessExcluder
from gatekeeper_tpu_torch.sync.source import (ADDED, DELETED, Event,
                                              FakeCluster)
from gatekeeper_tpu_torch.target.target import WipeData
from gatekeeper_tpu_torch.utils.unstructured import gvk_of, namespace_of


class CacheManager:
    def __init__(self, client, cluster: FakeCluster,
                 excluder: Optional[ProcessExcluder] = None,
                 readiness_tracker=None, metrics=None):
        self.client = client
        self.cluster = cluster
        self.excluder = excluder or ProcessExcluder()
        self.readiness_tracker = readiness_tracker
        self.metrics = metrics
        self.aggregator = GVKAggregator()
        self._cancels: dict[tuple, callable] = {}  # gvk -> unsubscribe
        self._synced: set = set()  # keys of objects in the inventory
        self._lock = threading.RLock()

    # --- sources (reference: UpsertSource cachemanager.go:139) ----------
    def upsert_source(self, key: tuple, gvks) -> None:
        with self._lock:
            self.aggregator.upsert(key, gvks)
            self._replace_watch_set()

    def remove_source(self, key: tuple) -> None:
        with self._lock:
            self.aggregator.remove(key)
            self._replace_watch_set()

    def _replace_watch_set(self) -> None:
        """Transactional watch swap (cachemanager.go:177-215)."""
        wanted = self.aggregator.gvks()
        current = set(self._cancels)
        for gvk in current - wanted:
            self._cancels.pop(gvk)()
            self._remove_gvk_data(gvk)
            if self.readiness_tracker is not None:
                # ExpectationsPruner (pruner.go:48-58): data expectations
                # for a GVK nobody watches anymore can never be observed
                self.readiness_tracker.prune(
                    "data", lambda k, g=gvk: k[0] == g)
        for gvk in wanted - current:
            # seed data expectations from current state (the reference's
            # boot-time data trackers, ready_tracker.go:326); the replay
            # below observes them immediately when they sync
            if self.readiness_tracker is not None:
                try:
                    for obj in self.cluster.list(gvk):
                        self.readiness_tracker.expect(
                            "data", _obj_key(obj))
                except Exception:
                    pass  # listing races/missing CRDs: watch retries
            self._cancels[gvk] = self.cluster.subscribe(
                gvk, self._on_event, replay=True
            )

    # --- data plane (reference: AddObject cachemanager.go:310-348) ------
    def _on_event(self, event: Event) -> None:
        obj = event.obj
        ns = namespace_of(obj)
        key = _obj_key(obj)
        if event.type == DELETED:
            self.client.remove_data(obj)
            self._synced.discard(key)
            if self.readiness_tracker is not None:
                # deletion is terminal, not retryable: unconditional
                # cancel (a budgeted try_cancel would never fire again
                # for an object that can't reappear)
                self.readiness_tracker.cancel("data", key)
        else:
            if ns and self.excluder.is_excluded("sync", ns):
                # excluded namespaces never reach the eval-plane inventory
                self.client.remove_data(obj)
                self._synced.discard(key)
                if self.readiness_tracker is not None:
                    # a seeded expectation for an excluded object can
                    # never be observed — terminal, not retryable
                    self.readiness_tracker.cancel("data", key)
                return
            self.client.add_data(obj)
            self._synced.add(key)
            if self.readiness_tracker is not None:
                self.readiness_tracker.observe("data", key)
        if self.metrics is not None:
            self.metrics.set_gauge("sync", len(self._synced), {})

    def _remove_gvk_data(self, gvk: tuple) -> None:
        for obj in self.cluster.list(gvk):
            self.client.remove_data(obj)
            self._synced.discard(_obj_key(obj))

    # --- excluder swap (reference: wipeCacheIfNeeded + replay) ----------
    def replace_excluder(self, new_excluder: ProcessExcluder) -> None:
        with self._lock:
            if self.excluder.equals(new_excluder):
                return
            self.excluder.replace(new_excluder)
            # wipe + relist: buffer-swap semantics of the device inventory
            self.client.add_data(WipeData())
            for gvk in self.aggregator.gvks():
                for obj in self.cluster.list(gvk):
                    ns = namespace_of(obj)
                    if ns and self.excluder.is_excluded("sync", ns):
                        continue
                    self.client.add_data(obj)

    def watched_gvks(self) -> set:
        return set(self._cancels)


def _obj_key(obj: dict) -> tuple:
    return (gvk_of(obj), namespace_of(obj),
            (obj.get("metadata") or {}).get("name", ""))
