"""Watch ingestion: the snapshot's event feed off the ObjectSource seam.

Port of ``gatekeeper_tpu/snapshot/ingest.py`` (a copy).  Its watch
source is ``sync/source.FakeCluster`` or ``sync/kube.KubeCluster``.

The reference's watch manager registers dynamic informers per GVK and
funnels their events into the cachemanager (pkg/watch/manager.go); here
the equivalent is :class:`WatchIngester` — one ``subscribe()`` per GVK on
any ObjectSource (``FakeCluster``, ``KubeCluster``), callbacks ENQUEUE
only (the source's watch threads never touch snapshot state), and the
audit thread applies the queue as row patches via
:meth:`ClusterSnapshot.pump`.

Replay semantics make this self-healing: both sources replay current
state as ADDED on subscribe, and ``KubeCluster`` re-replays after a 410
Gone relist — the snapshot's no-op-patch detection (resourceVersion /
deep equality) absorbs the churn without dirtying clean rows.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional, Sequence

from gatekeeper_tpu_torch.utils.unstructured import gvk_of


class WatchIngester:
    """Fan-in of per-GVK watch subscriptions into a ClusterSnapshot.

    ``from_rvs`` (``{gvk: resourceVersion}``, the snapshot spill's rv
    high-water marks) makes a restart cold-start-free on the watch side
    too: sources that support it (``KubeCluster``) resubscribe straight
    FROM the recorded rv — no initial list, missed events replay off the
    server's watch cache — seeding the vanished-object diff with the
    spilled keys so a 410-forced relist still synthesizes DELETEDs.
    Sources without rv resume fall back to a full replay, which the
    snapshot's no-op-patch detection absorbs.

    ``rvs`` tracks the newest resourceVersion seen per GVK (event
    objects advance it); :meth:`resume_rvs` is what the next spill
    records."""

    def __init__(self, snapshot, source, gvks: Sequence[tuple],
                 on_error: Optional[Callable[[Exception], None]] = None,
                 from_rvs: Optional[dict] = None, cluster: str = ""):
        self.snapshot = snapshot
        self.source = source
        self.gvks = list(gvks)
        self.on_error = on_error
        self.from_rvs = dict(from_rvs or {})
        # fleet mode: which cluster this ingester feeds — the id the
        # FleetEvaluator labels its metrics/log lines with, so N
        # ingesters' errors and rv marks stay attributable
        self.cluster = cluster
        # gvk -> newest seen resourceVersion; starts at the resume marks
        # so a quiet restart's next spill keeps the spilled rvs
        self.rvs: dict = dict(self.from_rvs)
        self._cancels: list = []
        self._lock = threading.Lock()
        self.events_seen = 0

    def resume_rvs(self) -> dict:
        """Per GVK the version to resume from: the source's own mark
        where it keeps one (``KubeCluster.resume_rv``: a list's version or
        a bookmark's, which no consumed event is past), else the newest
        event object's version, as the JAX ingester records it."""
        mark = getattr(self.source, "resume_rv", None)
        out = dict(self.rvs)
        if mark is not None:
            for gvk in self.gvks:
                rv = mark(gvk)
                if rv:
                    out[gvk] = rv
        return out

    def _on_event(self, ev) -> None:
        self.events_seen += 1
        rv = ((ev.obj.get("metadata") or {})
              .get("resourceVersion", "")) or ""
        if rv:
            self.rvs[gvk_of(ev.obj)] = rv
        self.snapshot.enqueue(ev.type, ev.obj)

    def _subscribe(self, gvk: tuple):
        rv = self.from_rvs.get(gvk, "")
        # a warm-loaded snapshot always seeds the vanished-object diff
        # (spilled keys the source no longer holds must synthesize
        # DELETED) even when the source records no rv marks — only the
        # list-skip needs a real rv to resume from
        if rv or getattr(self.snapshot, "warm_loaded", False):
            try:
                return self.source.subscribe(
                    gvk, self._on_event, replay=True, from_rv=rv,
                    seed_known=self.snapshot.keys_for_gvk(gvk))
            except TypeError:
                pass  # source without warm resume: full replay below
        return self.source.subscribe(gvk, self._on_event, replay=True)

    def start(self) -> "WatchIngester":
        with self._lock:
            for gvk in self.gvks:
                try:
                    self._cancels.append(self._subscribe(gvk))
                except Exception as e:  # noqa: PERF203
                    if self.on_error is not None:
                        self.on_error(e)
                    else:
                        raise
        return self

    def stop(self) -> None:
        with self._lock:
            cancels, self._cancels = self._cancels, []
        for cancel in cancels:
            try:
                cancel()
            except Exception:
                pass

    def pump(self, max_events: Optional[int] = None) -> int:
        """Apply queued events to the snapshot (audit-thread side)."""
        return self.snapshot.pump(max_events=max_events)


def gvks_of(objects: Iterable[dict]) -> list:
    """Distinct GVKs of an object iterable (FakeCluster-style sources
    without discovery), insertion-ordered."""
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of

    seen: dict = {}
    for obj in objects:
        seen.setdefault(gvk_of(obj), None)
    return list(seen)
