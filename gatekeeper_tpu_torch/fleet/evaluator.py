"""Fleet mode: one evaluator, N clusters.

Port of ``gatekeeper_tpu/fleet/evaluator.py``.  A policy control plane that
serves many clusters' audits shares everything keyed by content — the
compiled template programs (``drivers/generation.CompileCache``), the warm
state (``WarmStateCache``), the interned vocab — and nothing of it is tied
to one cluster:

- **LibraryRuntime** — ONE (client, driver, evaluator, generation
  coordinator) per distinct template-library digest, on one device.
  Clusters running the same library attach to the same runtime: the
  second cluster boots with ZERO fresh lowerings.  Distinct but
  overlapping libraries still share the on-disk CompileCache.
- **FleetCluster** — the per-cluster state: a resident
  :class:`~gatekeeper_tpu_torch.snapshot.ClusterSnapshot` + WatchIngester,
  an AuditManager (the verdict store + fold/render seams) and a
  per-cluster :class:`~gatekeeper_tpu_torch.snapshot.SnapshotSpill` under
  ``<spill-root>/<cluster-id>/`` with the cluster id in the header.
- **The packed fleet sweep** — the scheduler packs many small clusters'
  SAME-GROUP rows into one device-sized dispatch
  (``snapshot.store.concat_group_rows``): a cluster-id row column
  (``batch.cluster_rows``) rides the packed batch, the dispatch ships
  complete hit sets (``return_bits`` — per-row hit sets, never a
  cross-cluster top-k; the masks lane's ``epilogue`` where the sweep's
  collect lane is ``masks``, a device sum on the reduced lane), and each
  cluster's segment folds back into its own verdict store exactly as N
  independent sweeps would (segments keep canonical row order; verdict
  grids are per row).  For K small clusters the dispatch count and the
  padding collapse ~K-fold.

Packing rules (what keeps the fold identical by construction): segments
stay contiguous and in canonical row order; only rows of the same
library runtime AND the same constraint group pack together; the packed
lane always ships complete hit sets.  Totals and kept lists derive per
cluster from its verdict store, so chunk geometry is invisible to the
output.  ``pad_n`` is ``chunk_size x pack_chunks`` rounded up to a power of
two: past 0xFFFF rows the reduced lane's packed word splits into separate
``counts`` and ``occ`` rows (``parallel/sweep.py`` ``_reduce``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
from gatekeeper_tpu_torch.audit.manager import (AuditConfig, AuditManager,
                                                AuditRun)
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot, SnapshotConfig,
                                           SnapshotSpill, SnapshotSpiller,
                                           WatchIngester, concat_group_rows,
                                           gvks_of, templates_digest)

# path-safe cluster ids: they name spill subdirs and metric label values
_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def check_cluster_id(cluster_id: str) -> str:
    if not cluster_id or not set(cluster_id) <= _ID_OK \
            or cluster_id in (".", ".."):
        raise ValueError(
            f"cluster id {cluster_id!r} must be non-empty "
            f"[A-Za-z0-9._-]+ (it names spill subdirs and label values)")
    return cluster_id


class _SegmentHits:
    """One cluster's view of a packed dispatch's hit set: rows of local
    constraint ``ci`` restricted to this cluster's row range and rebased
    to segment-local indices — duck-types the bits slot consumed by
    ``violation_rows`` / the manager fold, so the per-cluster fold runs
    the exact unpacked code path."""

    __slots__ = ("_bits", "start", "k", "total")

    def __init__(self, bits, start: int, k: int, total: int):
        self._bits = bits
        self.start = start
        self.k = k
        self.total = total

    def rows(self, ci: int) -> np.ndarray:
        from gatekeeper_tpu_torch.parallel.sweep import violation_rows

        r = violation_rows(self._bits, ci, self.total)
        r = r[(r >= self.start) & (r < self.start + self.k)]
        return r - self.start


class LibraryRuntime:
    """The shared compile/executable plane of one template library:
    client + driver + evaluator (+ the driver's GenerationCoordinator).
    Clusters attach; nothing here is per-cluster."""

    def __init__(self, key: str, client, driver, evaluator):
        self.key = key
        self.client = client
        self.driver = driver
        self.evaluator = evaluator
        self.clusters: list = []  # FleetCluster, attach order
        # persisted warm execution state (drivers/generation.py
        # WarmStateCache), wired by FleetEvaluator when warm_root is set
        self.warm_cache = None
        self.warm_replayed: Optional[dict] = None
        # device-resident snapshot lane (snapshot/device_residency.py):
        # ONE residency per runtime — member clusters' stores are
        # distinct objects, so each gets its own mirror under it
        self.residency = None

    @property
    def gen_coord(self):
        return getattr(self.driver, "gen_coord", None)

    def audit_constraints(self) -> list:
        return [c for c in self.client.constraints()
                if c.actions_for(AUDIT_EP)]

    def library_digest(self) -> str:
        return templates_digest(self.client)


class FleetCluster:
    """One cluster's state behind a shared runtime."""

    def __init__(self, cluster_id: str, runtime: LibraryRuntime,
                 snapshot, manager, ingester=None, spill=None,
                 spiller=None, lister=None, statuses=None):
        self.id = cluster_id
        self.runtime = runtime
        self.snapshot = snapshot
        self.manager = manager
        self.ingester = ingester
        self.spill = spill
        self.spiller = spiller
        self.lister = lister
        self.warm_booted = False  # spill served the boot
        # per-cluster audit statuses {(kind, name): status dict}: the
        # runtime's Constraint OBJECTS are shared across clusters, so
        # status writeback must not mutate them (cluster B would
        # overwrite A's) — each cluster's manager writes here instead
        self.statuses: dict = statuses if statuses is not None else {}

    def sweep_independent(self, full: bool = True) -> AuditRun:
        """The unpacked reference: this cluster swept alone through the
        standard snapshot audit path (the fleet differential's oracle,
        and the sequential lane FLEET_BENCH compares against)."""
        if full:
            return self.manager.audit()
        return self.manager.audit_tick()

    def stop(self) -> None:
        if self.ingester is not None:
            self.ingester.stop()
        if self.spiller is not None:
            self.spiller.stop(flush=False)


class FleetEvaluator:
    """N clusters multiplexed behind shared per-library runtimes.

    ``add_cluster`` attaches a cluster to the runtime of its library
    key, building the runtime on first use (``build``) and reusing it
    afterwards (``shared_boots`` counts the zero-lowering attaches).
    ``sweep`` runs ONE fleet pass: per runtime, every member cluster's
    rows pack into shared same-group dispatches; per cluster, verdicts
    fold into its own store and totals/kept derive exactly as an
    independent sweep would."""

    def __init__(self, metrics=None, chunk_size: int = 500,
                 violations_limit: int = 20, exact_totals: bool = True,
                 pack_chunks: int = 0, spill_root: str = "",
                 spill_compress: str = "none", spill_delta: bool = False,
                 spill_full_every: int = 8, submit_window: int = 64,
                 chunk_retries: int = 1, warm_root: str = "",
                 residency: str = "auto"):
        self.metrics = metrics
        # warm execution state root (normally the compile-cache dir):
        # each runtime replays its persisted sweep traces at build time
        # and save_warm_all() persists them back — cold-start-free fleet
        # restarts, including runtimes born AFTER boot
        self.warm_root = warm_root
        self.chunk_size = max(1, chunk_size)
        self.violations_limit = violations_limit
        self.exact_totals = exact_totals
        # rows per packed dispatch = chunk_size x pack_chunks;
        # 0 = auto (the runtime's cluster count — K small clusters fill
        # one device batch), 1 = packing off (every cluster chunk
        # dispatches alone, the N-independent-sweeps shape)
        self.pack_chunks = max(0, int(pack_chunks))
        self.spill_root = spill_root
        self.spill_compress = spill_compress
        self.spill_delta = spill_delta
        self.spill_full_every = spill_full_every
        self.submit_window = max(1, submit_window)
        self.chunk_retries = max(0, chunk_retries)
        # residency mode for per-runtime DeviceResidency ('auto' / 'on'
        # / 'off'); single-cluster (unpacked) dispatches prefer the
        # resident lane, multi-cluster packs keep host columns (NEXT)
        self.residency_mode = residency
        self._runtimes: dict = {}  # library key -> LibraryRuntime
        self.clusters: dict = {}   # cluster id -> FleetCluster
        self._lock = threading.Lock()
        self.shared_boots = 0      # clusters served by an existing runtime
        self.packed_dispatches = 0
        self.unpacked_dispatches = 0
        self.last_sweep_s = 0.0

    # --- runtimes -------------------------------------------------------
    def runtime(self, key: str, build: Callable[[], tuple]
                ) -> LibraryRuntime:
        """The runtime of one library key; ``build`` -> (client, driver,
        evaluator) runs only on the first cluster of the key — every
        later cluster attaches to the already-compiled plane."""
        with self._lock:
            rt = self._runtimes.get(key)
        if rt is not None:
            with self._lock:
                self.shared_boots += 1
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(M.FLEET_SHARED_BOOTS)
            return rt
        client, driver, evaluator = build()
        rt = LibraryRuntime(key, client, driver, evaluator)
        if self.residency_mode != "off" and evaluator is not None:
            from gatekeeper_tpu_torch.snapshot.device_residency import \
                DeviceResidency

            rt.residency = DeviceResidency(evaluator,
                                           metrics=self.metrics,
                                           mode=self.residency_mode)
            gc = rt.gen_coord
            if gc is not None:
                gc.attach_residency(rt.residency)
        if self.warm_root:
            self._attach_warm(rt)
        with self._lock:
            self._runtimes[key] = rt
        self._publish_sizes()
        return rt

    def _attach_warm(self, rt: LibraryRuntime) -> None:
        """Replay persisted warm state (the sweep's hit-buffer sizing)
        into a freshly built runtime (WarmStateCache under ``warm_root``,
        keyed by the runtime's installed-programs digest), whether it was
        built at fleet boot or attached later.  Failures degrade to a
        cold runtime, never an error."""
        try:
            from gatekeeper_tpu_torch.drivers.generation import (
                WarmStateCache, library_warm_dir, programs_digest)

            rt.warm_cache = WarmStateCache(
                library_warm_dir(self.warm_root,
                                 programs_digest(rt.driver)),
                metrics=self.metrics)
            rt.warm_replayed = rt.warm_cache.replay(rt.driver,
                                                    rt.evaluator)
        except Exception:
            rt.warm_cache = None
            rt.warm_replayed = None

    def save_warm_all(self) -> int:
        """Persist every warm-wired runtime's execution state (the
        drain/exit counterpart of :meth:`_attach_warm`).  Returns the
        number of runtimes saved."""
        saved = 0
        for rt in self.runtimes():
            if rt.warm_cache is None:
                continue
            try:
                rt.warm_cache.save(rt.driver, rt.evaluator)
                saved += 1
            except Exception:
                pass
        return saved

    def runtimes(self) -> list:
        return list(self._runtimes.values())

    def _publish_sizes(self) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        self.metrics.set_gauge(M.FLEET_CLUSTERS, len(self.clusters))
        self.metrics.set_gauge(M.FLEET_RUNTIMES, len(self._runtimes))

    # --- clusters -------------------------------------------------------
    def add_cluster(self, cluster_id: str, source, library_key: str,
                    build: Callable[[], tuple],
                    lister: Optional[Callable] = None,
                    gvks: Optional[Sequence[tuple]] = None,
                    subscribe: bool = True) -> FleetCluster:
        """Attach one cluster: runtime (shared), snapshot, watch
        ingester, audit manager, and — with a ``spill_root`` — the
        per-cluster spill under ``<root>/<cluster-id>/`` (loaded now:
        a valid spill makes this cluster's first pass an incremental
        tick with zero relist, the watches resubscribing from the
        recorded rv)."""
        check_cluster_id(cluster_id)
        if cluster_id in self.clusters:
            raise ValueError(f"duplicate cluster id {cluster_id!r}")
        rt = self.runtime(library_key, build)
        snapshot = ClusterSnapshot(rt.evaluator, SnapshotConfig(),
                                   metrics=None)
        if lister is None:
            def lister(_src=source):
                return iter(_src.list())
        spill = spiller = None
        spill_load = None
        if self.spill_root:
            import os

            spill = SnapshotSpill(
                os.path.join(self.spill_root, cluster_id),
                metrics=self.metrics, compress=self.spill_compress,
                cluster_id=cluster_id, delta=self.spill_delta,
                full_every=self.spill_full_every)
            spill_load = spill.load(
                snapshot, rt.audit_constraints(),
                templates=rt.library_digest())
        ingester = None
        if subscribe:
            ingester = WatchIngester(
                snapshot, source,
                list(gvks) if gvks is not None else gvks_of(source.list()),
                from_rvs=(spill_load or {}).get("rvs"),
                cluster=cluster_id).start()
        statuses: dict = {}
        manager = AuditManager(
            rt.client, lister=lister,
            config=AuditConfig(
                audit_source="snapshot",
                chunk_size=self.chunk_size,
                violations_limit=self.violations_limit,
                exact_totals=self.exact_totals,
                submit_window=self.submit_window,
                chunk_retries=self.chunk_retries,
                pipeline="off"),
            evaluator=rt.evaluator, snapshot=snapshot,
            # per-cluster status sink: the constraint objects are
            # SHARED across the runtime's clusters — writeback into
            # con.raw would make the last-swept cluster win
            status_writer=lambda con, status:
                statuses.__setitem__(con.key(), status),
            metrics=self.metrics, cluster=cluster_id,
            residency=rt.residency)
        if spill is not None:
            spiller = SnapshotSpiller(
                spill, snapshot,
                rvs_fn=(lambda ing=ingester: dict(ing.rvs))
                if ingester is not None else None,
                templates_fn=lambda rt=rt: rt.library_digest())
            manager.attach_spiller(spiller)
            if spill_load is not None:
                manager.restore_spill_aux(spill_load.get("aux") or {})
        fc = FleetCluster(cluster_id, rt, snapshot, manager,
                          ingester=ingester, spill=spill,
                          spiller=spiller, lister=lister,
                          statuses=statuses)
        fc.warm_booted = spill_load is not None
        rt.clusters.append(fc)
        self.clusters[cluster_id] = fc
        self._publish_sizes()
        return fc

    # --- the packed fleet sweep ----------------------------------------
    def sweep(self, full: Optional[bool] = None,
              pack: bool = True) -> dict:
        """One fleet pass.  Returns ``{cluster id: AuditRun}``.

        ``full``: True evaluates every resident row, False only the
        watch-dirtied sets; None picks per cluster — a warm-booted or
        already-built snapshot ticks (O(churn)), a cold one takes the
        full build+evaluate.  ``pack=False`` keeps per-cluster
        dispatches (the N-independent-sweeps geometry) while still
        sharing the runtimes — the bench's sequential lane."""
        from gatekeeper_tpu_torch.observability import tracing

        t0 = time.time()
        out: dict = {}
        with tracing.span("fleet.sweep", clusters=len(self.clusters)) \
                as sp:
            by_rt: dict = {}  # id(rt) -> (rt, [(fc, cons, rows, run)])
            for cid in sorted(self.clusters):
                fc = self.clusters[cid]
                run = AuditRun(timestamp=_now_rfc3339())
                fc.manager._annotate_run(run)
                cons = fc.runtime.audit_constraints()
                was_stale = fc.snapshot.stale
                fc.manager._snapshot_ready(cons)
                f = full if full is not None else was_stale
                rows = fc.snapshot.all_rows() if f \
                    else fc.snapshot.dirty_rows()
                by_rt.setdefault(id(fc.runtime),
                                 (fc.runtime, []))[1].append(
                    (fc, cons, rows, run))
            total_rows = 0
            for rt, entries in by_rt.values():
                total_rows += sum(
                    sum(len(v) for v in rows.values())
                    for _fc, _cons, rows, _run in entries)
                self._sweep_runtime(rt, entries, pack=pack)
            for _rt, entries in by_rt.values():
                for fc, cons, _rows, run in entries:
                    totals, kept = fc.manager.snapshot_collect(cons)
                    run.total_objects = fc.snapshot.live_count()
                    run.total_violations = totals
                    run.kept = kept
                    run.duration_s = time.time() - t0
                    fc.manager._write_statuses(run, cons)
                    out[fc.id] = run
                    if self.metrics is not None:
                        from gatekeeper_tpu_torch.metrics import registry as M

                        self.metrics.inc_counter(
                            M.FLEET_SWEPT_ROWS, {"cluster": fc.id},
                            value=float(sum(
                                len(v) for v in _rows.values())))
            sp.set_attribute("rows", total_rows)
            sp.set_attribute("packed_dispatches", self.packed_dispatches)
        self.last_sweep_s = time.time() - t0
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.FLEET_SWEEP_SECONDS,
                                   self.last_sweep_s)
        return out

    def _sweep_runtime(self, rt: LibraryRuntime, entries, pack: bool
                       ) -> None:
        """Pack one runtime's member-cluster rows into shared same-group
        dispatches and fold every segment back per cluster."""
        # bucket by constraint group: stores of one runtime share plan
        # objects per group, so the group frozenset IS the pack key
        buckets: dict = {}  # group -> [(fc, store, gids, positions, run)]
        order: list = []
        for fc, _cons, rows, run in entries:
            for store, rowlist in rows.items():
                if not rowlist:
                    continue
                g = store.group
                if g not in buckets:
                    buckets[g] = []
                    order.append(g)
                buckets[g].append((
                    fc, store,
                    [gid for gid, _p in rowlist],
                    [p for _gid, p in rowlist], run))
        for g in order:
            segs = buckets[g]
            ev = rt.evaluator
            if not segs[0][1].lowered or ev is None:
                # non-lowered group: the drivers' exact lane is
                # per-cluster host work — nothing to pack
                for fc, store, gids, positions, run in segs:
                    objects = [store.row_obj(p) for p in positions]
                    fc.manager.fold_snapshot_segment(
                        {}, store.cons, gids, objects)
                continue
            # unit chunks (the canonical per-cluster chunking), then
            # greedy packing of consecutive same-group chunks — across
            # cluster boundaries — into device-sized dispatches
            stream: list = []
            for fc, store, gids, positions, run in segs:
                for i in range(0, len(gids), self.chunk_size):
                    stream.append((fc, store,
                                   gids[i:i + self.chunk_size],
                                   positions[i:i + self.chunk_size],
                                   run))
            k = self.pack_chunks or len(entries)
            if not pack:
                k = 1
            budget = self.chunk_size * max(1, k)
            window: deque = deque()
            i = 0
            while i < len(stream):
                parts = [stream[i]]
                total = len(stream[i][2])
                i += 1
                while pack and i < len(stream) \
                        and total + len(stream[i][2]) <= budget:
                    parts.append(stream[i])
                    total += len(stream[i][2])
                    i += 1
                self._submit_packed(rt, parts, window)
                while len(window) > self.submit_window:
                    self._fold_packed(rt, window.popleft())
            while window:
                self._fold_packed(rt, window.popleft())

    def _submit_packed(self, rt, parts, window) -> None:
        """Flatten-from-resident-columns + dispatch one packed chunk
        (async — the device drains while the host packs the next)."""
        from gatekeeper_tpu_torch.observability import tracing

        ev = rt.evaluator
        lens = [len(p[2]) for p in parts]
        total = sum(lens)
        pad_n = ev._pad(total)
        store0 = parts[0][1]
        n_clusters = len({p[0].id for p in parts})
        with tracing.span("fleet.pack", clusters=n_clusters,
                          chunks=len(parts), rows=total):
            # the cluster-id column rides the packed batch: cluster
            # index per packed row (pad region -1) — the fold's segment
            # map and the per-cluster cost-attribution row weights,
            # inspectable on the retained _FlatChunk while in flight
            cluster_rows = np.full(pad_n, -1, np.int32)
            cluster_rows[:total] = np.repeat(
                np.arange(len(parts), dtype=np.int32), lens)
            batch = None  # host gather happens only if a lane needs it

            def host_batch():
                nonlocal batch
                if batch is None:
                    batch = concat_group_rows(
                        [(p[1], p[3]) for p in parts], pad_n)
                    batch.cluster_rows = cluster_rows
                return batch

            objects = [p[1].row_obj(pos) for p in parts for pos in p[3]]
            # single-cluster (unpacked) chunks prefer the resident lane:
            # the one store's device mirror serves the rows with a
            # gather-index upload only; multi-cluster packs gather host
            # columns (cross-store device concat is a ROADMAP NEXT)
            rg = None
            if len(parts) == 1 and rt.residency is not None \
                    and store0.lowered:
                rg = rt.residency.prepare(store0)
            retries = self.chunk_retries
            pending = None
            last = None
            for attempt in range(retries + 1):
                try:
                    flat = None
                    if rg is not None:
                        flat = ev.sweep_flatten_resident(
                            rg, parts[0][3], return_bits=True)
                    if flat is None:
                        flat = ev.sweep_flatten_from_batch(
                            store0.cons, host_batch(), objects,
                            return_bits=True, alias=store0.alias)
                    pending = ev.sweep_dispatch(flat)
                    break
                except Exception as e:  # noqa: PERF203
                    last = e
            if pending is None:
                self._packed_failed(parts, last, "submit")
                return
            self.packed_dispatches += 1 if len(parts) > 1 else 0
            self.unpacked_dispatches += 1 if len(parts) == 1 else 0
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(
                    M.FLEET_PACKED_DISPATCHES if len(parts) > 1
                    else M.FLEET_UNPACKED_DISPATCHES)
        window.append((pending, parts, lens, total, objects,
                       cluster_rows))

    def _packed_failed(self, parts, exc, phase: str) -> None:
        """A packed chunk exhausted its retries: every member cluster's
        rows stay dirty with their previous verdicts, every member run
        flags incomplete (the AuditManager chunk-failure contract)."""
        from gatekeeper_tpu_torch.utils.logging import log_event

        for fc, _store, _gids, _positions, run in parts:
            run.failed_chunks += 1
            run.incomplete = True
        log_event("warning",
                  "fleet packed chunk dropped after exhausting retries "
                  "(rows stay dirty; previous verdicts kept)",
                  event_type="fleet_chunk_failed", phase=phase,
                  error=str(exc),
                  clusters=sorted({p[0].id for p in parts}))

    def _fold_packed(self, rt, item) -> None:
        """Collect one packed dispatch and fold each cluster's segment
        into its own verdict store (segment-rebased hit rows through
        the manager's unpacked fold path)."""
        from gatekeeper_tpu_torch.observability import costattr

        pending, parts, lens, total, objects, cluster_rows = item
        ev = rt.evaluator
        last = None
        swept = None
        for attempt in range(self.chunk_retries + 1):
            try:
                if attempt > 0:
                    store0 = parts[0][1]
                    pad_n = ev._pad(total)
                    batch = concat_group_rows(
                        [(p[1], p[3]) for p in parts], pad_n)
                    flat = ev.sweep_flatten_from_batch(
                        store0.cons, batch, objects, return_bits=True,
                        alias=store0.alias)
                    pending = ev.sweep_dispatch(flat)
                swept = ev.sweep_collect(pending)
                break
            except Exception as e:  # noqa: PERF203
                last = e
        else:
            self._packed_failed(parts, last, "collect")
            return
        wall = getattr(pending, "dispatch_wall", 0.0)
        attr = costattr.active()
        if attr is not None and wall > 0:
            attr.attribute_clusters(
                wall, {p[0].id: ln for p, ln in zip(parts, lens)},
                costattr.EP_AUDIT)
        off = 0
        for (fc, store, gids, _positions, run), ln in zip(parts, lens):
            sub = {}
            if isinstance(swept, dict):
                for kind, (kcons, _idx, _valid, _counts, bits) in \
                        swept.items():
                    sub[kind] = (kcons, None, None, None,
                                 _SegmentHits(bits, off, ln, total))
            try:
                fc.manager.fold_snapshot_segment(
                    sub, store.cons, gids, objects[off:off + ln])
            except Exception as e:
                run.failed_chunks += 1
                run.incomplete = True
                from gatekeeper_tpu_torch.utils.logging import log_event

                log_event("warning",
                          "fleet segment fold failed (rows stay dirty)",
                          event_type="fleet_fold_failed", cluster=fc.id,
                          error=str(e))
            off += ln

    # --- lifecycle ------------------------------------------------------
    def spill_all(self, wait: bool = True) -> None:
        """Spill every cluster's snapshot (drain / --once exit)."""
        for fc in self.clusters.values():
            if fc.spiller is not None:
                fc.spiller.spill_now() if wait else fc.spiller.request()

    def stop(self) -> None:
        for fc in self.clusters.values():
            fc.stop()
        for rt in self.runtimes():
            gc = rt.gen_coord
            if gc is not None:
                gc.stop()


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
