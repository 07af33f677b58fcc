"""Audit sweep: the enforcement point that reviews every cluster object.

Port of ``gatekeeper_tpu/audit/manager.py``: the serial schedule over a
relisting lister, and the resident-snapshot lane (``audit_source=
"snapshot"``: full passes and incremental ticks over
``snapshot/store.ClusterSnapshot`` rows, device-resident through
``snapshot/device_residency.DeviceResidency`` when one is given, with
the periodic resync differential), plus the ``run_forever`` loop of both.
Reference flow (pkg/audit/manager.go:258-973): list every auditable object
(chunked) → review each against all constraints → keep the first K
violations per constraint (LimitQueue) → write constraint status.

Device middle: each chunk flattens to columns and the whole constraint ×
chunk grid evaluates in one device pass (``parallel/sweep.SweepEvaluator``);
only the ≤K kept violations per constraint render to messages through the
exact interpreter.  Kinds the sweep does not cover go to their driver's
``query_batch`` (the admission path), on the sweep's device.

Not ported yet: the staged pipeline schedule, the expansion generator
stage (and the snapshot's generated verdicts), the snapshot spiller, the
fleet seams, export, metrics, tracing and brownout hooks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np

from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, Constraint
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.base import ReviewCfg
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
from gatekeeper_tpu_torch.utils.logging import log_event
from gatekeeper_tpu_torch.utils.rawjson import peek_kind
from gatekeeper_tpu_torch.utils.unstructured import gvk_of


@dataclass
class AuditConfig:
    interval_s: float = 60.0  # --audit-interval
    violations_limit: int = 20  # --constraint-violations-limit
    chunk_size: int = 500  # --audit-chunk-size
    # exact totals = reference parity: totalViolations counts every
    # violation *result* (a pod with 2 privileged containers contributes
    # 2), which requires rendering every hit through the interpreter.
    # False counts violating objects from the device grid.
    exact_totals: bool = True
    # how many chunks may be in flight on the device before the oldest is
    # collected (host memory + device memory bound)
    submit_window: int = 64
    # a chunk whose submit/collect raises is re-submitted up to
    # chunk_retries times, then SKIPPED — the run finishes with partial
    # results and an explicit `incomplete` marker
    chunk_retries: int = 1
    # sweep input (--audit-source): 'relist' pages the cluster through
    # the lister every pass; 'snapshot' audits the resident columnar
    # snapshot — a full pass evaluates resident columns with zero
    # list/flatten cost, and `audit_tick` evaluates only the
    # watch-dirtied rows (O(churn))
    audit_source: str = "relist"
    # snapshot mode: every Nth interval of run_forever runs the
    # full-resync differential instead of an incremental tick; 0 = never
    resync_every: int = 10
    # rotate the resync differential over 1/K of the row keyspace per
    # resync (K consecutive resyncs cover every row); a rotated resync
    # proves the store only, the cluster-global verdict differential runs
    # when rotation is off.  0/1 = off
    resync_rotate: int = 0


@dataclass
class Violation:
    constraint: Constraint
    message: str
    enforcement_action: str
    group: str
    version: str
    kind: str
    name: str
    namespace: str
    details: Any = None


@dataclass
class AuditRun:
    timestamp: str = ""
    total_objects: int = 0
    total_violations: dict = field(default_factory=dict)  # (kind,name) -> int
    kept: dict = field(default_factory=dict)  # (kind,name) -> list[Violation]
    duration_s: float = 0.0
    # partial-result marker: True when any chunk was dropped after
    # exhausting its retries or the lister died mid-sweep
    incomplete: bool = False
    failed_chunks: int = 0
    retried_chunks: int = 0
    # effective ingest/dispatch geometry of the pass
    flatten_workers: int = 0
    n_devices: int = 0
    shard_chunks: int = 0


def violation_rows(bits_or_hits, ci: int, n: int) -> np.ndarray:
    """Violating object indices of local constraint ``ci`` from either
    collect shape: bit-packed verdict rows (masks lane) or a
    device-reduced ``HitRows`` coordinate list (reduced lane)."""
    rows = getattr(bits_or_hits, "rows", None)
    if rows is not None:
        return rows(ci)
    return np.nonzero(np.unpackbits(bits_or_hits[ci], count=n))[0]


def _sweep_ready(pending) -> bool:
    """True when a submitted sweep's result needs no further wait
    (non-blocking).  Empty submits ({}) are always ready; local sweeps
    answer through their CUDA event."""
    ready = getattr(pending, "ready", None)
    return ready() if callable(ready) else True


class AuditManager:
    """One audit plane instance (the reference's audit Deployment pod)."""

    def __init__(
        self,
        client: Client,
        lister: Callable[[], Iterable[dict]],
        config: Optional[AuditConfig] = None,
        evaluator=None,  # parallel.sweep.SweepEvaluator (optional)
        snapshot=None,  # snapshot.ClusterSnapshot (audit_source=snapshot)
        residency=None,  # snapshot.DeviceResidency (resident lane)
    ):
        self.client = client
        self.lister = lister
        self.config = config or AuditConfig()
        self.evaluator = evaluator
        self.snapshot = snapshot
        # device-resident snapshot lane: when set, _snapshot_eval prefers
        # resident chunks and falls back to host columns per group
        # whenever the residency declines
        self.residency = residency
        # first difference of the last resync differential (None =
        # identical)
        self.last_resync_diff: Optional[str] = None
        self._resync_phase = 0  # rotated-resync rotor position
        self._stop = threading.Event()
        # per-phase seconds for the host-side fold/render of device sweeps
        # (the evaluator tracks its own flatten/masks/dispatch/collect),
        # and the snapshot lane's counters
        self.perf: dict = {}

    # --- loop (reference: auditManagerLoop, manager.go:831) -------------
    def run_forever(self) -> None:
        """Audit every ``interval_s`` until :meth:`stop`.  Snapshot mode:
        a first full pass builds the snapshot and evaluates every row,
        then each interval runs an incremental tick over the dirty rows,
        and every ``resync_every``-th one the resync differential.  A pass
        that raises is logged and the loop goes on."""
        def guarded(fn):
            try:
                fn()
            except Exception as e:
                log_event("error", "audit pass failed",
                          event_type="audit_pass_failed", error=repr(e))

        if self._snapshot_mode():
            guarded(self.audit)
            n = 0
            every = max(0, self.config.resync_every)
            while not self._stop.wait(self.config.interval_s):
                n += 1
                guarded(self.audit_resync if every and n % every == 0
                        else self.audit_tick)
            return
        while not self._stop.wait(self.config.interval_s):
            guarded(self.audit)

    def stop(self) -> None:
        self._stop.set()

    # --- one sweep (reference: audit(), manager.go:258) -----------------
    def audit(self) -> AuditRun:
        """One full pass: a relist sweep, or in snapshot mode a pass over
        every resident row."""
        if self._snapshot_mode():
            return self._audit_snapshot_impl(full=True)
        t0 = time.time()
        run = AuditRun(timestamp=_now_rfc3339())
        run.n_devices = 1 if self.evaluator is not None else 0
        constraints = self._audit_constraints()
        if not constraints:
            run.duration_s = time.time() - t0
            return run

        limit = self.config.violations_limit
        kept: dict = {(c.kind, c.name): [] for c in constraints}
        totals: dict = {(c.kind, c.name): 0 for c in constraints}
        device = self.evaluator is not None and self._render_driver() \
            is not None
        counter = [0]
        self._sweep_serial(constraints, device, kept, totals, limit,
                           counter, run)
        run.total_objects = counter[0]
        run.total_violations = totals
        run.kept = kept
        run.duration_s = time.time() - t0
        self._write_statuses(run, constraints)
        return run

    def _render_driver(self):
        """The driver that renders device hits (the port's TorchDriver)."""
        return next(
            (d for d in self.client.drivers if hasattr(d, "render_query")),
            None,
        )

    def _chunk_source(self, constraints, use_router, counter):
        """Yield ``(objects, constraint_subset)`` sweep chunks in canonical
        order.

        kind-bucketed routing (device path): objects stream into
        per-kind-group chunks (parallel/sweep.make_kind_router — the
        match-kinds prefilter of manager.go:427-483 applied per template),
        so objects no template can match skip the device entirely.
        ``counter[0]`` accumulates listed objects."""
        if use_router:
            from gatekeeper_tpu_torch.parallel.sweep import make_kind_router

            router = make_kind_router(constraints)
            cons_of_group: dict = {}
            bufs: dict = {}  # group -> pending chunk
            for obj in self.lister():
                counter[0] += 1
                g = router(peek_kind(obj))
                if not g:
                    continue  # no template's match reaches this kind
                buf = bufs.setdefault(g, [])
                buf.append(obj)
                if len(buf) >= self.config.chunk_size:
                    cg = cons_of_group.get(g)
                    if cg is None:
                        cg = [c for c in constraints if c.kind in g]
                        cons_of_group[g] = cg
                    yield buf, cg
                    bufs[g] = []
            for g, buf in bufs.items():
                if buf:
                    yield buf, [c for c in constraints if c.kind in g]
        else:
            chunk: list = []
            for obj in self.lister():
                chunk.append(obj)
                counter[0] += 1
                if len(chunk) >= self.config.chunk_size:
                    yield chunk, constraints
                    chunk = []
            if chunk:
                yield chunk, constraints

    # --- serial schedule --------------------------------------------------
    def _sweep_serial(self, constraints, device, kept, totals, limit,
                      counter, run=None):
        """One thread lists + flattens + dispatches chunks; the device runs
        asynchronously, and after each submit any in-flight chunk whose
        result is already ready (its CUDA event has fired) is collected +
        folded.  ``submit_window`` bounds the chunks in flight."""
        window: deque = deque()  # (pending, objects, constraint subset, i)
        max_inflight = max(1, self.config.submit_window)
        # reduced-collect kept budget: each dispatch tells the device how
        # many kept slots per constraint remain, so drained constraints
        # ship zero kept coordinates.  Read at dispatch time the budget is
        # always >= the fold-time remainder, so the device selection stays
        # a superset of what the fold keeps.
        budget_fn = None
        if device:
            budget_fn = (lambda con:
                         limit - len(kept.get(con.key(), ())))
        retries = max(0, self.config.chunk_retries)

        def chunk_failed(exc, phase):
            """Retry budget exhausted: skip the chunk, flag the run."""
            if run is not None:
                run.failed_chunks += 1
                run.incomplete = True
            log_event("warning",
                      "audit chunk dropped after exhausting retries",
                      event_type="audit_chunk_failed", phase=phase,
                      error=str(exc))

        def chunk_retry(exc, phase):
            if run is not None:
                run.retried_chunks += 1

        def submit_once(objs, cons):
            return self.evaluator.sweep_submit(
                cons, objs, return_bits=self.config.exact_totals,
                budget=budget_fn)

        def fold_oldest():
            # retry covers the non-mutating phases ONLY (submit/collect):
            # once the fold touches kept/totals a re-run would double
            # count, so a fold failure drops the chunk instead
            pending, objs, cons, _chunk_i = window.popleft()
            last = None
            swept = None
            for attempt in range(retries + 1):
                try:
                    if attempt > 0:
                        # a failed collect can't be re-fetched: the whole
                        # chunk re-submits through flatten/dispatch
                        chunk_retry(last, "collect")
                        pending = submit_once(objs, cons)
                    swept = self.evaluator.sweep_collect(pending)
                    break
                except Exception as e:  # noqa: PERF203
                    last = e
            else:
                chunk_failed(last, "collect")
                return
            try:
                t0 = time.perf_counter()
                self._process_swept(swept, objs, cons, kept, totals, limit)
                self.perf["fold_render"] = (
                    self.perf.get("fold_render", 0.0)
                    + time.perf_counter() - t0)
            except Exception as e:
                chunk_failed(e, "fold")

        def submit(objects, cons, chunk_i):
            if device:
                last = None
                for attempt in range(retries + 1):
                    try:
                        if attempt > 0:
                            chunk_retry(last, "submit")
                        pending = submit_once(objects, cons)
                        break
                    except Exception as e:  # noqa: PERF203
                        last = e
                else:
                    chunk_failed(last, "submit")
                    return
                window.append((pending, objects, cons, chunk_i))
                while window and (len(window) > max_inflight
                                  or _sweep_ready(window[0][0])):
                    self.perf["n_eager_collects"] = (
                        self.perf.get("n_eager_collects", 0) + 1)
                    fold_oldest()
            else:
                # interpreter lane: evaluate into CHUNK-LOCAL dicts and
                # merge only on success, so a retry can never double count
                last = None
                for attempt in range(retries + 1):
                    try:
                        if attempt > 0:
                            chunk_retry(last, "interp")
                        kept_c = {c.key(): [] for c in cons}
                        totals_c = {c.key(): 0 for c in cons}
                        self._audit_chunk(objects, cons, kept_c,
                                          totals_c, limit)
                        for key, n in totals_c.items():
                            totals[key] += n
                        for key, vs in kept_c.items():
                            for v in vs:
                                if len(kept[key]) < limit:
                                    kept[key].append(v)
                        return
                    except Exception as e:  # noqa: PERF203
                        last = e
                chunk_failed(last, "interp")

        src = iter(self._chunk_source(constraints, device, counter))
        chunk_i = -1
        while True:
            try:
                objs, cons = next(src)
                chunk_i += 1
            except StopIteration:
                break
            except Exception as e:
                # the lister died mid-iteration — finish with what was
                # listed and mark the pass incomplete
                if run is not None:
                    run.incomplete = True
                log_event("warning",
                          "audit lister failed mid-sweep; finishing "
                          "with partial results",
                          event_type="audit_lister_failed", error=str(e))
                break
            submit(objs, cons, chunk_i)
        while window:  # drain: blocking collect of the tail chunks
            fold_oldest()

    # --- chunk evaluation ------------------------------------------------
    def _audit_chunk(self, objects, constraints, kept, totals, limit):
        """No-evaluator path: every constraint goes through its template's
        own driver."""
        target = self.client.target
        reviews = [
            target.handle_review(
                AugmentedUnstructured(object=o, source=SOURCE_ORIGINAL)
            )
            for o in objects
        ]
        self._eval_via_drivers(constraints, objects, reviews, kept, totals,
                               limit)

    def _eval_via_drivers(self, constraints, objects, reviews, kept, totals,
                          limit):
        """Evaluate constraints through their own template's driver's
        ``query_batch``.  This is the lane for every constraint the device
        sweep did not cover: non-lowered Rego templates and referential
        templates whose inventory tables are inexact for the current data
        version."""
        per_row = self._eval_rows_via_drivers(constraints, objects, reviews)
        for oi in sorted(per_row):
            for key, results in per_row[oi].items():
                if key not in totals:
                    continue
                totals[key] += len(results)
                con = self.client.get_constraint(*key)
                for msg, details in results:
                    if len(kept[key]) < limit:
                        kept[key].append(
                            self._violation(con, objects[oi], msg, details))

    def _eval_rows_via_drivers(self, constraints, objects,
                               reviews=None) -> dict:
        """Exact-lane evaluation with per-row capture:
        ``{oi: {con_key: [(msg, details), ...]}}`` — each constraint
        through its own template's driver's ``query_batch``, on the
        sweep's device (without a sweep, the driver's own).  The relist
        fold and the snapshot's verdict store both read it."""
        out: dict = {}
        if not constraints:
            return out
        target = self.client.target
        if reviews is None:
            reviews = [target.handle_review(AugmentedUnstructured(
                object=o, source=SOURCE_ORIGINAL)) for o in objects]
        wanted = {c.key() for c in constraints}
        by_driver: dict[int, tuple] = {}
        for con in constraints:
            d = self.client._template_driver.get(con.kind)
            if d is None:
                continue  # no template: constraint cannot be evaluated
            by_driver.setdefault(id(d), (d, []))[1].append(con)
        device = self.evaluator.device if self.evaluator is not None else None
        cfg = ReviewCfg(enforcement_point=AUDIT_EP)
        for d, cons in by_driver.values():
            responses = d.query_batch(target.name, cons, reviews, cfg,
                                      device=device)
            for oi, resp in enumerate(responses):
                for r in resp.results:
                    key = (r.constraint.get("kind", ""),
                           (r.constraint.get("metadata") or {})
                           .get("name", ""))
                    if key in wanted:
                        out.setdefault(oi, {}).setdefault(key, []).append(
                            (r.msg, r.details))
        return out

    @staticmethod
    def fold_swept(swept, n_objects, render, limit, exact, budget=None):
        """Yield (constraint, total, kept[(oi, msg, details)]) per
        constraint of a device sweep result — the single definition of the
        kept/total fold.

        ``render(con, oi)`` -> list of exact-engine Results for one hit.
        ``exact``: totals count RESULTS via the complete hit rows; otherwise
        totals are the device's violating-object counts and only first-k
        hits render.  ``budget(con)`` -> remaining run-level kept slots
        for a constraint (defaults to ``limit``)."""
        for kind, (kcons, idx, valid, counts, bits) in swept.items():
            for ci, con in enumerate(kcons):
                kept_list: list = []
                cap = limit if budget is None else min(limit, budget(con))
                if exact and bits is not None:
                    # exact totals count RESULTS: every hit must render
                    # regardless of remaining kept budget
                    hit_idx = violation_rows(bits, ci, n_objects)
                    total = 0
                    for oi in hit_idx.tolist():
                        results = render(con, oi)
                        total += len(results)
                        for r in results:
                            if len(kept_list) < cap:
                                kept_list.append(
                                    (oi, r.msg,
                                     (r.metadata or {}).get("details")))
                else:
                    total = int(counts[ci])
                    for j in range(idx.shape[1]):
                        if not valid[ci, j] or len(kept_list) >= cap:
                            continue
                        oi = int(idx[ci, j])
                        for r in render(con, oi):
                            if len(kept_list) < cap:
                                kept_list.append(
                                    (oi, r.msg,
                                     (r.metadata or {}).get("details")))
                yield con, total, kept_list

    def _process_swept(self, swept, objects, constraints, kept, totals,
                       limit):
        """Fold one chunk's device results into the run state and run the
        non-lowered kinds through the exact engine."""
        target = self.client.target
        review_cache: dict = {}

        def get_review(oi):
            # per-index lazy: a chunk renders only its kept hits
            r = review_cache.get(oi)
            if r is None:
                r = target.handle_review(AugmentedUnstructured(
                    object=objects[oi], source=SOURCE_ORIGINAL))
                review_cache[oi] = r
            return r

        def get_reviews():
            return [get_review(oi) for oi in range(len(objects))]

        exact = self.config.exact_totals
        render_obj = self._render_fn(review_of=get_review)

        def render(con, oi):
            return render_obj(con, objects[oi], cache_key=oi)

        for con, total, kept_list in self.fold_swept(
                swept, len(objects), render, limit, exact,
                budget=lambda con: limit - len(kept[con.key()])):
            key = con.key()
            totals[key] += total
            for oi, msg, details in kept_list:
                if len(kept[key]) < limit:
                    kept[key].append(
                        self._violation(con, objects[oi], msg, details))
        # everything the device sweep did not cover (non-lowered kinds,
        # inventory-inexact referential kinds) goes through its own
        # driver's exact path
        rest = [c for c in constraints if c.kind not in swept]
        if rest:
            self._eval_via_drivers(rest, objects, get_reviews(), kept,
                                   totals, limit)

    def _violation(self, con, obj, msg, details) -> Violation:
        group, version, kind = gvk_of(obj)
        meta = obj.get("metadata") or {}
        actions = con.actions_for(AUDIT_EP)
        action = actions[0] if actions else con.enforcement_action
        return Violation(
            constraint=con,
            message=msg,
            enforcement_action=action,
            group=group,
            version=version,
            kind=kind,
            name=meta.get("name", "") or "",
            namespace=meta.get("namespace", "") or "",
            details=details,
        )

    def _render_fn(self, review_of=None):
        """``render(con, obj, cache_key=None)`` -> the exact engine's
        Results for one (constraint, object) hit, through the render
        driver: the same path for both audit sources, so messages and
        details agree across them.  Reviews are cached per ``cache_key``;
        ``review_of(cache_key)`` supplies them instead when given."""
        target = self.client.target
        driver = self._render_driver()
        cfg = ReviewCfg(enforcement_point=AUDIT_EP)
        cache: dict = {}

        def render(con, obj, cache_key=None):
            self.perf["n_renders"] = self.perf.get("n_renders", 0) + 1
            if review_of is not None:
                review = review_of(cache_key)
            else:
                review = cache.get(cache_key) if cache_key is not None \
                    else None
                if review is None:
                    review = target.handle_review(AugmentedUnstructured(
                        object=obj, source=SOURCE_ORIGINAL))
                    if cache_key is not None:
                        cache[cache_key] = review
            return driver.render_query(target.name, con, review, cfg).results

        return render

    # --- snapshot lane (gatekeeper_tpu_torch/snapshot/) --------------------
    def _snapshot_mode(self) -> bool:
        return (self.config.audit_source == "snapshot"
                and self.snapshot is not None)

    def _audit_constraints(self) -> list:
        return [c for c in self.client.constraints()
                if c.actions_for(AUDIT_EP)]

    def audit_tick(self) -> AuditRun:
        """Incremental snapshot audit: evaluate ONLY the dirty row set
        (rows the watch patched since the last evaluation) — O(churn), not
        O(cluster).  Cluster-wide totals and kept lists come from the
        per-row verdict store (clean rows keep their last results)."""
        return self._audit_snapshot_impl(full=False)

    def _snapshot_ready(self, constraints) -> None:
        """Adopt the constraint set, rebuild if stale, apply queued watch
        events."""
        snap = self.snapshot
        rechunks = snap.rechunk_count
        if snap.set_constraints(constraints):
            n = snap.rebuild(self.lister)
            log_event("info", "snapshot rebuilt",
                      event_type="snapshot_rebuilt", rows=n,
                      generation=snap.generation)
        elif snap.rechunk_count != rechunks:
            # a template/constraint change was absorbed by re-chunking the
            # resident rows (zero relist); every row is dirty now
            log_event("info", "snapshot rechunked (no relist)",
                      event_type="snapshot_rechunked",
                      rows=snap.live_count(), generation=snap.generation)
        snap.pump()

    def _audit_snapshot_impl(self, full: bool) -> AuditRun:
        t0 = time.time()
        run = AuditRun(timestamp=_now_rfc3339())
        run.n_devices = 1 if self.evaluator is not None else 0
        constraints = self._audit_constraints()
        if not constraints:
            run.duration_s = time.time() - t0
            return run
        snap = self.snapshot
        self._snapshot_ready(constraints)
        rows = snap.all_rows() if full else snap.dirty_rows()
        n_rows = sum(len(v) for v in rows.values())
        self.perf["snapshot_rows_evaluated"] = (
            self.perf.get("snapshot_rows_evaluated", 0.0) + n_rows)
        self.perf["last_rows_evaluated"] = float(n_rows)
        # bytes this pass shipped host -> device: the resident lane's
        # counter (gather indices, cache misses, uploads and patches) plus
        # the host-column lane's uploads — a warm pass over unchanged
        # resident rows reads ZERO
        ev = self.evaluator
        h2d0 = (ev.perf.get("resident_h2d_bytes", 0.0)
                + ev.perf.get("h2d_bytes", 0.0)) if ev is not None else 0.0
        self._snapshot_eval(rows, run)
        run.total_objects = snap.live_count()
        totals, kept = self._snapshot_collect(constraints)
        run.total_violations = totals
        run.kept = kept
        run.duration_s = time.time() - t0
        if ev is not None:
            self.perf["tick_h2d_bytes"] = (
                ev.perf.get("resident_h2d_bytes", 0.0)
                + ev.perf.get("h2d_bytes", 0.0)) - h2d0
        self._write_statuses(run, constraints)
        return run

    def _snapshot_eval(self, rows_by_store, run) -> None:
        """Evaluate snapshot rows group by group: device-resident chunks
        where the residency serves the group, else host columns sliced
        from the store (zero flatten either way); non-lowered kinds run
        their drivers' exact lane over the same rows.  Each evaluated
        row's verdict-store entries are REPLACED.  A chunk that exhausts
        its retries keeps its rows dirty and their previous entries, and
        flags the run incomplete."""
        snap = self.snapshot
        ev = self.evaluator
        retries = max(0, self.config.chunk_retries)
        chunk_size = max(1, self.config.chunk_size)
        max_inflight = max(1, self.config.submit_window)

        def chunk_failed(exc):
            run.failed_chunks += 1
            run.incomplete = True
            log_event("warning",
                      "snapshot audit chunk dropped after exhausting "
                      "retries (rows stay dirty; previous verdicts kept)",
                      event_type="audit_chunk_failed", phase="snapshot",
                      error=str(exc))

        for store, rowlist in rows_by_store.items():
            # resident lane: sync the device mirror ONCE per store per
            # pass (scatter-patch for dirty rows, nothing when clean);
            # None means this group serves host columns this pass
            rg = None
            if self.residency is not None and ev is not None \
                    and store.lowered:
                rg = self.residency.prepare(store)
            window: deque = deque()

            def submit_chunk(positions, objects, _rg=rg, _store=store):
                if _rg is not None:
                    flat = ev.sweep_flatten_resident(
                        _rg, positions, return_bits=True)
                    if flat is not None:
                        self._perf_count("snapshot_resident_chunks")
                        return ev.sweep_dispatch(flat)
                    # the programs changed under the mirror: host columns
                self._perf_count("snapshot_host_chunks")
                batch = _store.slice_rows(positions,
                                          pad_n=ev._pad(len(positions)))
                flat = ev.sweep_flatten_from_batch(
                    _store.cons, batch, objects, return_bits=True,
                    alias=_store.alias)
                return ev.sweep_dispatch(flat)

            def fold_oldest(_store=store, _submit=submit_chunk,
                            _window=window):
                pending, gids, positions, objects = _window.popleft()
                last = None
                swept = {}
                for attempt in range(retries + 1):
                    try:
                        if attempt > 0:
                            run.retried_chunks += 1
                            pending = _submit(positions, objects)
                        if pending is not None:
                            swept = ev.sweep_collect(pending)
                        break
                    except Exception as e:  # noqa: PERF203
                        last = e
                else:
                    chunk_failed(last)
                    return
                try:
                    t0 = time.perf_counter()
                    self._fold_snapshot_chunk(swept, _store.cons, gids,
                                              objects)
                    snap.mark_clean(gids)
                    self.perf["fold_render"] = (
                        self.perf.get("fold_render", 0.0)
                        + time.perf_counter() - t0)
                except Exception as e:
                    chunk_failed(e)

            for i in range(0, len(rowlist), chunk_size):
                chunk = rowlist[i: i + chunk_size]
                gids = [g for g, _p in chunk]
                positions = [p for _g, p in chunk]
                objects = [store.row_obj(p) for p in positions]
                pending = None
                if store.lowered and ev is not None:
                    last = None
                    for attempt in range(retries + 1):
                        try:
                            if attempt > 0:
                                run.retried_chunks += 1
                            pending = submit_chunk(positions, objects)
                            break
                        except Exception as e:  # noqa: PERF203
                            last = e
                    else:
                        chunk_failed(last)
                        continue
                window.append((pending, gids, positions, objects))
                while window and (len(window) > max_inflight
                                  or _sweep_ready(window[0][0])):
                    fold_oldest()
            while window:
                fold_oldest()

    def _perf_count(self, name: str) -> None:
        self.perf[name] = self.perf.get(name, 0.0) + 1.0

    def _fold_snapshot_chunk(self, swept, cons_g, gids, objects) -> None:
        """Replace the verdict-store entries of an evaluated row set:
        device hits from the complete hit rows (exact-totals mode renders
        every hit now; otherwise messages render lazily at kept time),
        non-lowered constraints via their drivers' exact lane."""
        snap = self.snapshot
        exact = self.config.exact_totals
        for gid in gids:
            snap.verdicts.clear_gid(gid)
        render = self._render_fn()
        k = len(gids)
        for _kind, (kcons, _idx, _valid, _counts, bits) in swept.items():
            for ci, con in enumerate(kcons):
                ckey = con.key()
                for oi in violation_rows(bits, ci, k).tolist():
                    if exact:
                        results = render(con, objects[oi], cache_key=oi)
                        msgs = tuple(
                            (r.msg, (r.metadata or {}).get("details"))
                            for r in results)
                        snap.verdicts.set(ckey, gids[oi], len(results),
                                          msgs)
                    else:
                        snap.verdicts.set(ckey, gids[oi], 1, None)
        rest = [c for c in cons_g if c.kind not in swept]
        if rest:
            per_row = self._eval_rows_via_drivers(rest, objects)
            for oi, per_con in per_row.items():
                for ckey, results in per_con.items():
                    snap.verdicts.set(ckey, gids[oi], len(results),
                                      tuple(results))

    def _snapshot_collect(self, constraints) -> tuple:
        """(totals, kept) derived from the verdict store: totals sum every
        row's contribution; kept takes the first ``limit`` rows in stable
        row-id order (messages render lazily on first derivation and are
        cached back into the store)."""
        snap = self.snapshot
        limit = self.config.violations_limit
        totals = {c.key(): 0 for c in constraints}
        kept: dict = {c.key(): [] for c in constraints}
        render = self._render_fn()
        for con in constraints:
            ckey = con.key()
            for gid, count, msgs in snap.verdicts.rows(ckey):
                totals[ckey] += count
                if len(kept[ckey]) >= limit:
                    continue
                obj = snap.obj_of(gid)
                if msgs is None:
                    results = render(con, obj, cache_key=gid)
                    msgs = tuple(
                        (r.msg, (r.metadata or {}).get("details"))
                        for r in results)
                    snap.verdicts.set_msgs(ckey, gid, msgs)
                for msg, details in msgs:
                    if len(kept[ckey]) < limit:
                        kept[ckey].append(
                            self._violation(con, obj, msg, details))
        return totals, kept

    def audit_resync(self) -> AuditRun:
        """The periodic resync differential (snapshot mode): drain the
        dirty set, then re-list + re-flatten fresh and require the
        resident snapshot to be identical — columns (per-row signatures
        over the same vocab), vocab (the fresh flatten interns nothing
        new) and, unrotated, verdicts (totals and kept lists against a
        fresh relist sweep, compared canonically).  A divergence marks
        the run incomplete and invalidates the snapshot: the next pass
        rebuilds."""
        rotate = max(0, self.config.resync_rotate)
        rotor = None
        if rotate > 1:
            rotor = (self._resync_phase % rotate, rotate)
            self._resync_phase = (self._resync_phase + 1) % rotate
        run = self._audit_snapshot_impl(full=False)
        snap = self.snapshot
        diff = snap.resync_differential(self.lister, rotor=rotor)
        if diff is None and rotor is None:
            constraints = self._audit_constraints()
            kept_f: dict = {c.key(): [] for c in constraints}
            totals_f: dict = {c.key(): 0 for c in constraints}
            device = self.evaluator is not None \
                and self._render_driver() is not None
            self._sweep_serial(constraints, device, kept_f, totals_f,
                               self.config.violations_limit, [0],
                               AuditRun(timestamp=run.timestamp))
            diff = self._verdicts_differ_canonical(
                run.kept, run.total_violations, kept_f, totals_f,
                self.config.violations_limit)
        self.last_resync_diff = diff
        if diff is None:
            log_event("info", "snapshot resync differential clean",
                      event_type="snapshot_resync_clean",
                      rows=snap.live_count(),
                      scope=f"1/{rotor[1]}" if rotor else "full")
        else:
            run.incomplete = True
            snap.invalidate()
            log_event("warning",
                      "snapshot resync differential diverged; snapshot "
                      "invalidated (next pass rebuilds)",
                      event_type="snapshot_resync_diverged",
                      difference=diff)
        self.perf["resync_ok"] = 0.0 if diff else 1.0
        return run

    @staticmethod
    def _verdicts_differ_canonical(kept_a, totals_a, kept_b, totals_b,
                                   limit):
        """None when two runs' verdicts agree; kept lists compare as
        CANONICAL (sorted) sets — the snapshot's row order and a relist's
        list order legitimately differ, and when a constraint's
        violations exceed the kept limit the top-K *selection* under
        different orders is not canonical (only the kept COUNT is
        compared there; totals stay exact always)."""
        if totals_a != totals_b:
            keys = [k for k in totals_a
                    if totals_a.get(k) != totals_b.get(k)]
            return (f"totals differ for {keys[:3]}: "
                    f"{[totals_a.get(k) for k in keys[:3]]} vs "
                    f"{[totals_b.get(k) for k in keys[:3]]}")
        if set(kept_a) != set(kept_b):
            return "kept constraint sets differ"
        for key in kept_a:
            va = sorted((v.message, v.kind, v.name, v.namespace,
                         v.enforcement_action) for v in kept_a[key])
            vb = sorted((v.message, v.kind, v.name, v.namespace,
                         v.enforcement_action) for v in kept_b[key])
            if len(va) != len(vb):
                return f"kept counts differ for {key}"
            if len(va) < limit and va != vb:
                return f"kept violations differ for {key}"
        return None

    # --- status writeback (reference: writeAuditResults, manager.go:947) -
    def _write_statuses(self, run: AuditRun, constraints):
        for con in constraints:
            key = con.key()
            status = {
                "auditTimestamp": run.timestamp,
                "totalViolations": run.total_violations.get(key, 0),
                # explicit partial-result marker, only written when set
                **({"incomplete": True} if run.incomplete else {}),
                "violations": [
                    {
                        "message": v.message,
                        "enforcementAction": v.enforcement_action,
                        "group": v.group,
                        "version": v.version,
                        "kind": v.kind,
                        "name": v.name,
                        "namespace": v.namespace,
                    }
                    for v in run.kept.get(key, [])
                ],
            }
            con.raw.setdefault("status", {}).update(status)


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
