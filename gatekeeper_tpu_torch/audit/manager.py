"""Audit sweep: the enforcement point that reviews every cluster object.

Port of ``gatekeeper_tpu/audit/manager.py``: the serial and the staged
pipeline schedules over a relisting lister, and the resident-snapshot lane (``audit_source=
"snapshot"``: full passes and incremental ticks over
``snapshot/store.ClusterSnapshot`` rows, device-resident through
``snapshot/device_residency.DeviceResidency`` when one is given, with
the periodic resync differential), plus the ``run_forever`` loop of both,
and the expansion generator stage of both (``expand_generated``: generator
objects expand through ``mutlane.ExpansionStage`` and their resultants
audit as ``Source=Generated`` chunks).
Reference flow (pkg/audit/manager.go:258-973): list every auditable object
(chunked) → review each against all constraints → keep the first K
violations per constraint (LimitQueue) → write constraint status.

Device middle: each chunk flattens to columns and the whole constraint ×
chunk grid evaluates in one device pass (``parallel/sweep.SweepEvaluator``);
only the ≤K kept violations per constraint render to messages through the
exact interpreter.  Kinds the sweep does not cover go to their driver's
``query_batch`` (the admission path), on the sweep's device.

The relist's schedule (``AuditConfig.pipeline``): the serial one lists,
flattens and dispatches on the caller's thread and folds each chunk whose
CUDA event has fired; the staged pipeline (``pipeline/executor.py``)
lists on the caller's thread and runs flatten, dispatch, collect and
fold_render on threads of their own with bounded queues, so chunk K's
flatten overlaps chunk K-1's device work and fold.  Both fold chunks in
submission order, so their totals, kept lists and messages are identical.
The snapshot lane evaluates serially, as in the JAX package.

With a ``spiller`` (``snapshot/persist.SnapshotSpiller``) the snapshot
lane persists: a clean resync requests a background spill,
``run_forever``'s exit flushes a final one, and a snapshot loaded from a
spill (``warm_loaded``) starts the loop with an incremental tick instead
of the full pass.

Hooks, as in the JAX package: the ``audit.sweep``, ``audit.tick``,
``snapshot.resync``, ``expansion.stage`` and per-chunk spans; the last-run,
incomplete, retry, failed-chunk and degradation metrics; the brownout
yield of the device lane before each relist chunk is submitted
(``resilience/overload.yield_device_lane``); the ``resync_defer``
degradation; and exact per-template render cost records.

Each finished run goes, as in the JAX package, to the export system
(``export_system=``: audit started, every kept violation, audit ended),
to the structured log (``log_violations=``) and to an event sink
(``event_sink=``, called with the run).

The fleet seams (``fleet/evaluator.py``): ``cluster=`` scopes the manager
to one cluster of a fleet (a ``{cluster}`` copy of the last-run and
``tick_h2d_bytes`` gauges, and the brownout yield and the
``resync_defer`` degradation read for that cluster), ``status_writer=``
takes the constraint statuses (the runtime's constraint objects are
shared by its clusters), and ``fold_snapshot_segment`` /
``snapshot_collect`` fold one cluster's segment of a packed dispatch and
derive its totals and kept lists.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np

from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, Constraint
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.base import ReviewCfg
from gatekeeper_tpu_torch.expansion.aggregate import CHILD_MSG_PREFIX
from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED, SOURCE_ORIGINAL
from gatekeeper_tpu_torch.observability import tracing
from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
from gatekeeper_tpu_torch.utils.logging import log_event
from gatekeeper_tpu_torch.utils.rawjson import peek_kind
from gatekeeper_tpu_torch.utils.unstructured import gvk_of

# a gauge of this package beyond the reference's registry
# (``metrics/registry.py`` keeps the JAX package's names one for one):
# the seconds the cyclic garbage collector ran during the last audit pass
AUDIT_COLLECTOR_SECONDS = "audit_collector_seconds"


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
    # sweep schedule (--pipeline): 'on' takes the staged host pipeline
    # (pipeline/executor.py — flatten, dispatch, collect and fold on
    # their own threads with bounded queues, so chunk K's flatten
    # overlaps chunk K-1's collect/fold); 'off' and 'auto' the serial
    # one ('auto': the stages share the interpreter lock, see
    # pipeline.resolve_schedule); 'differential' runs BOTH schedules and
    # asserts bit-identical output (totals, kept order, messages)
    pipeline: str = "auto"
    # threads in the flatten stage; 0 = auto (2 on hosts with >=4
    # effective cores, else 1).  >1 worker makes vocab-intern ORDER
    # depend on thread timing (ids stay self-consistent, and verdicts and
    # messages identical); emission order stays canonical either way
    # (the executor restores input order)
    pipeline_flatten_workers: int = 0
    # bound of each inter-stage queue (chunks buffered between stages);
    # the collect stage's input bound is submit_window, not this
    pipeline_queue_cap: int = 2
    # how many chunks may be in flight on the device before the oldest is
    # collected (host memory + device memory bound)
    submit_window: int = 64
    # a chunk whose submit/collect raises is re-submitted up to
    # chunk_retries times, then SKIPPED — the run finishes with partial
    # results and an explicit `incomplete` marker.  Stage workers of the
    # pipelined schedule restart and re-run their item up to
    # pipeline_stage_retries times; past that the executor aborts and the
    # sweep reruns on the serial schedule
    chunk_retries: int = 1
    pipeline_stage_retries: int = 1
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
    # expansion generator stage (--audit-expand): generator objects
    # (Deployment etc.) listed by the sweep expand through the batched
    # mutlane.ExpansionStage and their resultants (implied Pods, with
    # Source=Generated mutation applied) are audited at sweep scale with
    # the template's enforcementAction override — policies on the
    # generated GVK see violations BEFORE any Pod exists (shift-left)
    expand_generated: bool = False
    # data-parallel chunk sharding (--shard-chunks): pack K consecutive
    # same-group chunks into ONE dispatch over the evaluator's mesh (the
    # object axis splits over its data shards, parallel/sweep.py), so with
    # K ~= the mesh size each shard evaluates ~chunk_size objects while
    # the per-dispatch fixed costs amortize K-fold.  Objects keep their
    # listed order inside a packed chunk, so totals are unchanged; a
    # constraint whose kinds span more than one group keeps its first k
    # violations in dispatch order, which the packing shifts (as in the
    # JAX package).  0/1 = off
    shard_chunks: int = 0


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
    answer through their CUDA event, RPC replies (RemoteEvaluator)
    through ``done()``."""
    ready = getattr(pending, "ready", None)
    if callable(ready):
        return ready()
    done = getattr(pending, "done", None)
    return done() if callable(done) else True


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
        expansion_system=None,  # expansion.ExpansionSystem (expand stage)
        spiller=None,  # snapshot.SnapshotSpiller (--snapshot-spill)
        metrics=None,  # metrics.registry.MetricsRegistry
        export_system=None,  # export.system.ExportSystem
        event_sink: Optional[Callable] = None,  # run -> None
        log_violations: bool = False,
        status_writer: Optional[Callable] = None,  # (con, status) -> None
        cluster: str = "",  # fleet scope: labels the staleness gauges
    ):
        self.client = client
        # where constraint statuses go: None writes them into the
        # constraint's own ``status`` (a fleet cluster keeps its own)
        self.status_writer = status_writer
        # fleet mode: a non-empty cluster id adds a {cluster}-labelled copy
        # of the last-run gauges (the per-cluster audit-staleness SLO
        # objectives age each cluster's audit off one shared registry)
        self.cluster = cluster
        self.metrics = metrics
        self.export_system = export_system
        self.event_sink = event_sink
        self.log_violations = log_violations
        self.lister = lister
        self.config = config or AuditConfig()
        self.evaluator = evaluator
        self.snapshot = snapshot
        # device-resident snapshot lane: when set, _snapshot_eval prefers
        # resident chunks and falls back to host columns per group
        # whenever the residency declines
        self.residency = residency
        self.expansion_system = expansion_system
        # expansion generator stage state: the batched stage (lazy), the
        # per-sweep generator-object tee, the Namespace inventory the
        # expand needs, and — snapshot mode — per-parent-gid generated
        # verdicts so the stage stays O(churn) like the base rows
        self._expansion_stage = None
        self._gen_buf: Optional[list] = None
        self._gen_ns: dict = {}
        self._gen_kinds: set = set()
        self._gen_verdicts: dict = {}
        # snapshot spill writer: a clean resync requests a background
        # spill, run_forever's exit flushes a final one; None = off
        self.spiller = None
        if spiller is not None:
            self.attach_spiller(spiller)
        # first difference of the last resync differential (None =
        # identical)
        self.last_resync_diff: Optional[str] = None
        self._resync_phase = 0  # rotated-resync rotor position
        self._stop = threading.Event()
        # per-phase seconds of the host's side of a pass (the evaluator
        # tracks its own flatten/masks/upload/dispatch/collect): listing and
        # routing (list_route), fold_render, render and n_renders, the
        # snapshot lane's snapshot_ready, snapshot_rows, snapshot_collect,
        # status_write, and the collector's seconds (gc, gc/<phase>), with
        # the snapshot lane's counters
        self.perf: dict = {}
        # the collector's hook, held while a pass runs
        self._collector = tracing.CollectorHook(self._perf_add)
        # the last pipelined pass's PipelineRun.summary() plus
        # device_wait_s and device_idle_fraction (None after a serial one)
        self.pipe_stats: Optional[dict] = None

    # --- spill persistence (snapshot/persist.py) -------------------------
    def attach_spiller(self, spiller) -> None:
        """Wire a SnapshotSpiller: the manager feeds it the generator
        stage's verdicts (they ride the spill's aux section, so a warm
        boot's totals include them without re-expanding clean parents) and
        flushes it at the loop's exit."""
        self.spiller = spiller
        spiller.aux_fn = lambda: {
            "gen_verdicts": dict(self._gen_verdicts)}

    def restore_spill_aux(self, aux: dict) -> None:
        """Adopt a loaded spill's aux section (``SnapshotSpill.load``'s
        ``aux``)."""
        gen = aux.get("gen_verdicts")
        if gen:
            self._gen_verdicts = dict(gen)

    # --- loop (reference: auditManagerLoop, manager.go:831) -------------
    def run_forever(self) -> None:
        """Audit every ``interval_s`` until :meth:`stop`.  Snapshot mode:
        a first full pass builds the snapshot and evaluates every row (a
        snapshot loaded from a spill starts with an incremental tick: its
        rows are clean, its verdicts persisted), then each interval runs
        an incremental tick over the dirty rows, and every
        ``resync_every``-th one the resync differential; at the exit a
        spiller writes a final spill.  A pass that raises is logged and
        the loop goes on."""
        def guarded(fn):
            try:
                fn()
            except Exception as e:
                log_event("error", "audit pass failed",
                          event_type="audit_pass_failed", error=repr(e))

        if self._snapshot_mode():
            guarded(self.audit_tick if self.snapshot.warm_loaded
                    else self.audit)
            n = 0
            every = max(0, self.config.resync_every)
            while not self._stop.wait(self.config.interval_s):
                n += 1
                guarded(self.audit_resync
                        if every and n % every == 0
                        and not self._resync_deferred()
                        else self.audit_tick)
            if self.spiller is not None:
                # a clean stop never loses the resident state it built
                guarded(self.spiller.spill_now)
            return
        while not self._stop.wait(self.config.interval_s):
            guarded(self.audit)

    def stop(self) -> None:
        self._stop.set()

    # --- one sweep (reference: audit(), manager.go:258) -----------------
    def audit(self) -> AuditRun:
        """One full pass under its root span: a relist sweep, or in
        snapshot mode a pass over every resident row."""
        with tracing.span("audit.sweep") as sp, self._collector:
            if self._snapshot_mode():
                sp.set_attribute("source", "snapshot")
                run = self._audit_snapshot_impl(full=True)
            else:
                run = self._audit_impl()
            sp.set_attribute("objects", run.total_objects)
            sp.set_attribute("duration_s", round(run.duration_s, 3))
            sp.set_attribute("violations",
                             sum(run.total_violations.values()))
            sp.set_attribute("flatten_workers", run.flatten_workers)
            if self.pipe_stats:
                sp.set_attribute("schedule", "pipelined")
                sp.set_attribute(
                    "device_idle_fraction",
                    self.pipe_stats.get("device_idle_fraction", 0.0))
            if run.incomplete:
                sp.set_attribute("incomplete", True)
            return run

    def _annotate_run(self, run: AuditRun) -> None:
        """Stamp the pass's ingest and dispatch geometry onto the run: the
        evaluator's mesh size (none in this process behind the sidecar
        lane) and the chunk coalescing."""
        mesh = getattr(self.evaluator, "mesh", None) \
            if self._local_evaluator() else None
        run.n_devices = int(mesh.size) if mesh is not None else 0
        run.flatten_workers = int(
            getattr(self.evaluator, "flatten_workers", 0) or 0)
        run.shard_chunks = max(
            0, int(getattr(self.config, "shard_chunks", 0) or 0))

    def _audit_impl(self) -> AuditRun:
        t0 = time.time()
        run = AuditRun(timestamp=_now_rfc3339())
        self._annotate_run(run)
        constraints = self._audit_constraints()
        if self.export_system is not None:
            self.export_system.publish_audit_started(run.timestamp)
        if not constraints:
            run.duration_s = time.time() - t0
            self._finish(run)
            return run

        gen_stage = self._gen_stage()
        self._gen_reset(gen_stage is not None)
        limit = self.config.violations_limit
        kept: dict = {(c.kind, c.name): [] for c in constraints}
        totals: dict = {(c.kind, c.name): 0 for c in constraints}
        device = self._device_lane() or self._sidecar_lane()
        from gatekeeper_tpu_torch.pipeline import resolve_schedule

        # staged-pipeline eligibility: a local evaluator exposing the
        # split flatten/dispatch stages; the sidecar lane (renders=True,
        # RPC replies) and the interpreter lane stay serial
        device_capable = (self._device_lane()
                          and hasattr(self.evaluator, "sweep_flatten")
                          and hasattr(self.evaluator, "sweep_dispatch"))
        schedule = resolve_schedule(self.config.pipeline, device_capable)
        self.pipe_stats = None
        self.perf["pipelined"] = 1.0 if schedule == "pipelined" else 0.0
        counter = [0]
        if schedule == "differential":
            # serial is the reference schedule; the pipelined pass must
            # reproduce it bit for bit (totals, kept order, messages)
            self._sweep_serial(constraints, device, kept, totals, limit,
                               counter, run)
            kept_p: dict = {k: [] for k in kept}
            totals_p: dict = {k: 0 for k in totals}
            self._sweep_pipelined(constraints, kept_p, totals_p, limit,
                                  [0], run)
            diff = self._schedules_differ(kept, totals, kept_p, totals_p)
            if diff:
                raise RuntimeError(
                    f"pipeline differential mismatch: {diff}")
            self.perf["pipeline_differential_ok"] = 1.0
        elif schedule == "pipelined":
            try:
                self._sweep_pipelined(constraints, kept, totals, limit,
                                      counter, run)
            except Exception as e:
                # a pipeline whose stage kept failing past its restart
                # budget aborts cleanly: the sweep reruns on the serial
                # schedule (chunks re-list from the source, so nothing is
                # dropped)
                log_event("warning",
                          "pipelined sweep failed; degrading to the "
                          "serial schedule",
                          event_type="audit_degraded", error=str(e))
                if self.metrics is not None:
                    from gatekeeper_tpu_torch.metrics import registry as M

                    self.metrics.inc_counter(
                        M.RESILIENCE_DEGRADED,
                        {"component": "audit", "to": "serial"})
                for k in kept:
                    kept[k] = []
                for k in totals:
                    totals[k] = 0
                counter[0] = 0
                self.pipe_stats = None
                self.perf["pipelined"] = 0.0
                self.perf["degraded_to_serial"] = (
                    self.perf.get("degraded_to_serial", 0.0) + 1.0)
                self._sweep_serial(constraints, device, kept, totals,
                                   limit, counter, run)
        else:
            self._sweep_serial(constraints, device, kept, totals, limit,
                               counter, run)
        run.total_objects = counter[0]
        if gen_stage is not None and self._gen_buf:
            # the generator stage: expanded resultants audit AFTER the
            # base pass so base kept-ordering is unchanged
            self._sweep_generated(gen_stage, self._gen_buf, constraints,
                                  kept, totals, limit, run)
        run.total_violations = totals
        run.kept = kept
        run.duration_s = time.time() - t0
        with tracing.phase(self._perf_add, "status_write",
                           "audit.status_write"):
            self._write_statuses(run, constraints)
            self._publish_metrics(run)
            self._finish(run)
        return run

    def _render_driver(self):
        """The driver that renders device hits (the port's TorchDriver)."""
        return next(
            (d for d in self.client.drivers if hasattr(d, "render_query")),
            None,
        )

    def _sidecar_lane(self) -> bool:
        """The evaluator is the Evaluate sidecar's (``RemoteEvaluator``):
        its Sweep RPC renders the kept violations and covers every
        constraint, so this process neither routes, renders nor touches a
        device."""
        return getattr(self.evaluator, "renders", False) is True

    def _local_evaluator(self) -> bool:
        """An evaluator on this process's device (not the sidecar's)."""
        return self.evaluator is not None and not self._sidecar_lane()

    def _device_lane(self) -> bool:
        """A local evaluator with the driver that renders its hits."""
        return (self._local_evaluator()
                and self._render_driver() is not None)

    def _chunk_source(self, constraints, use_router, counter):
        """The chunk stream both schedules consume: the canonical chunking
        (:meth:`_chunk_source_impl`), coalesced by ``shard_chunks``: K
        consecutive chunks of the SAME constraint group pack into one
        dispatch over the mesh.  Objects keep their listed order inside a
        packed chunk; only the emission order across groups shifts, which
        only the kept selection of a constraint whose kinds span more than
        one group can see (the JAX package's coalescing does the same)."""
        src = self._listed(self._chunk_source_impl(constraints, use_router,
                                                   counter))
        k = max(1, int(getattr(self.config, "shard_chunks", 0) or 1))
        if k <= 1:
            yield from src
            return
        pend: dict = {}  # group key -> [objects, cons, chunks packed]
        for objs, cons in src:
            key = tuple((c.kind, c.name) for c in cons)
            buf = pend.get(key)
            if buf is None:
                pend[key] = [list(objs), cons, 1]
                continue
            buf[0].extend(objs)
            buf[2] += 1
            if buf[2] >= k:
                del pend[key]
                yield buf[0], buf[1]
        for objs, cons, _count in pend.values():  # partial tails
            yield objs, cons

    def _listed(self, src):
        """``src``'s chunks, each timed from the generator's resume to its
        yield as the ``list_route`` phase (the lister's pages, the kind
        peek, the router and the generator tee; not the consumer's
        time)."""
        it = iter(src)
        while True:
            with tracing.phase(self._perf_add, "list_route",
                               "audit.list_route"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def _chunk_source_impl(self, constraints, use_router, counter):
        """Yield ``(objects, constraint_subset)`` sweep chunks in canonical
        order.

        kind-bucketed routing (device path): objects stream into
        per-kind-group chunks (parallel/sweep.make_kind_router — the
        match-kinds prefilter of manager.go:427-483 applied per template),
        so objects no template can match skip the device entirely.
        ``counter[0]`` accumulates listed objects.  Every listed object
        passes the generator tee (:meth:`_gen_tee`) when it is armed."""
        if self._gen_buf is not None:
            self._gen_buf = []  # one tee per sweep pass
        if use_router:
            from gatekeeper_tpu_torch.parallel.sweep import make_kind_router

            router = make_kind_router(constraints)
            cons_of_group: dict = {}
            bufs: dict = {}  # group -> pending chunk
            for obj in self.lister():
                counter[0] += 1
                k = peek_kind(obj)
                self._gen_tee(obj, k)
                g = router(k)
                if not g:
                    continue  # no template's match reaches this kind
                buf = bufs.setdefault(g, [])
                buf.append(obj)
                if len(buf) >= self.config.chunk_size:
                    cg = cons_of_group.get(g)
                    if cg is None:
                        cg = [c for c in constraints if c.kind in g]
                        cons_of_group[g] = cg
                    self._brownout_yield()
                    yield buf, cg
                    bufs[g] = []
            for g, buf in bufs.items():
                if buf:
                    yield buf, [c for c in constraints if c.kind in g]
        else:
            chunk: list = []
            for obj in self.lister():
                if self._gen_buf is not None:
                    self._gen_tee(obj, gvk_of(obj)[2])
                chunk.append(obj)
                counter[0] += 1
                if len(chunk) >= self.config.chunk_size:
                    self._brownout_yield()
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
        # the sidecar lane's Sweep RPC takes no budget and no routing
        local = device and not self._sidecar_lane()
        budget_fn = None
        if local:
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
            self._count_chunk_failed()

        def chunk_retry(exc, phase):
            if run is not None:
                run.retried_chunks += 1
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(M.RESILIENCE_RETRIES,
                                         {"dependency": "audit_chunk"})

        def submit_once(objs, cons):
            return self.evaluator.sweep_submit(
                cons, objs, return_bits=self.config.exact_totals,
                **({"budget": budget_fn} if budget_fn is not None else {}))

        def fold_oldest():
            # retry covers the non-mutating phases ONLY (submit/collect):
            # once the fold touches kept/totals a re-run would double
            # count, so a fold failure drops the chunk instead
            pending, objs, cons, chunk_i = window.popleft()
            with tracing.span("audit.chunk.collect_fold", chunk=chunk_i,
                              objects=len(objs)) as sp, \
                    self._renders_on(sp):
                last = None
                swept = None
                for attempt in range(retries + 1):
                    try:
                        if attempt > 0:
                            # a failed collect can't be re-fetched: the
                            # whole chunk re-submits through flatten/dispatch
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
                    with tracing.phase(self._perf_add, "fold_render",
                                       "audit.fold_render"):
                        self._process_swept(swept, objs, cons, kept, totals,
                                            limit)
                except Exception as e:
                    chunk_failed(e, "fold")

        def submit(objects, cons, chunk_i):
            if device:
                with tracing.span("audit.chunk.submit", chunk=chunk_i,
                                  objects=len(objects)):
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
                    fold_oldest()
            else:
                # interpreter lane: evaluate into CHUNK-LOCAL dicts and
                # merge only on success, so a retry can never double count
                with tracing.span("audit.chunk.interp", chunk=chunk_i,
                                  objects=len(objects)):
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

        src = iter(self._chunk_source(constraints, local, counter))
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

    # --- pipelined schedule (staged executor) ----------------------------
    def _sweep_pipelined(self, constraints, kept, totals, limit, counter,
                         run=None):
        """Staged host pipeline: ``list -> flatten -> dispatch -> collect
        -> fold_render`` with one thread per stage (``flatten`` may have
        more) and bounded inter-stage queues (pipeline/executor.py).  The
        lister runs on the calling thread.  The collect stage's input
        bound is ``submit_window`` (chunks in flight on the device), and
        the fold stage consumes chunks in submission order, so the output
        equals the serial schedule's.

        The flatten threads and the dispatch thread (parameter tables)
        intern into one vocab, so its lock is armed first."""
        from gatekeeper_tpu_torch.pipeline import (Stage, StagedPipeline,
                                                   effective_cpu_count)

        ev = self.evaluator
        cfg = self.config
        rb = cfg.exact_totals
        vocab = ev.driver.vocab
        if vocab._lock is None:
            vocab._lock = threading.RLock()

        # reduced-collect kept budget (see _sweep_serial): evaluated at
        # DISPATCH on the dispatch thread while the fold stage mutates
        # kept — len() of a list is atomic under the interpreter lock and
        # budgets only shrink, so a stale read over-ships, never
        # under-ships
        def budget_fn(con):
            return limit - len(kept.get(con.key(), ()))

        def fl(item):
            objs, cons = item
            return (ev.sweep_flatten(cons, objs, return_bits=rb,
                                     budget=budget_fn), objs, cons)

        def disp(item):
            flat, objs, cons = item
            return ev.sweep_dispatch(flat), objs, cons

        def coll(item):
            pending, objs, cons = item
            event = getattr(pending, "event", None)
            if event is not None:
                # the stage's only blocking wait: the head-of-line chunk's
                # device work and its copy back (the wait releases the
                # interpreter lock); its busy seconds are the run's
                # device-wait measurement
                event.synchronize()
            return ev.sweep_collect(pending), objs, cons

        def fold_render(item):
            swept, objs, cons = item
            with tracing.phase(self._perf_add, "fold_render",
                               "audit.fold_render"):
                self._process_swept(swept, objs, cons, kept, totals, limit)
            return None

        fw = cfg.pipeline_flatten_workers
        if fw <= 0:  # auto: a second flatten thread once cores allow it
            fw = 2 if effective_cpu_count() >= 4 else 1
        # flatten/dispatch/collect re-run their item on a failure (they
        # touch no run state); fold_render mutates kept/totals, so it gets
        # no retry: its failure aborts the pipeline and the sweep degrades
        # to the serial schedule
        sr = max(0, cfg.pipeline_stage_retries)
        qc = cfg.pipeline_queue_cap
        pipe = StagedPipeline([
            Stage("flatten", fl, workers=fw, queue_cap=qc, max_retries=sr),
            Stage("dispatch", disp, queue_cap=qc, max_retries=sr),
            Stage("collect", coll, queue_cap=max(1, cfg.submit_window),
                  max_retries=sr),
            Stage("fold_render", fold_render, queue_cap=qc),
        ], source_cap=qc)
        pr = pipe.run(self._chunk_source(constraints, True, counter))
        if run is not None:
            run.retried_chunks += sum(s.retries for s in pr.stages)
        stats = pr.summary()
        # device-idle proxy: the collect stage blocks exactly while the
        # device is still producing the head-of-line result; for the rest
        # of the wall the card had nothing in flight to finish.  An upper
        # bound on device busy (it includes the copy back), hence a lower
        # bound on the idle share.
        coll_s = pr.stage("collect")
        device_wait = coll_s.busy_s if coll_s is not None else 0.0
        stats["device_wait_s"] = round(device_wait, 3)
        stats["device_idle_fraction"] = (
            round(max(0.0, 1.0 - device_wait / pr.wall_s), 3)
            if pr.wall_s > 0 else 0.0)
        self.pipe_stats = stats
        self.perf["pipe_wall"] = self.perf.get("pipe_wall", 0.0) + pr.wall_s
        self.perf["pipe_stage_busy_sum"] = (
            self.perf.get("pipe_stage_busy_sum", 0.0)
            + pr.stage_busy_sum())
        self.perf["pipe_device_wait"] = (
            self.perf.get("pipe_device_wait", 0.0) + device_wait)

    @staticmethod
    def _schedules_differ(kept_a, totals_a, kept_b, totals_b):
        """None when two schedules produced bit-identical output, else a
        human-readable first difference (differential mode)."""
        if totals_a != totals_b:
            keys = [k for k in totals_a
                    if totals_a.get(k) != totals_b.get(k)]
            return (f"totals differ for {keys[:3]}: "
                    f"{[totals_a.get(k) for k in keys[:3]]} vs "
                    f"{[totals_b.get(k) for k in keys[:3]]}")
        for key in kept_a:
            va = [(v.message, v.kind, v.name, v.namespace,
                   v.enforcement_action) for v in kept_a[key]]
            vb = [(v.message, v.kind, v.name, v.namespace,
                   v.enforcement_action) for v in kept_b.get(key, [])]
            if va != vb:
                return f"kept violations differ for {key}"
        return None

    # --- chunk evaluation ------------------------------------------------
    def _audit_chunk(self, objects, constraints, kept, totals, limit,
                     source=SOURCE_ORIGINAL, overrides=None):
        """No-evaluator path: every constraint goes through its template's
        own driver.  ``source``/``overrides`` carry the expansion
        generator stage's context (Generated reviews, per-object
        (template, enforcementAction) overrides)."""
        target = self.client.target
        reviews = [
            target.handle_review(
                AugmentedUnstructured(object=o, source=source)
            )
            for o in objects
        ]
        self._eval_via_drivers(constraints, objects, reviews, kept, totals,
                               limit, overrides=overrides)

    def _eval_via_drivers(self, constraints, objects, reviews, kept, totals,
                          limit, overrides=None):
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
                        kept[key].append(self._violation(
                            con, objects[oi], msg, details,
                            override=overrides[oi] if overrides else None))

    def _eval_rows_via_drivers(self, constraints, objects,
                               reviews=None,
                               source=SOURCE_ORIGINAL) -> dict:
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
                object=o, source=source)) for o in objects]
        wanted = {c.key() for c in constraints}
        by_driver: dict[int, tuple] = {}
        for con in constraints:
            d = self.client._template_driver.get(con.kind)
            if d is None:
                continue  # no template: constraint cannot be evaluated
            by_driver.setdefault(id(d), (d, []))[1].append(con)
        # on the local sweep's device; without one (no evaluator, or the
        # sidecar's, whose RemoteDriver takes no device) the driver's own
        on_device = ({"device": self.evaluator.device}
                     if self._local_evaluator() else {})
        cfg = ReviewCfg(enforcement_point=AUDIT_EP)
        for d, cons in by_driver.values():
            responses = d.query_batch(target.name, cons, reviews, cfg,
                                      **on_device)
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
                       limit, source=SOURCE_ORIGINAL, overrides=None):
        """Fold one chunk's device results into the run state and run the
        non-lowered kinds through the exact engine.  ``source``/
        ``overrides`` as in :meth:`_audit_chunk`."""
        if self._sidecar_lane():
            # the Sweep RPC already rendered the kept violations and
            # covered every constraint (non-lowered kinds included):
            # ``swept`` is {(kind, name): (total, [(oi, msg, details)])}
            for key, (total, kept_list) in swept.items():
                if key not in totals:
                    continue
                totals[key] += total
                con = self.client.get_constraint(*key)
                for oi, msg, details in kept_list:
                    if con is not None and len(kept[key]) < limit:
                        kept[key].append(
                            self._violation(con, objects[oi], msg, details))
            return
        target = self.client.target
        review_cache: dict = {}

        def get_review(oi):
            # per-index lazy: a chunk renders only its kept hits
            r = review_cache.get(oi)
            if r is None:
                r = target.handle_review(AugmentedUnstructured(
                    object=objects[oi], source=source))
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
                    kept[key].append(self._violation(
                        con, objects[oi], msg, details,
                        override=overrides[oi] if overrides else None))
        # everything the device sweep did not cover (non-lowered kinds,
        # inventory-inexact referential kinds) goes through its own
        # driver's exact path
        rest = [c for c in constraints if c.kind not in swept]
        if rest:
            self._eval_via_drivers(rest, objects, get_reviews(), kept,
                                   totals, limit, overrides=overrides)

    def _violation(self, con, obj, msg, details,
                   override=None) -> Violation:
        group, version, kind = gvk_of(obj)
        meta = obj.get("metadata") or {}
        actions = con.actions_for(AUDIT_EP)
        action = actions[0] if actions else con.enforcement_action
        if override is not None:
            # expansion generator stage: the [Implied by <template>]
            # message prefix and the template's enforcementAction
            # override (reference: expansion/aggregate.go semantics)
            template_name, override_action = override
            msg = f"{CHILD_MSG_PREFIX % template_name} {msg}"
            if override_action:
                action = override_action
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

    def _render_fn(self, review_of=None, source=SOURCE_ORIGINAL):
        """``render(con, obj, cache_key=None)`` -> the exact engine's
        Results for one (constraint, object) hit, through the render
        driver: the same path for both audit sources, so messages and
        details agree across them.  Reviews (under ``source``) are cached
        per ``cache_key``; ``review_of(cache_key)`` supplies them instead
        when given."""
        target = self.client.target
        driver = self._render_driver()
        cfg = ReviewCfg(enforcement_point=AUDIT_EP)
        cache: dict = {}

        def render(con, obj, cache_key=None):
            self.perf["n_renders"] = self.perf.get("n_renders", 0) + 1
            t0 = time.perf_counter()
            if review_of is not None:
                review = review_of(cache_key)
            else:
                review = cache.get(cache_key) if cache_key is not None \
                    else None
                if review is None:
                    review = target.handle_review(AugmentedUnstructured(
                        object=obj, source=source))
                    if cache_key is not None:
                        cache[cache_key] = review
            results = driver.render_query(target.name, con, review,
                                          cfg).results
            dt = time.perf_counter() - t0
            self._perf_add("render", dt)
            self._attr_render(con, dt)
            return results

        return render

    @contextmanager
    def _renders_on(self, sp):
        """Stamp the renders made inside the block (``renders``) and their
        seconds (``render_s``) on the span ``sp``."""
        n0 = self.perf.get("n_renders", 0)
        s0 = self.perf.get("render", 0.0)
        try:
            yield sp
        finally:
            sp.set_attribute("renders", self.perf.get("n_renders", 0) - n0)
            sp.set_attribute("render_s",
                             round(self.perf.get("render", 0.0) - s0, 6))

    @staticmethod
    def _attr_render(con, dt: float) -> None:
        """Exact per-template attribution of one exact-engine render (the
        host-side cost of a device hit): the call IS template-scoped."""
        from gatekeeper_tpu_torch.observability import costattr

        attr = costattr.active()
        if attr is not None:
            attr.record(con.kind, costattr.EP_AUDIT,
                        costattr.PHASE_RENDER, dt, rows=1)

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
        with tracing.span("audit.tick") as sp, self._collector:
            run = self._audit_snapshot_impl(full=False)
            sp.set_attribute("objects", run.total_objects)
            sp.set_attribute("duration_s", round(run.duration_s, 3))
            gc = getattr(getattr(self.evaluator, "driver", None),
                         "gen_coord", None)
            if gc is not None:
                # the template generation this tick evaluated under
                sp.set_attribute("generation", gc.gen_id)
            if run.incomplete:
                sp.set_attribute("incomplete", True)
            return run

    def _snapshot_ready(self, constraints) -> None:
        """Adopt the constraint set, rebuild if stale, apply queued watch
        events."""
        snap = self.snapshot
        rechunks = snap.rechunk_count
        if snap.set_constraints(constraints):
            n = snap.rebuild(self.lister)
            # the verdict store was reset: generated verdicts reset with
            # it (the full pass recomputes them for every row)
            self._gen_verdicts.clear()
            log_event("info", "snapshot rebuilt",
                      event_type="snapshot_rebuilt", rows=n,
                      generation=snap.generation)
        elif snap.rechunk_count != rechunks:
            # a template/constraint change was absorbed by re-chunking the
            # resident rows (zero relist); every row is dirty now, and the
            # generated verdicts are re-derived with them
            self._gen_verdicts.clear()
            log_event("info", "snapshot rechunked (no relist)",
                      event_type="snapshot_rechunked",
                      rows=snap.live_count(), generation=snap.generation)
        snap.pump()

    def _audit_snapshot_impl(self, full: bool) -> AuditRun:
        t0 = time.time()
        run = AuditRun(timestamp=_now_rfc3339())
        self._annotate_run(run)
        constraints = self._audit_constraints()
        if self.export_system is not None:
            self.export_system.publish_audit_started(run.timestamp)
        if not constraints:
            run.duration_s = time.time() - t0
            self._finish(run)
            return run
        snap = self.snapshot
        with tracing.phase(self._perf_add, "snapshot_ready",
                           "snapshot.ready", full=full):
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
        # the generator stage rides the same dirty set: only (re)evaluated
        # parents re-expand, clean parents keep their generated verdicts
        self._snapshot_generated(rows, constraints, run)
        run.total_objects = snap.live_count()
        with tracing.phase(self._perf_add, "snapshot_collect",
                           "snapshot.collect") as ph, \
                self._renders_on(ph.span):
            totals, kept = self._snapshot_collect(constraints)
        run.total_violations = totals
        run.kept = kept
        run.duration_s = time.time() - t0
        if ev is not None:
            tick_h2d = (ev.perf.get("resident_h2d_bytes", 0.0)
                        + ev.perf.get("h2d_bytes", 0.0)) - h2d0
            self.perf["tick_h2d_bytes"] = tick_h2d
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                labels = {"cluster": self.cluster} if self.cluster \
                    else None
                self.metrics.set_gauge(M.TICK_H2D_BYTES, float(tick_h2d),
                                       labels)
        with tracing.phase(self._perf_add, "status_write",
                           "audit.status_write"):
            snap.publish_metrics()
            self._write_statuses(run, constraints)
            self._publish_metrics(run)
            self._finish(run)
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
        # chunk sharding (AuditConfig.shard_chunks): snapshot rows slice
        # into K-chunk-wide dispatches; the verdict store's totals and kept
        # lists are per row, so this changes only the dispatch geometry
        shard_k = max(1, int(getattr(self.config, "shard_chunks", 0) or 1))
        chunk_size = max(1, self.config.chunk_size) * shard_k
        max_inflight = max(1, self.config.submit_window)

        def chunk_failed(exc):
            run.failed_chunks += 1
            run.incomplete = True
            log_event("warning",
                      "snapshot audit chunk dropped after exhausting "
                      "retries (rows stay dirty; previous verdicts kept)",
                      event_type="audit_chunk_failed", phase="snapshot",
                      error=str(exc))
            self._count_chunk_failed()

        for store, rowlist in rows_by_store.items():
            # resident lane: sync the device mirror ONCE per store per
            # pass (scatter-patch for dirty rows, nothing when clean);
            # None means this group serves host columns this pass
            rg = None
            if self.residency is not None and ev is not None \
                    and store.lowered:
                with tracing.phase(self._perf_add, "snapshot_rows",
                                   "snapshot.rows", prepare=True):
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
                pending, gids, positions, objects, ci = _window.popleft()
                with tracing.span("audit.chunk.collect_fold", chunk=ci,
                                  objects=len(gids),
                                  source="snapshot") as sp, \
                        self._renders_on(sp):
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
                        with tracing.phase(self._perf_add, "fold_render",
                                           "audit.fold_render"):
                            self._fold_snapshot_chunk(swept, _store.cons,
                                                      gids, objects)
                            snap.mark_clean(gids)
                    except Exception as e:
                        chunk_failed(e)

            for ci, i in enumerate(range(0, len(rowlist), chunk_size)):
                with tracing.phase(self._perf_add, "snapshot_rows",
                                   "snapshot.rows", chunk=ci):
                    chunk = rowlist[i: i + chunk_size]
                    gids = [g for g, _p in chunk]
                    positions = [p for _g, p in chunk]
                    objects = [store.row_obj(p) for p in positions]
                pending = None
                if store.lowered and ev is not None:
                    with tracing.span("audit.chunk.submit", chunk=ci,
                                      objects=len(gids)):
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
                window.append((pending, gids, positions, objects, ci))
                while window and (len(window) > max_inflight
                                  or _sweep_ready(window[0][0])):
                    fold_oldest()
            while window:
                fold_oldest()

    def _perf_count(self, name: str) -> None:
        self._perf_add(name, 1.0)

    def _perf_add(self, name: str, value: float) -> None:
        self.perf[name] = self.perf.get(name, 0.0) + value

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

    # --- fleet seam (fleet/evaluator.py) ----------------------------------
    def fold_snapshot_segment(self, swept, cons_g, gids, objects) -> None:
        """Fold ONE cluster's segment of a fleet-packed dispatch into this
        manager's verdict store and mark its rows clean: the packed twin of
        the per-chunk collect and fold of :meth:`_snapshot_eval`.
        ``swept`` carries segment-rebased hit rows
        (``fleet.evaluator._SegmentHits`` in the bits slot), so the fold is
        the one an unpacked chunk of the same rows takes."""
        self._fold_snapshot_chunk(swept, cons_g, gids, objects)
        self.snapshot.mark_clean(gids)

    def snapshot_collect(self, constraints) -> tuple:
        """(totals, kept) off the verdict store: the fleet scheduler's
        per-cluster derivation (the path the snapshot tick takes)."""
        return self._snapshot_collect(constraints)

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
        # generated resultants (expansion generator stage): per-parent
        # entries recomputed whenever the parent row was (re)evaluated,
        # clean parents keep their last generated verdicts — the same
        # O(churn) contract the base rows have
        dead = []
        for gid, per_con in self._gen_verdicts.items():
            if snap.obj_of(gid) is None:
                dead.append(gid)  # parent deleted since the tick
                continue
            for ckey, (count, violations) in per_con.items():
                if ckey not in totals:
                    continue
                totals[ckey] += count
                for v in violations:
                    if len(kept[ckey]) < limit:
                        kept[ckey].append(v)
        for gid in dead:
            self._gen_verdicts.pop(gid, None)
        return totals, kept

    def _eval_objects_capture(self, constraints, objects, source) -> tuple:
        """({oi: {con_key: [(msg, details)]}}, lowered_kinds) — evaluate
        arbitrary objects with per-object capture: device grid + exact
        render for lowered kinds, driver exact lane for the rest.  The
        snapshot generator stage's evaluator for generated resultants."""
        out: dict = {}
        swept: dict = {}
        ev = self.evaluator
        if self._local_evaluator() and objects:
            flat = ev.sweep_flatten(constraints, objects,
                                    return_bits=True, source=source)
            if flat:
                swept = ev.sweep_collect(ev.sweep_dispatch(flat))
        render = self._render_fn(source=source)
        k = len(objects)
        for _kind, (kcons, _idx, _valid, _counts, bits) in swept.items():
            for ci, con in enumerate(kcons):
                for oi in violation_rows(bits, ci, k).tolist():
                    results = render(con, objects[oi], cache_key=oi)
                    out.setdefault(oi, {}).setdefault(
                        con.key(), []).extend(
                        (r.msg, (r.metadata or {}).get("details"))
                        for r in results)
        rest = [c for c in constraints if c.kind not in swept]
        if rest:
            for oi, per_con in self._eval_rows_via_drivers(
                    rest, objects, source=source).items():
                for ckey, results in per_con.items():
                    out.setdefault(oi, {}).setdefault(
                        ckey, []).extend(results)
        return out, set(swept)

    def _snapshot_generated(self, rows_by_store, constraints, run) -> None:
        """Recompute the generated-resultant verdicts of every parent row
        that was just (re)evaluated: expand through the batched stage,
        evaluate resultants with Source=Generated, store per parent gid.
        A parent that stopped being a generator (or was deleted) simply
        loses its entry."""
        stage = self._gen_stage()
        if stage is None:
            self._gen_verdicts.clear()
            return
        snap = self.snapshot
        templates = self.expansion_system.templates()
        gens: list = []
        for store, rowlist in rows_by_store.items():
            for gid, pos in rowlist:
                obj = store.row_obj(pos)
                self._gen_verdicts.pop(gid, None)
                if obj is None:
                    continue
                if any(t.applies_to(obj) for t in templates):
                    gens.append((gid, obj))
        if not gens:
            return
        cons_by_key = {c.key(): c for c in constraints}
        exact = self.config.exact_totals
        chunk_size = max(1, self.config.chunk_size)
        for i in range(0, len(gens), chunk_size):
            part = gens[i:i + chunk_size]
            namespaces = []
            for _gid, obj in part:
                ns = (obj.get("metadata") or {}).get("namespace", "") or ""
                namespaces.append(snap.namespace(ns) if ns else None)
            t0 = time.perf_counter()
            results = stage.expand_batch([o for _g, o in part],
                                         namespaces)
            self._perf_add("expand", time.perf_counter() - t0)
            self._perf_add("generators", len(part))
            resultants: list = []  # (parent gid, obj, template, action)
            for (gid, obj), res in zip(part, results):
                if res.error is not None:
                    log_event("warning",
                              "audit expansion failed for a generator "
                              "object", event_type="audit_expand_failed",
                              name=(obj.get("metadata") or {})
                              .get("name", ""), error=str(res.error))
                    continue
                resultants.extend(
                    (gid, r.obj, r.template_name, r.enforcement_action)
                    for r in res.resultants)
            self._perf_add("resultants", len(resultants))
            if not resultants:
                continue
            t0 = time.perf_counter()
            captured, lowered = self._eval_objects_capture(
                constraints, [r[1] for r in resultants],
                SOURCE_GENERATED)
            self._perf_add("generated_sweep", time.perf_counter() - t0)
            for oi, (gid, robj, tname, action) in enumerate(resultants):
                for ckey, results in captured.get(oi, {}).items():
                    con = cons_by_key.get(ckey)
                    if con is None:
                        continue
                    # totals parity with the relist generator stage:
                    # non-exact device-lowered kinds count violating
                    # OBJECTS, everything else counts results
                    count = (len(results)
                             if exact or con.kind not in lowered else 1)
                    violations = [
                        self._violation(con, robj, msg, details,
                                        override=(tname, action))
                        for msg, details in results]
                    slot = self._gen_verdicts.setdefault(
                        gid, {}).setdefault(ckey, [0, []])
                    slot[0] += count
                    slot[1].extend(violations)

    def audit_resync(self) -> AuditRun:
        """The periodic resync differential (snapshot mode): drain the
        dirty set, then re-list + re-flatten fresh and require the
        resident snapshot to be identical — columns (per-row signatures
        over the same vocab), vocab (the fresh flatten interns nothing
        new) and, unrotated, verdicts (totals and kept lists against a
        fresh relist sweep, compared canonically).  A divergence marks
        the run incomplete and invalidates the snapshot: the next pass
        rebuilds."""
        t0 = time.time()
        rotate = max(0, self.config.resync_rotate)
        rotor = None
        if rotate > 1:
            rotor = (self._resync_phase % rotate, rotate)
            self._resync_phase = (self._resync_phase + 1) % rotate
        with tracing.span("snapshot.resync") as sp, self._collector:
            if rotor is not None:
                sp.set_attribute("rotor_phase", rotor[0])
                sp.set_attribute("rotor_k", rotor[1])
            return self._resync_impl(rotor, sp, t0)

    def _resync_impl(self, rotor, sp, t0: float) -> AuditRun:
        run = self._audit_snapshot_impl(full=False)
        snap = self.snapshot
        diff = snap.resync_differential(self.lister, rotor=rotor)
        if diff is None and rotor is None:
            constraints = self._audit_constraints()
            kept_f: dict = {c.key(): [] for c in constraints}
            totals_f: dict = {c.key(): 0 for c in constraints}
            device = self._device_lane() or self._sidecar_lane()
            fresh = AuditRun(timestamp=run.timestamp)
            gen_stage = self._gen_stage()
            self._gen_reset(gen_stage is not None)
            self._sweep_serial(constraints, device, kept_f, totals_f,
                               self.config.violations_limit, [0], fresh)
            if gen_stage is not None and self._gen_buf:
                # the reference sweep must expand too, or every generated
                # verdict would read as a divergence
                self._sweep_generated(gen_stage, self._gen_buf,
                                      constraints, kept_f, totals_f,
                                      self.config.violations_limit, fresh)
            self._gen_reset(False)
            diff = self._verdicts_differ_canonical(
                run.kept, run.total_violations, kept_f, totals_f,
                self.config.violations_limit)
        self.last_resync_diff = diff
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.SNAPSHOT_RESYNC_SECONDS,
                                   time.time() - t0)
        if diff is None:
            log_event("info", "snapshot resync differential clean",
                      event_type="snapshot_resync_clean",
                      rows=snap.live_count(),
                      scope=f"1/{rotor[1]}" if rotor else "full")
        else:
            sp.set_attribute("diverged", diff)
            run.incomplete = True
            snap.invalidate()
            log_event("warning",
                      "snapshot resync differential diverged; snapshot "
                      "invalidated (next pass rebuilds)",
                      event_type="snapshot_resync_diverged",
                      difference=diff)
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(
                    M.RESILIENCE_DEGRADED,
                    {"component": "snapshot", "to": "rebuild"})
        self.perf["resync_ok"] = 0.0 if diff else 1.0
        if diff is None and self.spiller is not None:
            # a snapshot just proven consistent is the state to persist:
            # capture now (array copies under the lock), write on the
            # spiller's worker
            self.spiller.request()
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

    # --- expansion generator stage (mutlane/expand_stage.py) -------------
    def _gen_stage(self):
        """The batched expansion stage, or None when the generator stage
        is off or has nothing to do.  Its lane's prefilter runs on the
        evaluator's device (without an evaluator: ``"cuda"``)."""
        if not self.config.expand_generated:
            return None
        if self.expansion_system is None or \
                not self.expansion_system.templates():
            return None
        if self._expansion_stage is None:
            from gatekeeper_tpu_torch.mutlane import ExpansionStage

            # the sidecar lane's control plane owns no card: its stage's
            # prefilter runs on the host
            device = (self.evaluator.device if self._local_evaluator()
                      else "cpu" if self._sidecar_lane() else "cuda")
            self._expansion_stage = ExpansionStage(self.expansion_system,
                                                   device=device)
        return self._expansion_stage

    def _gen_reset(self, active: bool) -> None:
        """Arm (or disarm) the per-sweep generator tee."""
        self._gen_buf = [] if active else None
        self._gen_ns = {}
        self._gen_kinds = set()
        if active:
            for t in self.expansion_system.templates():
                for entry in t.apply_to:
                    self._gen_kinds.update(entry.get("kinds") or [])

    def _gen_tee(self, obj, kind: str) -> None:
        """Observe one listed object: collect Namespaces (the expand's
        namespace context) and generator objects (some template's
        applyTo covers them).  RawJSON objects only parse when their
        kind pre-qualifies."""
        if self._gen_buf is None:
            return
        if kind == "Namespace":
            name = (obj.get("metadata") or {}).get("name", "") or ""
            if name:
                self._gen_ns[name] = obj
            return
        if kind in self._gen_kinds:
            if any(t.applies_to(obj)
                   for t in self.expansion_system.templates()):
                self._gen_buf.append(obj)

    def _gen_namespace_of(self, obj):
        ns = (obj.get("metadata") or {}).get("namespace", "") or ""
        return self._gen_ns.get(ns) if ns else None

    def _expand_bases(self, stage, bases) -> tuple:
        """Expand a chunk of generator bases through the batched stage;
        returns (resultants, errors) where each resultant is
        ``(obj, template_name, enforcement_override)``."""
        namespaces = [self._gen_namespace_of(b) for b in bases]
        results = stage.expand_batch(bases, namespaces)
        resultants: list = []
        errors: list = []
        for base, res in zip(bases, results):
            if res.error is not None:
                errors.append((base, res.error))
                continue
            resultants.extend((r.obj, r.template_name,
                               r.enforcement_action)
                              for r in res.resultants)
        return resultants, errors

    def _sweep_generated(self, stage, bases, constraints, kept, totals,
                         limit, run=None) -> None:
        """The generator stage of a relist sweep: expand the tee'd
        generator objects in chunks, then audit every resultant at sweep
        scale — device grid for lowered kinds (flattened with
        Source=Generated so source-scoped matches hold), driver exact
        lane for the rest — folding into the same kept/totals with the
        template's enforcementAction override and the reference's
        ``[Implied by <template>]`` message prefix."""
        chunk_size = max(1, self.config.chunk_size)
        n_resultants = 0
        with tracing.span("expansion.stage", phase="audit",
                          bases=len(bases)) as sp:
            for i in range(0, len(bases), chunk_size):
                part = bases[i:i + chunk_size]
                t0 = time.perf_counter()
                resultants, errors = self._expand_bases(stage, part)
                self._perf_add("expand", time.perf_counter() - t0)
                self._perf_add("generators", len(part))
                self._perf_add("resultants", len(resultants))
                n_resultants += len(resultants)
                for base, err in errors:
                    # mirrors the webhook's ExpansionError handling:
                    # surfaced, never silently dropped, run keeps going
                    log_event("warning",
                              "audit expansion failed for a generator "
                              "object", event_type="audit_expand_failed",
                              name=(base.get("metadata") or {}).get(
                                  "name", ""),
                              error=str(err))
                t0 = time.perf_counter()
                self._eval_generated_chunks(resultants, constraints, kept,
                                            totals, limit, run)
                self._perf_add("generated_sweep", time.perf_counter() - t0)
            sp.set_attribute("resultants", n_resultants)

    def _eval_generated_chunks(self, resultants, constraints, kept,
                               totals, limit, run) -> None:
        """Evaluate expanded resultants (Source=Generated) grouped the
        way the base sweep groups objects (kind-bucketed router on the
        device path)."""
        chunk_size = max(1, self.config.chunk_size)
        retries = max(0, self.config.chunk_retries)
        ev = self.evaluator
        # the sidecar lane evaluates resultants through the drivers (its
        # RemoteDriver's QueryBatch), as the JAX manager does
        device = self._device_lane()

        def fold(objs, cons, overrides):
            last = None
            for attempt in range(retries + 1):
                try:
                    if run is not None and attempt > 0:
                        run.retried_chunks += 1
                    if device:
                        flat = ev.sweep_flatten(
                            cons, objs,
                            return_bits=self.config.exact_totals,
                            source=SOURCE_GENERATED,
                            budget=lambda con: limit - len(
                                kept.get(con.key(), ())))
                        swept = ev.sweep_collect(ev.sweep_dispatch(flat))
                        self._process_swept(swept, objs, cons, kept,
                                            totals, limit,
                                            source=SOURCE_GENERATED,
                                            overrides=overrides)
                    else:
                        self._audit_chunk(objs, cons, kept, totals,
                                          limit, source=SOURCE_GENERATED,
                                          overrides=overrides)
                    return
                except Exception as e:  # noqa: PERF203
                    last = e
            if run is not None:
                run.failed_chunks += 1
                run.incomplete = True
            log_event("warning",
                      "generated-object audit chunk dropped after "
                      "exhausting retries",
                      event_type="audit_chunk_failed", phase="generated",
                      error=str(last))
            self._count_chunk_failed()

        if device:
            from gatekeeper_tpu_torch.parallel.sweep import make_kind_router

            router = make_kind_router(constraints)
            bufs: dict = {}
            for obj, tname, action in resultants:
                g = router(gvk_of(obj)[2])
                if not g:
                    continue  # no template's match reaches this kind
                bufs.setdefault(g, []).append((obj, tname, action))
            for g, entries in bufs.items():
                cons_g = [c for c in constraints if c.kind in g]
                for j in range(0, len(entries), chunk_size):
                    part = entries[j:j + chunk_size]
                    fold([e[0] for e in part], cons_g,
                         [(e[1], e[2]) for e in part])
        else:
            for j in range(0, len(resultants), chunk_size):
                part = resultants[j:j + chunk_size]
                fold([e[0] for e in part], constraints,
                     [(e[1], e[2]) for e in part])

    # --- overload brownout (resilience/overload.py) ----------------------
    def _brownout_yield(self) -> None:
        """Brownout level-2 hook: while the admission queue is under heavy
        pressure, the sweep yields the device lane before submitting its
        next chunk (bounded per call: the audit slows, never stalls).  A
        no-op without an installed OverloadController, and released while
        a breaching audit-staleness objective holds
        ``audit_yield_release`` (yield_device_lane checks it)."""
        from gatekeeper_tpu_torch.resilience import overload

        waited = overload.yield_device_lane(cluster=self.cluster)
        if waited:
            self.perf["brownout_yield_s"] = (
                self.perf.get("brownout_yield_s", 0.0) + waited)

    def _resync_deferred(self) -> bool:
        """``resync_defer`` degradation action: a breaching audit-staleness
        objective defers the periodic resync differential (a relist and a
        full re-evaluation) so the interval goes to the dirty set.  A
        deferral is counted."""
        from gatekeeper_tpu_torch.resilience import overload

        if not overload.degradation_active(overload.RESYNC_DEFER,
                                           self.cluster):
            return False
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.RESILIENCE_DEGRADED,
                {"component": "audit", "to": "resync_defer"})
        return True

    # --- metrics -----------------------------------------------------------
    def _count_chunk_failed(self) -> None:
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.RESILIENCE_CHUNKS_FAILED)

    def _publish_metrics(self, run: AuditRun) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        self.metrics.observe(M.AUDIT_DURATION, run.duration_s)
        now = time.time()
        self.metrics.set_gauge(M.AUDIT_LAST_RUN, now - run.duration_s)
        # end-of-sweep timestamp: the SLO engine's audit-staleness
        # objective ages against it
        self.metrics.set_gauge(M.AUDIT_LAST_RUN_END, now)
        self.metrics.set_gauge(M.AUDIT_LAST_RUN_INCOMPLETE,
                               1.0 if run.incomplete else 0.0)
        # the collector's seconds in this pass so far
        gc_s = self._collector.seconds
        self.metrics.set_gauge(AUDIT_COLLECTOR_SECONDS, gc_s)
        if self.cluster:
            # fleet: the per-cluster staleness series the cluster-scoped
            # objectives sample (the unlabelled gauges keep their process-
            # wide meaning: the last sweep of ANY cluster)
            lab = {"cluster": self.cluster}
            self.metrics.set_gauge(M.AUDIT_LAST_RUN,
                                   now - run.duration_s, lab)
            self.metrics.set_gauge(M.AUDIT_LAST_RUN_END, now, lab)
            self.metrics.set_gauge(M.AUDIT_LAST_RUN_INCOMPLETE,
                                   1.0 if run.incomplete else 0.0, lab)
            self.metrics.set_gauge(AUDIT_COLLECTOR_SECONDS, gc_s, lab)
        if not self.pipe_stats:
            return
        for name, st in self.pipe_stats.get("stages", {}).items():
            lab = {"stage": name}
            self.metrics.set_gauge(M.PIPELINE_STAGE_SECONDS,
                                   st["busy_s"], lab)
            self.metrics.set_gauge(M.PIPELINE_STAGE_OCCUPANCY,
                                   st["occupancy"], lab)
            self.metrics.set_gauge(M.PIPELINE_QUEUE_HIGHWATER,
                                   st["queue_highwater"], lab)
        self.metrics.set_gauge(
            M.PIPELINE_DEVICE_IDLE,
            self.pipe_stats.get("device_idle_fraction", 0.0))
        self.metrics.set_gauge(M.PIPELINE_WALL,
                               self.pipe_stats.get("wall_s", 0.0))
        self.metrics.set_gauge(
            M.PIPELINE_STAGE_BUSY_SUM,
            self.pipe_stats.get("stage_busy_sum_s", 0.0))

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
            if self.status_writer is not None:
                self.status_writer(con, status)
            else:
                con.raw.setdefault("status", {}).update(status)

    def _finish(self, run: AuditRun):
        if self.export_system is not None:
            for violations in run.kept.values():
                for v in violations:
                    self.export_system.publish_violation(run.timestamp, v)
            self.export_system.publish_audit_ended(run.timestamp)
        if self.log_violations:
            from gatekeeper_tpu_torch.utils.logging import \
                log_audit_violation

            for violations in run.kept.values():
                for v in violations:
                    log_audit_violation(v, run.timestamp)
        if self.event_sink is not None:
            self.event_sink(run)


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
