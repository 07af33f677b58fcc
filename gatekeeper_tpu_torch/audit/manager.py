"""Audit sweep: the enforcement point that reviews every cluster object.

Port of ``gatekeeper_tpu/audit/manager.py``, serial schedule only.
Reference flow (pkg/audit/manager.go:258-973): list every auditable object
(chunked) → review each against all constraints → keep the first K
violations per constraint (LimitQueue) → write constraint status.

Device middle: each chunk flattens to columns and the whole constraint ×
chunk grid evaluates in one device pass (``parallel/sweep.SweepEvaluator``);
only the ≤K kept violations per constraint render to messages through the
exact interpreter.  Non-lowered kinds run the interpreter behind the same
seam.

Not ported yet: the staged pipeline schedule, the resident snapshot,
the expansion generator stage, export, metrics, tracing and brownout hooks.
"""

from __future__ import annotations

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
    ):
        self.client = client
        self.lister = lister
        self.config = config or AuditConfig()
        self.evaluator = evaluator
        # per-phase seconds for the host-side fold/render of device sweeps
        # (the evaluator tracks its own flatten/masks/dispatch/collect)
        self.perf: dict = {}

    # --- one sweep (reference: audit(), manager.go:258) -----------------
    def audit(self) -> AuditRun:
        t0 = time.time()
        run = AuditRun(timestamp=_now_rfc3339())
        run.n_devices = 1 if self.evaluator is not None else 0
        constraints = [
            c for c in self.client.constraints()
            if c.actions_for(AUDIT_EP)
        ]
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
        """Evaluate constraints through their own template's driver with a
        matcher-prefiltered per-object query loop.  This is the lane for
        every constraint the device sweep did not cover: non-lowered Rego
        templates and referential templates whose inventory tables are
        inexact for the current data version."""
        if not constraints:
            return
        target = self.client.target
        by_driver: dict[int, tuple] = {}
        for con in constraints:
            d = self.client._template_driver.get(con.kind)
            if d is None:
                continue  # no template: constraint cannot be evaluated
            by_driver.setdefault(id(d), (d, []))[1].append(con)
        for d, cons in by_driver.values():
            for oi, obj in enumerate(objects):
                review = reviews[oi]
                for con in cons:
                    if not target.to_matcher(con.match).match(review):
                        continue
                    qr = d.query(
                        target.name, [con], review,
                        ReviewCfg(enforcement_point=AUDIT_EP)
                    )
                    key = con.key()
                    totals[key] += len(qr.results)
                    for r in qr.results:
                        if len(kept[key]) < limit:
                            kept[key].append(
                                self._violation(con, obj, r.msg, r.details))

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
        driver = self._render_driver()
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
        cfg = ReviewCfg(enforcement_point=AUDIT_EP)

        def render(con, oi):
            self.perf["n_renders"] = self.perf.get("n_renders", 0) + 1
            return driver.render_query(
                target.name, con, get_review(oi), cfg).results

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
