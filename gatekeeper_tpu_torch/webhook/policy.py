"""Validating admission handler (reference: pkg/webhook/policy.go).

Port of ``gatekeeper_tpu/webhook/policy.py``.  Flow:
- self-management bypass for the gatekeeper service account (policy.go:142)
- gatekeeper-resource meta-validation fast path (templates, constraints,
  expansion templates and mutators validated structurally,
  policy.go:359-401)
- namespace exclusion via the process excluder (policy.go:170)
- review of the request (+ expansion resultants, policy.go:602-646)
- deny/warn partition by enforcement action incl. scoped (policy.go:256-353)

Requests funnel into a **microbatching lane** (:class:`Batcher`) that
coalesces concurrent admissions into one ``review_batch`` call, whose
lowered kinds evaluate as one verdict grid per template on the device.

The served process's hooks sit around the review as in the JAX package:
the overload/QoS gate with its failurePolicy shed answers, the deadline
guard, the flight recorder, per-tenant cost records, request metrics, the
``webhook.review`` span and fault site, the batcher's spans and its
deadline check while a request is queued, and the ``ns_cache_stale``
degradation of namespace lookups.  The handler also takes the JAX
package's seams: the resident snapshot's warm namespace lookup
(``snapshot=``), ``fail_open=``, per-request stats (``log_stats=``), an
admission event sink (``event_sink=``) and the Config's validation traces
(``trace_config=``).  Not ported yet: the shadow lane and the fleet
cluster label.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

from gatekeeper_tpu_torch.apis.constraints import CONSTRAINTS_GROUP, WEBHOOK_EP
from gatekeeper_tpu_torch.apis.templates import (ConstraintTemplate,
                                                 TemplateError)
from gatekeeper_tpu_torch.expansion import aggregate
from gatekeeper_tpu_torch.expansion.system import (EXPANSION_GROUP,
                                                   ExpansionError,
                                                   ExpansionTemplate)
from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED, SOURCE_ORIGINAL
from gatekeeper_tpu_torch.mutation.mutators import (
    MUTATIONS_GROUP, MUTATOR_KINDS,
    from_unstructured as mutator_from_unstructured)
from gatekeeper_tpu_torch.target.review import (AdmissionRequest,
                                                AugmentedReview,
                                                AugmentedUnstructured)
from gatekeeper_tpu_torch.utils.logging import log_deny, log_event
from gatekeeper_tpu_torch.utils.unstructured import gvk_of

GATEKEEPER_SA_PREFIX = "system:serviceaccount:gatekeeper-system:"
TEMPLATES_GROUP = "templates.gatekeeper.sh"


@dataclass
class ValidationResponse:
    allowed: bool
    message: str = ""
    code: int = 200
    warnings: list = field(default_factory=list)
    uid: str = ""
    # shed under failurePolicy=Fail: the server emits an HTTP Retry-After
    # header with this hint (0 = no header)
    retry_after_s: float = 0.0


def parse_admission_review(body: dict) -> AdmissionRequest:
    req = body.get("request") or {}
    return AdmissionRequest(
        uid=req.get("uid", "") or "",
        kind=req.get("kind") or {},
        resource=req.get("resource") or {},
        sub_resource=req.get("subResource", "") or "",
        name=req.get("name", "") or "",
        namespace=req.get("namespace", "") or "",
        operation=req.get("operation", "") or "",
        user_info=req.get("userInfo") or {},
        object=req.get("object"),
        old_object=req.get("oldObject"),
        dry_run=bool(req.get("dryRun", False)),
        options=req.get("options"),
    )


class ValidationHandler:
    def __init__(
        self,
        client,
        process_excluder=None,
        namespace_lookup=None,  # name -> Namespace object
        batcher: Optional["Batcher"] = None,
        log_denies: bool = False,
        failure_policy: Optional[str] = None,  # "ignore" | "fail"
        expansion_system=None,  # expansion.ExpansionSystem
        metrics=None,  # metrics.registry.MetricsRegistry
        deadline_budget_s: float = 0.0,  # hard per-request wall budget
        overload=None,  # resilience.overload.OverloadController
        event_sink=None,  # (req, results) -> None, per reviewed request
        fail_open: bool = False,
        trace_config=None,  # callable -> list of Config trace entries
        log_stats: bool = False,  # --log-stats-admission
        snapshot=None,  # snapshot.ClusterSnapshot (warm lookup cache)
    ):
        self.client = client
        # generator objects' resultants are reviewed with the request
        # (Source=Generated) and fold into its answer
        self.expansion_system = expansion_system
        self.process_excluder = process_excluder
        self.namespace_lookup = namespace_lookup or (lambda name: None)
        self.batcher = batcher
        self.log_denies = log_denies
        self.event_sink = event_sink
        self.metrics = metrics
        # warm referential cache: with the resident snapshot active,
        # namespace lookups serve from its watch-synced rows before the
        # source (the reference's cached client, policy.go:694-702)
        self.snapshot = snapshot
        # failurePolicy (reference ValidatingWebhookConfiguration
        # failurePolicy): Ignore fails open, Fail fails closed; the
        # fail_open flag maps onto it
        if failure_policy is None:
            failure_policy = "ignore" if fail_open else "fail"
        if failure_policy not in ("ignore", "fail"):
            raise ValueError(f"failure_policy must be ignore|fail, "
                             f"got {failure_policy!r}")
        self.failure_policy = failure_policy
        self.fail_open = failure_policy == "ignore"
        # deadline budget: 0 disables the guard (the review runs inline on
        # the server's handler thread)
        self.deadline_budget_s = float(deadline_budget_s or 0.0)
        self.trace_config = trace_config
        self.log_stats = log_stats
        # overload protection (resilience/overload.py): the admission gate
        # in front of the review, plus the caches its brownout ladder
        # degrades onto — a bounded stale namespace-lookup cache and a
        # per-kind matched-constraint estimate for the cost model
        self.overload = overload
        self._ns_stale: dict = {}
        self._kind_est: dict = {}
        self._kind_est_total = -1

    # --- the handler (reference: validationHandler.Handle, policy.go:139) -
    def handle(self, review_body: dict,
               cost_hint: int = 0) -> ValidationResponse:
        cost = 0.0
        tenant, lane = self._route(review_body)
        t0 = time.perf_counter()
        if self.overload is not None:
            from gatekeeper_tpu_torch.resilience.overload import (
                Shed, estimate_cost)

            try:
                cost = estimate_cost(review_body, cost_hint,
                                     self._constraint_estimate)
                # QoS kwargs only when routing produced a lane: plain gates
                # keep their admit(cost) shape
                gate = (self.overload.admit(cost, tenant=tenant,
                                            priority=lane)
                        if lane is not None
                        else self.overload.admit(cost))
                with gate:
                    resp = self._counted(review_body)
            except Shed as shed:
                resp = self._shed_response(review_body, shed)
                self._record_decision(review_body, resp, cost,
                                      shed_reason=shed.reason,
                                      tenant=tenant, lane=lane)
                self._attr_tenant(tenant, time.perf_counter() - t0, cost)
                return resp
        else:
            resp = self._counted(review_body)
        self._record_decision(review_body, resp, cost,
                              tenant=tenant, lane=lane)
        self._attr_tenant(tenant, time.perf_counter() - t0, cost)
        return resp

    def _route(self, review_body: dict) -> tuple:
        """(tenant, PriorityLevel-or-None) for this request: the QoS
        routing when the controller carries a QoS config, else the plain
        namespace/serviceaccount tenant key — the attribution axis of the
        flight recorder and the cost grid, present with or without QoS."""
        route = getattr(self.overload, "route", None)
        if route is not None:
            tenant, lane = route(review_body)
            if lane is not None:
                return tenant, lane
        from gatekeeper_tpu_torch.observability import costattr, flightrec
        from gatekeeper_tpu_torch.resilience.qos import tenant_of_request

        if flightrec.active() is None and costattr.active() is None:
            return "", None  # nobody consumes the axis: skip the lookup
        return tenant_of_request(review_body.get("request") or {}), None

    def _attr_tenant(self, tenant: str, seconds: float,
                     cost: float) -> None:
        """Per-tenant admission cost attribution (the ``{tenant}`` axis
        on ``gatekeeper_constraint_eval_seconds``): one wall-time sample
        per admission, charged to the request's tenant."""
        if not tenant:
            return
        from gatekeeper_tpu_torch.observability import costattr

        attr = costattr.active()
        if attr is not None:
            attr.record_tenant(tenant, costattr.EP_WEBHOOK, seconds,
                               cost=cost)

    def _record_decision(self, review_body: dict, resp,
                         cost: float = 0.0, shed_reason: str = "",
                         tenant: str = "", lane=None) -> None:
        """Flight-recorder seam: one structured entry per decision (a
        no-op without an installed recorder)."""
        from gatekeeper_tpu_torch.observability import flightrec

        rec = flightrec.active()
        if rec is None:
            return
        req = review_body.get("request") or {}
        if shed_reason:
            decision = "shed"
        elif resp.allowed:
            decision = "allow"
        elif resp.code == 500:
            decision = "error"
        elif resp.code == 504:
            decision = "deadline"
        else:
            decision = "deny"
        rec.record(
            "validate", decision,
            uid=resp.uid or req.get("uid", "") or "",
            obj_kind=(req.get("kind") or {}).get("kind", ""),
            name=req.get("name", "") or "",
            namespace=req.get("namespace", "") or "",
            operation=req.get("operation", "") or "",
            message=resp.message,
            cost=cost,
            reason=shed_reason,
            warnings=len(resp.warnings or []),
            code=resp.code if not resp.allowed else 0,
            overload=self.overload,
            tenant=tenant,
            priority=getattr(lane, "name", "") or "",
            # capture mode: the raw admission request rides the JSONL
            # sink line (never the ring)
            request=(req if getattr(rec, "capture", False) else None),
        )

    def _counted(self, review_body: dict) -> ValidationResponse:
        if self.metrics is None:
            return self._guarded(review_body)
        from gatekeeper_tpu_torch.metrics import registry as m

        status = "error"  # count even when _handle itself raises
        try:
            with self.metrics.timed(m.REQUEST_DURATION):
                resp = self._guarded(review_body)
            if not resp.allowed and resp.code == 500:
                status = "error"  # internal error surfaced as Errored deny
            else:
                status = "allow" if resp.allowed else "deny"
            return resp
        finally:
            self.metrics.inc_counter(m.REQUEST_COUNT,
                                     {"admission_status": status})

    # --- overload plumbing ------------------------------------------------
    def _constraint_estimate(self, kind: str) -> int:
        """Matched-constraint count per kind for the admission cost model
        (cost = object bytes x this).  Cached until the constraint count
        changes; an estimate, not a matcher — namespaces and labels are
        not consulted."""
        cons = self.client.constraints()
        if self._kind_est_total != len(cons):
            self._kind_est_total = len(cons)
            self._kind_est.clear()
        n = self._kind_est.get(kind)
        if n is None:
            n = 0
            for c in cons:
                entries = (c.match or {}).get("kinds") or []
                if not entries:
                    n += 1
                    continue
                for e in entries:
                    ks = e.get("kinds") or []
                    if not ks or "*" in ks or kind in ks:
                        n += 1
                        break
            n = max(1, n)
            self._kind_est[kind] = n
        return n

    def _shed_response(self, review_body: dict, shed) -> ValidationResponse:
        """Shed semantics == deadline-miss semantics: the request's
        failurePolicy decides (Ignore = allow + warning annotation,
        Fail = deny 429 with Retry-After)."""
        uid = ((review_body.get("request") or {}).get("uid", "")) or ""
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("webhook.shed", uid=uid, reason=shed.reason,
                          policy=self.failure_policy):
            pass
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as m

            self.metrics.inc_counter(m.REQUEST_COUNT,
                                     {"admission_status": "shed"})
        log_event("warning", "admission request shed under overload",
                  event_type="overload_shed_resolved",
                  shed_reason=shed.reason,
                  failure_policy=self.failure_policy)
        if self.fail_open:
            return ValidationResponse(
                allowed=True, uid=uid,
                warnings=[
                    f"gatekeeper shed this request under overload "
                    f"({shed.reason}); failurePolicy=Ignore admitted it "
                    f"unreviewed"],
            )
        return ValidationResponse(
            allowed=False, uid=uid, code=429,
            message=(f"gatekeeper shed this request under overload "
                     f"({shed.reason}) (failurePolicy=Fail); retry after "
                     f"{shed.retry_after_s:.0f}s"),
            retry_after_s=shed.retry_after_s or 1.0,
        )

    def _guarded(self, review_body: dict) -> ValidationResponse:
        """Deadline-budget guard (reference: the apiserver's webhook
        ``timeoutSeconds`` enforced server-side so the ANSWER — not the
        apiserver's socket timeout — honors failurePolicy).  The review
        runs on a helper thread with the budget propagated by contextvar
        (dependencies bound their own waits by it); if the budget expires
        the request resolves per failurePolicy immediately: Ignore allows
        with a warning annotation, Fail denies with reason.  A timed-out
        review thread finishes in the background and its result is
        dropped."""
        if self.deadline_budget_s <= 0:
            return self._handle(review_body)
        from gatekeeper_tpu_torch.observability import tracing
        from gatekeeper_tpu_torch.resilience.policy import (Deadline,
                                                            deadline_scope)

        dl = Deadline(self.deadline_budget_s)
        done = threading.Event()
        slot: dict = {}
        parent_span = tracing.current_span()  # request span -> helper thread

        def run():
            try:
                with tracing.use_span(parent_span), deadline_scope(dl):
                    slot["resp"] = self._handle(review_body)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                slot["err"] = e
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name="admit-deadline").start()
        if done.wait(dl.remaining()):
            err = slot.get("err")
            if err is not None:
                raise err
            return slot["resp"]
        uid = ((review_body.get("request") or {}).get("uid", "")) or ""
        tracing.add_event("deadline_exceeded", component="webhook",
                          policy=self.failure_policy,
                          budget_s=self.deadline_budget_s)
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as m

            self.metrics.inc_counter(
                m.RESILIENCE_DEADLINE_EXCEEDED,
                {"component": "webhook", "policy": self.failure_policy})
        log_event("warning", "admission deadline budget exceeded",
                  event_type="deadline_exceeded",
                  deadline_budget_s=self.deadline_budget_s,
                  failure_policy=self.failure_policy)
        if self.fail_open:
            return ValidationResponse(
                allowed=True, uid=uid,
                warnings=[
                    f"gatekeeper review exceeded its "
                    f"{self.deadline_budget_s:.3f}s deadline budget; "
                    f"failurePolicy=Ignore admitted the request "
                    f"unreviewed"],
            )
        return ValidationResponse(
            allowed=False, uid=uid, code=504,
            message=(f"gatekeeper review exceeded its "
                     f"{self.deadline_budget_s:.3f}s deadline budget "
                     f"(failurePolicy=Fail)"),
        )

    def _handle(self, review_body: dict) -> ValidationResponse:
        req = parse_admission_review(review_body)
        username = (req.user_info or {}).get("username", "")

        # self-management bypass (policy.go:142)
        if username.startswith(GATEKEEPER_SA_PREFIX):
            return ValidationResponse(allowed=True, uid=req.uid)

        # gatekeeper resource meta-validation fast path (policy.go:359-401)
        group, _, _ = gvk_of(req.object or {})
        if group in (TEMPLATES_GROUP, CONSTRAINTS_GROUP, EXPANSION_GROUP,
                     MUTATIONS_GROUP):
            return self._validate_gatekeeper_resource(req)

        # namespace exclusion (policy.go:170)
        if self.process_excluder is not None and req.namespace:
            if self.process_excluder.is_excluded("webhook", req.namespace):
                return ValidationResponse(allowed=True, uid=req.uid)

        ns_obj = self._lookup_namespace(req.namespace) if req.namespace \
            else None
        augmented = AugmentedReview(
            admission_request=req, namespace=ns_obj,
            source=SOURCE_ORIGINAL, is_admission=True,
        )
        try:
            responses = self._review(augmented)
        except Exception as e:
            # admission.Errored equivalent (policy.go:664-668): a
            # well-formed allowed=false code-500 response under
            # failurePolicy=Fail; Ignore admits with a warning
            if self.fail_open:
                return ValidationResponse(
                    allowed=True, uid=req.uid,
                    warnings=[f"review failed: {e}"],
                )
            return ValidationResponse(
                allowed=False, uid=req.uid, code=500,
                message=f"review failed: {e}",
            )

        expansion_warnings: list = []
        if self.expansion_system is not None and req.object:
            try:
                resultants = self.expansion_system.expand(
                    dict(req.object), namespace=ns_obj,
                    username=username, source=SOURCE_ORIGINAL,
                )
            except ExpansionError as e:
                # the reference errors the request, which fails open under
                # failurePolicy=ignore (policy.go:626-631) — surface a warning
                resultants = []
                expansion_warnings.append(f"expansion failed: {e}")
            for r in resultants:
                r_aug = AugmentedUnstructured(
                    object=r.obj, namespace=ns_obj, source=SOURCE_GENERATED
                )
                r_resp = self.client.review(
                    r_aug, enforcement_point=WEBHOOK_EP
                )
                aggregate.override_enforcement_action(
                    r.enforcement_action, r_resp
                )
                aggregate.aggregate_responses(r.template_name, responses,
                                              r_resp)

        denies, warns = self._partition(responses)
        warns = warns + expansion_warnings
        if self.log_denies and denies:
            for result in responses.results():
                actions = (result.scoped_enforcement_actions
                           if result.enforcement_action == "scoped"
                           else [result.enforcement_action])
                if "deny" in actions:
                    log_deny(result, req)
        if denies:
            resp = ValidationResponse(
                allowed=False, message="\n".join(denies), code=403,
                warnings=warns, uid=req.uid,
            )
        else:
            resp = ValidationResponse(allowed=True, warnings=warns,
                                      uid=req.uid)
        if self.event_sink is not None:
            results = responses.results()
            if results:  # the reference emits per result, dryrun included
                self.event_sink(req, results)
        return resp

    def _lookup_namespace(self, name: str):
        """Namespace lookup with brownout degradation: at brownout level
        >= 1 — or while a breaching SLO objective holds the
        ``ns_cache_stale`` degradation action — the lookup is skipped and
        the last-seen value serves STALE: the first rung of the ladder,
        degraded before any request is shed."""
        from gatekeeper_tpu_torch.resilience import overload as _ovl

        degraded = (self.overload is not None
                    and self.overload.brownout_level() >= 1) or \
            _ovl.degradation_active(_ovl.NS_CACHE_STALE)
        if degraded and name in self._ns_stale:
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as m

                self.metrics.inc_counter(
                    m.RESILIENCE_STALE_SERVED,
                    {"dependency": "webhook/namespace_lookup"})
            return self._ns_stale[name]
        ns_obj = None
        if self.snapshot is not None:
            # the watch-synced resident snapshot answers without leaving
            # the process (None when stale or unknown: ask the source)
            ns_obj = self.snapshot.namespace(name)
        if ns_obj is None:
            ns_obj = self.namespace_lookup(name)
        if self.overload is not None or \
                _ovl.active_degradations() is not None:
            if len(self._ns_stale) >= 4096 and name not in self._ns_stale:
                self._ns_stale.pop(next(iter(self._ns_stale)))
            self._ns_stale[name] = ns_obj
        return ns_obj

    def _review(self, augmented):
        req = augmented.admission_request
        from gatekeeper_tpu_torch.observability import tracing as otel

        with otel.span("webhook.review", uid=req.uid,
                       kind=(req.kind or {}).get("kind", "")):
            from gatekeeper_tpu_torch.resilience.faults import fault_point

            fault_point("webhook.review", uid=req.uid,
                        kind=(req.kind or {}).get("kind", ""))
            trace = self._trace_for(req)
            if trace is None and self.batcher is not None:
                # hot path: stats ride the coalesced batch; only a traced
                # request bypasses it (policy.go:632-675)
                responses = self.batcher.review(augmented)
                if self.log_stats:
                    self._log_stats(responses)
                return responses
            responses = self.client.review(
                augmented, enforcement_point=WEBHOOK_EP,
                tracing=trace is not None, stats=self.log_stats)
            if trace is not None:
                log_event("info", "admission trace",
                          event_type="admission_trace",
                          request_user=(req.user_info or {}).get(
                              "username", ""),
                          resource_kind=(req.kind or {}).get("kind", ""),
                          trace_dump=responses.trace_dump())
                if str(trace.get("dump", "")).lower() == "all":
                    log_event("info", "cache dump",
                              event_type="admission_trace_dump",
                              dump=str(self.client.dump()))
            if self.log_stats:
                self._log_stats(responses)
            return responses

    def _log_stats(self, responses) -> None:
        for entry in getattr(responses, "stats_entries", []) or []:
            log_event("info", "admission stats",
                      event_type="admission_stats",
                      scope=entry.scope,
                      stats_for=entry.stats_for,
                      stats=[(s.name, s.value) for s in entry.stats])

    def _trace_for(self, req) -> Optional[dict]:
        """Config spec.validation.traces[] lookup (config_types.go:42-54:
        both user and kind must match)."""
        if self.trace_config is None:
            return None
        username = (req.user_info or {}).get("username", "")
        kind = req.kind or {}
        for t in self.trace_config() or []:
            if t.get("user", "") != username:
                continue
            want = t.get("kind") or {}
            if (want.get("group", "") == kind.get("group", "")
                    and want.get("version", "") == kind.get("version", "")
                    and want.get("kind", "") == kind.get("kind", "")):
                return t
        return None

    # --- deny/warn partition (reference: getValidationMessages,
    # policy.go:205-355) --------------------------------------------------
    @staticmethod
    def _partition(responses) -> tuple[list, list]:
        denies, warns = [], []
        for result in responses.results():
            if result.enforcement_action == "scoped":
                actions = result.scoped_enforcement_actions
            else:
                actions = [result.enforcement_action]
            for action in actions:
                if action == "deny":
                    denies.append(
                        f"[{_constraint_label(result)}] {result.msg}")
                elif action == "warn":
                    warns.append(
                        f"[{_constraint_label(result)}] {result.msg}")
                # dryrun: recorded in logs/metrics only
        return denies, warns

    # --- gatekeeper resource validation (policy.go:403-580) --------------
    def _validate_gatekeeper_resource(self, req) -> ValidationResponse:
        obj = req.object or {}
        group, _, kind = gvk_of(obj)
        if req.operation == "DELETE":
            return ValidationResponse(allowed=True, uid=req.uid)
        try:
            if group == TEMPLATES_GROUP and kind == "ConstraintTemplate":
                self.client.create_crd(obj)  # dry-run compile (policy.go:430)
                # also ensure an engine can compile the source
                t = ConstraintTemplate.from_unstructured(obj)
                if not any(d.has_source_for(t) for d in self.client.drivers):
                    raise TemplateError(
                        f"template {t.name}: no driver understands its "
                        f"source")
            elif group == CONSTRAINTS_GROUP:
                self.client.validate_constraint(obj)
            elif group == EXPANSION_GROUP and kind == "ExpansionTemplate":
                ExpansionTemplate.from_unstructured(obj)
            elif group == MUTATIONS_GROUP and kind in MUTATOR_KINDS:
                mutator_from_unstructured(obj)
        except Exception as e:
            return ValidationResponse(
                allowed=False, message=str(e), code=422, uid=req.uid
            )
        return ValidationResponse(allowed=True, uid=req.uid)


def _constraint_label(result) -> str:
    # reference formats "[<constraint metadata.name>] msg" (policy.go:346)
    c = result.constraint or {}
    return (c.get("metadata") or {}).get("name", "")


class Batcher:
    """Microbatching lane: coalesce concurrent reviews into one device pass.

    The reference bounds concurrency with a semaphore
    (--max-serving-threads, policy.go:116-120); here the equivalent
    resource is the batch axis — requests wait at most ``window_s`` to share
    a verdict-grid pass.  The batcher thread owns every device call; HTTP
    handler threads only enqueue.

    Batches of ``small_batch`` or fewer reviews take the per-review exact
    interpreter (the low-latency lane; a grid pass has a fixed cost of
    flatten + masks + one evaluation per template); larger ones take the
    grid lane (``client.review_batch``).  The lanes agree bit for bit.
    ``lane_counts`` and ``batch_sizes`` count the batches per lane and per
    size (written by the batcher thread only)."""

    def __init__(self, client, window_s: float = 0.003, max_batch: int = 64,
                 stats: bool = False, small_batch: Optional[int] = None,
                 metrics=None):
        self.client = client
        self.window_s = window_s
        self.max_batch = max_batch
        self.stats = stats
        # serving-lane contention: how long each review sat queued before
        # its batch ran, and the coalesced batch sizes
        self.metrics = metrics
        self.small_batch = 8 if small_batch is None else small_batch
        self.lane_counts: Counter = Counter()
        self.batch_sizes: Counter = Counter()
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="webhook-batcher")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> bool:
        """Stop AND drain: the loop keeps flushing until the queue is
        empty before exiting, so reviews queued at stop time still get
        their verdicts.  Idempotent; returns True when the loop exited
        (queue drained) within ``timeout``."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
            return not self._thread.is_alive()
        return True

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def review(self, augmented):
        from gatekeeper_tpu_torch.observability import tracing
        from gatekeeper_tpu_torch.resilience.policy import (
            DeadlineExceeded, current_deadline)

        done = threading.Event()
        slot: dict = {}
        # the caller's span rides the queue entry so the batch thread's
        # flush span can parent into the request's trace (cross-thread
        # propagation is explicit — contextvars don't cross the lane)
        with tracing.span("webhook.batcher.enqueue") as sp:
            self._queue.put((augmented, done, slot, time.perf_counter(),
                             tracing.current_span()))
            dl = current_deadline()
            timeout = None if dl is None else dl.remaining()
            if not done.wait(timeout):
                # the request's deadline budget expired while queued (or on
                # the device): abandon the slot — the batch loop still sets
                # it later, nobody is waiting
                sp.add_event("deadline_exceeded", component="batcher")
                raise DeadlineExceeded("batched review outlived the "
                                       "request deadline budget")
        if "error" in slot:
            raise slot["error"]
        return slot["responses"]

    def _observe_batch(self, batch) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as m

        now = time.perf_counter()
        self.metrics.observe(m.WEBHOOK_BATCH_SIZE, len(batch))
        for entry in batch:
            self.metrics.observe(m.WEBHOOK_QUEUE_WAIT, now - entry[3])

    def _loop(self):
        from gatekeeper_tpu_torch.observability import tracing

        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                # exit only when stopped AND drained: entries queued at
                # stop time flush first (zero-loss shutdown)
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            # drain whatever is already queued without blocking; the
            # window timer only runs when there IS accumulation — an idle
            # server answers a lone request immediately
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if len(batch) > self.small_batch:
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=timeout))
                    except queue.Empty:
                        break
            self._observe_batch(batch)
            lane = "interp" if len(batch) <= self.small_batch else "grid"
            self.lane_counts[lane] += 1
            self.batch_sizes[len(batch)] += 1
            try:
                # the flush span lives on the batch thread, parented into
                # the FIRST entry's trace (its request waited longest); the
                # other coalesced requests are recorded by count
                with tracing.span("webhook.batcher.flush",
                                  parent=batch[0][4],
                                  batch_size=len(batch), lane=lane):
                    if lane == "interp":
                        # per-review exact interpreter: each slot completes
                        # as soon as ITS review finishes (no head-of-line
                        # wait)
                        for aug, done, slot, _t, _sp in batch:
                            try:
                                slot["responses"] = self.client.review(
                                    aug, enforcement_point=WEBHOOK_EP,
                                    stats=self.stats)
                            except Exception as e:
                                slot["error"] = e
                            done.set()
                        continue
                    all_responses = self.client.review_batch(
                        [b[0] for b in batch], enforcement_point=WEBHOOK_EP,
                        stats=self.stats)
                for (_, done, slot, _t, _sp), responses in zip(
                        batch, all_responses):
                    # per-slot isolation: one bad request must not poison
                    # the coalesced batch (review_batch returns Exception
                    # entries)
                    if isinstance(responses, Exception):
                        slot["error"] = responses
                    else:
                        slot["responses"] = responses
                    done.set()
            except Exception as e:
                for _, done, slot, _t, _sp in batch:
                    slot["error"] = e
                    done.set()
