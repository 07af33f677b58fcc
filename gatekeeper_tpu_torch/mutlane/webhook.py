"""Batched `/v1/mutate` serving: microbatching + overload + drain.

The per-object :class:`webhook.mutation.MutationHandler` walks the full
mutator registry per request.  This handler routes mutate reviews
through a microbatching lane exactly like validation does (SURVEY.md
§7's dual-queue design): concurrent mutate admissions coalesce into ONE
:class:`mutlane.lane.MutationLane` pass, and the response patches come
back per slot.  The overload gate
(``resilience/overload.OverloadController``) fronts the review with the
same shed semantics as validation — mutation's failurePolicy decides
(Ignore = admit unmutated + warning, Fail = 429 + Retry-After) — and the
batcher exposes ``queue_depth``/``stop`` so the server's zero-loss drain
covers in-flight mutate reviews too.

Port of ``gatekeeper_tpu/mutlane/webhook.py``, with the JAX package's
hooks: overload and QoS shedding, request deadlines while a review is
queued, the flight recorder, per-tenant cost records, metrics and spans.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.webhook.mutation import MutationResponse
from gatekeeper_tpu_torch.webhook.policy import parse_admission_review


class MutationBatcher:
    """Microbatching lane for mutate reviews: coalesce concurrent
    admissions into one batched lane pass.  Mirrors the validation
    ``Batcher``'s lifecycle contract — ``stop`` drains the queue so
    reviews queued at stop time still answer (zero-loss drain), and
    ``queue_depth`` lets the server wait on it."""

    def __init__(self, lane, window_s: float = 0.003, max_batch: int = 64,
                 metrics=None):
        self.lane = lane
        self.window_s = window_s
        self.max_batch = max_batch
        self.metrics = metrics
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> "MutationBatcher":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mutation-batcher")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> bool:
        """Stop AND drain (idempotent): the loop flushes until the queue
        is empty before exiting."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
            return not self._thread.is_alive()
        return True

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def mutate(self, obj: dict, ns_obj):
        """Enqueue one object; blocks until its batch flushed.  Returns
        the :class:`MutationOutcome`."""
        from gatekeeper_tpu_torch.observability import tracing
        from gatekeeper_tpu_torch.resilience.policy import (DeadlineExceeded,
                                                      current_deadline)

        done = threading.Event()
        slot: dict = {}
        self._queue.put((obj, ns_obj, done, slot, time.perf_counter(),
                         tracing.current_span()))
        dl = current_deadline()
        timeout = None if dl is None else dl.remaining()
        if not done.wait(timeout):
            raise DeadlineExceeded("batched mutation outlived the "
                                   "request deadline budget")
        if "error" in slot:
            raise slot["error"]
        return slot["outcome"]

    def _observe_batch(self, batch) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as m

        now = time.perf_counter()
        self.metrics.observe(m.WEBHOOK_BATCH_SIZE, len(batch))
        for entry in batch:
            self.metrics.observe(m.WEBHOOK_QUEUE_WAIT, now - entry[4])

    def _loop(self):
        from gatekeeper_tpu_torch.observability import tracing

        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return  # stopped AND drained
                continue
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if len(batch) > 1:
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
            try:
                with tracing.span("webhook.batcher.flush",
                                  parent=batch[0][5],
                                  batch_size=len(batch), lane="mutate"):
                    outcomes = self.lane.mutate_objects(
                        [b[0] for b in batch],
                        namespaces=[b[1] for b in batch],
                        source=SOURCE_ORIGINAL)
                for (_o, _ns, done, slot, _t, _sp), outcome in zip(
                        batch, outcomes):
                    slot["outcome"] = outcome
                    done.set()
            except Exception as e:
                for _o, _ns, done, slot, _t, _sp in batch:
                    slot["error"] = e
                    done.set()


class BatchedMutationHandler:
    """`/v1/mutate` handler over the batched lane (reference semantics:
    pkg/webhook/mutation.go — CREATE/UPDATE only, namespace from cache,
    JSONPatch response; errors answer allowed with a message).  Without a
    ``lane``, one is built on ``device`` with the ``ingest`` lane."""

    def __init__(self, mutation_system, lane=None, namespace_lookup=None,
                 process_excluder=None,
                 batcher: Optional[MutationBatcher] = None,
                 device: str = "cuda", ingest: str = "dict", metrics=None,
                 overload=None, failure_policy: str = "ignore"):
        from gatekeeper_tpu_torch.mutlane.lane import MutationLane

        self.system = mutation_system
        self.lane = lane or MutationLane(mutation_system, device=device,
                                         ingest=ingest, metrics=metrics)
        self.namespace_lookup = namespace_lookup or (lambda name: None)
        self.process_excluder = process_excluder
        self.batcher = batcher
        self.metrics = metrics
        # the mutating webhook's failurePolicy (reference default Ignore:
        # a failed/shed mutation admits the object UNMUTATED)
        if failure_policy not in ("ignore", "fail"):
            raise ValueError(f"failure_policy must be ignore|fail, "
                             f"got {failure_policy!r}")
        self.failure_policy = failure_policy
        self.overload = overload
        self._mut_est: dict = {}
        self._mut_est_rev = -1

    # --- overload cost model ----------------------------------------------
    def _mutator_estimate(self, kind: str) -> int:
        """Matched-mutator count per kind (cost = object bytes × this);
        cached until the registry revision moves."""
        rev = self.system.revision()
        if self._mut_est_rev != rev:
            self._mut_est_rev = rev
            self._mut_est.clear()
        n = self._mut_est.get(kind)
        if n is None:
            n = 0
            for m in self.system.active():
                if not m.apply_to:
                    n += 1  # AssignMetadata: applies to every GVK
                    continue
                for e in m.apply_to:
                    if kind in (e.get("kinds") or []):
                        n += 1
                        break
            n = max(1, n)
            self._mut_est[kind] = n
        return n

    # --- the handler -------------------------------------------------------
    def handle(self, review_body: dict,
               cost_hint: int = 0) -> MutationResponse:
        import time as _t

        from gatekeeper_tpu_torch.observability import tracing

        uid = ((review_body.get("request") or {}).get("uid", "")) or ""
        t0 = _t.perf_counter()
        with tracing.span("webhook.mutate", uid=uid):
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(M.MUTATION_REQUEST_COUNT)
            cost = 0.0
            tenant, lane = self._route(review_body)
            try:
                if self.overload is not None:
                    from gatekeeper_tpu_torch.resilience.overload import (
                        Shed, estimate_cost)

                    try:
                        cost = estimate_cost(review_body, cost_hint,
                                             self._mutator_estimate)
                        # QoS kwargs only when routing produced a lane:
                        # legacy gates (and test doubles) keep their
                        # admit(cost) shape
                        gate = (self.overload.admit(
                            cost, tenant=tenant, priority=lane)
                            if lane is not None
                            else self.overload.admit(cost))
                        with gate:
                            resp = self._handle(review_body)
                    except Shed as shed:
                        resp = self._shed_response(review_body, shed)
                        self._record_decision(review_body, resp, cost,
                                              shed_reason=shed.reason,
                                              tenant=tenant, lane=lane)
                        self._attr_tenant(tenant,
                                          _t.perf_counter() - t0, cost)
                        return resp
                else:
                    resp = self._handle(review_body)
            finally:
                if self.metrics is not None:
                    self.metrics.observe(M.MUTATION_REQUEST_DURATION,
                                         _t.perf_counter() - t0)
            self._record_decision(review_body, resp, cost,
                                  tenant=tenant, lane=lane)
            self._attr_tenant(tenant, _t.perf_counter() - t0, cost)
            return resp

    def _route(self, review_body: dict) -> tuple:
        """(tenant, PriorityLevel-or-None): QoS routing when enabled,
        else the plain tenant key for the flight-recorder / cost-grid
        attribution axis (mirrors ValidationHandler._route)."""
        # duck-typed: test doubles / custom gates may not speak QoS
        route = getattr(self.overload, "route", None)
        if route is not None:
            tenant, lane = route(review_body)
            if lane is not None:
                return tenant, lane
        from gatekeeper_tpu_torch.observability import costattr, flightrec
        from gatekeeper_tpu_torch.resilience.qos import tenant_of_request

        if flightrec.active() is None and costattr.active() is None:
            return "", None
        return tenant_of_request(review_body.get("request") or {}), None

    def _attr_tenant(self, tenant: str, seconds: float,
                     cost: float) -> None:
        if not tenant:
            return
        from gatekeeper_tpu_torch.observability import costattr

        attr = costattr.active()
        if attr is not None:
            attr.record_tenant(tenant, costattr.EP_MUTATION, seconds,
                               cost=cost)

    def _record_decision(self, review_body: dict, resp,
                         cost: float = 0.0, shed_reason: str = "",
                         tenant: str = "", lane=None) -> None:
        from gatekeeper_tpu_torch.observability import flightrec

        rec = flightrec.active()
        if rec is None:
            return
        req = review_body.get("request") or {}
        decision = "shed" if shed_reason else (
            "allow" if resp.allowed else "deny")
        if not shed_reason and resp.message:
            decision = "error"  # mutate errors answer allowed + message
        rec.record(
            "mutate", decision,
            uid=resp.uid or req.get("uid", "") or "",
            obj_kind=(req.get("kind") or {}).get("kind", ""),
            name=req.get("name", "") or "",
            namespace=req.get("namespace", "") or "",
            operation=req.get("operation", "") or "",
            message=resp.message,
            cost=cost,
            reason=shed_reason,
            lane=getattr(resp, "lane", "") or "",
            patch_ops=len(resp.patch or []) if resp.patch else 0,
            overload=self.overload,
            tenant=tenant,
            priority=getattr(lane, "name", "") or "",
        )

    def _shed_response(self, review_body, shed) -> MutationResponse:
        uid = ((review_body.get("request") or {}).get("uid", "")) or ""
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("webhook.shed", uid=uid, reason=shed.reason,
                          policy=self.failure_policy, endpoint="mutate"):
            pass
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.MUTATION_REQUEST_COUNT,
                                     {"admission_status": "shed"})
        if self.failure_policy == "ignore":
            return MutationResponse(
                allowed=True, uid=uid,
                warnings=[f"gatekeeper shed this mutation under overload "
                          f"({shed.reason}); failurePolicy=Ignore "
                          f"admitted it unmutated"])
        return MutationResponse(
            allowed=False, uid=uid, code=429,
            message=(f"gatekeeper shed this mutation under overload "
                     f"({shed.reason}) (failurePolicy=Fail); retry after "
                     f"{shed.retry_after_s:.0f}s"),
            retry_after_s=shed.retry_after_s or 1.0)

    def _handle(self, review_body: dict) -> MutationResponse:
        req = parse_admission_review(review_body)
        if req.operation not in ("CREATE", "UPDATE") or req.object is None:
            return MutationResponse(allowed=True, uid=req.uid)
        if self.process_excluder is not None and req.namespace:
            if self.process_excluder.is_excluded("mutation-webhook",
                                                 req.namespace):
                return MutationResponse(allowed=True, uid=req.uid)
        ns_obj = (self.namespace_lookup(req.namespace)
                  if req.namespace else None)
        try:
            if self.batcher is not None:
                outcome = self.batcher.mutate(req.object, ns_obj)
            else:
                outcome = self.lane.mutate_objects(
                    [req.object], namespaces=[ns_obj],
                    source=SOURCE_ORIGINAL)[0]
        except Exception as e:
            return MutationResponse(allowed=True, message=str(e),
                                    uid=req.uid)
        if outcome.error is not None:
            return MutationResponse(allowed=True, message=outcome.error,
                                    uid=req.uid)
        resp = MutationResponse(allowed=True, patch=outcome.patch,
                                uid=req.uid)
        resp.lane = outcome.lane  # flight-recorder context (non-wire)
        return resp
