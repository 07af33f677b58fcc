"""Validating admission handler (reference: pkg/webhook/policy.go).

Port of ``gatekeeper_tpu/webhook/policy.py``.  Flow:
- self-management bypass for the gatekeeper service account (policy.go:142)
- gatekeeper-resource meta-validation fast path (templates and constraints
  validated structurally, policy.go:359-401)
- namespace exclusion via the process excluder (policy.go:170)
- review of the request
- deny/warn partition by enforcement action incl. scoped (policy.go:256-353)

Requests funnel into a **microbatching lane** (:class:`Batcher`) that
coalesces concurrent admissions into one ``review_batch`` call, whose
lowered kinds evaluate as one verdict grid per template on the device.

Not ported yet: overload/QoS, shadow, the flight recorder, cost
attribution, tracing, deadlines, metrics, the snapshot lookup, the fleet
cluster label, validation traces and expansion.  Mutators and
ExpansionTemplates cannot be validated until their modules are ported:
they are admitted with a warning that says so.
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
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.target.review import AdmissionRequest, AugmentedReview
from gatekeeper_tpu_torch.utils.logging import log_deny
from gatekeeper_tpu_torch.utils.unstructured import gvk_of

GATEKEEPER_SA_PREFIX = "system:serviceaccount:gatekeeper-system:"
TEMPLATES_GROUP = "templates.gatekeeper.sh"
EXPANSION_GROUP = "expansion.gatekeeper.sh"
MUTATIONS_GROUP = "mutations.gatekeeper.sh"
MUTATOR_KINDS = ("Assign", "AssignMetadata", "ModifySet", "AssignImage")


@dataclass
class ValidationResponse:
    allowed: bool
    message: str = ""
    code: int = 200
    warnings: list = field(default_factory=list)
    uid: str = ""


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
        failure_policy: str = "fail",  # "ignore" | "fail"
    ):
        self.client = client
        self.process_excluder = process_excluder
        self.namespace_lookup = namespace_lookup or (lambda name: None)
        self.batcher = batcher
        self.log_denies = log_denies
        # failurePolicy (reference ValidatingWebhookConfiguration
        # failurePolicy): Ignore fails open, Fail fails closed
        if failure_policy not in ("ignore", "fail"):
            raise ValueError(f"failure_policy must be ignore|fail, "
                             f"got {failure_policy!r}")
        self.failure_policy = failure_policy

    # --- the handler (reference: validationHandler.Handle, policy.go:139) -
    def handle(self, review_body: dict) -> ValidationResponse:
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

        ns_obj = self.namespace_lookup(req.namespace) if req.namespace \
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
            if self.failure_policy == "ignore":
                return ValidationResponse(
                    allowed=True, uid=req.uid,
                    warnings=[f"review failed: {e}"],
                )
            return ValidationResponse(
                allowed=False, uid=req.uid, code=500,
                message=f"review failed: {e}",
            )

        denies, warns = self._partition(responses)
        if self.log_denies and denies:
            for result in responses.results():
                actions = (result.scoped_enforcement_actions
                           if result.enforcement_action == "scoped"
                           else [result.enforcement_action])
                if "deny" in actions:
                    log_deny(result, req)
        if denies:
            return ValidationResponse(
                allowed=False, message="\n".join(denies), code=403,
                warnings=warns, uid=req.uid,
            )
        return ValidationResponse(allowed=True, warnings=warns, uid=req.uid)

    def _review(self, augmented):
        if self.batcher is not None:
            return self.batcher.review(augmented)
        return self.client.review(augmented, enforcement_point=WEBHOOK_EP)

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
        if (group == EXPANSION_GROUP and kind == "ExpansionTemplate") or \
                (group == MUTATIONS_GROUP and kind in MUTATOR_KINDS):
            return ValidationResponse(
                allowed=True, uid=req.uid,
                warnings=[f"{kind} not validated: mutation/expansion not "
                          f"ported"])
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
                 stats: bool = False, small_batch: Optional[int] = None):
        self.client = client
        self.window_s = window_s
        self.max_batch = max_batch
        self.stats = stats
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
        done = threading.Event()
        slot: dict = {}
        self._queue.put((augmented, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["responses"]

    def _loop(self):
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
            lane = "interp" if len(batch) <= self.small_batch else "grid"
            self.lane_counts[lane] += 1
            self.batch_sizes[len(batch)] += 1
            if lane == "interp":
                # per-review exact interpreter: each slot completes as
                # soon as ITS review finishes (no head-of-line wait)
                for aug, done, slot in batch:
                    try:
                        slot["responses"] = self.client.review(
                            aug, enforcement_point=WEBHOOK_EP,
                            stats=self.stats)
                    except Exception as e:
                        slot["error"] = e
                    done.set()
                continue
            try:
                all_responses = self.client.review_batch(
                    [b[0] for b in batch], enforcement_point=WEBHOOK_EP,
                    stats=self.stats)
                for (_, done, slot), responses in zip(batch, all_responses):
                    # per-slot isolation: one bad request must not poison
                    # the coalesced batch (review_batch returns Exception
                    # entries)
                    if isinstance(responses, Exception):
                        slot["error"] = responses
                    else:
                        slot["responses"] = responses
                    done.set()
            except Exception as e:
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
