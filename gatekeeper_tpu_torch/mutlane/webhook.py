"""Batched `/v1/mutate` serving: microbatching + drain.

The per-object :class:`webhook.mutation.MutationHandler` walks the full
mutator registry per request.  This handler routes mutate reviews
through a microbatching lane exactly like validation does (SURVEY.md
§7's dual-queue design): concurrent mutate admissions coalesce into ONE
:class:`mutlane.lane.MutationLane` pass, and the response patches come
back per slot.  The batcher exposes ``queue_depth``/``stop`` so the
server's zero-loss drain covers in-flight mutate reviews too.

Port of ``gatekeeper_tpu/mutlane/webhook.py``.  Not ported yet, as in the
port's validating handler: overload and QoS shedding, the flight
recorder, cost attribution, request deadlines, metrics and tracing.
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

    def __init__(self, lane, window_s: float = 0.003, max_batch: int = 64):
        self.lane = lane
        self.window_s = window_s
        self.max_batch = max_batch
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
        done = threading.Event()
        slot: dict = {}
        self._queue.put((obj, ns_obj, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["outcome"]

    def _loop(self):
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
            try:
                outcomes = self.lane.mutate_objects(
                    [b[0] for b in batch],
                    namespaces=[b[1] for b in batch],
                    source=SOURCE_ORIGINAL)
                for (_o, _ns, done, slot), outcome in zip(batch, outcomes):
                    slot["outcome"] = outcome
                    done.set()
            except Exception as e:
                for _o, _ns, done, slot in batch:
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
                 device: str = "cuda", ingest: str = "dict"):
        from gatekeeper_tpu_torch.mutlane.lane import MutationLane

        self.system = mutation_system
        self.lane = lane or MutationLane(mutation_system, device=device,
                                         ingest=ingest)
        self.namespace_lookup = namespace_lookup or (lambda name: None)
        self.process_excluder = process_excluder
        self.batcher = batcher

    def handle(self, review_body: dict) -> MutationResponse:
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
        return MutationResponse(allowed=True, patch=outcome.patch,
                                uid=req.uid)
