"""Continuous shadow canary: candidate policy against live traffic.

Port of ``gatekeeper_tpu/replay/shadow.py`` (a copy; the candidate runtime
is ``replay/core.load_candidate``'s, built on the serving device).  The
webhook's ``ValidationHandler`` hands every served admission (and
its final response) to the active :class:`ShadowLane` — enqueue-only,
strictly off the response path.  A worker thread drains microbatches
and decides them against the CANDIDATE library through the same
``replay/core.py`` decide path the offline time machine uses; shadow
verdicts go to a shadow flight-recorder stream (endpoint ``shadow``,
never answered to the apiserver), divergences count into
``gatekeeper_shadow_divergence_count{kind}``, and the
``shadow-divergence-rate`` SLO objective turns the stream into a
promote/abort signal.  ``promote()`` applies the candidate docs to the
SERVING client — template upserts ride the existing generation-swap
machinery (background build, atomic swap), so promotion never blocks
an admission.

Safety invariants (pinned by tests/test_torch_shadow.py):
- the served response is final before ``submit`` is called; the lane
  can never alter, delay, or answer an admission;
- a full queue drops the OLDEST shadow item (freshest traffic is the
  canary signal) and counts the drop — it never blocks the webhook;
- every failure inside the lane is swallowed and counted.

Activation mirrors ``resilience/faults.py``: :func:`install`
process-global, :func:`activate` scoped for tests, :func:`active` the
hot-path read.
"""

from __future__ import annotations

import queue
import threading
from collections import Counter, deque
from contextlib import contextmanager
from typing import Optional

# Divergence-rate SLO objective (observability/slo.py shape): bad =
# divergence counter summed across {kind} labelsets (labels omitted =
# sum), total = shadowed decisions.  Registered with the engine when
# the shadow lane is configured; the lint scans this literal like
# DEFAULT_OBJECTIVES.
SHADOW_OBJECTIVE = {
    "name": "shadow-divergence-rate",
    "type": "ratio",
    "description": "at most 1% of shadowed admissions may diverge "
                   "between serving and candidate libraries",
    "bad_metric": "shadow_divergence_count",
    "total_metric": "shadow_decisions_count",
    "target": 0.99,
}


class ShadowLane:
    """One candidate library shadow-evaluating copies of live traffic.

    ``runtime`` is a ``replay.core.CandidateRuntime`` (the candidate
    client/driver/handler); ``serving_client`` + ``candidate_docs``
    are what :meth:`promote` applies on success."""

    def __init__(self, runtime, serving_client=None, candidate_docs=None,
                 recorder=None, metrics=None, max_queue: int = 1024,
                 max_batch: int = 64, max_message: int = 512,
                 poll_s: float = 0.05):
        self.runtime = runtime
        self.serving_client = serving_client
        self.candidate_docs = list(candidate_docs or [])
        self.recorder = recorder
        self.metrics = metrics
        self.max_batch = max(1, max_batch)
        self.max_message = max_message
        self.poll_s = poll_s
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, max_queue))
        self._recent: deque = deque(maxlen=32)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.submitted = 0
        self.evaluated = 0
        self.dropped = 0
        self.lane_errors = 0
        self.skipped = 0  # served shed/error/deadline: nothing to shadow
        self.divergences: Counter = Counter()
        self.decisions: Counter = Counter()
        self.state = "shadowing"  # shadowing | promoted | aborted

    # --- webhook side (hot path: enqueue only) --------------------------
    def submit(self, review_body: dict, resp) -> bool:
        """Called by the webhook AFTER the response is final.  Never
        blocks: a full queue evicts the oldest pending item."""
        if self.state != "shadowing":
            return False
        if getattr(resp, "allowed", False):
            served = "allow"
        elif getattr(resp, "code", 0) in (500, 504):
            # the serving library didn't decide (error/deadline);
            # comparing the candidate against it is noise, not signal
            self.skipped += 1
            return False
        else:
            served = "deny"
        item = (review_body.get("request") or {}, served,
                getattr(resp, "message", "") or "",
                getattr(resp, "uid", "") or "")
        while True:
            try:
                self._queue.put_nowait(item)
                break
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    self.dropped += 1
                    if self.metrics is not None:
                        from gatekeeper_tpu_torch.metrics import registry as M

                        self.metrics.inc_counter(M.SHADOW_DROPPED)
                except queue.Empty:
                    continue
        self.submitted += 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.SHADOW_QUEUE_DEPTH,
                                   self._queue.qsize())
        return True

    # --- worker ---------------------------------------------------------
    def start(self) -> "ShadowLane":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="shadow-lane",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._drain(block=True)
            if batch:
                self._flush(batch)
        # final drain so stop() observes every submitted item
        batch = self._drain(block=False)
        if batch:
            self._flush(batch)

    def _drain(self, block: bool) -> list:
        batch: list = []
        try:
            if block:
                batch.append(self._queue.get(timeout=self.poll_s))
            while len(batch) < self.max_batch:
                batch.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        return batch

    def _flush(self, batch: list) -> None:
        from gatekeeper_tpu_torch.observability.tracing import span

        try:
            from gatekeeper_tpu_torch.replay import core

            bodies = [{"request": req} for req, _s, _m, _u in batch]
            with span("replay.shadow_flush", batch_size=len(batch)):
                verdicts = core.evaluate_bodies(
                    self.runtime, bodies, max_message=self.max_message)
        except Exception:
            # candidate bugs must stay invisible to serving: count the
            # whole batch as lane errors and move on
            self.lane_errors += len(batch)
            return
        for (req, served, served_msg, uid), v in zip(batch, verdicts):
            try:
                self._compare(req, served, served_msg, uid, v)
            except Exception:
                self.lane_errors += 1

    def _compare(self, req: dict, served: str, served_msg: str,
                 uid: str, v: dict) -> None:
        self.evaluated += 1
        self.decisions[v["decision"]] += 1
        kind = ""
        if v["decision"] == "error":
            kind = "would_error"
        elif served == "allow" and v["decision"] == "deny":
            kind = "would_deny"
        elif served == "deny" and v["decision"] == "allow":
            kind = "would_allow"
        elif served == "deny" and v["decision"] == "deny" \
                and v["message"] != (served_msg or "")[:self.max_message]:
            kind = "message"
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.SHADOW_DECISIONS,
                                     {"decision": v["decision"]})
            if kind:
                self.metrics.inc_counter(M.SHADOW_DIVERGENCE,
                                         {"kind": kind})
        if kind:
            self.divergences[kind] += 1
            self._recent.append({
                "divergence": kind, "uid": uid,
                "kind": (req.get("kind") or {}).get("kind", ""),
                "namespace": req.get("namespace", "") or "",
                "served": served, "shadow": v["decision"],
            })
        if self.recorder is not None:
            self.recorder.record(
                "shadow", v["decision"], uid=uid,
                obj_kind=(req.get("kind") or {}).get("kind", ""),
                name=req.get("name", "") or "",
                namespace=req.get("namespace", "") or "",
                operation=req.get("operation", "") or "",
                message=v["message"],
                code=v["code"],
                served=served,
                divergence=kind,
            )

    # --- lifecycle ------------------------------------------------------
    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def drain(self, timeout: float = 5.0) -> None:
        """Block until every submitted item has been evaluated (tests /
        pre-promote checks; the serving path never calls this)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                done = self._queue.empty() and \
                    (self.evaluated + self.lane_errors >= self.submitted)
            if done:
                return
            _time.sleep(0.005)

    def promote(self) -> dict:
        """Apply the candidate docs to the SERVING client.  Template
        upserts go through ``Client.add_template``, which with a
        generation coordinator active means background build + atomic
        swap — the generation-swap ride.  The lane stops shadowing."""
        from gatekeeper_tpu_torch.gator import reader

        if self.serving_client is None:
            return {"state": self.state,
                    "error": "no serving client wired"}
        applied = {"templates": 0, "constraints": 0}
        errors: list = []
        for doc in self.candidate_docs:
            if reader.is_template(doc):
                try:
                    self.serving_client.add_template(doc)
                    applied["templates"] += 1
                except Exception as e:
                    errors.append(f"template: {e}")
        for doc in self.candidate_docs:
            if reader.is_constraint(doc):
                try:
                    self.serving_client.add_constraint(doc)
                    applied["constraints"] += 1
                except Exception as e:
                    errors.append(f"constraint: {e}")
        self.state = "promoted"
        self.stop()
        out = {"state": self.state, "applied": applied}
        if errors:
            out["errors"] = errors
        return out

    def abort(self, reason: str = "") -> dict:
        self.state = "aborted"
        self.abort_reason = reason
        self.stop()
        return {"state": self.state, "reason": reason}

    def bind_slo(self, engine) -> "ShadowLane":
        """Auto-abort on candidate SLO breach: a rising-edge breach of
        the shadow divergence objective aborts the canary — the call a
        human would make from the dashboard, taken at tick speed.
        Manual promote/abort via POST /debug/shadow stay authoritative;
        a lane already promoted (or aborted) is immune."""
        name = SHADOW_OBJECTIVE["name"]

        def _on_breach(objective, ev):
            if self.state != "shadowing":
                return
            self.abort(reason=f"slo auto-abort: {objective} "
                              f"sli={ev.get('sli', 0.0):.4f} "
                              f"tier={ev.get('breach_tier', '')}")
            try:
                from gatekeeper_tpu_torch.utils.logging import log_event

                log_event("warning", "shadow canary auto-aborted on "
                          "SLO breach", event_type="shadow_auto_abort",
                          objective=objective, sli=ev.get("sli", 0.0))
            except Exception:
                pass

        engine.on_breach(_on_breach, objective=name)
        return self

    def snapshot(self) -> dict:
        """The ``/debug/shadow`` payload."""
        return {
            "state": self.state,
            "submitted": self.submitted,
            "evaluated": self.evaluated,
            "dropped": self.dropped,
            "skipped": self.skipped,
            "lane_errors": self.lane_errors,
            "queue_depth": self._queue.qsize(),
            "decisions": dict(self.decisions),
            "divergences": dict(self.divergences),
            "divergence_rate": round(
                sum(self.divergences.values()) / self.evaluated, 6)
            if self.evaluated else 0.0,
            "recent_divergences": list(self._recent),
            "candidate_lowering": self.runtime.lowering_stats(),
        }


# --- activation (the faults.py pattern) -----------------------------------

_global: list = [None]


def install(lane: Optional[ShadowLane]) -> None:
    _global[0] = lane


def uninstall() -> None:
    _global[0] = None


def active() -> Optional[ShadowLane]:
    return _global[0]


@contextmanager
def activate(lane: ShadowLane):
    prev = _global[0]
    _global[0] = lane
    try:
        yield lane
    finally:
        _global[0] = prev
