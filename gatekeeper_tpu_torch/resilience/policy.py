"""Unified resilience policies: deadline budgets, jittered retry,
circuit breakers, graceful-degradation hooks.

This replaces the stack's ad-hoc failure handling with one vocabulary
(the reference's failure semantics are explicit — webhook failurePolicy
fail-open/fail-closed, external-data failure policies with TTL-cache
fallback, watch 410 resync — so the failure *machinery* should be too):

- :class:`Deadline` — a wall-clock budget created per admission request
  and propagated by contextvar (:func:`deadline_scope` /
  :func:`current_deadline`), so every dependency call downstream of the
  webhook bounds its own waits by the request's remaining time.
- :class:`RetryPolicy` — seeded-jitter exponential backoff with a
  deadline cap; retries count into
  ``gatekeeper_resilience_retry_count{dependency}``.
- :class:`CircuitBreaker` — closed → open on a failure run, open →
  half-open after the reset timeout (bounded probes), half-open →
  closed on probe success / back to open on probe failure.  Transitions
  count into
  ``gatekeeper_resilience_breaker_transition_count{dependency,from,to}``
  and the current state is the
  ``gatekeeper_resilience_breaker_state{dependency}`` gauge
  (0 closed, 1 half-open, 2 open).

Everything takes an injectable ``clock`` so tests drive state machines
without real sleeps, and a ``seed`` so jitter sequences replay.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence


class DeadlineExceeded(Exception):
    """A deadline budget ran out (the webhook maps this onto its
    failurePolicy; dependencies surface it like any other failure)."""


class BreakerOpen(Exception):
    """A circuit breaker refused the call (dependency presumed down);
    callers degrade — stale cache, fallback lane, partial result."""

    def __init__(self, dependency: str, retry_after_s: float = 0.0):
        super().__init__(
            f"circuit breaker open for {dependency!r}"
            + (f" (retry in {retry_after_s:.1f}s)" if retry_after_s else ""))
        self.dependency = dependency
        self.retry_after_s = retry_after_s


# --- deadline budgets ----------------------------------------------------

class Deadline:
    """Wall-clock budget.  ``Deadline(0)`` (or None budget) is unlimited —
    every wait-bounding helper treats it as 'no deadline'."""

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.budget_s = budget_s if budget_s and budget_s > 0 else None
        self._t0 = clock()

    def remaining(self) -> Optional[float]:
        """Seconds left (may be <= 0), or None when unlimited."""
        if self.budget_s is None:
            return None
        return self.budget_s - (self._clock() - self._t0)

    @property
    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def check(self, what: str = "") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"deadline budget {self.budget_s:.3f}s exhausted"
                + (f" in {what}" if what else ""))

    def bound(self, timeout_s: Optional[float]) -> Optional[float]:
        """Clamp a caller's timeout by the remaining budget (None in,
        None budget -> None out)."""
        r = self.remaining()
        if r is None:
            return timeout_s
        r = max(0.0, r)
        return r if timeout_s is None else min(timeout_s, r)


_ctx_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "gatekeeper_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return _ctx_deadline.get()


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Propagate a request's budget to same-thread dependency calls."""
    token = _ctx_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _ctx_deadline.reset(token)


# --- jittered exponential retry ------------------------------------------

class RetryPolicy:
    """Seeded full-jitter exponential backoff.

    ``backoff(attempt)`` for attempt k in [0, attempts-2] is
    ``uniform(base * mult^k * (1-jitter), base * mult^k)`` capped at
    ``cap_s`` — deterministic for a given seed (chaos runs replay)."""

    def __init__(self, attempts: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 metrics=None, dependency: str = ""):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.dependency = dependency
        self.metrics = metrics
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        hi = min(self.cap_s, self.base_s * (self.multiplier ** attempt))
        lo = hi * (1.0 - self.jitter)
        with self._lock:
            return self._rng.uniform(lo, hi)

    def call(self, fn: Callable, *args,
             retry_on: Sequence[type] = (Exception,),
             giveup: Optional[Callable[[BaseException], bool]] = None,
             deadline: Optional[Deadline] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kwargs):
        """Run ``fn`` with up to ``attempts`` tries.  ``giveup(exc)`` True
        means the failure is not transient (4xx, validation) — re-raise
        immediately.  A deadline (explicit or ambient via
        :func:`current_deadline`) bounds the whole loop: no retry sleep
        ever outlives the request budget."""
        if deadline is None:
            deadline = current_deadline()
        last: Optional[BaseException] = None
        for attempt in range(self.attempts):
            if deadline is not None and deadline.expired:
                try:
                    from gatekeeper_tpu_torch.observability import tracing

                    tracing.add_event(
                        "deadline_exceeded",
                        dependency=self.dependency or "unknown",
                        attempt=attempt)
                except Exception:
                    pass
                raise DeadlineExceeded(
                    f"retry budget for {self.dependency or 'call'} "
                    "outlived the deadline") from last
            try:
                return fn(*args, **kwargs)
            except tuple(retry_on) as e:  # noqa: PERF203
                last = e
                if giveup is not None and giveup(e):
                    raise
                if attempt == self.attempts - 1:
                    raise
                delay = self.backoff(attempt)
                if deadline is not None:
                    r = deadline.remaining()
                    if r is not None:
                        if r <= 0:
                            raise
                        delay = min(delay, r)
                self._count_retry(attempt, e)
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(delay)
        raise last  # unreachable (loop always returns or raises)

    def _count_retry(self, attempt: int, exc: BaseException) -> None:
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.RESILIENCE_RETRIES,
                {"dependency": self.dependency or "unknown"})
        try:
            from gatekeeper_tpu_torch.observability import tracing

            tracing.add_event("retry",
                              dependency=self.dependency or "unknown",
                              attempt=attempt + 1, error=str(exc))
        except Exception:
            pass
        try:
            from gatekeeper_tpu_torch.utils.logging import log_event

            log_event("warning", "retrying after transient failure",
                      event_type="resilience_retry",
                      dependency=self.dependency, attempt=attempt + 1,
                      error=str(exc))
        except Exception:
            pass


# --- circuit breaker ------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-dependency breaker with half-open probing.

    - CLOSED: calls flow; ``failure_threshold`` consecutive failures trip
      to OPEN.
    - OPEN: ``allow()`` is False until ``reset_timeout_s`` elapses, then
      the breaker moves to HALF_OPEN.
    - HALF_OPEN: at most ``half_open_max`` concurrent probes; a probe
      success closes the breaker, a probe failure re-opens it (fresh
      reset timer).
    """

    def __init__(self, dependency: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.dependency = dependency
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = max(1, half_open_max)
        self.metrics = metrics
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        self._set_gauge()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now?  In HALF_OPEN this *claims* a
        probe slot; callers must report the outcome via
        record_success/record_failure."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return True
            return False

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s
                       - (self._clock() - self._opened_at))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._transition(OPEN)

    def call(self, fn: Callable, *args, **kwargs):
        """Guarded call: raises :class:`BreakerOpen` without touching the
        dependency when the breaker refuses."""
        if not self.allow():
            raise BreakerOpen(self.dependency, self.retry_after_s())
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out

    # --- internals (call under self._lock) -------------------------------
    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._transition(HALF_OPEN)

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = self._clock()
        if new in (OPEN, CLOSED):
            self._probes = 0
        if new == CLOSED:
            self._failures = 0
        self._set_gauge()
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.RESILIENCE_BREAKER_TRANSITIONS,
                {"dependency": self.dependency, "from": old, "to": new})
        try:
            from gatekeeper_tpu_torch.observability import tracing

            tracing.add_event("breaker_transition",
                              dependency=self.dependency,
                              breaker_from=old, breaker_to=new)
        except Exception:
            pass
        try:
            from gatekeeper_tpu_torch.utils.logging import log_event

            log_event("warning", "circuit breaker transition",
                      event_type="breaker_transition",
                      dependency=self.dependency,
                      breaker_from=old, breaker_to=new)
        except Exception:
            pass
        if self.on_transition is not None:
            self.on_transition(old, new)

    def _set_gauge(self) -> None:
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.RESILIENCE_BREAKER_STATE,
                                   _STATE_GAUGE[self._state],
                                   {"dependency": self.dependency})
