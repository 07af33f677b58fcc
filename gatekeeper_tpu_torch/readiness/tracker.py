"""Readiness tracker: expectation-vs-observation gating.

Reference: pkg/readiness/ready_tracker.go — at boot, each tracked kind's
existing objects become *expectations*; controllers *observe* as they ingest;
``/readyz`` fails until every expectation is observed (or cancelled), so a
restarting pod takes no webhook traffic with a cold policy cache.

Two failure-isolation mechanisms mirror pkg/readiness/object_tracker.go:

* **TryCancel retry budget** (object_tracker.go:158–188 + the
  ``--readiness-retries`` flag, object_tracker.go:36): a retryable
  ingestion failure (template compile error, watch failure) calls
  ``try_cancel``; the expectation is only cancelled once the per-object
  retry budget is exhausted, so a transient failure that succeeds on a
  later reconcile does not permanently disregard the object.  Budget -1
  retries forever (the expectation is never cancelled this way).
  Unconditional ``cancel`` (reference CancelExpect) is for deletions.

* **allSatisfied circuit breaker** (object_tracker.go:65,275–345): the
  first time a tracker observes every expectation it latches satisfied,
  snapshots its stats, and frees the tracking sets — later expect/observe
  calls are no-ops and ``satisfied()`` is a lock-free constant.  A
  poisoned object arriving *after* readiness can therefore never flip a
  serving pod back to not-ready.
"""

from __future__ import annotations

import threading
from typing import Hashable


class ObjectTracker:
    def __init__(self, kind: str, retries: int = 0):
        self.kind = kind
        self.retries = retries  # try_cancel budget; -1 = retry forever
        self._expected: set = set()
        self._observed: set = set()
        self._cancelled: set = set()
        self._retries_left: dict = {}  # key -> remaining try_cancel budget
        self._populated = False
        self._all_satisfied = False  # latched circuit breaker
        self._final_stats: dict = {}
        self._lock = threading.Lock()

    def expect(self, key: Hashable) -> None:
        with self._lock:
            if self._all_satisfied:
                return
            if key not in self._cancelled:
                self._expected.add(key)

    def observe(self, key: Hashable) -> None:
        with self._lock:
            if self._all_satisfied:
                return
            self._observed.add(key)
            # a success resets the object's retry budget (the reference
            # deletes the objData entry on Observe)
            self._retries_left.pop(key, None)

    def cancel(self, key: Hashable) -> None:
        """Unconditionally cancel an expectation (reference CancelExpect:
        the object was deleted, it can never be observed)."""
        with self._lock:
            if self._all_satisfied:
                return
            self._cancelled.add(key)
            self._expected.discard(key)
            self._retries_left.pop(key, None)

    def try_cancel(self, key: Hashable) -> bool:
        """Budgeted cancel for *retryable* failures (reference
        TryCancelExpect, object_tracker.go:158–188): decrement the
        object's retry budget; cancel only when exhausted.  Returns True
        if the expectation was cancelled."""
        with self._lock:
            if self._all_satisfied:
                return False
            if self.retries < 0:
                return False  # -1: retry indefinitely
            left = self._retries_left.get(key, self.retries)
            if left > 0:
                self._retries_left[key] = left - 1
                return False
            self._cancelled.add(key)
            self._expected.discard(key)
            self._retries_left.pop(key, None)
            return True

    def prune(self, predicate) -> int:
        """Cancel every expectation matching ``predicate`` — the
        ExpectationsPruner: expectations for objects whose parent/watch
        went away must not wedge readiness (reference:
        pkg/readiness/pruner/pruner.go:28-58).  Returns pruned count."""
        with self._lock:
            if self._all_satisfied:
                return 0
            doomed = [k for k in self._expected if predicate(k)]
            for k in doomed:
                self._cancelled.add(k)
                self._expected.discard(k)
                self._retries_left.pop(k, None)
            return len(doomed)

    def expectations_done(self) -> None:
        with self._lock:
            self._populated = True

    def satisfied(self) -> bool:
        if self._all_satisfied:  # latched: lock-free fast path
            return True
        with self._lock:
            if self._all_satisfied:
                return True
            if not self._populated:
                return False
            if self._expected <= (self._observed | self._cancelled):
                # trip the breaker: snapshot stats, free tracking memory
                # (object_tracker.go:336–345)
                self._final_stats = self._stats_locked(satisfied=True)
                self._expected = set()
                self._observed = set()
                self._cancelled = set()
                self._retries_left = {}
                self._all_satisfied = True
                return True
            return False

    def _stats_locked(self, satisfied: bool) -> dict:
        return {
            "expected": len(self._expected),
            "observed": len(self._observed),
            "cancelled": len(self._cancelled),
            "retrying": len(self._retries_left),
            "populated": self._populated,
            "satisfied": satisfied,
        }

    def stats(self) -> dict:
        with self._lock:
            if self._all_satisfied:
                return dict(self._final_stats)
            return self._stats_locked(satisfied=False)


class Tracker:
    """Per-kind trackers + overall satisfaction (ready_tracker.go:63-128)."""

    KINDS = ("templates", "constraints", "config", "data", "mutators",
             "expansions", "providers")

    def __init__(self, retries: int = 0):
        self._trackers = {k: ObjectTracker(k, retries=retries)
                          for k in self.KINDS}

    def for_kind(self, kind: str) -> ObjectTracker:
        return self._trackers[kind]

    def expect(self, kind: str, key) -> None:
        self._trackers[kind].expect(key)

    def observe(self, kind: str, key) -> None:
        self._trackers[kind].observe(key)

    def cancel(self, kind: str, key) -> None:
        self._trackers[kind].cancel(key)

    def try_cancel(self, kind: str, key) -> bool:
        return self._trackers[kind].try_cancel(key)

    def populated(self, kind: str) -> None:
        self._trackers[kind].expectations_done()

    def prune(self, kind: str, predicate) -> int:
        return self._trackers[kind].prune(predicate)

    def all_populated(self) -> None:
        for t in self._trackers.values():
            t.expectations_done()

    def satisfied(self) -> bool:
        return all(t.satisfied() for t in self._trackers.values())

    def stats(self) -> dict:
        return {k: t.stats() for k, t in self._trackers.items()}
