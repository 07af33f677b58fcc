"""Staged host-pipeline executor: bounded queues, backpressure, stats.

The audit sweep's host phases (flatten / wire-pack / fold-render) dominate
wall-clock while the device is idle most of a pass.
This module is the generic fix: a linear dataflow of stages connected by
BOUNDED channels, each stage on its own thread(s), so chunk K's flatten
(GIL-released C columnizer) overlaps chunk K-1's collect/fold and the
device/wire waits hide behind host work — the tf.data-style overlapped
prefetch pattern of training-stack input pipelines, applied to a policy
sweep.

Design constraints, in order:

- **bit-identical output**: stage emission preserves source order even for
  multi-worker stages (a per-stage reorder buffer keyed by the input
  sequence number), so a pipelined sweep folds chunks in exactly the
  serial schedule's order.
- **backpressure, no deadlock**: every channel is bounded; a slow stage
  stalls its producers (at O(queue_cap) buffered chunks of host memory)
  instead of queueing unboundedly.  A stage failure aborts the whole
  pipeline — every blocked put/get wakes and unwinds, the first error
  re-raises on the caller thread.
- **instrumentation**: per-stage busy/wait/stall seconds, items, input
  queue depth high-water marks, and occupancy (busy / pipeline wall) —
  enough for a bench artifact to PROVE the overlap (sum of stage busy
  times exceeding the region's wall time).

One-core degradation (a collector thread doubled flatten wall-time on
a one-core host — two GIL-hungry threads thrash):
callers consult :func:`effective_cpu_count` and keep the serial schedule
when the host cannot actually run stages in parallel.

Copy of ``gatekeeper_tpu/pipeline/executor.py`` with its chaos fault
points (``pipeline.stage.<name>`` before each stage call) and its
``pipeline.stage.<name>`` spans (one per chunk and stage); a stage restart
is logged through ``utils/logging.log_event``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional, Sequence

from gatekeeper_tpu_torch.observability import tracing
from gatekeeper_tpu_torch.resilience.faults import fault_point
from gatekeeper_tpu_torch.utils.logging import log_event


def effective_cpu_count() -> int:
    """Cores this process may actually use: the scheduling affinity mask
    when the platform exposes it (containers with cpuset limits report
    the limit, not the node size), else ``os.cpu_count()``."""
    getaff = getattr(os, "sched_getaffinity", None)
    if getaff is not None:
        try:
            return len(getaff(0)) or 1
        except OSError:
            pass
    return os.cpu_count() or 1


def _log_stage_restart(stage: str, attempt: int, exc: BaseException) -> None:
    log_event("warning", "pipeline stage worker restarted",
              event_type="pipeline_worker_restart",
              stage=stage, attempt=attempt, error=str(exc))


class PipelineError(Exception):
    """A stage raised; carries the stage name, original error as __cause__."""

    def __init__(self, stage: str, cause: BaseException):
        super().__init__(f"pipeline stage '{stage}' failed: {cause!r}")
        self.stage = stage


class _Aborted(Exception):
    """Internal: a channel operation was interrupted by pipeline abort."""


_DONE = object()  # end-of-stream sentinel (bypasses channel capacity)
_SKIP = object()  # ordered-emit placeholder for dropped (None) results


class _Chan:
    """Bounded FIFO channel with depth high-water tracking and abort-aware
    blocking.  ``get`` also hands out a monotonically increasing arrival
    index — assigned atomically with the pop — which multi-worker stages
    use to restore input order on emission."""

    def __init__(self, cap: int, abort: threading.Event):
        self._q: deque = deque()
        self._cap = max(1, cap)
        self._abort = abort
        self._cond = threading.Condition()
        self._next_idx = 0
        self.highwater = 0

    def put(self, item) -> None:
        with self._cond:
            # the sentinel bypasses capacity: shutdown must never block
            while item is not _DONE and len(self._q) >= self._cap:
                if self._abort.is_set():
                    raise _Aborted()
                self._cond.wait(0.05)
            if self._abort.is_set():
                raise _Aborted()
            self._q.append(item)
            # the sentinel rides above capacity; don't let it inflate the
            # reported depth high-water
            if item is not _DONE and len(self._q) > self.highwater:
                self.highwater = len(self._q)
            self._cond.notify_all()

    def get(self) -> tuple:
        """-> (arrival_idx, item); idx is -1 for the _DONE sentinel."""
        with self._cond:
            while not self._q:
                if self._abort.is_set():
                    raise _Aborted()
                self._cond.wait(0.05)
            item = self._q.popleft()
            if item is _DONE:
                return -1, item
            idx = self._next_idx
            self._next_idx += 1
            self._cond.notify_all()
            return idx, item


@dataclass
class StageStats:
    """Per-stage timings (seconds) + queue telemetry for one pipeline run."""

    name: str
    workers: int = 1
    items: int = 0
    busy_s: float = 0.0   # inside fn (summed across workers)
    wait_s: float = 0.0   # blocked on upstream (input get)
    stall_s: float = 0.0  # blocked on downstream (output put, backpressure)
    queue_highwater: int = 0  # input channel depth high-water
    retries: int = 0  # crashed-worker restarts that re-ran an item

    def occupancy(self, wall_s: float) -> float:
        """Fraction of the pipeline wall this stage spent doing work
        (per worker-slot; 1.0 = the stage was the bottleneck)."""
        if wall_s <= 0:
            return 0.0
        return min(1.0, self.busy_s / (wall_s * max(1, self.workers)))


@dataclass
class PipelineRun:
    """Result of StagedPipeline.run: stats + wall clock."""

    wall_s: float = 0.0
    source_items: int = 0
    source_stall_s: float = 0.0  # source blocked on stage-1 backpressure
    stages: list = field(default_factory=list)  # [StageStats]

    def stage(self, name: str) -> Optional[StageStats]:
        for s in self.stages:
            if s.name == name:
                return s
        return None

    def stage_busy_sum(self) -> float:
        """Serial-equivalent host+device seconds: if this exceeds wall_s,
        the stages measurably overlapped."""
        return sum(s.busy_s for s in self.stages)

    def summary(self) -> dict:
        """JSON-ready per-stage breakdown (bench artifacts, metrics)."""
        return {
            "wall_s": round(self.wall_s, 3),
            "stage_busy_sum_s": round(self.stage_busy_sum(), 3),
            "overlap_ratio": round(
                self.stage_busy_sum() / self.wall_s, 3
            ) if self.wall_s > 0 else 0.0,
            "source_items": self.source_items,
            "source_stall_s": round(self.source_stall_s, 3),
            "stages": {
                s.name: {
                    "items": s.items,
                    "busy_s": round(s.busy_s, 3),
                    "wait_s": round(s.wait_s, 3),
                    "stall_s": round(s.stall_s, 3),
                    "occupancy": round(s.occupancy(self.wall_s), 3),
                    "queue_highwater": s.queue_highwater,
                    "workers": s.workers,
                    "retries": s.retries,
                }
                for s in self.stages
            },
        }


class Stage:
    """One pipeline stage: ``fn(item) -> item | None`` (None drops the
    item).  ``workers`` > 1 fans the stage over a thread pool; emission
    to the next stage is ALWAYS restored to input order, so downstream
    stages (and the final fold) observe the serial schedule's sequence.
    ``queue_cap`` bounds this stage's INPUT queue — the backpressure knob
    limiting how far its producer may run ahead."""

    def __init__(self, name: str, fn: Callable[[Any], Any],
                 workers: int = 1, queue_cap: int = 2,
                 max_retries: int = 0):
        if workers < 1:
            raise ValueError(f"stage {name}: workers must be >= 1")
        self.name = name
        self.fn = fn
        self.workers = workers
        self.queue_cap = queue_cap
        # crashed-worker policy (resilience layer): a worker whose fn
        # raises restarts and re-runs THE SAME item up to max_retries
        # times before the failure aborts the pipeline — no item is ever
        # silently dropped, and the chunk sequence downstream stages see
        # is unchanged (the reorder buffer keys on arrival index)
        self.max_retries = max_retries


class _OrderedEmit:
    """Reorder buffer at a stage's exit: results emit downstream in input
    arrival order regardless of worker completion order.  Bounded by the
    stage's worker count (a worker blocks in emit until its predecessors
    have emitted — via the downstream channel put, not a spin)."""

    def __init__(self, out: Optional[_Chan]):
        self._out = out
        self._lock = threading.Lock()       # guards _buf/_next
        self._emit_lock = threading.Lock()  # serializes downstream puts
        self._buf: dict = {}
        self._next = 0

    def emit(self, idx: int, item) -> float:
        """Returns seconds spent blocked on the downstream put."""
        stall = 0.0
        with self._lock:
            self._buf[idx] = item
        # drain under a dedicated emit mutex: claims advance _next one item
        # at a time IN ORDER and the put happens before the next claim, so
        # two workers finishing out of order can never interleave their
        # downstream puts.  Parking (above) stays lock-cheap — a sibling
        # blocked here never prevents others from parking results.
        with self._emit_lock:
            while True:
                with self._lock:
                    if self._next not in self._buf:
                        break
                    it = self._buf.pop(self._next)
                    self._next += 1
                if it is not _SKIP and self._out is not None:
                    t0 = time.perf_counter()
                    self._out.put(it)
                    stall += time.perf_counter() - t0
        return stall


class StagedPipeline:
    """A linear chain of stages fed from an iterable source.

    ``run(source)`` drives the source on the CALLING thread (listing
    stays where the caller's generator state lives), spawns stage
    workers, blocks until the last stage drains, and returns a
    :class:`PipelineRun`.  Any stage exception (or source exception)
    aborts every thread and re-raises."""

    def __init__(self, stages: Sequence[Stage], source_cap: int = 2):
        if not stages:
            raise ValueError("pipeline needs at least one stage")
        self.stages = list(stages)
        self.source_cap = source_cap

    def run(self, source: Iterable) -> PipelineRun:
        abort = threading.Event()
        run = PipelineRun()
        stats = [StageStats(name=s.name, workers=s.workers)
                 for s in self.stages]
        run.stages = stats
        chans = [_Chan(self.stages[0].queue_cap or self.source_cap, abort)]
        for s in self.stages[1:]:
            chans.append(_Chan(s.queue_cap, abort))
        chans.append(None)  # last stage has no output
        emits = [_OrderedEmit(chans[i + 1]) for i in range(len(self.stages))]

        first_error: list = []  # [(stage_name, exc)]
        err_lock = threading.Lock()

        def fail(stage_name: str, exc: BaseException) -> None:
            with err_lock:
                if not first_error:
                    first_error.append((stage_name, exc))
            abort.set()

        # per-stage countdown: the LAST worker to exit propagates _DONE
        remaining = [s.workers for s in self.stages]
        rem_lock = threading.Lock()

        # stage workers run on threads of their own, so the caller's
        # ambient span (the audit sweep's root) is captured here and passed
        # explicitly; each stage span carries its chunk index
        trace_parent = tracing.current_span()

        def worker(si: int, stage: Stage) -> None:
            st = stats[si]
            in_ch, out_ch = chans[si], chans[si + 1]
            try:
                while True:
                    t0 = time.perf_counter()
                    idx, item = in_ch.get()
                    wait = time.perf_counter() - t0
                    if item is _DONE:
                        in_ch.put(_DONE)  # release sibling workers
                        break
                    t0 = time.perf_counter()
                    attempt = 0
                    with tracing.span(f"pipeline.stage.{stage.name}",
                                      parent=trace_parent, chunk=idx) as sp:
                        while True:
                            try:
                                fault_point(f"pipeline.stage.{stage.name}")
                                out = stage.fn(item)
                                break
                            except _Aborted:
                                raise
                            except BaseException as e:  # noqa: BLE001
                                if attempt >= stage.max_retries or \
                                        abort.is_set():
                                    fail(stage.name, e)
                                    return
                                attempt += 1
                                with st_locks[si]:
                                    st.retries += 1
                                sp.add_event("stage_retry",
                                             attempt=attempt, error=str(e))
                                _log_stage_restart(stage.name, attempt, e)
                    busy = time.perf_counter() - t0
                    stall = emits[si].emit(
                        idx, _SKIP if out is None else out)
                    with st_locks[si]:
                        st.items += 1
                        st.busy_s += busy
                        st.wait_s += wait
                        st.stall_s += stall
            except _Aborted:
                return
            finally:
                last = False
                with rem_lock:
                    remaining[si] -= 1
                    last = remaining[si] == 0
                if last and out_ch is not None and not abort.is_set():
                    try:
                        out_ch.put(_DONE)
                    except _Aborted:
                        pass

        st_locks = [threading.Lock() for _ in self.stages]
        threads = []
        for si, stage in enumerate(self.stages):
            for w in range(stage.workers):
                t = threading.Thread(
                    target=worker, args=(si, stage), daemon=True,
                    name=f"pipe-{stage.name}-{w}")
                t.start()
                threads.append(t)

        t_start = time.perf_counter()
        try:
            for item in source:
                t0 = time.perf_counter()
                chans[0].put(item)
                run.source_stall_s += time.perf_counter() - t0
                run.source_items += 1
            chans[0].put(_DONE)
        except _Aborted:
            pass
        except BaseException as e:  # noqa: BLE001 — source failed
            fail("<source>", e)
        # wait for drain (or abort): the last stage's worker exit is the
        # completion signal; on abort, _Aborted unwinds every thread
        for t in threads:
            while t.is_alive():
                t.join(0.1)
                if abort.is_set():
                    t.join(5.0)
                    break
        run.wall_s = time.perf_counter() - t_start
        for si, ch in enumerate(chans[:-1]):
            stats[si].queue_highwater = ch.highwater
        if first_error:
            stage_name, exc = first_error[0]
            raise PipelineError(stage_name, exc) from exc
        return run
