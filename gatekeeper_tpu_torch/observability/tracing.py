"""Dependency-free span tracer: one timeline from AdmissionReview to
device dispatch (copy of ``gatekeeper_tpu/observability/tracing.py``).

The reference Gatekeeper wires OTel tracing through ``pkg/metrics`` so a
single admission request (or one audit sweep chunk) can be followed
across layers; here the same Dapper-style request-scoped span model is
rebuilt on the stdlib only, reusing the contextvar-propagation pattern
the resilience layer's :class:`Deadline` budget already uses:

- :class:`Span` — trace/span IDs, a parent link, wall-clock bounds,
  attributes, and point-in-time *events* (retries, breaker transitions,
  deadline misses and injected chaos faults all land here, so a
  ``--chaos`` run shows exactly where the fault hit).
- :class:`Tracer` — creates spans (IDs come from a seeded RNG, so a
  test seed replays the exact ID sequence), buffers the spans of each
  in-flight trace, and *tail-samples* finished traces into a bounded
  ring buffer: traces slower than ``slow_threshold_s`` are always kept,
  the rest keep with probability ``sample_rate``.  ``sample_rate=0``
  with no threshold is the "empty sampler" — the tracer runs the full
  span machinery but retains nothing, which the differential tests use
  to prove tracing is zero-cost to verdicts.
- activation mirrors ``resilience/faults.py``: :func:`install` is the
  process-global switch (the ``--trace`` CLI flag — worker threads
  spawned before any contextvar was set still see it), and
  :func:`activate` is the scoped variant for tests.

With no tracer installed every entry point (:func:`span`,
:func:`add_event`, :func:`current_span`) is one contextvar read plus one
global read — nanoseconds, no locks, no behavior change.  Cross-thread
propagation (batcher lane, pipeline stage workers, the webhook deadline
helper thread) is explicit: capture :func:`current_span` on the
submitting thread, re-enter it with :func:`use_span` (or pass it as
``parent=``) on the worker.

The port's phase clock (:class:`phase`) times an audit phase once for
both its counter (the owner's ``perf`` dict) and its span, and keeps a
per-thread stack of the open phases; :class:`CollectorHook` charges each
garbage collection to the innermost one (``perf["gc/<phase>"]``) and
turns full collections into ``python.gc`` spans.  A span's
``start_mono`` is its start on the monotonic clock, which
``export.host_spans`` hands to a profiler's window anchor.

W3C trace-context interop: :func:`parse_traceparent` ingests an incoming
``traceparent`` header as a remote parent (the webhook HTTP path), and
:func:`format_traceparent` emits the current span's context on outbound
calls (external-data provider sends, apiserver requests).
"""

from __future__ import annotations

import contextvars
import gc
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Optional

TRACEPARENT_HEADER = "traceparent"

_UNSET = object()  # span(parent=...) sentinel: "use the ambient span"


class SpanContext:
    """A remote span reference (an ingested ``traceparent``): enough to
    parent a local span into the caller's trace without a local Span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    """One timed operation.  Mutate only from the thread(s) that own the
    operation; ``add_event``/``set_attribute`` are lock-free appends."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ts",
                 "duration_s", "attributes", "events", "status", "error",
                 "thread_id", "thread_name", "is_root", "_t0", "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], is_root: bool, tracer: "Tracer"):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.is_root = is_root
        self.start_ts = tracer._wall()
        self._t0 = tracer._clock()
        self.duration_s = 0.0
        self.attributes: dict = {}
        self.events: list = []
        self.status = "ok"
        self.error = ""
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self._tracer = tracer

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"ts": self._tracer._wall(), "name": name,
                            "attrs": attrs})

    def set_status(self, status: str, error: str = "") -> None:
        self.status = status
        self.error = error

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.start_ts,
            # the tracer's monotonic clock (perf_counter unless injected):
            # the clock a profiler's window is anchored to
            "start_mono": self._t0,
            "duration_s": self.duration_s,
            "thread_id": self.thread_id,
            "thread_name": self.thread_name,
            "attributes": dict(self.attributes),
            "events": list(self.events),
            "status": self.status,
            **({"error": self.error} if self.error else {}),
        }


class _NoopSpan:
    """Returned by :func:`span` when no tracer is installed: every method
    is a no-op, so call sites never branch on tracing being enabled."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    name = ""

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def set_status(self, status: str, error: str = "") -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + per-trace buffer + tail-sampled ring buffer.

    ``seed`` drives BOTH the ID generator and the sampling RNG, so a
    seeded run replays the same trace/span IDs and the same keep/drop
    decisions (the chaos-differential discipline applied to tracing).
    ``seed=None`` draws from OS entropy (production default)."""

    def __init__(self, seed: Optional[int] = 0,
                 ring_capacity: int = 256,
                 slow_threshold_s: Optional[float] = None,
                 sample_rate: float = 1.0,
                 max_spans_per_trace: int = 4096,
                 clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time,
                 metrics=None):
        self._rng = random.Random(seed)
        self._clock = clock
        self._wall = wall
        self.slow_threshold_s = slow_threshold_s
        self.sample_rate = float(sample_rate)
        self.max_spans_per_trace = max_spans_per_trace
        self.metrics = metrics
        self._lock = threading.Lock()
        # trace_id -> list of finished span dicts, awaiting the root's end
        self._pending: dict = {}
        self._ring: deque = deque(maxlen=max(1, ring_capacity))
        self.kept = 0
        self.sampled_out = 0
        self.span_count = 0  # spans STARTED (includes sampled-out traces)

    # --- IDs --------------------------------------------------------------
    def _gen_trace_id(self) -> str:
        return f"{self._rng.getrandbits(128):032x}"

    def _gen_span_id(self) -> str:
        return f"{self._rng.getrandbits(64):016x}"

    # --- span lifecycle ---------------------------------------------------
    def start_span(self, name: str, parent=None,
                   attributes: Optional[dict] = None,
                   t0: Optional[float] = None,
                   start_ts: Optional[float] = None,
                   thread: Optional[tuple] = None) -> Span:
        """``parent`` may be a local :class:`Span`, a remote
        :class:`SpanContext` (ingested traceparent), or None (new trace).
        A span with no *local* parent is its trace's local root — its end
        finalizes the trace through the tail sampler.  ``t0`` is a start
        already read on the monotonic clock (a :class:`phase`'s),
        ``start_ts`` the same start on the wall clock and ``thread`` the
        ``(id, name)`` of the thread that ran it, for a span opened after
        the fact (a ``python.gc`` span)."""
        with self._lock:
            if parent is None:
                trace_id = self._gen_trace_id()
                parent_id = None
            else:
                trace_id = parent.trace_id
                parent_id = parent.span_id
            span_id = self._gen_span_id()
            self.span_count += 1
        is_root = parent is None or isinstance(parent, SpanContext)
        s = Span(name, trace_id, span_id, parent_id, is_root, self)
        if t0 is not None:
            s._t0 = t0
        if start_ts is not None:
            s.start_ts = start_ts
        if thread is not None:
            s.thread_id, s.thread_name = thread
        if attributes:
            s.attributes.update(attributes)
        return s

    def end_span(self, s: Span, t1: Optional[float] = None) -> None:
        """End ``s`` now, or at ``t1`` read on the monotonic clock."""
        s.duration_s = (self._clock() if t1 is None else t1) - s._t0
        with self._lock:
            buf = self._pending.setdefault(s.trace_id, [])
            if len(buf) < self.max_spans_per_trace:
                buf.append(s.to_dict())
            if s.is_root:
                spans = self._pending.pop(s.trace_id, [])
                self._finalize(s, spans)
            elif len(self._pending) > 4096:
                # straggler bound: a span ending after its root finalized
                # (a batch-thread tail racing the request thread) re-seeds
                # _pending with an entry no root will ever drain — prune
                # oldest-first so a long-running server can't grow it
                self._pending.pop(next(iter(self._pending)))

    def _finalize(self, root: Span, spans: list) -> None:
        """Tail-sampling decision at trace end (call under self._lock):
        slow traces always keep; the rest keep at ``sample_rate``."""
        if self.slow_threshold_s is not None \
                and root.duration_s >= self.slow_threshold_s:
            keep = True  # slow traces always keep (the tail matters most)
        elif self.sample_rate >= 1.0:
            keep = True
        elif self.sample_rate <= 0.0:
            keep = False
        else:
            keep = self._rng.random() < self.sample_rate
        if not keep:
            self.sampled_out += 1
            self._count("trace_traces_sampled_out_count")
            return
        self.kept += 1
        self._count("trace_traces_kept_count")
        self._ring.append({
            "trace_id": root.trace_id,
            "root": root.name,
            "start_ts": root.start_ts,
            "duration_s": root.duration_s,
            "n_spans": len(spans),
            "spans": spans,
        })

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.inc_counter(name)
            except Exception:
                pass  # tracing must never add a failure mode of its own

    # --- introspection ----------------------------------------------------
    def traces(self) -> list:
        """Snapshot of the kept-trace ring buffer (oldest first)."""
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict:
        """The ``/debug/traces`` payload."""
        with self._lock:
            return {
                "kept": self.kept,
                "sampled_out": self.sampled_out,
                "spans_started": self.span_count,
                "ring_capacity": self._ring.maxlen,
                "slow_threshold_s": self.slow_threshold_s,
                "sample_rate": self.sample_rate,
                "traces": list(self._ring),
            }


# --- activation (the faults.py pattern) ----------------------------------

_ctx_tracer: contextvars.ContextVar = contextvars.ContextVar(
    "gatekeeper_tracer", default=None)
_global_tracer: list = [None]  # process-scoped (--trace; worker threads)
_ctx_span: contextvars.ContextVar = contextvars.ContextVar(
    "gatekeeper_span", default=None)


def install(tracer: Optional[Tracer]) -> None:
    """Process-global activation (the ``--trace`` flag): every thread
    sees the tracer, including workers spawned before the call."""
    _global_tracer[0] = tracer


def uninstall() -> None:
    _global_tracer[0] = None


def active_tracer() -> Optional[Tracer]:
    t = _ctx_tracer.get()
    if t is None:
        t = _global_tracer[0]
    return t


@contextmanager
def activate(tracer: Tracer, process: bool = True):
    """Scoped activation for tests: contextvar (same thread) and — by
    default — the process global, so spans on worker threads (batcher,
    pipeline stages) reach the same tracer.  Restores both on exit."""
    token = _ctx_tracer.set(tracer)
    prev = _global_tracer[0]
    if process:
        _global_tracer[0] = tracer
    try:
        yield tracer
    finally:
        _ctx_tracer.reset(token)
        if process:
            _global_tracer[0] = prev


# --- the hot-path entry points -------------------------------------------

def current_span() -> Optional[Span]:
    return _ctx_span.get()


def add_event(name: str, **attrs: Any) -> None:
    """Attach an event to the ambient span (no-op when none): the seam
    the resilience layer uses — retries, breaker transitions, deadline
    misses and injected faults become span events through this call."""
    s = _ctx_span.get()
    if s is not None:
        s.add_event(name, **attrs)


def set_attribute(key: str, value: Any) -> None:
    s = _ctx_span.get()
    if s is not None:
        s.set_attribute(key, value)


@contextmanager
def span(name: str, parent=_UNSET, **attrs: Any):
    """Open a span as a context manager.  With no tracer installed this
    yields the shared no-op span (one contextvar read + one global read).
    ``parent`` defaults to the ambient span; pass an explicit Span /
    SpanContext for cross-thread or remote parenting, or None to force a
    new root."""
    tracer = _ctx_tracer.get()
    if tracer is None:
        tracer = _global_tracer[0]
        if tracer is None:
            yield NOOP_SPAN
            return
    p = _ctx_span.get() if parent is _UNSET else parent
    s = tracer.start_span(name, parent=p, attributes=attrs)
    token = _ctx_span.set(s)
    try:
        yield s
    except BaseException as e:  # noqa: BLE001 — annotate and re-raise
        s.set_status("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        _ctx_span.reset(token)
        tracer.end_span(s)


@contextmanager
def use_span(s: Optional[Span]):
    """Re-enter an existing span on another thread (the cross-thread
    propagation seam: batcher entries, pipeline workers, the webhook's
    deadline helper thread).  The span is NOT ended on exit — its owner
    ends it."""
    token = _ctx_span.set(s)
    try:
        yield s
    finally:
        _ctx_span.reset(token)


def enabled() -> bool:
    return _ctx_tracer.get() is not None or _global_tracer[0] is not None


# --- the phase clock -------------------------------------------------------

_phase_stacks = threading.local()

# The spans only the port opens, beyond the JAX package's names: its phase
# clock's (``phase(add, key, span)``; the counter key in brackets) and the
# collector hook's.
PORT_ONLY_SPANS = frozenset({
    "audit.list_route",    # a chunk's listing and routing [list_route]
    "audit.fold_render",   # a chunk's fold and renders [fold_render]
    "audit.status_write",  # statuses, metrics, export [status_write]
    "snapshot.ready",      # constraint adoption, pump, rows [snapshot_ready]
    "snapshot.rows",       # a chunk's row objects, residency [snapshot_rows]
    "snapshot.collect",    # totals and kept off the store [snapshot_collect]
    "device.masks",        # a dispatch's tables and masks [masks]
    "device.upload",       # a dispatch's uploads [upload]
    "device.launch",       # a dispatch's grid and fold enqueue [dispatch]
    "device.collect",      # a chunk's fetch and unpack [collect]
    "audit.gc_settle",     # a settle's collection and freeze [gc_settle]
    "python.gc",           # a full garbage collection (CollectorHook)
})


def open_phases() -> list:
    """The keys of the phases open on this thread, innermost last."""
    stack = getattr(_phase_stacks, "keys", None)
    if stack is None:
        stack = _phase_stacks.keys = []
    return stack


class phase:
    """One timing of one phase, for its counter and its span alike::

        with tracing.phase(self._perf_add, "upload", "device.upload") as ph:
            ...
        ph.dt  # the seconds just added under "upload"

    Reads one ``time.perf_counter()`` pair and adds the seconds through
    ``add(key, dt)`` (the owner's counter, under the owner's lock), also
    when the body raises.  While open, ``key`` is on this thread's phase
    stack (:func:`open_phases`), which the collector hook reads.  With a
    tracer active and a ``span`` name, it opens that span (``attrs`` its
    attributes, ``ph.span`` the span) with exactly the counter's two
    readings as its start and end, so the span lies on the monotonic
    clock the counter reads.  Without a tracer it costs one contextvar
    read, one global read and the stack's push and pop.

    It opens no range of the CUDA profiler's: the profiler mirrors such
    ranges onto the device's timeline, where they would read as device
    work."""

    __slots__ = ("_add", "key", "_name", "_attrs", "span", "dt", "_t0",
                 "_stack", "_tracer", "_token")

    def __init__(self, add: Callable[[str, float], None], key: str,
                 span: Optional[str] = None, **attrs: Any):
        self._add = add
        self.key = key
        self._name = span
        self._attrs = attrs
        self.span = NOOP_SPAN
        self.dt = 0.0
        self._tracer = None

    def __enter__(self) -> "phase":
        self._stack = open_phases()
        self._stack.append(self.key)
        if self._name is not None:
            tracer = _ctx_tracer.get()
            if tracer is None:
                tracer = _global_tracer[0]
            self._tracer = tracer
        self._t0 = time.perf_counter()
        if self._tracer is not None:
            s = self._tracer.start_span(self._name, parent=_ctx_span.get(),
                                        attributes=self._attrs, t0=self._t0)
            self.span = s
            self._token = _ctx_span.set(s)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self.dt = t1 - self._t0
        self._add(self.key, self.dt)
        self._stack.pop()
        if self._tracer is not None:
            s = self.span
            if exc_type is not None:
                s.set_status("error", f"{exc_type.__name__}: {exc}")
            _ctx_span.reset(self._token)
            self._tracer.end_span(s, t1)
        return False


class CollectorHook:
    """The cyclic garbage collector's seconds by phase, while entered.

    One ``gc.callbacks`` hook: each collection's seconds add through
    ``add`` under ``"gc"`` and under ``"gc/<innermost open phase>"`` of
    the thread that ran it (``"gc/none"`` outside every phase); a full
    (generation 2) collection also adds 1 under ``"gc_full"`` and its
    seconds under ``"gc_full_s"``.  With a tracer active, a full
    collection inside an open span also becomes a ``python.gc`` span under
    it; younger generations only count.  Entering again while entered only
    deepens the hold; the hook leaves ``gc.callbacks`` when the outermost
    hold exits, and opens the ``python.gc`` spans then (a collection can
    interrupt code that holds the tracer's lock), so hold it inside the
    span that roots the pass.
    Each such span keeps the start (monotonic and wall) and the thread of
    its collection, so a trace draws it where it ran.
    ``seconds`` sums the collections since the outermost hold began."""

    def __init__(self, add: Callable[[str, float], None]):
        self._add = add
        self._depth = 0
        self._t0 = 0.0
        self._tracer = None
        self._wall0 = 0.0
        self._full: list = []
        self.seconds = 0.0

    def __call__(self, stage: str, info: dict) -> None:
        if stage == "start":
            self._tracer = None
            if info.get("generation") == 2 and \
                    _ctx_span.get() is not None:
                tracer = _ctx_tracer.get()
                if tracer is None:
                    tracer = _global_tracer[0]
                if tracer is not None:
                    # the span opens later: keep where and when it ran
                    self._tracer = tracer
                    self._wall0 = tracer._wall()
            self._t0 = time.perf_counter()
            return
        t1 = time.perf_counter()
        dt = t1 - self._t0
        self.seconds += dt
        stack = open_phases()
        self._add("gc", dt)
        self._add("gc/" + (stack[-1] if stack else "none"), dt)
        if info.get("generation") == 2:
            self._add("gc_full", 1.0)
            self._add("gc_full_s", dt)
        tracer = self._tracer
        if tracer is None:
            return
        self._tracer = None
        t = threading.current_thread()
        self._full.append((tracer, _ctx_span.get(), self._t0, t1,
                           self._wall0, (t.ident or 0, t.name), {
            "generation": 2, "collected": info.get("collected", 0),
            "phase": stack[-1] if stack else "none"}))

    def __enter__(self) -> "CollectorHook":
        if self._depth == 0:
            self.seconds = 0.0
            gc.callbacks.append(self)
        self._depth += 1
        return self

    def __exit__(self, *exc) -> bool:
        self._depth -= 1
        if self._depth == 0:
            gc.callbacks.remove(self)
            full, self._full = self._full, []
            for tracer, parent, t0, t1, wall0, thread, attrs in full:
                s = tracer.start_span("python.gc", parent=parent,
                                      attributes=attrs, t0=t0,
                                      start_ts=wall0, thread=thread)
                tracer.end_span(s, t1)
        return False


# --- W3C trace-context ----------------------------------------------------

def format_traceparent(s: Optional[Span] = None) -> Optional[str]:
    """``00-<trace_id>-<span_id>-01`` for the given (default: ambient)
    span; None when there is nothing to propagate."""
    if s is None:
        s = _ctx_span.get()
    if s is None or not getattr(s, "trace_id", ""):
        return None
    return f"00-{s.trace_id}-{s.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Validate + parse an incoming ``traceparent`` header into a remote
    :class:`SpanContext`; malformed headers return None (the request
    simply starts a fresh trace — never an error)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())
