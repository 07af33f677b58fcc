"""Reading one profiled sub-window of a traced run.

``torch.profiler`` inflates the host's time, so a traced run reads its host
counters from its unprofiled window and profiles one steady sub-window after
it: one whole sweep.  From that sub-window come
the device's busy time (the union of its kernel, copy and set intervals),
the idle share, the kernels' device time by name, and the idle gaps by the
harness span the host was in.
"""

from __future__ import annotations

import collections
import time

WINDOW_LABEL = "bench.window"
FOLD_KERNEL = "fold_rows"  # both fold kernels: fold_rows<HAS_MASK, VEC>

# H100 SXM, NVIDIA's data sheet: HBM3 bandwidth and the dense int8 rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def fold_bound(c: int, n: int, k: int, fused: bool) -> tuple:
    """(bound_ms, bound_by, bytes): the least time of the card for one
    fold: each input byte read once and each output byte written once over
    the HBM rate, against one AND, one compare and one count per input cell
    at the int8 peak.  Copied from ``chip_smoke.py`` ``_bound`` at commit
    df605b0."""
    out = c * k * 4 + c * k + c * 4 + (c * 4 if fused else 0)
    nbytes = (2 if fused else 1) * c * n + out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * c * n / INT8_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes
    return ops_ms, "operations", nbytes


def wrap(obj, attr: str, name: str, acc: dict = None, spans: list = None):
    """Put a harness span around ``obj.attr``: with ``acc``, its wall time
    and calls add up under ``name`` and ``name#calls``; with ``spans``,
    each call appends (name, start, end) on the host's clock, from
    whatever thread makes it.  Returns an undo."""
    orig = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            t1 = time.perf_counter()
            if acc is not None:
                acc[name] = acc.get(name, 0.0) + t1 - t0
                acc[name + "#calls"] = acc.get(name + "#calls", 0) + 1
            if spans is not None:
                spans.append((name, t0, t1))

    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, orig)


def wrap_iter(obj, attr: str, name: str, spans: list):
    """A harness span around each step of the iterator that ``obj.attr``
    returns (the audit's chunk source: listing and routing a chunk)."""
    orig = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        it = iter(orig(*args, **kwargs))
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                spans.append((name, t0, time.perf_counter()))
            yield item

    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, orig)


def profiled(fn, spans: list) -> dict:
    """Run ``fn()`` under the profiler inside a ``bench.window`` range
    (synchronized at its end) and read the result with the harness spans
    that ``spans`` collects meanwhile: see :func:`analyse`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    del spans[:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    w0 = next(e.time_range.start for e in events
              if e.name == WINDOW_LABEL and not _is_device(e))
    # the host's clock onto the profiler's: both start the window together
    host = [(name, w0 + (a - t0) * 1e6, w0 + (b - t0) * 1e6)
            for name, a, b in spans]
    out = analyse(events, host)
    out["host_wall_s"] = wall
    return out


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def analyse(events, host_spans) -> dict:
    """{window_s, busy_s, idle_share, kernels: {name: [count, seconds]},
    fold_s, fold_events, other_kernel_s, gaps: {span: seconds}} of one
    profile's events, with the idle gaps named by ``host_spans``
    ([(name, start us, end us)] on the profiler's clock); ``busy_s`` is
    None where the profiler saw no device event."""
    window = None
    cpu_spans = [(a, b, n) for n, a, b in host_spans]
    device = []
    for e in events:
        tr = e.time_range
        if _is_device(e):
            # the window's record_function range is mirrored onto the
            # device's timeline as an annotation: no work ran there
            if e.name != WINDOW_LABEL:
                device.append((tr.start, tr.end, e.name))
        elif e.name == WINDOW_LABEL:
            window = (tr.start, tr.end)
    if window is None:
        raise RuntimeError("the profile holds no bench.window range")
    w0, w1 = window
    clipped = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                     if b > w0 and a < w1)
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    fold_s = other_s = 0.0
    fold_events = 0
    for a, b, n in clipped:
        kernels[n][0] += 1
        kernels[n][1] += (b - a) / 1e6
        if FOLD_KERNEL in n:
            fold_s += (b - a) / 1e6
            fold_events += 1
        elif not (n.startswith("Memcpy") or n.startswith("Memset")):
            other_s += (b - a) / 1e6
    busy = 0.0
    gaps: dict = collections.defaultdict(float)
    cur_a = cur_b = None
    prev_end = w0
    merged = []
    for a, b, _n in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                merged.append((cur_a, cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        merged.append((cur_a, cur_b))
    for a, b in merged:
        busy += (b - a) / 1e6
        if a > prev_end:
            gaps[_host_span(cpu_spans, prev_end, a)] += (a - prev_end) / 1e6
        prev_end = b
    if w1 > prev_end:
        gaps[_host_span(cpu_spans, prev_end, w1)] += (w1 - prev_end) / 1e6
    window_s = (w1 - w0) / 1e6
    return {"window_s": window_s,
            "busy_s": busy if clipped else None,
            "idle_share": (1.0 - busy / window_s) if clipped else None,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "fold_s": fold_s, "fold_events": fold_events,
            "other_kernel_s": other_s, "gaps": dict(gaps)}


def _host_span(cpu_spans, a: float, b: float) -> str:
    """The innermost harness span covering the middle of an idle gap."""
    mid = (a + b) / 2.0
    best = None
    for s0, s1, name in cpu_spans:
        if s0 <= mid <= s1 and (best is None or s1 - s0 < best[0]):
            best = (s1 - s0, name)
    return best[1] if best else "outside the harness spans"


def breakdown(prof: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten largest sums of idle time by host span."""
    ops = sorted(((n[:120], v[1]) for n, v in prof["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(prof["gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
