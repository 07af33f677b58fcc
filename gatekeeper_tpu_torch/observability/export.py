"""Trace export: Chrome trace-event JSON (Perfetto-loadable) and the
top-spans-by-self-time summary.

The Chrome trace-event format is the lowest-common-denominator timeline
interchange: ``chrome://tracing`` and https://ui.perfetto.dev both load
``{"traceEvents": [...]}`` with complete events (``ph: "X"``, micro-
second ``ts``/``dur``) directly.  Spans become complete events laid out
per thread; span *events* (retries, breaker transitions, injected
faults, deadline misses) become instant events (``ph: "i"``) so a chaos
run's faults are visible as markers on the exact span they hit.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def chrome_trace_events(traces: list, pid: Optional[int] = None) -> list:
    """Flatten kept traces into a Chrome trace-event list."""
    pid = os.getpid() if pid is None else pid
    events: list = []
    thread_names: dict = {}
    for trace in traces:
        for sp in trace.get("spans", []):
            tid = sp.get("thread_id", 0)
            tname = sp.get("thread_name", "")
            if tname and tid not in thread_names:
                thread_names[tid] = tname
            args = dict(sp.get("attributes") or {})
            args["trace_id"] = sp.get("trace_id", "")
            args["span_id"] = sp.get("span_id", "")
            if sp.get("parent_id"):
                args["parent_id"] = sp["parent_id"]
            if sp.get("status") != "ok":
                args["status"] = sp.get("status")
                if sp.get("error"):
                    args["error"] = sp["error"]
            events.append({
                "ph": "X",
                "name": sp.get("name", ""),
                "cat": (sp.get("name", "") or "span").split(".")[0],
                "ts": round(sp.get("start_ts", 0.0) * 1e6, 3),
                "dur": round(max(0.0, sp.get("duration_s", 0.0)) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
            for ev in sp.get("events", []):
                events.append({
                    "ph": "i",
                    "s": "t",  # thread-scoped instant marker
                    "name": ev.get("name", ""),
                    "cat": "event",
                    "ts": round(ev.get("ts", 0.0) * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                    "args": dict(ev.get("attrs") or {}),
                })
    for tid, tname in sorted(thread_names.items()):
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": tname},
        })
    return events


def chrome_trace(traces: list) -> dict:
    return {
        "traceEvents": chrome_trace_events(traces),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "gatekeeper-tpu span tracer"},
    }


def write_chrome_trace(path: str, tracer) -> int:
    """Export a tracer's kept traces to ``path``; returns the number of
    trace-event records written."""
    doc = chrome_trace(tracer.traces())
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return len(doc["traceEvents"])


# --- self-time summary ----------------------------------------------------

def self_times(traces: list) -> dict:
    """Aggregate per span NAME: ``{name: (total_self_s, count)}``.
    Self-time is a span's duration minus its direct children's durations
    (clamped at 0 — children on other threads can overlap the parent),
    the standard profile ranking for 'where did the wall actually go'."""
    agg: dict = {}
    for trace in traces:
        spans = trace.get("spans", [])
        child_sum: dict = {}
        for sp in spans:
            pid = sp.get("parent_id")
            if pid:
                child_sum[pid] = (child_sum.get(pid, 0.0)
                                  + sp.get("duration_s", 0.0))
        for sp in spans:
            self_s = max(0.0, sp.get("duration_s", 0.0)
                         - child_sum.get(sp.get("span_id"), 0.0))
            name = sp.get("name", "")
            tot, cnt = agg.get(name, (0.0, 0))
            agg[name] = (tot + self_s, cnt + 1)
    return agg


def top_spans_by_self_time(traces: list, top: int = 3) -> list:
    """[(name, total_self_s, count)] ranked by total self-time."""
    agg = self_times(traces)
    ranked = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=True)
    return [(name, tot, cnt) for name, (tot, cnt) in ranked[:top]]


def format_span_summary(traces: list, top: int = 3) -> str:
    """One-line summary (``gator bench`` prints this after each engine
    run): the top-N spans by self-time."""
    ranked = top_spans_by_self_time(traces, top=top)
    if not ranked:
        return "spans: (no traces kept)"
    parts = [f"{name} {tot:.3f}s/{cnt}x" for name, tot, cnt in ranked]
    return "spans (top self-time): " + ", ".join(parts)
