"""Admission flight recorder: "why was THIS request shed at 14:02".

A bounded structured ring of every admission / mutation / shed decision
the serving path makes, with enough context to reconstruct the decision
after the fact: uid, verdict, matched-template messages (truncated),
lane, admission cost, trace id (the link into ``/debug/traces``), and
the overload state at decision time (brownout level, in-flight limit,
queue depth).  Served at ``/debug/decisions?uid=``; optionally mirrored
to a JSONL file sink (the ``export/`` seam's disk shape — one line per
decision, append-only, the operator's black box).

Privacy: the in-memory ring stores decision METADATA only — kind,
name, namespace, uid, messages — never the object body (admission
payloads carry Secrets).  Messages truncate at ``max_message``.  With
``capture=True`` the JSONL *sink* lines additionally carry the raw
admission ``request`` (the replay corpus for ``gator replay``); the
ring still never holds bodies, and capture is opt-in precisely because
the sink then holds Secrets-grade data.

Activation mirrors ``resilience/faults.py``: :func:`install` process-
global, :func:`activate` scoped for tests, :func:`active` the hot-path
read.  Recording is one dict build + deque append under a lock —
nanoseconds against a millisecond admission path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional


def _open_sink(path: str):
    """Append-open the JSONL sink, repairing a torn tail first.

    A recorder killed mid-write leaves a partial final line with no
    newline; appending straight after it would fuse the next record
    onto the fragment, corrupting BOTH lines for every reader.  Writing
    one separating newline confines the damage to the already-lost
    fragment (readers count it as a single truncated record)."""
    torn = False
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            if f.tell() > 0:
                f.seek(-1, 2)
                torn = f.read(1) != b"\n"
    except OSError:
        pass  # absent/unreadable: plain append-create below
    sink = open(path, "a", buffering=1)  # line-buffered
    if torn:
        try:
            sink.write("\n")
        except Exception:
            pass
    return sink


def rotated_paths(path: str) -> list:
    """Every existing file of a (possibly rotated) sink set, OLDEST
    first: ``path.N`` … ``path.1`` then ``path`` itself.  Readers
    (``gator decisions`` / ``gator triage`` offline mode) concatenate
    these to see the full retained decision stream; each file repairs /
    counts its own torn tail independently, so rotation never corrupts
    a read."""
    out: list = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    for i in range(n - 1, 0, -1):
        out.append(f"{path}.{i}")
    if os.path.exists(path):
        out.append(path)
    return out


class FlightRecorder:
    def __init__(self, capacity: int = 2048,
                 sink_path: Optional[str] = None,
                 metrics=None,
                 wall=time.time,
                 max_message: int = 512,
                 capture: bool = False,
                 sink_max_bytes: int = 0,
                 sink_keep: int = 3):
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.metrics = metrics
        self._wall = wall
        self.max_message = max_message
        self.capture = capture
        self.recorded = 0
        self._sink = None
        self.sink_path = sink_path
        # size-based sink rotation (--flight-recorder-sink-max-mb): a
        # sink past sink_max_bytes rotates to path.1 (path.1 -> path.2
        # ... up to sink_keep rotated files, oldest dropped) and a
        # fresh sink opens.  0 = unbounded (the pre-rotation shape)
        self.sink_max_bytes = max(0, int(sink_max_bytes))
        self.sink_keep = max(1, int(sink_keep))
        self.rotations = 0
        self._sink_lock = threading.Lock()
        self._sink_bytes = 0
        if sink_path:
            self._sink = _open_sink(sink_path)
            try:
                self._sink_bytes = os.path.getsize(sink_path)
            except OSError:
                self._sink_bytes = 0

    # --- recording -----------------------------------------------------
    def record(self, endpoint: str, decision: str, uid: str = "",
               obj_kind: str = "", name: str = "", namespace: str = "",
               operation: str = "", message: str = "", lane: str = "",
               cost: float = 0.0, reason: str = "",
               warnings: int = 0, code: int = 0,
               overload=None, tenant: str = "", cluster: str = "",
               request=None, **extra) -> dict:
        """One decision.  ``endpoint``: validate|mutate; ``decision``:
        allow|deny|shed|error|deadline.  ``overload`` is the
        OverloadController whose state gets snapshotted (or None).
        ``tenant`` is the QoS/attribution tenant key (namespace or
        serviceaccount) — the axis ``?tenant=`` and ``gator decisions
        --tenant`` filter on.  ``cluster`` (fleet mode) names the
        serving cluster the decision belongs to — the ``?cluster=`` /
        ``gator decisions --cluster`` axis, so a fleet's interleaved
        decision stream stays attributable per cluster.  ``request``
        (capture mode only) is the raw admission request dict; it rides
        the sink line — never the ring — as the replay corpus."""
        from gatekeeper_tpu_torch.observability import tracing

        span = tracing.current_span()
        entry = {
            "ts": self._wall(),
            "endpoint": endpoint,
            "decision": decision,
            "uid": uid,
            "kind": obj_kind,
            "name": name,
            "namespace": namespace,
        }
        if operation:
            entry["operation"] = operation
        if tenant:
            entry["tenant"] = tenant
        if cluster:
            entry["cluster"] = cluster
        if message:
            entry["message"] = message[: self.max_message]
        if lane:
            entry["lane"] = lane
        if cost:
            entry["cost"] = round(float(cost), 1)
        if reason:
            entry["reason"] = reason
        if warnings:
            entry["warnings"] = warnings
        if code:
            entry["code"] = code
        if span is not None and getattr(span, "trace_id", ""):
            entry["trace_id"] = span.trace_id
        if overload is not None:
            try:
                entry["overload"] = {
                    "brownout": overload.brownout_level(),
                    "inflight_limit": overload.limiter.limit,
                    "queue_depth": overload.queue_depth(),
                }
            except Exception:
                pass
        # targeted SLO degradations in force at decision time (the
        # overload-state change the degradation maps make visible in
        # the black box — "this allow served a stale namespace")
        try:
            from gatekeeper_tpu_torch.resilience import overload as _ovl

            reg = _ovl.active_degradations()
            if reg is not None:
                degraded = reg.active_names()
                if degraded:
                    entry.setdefault("overload", {})["degraded"] = \
                        degraded
        except Exception:
            pass
        for k, v in extra.items():
            if v not in (None, "", 0):
                entry[k] = v
        with self._lock:
            self._ring.append(entry)
            self.recorded += 1
            sink = self._sink
        if sink is not None:
            line = entry
            if self.capture and request is not None:
                # bodies ride the sink only: the ring (served at
                # /debug/decisions) stays metadata-only
                line = dict(entry)
                line["request"] = request
            try:
                data = json.dumps(line, default=str) + "\n"
                with self._sink_lock:
                    sink = self._sink  # re-read: rotation swaps it
                    if sink is not None:
                        sink.write(data)
                        self._sink_bytes += len(data)
                        if self.sink_max_bytes and \
                                self._sink_bytes >= self.sink_max_bytes:
                            self._rotate_locked()
            except Exception:
                pass  # the recorder must never fail an admission
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.FLIGHTREC_DECISIONS,
                                     {"decision": decision})
        return entry

    # --- lookup ---------------------------------------------------------
    def by_uid(self, uid: str) -> list:
        with self._lock:
            return [e for e in self._ring if e.get("uid") == uid]

    def decisions(self, limit: int = 100) -> list:
        """Most recent first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out[: max(0, limit)]

    def snapshot(self, uid: Optional[str] = None,
                 limit: int = 100,
                 since: Optional[float] = None,
                 until: Optional[float] = None,
                 kinds: Optional[set] = None,
                 tenant: Optional[str] = None,
                 cluster: Optional[str] = None) -> dict:
        """The ``/debug/decisions`` payload.

        ``since``/``until`` bound the decision timestamp (unix seconds,
        half-open ``[since, until)``); ``kinds`` keeps only the named
        decision kinds (allow|deny|shed|error|deadline); ``tenant``
        keeps one tenant's decisions (the QoS/attribution axis);
        ``cluster`` keeps one cluster's decisions (the fleet axis).
        Filters compose with each other and with ``uid``, so "every
        shed tenant-a took between 14:02 and 14:03" is one query
        instead of a ring dump."""
        with self._lock:
            ring = list(self._ring)
        filtered = since is not None or until is not None or kinds \
            or tenant is not None or cluster is not None
        if filtered:
            ring = [e for e in ring
                    if (since is None or e.get("ts", 0.0) >= since)
                    and (until is None or e.get("ts", 0.0) < until)
                    and (not kinds or e.get("decision") in kinds)
                    and (tenant is None or e.get("tenant", "") == tenant)
                    and (cluster is None
                         or e.get("cluster", "") == cluster)]
        if uid:
            matched = [e for e in ring if e.get("uid") == uid]
            return {"uid": uid, "recorded": self.recorded,
                    **({"matched": len(matched)} if filtered else {}),
                    "decisions": matched}
        ring.reverse()
        out = {"recorded": self.recorded,
               "capacity": self._ring.maxlen,
               "sink": self.sink_path or "",
               "decisions": ring[: max(0, limit)]}
        if filtered:
            out["matched"] = len(ring)
        return out

    def _rotate_locked(self) -> None:
        """Shift the sink set one slot (call under ``_sink_lock``):
        close, ``path.k -> path.k+1`` newest-first (the file past
        ``sink_keep`` is dropped), ``path -> path.1``, reopen fresh.
        The shift preserves per-file line integrity, so torn-tail
        repair and readers work unchanged across the set."""
        path = self.sink_path
        try:
            self._sink.close()
        except Exception:
            pass
        self._sink = None
        try:
            drop = f"{path}.{self.sink_keep}"
            if os.path.exists(drop):
                os.remove(drop)
            for i in range(self.sink_keep - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            os.replace(path, f"{path}.1")
        except OSError:
            pass  # rotation best-effort: keep recording into `path`
        self._sink = _open_sink(path)
        self._sink_bytes = 0
        self.rotations += 1

    def close(self) -> None:
        with self._sink_lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:
                pass


# --- activation (the faults.py pattern) -----------------------------------

_global: list = [None]


def install(rec: Optional[FlightRecorder]) -> None:
    _global[0] = rec


def uninstall() -> None:
    _global[0] = None


def active() -> Optional[FlightRecorder]:
    return _global[0]


@contextmanager
def activate(rec: FlightRecorder):
    prev = _global[0]
    _global[0] = rec
    try:
        yield rec
    finally:
        _global[0] = prev
