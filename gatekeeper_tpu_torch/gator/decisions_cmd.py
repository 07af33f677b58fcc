"""``gator decisions``: offline reader over the flight-recorder JSONL
sink (the operator's black box).

``/debug/decisions`` answers "why was THIS request shed at 14:02" while
the process is alive; this command answers it from the ``--flight-
recorder-sink`` file after the pod is gone — same filter semantics
(uid, half-open ``[--since, --until)`` time range, decision kinds,
tenant, fleet cluster), most-recent-first, bounded by ``--limit``.

    gator decisions -f decisions.jsonl --decision shed --tenant team-a \
        --since 1700000000 --until 1700000060 -o json

Timestamps accept unix seconds or ISO-8601 (``2026-08-04T14:02:00``,
interpreted as UTC when no offset is given — sink ``ts`` fields are
``time.time()`` epochs)."""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from typing import Optional


def _parse_ts(v: Optional[str]) -> Optional[float]:
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        pass
    try:
        dt = datetime.fromisoformat(v)
    except ValueError:
        raise ValueError(f"bad timestamp {v!r} (unix seconds or ISO-8601)")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def read_decisions(path: str, uid: str = "",
                   since: Optional[float] = None,
                   until: Optional[float] = None,
                   kinds: Optional[set] = None,
                   tenant: Optional[str] = None,
                   cluster: Optional[str] = None,
                   limit: int = 100) -> dict:
    """Load + filter a flight-recorder JSONL sink.  Returns the same
    payload shape as ``FlightRecorder.snapshot`` (``decisions`` most
    recent first, ``matched`` when any filter applied) so tooling built
    against ``/debug/decisions`` reads both.  A size-rotated sink set
    (``path.N`` … ``path.1`` + ``path``, see ``--flight-recorder-sink-
    max-mb``) reads transparently oldest-first as one stream.
    Malformed lines are counted, never fatal — a black box that
    crashes its reader is no black box."""
    from gatekeeper_tpu_torch.observability.flightrec import rotated_paths

    decisions: list = []
    malformed = 0
    truncated = 0
    total = 0
    paths = rotated_paths(path) or [path]
    for part in paths:
        with open(part) as f:
            for raw in f:
                ends_nl = raw.endswith("\n")
                line = raw.strip()
                if not line:
                    continue
                total += 1
                try:
                    e = json.loads(line)
                except ValueError:
                    # a final line with no newline is a crashed
                    # recorder's torn tail, not sink corruption —
                    # count it apart
                    if ends_nl:
                        malformed += 1
                    else:
                        truncated += 1
                    continue
                if not isinstance(e, dict):
                    # valid JSON but not a record (e.g. a bare number
                    # from a corrupted merge) — same skip-and-count
                    # contract
                    malformed += 1
                    continue
                if uid and e.get("uid") != uid:
                    continue
                ts = float(e.get("ts", 0.0) or 0.0)
                if since is not None and ts < since:
                    continue
                if until is not None and ts >= until:
                    continue
                if kinds and e.get("decision") not in kinds:
                    continue
                if tenant is not None and e.get("tenant", "") != tenant:
                    continue
                if cluster is not None and \
                        e.get("cluster", "") != cluster:
                    continue
                decisions.append(e)
    filtered = bool(uid or since is not None or until is not None
                    or kinds or tenant is not None
                    or cluster is not None)
    decisions.reverse()  # most recent first, like /debug/decisions
    out = {"recorded": total, "sink": path,
           "decisions": decisions[: max(0, limit)]}
    if len(paths) > 1:
        out["rotated_files"] = len(paths)
    if filtered:
        out["matched"] = len(decisions)
    if malformed:
        out["malformed"] = malformed
    if truncated:
        out["truncated"] = truncated
    return out


def _table(doc: dict) -> str:
    rows = doc["decisions"]
    if not rows:
        return "(no matching decisions)"
    cols = ("ts", "endpoint", "decision", "uid", "kind", "namespace",
            "tenant", "cluster", "priority", "reason", "cost")
    rendered = [[("%.3f" % e["ts"]) if c == "ts" and "ts" in e
                 else str(e.get(c, "")) for c in cols] for e in rows]
    widths = [max(len(c), *(len(r[i]) for r in rendered))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(cols))]
    for r in rendered:
        lines.append("  ".join(v.ljust(widths[i])
                               for i, v in enumerate(r)))
    return "\n".join(lines)


def run_cli(argv: list) -> int:
    p = argparse.ArgumentParser(
        prog="gator decisions",
        description="offline reader over a flight-recorder JSONL sink "
                    "(--flight-recorder-sink); same filter semantics as "
                    "/debug/decisions")
    p.add_argument("--filename", "-f", required=True,
                   help="flight-recorder JSONL sink file")
    p.add_argument("--uid", default="", help="one request uid's history")
    p.add_argument("--since", default="",
                   help="keep decisions at/after this time (unix seconds "
                        "or ISO-8601; half-open [since, until))")
    p.add_argument("--until", default="",
                   help="keep decisions before this time")
    p.add_argument("--decision", action="append", default=[],
                   help="decision kind filter (repeatable or comma list: "
                        "allow|deny|shed|error|deadline)")
    p.add_argument("--tenant", default=None,
                   help="one tenant's decisions (the QoS/attribution "
                        "tenant key: namespace or serviceaccount)")
    p.add_argument("--cluster", default=None,
                   help="one cluster's decisions (the fleet axis: the "
                        "serving cluster id recorded per decision)")
    p.add_argument("--limit", type=int, default=100,
                   help="max decisions printed (most recent first)")
    p.add_argument("--output", "-o", default="",
                   choices=["", "json", "table"],
                   help="output format (default: human table)")
    args = p.parse_args(argv)
    try:
        since = _parse_ts(args.since)
        until = _parse_ts(args.until)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    kinds = {k for v in args.decision for k in v.split(",") if k}
    try:
        doc = read_decisions(args.filename, uid=args.uid, since=since,
                             until=until, kinds=kinds or None,
                             tenant=args.tenant, cluster=args.cluster,
                             limit=args.limit)
    except OSError as e:
        print(f"error: reading sink: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(_table(doc))
        extra = f"{len(doc['decisions'])} shown"
        if "matched" in doc:
            extra += f" of {doc['matched']} matched"
        extra += f" ({doc['recorded']} lines in sink"
        if doc.get("malformed"):
            extra += f", {doc['malformed']} malformed"
        if doc.get("truncated"):
            extra += f", {doc['truncated']} truncated"
        print(f"-- {extra})")
    return 0
