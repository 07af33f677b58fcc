"""``gator replay``: the offline policy time machine.

Replays a recorded decision corpus against a CANDIDATE template
library and prints the verdict diff — the "what would the candidate
have decided about last week's admissions" answer.  Two corpus
sources:

- ``-f sink.jsonl``: a capture-mode flight-recorder sink
  (``--flight-recorder-capture``), replayed through the webhook decide
  path, chunked and batched device-side;
- ``--from-spill DIR``: a ``--snapshot-spill`` directory (the
  state-at-rv spill), whose resident objects replay at the audit
  enforcement point against the spilled verdict store.

``--differential`` points ``--candidate`` at the RECORDED library and
asserts bit-identity to the record (exit 1 on any mismatch) — the
replay path validating itself.

    gator replay -f decisions.jsonl --candidate candidate/ \
        --compile-cache /var/cache/gk -o json
    gator replay --from-spill /var/spill --candidate candidate/
    gator replay -f decisions.jsonl --candidate recorded/ --differential

The candidate's batched reviews run on ``--device`` (default ``cuda``;
it raises without a card unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_table(report: dict) -> str:
    lines = []
    skipped = report.get("skipped") or {}
    if "records" in report:
        lines.append(f"replayed {report['records']} recorded decisions "
                     f"in {report.get('wall_s', 0)}s "
                     f"({report.get('decisions_per_s') or 0}/s)")
        rec, cand = report.get("recorded", {}), report.get("candidate", {})
        lines.append(f"  recorded:  allow={rec.get('allow', 0)} "
                     f"deny={rec.get('deny', 0)}")
        lines.append(f"  candidate: allow={cand.get('allow', 0)} "
                     f"deny={cand.get('deny', 0)} "
                     f"error={cand.get('error', 0)}")
        lines.append(f"  newly denied: {report['newly_denied']}   "
                     f"newly allowed: {report['newly_allowed']}   "
                     f"message changed: {report['message_changed']}")
    else:
        lines.append(f"replayed {report['rows']} spilled rows in "
                     f"{report.get('wall_s', 0)}s "
                     f"({report.get('decisions_per_s') or 0}/s)")
        lines.append(f"  divergent rows: {report['divergences_total']}")
    if skipped:
        drops = {k: v for k, v in skipped.items()
                 if k not in ("lines", "replayed") and v}
        if drops:
            lines.append("  skipped: " + "  ".join(
                f"{k}={v}" for k, v in sorted(drops.items())))
    by_con = report.get("by_constraint") or {}
    if by_con:
        lines.append("per-constraint divergence:")
        for name, entry in sorted(by_con.items()):
            lines.append("  " + name + ": " + "  ".join(
                f"{k}={v}" for k, v in sorted(entry.items()) if v))
    off = report.get("top_offenders") or {}
    for axis in ("namespace", "kind"):
        top = [t for t in off.get(axis, []) if t[0]]
        if top:
            lines.append(f"top offenders by {axis}: " + ", ".join(
                f"{n or '(cluster)'}={c}" for n, c in top[:5]))
    for d in report.get("divergences", [])[:10]:
        where = d.get("namespace", "")
        what = d.get("obj_kind", "")
        lines.append(f"  {d['kind']}: {what} {where}/{d.get('name', '')}"
                     + (f" [{d['constraint']}]" if "constraint" in d
                        else "")
                     + (f" uid={d['uid']}" if d.get("uid") else ""))
    low = report.get("lowering") or {}
    cc = report.get("compile_cache") or {}
    if low or cc:
        lines.append(f"candidate: {low.get('lowered', 0)}/"
                     f"{low.get('templates', 0)} templates lowered, "
                     f"compile cache hits={cc.get('hits', 0)} "
                     f"misses={cc.get('misses', 0)}")
    for err in report.get("candidate_load_errors", []):
        lines.append(f"  candidate load error: {err}")
    diff = report.get("differential")
    if diff:
        if diff["bit_identical"]:
            lines.append(f"differential: bit-identical over "
                         f"{diff['checked']} records")
        else:
            lines.append(f"differential: {diff['mismatches_total']} "
                         f"MISMATCHES over {diff['checked']} records")
            for m in diff["mismatches"][:10]:
                lines.append(f"  mismatch: {json.dumps(m, default=str)}")
    return "\n".join(lines)


def run_cli(argv: list) -> int:
    p = argparse.ArgumentParser(
        prog="gator replay",
        description="replay a recorded decision corpus (capture-mode "
                    "flight-recorder JSONL or a --snapshot-spill dir) "
                    "against a candidate template library and diff "
                    "the verdicts")
    p.add_argument("--filename", "-f", default="",
                   help="flight-recorder JSONL sink recorded with "
                        "--flight-recorder-capture")
    p.add_argument("--from-spill", default="",
                   help="a --snapshot-spill directory: replay its "
                        "resident objects against the spilled verdicts")
    p.add_argument("--candidate", action="append", default=[],
                   help="candidate library file/dir (repeatable): "
                        "templates + constraints + cluster fixtures "
                        "(v1 Namespaces resolve namespace selectors)")
    p.add_argument("--namespaces-from-spill", default="",
                   metavar="DIR",
                   help="take v1/Namespace fixtures from this "
                        "--snapshot-spill directory (the RECORDED "
                        "cluster's labels) instead of the candidate "
                        "docs — pins namespace-selector fidelity; "
                        "point it at the --from-spill dir to reuse it")
    p.add_argument("--differential", action="store_true",
                   help="candidate IS the recorded library: assert "
                        "bit-identity to the record (exit 1 on any "
                        "mismatch)")
    p.add_argument("--compile-cache", default="",
                   help="shared on-disk compile cache dir; warm = the "
                        "candidate loads with zero fresh lowerings")
    p.add_argument("--chunk", type=int, default=256,
                   help="decisions per batched device pass")
    p.add_argument("--limit", type=int, default=0,
                   help="replay at most N records (0 = all)")
    p.add_argument("--max-divergences", type=int, default=50,
                   help="row-level divergences listed in the report")
    p.add_argument("--max-message", type=int, default=512,
                   help="recorder message truncation (must match the "
                        "recording side for --differential)")
    p.add_argument("--output", "-o", default="",
                   choices=["", "json", "table"],
                   help="output format (default: human table)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the candidate's batched reviews run: cuda "
                        "(default; raises without a card) or cpu")
    args = p.parse_args(argv)

    if bool(args.filename) == bool(args.from_spill):
        print("error: exactly one of -f/--filename or --from-spill",
              file=sys.stderr)
        return 2
    if not args.candidate:
        print("error: --candidate is required (for --differential, "
              "point it at the recorded library)", file=sys.stderr)
        return 2

    from gatekeeper_tpu_torch.gator import reader
    from gatekeeper_tpu_torch.replay import core

    try:
        docs = reader.read_sources(args.candidate)
    except OSError as e:
        print(f"error: reading candidate: {e}", file=sys.stderr)
        return 1
    if not docs:
        print("error: no candidate docs found", file=sys.stderr)
        return 1
    ns_override = None
    if args.namespaces_from_spill:
        try:
            ns_override = core.namespaces_from_spill(
                core.read_spill(args.namespaces_from_spill))
        except (OSError, ValueError) as e:
            print(f"error: reading namespace spill: {e}",
                  file=sys.stderr)
            return 1
    runtime = core.load_candidate(docs,
                                  compile_cache_dir=args.compile_cache,
                                  namespaces=ns_override,
                                  device=args.device)
    try:
        if args.filename:
            records, counts = core.read_corpus(args.filename,
                                               limit=args.limit)
            report = core.replay_decisions(
                records, runtime, chunk=args.chunk,
                max_message=args.max_message,
                differential=args.differential,
                max_divergences=args.max_divergences,
                skipped=counts)
        else:
            spill = core.read_spill(args.from_spill)
            report = core.replay_spill(
                spill, runtime, chunk=args.chunk,
                differential=args.differential,
                max_divergences=args.max_divergences)
    except (OSError, ValueError) as e:
        print(f"error: reading corpus: {e}", file=sys.stderr)
        return 1

    if args.output == "json":
        print(json.dumps(report, indent=2, default=str))
    else:
        print(_fmt_table(report))
    diff = report.get("differential")
    if diff is not None and not diff["bit_identical"]:
        return 1
    return 0
