"""gator expand: offline expansion preview (reference: cmd/gator/expand).

Reads resources + ExpansionTemplates + mutators, prints the resultant
resources as YAML documents (sorted keys, --- separated), or writes them to
--outputs.  The batched and differential lanes run the mutation
prefilter's grids on ``--device`` (default ``cuda``; they raise without a
card unless ``--device cpu`` is given); the host lane runs no device work.
"""

from __future__ import annotations

import argparse
import sys

import yaml

from gatekeeper_tpu_torch.expansion.expander import Expander
from gatekeeper_tpu_torch.gator import reader


def run_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator expand")
    p.add_argument("--filename", "-f", action="append", default=[])
    p.add_argument("--output", "-o", default="",
                   help="write to file instead of stdout")
    p.add_argument("--format", default="yaml", choices=["yaml", "json"])
    p.add_argument("--lane", default="host",
                   choices=["host", "batched", "differential"],
                   help="'host' walks the recursive per-object reference "
                        "path; 'batched' expands level-synchronously "
                        "through the mutlane expansion stage (resultants "
                        "batch-mutate in one columnar pass per level); "
                        "'differential' runs BOTH and asserts identical "
                        "resultants")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the batched and differential lanes run the "
                        "mutation prefilter: cuda (default; raises without "
                        "a card) or cpu")
    args = p.parse_args(argv)
    if args.lane != "host":
        from gatekeeper_tpu_torch import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise

    try:
        objs = reader.read_sources(args.filename, use_stdin=not args.filename)
    except OSError as e:
        print(f"error: reading: {e}", file=sys.stderr)
        return 1
    if not objs:
        print("no input data identified", file=sys.stderr)
        return 1

    try:
        resultants = _expand(objs, args.lane, args.device)
    except Exception as e:
        print(f"error: expanding resources: {e}", file=sys.stderr)
        return 1

    docs = [r.obj for r in resultants]
    if args.lane == "differential":
        print(f"differential: batched lane identical to the host walk "
              f"({len(docs)} resultants)", file=sys.stderr)
    if args.format == "json":
        import json

        out = json.dumps(docs, indent=4)
    else:
        out = "---\n".join(
            yaml.safe_dump(d, sort_keys=True, default_flow_style=False)
            for d in docs
        )
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def _expand(objs, lane: str, device: str = "cuda") -> list:
    """Resultants of every base under the chosen lane (the CLI's
    sequential per-object order); the batched lane's prefilter runs on
    ``device``."""
    import copy

    def host(objects):
        expander = Expander(objects)
        out = []
        for obj in objects:
            out.extend(expander.expand(obj))
        return out

    if lane == "host":
        return host(objs)
    from gatekeeper_tpu_torch.mutlane import BatchedExpander

    # the host walk mutates bases in place; isolate each lane's input so
    # a differential run compares two independent expansions
    batched_objs = copy.deepcopy(objs) if lane == "differential" else objs
    batched = BatchedExpander(
        batched_objs, differential=lane == "differential", device=device)
    resultants = batched.expand_all(batched_objs)
    if lane == "differential":
        want = host(objs)
        got_docs = [r.obj for r in resultants]
        want_docs = [r.obj for r in want]
        if got_docs != want_docs:
            raise AssertionError(
                "expansion differential mismatch: batched lane diverged "
                f"from the host walk ({len(got_docs)} vs "
                f"{len(want_docs)} resultants)")
        for g, w in zip(resultants, want):
            if (g.template_name, g.enforcement_action) != \
                    (w.template_name, w.enforcement_action):
                raise AssertionError(
                    "expansion differential mismatch: template/"
                    "enforcement metadata diverged")
    return resultants
