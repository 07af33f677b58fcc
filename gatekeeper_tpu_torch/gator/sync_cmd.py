"""gator sync test: verify referential-data requirements are covered.

Reference: pkg/gator/sync — templates declare the GVKs their policies read
from ``data.inventory`` via the ``metadata.gatekeeper.sh/requires-sync-data``
annotation (a JSON list of requirement lists: ANY-of groups of
{groups, versions, kinds} ALL-of clauses); SyncSets and the Config resource
declare what is synced; the command reports requirements no sync source
covers.
"""

from __future__ import annotations

import argparse
import json
import sys

from gatekeeper_tpu_torch.gator import reader
from gatekeeper_tpu_torch.utils.unstructured import deep_get, gvk_of

REQUIRES_SYNC_ANNOTATION = "metadata.gatekeeper.sh/requires-sync-data"


def sync_sources(objs) -> list[dict]:
    """GVK entries synced by SyncSet CRs + the Config resource."""
    out = []
    for obj in objs:
        group, _, kind = gvk_of(obj)
        if kind == "SyncSet" and group == "syncset.gatekeeper.sh":
            out.extend(deep_get(obj, ("spec", "gvks"), []) or [])
        elif kind == "Config" and group == "config.gatekeeper.sh":
            for entry in deep_get(obj, ("spec", "sync", "syncOnly"), []) or []:
                out.append(entry)
    return out


def _covers(synced: dict, req: dict) -> bool:
    def any_match(want, got) -> bool:
        if not want:
            return True
        return got in want or "*" in want

    return (
        any_match(req.get("groups"), synced.get("group", ""))
        and any_match(req.get("versions"), synced.get("version", ""))
        and any_match(req.get("kinds"), synced.get("kind", ""))
    )


def missing_requirements(objs) -> dict:
    """template name -> list of uncovered requirement clauses."""
    synced = sync_sources(objs)
    out = {}
    for obj in objs:
        if not reader.is_template(obj):
            continue
        ann = deep_get(obj, ("metadata", "annotations"), {}) or {}
        raw = ann.get(REQUIRES_SYNC_ANNOTATION)
        if not raw:
            continue
        try:
            requirements = json.loads(raw)
        except json.JSONDecodeError as e:
            out[deep_get(obj, ("metadata", "name"), "?")] = [
                f"invalid {REQUIRES_SYNC_ANNOTATION} annotation: {e}"
            ]
            continue
        uncovered = []
        for any_of in requirements:
            if not isinstance(any_of, list):
                any_of = [any_of]
            ok = any(
                any(_covers(s, clause) for s in synced)
                for clause in any_of
            )
            if not ok:
                uncovered.append(any_of)
        if uncovered:
            out[deep_get(obj, ("metadata", "name"), "?")] = uncovered
    return out


def run_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator sync test")
    # accept both `gator sync test -f ...` and `gator sync -f ...`
    if argv and argv[0] == "test":
        argv = argv[1:]
    p.add_argument("--filename", "-f", action="append", default=[])
    args = p.parse_args(argv)

    try:
        objs = reader.read_sources(args.filename, use_stdin=not args.filename)
    except OSError as e:
        print(f"error: reading: {e}", file=sys.stderr)
        return 1
    if not objs:
        print("no input data identified", file=sys.stderr)
        return 1
    missing = missing_requirements(objs)
    if not missing:
        print("all requirements satisfied")
        return 0
    for name, reqs in sorted(missing.items()):
        print(f"template {name} has unsatisfied sync requirements:")
        for r in reqs:
            print(f"  {json.dumps(r)}")
    return 1
