"""Relist audit phases of one checkout of gatekeeper_tpu_torch on the card.

    python3 tools/torch_relist_ab.py --package-root DIR [--objects N]

Runs ``chip_smoke.py``'s relist audit with DIR's package: all 46 library
templates over ``make_cluster_objects(N, seed=0)`` (131,072 by default),
chunks of 32,768, 20 kept, ``exact_totals=False``, on the ``reduced``
lane, then the ``masks`` lane.  A warm-up audit of the first 4,096
objects on both lanes comes first, so the CUDA context, the fold
kernels' build and the allocator's first growth stay out of the timed
runs.  Prints the card's ``nvidia-smi`` name and power limit, then one
JSON line: per lane the wall seconds, the evaluator's and manager's
phase totals (flatten, masks, upload, dispatch, fold_render, collect,
h2d_bytes) and the violation total.

For an A/B of two commits on one card, unpack the other commit with
``git archive`` into a directory and run this script on it and on ``.``
alternately (A, B, B, A) in one call to the card.  It uses only the
audit's entry points (``AuditManager``, ``SweepEvaluator``, the library
loader), so it runs on any commit of the port since its CEL slice.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package-root", required=True,
                   help="the checkout whose gatekeeper_tpu_torch is timed")
    p.add_argument("--objects", type=int, default=131072)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_relist_ab: torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    smoke = _chip_smoke()
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    import gatekeeper_tpu_torch
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    if not os.path.abspath(gatekeeper_tpu_torch.__file__).startswith(
            root + os.sep):
        raise SystemExit(f"torch_relist_ab: imported "
                         f"{gatekeeper_tpu_torch.__file__}, not the package "
                         f"under {root}")
    objects = make_cluster_objects(args.objects, seed=0)
    for lane in ("reduced", "masks"):
        smoke.audit(objects[:4096], "cuda", lane)
    out = {"package": root, "card": card, "objects": args.objects}
    for lane in ("reduced", "masks"):
        run, phases, dt = smoke.audit(objects, "cuda", lane)
        out[lane] = {"wall_s": dt,
                     "violations": sum(run.total_violations.values()),
                     "phases": dict(sorted(phases.items()))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
