"""Device time of the fold kernels of one checkout of gatekeeper_tpu_torch.

    python3 tools/torch_fold_ab.py --package-root DIR

Builds DIR's fold kernels, holds ``fused_fold`` and ``epilogue`` bit for
bit against their plain versions at the audit sweep's shape (C=44,
N=32,768, k=20: a grid of density 0.01 under a 70% mask), and times both
by ``chip_smoke.py``'s methods: ``ms`` is device time per launch from
CUDA-graph replay (``device_ms``), ``call_ms`` one call between two events
(``call_ms``, which includes the host's enqueue).  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line.

For an A/B of two commits on one card, unpack the other commit with
``git archive`` into a directory and run this script on it and on ``.``
alternately (A, B, B, A) in one call to the card.  It uses only the fold's
contract (the two wrappers and their plain versions), so it runs on any
commit of the port.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
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
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fold_ab: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    smoke = _chip_smoke()
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    from gatekeeper_tpu_torch.ops import fold

    if not os.path.abspath(fold.__file__).startswith(root + os.sep):
        raise SystemExit(f"torch_fold_ab: imported {fold.__file__}, "
                         f"not the package under {root}")
    c, n, k = smoke.C_MAIN, smoke.N_MAIN, smoke.K_MAIN
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
    mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
    masked = grid & mask
    kernels = (("fused_fold", lambda: fold.fused_fold(grid, mask, k),
                lambda: fold.fused_fold_plain(grid, mask, k)),
               ("epilogue", lambda: fold.epilogue(masked, k),
                lambda: fold.epilogue_plain(masked, k)))
    out = {"package": root, "card": card, "c": c, "n": n, "k": k}
    for name, fn, plain in kernels:
        smoke._max_abs_err(fn(), plain())  # raises on any difference
        out[name] = {"ms": smoke.device_ms(fn), "call_ms": smoke.call_ms(fn)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
