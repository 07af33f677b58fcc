"""chip_smoke.py's served phase with one checkout of gatekeeper_tpu_torch.

    python3 tools/torch_served_ab.py --package-root DIR [--admissions N] \
        [--objects N]

Runs this checkout's ``chip_smoke.served_phase`` with DIR's package on the
card: ``N`` admissions (1,024 by default) from 64 keep-alive clients
through the webhook while the snapshot audit loop (every 0.25 s, a resync
every 2nd pass) runs over a churning ``FakeCluster`` of
``make_cluster_objects(N, seed=9)`` (4,096 by default), every answer held
against the CPU handler.  Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line: admissions/s, p50/p99, the loop's passes
during the burst and the final resync difference.

For an A/B of two commits on one card, unpack the other commit with
``git archive`` into a directory and run this script on it and on ``.``
alternately (A, B, B, A) in one call to the card.  It uses only the
served CLI's entry points (``__main__.build_audit``,
``start_audit_loop``, ``Batcher``, ``ValidationHandler``,
``WebhookServer``), so it runs on any commit of the port since its
snapshot slice.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package-root", required=True,
                   help="the checkout whose gatekeeper_tpu_torch is timed")
    p.add_argument("--admissions", type=int, default=1024)
    p.add_argument("--objects", type=int, default=4096)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_served_ab: torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    root = os.path.abspath(args.package_root)
    # DIR's package is imported first, so every later import of its
    # modules resolves under DIR; then this checkout's chip_smoke.py by
    # its module name, which the spawned load processes import too
    sys.path.insert(0, root)
    import gatekeeper_tpu_torch
    sys.path.insert(0, REPO)
    import chip_smoke as smoke

    if not os.path.abspath(gatekeeper_tpu_torch.__file__).startswith(
            root + os.sep):
        raise SystemExit(f"torch_served_ab: imported "
                         f"{gatekeeper_tpu_torch.__file__}, not the package "
                         f"under {root}")
    out = smoke.served_phase(args.admissions, args.objects, card)
    print(json.dumps({"package": root, "card": card, **out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
