"""chip_smoke.py's hooks (a) with one checkout of gatekeeper_tpu_torch.

    python3 tools/torch_hooks_ab.py --package-root DIR [--device cpu]

Runs DIR's ``chip_smoke.hooks_cli_run`` four times in ABBA order on the
card (or, with ``--device cpu``, on the host: the CLI's plain versions,
a rehearsal whose host serves ~60-90 admissions/s, as slow card hosts
did): ``python -m gatekeeper_tpu_torch --manifests library --port P`` at
the JAX defaults (the overload limiter, cost attribution, the flight
recorder and the SLO engine on), with ``HOOKS_OFF``, with ``HOOKS_OFF``
and at the defaults again, each answering 1,024 admission bodies from 64
keep-alive clients (every answer held against the CPU handler).  Prints
one line ``HOOKS_AB {...}``: the package root, the defaults' p99 sum over
hooks off's (the ratio chip_smoke gates at 1.3) and each run's p99,
sheds and rate.

For an A/B of two commits on one card, unpack the other commit with
``git archive`` into a directory and run this script on it and on ``.``
alternately (A, B, B, A) in one call to the card.  It uses only the
hooks phase's helpers of that checkout's ``chip_smoke.py``, so it runs
on any commit of the port since its hooks slice.  Needs one CUDA card
unless ``--device cpu``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package-root", required=True,
                   help="the checkout whose served CLI is timed")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the served CLI evaluates (default cuda)")
    args = p.parse_args()
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from gatekeeper_tpu_torch.__main__ import build_client
    from gatekeeper_tpu_torch.webhook.server import admission_response

    manifests = cs.library_manifests()
    bodies, _objects = cs.admission_traffic(1024)
    ref = cs._cli_handler(build_client(manifests, device="cpu")[0],
                          manifests)
    refs = []
    for body in bodies:
        v = ref.handle(copy.deepcopy(body))
        refs.append(cs._answer(admission_response(
            v.uid, v.allowed, v.message, v.code, v.warnings)["response"]))
    runs = []
    for on in (True, False, False, True):
        r = cs.hooks_cli_run(bodies, refs, on, args.device, args.device)
        runs.append({"defaults": on, "p99_ms": r["p99_ms"],
                     "shed": r["shed"], "per_s": r["per_s"]})
    on = sum(r["p99_ms"] for r in runs if r["defaults"])
    off = sum(r["p99_ms"] for r in runs if not r["defaults"])
    print("HOOKS_AB " + json.dumps({"root": args.package_root,
                                    "device": args.device,
                                    "ratio": on / off, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
