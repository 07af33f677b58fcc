#!/usr/bin/env python
"""Adversarial soak CLI of the PyTorch/CUDA port: the corpus + chaos
harness (``gatekeeper_tpu_torch/fuzz/soak.py``) as one command.

    python tools/torch_soak.py --seed 0 --minutes 0 --families all \
        --chaos on [--device cuda|cpu]

The port's twin of ``tools/soak.py``.  A zero-``--minutes`` run is a
single full pass over every selected family; ``--minutes N`` loops rounds
until the clock runs out.  ``--device`` (default ``cuda``) is where the
webhook's grid, the mutation lane and the audit sweep run.  Every failure
prints the exact repro line; the run is recorded to
``tools/TORCH_SOAK_BENCH.json`` (never to the JAX package's
``tools/SOAK_BENCH.json``) with the previous record appended under
``history``, the corpus stats, the device, the differential collect
lane's counts and ``host_cpus``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEFAULT_OUT = os.path.join(os.path.dirname(__file__),
                           "TORCH_SOAK_BENCH.json")


def main() -> int:
    from gatekeeper_tpu_torch.fuzz import corpus
    from gatekeeper_tpu_torch.fuzz.soak import _repro_line, run_soak

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=1,
                   help="corpus size dial (1 = smoke, 16+ = ~1MB objects)")
    p.add_argument("--minutes", type=float, default=0.0,
                   help="0 = one full pass; >0 loops rounds on the clock")
    p.add_argument("--rounds", type=int, default=1,
                   help="passes when --minutes is 0")
    p.add_argument("--families", default="all",
                   help="comma list out of: " + ",".join(corpus.FAMILIES))
    p.add_argument("--chaos", default="on",
                   help="'on' (plan seeded by --seed), 'off', or an "
                        "integer chaos seed")
    p.add_argument("--concurrent", action="store_true",
                   help="drive admit/mutate from threads while the "
                        "audit runs (multi-core hosts)")
    p.add_argument("--inject-bug", default=None,
                   choices=["mutate_program", "extdata_column"],
                   help="seeded-bug sensitivity check: the run MUST "
                        "report a divergence")
    p.add_argument("--residency", default="off",
                   choices=["off", "auto", "on"],
                   help="arm the device-resident snapshot lane on the "
                        "snapshot-side audit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the fold kernels and the grid "
                        "on the card; cpu runs their plain versions")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="bench record path ('' disables recording)")
    args = p.parse_args()

    families = (None if args.families in ("all", "") else
                [f.strip() for f in args.families.split(",") if f.strip()])
    chaos = args.chaos != "off"
    chaos_seed = (int(args.chaos) if chaos and args.chaos != "on"
                  else None)

    report = run_soak(
        seed=args.seed, size=args.size, families=families,
        duration_s=args.minutes * 60.0, rounds=args.rounds,
        chaos=chaos, chaos_seed=chaos_seed, inject_bug=args.inject_bug,
        concurrent=args.concurrent, quiet=True,
        residency=args.residency, device=args.device)

    if args.inject_bug:
        # sensitivity inversion: the seeded bug MUST have been caught
        caught = bool(report["divergences"])
        report["ok"] = caught
        print("seeded bug "
              + ("CAUGHT" if caught else "MISSED — harness is blind"))

    print(json.dumps(report, indent=2, default=str))
    if args.out:
        record = {
            "kind": "soak",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
            "host_cpus": os.cpu_count(),
            "device": report["device"],
            "seed": report["seed"],
            "size": report["size"],
            "families": report["families"],
            "rounds": report["rounds"],
            "chaos": report["chaos"],
            "inject_bug": report["inject_bug"],
            "requests": report["requests"],
            "lost_verdicts": report["lost_verdicts"],
            "drain_ok": report["drain_ok"],
            "divergences_found": len(report["divergences"]),
            "crashes": len(report["crashes"]),
            "corpus": report["corpus"],
            "collect_differential": report["collect_differential"],
            "resident_uploads": report["resident_uploads"],
            "wall_s": report["wall_s"],
            "ok": report["ok"],
        }
        history = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                prev = json.load(f)
            history = prev.pop("history", [])
            history.append(prev)
        record["history"] = history
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        print(f"recorded -> {args.out}")
    if not report["ok"]:
        print(_repro_line(report))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
