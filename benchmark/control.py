"""Run a cell's control: the reference with one stated guarantee broken, in
the program's place, through the comparison that decides ``correct``.

    python3 benchmark/control.py --workload NAME --seeds S1 S2 S3
        [--objects N] [--workers K]

For each seed it prints the numbers the comparison gives for the control's
answers beside their limits, one JSON line a seed.  The configuration's
``control`` names the guarantee (``no_inventory``: the Ingress join sees no
inventory); the cell's driver (``drivers/<driver>.py``, its ``control``)
works the control's answer out and compares it.  It needs no card: the
control is the reference, which runs on the host.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--objects", type=int, default=0,
                   help="scale the cluster to about this many objects "
                        "(default: the configuration's)")
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    from harness import core

    spec = core.benchmark_spec()
    _cell, _entry, config, mix = core.find_cell(spec, args.workload)
    driver = core.plugin("drivers", mix["driver"])
    workers = args.workers or min(config["check"]["workers"],
                                  os.cpu_count() or 1)
    limits = config["check"]["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = {"config": config, "mix": mix, "seed": seed,
               "objects": args.objects,
               "library_root": os.path.join(core.ROOT, config["library"])}
        nums = driver.control(ctx, workers)
        print(json.dumps({
            "workload": args.workload, "control": config["control"],
            "seed": seed, "objects": args.objects or "configuration's",
            "seconds": round(time.perf_counter() - t0, 3),
            "compared": {k: {"value": v, "limit": limits[k]}
                         for k, v in nums.items()},
            "correct": all(v <= limits[k] for k, v in nums.items())}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
