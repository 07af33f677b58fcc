"""One run of one cell: set-up, the window, the trace, the check, the line.

``python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1``
from the root of a checkout.  Standard error carries the progress, the
card's name, power limit and the host's cores, and as its last lines each
number compared beside its limit; the last line of standard output is the
result.  A run that cannot measure (no card, too few cards, a changed
library, JAX loaded) exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from harness import core, trace
from harness.core import BenchError, log


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def reference_workers(config: dict) -> int:
    return max(1, min(config["check"]["workers"], os.cpu_count() or 1))


def main(argv, t_process: float, device: str = "cuda",
         overrides: dict = None) -> int:
    """The run.  ``device`` and ``overrides`` (``objects``, ``workers``,
    ``mix``, ``program_hooks``) are for the benchmark's own tests, which
    drive a run on the CPU at a small size; the command never sets them."""
    overrides = overrides or {}
    try:
        result, compared = run(parse(argv), t_process, device, overrides)
    except BenchError as e:
        log(f"benchmark: {e}")
        return 2
    for name, value, limit in compared:
        log(f"compare {name}: {value} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0


def run(args, t_process: float, device: str, overrides: dict) -> tuple:
    spec = core.benchmark_spec()
    cell, _entry, config, mix = core.find_cell(spec, args.workload)
    mix = {**mix, **overrides.pop("mix", {})}
    library_root = os.path.join(core.ROOT, config["library"])
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{torch.cuda.device_count()} cards, the cell "
                             f"asks for {cell['chips']}")
        kind = torch.cuda.get_device_name(0)
        torch.cuda.reset_peak_memory_stats()
    else:
        kind = "cpu"
    digest = core.library_digest(library_root)
    if digest != config["library_digest"]:
        raise BenchError(f"library digest {digest} is not the "
                         f"configuration's {config['library_digest']}")
    info = core.card_info()
    log(f"card: {kind}, power limit {info['power_limit']}, host "
        f"os.cpu_count() {info['cpu_count']}")
    marks: dict = {}

    def mark_window_start():
        marks["setup_s"] = time.perf_counter() - t_process

    def window_closed():
        core.check_modules("after the window")

    ctx = {"config": config, "mix": mix, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "device": device, "library_root": library_root,
           "mark_window_start": mark_window_start,
           "window_closed": window_closed, **overrides}
    driver = core.plugin("drivers", mix["driver"])
    out = driver.run(ctx)
    core.check_modules("after the run")

    t0 = time.perf_counter()
    limits = config["check"]["limits"]
    nums = driver.check(ctx, out, overrides.get("workers")
                        or reference_workers(config))
    compared = [(k, v, limits[k]) for k, v in nums.items()]
    log(f"check: reference {time.perf_counter() - t0:.3f} s")
    core.check_modules("after the check")
    correct = all(value <= limit for _n, value, limit in compared)

    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    metrics = {}
    if not args.trace:
        e2e = {**out["e2e"], "setup_s": marks["setup_s"]}
        for m in core.cell_metrics(spec, args.workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        layer = {**out["layer"], "profile": out.get("profile")}
        for m in core.cell_metrics(spec, args.workload, "per_layer"):
            value = core.metric_reader(m["name"])(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit": info["power_limit"],
           "cpu_count": info["cpu_count"]}
    prof = out.get("profile")
    if args.trace and prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = trace.breakdown(prof)
    result["device"] = dev
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result, compared
