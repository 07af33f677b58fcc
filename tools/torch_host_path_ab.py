"""The audit's host paths side by side on the card, in one process.

    python3 tools/torch_host_path_ab.py [--objects N] [--rounds R]

Runs ``chip_smoke.py``'s library relist (all 46 templates over
``make_cluster_objects(N, seed=0)``, 131,072 by default; chunks of
32,768, 20 kept, ``exact_totals=False``, reduced lane) under six host
paths, each with a fresh client:

- ``dict serial``: a dict lister, the serial schedule (the native dict
  columnizer, which holds the interpreter lock);
- ``dict pipelined 1``/``dict pipelined 2``: the same lister on the staged
  pipeline with one and with two flatten threads (two is ``auto`` on 4+
  cores);
- ``raw serial``: a lister of ``RawJSON`` objects (serialized once, before
  any timer), ``flatten_lane="raw"`` (the threaded C columnizer, lock
  released), serial;
- ``raw pipelined``: that lister on the pipeline, two flatten threads, in
  process;
- ``raw pipelined workers``: the same with W = min(4, effective cores -
  2), at least 2, flatten worker processes.

A warm-up relist of the first 4,096 objects runs first.  The runs go in
``--rounds`` rounds, the order reversed on every other round, so a drift
of the host's speed shows as a spread and not as a difference.  Prints
the card's ``nvidia-smi`` name and power limit and the host's core
counts, then one JSON line per run: wall seconds, the evaluator's and
manager's phase totals, and the pipeline's per-stage busy/wait/stall
seconds.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_KEYS = ("flatten", "fl_c_columnize", "masks", "upload", "wire_pack",
         "dispatch", "fold_render", "h2d_copies", "h2d_bytes")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=int, default=131072)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_host_path_ab: torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    smoke = _chip_smoke()
    from gatekeeper_tpu_torch.ops.flatten import shutdown_flatten_pools
    from gatekeeper_tpu_torch.pipeline import effective_cpu_count
    from gatekeeper_tpu_torch.utils.rawjson import as_raw
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    cores = (os.cpu_count(), effective_cpu_count())
    workers = max(2, min(4, cores[1] - 2))
    print(f"{card}; os.cpu_count() {cores[0]}, effective {cores[1]}; "
          f"flatten workers {workers}", flush=True)
    objects = make_cluster_objects(args.objects, seed=0)
    raws = [as_raw(o) for o in objects]
    configs = (  # label, lister, schedule, lane, worker processes, threads
        ("dict serial", objects, "off", "auto", 0, 0),
        ("dict pipelined 1", objects, "on", "auto", 0, 1),
        ("dict pipelined 2", objects, "on", "auto", 0, 2),
        ("raw serial", raws, "off", "raw", 0, 0),
        ("raw pipelined", raws, "on", "raw", 0, 2),
        ("raw pipelined workers", raws, "on", "raw", workers, 2))
    try:
        smoke.audit(objects[:4096], "cuda", "reduced")
        for rnd in range(args.rounds):
            order = configs if rnd % 2 == 0 else configs[::-1]
            for label, listed, pipeline, lane, w, threads in order:
                mgr, ev = smoke.pipeline_audit(objects, listed, "reduced",
                                               pipeline, lane, w)
                mgr.config.pipeline_flatten_workers = threads
                t0 = time.perf_counter()
                run = mgr.audit()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                perf = {**ev.perf, **mgr.perf}
                rec = {"run": label, "round": rnd, "wall_s": wall,
                       "violations": sum(run.total_violations.values()),
                       **{k: perf.get(k, 0.0) for k in _KEYS}}
                if mgr.pipe_stats is not None:
                    rec["stages"] = {
                        name: [st["busy_s"], st["wait_s"], st["stall_s"]]
                        for name, st in mgr.pipe_stats["stages"].items()}
                    rec["device_idle_fraction"] = \
                        mgr.pipe_stats["device_idle_fraction"]
                print(json.dumps(rec), flush=True)
    finally:
        shutdown_flatten_pools()
    return 0


if __name__ == "__main__":
    sys.exit(main())
