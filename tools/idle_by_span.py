"""Name the card's idle time by what the program was doing.

    python3 tools/idle_by_span.py --workload library-150k.resident \\
        --seed 7 [--objects N] [--cost-pairs K] [--profiled P] \\
        [--device cuda|cpu] [--out chiprun_out/idle_resident.json]

Builds a benchmark cell's audit stack as ``benchmark/run.py`` does (the
cluster from the seed, the program's stack, a warm sweep, a full
collection), then:

1. the cost of tracing: ``K`` pairs of whole sweeps, one with no tracer
   and one with the program's ``Tracer`` installed, in turn (ABAB), each
   sweep's wall on the host's clock;
2. ``P`` consecutive sweeps, each under ``torch.profiler`` through the
   benchmark's ``harness.trace.profiled``, with the program's ``Tracer``
   installed: each idle gap of the card is named by the innermost
   program span (``observability.export.host_spans``, laid on the
   profiler's clock by the harness's window anchor) open at its middle,
   and the manager's ``gc/<phase>`` counters split that sweep's garbage
   collections by the phase they interrupted (consecutive resident
   passes differ in how many full collections they hold).

Last, the cost of one phase on this host: ``--phase-cost N`` phases with
no tracer and ``N`` with one, in microseconds a phase (times the sweep's
spans, a bound on what the phase clock costs a sweep, tracer on and off).

Prints one JSON line (and writes it to ``--out``): for each profiled sweep
the idle gaps by span, largest first, its phase counters and collector
split; and the tracing cost.  ``--device cpu`` rehearses the tool at a
small size (no device events: the whole window is one gap).  Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
OUTSIDE = "outside the program's spans"
# the manager's counters that sum over a pass (its perf dict also holds
# last-pass readings, which a difference would misread)
MANAGER_PHASES = ("list_route", "snapshot_ready", "snapshot_rows",
                  "fold_render", "render", "n_renders", "snapshot_collect",
                  "status_write")


def _args(argv):
    p = argparse.ArgumentParser(prog="tools/idle_by_span.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--objects", type=int, default=0,
                   help="scale the cluster to about N objects (0: the "
                        "configuration's)")
    p.add_argument("--cost-pairs", type=int, default=3)
    p.add_argument("--profiled", type=int, default=1)
    p.add_argument("--phase-cost", type=int, default=20000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    return p.parse_args(argv)


def _numbers(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in _numbers(after).items()
            if v - before.get(k, 0.0)}


def phase_cost(tracing, n: int) -> dict:
    """Microseconds a ``phase`` with a span name costs on this host, with
    no tracer (``off``) and with one installed (``on``)."""
    perf: dict = {}

    def add(key, dt):
        perf[key] = perf.get(key, 0.0) + dt

    out = {}
    for side in ("off", "on"):
        tracer = tracing.Tracer(seed=0, max_spans_per_trace=n + 2)
        t0 = time.perf_counter()
        with tracing.activate(tracer) if side == "on" else _Nothing():
            with tracing.span("audit.sweep"):
                for _ in range(n):
                    with tracing.phase(add, "list_route",
                                       "audit.list_route"):
                        pass
        out[side] = (time.perf_counter() - t0) / max(1, n) * 1e6
    return out


class _Nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def main(argv) -> int:
    args = _args(argv)
    sys.path.insert(0, BENCH)
    sys.path.append(ROOT)
    from harness import core, trace
    from harness.core import set_cache_dirs

    set_cache_dirs()
    import torch

    from gatekeeper_tpu_torch.observability import export, tracing

    spec = core.benchmark_spec()
    _cell, _entry, config, mix = core.find_cell(spec, args.workload)
    audit = core.plugin("drivers", mix["driver"])
    cuda = args.device == "cuda"
    if not cuda:
        # a CPU rehearsal: the profiler sees no device
        torch.cuda.synchronize = lambda: None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    objects, inputs = audit.cluster_inputs(config, args.seed, args.objects)
    n = len(objects)
    stack = audit.build(objects, inputs["raws"], config, mix, args.device)
    del objects, inputs
    mgr, evaluator = stack["mgr"], stack["evaluator"]
    mgr.audit()
    sync()
    gc.collect()
    print(f"idle_by_span: {n} objects, set up in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)

    walls: dict = {"off": [], "on": []}
    for _ in range(max(0, args.cost_pairs)):
        for side in ("off", "on"):
            tracer = tracing.Tracer(seed=0, max_spans_per_trace=65536)
            s0 = time.perf_counter()
            if side == "on":
                with tracing.activate(tracer):
                    mgr.audit()
            else:
                mgr.audit()
            sync()
            walls[side].append(time.perf_counter() - s0)

    profiled = []
    for _ in range(max(1, args.profiled)):
        tracer = tracing.Tracer(seed=0, max_spans_per_trace=65536)
        spans: list = []
        mperf0, eperf0 = _numbers(mgr.perf), _numbers(evaluator.perf)

        def sweep():
            with tracing.activate(tracer):
                mgr.audit()
            # the program's spans, on the host's monotonic clock, for the
            # harness to lay on the profiler's
            spans.extend(export.host_spans(tracer.traces()))

        prof = trace.profiled(sweep, spans)
        mperf = _delta(mgr.perf, mperf0)
        eperf = _delta(evaluator.perf, eperf0)
        gaps = sorted(((OUTSIDE if k == "outside the harness spans" else k,
                        v) for k, v in prof["gaps"].items()),
                      key=lambda x: -x[1])
        profiled.append({
            "wall_s": prof["host_wall_s"], "window_s": prof["window_s"],
            "busy_s": prof["busy_s"], "idle_share": prof["idle_share"],
            "idle_gaps": [[k, v] for k, v in gaps], "spans": len(spans),
            "collector": {k: v for k, v in sorted(mperf.items())
                          if k == "gc" or k.startswith("gc/")},
            "manager_phases": {k: mperf[k] for k in MANAGER_PHASES
                               if k in mperf},
            "evaluator_phases": {k: eperf[k] for k in (
                "flatten", "masks", "upload", "dispatch", "collect",
                "dispatches") if k in eperf}})
    out = {
        "workload": args.workload, "seed": args.seed, "objects": n,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "power_limit": core.card_info()["power_limit"],
        "profiled": profiled,
        "tracing_cost": {
            "pairs": len(walls["on"]),
            "sweep_s_off": walls["off"], "sweep_s_on": walls["on"],
            "ratio_on_off": (sum(walls["on"]) / sum(walls["off"])
                             if walls["off"] else None),
            "phase_us": phase_cost(tracing, args.phase_cost)},
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    close = stack.get("close")
    if close is not None:
        close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
