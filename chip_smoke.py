"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--objects N]

Phases (any failure raises and exits non-zero):

1. device: require CUDA, print the card's name and power limit, build the
   hand-written kernels from ``gatekeeper_tpu_torch/csrc/``;
2. kernels: hold every kernel bit for bit against its plain PyTorch
   version on numpy-seeded grids at the audit sweep's shape (C=44,
   N=32,768, k=20) and at edge shapes (hits on both sides of the cluster's
   segment edges, all hits in the last segment, k spanning segments, k past
   the hits, N=8, N=33, N=1,000, a misaligned view, rows of more than one
   pass, 70,000 rows), then time the kernel, the plain version, one
   ``torch.topk`` call (the library yardstick) and an empty kernel (the
   launch floor) on the device clock (see ``device_ms``);
3. path: the library audit sweep (every Rego template of ``library/`` and
   its sample constraint, ``--objects`` synthetic cluster objects, chunks
   of 32,768, 20 kept violations per constraint) through
   ``AuditManager.audit()`` on the card, once per collect lane: both lanes
   must agree, each fold kernel must have been launched by its lane, and a
   CPU run of the port (plain versions) must equal the card's run on the
   first 8,192 objects;
4. shapes: at every distinct (C, N, k) that the path launched a kernel
   with, both kernels held bit for bit against their plain versions on an
   edge grid and on a random grid, then timed;
5. profile: the reduced-lane audit once more under ``torch.profiler``,
   for the device's busy share of the audit wall and its top kernels;
6. report: a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate (data sheet)
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
C_MAIN, N_MAIN, K_MAIN = 44, 32768, 20
CPU_PREFIX = 8192
GRAPH_CALLS = 20    # back-to-back calls captured in one CUDA graph
GRAPH_REPLAYS = 25  # timed replays of that graph (median taken)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from gatekeeper_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.3f}s {sorted(paths)}")
    for name, out in sorted(cuda_build.reports.items()):
        log(f"nvcc {name}.cu:\n{out.strip()}")
    return {"card": card}


def call_ms(fn, reps: int = 50) -> float:
    """Median of CUDA-event pairs around ONE call each: the device clock,
    but the window holds the host's enqueue of the call too."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of a CUDA
    graph that holds GRAPH_CALLS back-to-back calls, so no host work (the
    wrapper's checks, allocations, the ctypes call) falls inside the timed
    window.  Median over GRAPH_REPLAYS replays.  The inputs stay in the
    50 MB L2 from call to call, as the path's freshly written grids do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_CALLS)
    del graph
    return statistics.median(times)


def _max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"kernel disagrees with its plain version: {g} vs {w}")
        err = max(err, float((g.to(torch.int64) - w.to(torch.int64))
                             .abs().max().item()) if g.numel() else 0.0)
    return err


def edge_rows(c: int, n: int, seg: int, rng) -> np.ndarray:
    """A [c, n] grid whose rows cycle through the cases of the segment
    split: hits on both sides of every segment edge (and at 0, n-1), hits
    only in the last segment, one hit per segment, an empty row, a full
    row, and a sparse random row."""
    g = np.zeros((c, n), bool)
    edges = np.arange(seg, n, seg)
    last = ((n - 1) // seg) * seg
    for r in range(c):
        case = r % 6
        if case == 0:
            g[r, np.concatenate([edges - 1, edges, [0, n - 1]])] = True
        elif case == 1:
            g[r, last:] = rng.random(n - last) < 0.3
        elif case == 2:
            starts = np.arange(0, n, seg)
            span = np.minimum(starts + seg, n) - starts
            g[r, starts + (rng.random(starts.size) * span).astype(int)] = True
        elif case == 4:
            g[r] = True
        elif case == 5:
            g[r] = rng.random(n) < 0.002
    return g


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one byte past an
    aligned address (a view with a storage offset)."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _cases(fold, rng) -> list:
    """(label, grid, mask, k) on the card."""
    cases = []

    def add(label, g, k, mask_density=0.7, edge=False):
        m = rng.random(g.shape) < mask_density
        if edge:
            m |= g  # keep the edge hits in scope for the fused kernel
        cases.append((label, torch.from_numpy(g).cuda(),
                      torch.from_numpy(m).cuda(), k))

    for d in (0.5, 0.001, 0.0):
        add(f"random density={d}", rng.random((C_MAIN, N_MAIN)) < d, K_MAIN)
    for c in (1, 45):
        add("random density=0.01", rng.random((c, N_MAIN)) < 0.01, K_MAIN)
    for k in (1, 126, 127, 128, 200):
        add("random density=0.05", rng.random((C_MAIN, 4096)) < 0.05, k)
    add("random density=0.05", rng.random((7, 1000)) < 0.05, K_MAIN)
    add("random density=0.5", rng.random((3, 33)) < 0.5, 40)
    add("random density=0.5", rng.random((6, 8)) < 0.5, K_MAIN)
    add("random density=0.3", rng.random((70000, 16)) < 0.3, 4)
    seg = fold.THREADS * fold.CHUNK
    for c, n, ks in ((16, N_MAIN, (3, 20, 200)), (3, 8192, (20,)),
                     (6, 16384, (20,)), (12, 65536, (20,)),
                     (12, 262144, (20, 40)), (6, 200003, (20,)),
                     (6, 1000, (20,))):
        for k in ks:
            add("segment edges", edge_rows(c, n, seg, rng), k, edge=True)
    for c, n in ((C_MAIN, N_MAIN), (6, 4096)):
        g = torch.from_numpy(edge_rows(c, n, seg, rng)).cuda()
        m = torch.from_numpy(rng.random((c, n)) < 0.7).cuda() | g
        cases.append(("misaligned view", _misaligned(g), _misaligned(m),
                      K_MAIN))
    return cases


def _bound(c: int, n: int, k: int, fused: bool) -> tuple:
    """(bound_ms, bound_by, bytes): the least time of the card for one
    fold: each input byte read once and each output byte written once over
    the HBM rate, against one AND, one compare and one count per input cell
    at the int8 peak."""
    out = c * k * 4 + c * k + c * 4 + (c * 4 if fused else 0)
    nbytes = (2 if fused else 1) * c * n + out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * c * n / INT8_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes
    return ops_ms, "operations", nbytes


def _check_both(fold, err, label, grid, mask, k) -> None:
    """Hold both kernels bit for bit against their plain versions on one
    case; keep the largest error of each in ``err``."""
    c, n = grid.shape
    err["fused_fold"] = max(err["fused_fold"], _max_abs_err(
        fold.fused_fold(grid, mask, k),
        fold.fused_fold_plain(grid, mask, k)))
    masked = grid & mask
    if grid.data_ptr() % 16:
        masked = _misaligned(masked)
    err["epilogue"] = max(err["epilogue"], _max_abs_err(
        fold.epilogue(masked, k), fold.epilogue_plain(masked, k)))
    torch.cuda.synchronize()
    plan = fold.fold_plan(n, grid.data_ptr() % 16 == 0)
    log(f"kernels agree: {label} C={c} N={n} k={k} plan={plan}")


def kernel_phase() -> tuple:
    from gatekeeper_tpu_torch.ops import fold

    rng = np.random.default_rng(0)
    err = {"fused_fold": 0.0, "epilogue": 0.0}
    for label, grid, mask, k in _cases(fold, rng):
        _check_both(fold, err, label, grid, mask, k)

    # timing at the sweep's shape: a sparse raw grid under a 70% mask
    c, n, k = C_MAIN, N_MAIN, K_MAIN
    grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
    mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
    masked = grid & mask
    idxs = torch.arange(n, dtype=torch.int32, device="cuda")
    score = torch.where(masked, n - idxs, 0).to(torch.int32)
    library_ms = device_ms(lambda: torch.topk(score, k, dim=1))
    floor_ms = device_ms(lambda: fold.empty_launch("cuda"))
    rows = []
    for name, line, fn, plain, fused in (
            ("fused_fold", 113, lambda: fold.fused_fold(grid, mask, k),
             lambda: fold.fused_fold_plain(grid, mask, k), True),
            ("epilogue", 33, lambda: fold.epilogue(masked, k),
             lambda: fold.epilogue_plain(masked, k), False)):
        bound_ms, bound_by, nbytes = _bound(c, n, k, fused)
        row = {
            "name": name, "route": "cuda",
            "source": "gatekeeper_tpu_torch/csrc/fold.cu",
            "replaces": f"gatekeeper_tpu/ops/pallas_topk.py:{line}",
            "max_abs_err": err[name],
            "ms": device_ms(fn), "plain_ms": device_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "call_ms": call_ms(fn), "floor_ms": floor_ms,
        }
        log(f"{name}: kernel {row['ms']:.5f} ms (device, graph replay), "
            f"{row['call_ms']:.5f} ms (one call), plain "
            f"{row['plain_ms']:.5f} ms, torch.topk {library_ms:.5f} ms, "
            f"floor {floor_ms:.5f} ms, bound {bound_ms:.6f} ms ({nbytes} "
            f"bytes) at C={c} N={n} k={k}")
        rows.append(row)
    return rows, err


def shape_phase(rows, err, shapes) -> None:
    """At every distinct (C, N, k) the path launched a kernel with: hold
    both kernels against their plain versions on an edge grid (under a 70%
    mask that keeps the edge hits in scope) and on a grid of density 0.01
    under a 70% mask, then time the kernel on the latter."""
    from gatekeeper_tpu_torch.ops import fold

    rng = np.random.default_rng(1)
    seg = fold.THREADS * fold.CHUNK
    for row in rows:
        name = row["name"]
        row["shapes"] = []
        for (c, n, k), launches in sorted(shapes[name].items()):
            edge = torch.from_numpy(edge_rows(c, n, seg, rng)).cuda()
            mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
            _check_both(fold, err, "path shape, segment edges", edge,
                        mask | edge, k)
            grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
            _check_both(fold, err, "path shape, density=0.01", grid, mask, k)
            masked = grid & mask
            if name == "fused_fold":
                ms = device_ms(lambda: fold.fused_fold(grid, mask, k))
            else:
                ms = device_ms(lambda: fold.epilogue(masked, k))
            bound_ms = _bound(c, n, k, name == "fused_fold")[0]
            row["shapes"].append({"c": c, "n": n, "k": k,
                                  "launches": launches, "ms": ms,
                                  "bound_ms": bound_ms})
            log(f"{name} at C={c} N={n} k={k}: {ms:.5f} ms (device), "
                f"{launches} launches on the path, plan "
                f"{fold.fold_plan(n, True)}")
    for row in rows:
        row["max_abs_err"] = err[row["name"]]


def _client(objects):
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.synthetic import load_library

    driver = TorchDriver()
    client = Client(target=K8sValidationTarget(), drivers=[driver],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    nt, nc = load_library(client, skip_kinds=CEL_KINDS)
    if driver.fallback_kinds():
        raise AssertionError(
            f"templates fell back to the interpreter: "
            f"{driver.fallback_kinds()}")
    for o in objects:
        if o.get("kind") == "Ingress":
            client.add_data(o)  # referential inventory (uniqueingresshost)
    return client, driver, nt, nc


def audit(objects, device: str, collect: str) -> tuple:
    """One library audit through the port's entry points: (run, phases,
    seconds)."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    mgr = AuditManager(client, lister=lambda: iter(objects),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4),
                       evaluator=evaluator)
    t0 = time.perf_counter()
    run = mgr.audit()
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phases = {**evaluator.perf, **mgr.perf}
    return run, phases, dt


def summary(run) -> tuple:
    kept = {key: [(v.constraint.kind, v.kind,
                   f"{v.namespace}/{v.name}", v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept


def path_phase(n_objects: int) -> tuple:
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    t0 = time.perf_counter()
    objects = make_cluster_objects(n_objects, seed=0)
    log(f"generated {n_objects} objects in {time.perf_counter() - t0:.1f}s")
    launches = {}
    shapes = {}
    results = {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        for wrapper in (fold.fused_fold, fold.epilogue):
            wrapper.launches = 0
            wrapper.shapes.clear()
        run, phases, dt = audit(objects, "cuda", collect)
        counts = {"fused_fold": fold.fused_fold.launches,
                  "epilogue": fold.epilogue.launches}
        if counts[kernel] <= 0:
            raise AssertionError(f"{collect} lane never launched {kernel}")
        launches[kernel] = counts[kernel]
        shapes[kernel] = dict(getattr(fold, kernel).shapes)
        total = sum(run.total_violations.values())
        log(f"audit[{collect}]: {run.total_objects} objects, {total} "
            f"violations, {dt:.3f}s, {run.total_objects / dt:.1f} objects/s, "
            f"launches {counts}")
        log(f"phases[{collect}]: " + json.dumps(
            {k: round(v, 6) for k, v in sorted(phases.items())}))
        if run.incomplete or run.total_objects != n_objects or total <= 0:
            raise AssertionError(f"audit[{collect}] result is not sane")
        results[collect] = summary(run)
    if results["reduced"] != results["masks"]:
        raise AssertionError("reduced and masks lanes disagree")
    prefix = objects[:CPU_PREFIX]
    on_card = summary(audit(prefix, "cuda", "reduced")[0])
    on_cpu = summary(audit(prefix, "cpu", "reduced")[0])
    if on_card != on_cpu:
        raise AssertionError("CPU run of the port differs from the card's")
    log(f"cpu == cuda on the first {CPU_PREFIX} objects "
        f"({sum(on_cpu[1].values())} violations)")
    return launches, shapes, objects


def profile_phase(objects) -> None:
    """Device busy time of one reduced-lane audit (sum of the device
    events' self time; one stream, so they do not overlap) against its wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run, _phases, wall = audit(objects, "cuda", "reduced")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy, memset): the aten ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        log("profile[reduced]: the profiler reported no device events; "
            "device busy time not measured")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    log(f"profile[reduced]: wall {wall * 1e3:.1f} ms (profiled), device "
        f"busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / (wall * 1e3):.4f}; top: " + "; ".join(
            f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
            for e in top))
    # the fold kernel as the audit launched it (inputs as the path leaves
    # them), beside the graph-replay time of the kernel phase
    for e in events:
        if "fold_rows" in e.key:
            log(f"profile[reduced]: {e.key[:60]} x{e.count}, "
                f"{dev_us(e) / 1e3 / e.count:.5f} ms per launch")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=int, default=131072,
                   help="synthetic cluster objects (131,072 = 4 chunks; up "
                        "to 1,000,000)")
    args = p.parse_args()
    if not 0 < args.objects <= 1_000_000:
        raise SystemExit("--objects must be in 1..1,000,000")
    device_phase()
    rows, err = kernel_phase()
    launches, shapes, objects = path_phase(args.objects)
    shape_phase(rows, err, shapes)
    profile_phase(objects)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
