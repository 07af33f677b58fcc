"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--objects N]

Phases (any failure raises and exits non-zero):

1. device: require CUDA, print the card's name and power limit, build the
   hand-written kernels from ``gatekeeper_tpu_torch/csrc/``;
2. kernels: hold every kernel bit for bit against its plain PyTorch
   version on numpy-seeded grids at the audit sweep's shape (C=44,
   N=32,768, k=20) and edge shapes, and time the kernel, the plain version
   and one ``torch.topk`` call (the library yardstick) with CUDA events;
3. path: the library audit sweep (every Rego template of ``library/`` and
   its sample constraint, ``--objects`` synthetic cluster objects, chunks
   of 32,768, 20 kept violations per constraint) through
   ``AuditManager.audit()`` on the card, once per collect lane: both lanes
   must agree, each fold kernel must have been launched by its lane, and a
   CPU run of the port (plain versions) must equal the card's run on the
   first 8,192 objects;
4. profile: the reduced-lane audit once more under ``torch.profiler``,
   for the device's busy share of the audit wall and its top kernels;
5. report: a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

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
    return {"card": card}


def _median_ms(fn, reps: int = 50) -> float:
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


def _max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"kernel disagrees with its plain version: {g} vs {w}")
        err = max(err, float((g.to(torch.int64) - w.to(torch.int64))
                             .abs().max().item()) if g.numel() else 0.0)
    return err


def kernel_phase() -> list:
    from gatekeeper_tpu_torch.ops import fold

    rng = np.random.default_rng(0)
    cases = [(C_MAIN, N_MAIN, K_MAIN, d) for d in (0.5, 0.001, 0.0)]
    cases += [(1, N_MAIN, K_MAIN, 0.01), (45, N_MAIN, K_MAIN, 0.01)]
    cases += [(C_MAIN, 4096, k, 0.05) for k in (1, 126, 127, 128, 200)]
    cases += [(7, 1000, K_MAIN, 0.05), (3, 33, 40, 0.5)]
    err = {"fused_fold": 0.0, "epilogue": 0.0}
    for c, n, k, dens in cases:
        grid = torch.from_numpy(rng.random((c, n)) < dens).cuda()
        mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
        err["fused_fold"] = max(err["fused_fold"], _max_abs_err(
            fold.fused_fold(grid, mask, k),
            fold.fused_fold_plain(grid, mask, k)))
        masked = grid & mask
        err["epilogue"] = max(err["epilogue"], _max_abs_err(
            fold.epilogue(masked, k), fold.epilogue_plain(masked, k)))
        torch.cuda.synchronize()
        log(f"kernels agree: C={c} N={n} k={k} density={dens}")

    # timing at the sweep's shape: a sparse raw grid under a 70% mask
    c, n, k = C_MAIN, N_MAIN, K_MAIN
    grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
    mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
    masked = grid & mask
    idxs = torch.arange(n, dtype=torch.int32, device="cuda")
    score = torch.where(masked, n - idxs, 0).to(torch.int32)
    library_ms = _median_ms(lambda: torch.topk(score, k, dim=1))
    out_bytes = c * k * 4 + c * k + c * 4
    rows = []
    for name, line, fn, plain, in_bytes, extra_out in (
            ("fused_fold", 113, lambda: fold.fused_fold(grid, mask, k),
             lambda: fold.fused_fold_plain(grid, mask, k), 2 * c * n, c * 4),
            ("epilogue", 33, lambda: fold.epilogue(masked, k),
             lambda: fold.epilogue_plain(masked, k), c * n, 0)):
        nbytes = in_bytes + out_bytes + extra_out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # one AND, one compare and one count per input cell
        ops_ms = 3 * c * n / INT8_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda",
            "source": "gatekeeper_tpu_torch/csrc/fold.cu",
            "replaces": f"gatekeeper_tpu/ops/pallas_topk.py:{line}",
            "launches": 0, "max_abs_err": err[name],
            "ms": _median_ms(fn), "plain_ms": _median_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }
        log(f"{name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
            f" ms, torch.topk {library_ms:.4f} ms, bound {row['bound_ms']:.6f}"
            f" ms ({nbytes} bytes) at C={c} N={n} k={k}")
        rows.append(row)
    return rows


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
    results = {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        fold.fused_fold.launches = 0
        fold.epilogue.launches = 0
        run, phases, dt = audit(objects, "cuda", collect)
        counts = {"fused_fold": fold.fused_fold.launches,
                  "epilogue": fold.epilogue.launches}
        if counts[kernel] <= 0:
            raise AssertionError(f"{collect} lane never launched {kernel}")
        launches[kernel] = counts[kernel]
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
    return launches, objects


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


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=int, default=131072,
                   help="synthetic cluster objects (131,072 = 4 chunks; up "
                        "to 1,000,000)")
    args = p.parse_args()
    if not 0 < args.objects <= 1_000_000:
        raise SystemExit("--objects must be in 1..1,000,000")
    device_phase()
    rows = kernel_phase()
    launches, objects = path_phase(args.objects)
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
