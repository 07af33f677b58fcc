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
3. path: the library audit sweep (all 46 templates of ``library/``, 44
   Rego and 2 CEL, each with its sample constraint; every template must
   lower to the device grid; ``--objects`` synthetic cluster objects,
   chunks of 32,768, 20 kept violations per constraint) through
   ``AuditManager.audit()`` on the card, once per collect lane: both lanes
   must agree, each fold kernel must have been launched by its lane, the
   rows of both CEL kinds must have ridden at least one of those launches
   and each CEL constraint must have violations, and a CPU run of the port
   (plain versions) must equal the card's run on the first 8,192 objects;
4. shapes: at every distinct (C, N, k) that the path launched a kernel
   with, both kernels held bit for bit against their plain versions on an
   edge grid and on a random grid, then timed;
5. profile: the reduced-lane audit once more under ``torch.profiler``,
   for the device's busy share of the audit wall and its top kernels;
6. admission: the library (all 46 templates and their sample
   constraints, the Ingresses of the traffic synced as inventory) served
   by the port's
   ``WebhookServer`` on 127.0.0.1 with ``TorchDriver(device="cuda")``, a
   ``Batcher`` at its default window, batch size and interpreter cut-off
   (with batch stats on) and failurePolicy=Fail.  ``--admissions``
   AdmissionReview bodies (the library's ``samples/example_*.yaml``
   objects, then ``make_cluster_objects(..., seed=3)``; every tenth an
   UPDATE that carries an ``oldObject``, every twentieth of the others a
   DELETE whose ``object`` is null and whose ``oldObject`` is the object)
   are posted by 64 keep-alive clients in 8 load processes.  Every
   response must equal the port's in-process handler on the CPU without a
   batcher (the exact engines: the CEL evaluator and the Rego
   interpreter); the deny message is compared as its set of lines, since
   that handler lists CEL results before Rego ones and the grid lane
   lists them by constraint kind, as in the JAX package.  No answer may
   have code 500, the grid lane must have run, the CEL DELETE route of
   ``query_batch`` must have run on the card, CEL constraints must have
   hit in grid batches and ``query_batch`` must not have raised.  Prints
   admissions/s, p50/p99 latency, the batch-size histogram, the lane
   counts, the DELETE count, the CEL hits per grid batch and the medians
   of the grid batches' ``flattenNS``/``batchEvalNS``/``totalNS``;
7. report: a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import http.client
import json
import multiprocessing
import statistics
import threading
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate (data sheet)
# the library's two CEL (K8sNativeValidation) templates
CEL_TEMPLATE_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
C_MAIN, N_MAIN, K_MAIN = 44, 32768, 20
CPU_PREFIX = 8192
GRAPH_CALLS = 20    # back-to-back calls captured in one CUDA graph
GRAPH_REPLAYS = 25  # timed replays of that graph (median taken)
LOAD_PROCS, LOAD_CONNS = 8, 8  # 64 keep-alive clients in 8 processes


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


def _client(objects, device: str = "cuda"):
    """(client, driver, templates, constraints) as the CLI builds them:
    a ``TorchDriver`` with a ``CELDriver`` beside it, the whole library
    loaded, every template lowered."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.synthetic import load_library

    cel = CELDriver()
    driver = TorchDriver(device=device, cel_driver=cel)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    nt, nc = load_library(client)
    if driver.fallback_kinds():
        raise AssertionError(
            f"templates fell back to the interpreter: "
            f"{driver.fallback_kinds()}")
    if driver._cel_kinds != set(CEL_TEMPLATE_KINDS):
        raise AssertionError(f"CEL kinds {sorted(driver._cel_kinds)}")
    for o in objects:
        if o.get("kind") == "Ingress":
            client.add_data(o)  # referential inventory (uniqueingresshost)
    return client, driver, nt, nc


def audit(objects, device: str, collect: str, dispatches=None) -> tuple:
    """One library audit through the port's entry points: (run, phases,
    seconds).  ``dispatches`` (a list) receives (kinds, C, padded N) of
    every device dispatch of the sweep; each launches one fold kernel."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    if dispatches is not None:
        dispatch = evaluator.sweep_dispatch

        def recorded_dispatch(flat):
            if getattr(flat, "kinds", None):
                dispatches.append((flat.kinds, sum(
                    len(flat.by_kind[k]) for k in flat.kinds), flat.pad_n))
            return dispatch(flat)

        evaluator.sweep_dispatch = recorded_dispatch
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
        dispatches: list = []
        for wrapper in (fold.fused_fold, fold.epilogue):
            wrapper.launches = 0
            wrapper.shapes.clear()
        run, phases, dt = audit(objects, "cuda", collect, dispatches)
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
        # the CEL rows ride the fold launches of their kind group
        with_cel = [(c, n) for kinds, c, n in dispatches
                    if set(CEL_TEMPLATE_KINDS) <= set(kinds)]
        if len(dispatches) != counts[kernel] or not with_cel:
            raise AssertionError(
                f"audit[{collect}]: {len(dispatches)} dispatches for "
                f"{counts[kernel]} {kernel} launches, {len(with_cel)} with "
                f"both CEL kinds")
        cel_totals = {f"{kind}/{name}": v for (kind, name), v in
                      sorted(run.total_violations.items())
                      if kind in CEL_TEMPLATE_KINDS}
        log(f"audit[{collect}]: {len(with_cel)} of {len(dispatches)} "
            f"{kernel} launches carry both CEL kinds' rows at (C, N) "
            f"{sorted(set(with_cel))}; CEL constraint totals {cel_totals}")
        if len(cel_totals) != len(CEL_TEMPLATE_KINDS) or \
                min(cel_totals.values()) <= 0:
            raise AssertionError(f"audit[{collect}]: a CEL constraint has "
                                 f"no violations: {cel_totals}")
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


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_events(prof) -> list:
    """Device-side events only (kernels, memcpy, memset): the aten ops
    that launched them carry the same time again."""
    return [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]


def profile_phase(objects) -> None:
    """Device busy time of one reduced-lane audit (sum of the device
    events' self time; one stream, so they do not overlap) against its wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run, _phases, wall = audit(objects, "cuda", "reduced")
    events = _device_events(prof)
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


def admission_body(obj: dict, uid: str, old: dict = None,
                   delete: bool = False) -> dict:
    """An AdmissionReview for ``obj`` as the apiserver sends it: CREATE,
    UPDATE when ``old`` (the oldObject) is given, or DELETE (``object``
    null, ``oldObject`` the object)."""
    group, _, version = obj.get("apiVersion", "").rpartition("/")
    meta = obj.get("metadata") or {}
    req = {"uid": uid, "operation": "CREATE" if old is None else "UPDATE",
           "kind": {"group": group, "version": version,
                    "kind": obj.get("kind", "")},
           "name": meta.get("name", ""),
           "namespace": meta.get("namespace", ""),
           "userInfo": {"username": "kubernetes-admin",
                        "groups": ["system:masters"]},
           "object": obj}
    if delete:
        req.update(operation="DELETE", object=None, oldObject=obj)
    elif old is not None:
        req["oldObject"] = old
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}


def admission_traffic(n: int) -> tuple:
    """(bodies, objects): the library's sample objects, then synthetic
    cluster objects, ``n`` in all; every tenth body is an UPDATE whose
    oldObject differs (a Pod's service account, else a label), and every
    twentieth of the other bodies a DELETE."""
    import glob
    import os

    from gatekeeper_tpu_torch.utils.synthetic import (library_dir,
                                                      make_cluster_objects)
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    samples = []
    for path in sorted(glob.glob(os.path.join(
            library_dir(), "*", "*", "samples", "example_*.yaml"))):
        samples.extend(d for d in load_yaml_file(path) if isinstance(d, dict))
    objects = (samples + make_cluster_objects(max(0, n - len(samples)),
                                              seed=3))[:n]
    bodies = []
    others = 0  # non-UPDATE bodies so far
    for i, obj in enumerate(objects):
        old = None
        delete = False
        if i % 10 != 9:
            others += 1
            delete = others % 20 == 0
        else:
            old = copy.deepcopy(obj)
            if obj.get("kind") == "Pod":
                old.setdefault("spec", {})["serviceAccountName"] = "prior-sa"
            else:
                old.setdefault("metadata", {}).setdefault(
                    "labels", {})["revision"] = "prior"
        bodies.append(admission_body(obj, f"adm-{i}", old, delete))
    return bodies, objects


def _load_worker(port: int, share: list, conns: int, barrier,
                 results) -> None:
    """One load process: ``conns`` threads, each posting its part of
    ``share`` ([(index, body bytes)]) over one keep-alive connection, one
    request at a time.  Puts [(index, latency s, status, reply bytes)]."""
    out = []
    lock = threading.Lock()

    def client(part):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for idx, data in part:
                t0 = time.perf_counter()
                conn.request("POST", "/v1/admit", body=data, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                reply = resp.read()
                dt = time.perf_counter() - t0
                with lock:
                    out.append((idx, dt, resp.status, reply))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(share[c::conns],))
               for c in range(conns)]
    barrier.wait(timeout=300)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results.put(out)


def post_concurrently(port: int, bodies: list) -> tuple:
    """Post every body from LOAD_PROCS processes x LOAD_CONNS keep-alive
    connections.  Returns (replies by index, latencies s, wall s)."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(LOAD_PROCS + 1)
    results = ctx.Queue()
    items = [(i, json.dumps(b).encode()) for i, b in enumerate(bodies)]
    procs = [ctx.Process(target=_load_worker,
                         args=(port, items[p::LOAD_PROCS], LOAD_CONNS,
                               barrier, results), daemon=True)
             for p in range(LOAD_PROCS)]
    for proc in procs:
        proc.start()
    try:
        barrier.wait(timeout=300)
        t0 = time.perf_counter()
        rows = []
        for _ in procs:  # drain the queue before joining the writers
            rows.extend(results.get(timeout=600))
        wall = time.perf_counter() - t0
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    replies = {}
    for idx, _dt, status, reply in rows:
        if status != 200:
            raise AssertionError(f"admission {idx}: HTTP {status}")
        replies[idx] = json.loads(reply)["response"]
    if len(replies) != len(bodies):
        raise AssertionError(f"{len(replies)} of {len(bodies)} answered")
    return replies, [r[1] for r in rows], wall


def _answer(resp: dict) -> tuple:
    status = resp.get("status") or {}
    return (resp["allowed"], status.get("code", 200),
            status.get("message", ""), sorted(resp.get("warnings") or []))


def _unordered(answer: tuple) -> tuple:
    """An answer with its deny message as the sorted list of its lines
    (one line per violated constraint)."""
    allowed, code, message, warnings = answer
    return allowed, code, sorted(message.split("\n")), warnings


def profile_grid_batch(client, bodies, namespaces) -> None:
    """One grid-lane batch (``client.review_batch``, as the batcher calls
    it) under ``torch.profiler``: the device's busy time beside the
    batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from gatekeeper_tpu_torch.apis.constraints import WEBHOOK_EP
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedReview
    from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

    reviews = []
    for body in bodies:
        req = parse_admission_review(copy.deepcopy(body))
        reviews.append(AugmentedReview(
            admission_request=req, namespace=namespaces.get(req.namespace),
            source=SOURCE_ORIGINAL, is_admission=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.review_batch(reviews, enforcement_point=WEBHOOK_EP)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    if not events:
        log("admission profile: the profiler reported no device events; "
            "device busy time not measured")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:4]
    log(f"admission profile: one grid batch of {len(reviews)}, wall "
        f"{wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.4f}; top: " + "; ".join(
            f"{e.key[:50]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
            for e in top))


def admission_phase(n: int, card: str, device: str = "cuda") -> dict:
    """Serve ``n`` admissions through the port's webhook on ``device``
    and hold every answer against the CPU exact-interpreter handler."""
    from gatekeeper_tpu_torch.__main__ import warm_batcher
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import (WebhookServer,
                                                     admission_response)

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    client, driver, nt, nc = _client(objects, device=device)
    batcher = Batcher(client, stats=True).start()
    t0 = time.perf_counter()
    warm_batcher(client, batcher)
    log(f"admission: {nt} templates, {nc} constraints, {n} bodies; warm "
        f"{time.perf_counter() - t0:.3f}s")
    grid_stats: list = []
    errors: list = []
    cel_hits: list = []  # per grid batch: results of the CEL constraints
    delete_route: list = []  # CEL evaluations of DELETE reviews in batches
    in_batch = threading.local()
    query_batch = driver.query_batch
    cel_query = driver._cel.query

    def counted_cel_query(target, constraints, review, cfg=None):
        if getattr(in_batch, "on", False) and \
                review.request.operation == "DELETE":
            delete_route.append(len(constraints))
        return cel_query(target, constraints, review, cfg)

    def counted_query_batch(*args, **kwargs):
        in_batch.on = True
        try:
            out = query_batch(*args, **kwargs)
        except Exception as e:
            errors.append(repr(e))
            raise
        finally:
            in_batch.on = False
        for entry in out[0].stats_entries if out else ():
            grid_stats.append({s.name: s.value for s in entry.stats})
        cel_hits.append(sum(r.constraint.get("kind") in CEL_TEMPLATE_KINDS
                            for qr in out for r in qr.results))
        return out

    driver.query_batch = counted_query_batch
    driver._cel.query = counted_cel_query
    driver.perf.clear()
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, namespace_lookup=namespaces.get, batcher=batcher,
            failure_policy="fail"),
        namespace_label_handler=NamespaceLabelHandler(),
        host="127.0.0.1", port=0, batcher=batcher).start()
    try:
        replies, lat, wall = post_concurrently(server.port, bodies)
    finally:
        drained = server.stop()
    driver.query_batch = query_batch
    driver._cel.query = cel_query
    lanes = dict(batcher.lane_counts)
    sizes = dict(sorted(batcher.batch_sizes.items()))
    n_delete = sum(b["request"]["operation"] == "DELETE" for b in bodies)
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {
        "admissions": n, "wall_s": wall, "admissions_per_s": n / wall,
        "p50_ms": lat_ms[len(lat_ms) // 2],
        "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
        "lanes": lanes, "batch_sizes": sizes,
        "grid_batches": len(grid_stats),
        "d2h_bytes": driver.perf.get("d2h_bytes", 0.0),
        "deletes": n_delete, "cel_delete_evaluations": len(delete_route),
        "cel_hits_per_grid_batch": cel_hits,
    }
    for name in ("flattenNS", "batchEvalNS", "totalNS"):
        vals = [g[name] for g in grid_stats]
        out[f"median_{name}"] = statistics.median(vals) if vals else None
    log(f"admission: {n} admissions in {wall:.3f}s, "
        f"{out['admissions_per_s']:.1f} admissions/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms "
        f"({LOAD_PROCS * LOAD_CONNS} keep-alive clients), {card}")
    log(f"admission: lanes {lanes}, batch sizes {sizes}")
    log(f"admission: {n_delete} DELETE bodies; {len(delete_route)} CEL "
        f"evaluations of DELETE reviews inside grid batches (the CEL "
        f"DELETE route); CEL hits per grid batch {cel_hits} "
        f"({sum(cel_hits)} in all)")
    log("admission: grid batch medians (ns): " + json.dumps(
        {k: out[f"median_{k}"] for k in ("flattenNS", "batchEvalNS",
                                         "totalNS")})
        + f", {out['grid_batches']} grid batches, d2h "
        f"{out['d2h_bytes']:.0f} bytes")

    if device == "cuda":
        profile_grid_batch(client, bodies[:batcher.max_batch], namespaces)
    ref_client = _client(objects, device="cpu")[0]
    ref = ValidationHandler(ref_client, namespace_lookup=namespaces.get,
                            failure_policy="fail")
    t0 = time.perf_counter()
    diffs, denied, code500, reordered = [], 0, 0, 0
    for i, body in enumerate(bodies):
        v = ref.handle(copy.deepcopy(body))
        want = _answer(admission_response(v.uid, v.allowed, v.message,
                                          v.code, v.warnings)["response"])
        got = _answer(replies[i])
        denied += not got[0]
        code500 += got[1] == 500
        reordered += got != want
        if _unordered(got) != _unordered(want):
            diffs.append((i, got, want))
    log(f"admission: cpu reference handler {time.perf_counter() - t0:.3f}s; "
        f"{denied} denied, {len(diffs)} differ, {code500} with code 500, "
        f"{reordered} with the deny lines in another order")
    if errors:
        raise AssertionError(f"query_batch raised: {errors[:3]}")
    if diffs:
        raise AssertionError(f"served answers differ from the CPU handler, "
                             f"first: {diffs[:2]}")
    if code500 or not lanes.get("grid") or not grid_stats:
        raise AssertionError(f"admission not sane: {code500} code-500 "
                             f"answers, lanes {lanes}")
    if not delete_route or not sum(cel_hits):
        raise AssertionError(
            f"admission: the CEL DELETE route ran {len(delete_route)} "
            f"times, CEL constraints hit {sum(cel_hits)} times in grid "
            f"batches")
    if not drained or denied == 0:
        raise AssertionError("admission: server did not drain, or nothing "
                             "was denied")
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=int, default=131072,
                   help="synthetic cluster objects (131,072 = 4 chunks; up "
                        "to 1,000,000)")
    p.add_argument("--admissions", type=int, default=4096,
                   help="AdmissionReviews served in the admission phase")
    args = p.parse_args()
    if not 0 < args.objects <= 1_000_000:
        raise SystemExit("--objects must be in 1..1,000,000")
    if args.admissions < 1:
        raise SystemExit("--admissions must be positive")
    card = device_phase()["card"]
    rows, err = kernel_phase()
    launches, shapes, objects = path_phase(args.objects)
    shape_phase(rows, err, shapes)
    profile_phase(objects)
    del objects
    admission_phase(args.admissions, card)
    log(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
