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
5. snapshot: the same objects and templates through the resident
   snapshot (``--audit-source snapshot``): per collect lane a
   ``FakeCluster``, a ``ClusterSnapshot``, a ``WatchIngester`` and
   ``DeviceResidency(mode="auto")`` on the card; (1) a first ``audit()``
   (builds, uploads, evaluates), (2) a second full ``audit()`` from
   resident columns only (repeated under ``torch.profiler`` for the
   device's idle share), (3) a clean ``audit_tick()``, (4) a 1% churn
   (label edits, ``privileged: true`` on some Pods, deletes and adds)
   pumped and ticked; on the reduced lane one more resident dispatch of a
   gathered chunk with ``return_bits=False``, which launches
   ``fused_fold``.  Every lowered group must be promoted, no resident
   chunk may take the host-column path, steps 1 and 2 must equal the path
   phase's relist run canonically, the repeat of step 2 must upload 0
   bytes, the dirty tick must evaluate only dirty rows and upload under 5%
   of the resident bytes, and the card must equal a CPU snapshot run
   (``mode="on"``) on the first 8,192 objects, step by step, where (5)
   ``audit_resync()`` runs after the churn tick and must find no
   difference on either device (the resync runs at that depth, not at the
   full one: at 131,072 objects it took ~44 s per lane).  Prints each
   step's wall, objects/s,
   snapshot-build (flatten), residency upload/patch and dispatch seconds,
   resident MB and uploaded bytes, and the rows patched;
6. expand: the same objects and templates with the mutation bench's 8
   mutators (6 the prefilter lowers, 2 host-only) and the reference's
   ``expand-deployments`` ExpansionTemplate, audited with
   ``--audit-expand``: every Deployment's implied Pod expands through the
   batched stage (mutated with ``Source=Generated``) and is audited on the
   card.  Relist on both collect lanes: the generated chunks must launch
   ``fused_fold`` (reduced) and ``epilogue`` (masks), counted inside the
   generator stage only; the implied Pods must add violations to the path
   phase's totals and no total may fall; both lanes must agree.  Then a
   resident-snapshot first pass, which must equal the relist canonically
   and hold ``[Implied by expand-deployments]`` violations in its
   generated verdicts, and a 1% churn tick.  The card must equal a CPU run
   on the first 8,192 objects.  Prints each pass's wall, generators,
   resultants, and the expand and generated-sweep seconds;
7. shapes (after the snapshot and expand phases): as phase 4, at the
   (C, N, k) the snapshot and expand paths launched too;
8. profile: the reduced-lane audit once more under ``torch.profiler``,
   for the device's busy share of the audit wall and its top kernels;
9. admission: the library (all 46 templates and their sample
   constraints, the Ingresses of the traffic synced as inventory) served
   by the port's
   ``WebhookServer`` on 127.0.0.1 with ``TorchDriver(device="cuda")``, a
   ``Batcher`` at its default window, batch size and interpreter cut-off
   (with batch stats on), failurePolicy=Fail and the
   ``ExpansionSystem`` of the expand phase (each Deployment body's implied
   Pod reviewed with ``Source=Generated``).  ``--admissions``
   AdmissionReview bodies (the library's ``samples/example_*.yaml``
   objects, then ``make_cluster_objects(..., seed=3)``; every tenth an
   UPDATE that carries an ``oldObject``, every twentieth of the others a
   DELETE whose ``object`` is null and whose ``oldObject`` is the object)
   are posted by 64 keep-alive clients in 8 load processes.  Every
   response must equal the port's in-process handler on the CPU without a
   batcher (the exact engines: the CEL evaluator and the Rego
   interpreter) and with the same expansion system, and some must carry
   ``[Implied by expand-deployments]`` lines; the deny message is compared as its set of lines, since
   that handler lists CEL results before Rego ones and the grid lane
   lists them by constraint kind, as in the JAX package.  No answer may
   have code 500, the grid lane must have run, the CEL DELETE route of
   ``query_batch`` must have run on the card, CEL constraints must have
   hit in grid batches and ``query_batch`` must not have raised.  Prints
   admissions/s, p50/p99 latency, the batch-size histogram, the lane
   counts, the DELETE count, the CEL hits per grid batch and the medians
   of the grid batches' ``flattenNS``/``batchEvalNS``/``totalNS``;
10. served: the served process's two threads on one driver and vocab, as
   ``python -m gatekeeper_tpu_torch --audit-source snapshot --port ...``
   runs them (``__main__.build_audit`` and ``start_audit_loop``): the
   webhook answers up to 512 of the admission bodies (cut from 1,024 so
   the whole run stays well inside its time limit) while the snapshot
   audit loop ticks and resyncs over a ``FakeCluster`` of 4,096 objects
   that churns meanwhile.  Every answer must equal the CPU handler, at
   least one tick and one resync must overlap the burst, no resync may
   take an admission's new strings for its own, a final resync must find
   no difference, the vocab must stay a bijection, every lowered group
   must be resident and no chunk may take the host-column path;
11. mutate: the admission bodies posted to ``/v1/mutate`` of a
   ``WebhookServer`` on the card (the batched ``MutationLane`` behind a
   ``MutationBatcher``, the bench's 8 mutators) by 64 keep-alive clients in
   8 processes.  Every answer must equal the per-object
   ``MutationHandler`` on the CPU, patch bytes included.  Then
   ``MutationSystem.mutate_batch`` over the same objects on the card (the
   6 lowered mutators, so the grids decide) must equal per-object
   ``mutate``, with rows decided by the compiled program.  Prints
   mutations/s, p50/p99, the outcome-lane histogram and the relevance
   rows' wall time through ``CompiledProgram.run`` on the card against the
   host ``_np_eval`` at bursts of 64 and 4,096.  (``/v1/admit`` with the
   expansion system is served and held in the admission phase);
12. report: a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}``
   last.
   ``launches`` counts the relist path's launches, ``snapshot_launches``
   the snapshot path's, ``expand_launches`` those inside the generator
   stage of the expand phase.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import copy
import gc
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
CHURN_SHARE = 0.01  # of the objects, per dirty tick of the snapshot phase
GRAPH_CALLS = 20    # back-to-back calls captured in one CUDA graph
GRAPH_REPLAYS = 25  # timed replays of that graph (median taken)
LOAD_PROCS, LOAD_CONNS = 8, 8  # 64 keep-alive clients in 8 processes
SERVED_ADMISSIONS, SERVED_OBJECTS = 512, 4096  # the served phase's sizes


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
                f"{launches} launches on the relist, snapshot and expand "
                f"paths, plan "
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
    runs = {}
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
        runs[collect] = run
    if results["reduced"] != results["masks"]:
        raise AssertionError("reduced and masks lanes disagree")
    prefix = objects[:CPU_PREFIX]
    on_card = summary(audit(prefix, "cuda", "reduced")[0])
    on_cpu = summary(audit(prefix, "cpu", "reduced")[0])
    if on_card != on_cpu:
        raise AssertionError("CPU run of the port differs from the card's")
    log(f"cpu == cuda on the first {CPU_PREFIX} objects "
        f"({sum(on_cpu[1].values())} violations)")
    return launches, shapes, objects, runs


def snapshot_churn(objects, n: int, seed: int = 5) -> list:
    """``n`` watch operations over ``objects`` (as ("apply"|"delete",
    obj)): half label edits, a quarter ``privileged: true`` on a Pod's
    first container (verdicts flip), an eighth deletes, an eighth new
    Pods.  Distinct objects per operation; made from ``seed``."""
    rng = np.random.default_rng(seed)
    n_priv, n_del, n_add = n // 4, n // 8, n // 8
    n_lab = n - n_priv - n_del - n_add
    order = rng.permutation(len(objects)).tolist()
    pods = [i for i in order if objects[i].get("kind") == "Pod"
            and (objects[i].get("spec") or {}).get("containers")]
    priv = set(pods[:n_priv])
    rest = [i for i in order if i not in priv]
    ops = []
    for i in rest[:n_lab]:
        o = copy.deepcopy(objects[i])
        o.setdefault("metadata", {}).setdefault("labels", {})["churn"] = \
            f"tick-{seed}"
        ops.append(("apply", o))
    for i in sorted(priv):
        o = copy.deepcopy(objects[i])
        o["spec"]["containers"][0].setdefault(
            "securityContext", {})["privileged"] = True
        ops.append(("apply", o))
    for i in rest[n_lab: n_lab + n_del]:
        ops.append(("delete", copy.deepcopy(objects[i])))
    for j, i in enumerate(pods[n_priv: n_priv + n_add]):
        o = copy.deepcopy(objects[i])
        o["metadata"]["name"] = f"churn-add-{seed}-{j}"
        ops.append(("apply", o))
    return ops


def snapshot_world(objects, device: str, collect: str, mode: str):
    """(manager, cluster, ingester, residency, snapshot, evaluator): the
    CLI's ``--audit-source snapshot`` stack over ``objects``, with the
    path phase's audit settings."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    cluster = FakeCluster()
    for o in objects:
        cluster.apply(o)
    snap = ClusterSnapshot(evaluator, SnapshotConfig())
    ingester = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
    residency = DeviceResidency(evaluator, mode=mode)
    mgr = AuditManager(client, lister=cluster.list,
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4,
                                          audit_source="snapshot"),
                       evaluator=evaluator, snapshot=snap,
                       residency=residency)
    return mgr, cluster, ingester, residency, snap, evaluator


def _timed(obj, name: str, acc: dict) -> None:
    """Wrap ``obj.name`` so its wall seconds add up in ``acc[name]``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def _churn_apply(cluster, ops) -> None:
    for op, obj in ops:
        (cluster.apply if op == "apply" else cluster.delete)(obj)


def snapshot_lane(objects, relist_run, collect: str, card: str,
                  device: str = "cuda") -> dict:
    """Steps 1-5 of the snapshot phase on one collect lane, on ``device``
    (residency ``auto`` on the card; ``on`` for a CPU rehearsal)."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    mgr, cluster, ingester, residency, snap, ev = snapshot_world(
        objects, device, collect, "auto" if device == "cuda" else "on")
    if not residency.available():
        raise AssertionError("residency declined on the card")
    acc: dict = {}
    _timed(snap, "rebuild", acc)
    _timed(residency, "_upload", acc)
    _timed(residency, "_patch", acc)
    n_churn = max(8, int(len(objects) * CHURN_SHARE))
    ops = snapshot_churn(objects, n_churn)
    out = {"steps": {}}
    try:
        def step(name, fn, churn=None):
            acc.clear()
            perf0 = dict(ev.perf)
            patched0 = residency.patched_rows
            t0 = time.perf_counter()
            run = fn()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = {k: ev.perf.get(k, 0.0) - perf0.get(k, 0.0)
                 for k in ("dispatch", "upload", "collect")}
            rec = {"wall_s": wall,
                   "objects_per_s": run.total_objects / wall,
                   "rows": mgr.perf.get("last_rows_evaluated", 0.0),
                   "h2d_bytes": mgr.perf.get("tick_h2d_bytes", 0.0),
                   "resident_mb": residency.resident_bytes() / 1e6,
                   "rows_patched": residency.patched_rows - patched0,
                   "build_s": acc.get("rebuild", 0.0),
                   "residency_upload_s": acc.get("_upload", 0.0),
                   "residency_patch_s": acc.get("_patch", 0.0),
                   "dispatch_s": d["dispatch"], "tables_s": d["upload"],
                   "collect_s": d["collect"],
                   "violations": sum(run.total_violations.values())}
            out["steps"][name] = rec
            log(f"snapshot[{collect}] {name}: {run.total_objects} objects, "
                f"{rec['violations']} violations, {wall:.3f}s, "
                f"{rec['objects_per_s']:.1f} objects/s, "
                f"{rec['rows']:.0f} rows evaluated, h2d "
                f"{rec['h2d_bytes']:.0f} bytes, resident "
                f"{rec['resident_mb']:.3f} MB, {rec['rows_patched']} rows "
                f"patched; build (flatten) {rec['build_s']:.3f}s, residency "
                f"upload {rec['residency_upload_s']:.3f}s / patch "
                f"{rec['residency_patch_s']:.3f}s, dispatch "
                f"{rec['dispatch_s']:.3f}s, tables {rec['tables_s']:.3f}s, "
                f"collect {rec['collect_s']:.3f}s ({card})")
            if run.incomplete:
                raise AssertionError(f"snapshot[{collect}] {name}: "
                                     f"incomplete run")
            return run, rec

        run1, _ = step("1 build+upload+audit", mgr.audit)
        run2, rec2 = step("2 resident audit", mgr.audit)
        for label, run in (("1", run1), ("2", run2)):
            diff = AuditManager._verdicts_differ_canonical(
                run.kept, run.total_violations, relist_run.kept,
                relist_run.total_violations, 20)
            if diff is not None or run.total_objects != len(objects):
                raise AssertionError(f"snapshot[{collect}] step {label} "
                                     f"differs from the relist run: {diff}")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _run2b, rec2b = step("2 repeated, profiled", mgr.audit)
        if rec2b["h2d_bytes"] != 0:
            raise AssertionError(f"snapshot[{collect}]: the repeat of step "
                                 f"2 uploaded {rec2b['h2d_bytes']} bytes")
        events = _device_events(prof)
        if events:
            busy_ms = sum(dev_us(e) for e in events) / 1e3
            idle = 1 - busy_ms / (rec2b["wall_s"] * 1e3)
            out["idle_share"] = idle
            top = sorted(events, key=dev_us, reverse=True)[:5]
            log(f"snapshot[{collect}] profile of step 2: wall "
                f"{rec2b['wall_s'] * 1e3:.1f} ms (profiled), device busy "
                f"{busy_ms:.3f} ms, idle share {idle:.4f}; top: "
                + "; ".join(f"{e.key[:50]} x{e.count} "
                            f"{dev_us(e) / 1e3:.3f} ms" for e in top))
        else:
            log(f"snapshot[{collect}] profile: the profiler reported no "
                f"device events; idle share not measured")
        _run3, rec3 = step("3 clean tick", mgr.audit_tick)
        if rec3["rows"] != 0 or rec3["h2d_bytes"] != 0:
            raise AssertionError(f"snapshot[{collect}]: the clean tick "
                                 f"evaluated {rec3['rows']} rows")
        _churn_apply(cluster, ops)
        ingester.pump()
        dirty = snap.dirty_count()
        _run4, rec4 = step(f"4 churn tick ({len(ops)} operations)",
                           mgr.audit_tick)
        resident = residency.resident_bytes()
        if not 0 < rec4["rows"] <= dirty or rec4["rows"] > len(ops):
            raise AssertionError(f"snapshot[{collect}]: the churn tick "
                                 f"evaluated {rec4['rows']} rows for "
                                 f"{dirty} dirty")
        if not 0 < rec4["h2d_bytes"] < 0.05 * resident:
            raise AssertionError(f"snapshot[{collect}]: the churn tick "
                                 f"uploaded {rec4['h2d_bytes']} of "
                                 f"{resident} resident bytes")
        lowered = [s for s in snap.routed_stores() if s.lowered]
        promoted = sum(residency.is_resident(s) for s in lowered)
        host_chunks = mgr.perf.get("snapshot_host_chunks", 0.0)
        log(f"snapshot[{collect}]: {promoted} of {len(lowered)} lowered "
            f"groups resident, "
            f"{mgr.perf.get('snapshot_resident_chunks', 0.0):.0f} resident "
            f"chunks, {host_chunks:.0f} host-column chunks, residency "
            f"{residency.stats()}")
        if promoted != len(lowered) or not lowered or host_chunks:
            raise AssertionError(f"snapshot[{collect}]: a group served "
                                 f"host columns")
        out["direct"] = None
        if collect == "reduced":
            # one budgeted resident dispatch: fused_fold on a gathered
            # chunk (snapshot passes take the complete variant)
            store = max(lowered, key=lambda s: s.live_count)
            rg = residency.prepare(store)
            positions = store.live_positions()[:32768]
            got = ev.sweep_collect(ev.sweep_dispatch(
                ev.sweep_flatten_resident(rg, positions,
                                          return_bits=False)))
            out["direct"] = (store, positions, got)
        out["churn_violations"] = rec4["violations"]
        return out
    finally:
        ingester.stop()


def snapshot_cpu_equal(objects) -> None:
    """The card's snapshot lane equals a CPU snapshot run on ``objects``,
    step by step (full pass, resident pass, churn tick, resync), and each
    resync finds no difference."""
    sums = {}
    for device, mode in (("cuda", "auto"), ("cpu", "on")):
        mgr, cluster, ingester, residency, _snap, _ev = snapshot_world(
            objects, device, "reduced", mode)
        try:
            got = [summary(mgr.audit()), summary(mgr.audit())]
            _churn_apply(cluster, snapshot_churn(
                objects, max(8, int(len(objects) * CHURN_SHARE))))
            ingester.pump()
            got.append(summary(mgr.audit_tick()))
            got.append(summary(mgr.audit_resync()))
            if mgr.last_resync_diff is not None:
                raise AssertionError(f"snapshot on {device}: resync "
                                     f"differs: {mgr.last_resync_diff}")
        finally:
            ingester.stop()
        if not residency.upload_count:
            raise AssertionError(f"snapshot on {device}: nothing resident")
        sums[device] = got
    if sums["cuda"] != sums["cpu"]:
        raise AssertionError("snapshot: the CPU run differs from the card's")
    log(f"snapshot: cpu == cuda on the first {len(objects)} objects, step "
        f"by step ({[sum(s[1].values()) for s in sums['cpu']]} violations), "
        f"resync diff None on both")


def snapshot_phase(objects, relist_runs, card: str,
                   device: str = "cuda") -> tuple:
    """The resident snapshot on both collect lanes: (launches, shapes) of
    the fold kernels over the snapshot path's runs, and each lane's steps.
    ``device="cpu"`` rehearses it without the card (and without the
    card-against-CPU comparison)."""
    from gatekeeper_tpu_torch.ops import fold

    launches, shapes, direct = {}, {}, None
    for wrapper in (fold.fused_fold, fold.epilogue):
        wrapper.launches = 0
        wrapper.shapes.clear()
    results = {}
    for collect in ("reduced", "masks"):
        out = snapshot_lane(objects, relist_runs[collect], collect, card,
                            device)
        results[collect] = out
        if out["direct"] is not None:
            direct = out["direct"]
    for name in ("fused_fold", "epilogue"):
        wrapper = getattr(fold, name)
        launches[name] = wrapper.launches
        shapes[name] = dict(wrapper.shapes)
    log(f"snapshot: launches {launches}, shapes {shapes}")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"snapshot path: a fold kernel never "
                             f"launched: {launches}")
    # the direct resident dispatch against a host-column dispatch of the
    # same rows (after the count was read)
    store, positions, got = direct
    ev = store.evaluator
    batch = store.slice_rows(positions, ev._pad(len(positions)))
    want = ev.sweep_collect(ev.sweep_dispatch(ev.sweep_flatten_from_batch(
        store.cons, batch, [store.row_obj(p) for p in positions],
        return_bits=False, alias=store.alias)))
    for kind in want:
        for a, b in zip(got[kind][1:4], want[kind][1:4]):
            if not np.array_equal(a, b):
                raise AssertionError(f"resident fused_fold dispatch of "
                                     f"{kind} differs from host columns")
    log(f"snapshot: the budgeted resident dispatch of {len(positions)} rows "
        f"equals the host-column dispatch ({len(want)} kinds)")
    if results["reduced"]["churn_violations"] != \
            results["masks"]["churn_violations"]:
        raise AssertionError("snapshot: reduced and masks lanes disagree")
    if device == "cuda":
        snapshot_cpu_equal(objects[:CPU_PREFIX])
    return launches, shapes, {c: {k: v for k, v in r.items()
                                  if k != "direct"}
                              for c, r in results.items()}


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
                 results, path: str = "/v1/admit") -> None:
    """One load process: ``conns`` threads, each posting its part of
    ``share`` ([(index, body bytes)]) to ``path`` over one keep-alive
    connection, one request at a time.  Puts [(index, latency s, status,
    reply bytes)]."""
    out = []
    lock = threading.Lock()

    def client(part):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for idx, data in part:
                t0 = time.perf_counter()
                conn.request("POST", path, body=data, headers={
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


def post_concurrently(port: int, bodies: list,
                      path: str = "/v1/admit") -> tuple:
    """Post every body to ``path`` from LOAD_PROCS processes x LOAD_CONNS
    keep-alive connections.  Returns (replies by index, latencies s, wall
    s)."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(LOAD_PROCS + 1)
    results = ctx.Queue()
    items = [(i, json.dumps(b).encode()) for i, b in enumerate(bodies)]
    procs = [ctx.Process(target=_load_worker,
                         args=(port, items[p::LOAD_PROCS], LOAD_CONNS,
                               barrier, results, path), daemon=True)
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


def _held_against_cpu(label: str, objects, namespaces, bodies,
                      replies, expansion_system=None) -> tuple:
    """Hold every served answer against the port's in-process handler on
    the CPU without a batcher (the exact engines), the deny message as its
    set of lines.  Raises on a difference; returns (denied, code 500)."""
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    from gatekeeper_tpu_torch.webhook.server import admission_response

    ref_client = _client(objects, device="cpu")[0]
    # only given when set, so the served A/B tool can drive a checkout
    # whose handler predates expansion
    kw = {} if expansion_system is None else {
        "expansion_system": expansion_system}
    ref = ValidationHandler(ref_client, namespace_lookup=namespaces.get,
                            failure_policy="fail", **kw)
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
    log(f"{label}: cpu reference handler {time.perf_counter() - t0:.3f}s; "
        f"{denied} denied, {len(diffs)} differ, {code500} with code 500, "
        f"{reordered} with the deny lines in another order")
    if diffs:
        raise AssertionError(f"{label}: served answers differ from the CPU "
                             f"handler, first: {diffs[:2]}")
    return denied, code500


def admission_phase(n: int, card: str, device: str = "cuda") -> dict:
    """Serve ``n`` admissions through the port's webhook on ``device``
    and hold every answer against the CPU exact-interpreter handler."""
    from gatekeeper_tpu_torch.__main__ import warm_batcher
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

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
            failure_policy="fail",
            expansion_system=mutation_systems()[1]),
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
    denied, code500 = _held_against_cpu(
        "admission", objects, namespaces, bodies, replies,
        expansion_system=mutation_systems()[1])
    implied = sum(IMPLIED in (r.get("status") or {}).get("message", "")
                  for r in replies.values())
    out["implied_denials"] = implied
    log(f"admission: {implied} answers carry {IMPLIED} lines (the implied "
        f"Pods of Deployment bodies, reviewed with Source=Generated)")
    if not implied:
        raise AssertionError("admission: no implied-Pod denial")
    if errors:
        raise AssertionError(f"query_batch raised: {errors[:3]}")
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


def served_phase(n: int, n_objects: int, card: str,
                 device: str = "cuda") -> dict:
    """The served process's two threads on one driver and vocab, as the
    served CLI in snapshot mode runs them: ``n`` admissions through the
    webhook while the audit loop ticks and resyncs over a churning
    ``FakeCluster`` of ``n_objects`` (``__main__.build_audit`` and
    ``start_audit_loop``).  ``device="cpu"`` rehearses it (residency
    ``on``)."""
    from gatekeeper_tpu_torch.__main__ import (build_audit,
                                               start_audit_loop,
                                               warm_batcher)
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    client, driver, _nt, _nc = _client(objects, device=device)
    cluster_objects = make_cluster_objects(n_objects, seed=9)
    args = argparse.Namespace(
        device=device, constraint_violations_limit=20, collect="reduced",
        audit_interval=0.25, audit_chunk_size=32768,
        audit_source="snapshot", snapshot_resync_every=2,
        snapshot_resync_rotate=0, audit_expand=False,
        snapshot_residency="auto" if device == "cuda" else "on")
    mgr, ingester = build_audit(args, cluster_objects, client, driver)
    cluster = ingester.source
    spans = {"audit": [], "audit_tick": [], "audit_resync": []}
    loop_diffs: list = []  # each loop resync's first difference

    def spanned(name):
        fn = getattr(mgr, name)

        def run():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                spans[name].append((t0, time.perf_counter()))
                if name == "audit_resync":
                    loop_diffs.append(mgr.last_resync_diff)

        setattr(mgr, name, run)

    for name in spans:
        spanned(name)
    ops = snapshot_churn(cluster_objects, max(8, int(n_objects *
                                                     CHURN_SHARE * 4)),
                         seed=6)
    batcher = Batcher(client).start()
    try:
        warm_batcher(client, batcher)
        server = WebhookServer(
            validation_handler=ValidationHandler(
                client, namespace_lookup=namespaces.get, batcher=batcher,
                failure_policy="fail"),
            namespace_label_handler=NamespaceLabelHandler(),
            host="127.0.0.1", port=0, batcher=batcher).start()
    except BaseException:
        batcher.stop()
        ingester.stop()
        raise
    auditor = start_audit_loop(mgr)
    stop_churn = threading.Event()

    def churn():
        for op, obj in ops:
            if stop_churn.wait(0.005):
                return
            (cluster.apply if op == "apply" else cluster.delete)(obj)

    churner = threading.Thread(target=churn, name="churn", daemon=True)
    try:
        deadline = time.monotonic() + 300
        while not spans["audit"]:  # the loop's first pass builds
            if time.monotonic() > deadline or not auditor.is_alive():
                raise AssertionError("served: the audit loop's first pass "
                                     "never ended")
            time.sleep(0.05)
        churner.start()
        t_burst = time.perf_counter()
        replies, lat, wall = post_concurrently(server.port, bodies)
        t_end = time.perf_counter()
    finally:
        stop_churn.set()
        if churner.is_alive():
            churner.join()
        mgr.stop()
        drained = server.stop()
        auditor.join(timeout=600)
        batcher.stop()
    try:
        if auditor.is_alive():
            raise AssertionError("served: the audit loop did not stop")
        during = {name: sum(1 for a, b in sp if a < t_end and b > t_burst)
                  for name, sp in spans.items()}
        mgr.audit_tick()  # what the loop had not pumped yet
        mgr.audit_resync()
        final_diff = mgr.last_resync_diff
        snap, residency = mgr.snapshot, mgr.residency
        lowered = [st for st in snap.routed_stores() if st.lowered]
        promoted = sum(residency.is_resident(st) for st in lowered)
        host_chunks = mgr.perf.get("snapshot_host_chunks", 0.0)
    finally:
        ingester.stop()
    vocab = driver.vocab
    bijection = len(vocab._to_id) == len(vocab._to_str) and all(
        vocab._to_id[st] == i for i, st in enumerate(vocab._to_str))
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"admissions": n, "wall_s": wall, "admissions_per_s": n / wall,
           "p50_ms": lat_ms[len(lat_ms) // 2],
           "p99_ms": lat_ms[min(len(lat_ms) - 1,
                                int(0.99 * len(lat_ms)))],
           "passes_during_burst": during, "churn_operations": len(ops),
           "loop_resync_diffs": [d for d in loop_diffs if d],
           "vocab": len(vocab)}
    log(f"served: {n} admissions in {wall:.3f}s, "
        f"{out['admissions_per_s']:.1f} admissions/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms beside the "
        f"audit loop over {n_objects} objects ({len(ops)} churn "
        f"operations); passes during the burst {during}, in all "
        f"{ {k: len(v) for k, v in spans.items()} }; loop resync "
        f"differences {out['loop_resync_diffs']}; final resync diff "
        f"{final_diff}; {promoted} of {len(lowered)} lowered groups "
        f"resident, {host_chunks:.0f} host-column chunks; vocab "
        f"{len(vocab)} strings, bijection {bijection} ({card})")
    _denied, code500 = _held_against_cpu("served", objects, namespaces,
                                         bodies, replies)
    if not during["audit_tick"] or not during["audit_resync"]:
        raise AssertionError(f"served: the audit loop did not tick and "
                             f"resync during the burst: {during}")
    if any("vocab" in d for d in out["loop_resync_diffs"]):
        raise AssertionError(f"served: a resync took an admission's "
                             f"strings for its own: "
                             f"{out['loop_resync_diffs']}")
    if final_diff is not None or not bijection or code500 or not drained:
        raise AssertionError(f"served: final resync {final_diff}, vocab "
                             f"bijection {bijection}, {code500} code-500 "
                             f"answers, drained {drained}")
    if promoted != len(lowered) or not lowered or host_chunks:
        raise AssertionError("served: a group served host columns")
    return out


# --- mutation and expansion (the mutate and expand phases) -----------------

# the reference's ExpansionTemplate from Gatekeeper's "Validation of
# Workload Resources" docs: a Deployment implies the Pod of its template
EXPAND_DEPLOYMENTS = {
    "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
    "kind": "ExpansionTemplate",
    "metadata": {"name": "expand-deployments"},
    "spec": {"applyTo": [{"groups": ["apps"], "versions": ["v1"],
                          "kinds": ["Deployment"]}],
             "templateSource": "spec.template",
             "generatedGVK": {"group": "", "version": "v1",
                              "kind": "Pod"}},
}
IMPLIED = "[Implied by expand-deployments]"
PREFILTER_BURSTS = (64, 4096)  # bursts the prefilter's two routes are timed at


def _assign(name, location, value, extra=None) -> dict:
    params = {"assign": {"value": value}}
    params.update(extra or {})
    return {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
            "metadata": {"name": name},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Pod"]}],
                     "location": location, "parameters": params}}


def _assign_meta(name, location, value) -> dict:
    return {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
            "kind": "AssignMetadata", "metadata": {"name": name},
            "spec": {"location": location,
                     "parameters": {"assign": {"value": value}}}}


def mutators() -> list:
    """The 8-mutator registry of the JAX package's mutation bench: 6 the
    prefilter lowers (first), 2 host-only (ModifySet, assignIf)."""
    return [
        _assign("pull-policy", "spec.containers[name: *].imagePullPolicy",
                "Always"),
        _assign("host-network", "spec.hostNetwork", False),
        _assign("run-as-nonroot", "spec.securityContext.runAsNonRoot",
                True),
        _assign("priority", "spec.priority", 100),
        _assign_meta("owner-label", "metadata.labels.owner",
                     "platform-team"),
        _assign_meta("audit-ann", "metadata.annotations.audited", "true"),
        {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "ModifySet",
         "metadata": {"name": "topo-keys"},
         "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                               "kinds": ["Service"]}],
                  "location": "spec.topologyKeys",
                  "parameters": {"operation": "merge",
                                 "values": {"fromList": ["zone"]}}}},
        _assign("dns-policy-cond", "spec.dnsPolicy", "ClusterFirst",
                extra={"assignIf": {"in": ["Default"]}}),
    ]


def mutation_systems(registry=None) -> tuple:
    """(MutationSystem, ExpansionSystem) as the CLI loads them from
    manifests: ``registry`` (default: the whole bench registry) and
    ``expand-deployments``."""
    from gatekeeper_tpu_torch.__main__ import build_mutation

    return build_mutation((mutators() if registry is None else registry)
                          + [EXPAND_DEPLOYMENTS])


def _fold_counted(fn, launches: dict, shapes: dict):
    """``fn`` wrapped so the fold kernels' launches and shapes inside its
    calls add up in ``launches``/``shapes`` (the counters are set to 0
    just before each call and read just after)."""
    from gatekeeper_tpu_torch.ops import fold

    def counted(*args, **kwargs):
        for name in launches:
            getattr(fold, name).launches = 0
            getattr(fold, name).shapes.clear()
        try:
            return fn(*args, **kwargs)
        finally:
            for name in launches:
                launches[name] += getattr(fold, name).launches
                shapes[name].update(getattr(fold, name).shapes)

    return counted


def expand_manager(objects, device: str, collect: str, launches=None,
                   shapes=None, source: str = "relist") -> tuple:
    """(manager, cluster, ingester): the library audit of ``objects`` with
    the generator stage on (``--audit-expand``) and the path phase's
    settings, relisting or (``source="snapshot"``) over a resident snapshot
    fed by a ``FakeCluster`` watch (cluster and ingester None otherwise).
    ``launches``/``shapes`` receive the fold kernels' launches inside the
    generator stage."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    _ms, es = mutation_systems()
    config = AuditConfig(violations_limit=20, chunk_size=32768,
                         exact_totals=False, submit_window=4,
                         expand_generated=True, audit_source=source)
    kw, cluster, ingester = {}, None, None
    lister = (lambda: iter(objects))
    if source == "snapshot":
        from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                                   DeviceResidency,
                                                   SnapshotConfig,
                                                   WatchIngester, gvks_of)
        from gatekeeper_tpu_torch.sync.source import FakeCluster

        cluster = FakeCluster()
        for o in objects:
            cluster.apply(o)
        snap = ClusterSnapshot(evaluator, SnapshotConfig())
        ingester = WatchIngester(snap, cluster,
                                 gvks_of(cluster.list())).start()
        kw = {"snapshot": snap,
              "residency": DeviceResidency(evaluator, mode="auto")}
        lister = cluster.list
    mgr = AuditManager(client, lister=lister, config=config,
                       evaluator=evaluator, expansion_system=es, **kw)
    if launches is not None:
        for name in ("_sweep_generated", "_snapshot_generated"):
            setattr(mgr, name, _fold_counted(getattr(mgr, name), launches,
                                             shapes))
    return mgr, cluster, ingester


def _expand_step(label: str, mgr, fn, device: str, card: str) -> tuple:
    """(run, record) of one audit pass ``fn`` with the generator stage:
    wall, objects, violations, and the generator stage's own counts and
    seconds in this pass."""
    keys = ("generators", "resultants", "expand", "generated_sweep")
    perf0 = {k: mgr.perf.get(k, 0.0) for k in keys}
    t0 = time.perf_counter()
    run = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "objects": run.total_objects,
           "violations": sum(run.total_violations.values()),
           **{k: mgr.perf.get(k, 0.0) - perf0[k] for k in keys}}
    log(f"expand[{label}]: {rec['objects']} objects, {rec['violations']} "
        f"violations, {wall:.3f}s; {rec['generators']:.0f} generators, "
        f"{rec['resultants']:.0f} resultants; expand {rec['expand']:.3f}s, "
        f"generated sweep {rec['generated_sweep']:.3f}s ({card})")
    if run.incomplete:
        raise AssertionError(f"expand[{label}]: incomplete run")
    return run, rec


def expand_audit(objects, device: str):
    """One relist audit (its ``AuditRun``) with the generator stage, on
    the reduced lane."""
    mgr = expand_manager(objects, device, "reduced")[0]
    return mgr.audit()


def expand_phase(objects, plain_totals: dict, card: str,
                 device: str = "cuda") -> tuple:
    """``--audit-expand`` over the path phase's objects on both collect
    lanes (relist), then a resident-snapshot first pass and a 1% churn
    tick.  Returns (launches, shapes) of the fold kernels inside the
    generator stage, and the steps' records.  ``device="cpu"`` rehearses
    it (no launches to count, no card-against-CPU comparison)."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {name: collections.Counter() for name in launches}
    steps, runs = {}, {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        before = dict(launches)
        mgr = expand_manager(objects, device, collect, launches, shapes)[0]
        run, steps[collect] = _expand_step(collect, mgr, mgr.audit, device,
                                           card)
        if device == "cuda" and launches[kernel] <= before[kernel]:
            raise AssertionError(f"expand[{collect}]: the generated chunks "
                                 f"never launched {kernel}")
        extra = {k: v - plain_totals[collect].get(k, 0)
                 for k, v in run.total_violations.items()}
        if min(extra.values()) < 0 or sum(extra.values()) <= 0 or \
                not 0 < steps[collect]["resultants"] \
                == steps[collect]["generators"]:
            raise AssertionError(f"expand[{collect}]: the implied Pods "
                                 f"added no violations: {extra}")
        steps[collect]["added_violations"] = sum(extra.values())
        runs[collect] = run
    if summary(runs["reduced"]) != summary(runs["masks"]):
        raise AssertionError("expand: reduced and masks lanes disagree")
    # the resident snapshot with the generator stage: a first pass, then a
    # 1% churn tick
    mgr, cluster, ingester = expand_manager(objects, device, "reduced",
                                            launches, shapes, "snapshot")
    try:
        run1, steps["snapshot first pass"] = _expand_step(
            "snapshot first pass", mgr, mgr.audit, device, card)
        diff = AuditManager._verdicts_differ_canonical(
            run1.kept, run1.total_violations, runs["reduced"].kept,
            runs["reduced"].total_violations, 20)
        if diff is not None:
            raise AssertionError(f"expand: the snapshot differs from the "
                                 f"relist: {diff}")
        implied = sum(v.message.startswith(IMPLIED)
                      for per_con in mgr._gen_verdicts.values()
                      for _count, vs in per_con.values() for v in vs)
        if not implied:
            raise AssertionError(f"expand: no {IMPLIED} violations")
        ops = snapshot_churn(objects, max(8, int(len(objects)
                                                 * CHURN_SHARE)), seed=11)
        _churn_apply(cluster, ops)
        ingester.pump()
        _run2, steps["snapshot churn tick"] = _expand_step(
            f"snapshot churn tick ({len(ops)} operations)", mgr,
            mgr.audit_tick, device, card)
        rows = mgr.perf.get("last_rows_evaluated", 0.0)
        if not 0 < rows <= len(ops):
            raise AssertionError(f"expand: the churn tick evaluated {rows} "
                                 f"rows for {len(ops)} operations")
        steps["snapshot first pass"]["implied_violations"] = implied
        log(f"expand: snapshot == relist canonically; {implied} {IMPLIED} "
            f"violations in the generated verdicts; churn tick {rows:.0f} "
            f"rows")
    finally:
        ingester.stop()
    if device == "cuda":
        prefix = objects[:CPU_PREFIX]
        on_card = summary(expand_audit(prefix, "cuda"))
        on_cpu = summary(expand_audit(prefix, "cpu"))
        if on_card != on_cpu:
            raise AssertionError("expand: the CPU run differs from the "
                                 "card's")
        log(f"expand: cpu == cuda on the first {CPU_PREFIX} objects "
            f"({sum(on_cpu[1].values())} violations)")
    log(f"expand: generator-stage launches {launches}, shapes "
        f"{dict((k, dict(v)) for k, v in shapes.items())}")
    return launches, {k: dict(v) for k, v in shapes.items()}, steps


def _prefilter_times(objs, device: str) -> dict:
    """Wall ms of the lane's relevance rows for one burst through each
    route of the prefilter: the compiled programs on the card
    (``CompiledProgram.run``: upload, torch ops, fetch) and the host numpy
    ``_np_eval``, over one shared flatten; the two must agree."""
    from gatekeeper_tpu_torch.mutation.device import (MutationPrefilter,
                                                      _np_eval)

    ms, _es = mutation_systems(mutators()[:6])
    pre = MutationPrefilter(device=device)
    low = [m for m in ms.active() if pre.add_mutator(m)]
    n = len(objs)
    _rel, batch = pre.relevance_and_batch(low, objs)
    progs = [pre._programs[m.id][2] for m in low]
    out = {}
    for route, fn in (
            ("device", lambda: [pre._run_program(p, batch, n)
                                for p in progs]),
            ("np_eval", lambda: [np.broadcast_to(np.asarray(_np_eval(
                p.program.expr, batch, n), bool), (n,)) for p in progs])):
        rows = fn()
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[route] = (statistics.median(times), rows)
    for a, b in zip(out["device"][1], out["np_eval"][1]):
        if not np.array_equal(a, b):
            raise AssertionError("prefilter: the card's rows differ from "
                                 "_np_eval's")
    return {"device_ms": out["device"][0], "np_eval_ms": out["np_eval"][0],
            "programs": len(progs)}


def mutate_phase(n: int, card: str, device: str = "cuda") -> dict:
    """``/v1/mutate`` (the batched lane behind its microbatcher) served on
    ``device``, every answer held against the port's per-object CPU
    handler; then ``mutate_batch`` on the card against per-object
    ``mutate`` and the prefilter's two routes timed.  (``/v1/admit`` with
    the expansion system is the admission phase's.)"""
    from gatekeeper_tpu_torch.mutlane import (BatchedMutationHandler,
                                              MutationBatcher, MutationLane)
    from gatekeeper_tpu_torch.webhook.mutation import MutationHandler
    from gatekeeper_tpu_torch.webhook.server import (WebhookServer,
                                                     admission_response)

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    ms, _es = mutation_systems()
    lane = MutationLane(ms, device=device)
    lanes: collections.Counter = collections.Counter()
    bursts: collections.Counter = collections.Counter()
    mutate_objects = lane.mutate_objects

    def counted_mutate(objs, **kwargs):
        out = mutate_objects(objs, **kwargs)
        lanes.update(o.lane for o in out)
        bursts[len(objs)] += 1
        return out

    lane.mutate_objects = counted_mutate
    mbatcher = MutationBatcher(lane).start()
    server = WebhookServer(
        mutation_handler=BatchedMutationHandler(
            ms, lane=lane, namespace_lookup=namespaces.get,
            batcher=mbatcher),
        host="127.0.0.1", port=0, mutation_batcher=mbatcher).start()
    try:
        m_replies, m_lat, m_wall = post_concurrently(server.port, bodies,
                                                     "/v1/mutate")
    finally:
        drained = server.stop()
    out = {"mutations": n, "wall_s": m_wall, "mutations_per_s": n / m_wall,
           "lanes": dict(lanes),
           "batch_sizes": dict(sorted(bursts.items()))}
    lat_ms = sorted(x * 1e3 for x in m_lat)
    out["p50_ms"] = lat_ms[len(lat_ms) // 2]
    out["p99_ms"] = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    log(f"mutate: {n} mutations in {m_wall:.3f}s, "
        f"{out['mutations_per_s']:.1f} mutations/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms "
        f"({LOAD_PROCS * LOAD_CONNS} keep-alive clients), {card}")
    log(f"mutate: outcome lanes {dict(lanes)}, lane bursts "
        f"{out['batch_sizes']}")
    # every /v1/mutate answer against the per-object CPU handler
    ref_ms = mutation_systems()[0]
    ref = MutationHandler(ref_ms, namespace_lookup=namespaces.get)
    diffs, patched, errors = [], 0, 0
    for i, body in enumerate(bodies):
        m = ref.handle(copy.deepcopy(body))
        want = admission_response(m.uid, m.allowed, m.message, m.code,
                                  warnings=m.warnings,
                                  patch=m.patch)["response"]
        patched += "patch" in want
        errors += bool(m.message)
        if m_replies[i] != want:
            diffs.append((i, m_replies[i], want))
    log(f"mutate: {patched} patched, {errors} with a mutation error, "
        f"{len(diffs)} differ from the CPU MutationHandler")
    if diffs or not patched or not drained:
        raise AssertionError(f"mutate: answers differ from the CPU handler "
                             f"(first: {diffs[:2]}), or the server did not "
                             f"drain ({drained})")
    # mutate_batch on the card: an all-lowered registry takes the grids
    low_ms, _ = mutation_systems(mutators()[:6])
    objs = [b["request"]["object"] for b in bodies
            if b["request"].get("object") is not None]
    card_objs, ref_objs = copy.deepcopy(objs), copy.deepcopy(objs)
    t0 = time.perf_counter()
    changed = low_ms.mutate_batch(card_objs, device=device)
    batch_s = time.perf_counter() - t0
    want = [low_ms.mutate(o) for o in ref_objs]
    pre = low_ms._prefilter
    log(f"mutate_batch on {device}: {len(objs)} objects, {sum(changed)} "
        f"changed, {batch_s:.3f}s; prefilter rows {pre.perf}")
    if changed != want or card_objs != ref_objs:
        raise AssertionError("mutate_batch on the card differs from "
                             "per-object mutate")
    if pre.perf["program_rows"] <= 0:
        raise AssertionError("mutate_batch: no compiled-program row ran")
    out["mutate_batch_s"] = batch_s
    out["prefilter"] = {}
    for burst in PREFILTER_BURSTS:
        rec = _prefilter_times(objs[:burst], device)
        out["prefilter"][burst] = rec
        log(f"prefilter at burst {burst}: {rec['programs']} relevance "
            f"programs, card (CompiledProgram.run) {rec['device_ms']:.3f} "
            f"ms, host _np_eval {rec['np_eval_ms']:.3f} ms (wall, median of "
            f"7), {card}")
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
    t_start = time.perf_counter()

    def phase(name):
        log(f"== {name} (at {time.perf_counter() - t_start:.1f}s)")

    phase("device")
    card = device_phase()["card"]
    phase("kernels")
    rows, err = kernel_phase()
    phase("path")
    launches, shapes, objects, relist_runs = path_phase(args.objects)
    plain_totals = {c: dict(run.total_violations)
                    for c, run in relist_runs.items()}
    phase("snapshot")
    snap_launches, snap_shapes, snap_steps = snapshot_phase(
        objects, relist_runs, card)
    del relist_runs
    gc.collect()  # the snapshot worlds' reference cycles, before timing on
    phase("expand")
    exp_launches, exp_shapes, exp_steps = expand_phase(objects, plain_totals,
                                                       card)
    gc.collect()
    phase("shapes")
    shape_phase(rows, err, {
        name: dict(collections.Counter(shapes[name])
                   + collections.Counter(snap_shapes[name])
                   + collections.Counter(exp_shapes[name]))
        for name in shapes})
    phase("profile")
    profile_phase(objects)
    del objects
    phase("admission")
    admission_phase(args.admissions, card)
    phase("served")
    served_phase(min(SERVED_ADMISSIONS, args.admissions), SERVED_OBJECTS,
                 card)
    phase("mutate")
    mutate = mutate_phase(args.admissions, card)
    log(f"snapshot steps: {json.dumps(snap_steps)}")
    log(f"expand steps: {json.dumps(exp_steps)}")
    log(f"mutate: {json.dumps(mutate)}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
    log(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["snapshot_launches"] = snap_launches[row["name"]]
        row["expand_launches"] = exp_launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
