"""The audit driver: whole ``AuditManager.audit()`` sweeps, back to back.

A mix that names ``"driver": "audit"`` names its ``source`` too: the module
``sources/<source>.py`` whose ``build(stack, raws, cfg, mix)`` puts the
program's ``AuditManager`` over the cluster into ``stack["mgr"]`` (and, where
it holds state that must be stopped, a ``stack["close"]``).  Set-up draws the
cluster from the seed, serializes it, builds the stack, runs one whole sweep
so that every shape the window uses is warm, and ends with a full garbage
collection, so that every run starts its window from the same collector
state.  The window runs sweeps until ``--seconds`` have passed, and the last
one started is finished.

Each sweep of the window is logged with its wall, the process's CPU time,
and the collector's full (generation 2) collections and their seconds: what
makes one sweep slower than another.
"""

from __future__ import annotations

import gc
import json
import time

from harness import core, trace
from harness.cluster import iter_cluster_objects, scaled_counts
from harness.core import log

SWEEP_SPANS = (("evaluator", "sweep_flatten", "flatten"),
               ("evaluator", "sweep_flatten_resident", "flatten_resident"),
               ("evaluator", "sweep_dispatch", "dispatch"),
               ("evaluator", "sweep_collect", "collect"),
               ("mgr", "_process_swept", "fold_render"),
               ("mgr", "_fold_snapshot_chunk", "fold_render"))


def summary(run) -> dict:
    """One sweep's answer in plain data: objects, totals and kept
    violations (kind, namespace, name, message) by constraint."""
    return {
        "objects": run.total_objects,
        "incomplete": bool(run.incomplete),
        "totals": {f"{k}/{n}": int(v)
                   for (k, n), v in sorted(run.total_violations.items())},
        "kept": {f"{k}/{n}": [[v.kind, v.namespace, v.name, v.message]
                              for v in vs]
                 for (k, n), vs in sorted(run.kept.items())},
    }


def cluster_inputs(config: dict, seed: int, n: int = 0) -> tuple:
    """(objects, inputs) of the configuration's cluster from ``seed``
    (``n``: the same mix scaled to about ``n`` objects).  ``inputs`` is
    what the reference reads: every object as JSON bytes, serialized
    before the program sees it (``raws``), the index of each (kind,
    namespace, name) (``where``) and the inventory's indices."""
    objects = list(iter_cluster_objects(scaled_counts(config["kinds"], n),
                                        seed=seed))
    raws = [json.dumps(o, separators=(",", ":")).encode() for o in objects]
    where = {}
    for i, o in enumerate(objects):
        meta = o.get("metadata") or {}
        where[(o.get("kind", ""), meta.get("namespace", "") or "",
               meta.get("name", ""))] = i
    inventory = [i for i, o in enumerate(objects)
                 if o.get("kind") in config["inventory_kinds"]]
    return objects, {"raws": raws, "where": where, "inventory": inventory}


def build(objects, raws, config: dict, mix: dict, device: str) -> dict:
    """The program's audit stack over ``objects`` (``raws``: their JSON
    bytes), its manager built by the mix's source."""
    from gatekeeper_tpu_torch.__main__ import new_client
    from gatekeeper_tpu_torch.audit.manager import AuditConfig
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.utils.synthetic import load_library

    client, driver = new_client(device=device)
    load_library(client)
    for o in objects:
        if o.get("kind") in config["inventory_kinds"]:
            client.add_data(o)
    evaluator = SweepEvaluator(driver, device=device,
                               violations_limit=config["violations_limit"],
                               collect=config["collect"])
    cfg = AuditConfig(violations_limit=config["violations_limit"],
                      chunk_size=config["chunk_size"],
                      exact_totals=config["exact_totals"],
                      submit_window=config["submit_window"],
                      audit_source=mix.get("audit_source", "relist"))
    stack = {"client": client, "driver": driver, "evaluator": evaluator,
             "objects": objects}
    core.plugin("sources", mix["source"]).build(stack, raws, cfg, mix)
    del stack["objects"]
    return stack


def _numbers(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


class CollectorClock:
    """Counts the cyclic collector's full collections and their seconds
    while it is installed."""

    def __init__(self):
        self.full = 0
        self.full_s = 0.0
        self.all_s = 0.0
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self._t0
        self.all_s += dt
        if info["generation"] == 2:
            self.full += 1
            self.full_s += dt

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def run(ctx: dict) -> dict:
    """Set up, run the window and (with ``--trace 1``) profile one sweep.
    Returns what the result line and the check need; the program's state
    is freed before it returns."""
    import torch

    from gatekeeper_tpu_torch.ops import fold

    config, mix, device = ctx["config"], ctx["mix"], ctx["device"]
    t0 = time.perf_counter()
    objects, inputs = cluster_inputs(config, ctx["seed"],
                                     ctx.get("objects", 0))
    n = len(objects)
    t1 = time.perf_counter()
    stack = build(objects, inputs["raws"], config, mix, device)
    log(f"audit: {n} objects from seed {ctx['seed']}: generated and "
        f"serialized in {t1 - t0:.3f} s, the program's stack built in "
        f"{time.perf_counter() - t1:.3f} s")
    # the harness holds the cluster as bytes only: a list of dicts would
    # lengthen every garbage collection inside the program's window
    del objects
    mgr, evaluator = stack["mgr"], stack["evaluator"]
    hooks = ctx.get("program_hooks")
    if hooks:
        hooks(stack)
    t0 = time.perf_counter()
    warm = mgr.audit()
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"audit: warm sweep {time.perf_counter() - t0:.3f} s, "
        f"{warm.total_objects} objects")
    del warm
    gc.collect()

    collected = {}
    undo_count = trace.wrap(evaluator, "sweep_collect", "collect", collected)
    perf0, mperf0 = _numbers(evaluator.perf), _numbers(mgr.perf)
    sweeps = []
    clock = CollectorClock()
    ctx["mark_window_start"]()
    t_start = time.perf_counter()
    t_end = t_start + ctx["seconds"]
    with clock:
        while True:
            s0, c0 = time.perf_counter(), time.process_time()
            full0, full_s0 = clock.full, clock.full_s
            r = mgr.audit()
            if device == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - s0
            sweeps.append((summary(r), dt, r.failed_chunks, (
                round(time.process_time() - c0, 3), clock.full - full0,
                round(clock.full_s - full_s0, 3))))
            if time.perf_counter() >= t_end:
                break
    window_s = time.perf_counter() - t_start
    undo_count()
    ctx["window_closed"]()
    perf = _delta(_numbers(evaluator.perf), perf0)
    mperf = _delta(_numbers(mgr.perf), mperf0)
    objects_window = sum(s[0]["objects"] for s in sweeps)
    wall = sum(s[1] for s in sweeps)
    failed = sum(s[2] for s in sweeps)
    attempted = int(collected.get("collect#calls", 0)) + failed
    log(f"audit: {len(sweeps)} sweeps in {window_s:.3f} s, "
        f"{objects_window} objects, {objects_window / wall:.1f} objects/s; "
        f"walls {[round(s[1], 4) for s in sweeps]}")
    log(f"audit: per sweep (cpu s, full collections, their s) "
        f"{[s[3] for s in sweeps]}; collector {clock.all_s:.3f} s of "
        f"{wall:.3f} s")
    out = {
        "attempted": attempted, "failed": failed,
        "e2e": {"audit_objects_per_s": objects_window / wall},
        "answers": [s[0] for s in sweeps],
        "n_objects": n, "inputs": inputs,
        "layer": {"objects": objects_window, "perf": perf, "mgr_perf": mperf,
                  "sweeps": len(sweeps), "window_s": window_s,
                  "gc_s": clock.all_s},
    }
    residency = stack.get("residency")
    if residency is not None:
        out["layer"]["resident_bytes"] = float(residency.resident_bytes())
        out["layer"]["n_objects"] = n
    if ctx["trace"] and device == "cuda":
        spans: list = []
        undos = [trace.wrap_iter(mgr, "_chunk_source", "list_route", spans)]
        for owner, attr, name in SWEEP_SPANS:
            obj = stack[owner]
            if hasattr(obj, attr):
                undos.append(trace.wrap(obj, attr, name, spans=spans))
        shapes0 = {k: dict(getattr(fold, k).shapes)
                   for k in ("fused_fold", "epilogue")}
        prof = trace.profiled(mgr.audit, spans)
        for u in reversed(undos):
            u()
        launches = []
        for k in ("fused_fold", "epilogue"):
            now = dict(getattr(fold, k).shapes)
            for shape, count in now.items():
                extra = count - shapes0[k].get(shape, 0)
                if extra > 0:
                    launches.append((k, shape, extra))
        prof["fold_launches"] = launches
        prof["objects"] = n
        out["profile"] = prof
        log(f"audit: profiled sweep {prof['host_wall_s']:.3f} s against "
            f"{wall / len(sweeps):.3f} s unprofiled; device busy "
            f"{prof['busy_s']} s of {prof['window_s']:.3f} s")
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if device == "cuda" else 0)
    close = stack.get("close")
    if close is not None:
        close()
    stack.clear()
    del mgr, evaluator, stack
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def check(ctx: dict, out: dict, workers: int) -> dict:
    """The numbers compared (see ``reference/check.py``) for the window's
    sweeps."""
    from reference import check as ref

    config = ctx["config"]
    r = ref.audit_reference(ctx["library_root"], config, ctx["seed"],
                            out["inputs"], out["answers"], workers)
    log(f"check: {len(r['keys'])} constraints' totals checked over "
        f"{len(out['answers'])} sweeps; {len(r['kept'])} kept objects")
    return ref.compare_audit(out["answers"], r, config, out["n_objects"])


def control(ctx: dict, workers: int) -> dict:
    """The numbers compared for the control's answer: the reference's own
    totals with the configuration's ``control`` guarantee broken, put in
    the program's place.  It answers no kept list, so only its totals are
    judged."""
    from reference import check as ref

    config = ctx["config"]
    _objects, inputs = cluster_inputs(config, ctx["seed"],
                                      ctx.get("objects", 0))
    n = len(inputs["raws"])
    args = (ctx["library_root"], config, ctx["seed"], inputs, [], workers)
    want = ref.audit_reference(*args)
    broken = ref.audit_reference(*args, control=config["control"])
    nums = ref.compare_audit([ref.control_audit(broken, config, n)], want,
                             config, n)
    nums.pop("kept_wrong")
    return nums
