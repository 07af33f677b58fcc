"""gator bench: policy evaluation benchmark harness.

Reference: pkg/gator/bench/bench.go — per-engine setup-vs-eval timing with
warmup, P50/P90/P99 latencies, reviews/sec (>=1000 iterations recommended
for P99 validity, bench.go:29-31).  Engines: rego | cel | all — plus the
device engines, which run on ``--device`` (default ``cuda``; they raise
without a card unless ``--device cpu`` is given): ``tpu`` (the name is
kept so that scripts written for the JAX CLI still run) drives the
batched verdict grid of ``TorchDriver.query_batch`` instead of the
per-review loop, ``sweep`` drives the full audit-sweep lane
(AuditManager + SweepEvaluator, whose folds run the hand-written
kernels) through the schedule ``--pipeline`` picks, reporting the
per-stage breakdown, and ``mutate`` drives a mutate burst through the
batched mutation lane.  The grid engines report the lowering fallback
fraction — templates silently losing the device speedup are visible
here.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass, field

from gatekeeper_tpu_torch.apis.constraints import GATOR_EP
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
from gatekeeper_tpu_torch.gator import reader
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
from gatekeeper_tpu_torch.target.target import K8sValidationTarget


@dataclass
class BenchResult:
    engine: str
    iterations: int
    objects: int
    setup_client_s: float = 0.0
    setup_templates_s: float = 0.0
    setup_constraints_s: float = 0.0
    setup_data_s: float = 0.0
    total_eval_s: float = 0.0
    reviews_per_sec: float = 0.0
    p50_ms: float = 0.0
    p90_ms: float = 0.0
    p99_ms: float = 0.0
    violations: int = 0
    # grid engines only (tpu/sweep): lowering coverage + the sweep
    # engine's per-stage pipeline breakdown (None for rego/cel/all)
    lowering: dict = None
    pipeline: dict = None

    def to_dict(self) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.__dict__.items() if v is not None}


DEVICE_ENGINES = ("tpu", "sweep", "mutate")


def _drivers_for(engine: str, compile_cache: str = "",
                 device: str = "cuda"):
    if engine == "rego":
        return [RegoDriver()]
    if engine == "cel":
        return [CELDriver()]
    if engine in ("tpu", "sweep"):
        cache = None
        if compile_cache:
            from gatekeeper_tpu_torch.drivers.generation import CompileCache

            cache = CompileCache(compile_cache)
        return [TorchDriver(device=device, cel_driver=CELDriver(),
                            compile_cache=cache)]
    return [RegoDriver(), CELDriver()]  # all


def run_bench(objs, engine: str, iterations: int,
              pipeline: str = "auto",
              flatten_lane: str = "auto",
              collect: str = "reduced",
              compile_cache: str = "",
              flatten_workers: int = 0,
              device: str = "cuda") -> BenchResult:
    if engine in DEVICE_ENGINES:
        from gatekeeper_tpu_torch import resolve_device

        resolve_device(device)  # no card and no device="cpu": raise now
    templates = [o for o in objs if reader.is_template(o)]
    constraints = [o for o in objs if reader.is_constraint(o)]
    data = [o for o in objs
            if not reader.is_template(o) and not reader.is_constraint(o)]
    r = BenchResult(engine=engine, iterations=iterations, objects=len(data))

    if engine == "mutate":
        return _run_mutate_bench(r, data, iterations, device)

    t0 = time.perf_counter()
    client = Client(target=K8sValidationTarget(),
                    drivers=_drivers_for(engine, compile_cache, device),
                    enforcement_points=[GATOR_EP])
    r.setup_client_s = time.perf_counter() - t0

    from gatekeeper_tpu_torch.apis.templates import TemplateError
    from gatekeeper_tpu_torch.utils.unstructured import deep_get

    skipped_kinds = set()
    t0 = time.perf_counter()
    for t in templates:
        try:
            client.add_template(t)
        except TemplateError:
            # template has no source for this engine (e.g. rego-only template
            # under --engine cel): skip it and its constraints
            skipped_kinds.add(deep_get(
                t, ("spec", "crd", "spec", "names", "kind"), ""))
    r.setup_templates_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in constraints:
        if c.get("kind") in skipped_kinds:
            continue
        client.add_constraint(c)
    r.setup_constraints_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in data:
        if not reader.is_admission_review(d):
            client.add_data(d)
    r.setup_data_s = time.perf_counter() - t0

    if engine == "sweep":
        return _run_sweep_bench(r, client, data, iterations, pipeline,
                                flatten_lane, collect, flatten_workers,
                                device)

    from gatekeeper_tpu_torch.target.review import AugmentedReview
    from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

    reviews = [
        (AugmentedReview(admission_request=parse_admission_review(o),
                         is_admission=True)
         if reader.is_admission_review(o)
         else AugmentedUnstructured(object=o, source=SOURCE_ORIGINAL))
        for o in data
    ]
    latencies = []
    violations = 0
    from gatekeeper_tpu_torch.observability import tracing

    if not reviews:
        total_reviews = 0
    elif engine == "tpu":
        # batched lane: one latency sample per batch pass over all objects
        client.review_batch(reviews, enforcement_point=GATOR_EP)  # warmup
        t_all0 = time.perf_counter()
        for _ in range(iterations):
            with tracing.span("gator.bench.pass", engine=engine,
                              n=len(reviews)):
                t0 = time.perf_counter()
                out = client.review_batch(reviews,
                                          enforcement_point=GATOR_EP)
                latencies.append((time.perf_counter() - t0) * 1000)
            violations = sum(
                len(o.results()) for o in out
                if not isinstance(o, Exception)
            )
        r.total_eval_s = time.perf_counter() - t_all0
        total_reviews = iterations * len(reviews)
    else:
        for rv in reviews:  # warmup pass (bench.go warmup)
            client.review(rv, enforcement_point=GATOR_EP)
        t_all0 = time.perf_counter()
        for _ in range(iterations):
            pass_violations = 0
            # one span per PASS, not per review: tracing must not tax the
            # per-review latency samples it sits next to
            with tracing.span("gator.bench.pass", engine=engine,
                              n=len(reviews)):
                for rv in reviews:
                    t0 = time.perf_counter()
                    resp = client.review(rv, enforcement_point=GATOR_EP)
                    latencies.append((time.perf_counter() - t0) * 1000)
                    pass_violations += len(resp.results())
            violations = pass_violations
        r.total_eval_s = time.perf_counter() - t_all0
        total_reviews = iterations * len(reviews)

    r.reviews_per_sec = (total_reviews / r.total_eval_s
                         if r.total_eval_s else 0.0)
    _fill_latencies(r, latencies)
    r.violations = violations
    if engine == "tpu":
        driver = next((d for d in client.drivers
                       if hasattr(d, "lowering_stats")), None)
        if driver is not None:
            r.lowering = driver.lowering_stats()
    return r


def _run_mutate_bench(r: BenchResult, data: list,
                      iterations: int, device: str = "cuda") -> BenchResult:
    """The ``mutate`` engine: a mutate burst through the batched lane
    (mutlane/lane.py, its prefilter's grids on ``device``) vs the
    per-object host fixed-point loop, over the input's mutators + objects.  ``reviews_per_sec`` is the batched
    lane's throughput; the host loop's lands in ``lowering`` alongside
    the lane breakdown (speedup = the headline)."""
    import copy

    from gatekeeper_tpu_torch.mutation.mutators import (MUTATIONS_GROUP,
                                                  MUTATOR_KINDS)
    from gatekeeper_tpu_torch.mutation.system import MutationSystem
    from gatekeeper_tpu_torch.mutlane import MutationLane
    from gatekeeper_tpu_torch.observability import tracing
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of

    mutators, objects = [], []
    for o in data:
        group, _, kind = gvk_of(o)
        if group == MUTATIONS_GROUP and kind in MUTATOR_KINDS:
            mutators.append(o)
        elif kind not in ("ExpansionTemplate",):
            objects.append(o)
    if not mutators:
        raise ValueError("--engine mutate needs mutators in the input")
    if not objects:
        raise ValueError("--engine mutate needs objects in the input")
    t0 = time.perf_counter()
    system = MutationSystem()
    for m in mutators:
        system.upsert_unstructured(m)
    lane = MutationLane(system, device=device)
    lane.mutate_objects(objects[:1])  # compile warmup
    r.setup_client_s = time.perf_counter() - t0
    r.objects = len(objects)

    latencies: list = []
    lanes: dict = {}
    patch_ops = 0
    t_all0 = time.perf_counter()
    for _ in range(iterations):
        with tracing.span("gator.bench.pass", engine="mutate",
                          n=len(objects)):
            t0 = time.perf_counter()
            outcomes = lane.mutate_objects(objects)
            latencies.append((time.perf_counter() - t0) * 1000)
        lanes = {}
        patch_ops = 0
        for o in outcomes:
            lanes[o.lane] = lanes.get(o.lane, 0) + 1
            patch_ops += len(o.patch or ())
    r.total_eval_s = time.perf_counter() - t_all0
    r.reviews_per_sec = (iterations * len(objects) / r.total_eval_s
                         if r.total_eval_s else 0.0)
    _fill_latencies(r, latencies)
    r.violations = patch_ops  # for mutate: emitted patch ops, last pass

    # the host loop reference: the same burst through the per-object
    # fixed point (one pass is enough for the comparison number)
    t0 = time.perf_counter()
    for obj in objects:
        try:
            system.mutate(copy.deepcopy(obj))
        except Exception:
            pass  # error outcomes count as work done too
    host_s = time.perf_counter() - t0
    host_ops = len(objects) / host_s if host_s else 0.0
    r.lowering = {
        "lanes": lanes,
        "host_objs_per_sec": round(host_ops, 1),
        "batched_objs_per_sec": round(r.reviews_per_sec, 1),
        "speedup": round(r.reviews_per_sec / host_ops, 2)
        if host_ops else 0.0,
        "lowered_mutators": len(lane.compiled().lowered),
        "host_only_mutators": len(lane.compiled().host_only),
    }
    return r


def _fill_latencies(r: BenchResult, latencies: list) -> None:
    if latencies:
        qs = statistics.quantiles(latencies, n=100, method="inclusive") if (
            len(latencies) > 1) else [latencies[0]] * 99
        r.p50_ms, r.p90_ms, r.p99_ms = qs[49], qs[89], qs[98]


def _run_sweep_bench(r: BenchResult, client: Client, data: list,
                     iterations: int, pipeline: str,
                     flatten_lane: str = "auto",
                     collect: str = "reduced",
                     flatten_workers: int = 0,
                     device: str = "cuda") -> BenchResult:
    """The ``sweep`` engine: the production audit lane (AuditManager +
    SweepEvaluator on ``device``, as ``python -m gatekeeper_tpu_torch
    --once`` builds it) over the fixture's data objects, scheduled per
    ``--pipeline``, at the audit's defaults (chunks of 500, exact
    totals).  One latency sample per full sweep; the per-stage breakdown
    of the last pipelined sweep rides the result."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    driver = next((d for d in client.drivers
                   if hasattr(d, "lowering_stats")), None)
    corpus = [o for o in data if not reader.is_admission_review(o)]
    r.objects = len(corpus)
    mgr = AuditManager(
        client, lister=lambda: iter(corpus),
        config=AuditConfig(pipeline=pipeline),
        evaluator=SweepEvaluator(driver, device=device,
                                 flatten_lane=flatten_lane,
                                 collect=collect,
                                 flatten_workers=flatten_workers),
    )
    latencies = []
    violations = 0
    if corpus:
        mgr.audit()  # warmup: vocab, lowering and the kernels' first build
        t_all0 = time.perf_counter()
        for _ in range(iterations):
            t0 = time.perf_counter()
            run = mgr.audit()
            latencies.append((time.perf_counter() - t0) * 1000)
            violations = sum(run.total_violations.values())
        r.total_eval_s = time.perf_counter() - t_all0
    total_reviews = iterations * len(corpus)
    r.reviews_per_sec = (total_reviews / r.total_eval_s
                         if r.total_eval_s else 0.0)
    _fill_latencies(r, latencies)
    r.violations = violations
    if driver is not None:
        r.lowering = driver.lowering_stats()
    stats = dict(mgr.pipe_stats) if mgr.pipe_stats else {}
    stats["schedule"] = ("pipelined" if mgr.perf.get("pipelined")
                        else "serial")
    r.pipeline = stats
    return r


def format_text(results: list) -> str:
    lines = []
    for r in results:
        lines.append(f"engine: {r.engine}")
        lines.append(
            f"  setup: client={r.setup_client_s * 1000:.1f}ms "
            f"templates={r.setup_templates_s * 1000:.1f}ms "
            f"constraints={r.setup_constraints_s * 1000:.1f}ms "
            f"data={r.setup_data_s * 1000:.1f}ms"
        )
        lines.append(
            f"  eval: {r.iterations} iterations x {r.objects} objects in "
            f"{r.total_eval_s:.3f}s -> {r.reviews_per_sec:,.0f} reviews/sec"
        )
        lines.append(
            f"  latency: P50={r.p50_ms:.3f}ms P90={r.p90_ms:.3f}ms "
            f"P99={r.p99_ms:.3f}ms"
        )
        lines.append(f"  violations (last pass): {r.violations}")
        if r.engine == "mutate" and r.lowering is not None:
            lo = r.lowering
            lanes = " ".join(f"{k}={v}" for k, v in
                             sorted(lo.get("lanes", {}).items()))
            lines.append(
                f"  mutate: batched={lo['batched_objs_per_sec']:,.0f} "
                f"obj/s vs host loop={lo['host_objs_per_sec']:,.0f} "
                f"obj/s ({lo['speedup']}x); "
                f"{lo['lowered_mutators']} lowered / "
                f"{lo['host_only_mutators']} host-only mutators; "
                f"lanes: {lanes}")
        elif r.lowering is not None:
            lo = r.lowering
            lines.append(
                f"  lowering: {lo['lowered']}/{lo['templates']} templates "
                f"on the device verdict path "
                f"({lo['fallback_fraction'] * 100:.1f}% interpreter "
                f"fallback)"
            )
            for kind, why in sorted(lo.get("fallback_kinds", {}).items()):
                lines.append(f"    fallback {kind}: {why}")
        if r.pipeline is not None:
            lines.append(f"  pipeline: schedule={r.pipeline.get('schedule')}")
            for name, s in (r.pipeline.get("stages") or {}).items():
                lines.append(
                    f"    stage {name}: busy={s['busy_s']:.3f}s "
                    f"occupancy={s['occupancy'] * 100:.0f}% "
                    f"queue_hw={s['queue_highwater']}"
                )
    return "\n".join(lines)


def run_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator bench")
    p.add_argument("--filename", "-f", action="append", default=[])
    p.add_argument("--engine", default="all",
                   choices=["rego", "cel", "all", "tpu", "sweep",
                            "mutate"],
                   help="'tpu' benchmarks the batched verdict grid of "
                        "TorchDriver.query_batch on --device (the name of "
                        "the JAX CLI's engine, kept for its scripts); "
                        "'sweep' the audit lane on --device; 'mutate' a "
                        "mutate burst through the batched mutlane (vs the "
                        "host fixed-point loop) over the input's mutators "
                        "+ objects; not part of 'all' (it needs mutators "
                        "in the input)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tpu, sweep and mutate engines run: "
                        "cuda (default; raises without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")
    p.add_argument("--iterations", "-n", type=int, default=10)
    p.add_argument("--output", "-o", default="", choices=["", "json"])
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "on", "off", "differential"],
                   help="sweep-engine schedule: the staged host "
                        "pipeline (on) vs serial eager-poll (off; auto "
                        "resolves to serial: the stages share the "
                        "interpreter lock); differential runs both and "
                        "asserts bit-identical output")
    p.add_argument("--flatten-lane", default="auto",
                   choices=["auto", "dict", "raw", "py", "differential"],
                   help="sweep-engine columnizer lane: raw JSON bytes "
                        "through the threaded C columnizer (auto/raw) "
                        "vs the GIL-bound dict walker (dict) vs Python "
                        "(py); differential runs raw THEN dict and "
                        "asserts bit-identical columns")
    p.add_argument("--flatten-workers", type=int, default=0,
                   help="sweep-engine flatten worker processes (see "
                        "the server's --flatten-workers); 0 = "
                        "in-process")
    p.add_argument("--collect", default="reduced",
                   choices=["reduced", "masks", "differential"],
                   help="sweep-engine collect lane: device-side verdict "
                        "reduction (reduced — O(kept) device->host "
                        "bytes) vs the host-fold bit grid (masks); "
                        "differential runs both per chunk and raises on "
                        "any difference")
    p.add_argument("--trace", default="",
                   help="export a Chrome trace-event JSON of the bench "
                        "run's spans to this path (Perfetto-loadable)")
    p.add_argument("--compile-cache", default="",
                   help="on-disk compile cache directory (see python -m "
                        "gatekeeper_tpu_torch --compile-cache): a warm cache "
                        "makes repeat device-engine bench runs skip "
                        "template lowering entirely")
    p.add_argument("--attribution", action="store_true",
                   help="per-template cost attribution table after the "
                        "run: each engine's shared passes apportioned "
                        "across the constraint grid by row occupancy "
                        "(the /debug/cost view, offline)")
    args = p.parse_args(argv)

    try:
        objs = reader.read_sources(args.filename, use_stdin=not args.filename)
    except OSError as e:
        print(f"error: reading: {e}", file=sys.stderr)
        return 1
    if not objs:
        print("no input data identified", file=sys.stderr)
        return 1

    engines = ([args.engine] if args.engine != "all"
               else ["rego", "cel", "all"])
    if args.engine in DEVICE_ENGINES:
        from gatekeeper_tpu_torch import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise
    # span-trace every engine run: an already-active tracer (gator
    # --chaos runs under an outer harness, tests) is reused; otherwise a
    # seeded full-sampling tracer is installed for the bench duration so
    # the per-engine self-time summary below always has data
    from gatekeeper_tpu_torch.observability import (format_span_summary,
                                                    tracing,
                                                    write_chrome_trace)

    tracer = tracing.active_tracer()
    installed = False
    if tracer is None:
        tracer = tracing.Tracer(seed=0)
        tracing.install(tracer)
        installed = True
    from gatekeeper_tpu_torch.observability import costattr as _costattr

    attr = None
    attr_installed = False
    if args.attribution:
        attr = _costattr.active()
        if attr is None:
            attr = _costattr.CostAttribution()
            _costattr.install(attr)
            attr_installed = True
    results = []
    try:
        for engine in engines:
            seen = len(tracer.traces())
            try:
                results.append(run_bench(
                    objs, engine, args.iterations,
                    pipeline=args.pipeline,
                    flatten_lane=args.flatten_lane,
                    collect=args.collect,
                    compile_cache=args.compile_cache,
                    flatten_workers=args.flatten_workers,
                    device=args.device))
            except Exception as e:
                print(f"error: benchmarking {engine}: {e}", file=sys.stderr)
                return 1
            # one-line top-3-by-self-time span summary per engine run:
            # where the wall actually went, straight from the timeline
            print(f"[{engine}] "
                  + format_span_summary(tracer.traces()[seen:]),
                  file=sys.stderr)
        if args.trace:
            n = write_chrome_trace(args.trace, tracer)
            print(f"trace: {n} events -> {args.trace} (load in "
                  "ui.perfetto.dev or chrome://tracing)", file=sys.stderr)
    finally:
        if installed:
            tracing.uninstall()
        if attr_installed:
            _costattr.uninstall()
    if args.output == "json":
        out = [r.to_dict() for r in results]
        if attr is not None:
            out.append({"attribution": attr.snapshot()})
        print(json.dumps(out, indent=2))
    else:
        print(format_text(results))
        if attr is not None:
            print("cost attribution (per template, all engines):")
            print(attr.table())
    return 0
