"""``python -m gatekeeper_tpu_torch --fleet-config clusters.json``: the
fleet control plane's process shape — N clusters' audit planes
multiplexed behind shared per-library runtimes (see
:mod:`gatekeeper_tpu_torch.fleet.evaluator`).

Port of ``gatekeeper_tpu/fleet/run.py``.  Shares the single-cluster
entry's flags where they apply: one ``--compile-cache`` serves every
library's lowerings (and its warm state), one ``--snapshot-spill`` root
holds per-cluster spill subdirs, ``--audit-interval`` /
``--audit-chunk-size`` / ``--constraint-violations-limit`` size the
sweeps, ``--collect`` / ``--flatten-lane`` / ``--flatten-workers`` build
each runtime's sweep evaluator, ``--device`` is where every runtime runs,
and ``--once`` runs one packed fleet pass and exits (spilling each cluster
on the way out).  Everything is printed on stderr, as the JAX CLI prints
it.
"""

from __future__ import annotations

import signal
import sys
import threading


def _build_runtime_factory(library_docs, compile_cache, metrics, args):
    """A build() closure for FleetEvaluator.runtime: client + driver +
    evaluator over one library's documents (templates before
    constraints — a constraint of a not-yet-loaded kind is an error), on
    ``args.device``."""
    def build():
        from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
        from gatekeeper_tpu_torch.client.client import Client
        from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
        from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
        from gatekeeper_tpu_torch.gator import reader
        from gatekeeper_tpu_torch.parallel.mesh import make_mesh
        from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
        from gatekeeper_tpu_torch.target.target import K8sValidationTarget

        cel = CELDriver()
        driver = TorchDriver(device=args.device, cel_driver=cel,
                             metrics=metrics, compile_cache=compile_cache)
        client = Client(target=K8sValidationTarget(),
                        drivers=[driver, cel],
                        enforcement_points=[AUDIT_EP])
        for doc in library_docs:
            if reader.is_template(doc):
                client.add_template(doc)
        for doc in library_docs:
            if reader.is_constraint(doc):
                client.add_constraint(doc)
        if getattr(driver, "gen_coord", None) is not None:
            driver.gen_coord.constraints_fn = client.constraints
        evaluator = SweepEvaluator(
            driver, device=args.device,
            violations_limit=args.constraint_violations_limit,
            flatten_lane=args.flatten_lane, metrics=metrics,
            collect=args.collect,
            flatten_workers=args.flatten_workers,
            mesh=make_mesh(device=args.device))
        return client, driver, evaluator

    return build


def run_fleet(args) -> int:
    """The --fleet-config entry: build the fleet, sweep (once or on the
    audit interval), spill per cluster on the way out."""
    from gatekeeper_tpu_torch import resolve_device
    from gatekeeper_tpu_torch.fleet.config import load_fleet_config
    from gatekeeper_tpu_torch.fleet.evaluator import FleetEvaluator
    from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry
    from gatekeeper_tpu_torch.resilience import overload as ovl

    resolve_device(args.device)  # no card and no --device cpu: raise now
    try:
        cfg = load_fleet_config(args.fleet_config)
    except (OSError, ValueError) as e:
        print(f"fleet config: {e}", file=sys.stderr)
        return 2
    metrics = MetricsRegistry()
    compile_cache = None
    if args.compile_cache:
        from gatekeeper_tpu_torch.drivers.generation import CompileCache

        compile_cache = CompileCache(args.compile_cache, metrics=metrics)
    fleet = FleetEvaluator(
        metrics=metrics,
        chunk_size=args.audit_chunk_size,
        violations_limit=args.constraint_violations_limit,
        pack_chunks=cfg.pack_chunks,
        spill_root=args.snapshot_spill,
        spill_compress=args.snapshot_spill_compress,
        spill_delta=args.snapshot_spill_delta,
        spill_full_every=args.snapshot_spill_full_every,
        residency=args.snapshot_residency,
        # every runtime (including ones born after boot) replays its
        # persisted warm state from a WarmStateCache subdir under the
        # shared compile-cache root
        warm_root=args.compile_cache or "")
    try:
        _add_clusters(args, cfg, fleet, compile_cache, metrics)
        try:
            slo_engine = _slo_engine(args, fleet, metrics)
        except ValueError as e:  # slo.SLOConfigError
            print(f"slo config: {e}", file=sys.stderr)
            fleet.stop()
            return 2
        return _sweeps(args, fleet, slo_engine)
    finally:
        ovl.uninstall_degradations()
        if args.flatten_workers:
            from gatekeeper_tpu_torch.ops.flatten import \
                shutdown_flatten_pools

            shutdown_flatten_pools()  # the worker processes exit with us


def _add_clusters(args, cfg, fleet, compile_cache, metrics) -> None:
    from gatekeeper_tpu_torch.fleet.config import load_cluster_spec
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    for spec in cfg.clusters:
        key, library, state = load_cluster_spec(spec)
        source = FakeCluster()
        for obj in state:
            source.apply(obj)
        fc = fleet.add_cluster(
            spec.cluster_id, source, key,
            _build_runtime_factory(library, compile_cache, metrics,
                                   args))
        shared = len(fc.runtime.clusters) > 1
        print(f"cluster {fc.id}: {len(state)} objects, "
              f"library {key[:12]} "
              f"({'shared runtime' if shared else 'new runtime'})"
              + (", warm spill" if fc.warm_booted else ""),
              file=sys.stderr)
    print(f"fleet: {len(fleet.clusters)} clusters over "
          f"{len(fleet.runtimes())} library runtimes "
          f"({fleet.shared_boots} shared boots)", file=sys.stderr)


def _slo_engine(args, fleet, metrics):
    """Fleet-scoped SLOs: each cluster gets its own audit-staleness
    objective over the {cluster}-labelled last-run gauges, burning and
    degrading independently (``--slo-degradation`` arms the per-objective
    maps: a stale cluster releases ITS audit's device-lane yield and
    defers ITS resyncs — no other cluster's lane moves).  None when
    ``--slo off``; a malformed ``--slo-config`` raises
    ``slo.SLOConfigError``."""
    if getattr(args, "slo", "on") != "on":
        return None
    from gatekeeper_tpu_torch.observability import slo as slo_mod
    from gatekeeper_tpu_torch.resilience import overload as ovl

    degradations = None
    if getattr(args, "slo_degradation", "off") == "on":
        degradations = ovl.DegradationRegistry(metrics=metrics)
        ovl.install_degradations(degradations)
    base = list(slo_mod.DEFAULT_OBJECTIVES)
    if getattr(args, "slo_config", ""):
        base = [o.spec for o in slo_mod.load_config(
            args.slo_config, degradations)["objectives"]]
    # the fleet control plane has no admission lane: scope the audit-side
    # objectives per cluster, skip the webhook ones
    base = [o for o in base if o.get("type") == "staleness"]
    return slo_mod.SLOEngine(
        metrics,
        objectives=slo_mod.per_cluster_objectives(
            sorted(fleet.clusters), base=base),
        degradations=degradations)


def _sweeps(args, fleet, slo_engine) -> int:
    for rt in fleet.runtimes():
        rep = rt.warm_replayed
        if rep and rep.get("hit"):
            print(f"warm state replayed for library "
                  f"{rt.key[:12]}: {rep['hit_states']} hit-buffer "
                  f"states landed", file=sys.stderr)

    def summarize(runs: dict) -> None:
        for cid in sorted(runs):
            run = runs[cid]
            total = sum(run.total_violations.values())
            print(f"fleet audit [{cid}]: {run.total_objects} objects, "
                  f"{total} violations in {run.duration_s:.2f}s"
                  + (" [INCOMPLETE]" if run.incomplete else ""),
                  file=sys.stderr)

    if args.once:
        runs = fleet.sweep(full=True)
        if slo_engine is not None:
            slo_engine.tick()
        summarize(runs)
        print(f"fleet sweep: {fleet.packed_dispatches} packed + "
              f"{fleet.unpacked_dispatches} unpacked dispatches, "
              f"{fleet.last_sweep_s:.2f}s", file=sys.stderr)
        fleet.spill_all()
        fleet.save_warm_all()
        fleet.stop()
        return 0

    stopping = threading.Event()

    def _on_term(signum, frame):
        stopping.set()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        summarize(fleet.sweep(full=None))
        if slo_engine is not None:
            slo_engine.tick()
        while not stopping.wait(args.audit_interval):
            summarize(fleet.sweep(full=None))
            if slo_engine is not None:
                slo_engine.tick()
    except KeyboardInterrupt:
        pass
    finally:
        fleet.spill_all()
        fleet.save_warm_all()
        fleet.stop()
        print("fleet drained (per-cluster spills + warm state flushed)",
              file=sys.stderr)
    return 0
