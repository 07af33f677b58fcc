"""Entry point of the port: one audit sweep, or the admission webhook
beside the audit loop.

    python -m gatekeeper_tpu_torch --manifests DIR --once \
        [--collect reduced|masks] [--device cuda|cpu] \
        [--constraint-violations-limit N] [--audit-chunk-size N] \
        [--audit-source relist|snapshot] [--snapshot-residency auto|on|off] \
        [--audit-expand]
    python -m gatekeeper_tpu_torch --manifests DIR [--port N] \
        [--certs-dir D] [--tls-min-version 1.2|1.3] [--log-denies] \
        [--webhook-small-batch N] [--webhook-failure-policy fail|ignore] \
        [--device cuda|cpu] [--audit-interval S] [--audit-source ...] \
        [--snapshot-resync-every N] [--snapshot-resync-rotate K] \
        [--audit-expand] [--mutate-lane batched|host|differential] \
        [--operation audit|webhook|mutation-webhook ...]

Loads ConstraintTemplates, constraints and cluster objects from YAML
(files or directories, ``--manifests`` repeatable).  ``--device`` is where
both the audit sweep and the webhook's batched reviews run.

``--once`` runs one audit sweep on the device and prints the same summary
(stderr) and kept-violation lines (stdout) as ``python -m gatekeeper_tpu
--manifests DIR --once``.  Every manifest object is audited, templates and
constraints included.  The JAX package's CLI runs its controller plane and
also audits the status objects it writes (one ConstraintTemplatePodStatus
per template); the port has no controller plane yet, so its object count
leaves those out.

Mutators (``mutations.gatekeeper.sh``: Assign, AssignMetadata, ModifySet,
AssignImage) load into a ``MutationSystem`` and ExpansionTemplates
(``expansion.gatekeeper.sh``) into an ``ExpansionSystem`` over it.
``--audit-expand`` adds the audit's generator stage: every generator
object (a Deployment, under the reference's ``expand-deployments``
template) expands into its implied resultants, mutated with
``Source=Generated``, and those are audited on the device too, their
violations prefixed ``[Implied by <template>]``.

``--audit-source snapshot`` audits the resident columnar snapshot
instead of relisting: the manifests populate an in-memory ``FakeCluster``
that a ``WatchIngester`` watches, the first pass builds the snapshot, and
with ``--snapshot-residency`` ``auto`` (on a CUDA device) or ``on`` its
columns and match masks stay on the device.  ``--once`` prints the same
lines in either mode.

Without ``--once`` the CLI serves ``/v1/admit``, ``/v1/mutate``,
``/v1/admitlabel`` and ``/healthz`` on ``--port`` (0 picks a free port;
stderr prints ``webhook serving on :PORT``) until SIGINT or SIGTERM, then
drains.  ``/v1/admit`` reviews each generator object's resultants with it.
``/v1/mutate`` answers through the batched mutation lane and its
microbatcher (``--mutate-lane batched``, the default), the per-object
reference handler (``host``) or the batched lane checked against the
reference on every batch (``differential``).  ``--operation`` (repeatable;
default all three) picks what the process runs, as the reference's
process split does: ``audit`` (the audit loop), ``webhook`` (validation)
and ``mutation-webhook`` (mutation); ``--once`` audits whatever it is
given.  Beside
the webhook a thread runs ``AuditManager.run_forever()``: a relist sweep
every ``--audit-interval`` seconds, or in snapshot mode a first full pass,
then an incremental tick per interval and every
``--snapshot-resync-every``-th interval the resync differential.  The
audit thread stops on drain.  The
namespace of a request is looked up among the manifests' Namespace
objects.  ``--certs-dir`` serves TLS from its existing ``tls.crt`` and
``tls.key``.  Before serving, one grid-lane batch of the batcher's largest
size warms the device path.

A ``Config`` named ``config`` is read for ``spec.sync.syncOnly`` (the
kinds synced into ``data.inventory``) and ``spec.match`` (the per-process
namespace exclusions); its other fields are not read.  CEL
(K8sNativeValidation) templates install through a ``CELDriver`` beside the
device driver, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import sys

TEMPLATES_GROUP = "templates.gatekeeper.sh"
CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"
CONFIG_GROUP = "config.gatekeeper.sh"
AUDIT_JOIN_S = 120.0  # drain's wait for an audit pass in flight
# the process split of --operation (reference pkg/operations)
OPERATIONS = ("audit", "webhook", "mutation-webhook")


def load_manifests(paths) -> list:
    """Manifest objects in apply order, deduplicated by (gvk, namespace,
    name): a re-applied object keeps its first position and its last
    content, as an apiserver store would."""
    from gatekeeper_tpu_torch.sync.source import FileSource
    from gatekeeper_tpu_torch.utils.unstructured import (gvk_of, name_of,
                                                         namespace_of)

    store: dict = {}
    for obj in FileSource(*paths).objects:
        if isinstance(obj, dict):
            store[(gvk_of(obj), namespace_of(obj), name_of(obj))] = obj
    return list(store.values())


def is_config(obj) -> bool:
    """True for the gatekeeper ``Config`` object the CLI reads."""
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    group, _v, kind = gvk_of(obj)
    return group == CONFIG_GROUP and kind == "Config" \
        and name_of(obj) == "config"


def process_excluder(objects):
    """The ``ProcessExcluder`` of the Config's ``spec.match``."""
    from gatekeeper_tpu_torch.sync.process import ProcessExcluder

    entries: list = []
    for obj in objects:
        if is_config(obj):
            entries = (obj.get("spec") or {}).get("match") or []
    return ProcessExcluder.from_config_match(entries)


def warm_batcher(client, batcher) -> None:
    """Run one grid-lane batch at the batcher's largest size, so the first
    admission burst does not pay the first-use cost of the device path.
    One batch is enough: the torch evaluation compiles nothing per shape."""
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedUnstructured

    if not client.templates():
        return
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "warmup", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "image": "warmup"}]}}
    warm = [AugmentedUnstructured(object=dict(pod), source=SOURCE_ORIGINAL)
            for _ in range(batcher.max_batch)]
    client.review_batch(warm)


def build_client(objects, device: str = "cuda"):
    """(client, driver) with every template and constraint of
    ``objects`` installed and the Config-synced inventory loaded; the
    driver's batched reviews run on ``device``."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    cel = CELDriver()
    driver = TorchDriver(device=device, cel_driver=cel)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    sync: set = set()
    for obj in objects:
        group, _v, kind = gvk_of(obj)
        if group == TEMPLATES_GROUP and kind == "ConstraintTemplate":
            try:
                client.add_template(obj)
            except Exception as e:
                print(f"template {name_of(obj)} skipped: {e}",
                      file=sys.stderr)
        elif is_config(obj):
            for e in ((obj.get("spec") or {}).get("sync") or {}).get(
                    "syncOnly") or []:
                sync.add((e.get("group", ""), e.get("version", ""),
                          e.get("kind", "")))
    for obj in objects:
        if gvk_of(obj)[0] == CONSTRAINTS_GROUP:
            try:
                client.add_constraint(obj)
            except Exception as e:
                print(f"constraint {name_of(obj)} skipped: {e}",
                      file=sys.stderr)
    for obj in objects:
        if gvk_of(obj) in sync:
            client.add_data(obj)
    return client, driver


def build_mutation(objects) -> tuple:
    """(MutationSystem, ExpansionSystem) with every mutator and
    ExpansionTemplate of ``objects`` installed; the expansion system
    mutates resultants through the mutation system."""
    from gatekeeper_tpu_torch.expansion.system import (EXPANSION_GROUP,
                                                       ExpansionSystem)
    from gatekeeper_tpu_torch.mutation.mutators import (MUTATIONS_GROUP,
                                                        MUTATOR_KINDS)
    from gatekeeper_tpu_torch.mutation.system import MutationSystem
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    mutation_system = MutationSystem()
    expansion_system = ExpansionSystem(mutation_system=mutation_system)
    for obj in objects:
        group, _v, kind = gvk_of(obj)
        try:
            if group == MUTATIONS_GROUP and kind in MUTATOR_KINDS:
                mutation_system.upsert_unstructured(obj)
            elif group == EXPANSION_GROUP and kind == "ExpansionTemplate":
                expansion_system.upsert_template(obj)
        except Exception as e:
            print(f"{kind} {name_of(obj)} skipped: {e}", file=sys.stderr)
    return mutation_system, expansion_system


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gatekeeper_tpu_torch")
    p.add_argument("--manifests", action="append", default=[],
                   help="YAML file or directory (repeatable)")
    p.add_argument("--once", action="store_true",
                   help="run one audit sweep and exit (no server)")
    p.add_argument("--collect", default="reduced",
                   choices=("reduced", "masks"),
                   help="what a sweep chunk brings back from the device")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) runs the hand-written kernels and "
                        "the grid evaluator on the card; cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--constraint-violations-limit", type=int, default=20)
    p.add_argument("--port", type=int, default=8443,
                   help="webhook port (0 picks a free one)")
    p.add_argument("--certs-dir", default="",
                   help="serve TLS with tls.crt and tls.key from this dir")
    p.add_argument("--tls-min-version", default="1.3",
                   choices=["1.2", "1.3"])
    p.add_argument("--log-denies", action="store_true",
                   help="log structured deny events (reference --log-denies)")
    p.add_argument("--webhook-small-batch", type=int, default=None,
                   help="admission batches this size or smaller take the "
                        "per-review interpreter lane instead of the "
                        "device verdict grid (default 8; the lanes agree "
                        "bit for bit)")
    p.add_argument("--webhook-failure-policy", default="fail",
                   choices=["ignore", "fail"],
                   help="what a failed review answers: 'ignore' fails open "
                        "(allow + warning), 'fail' fails closed (deny, "
                        "code 500) — the reference webhook failurePolicy")
    p.add_argument("--audit-interval", type=float, default=60.0,
                   help="seconds between audit passes of a served process")
    p.add_argument("--audit-chunk-size", type=int, default=500)
    p.add_argument("--audit-source", default="relist",
                   choices=["relist", "snapshot"],
                   help="sweep input: 'relist' lists and flattens every "
                        "object every pass; 'snapshot' keeps the "
                        "flattened columns resident between passes, "
                        "patched by watch events: a full pass evaluates "
                        "resident columns and each interval's tick only "
                        "the watch-dirtied rows")
    p.add_argument("--snapshot-resync-every", type=int, default=10,
                   help="snapshot mode: every Nth audit interval runs the "
                        "resync differential (fresh relist asserted equal "
                        "to the snapshot) instead of a tick; 0 = never")
    p.add_argument("--snapshot-resync-rotate", type=int, default=0,
                   help="rotate the resync differential over 1/K of the "
                        "row keyspace per resync; 0/1 = the full "
                        "differential every time")
    p.add_argument("--snapshot-residency", default="auto",
                   choices=["auto", "on", "off"],
                   help="snapshot mode: keep each group's columns and "
                        "match masks on the device, patched by scatter "
                        "('auto': only on a CUDA device; 'on': on any "
                        "device; 'off': host columns)")
    p.add_argument("--audit-expand", action="store_true",
                   help="expansion generator stage in the audit sweep: "
                        "generator objects (per ExpansionTemplate "
                        "applyTo) expand through the batched stage and "
                        "their resultants — implied Pods with "
                        "Source=Generated mutation applied — are audited "
                        "on the device with the template's "
                        "enforcementAction override")
    p.add_argument("--mutate-lane", default="batched",
                   choices=["batched", "host", "differential"],
                   help="/v1/mutate serving lane: 'batched' coalesces "
                        "mutate reviews into one columnar lane pass "
                        "(host fixed-point fallback for unsupported "
                        "mutators); 'host' is the per-object reference "
                        "path; 'differential' runs the batched lane AND "
                        "asserts it bit-identical to the reference per "
                        "batch (debugging)")
    p.add_argument("--operation", action="append", default=[],
                   choices=OPERATIONS,
                   help="audit|webhook|mutation-webhook (repeatable; "
                        "default all)")
    args = p.parse_args(argv)
    from gatekeeper_tpu_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now
    objects = load_manifests(args.manifests)
    client, driver = build_client(objects, device=args.device)
    mutation_system, expansion_system = build_mutation(objects)
    print(f"templates: {len(client.templates())} "
          f"({len(driver.lowered_kinds())} on the device verdict path), "
          f"constraints: {len(client.constraints())}, mutators: "
          f"{len(mutation_system.mutators())}, expansion templates: "
          f"{len(expansion_system.templates())}", file=sys.stderr)
    operations = set(args.operation or OPERATIONS)
    mgr = ingester = None
    if args.once or "audit" in operations:
        mgr, ingester = build_audit(args, objects, client, driver,
                                    expansion_system=expansion_system)
    try:
        if args.once:
            return audit_once(mgr)
        return serve(args, objects, client, mgr, operations,
                     mutation_system, expansion_system)
    finally:
        if ingester is not None:
            ingester.stop()


def build_audit(args, objects, client, driver,
                expansion_system=None) -> tuple:
    """(AuditManager, WatchIngester or None) as the flags ask: a relisting
    lister over the manifests, or the resident snapshot fed by a watch on a
    ``FakeCluster`` that holds them.  With ``--audit-expand`` the manager
    expands generator objects through ``expansion_system``."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    evaluator = SweepEvaluator(
        driver, device=args.device,
        violations_limit=args.constraint_violations_limit,
        collect=args.collect)
    config = AuditConfig(
        interval_s=args.audit_interval,
        violations_limit=args.constraint_violations_limit,
        chunk_size=args.audit_chunk_size,
        audit_source=args.audit_source,
        resync_every=args.snapshot_resync_every,
        resync_rotate=args.snapshot_resync_rotate,
        expand_generated=args.audit_expand)
    if args.audit_source != "snapshot":
        return AuditManager(client, lister=lambda: iter(objects),
                            config=config, evaluator=evaluator,
                            expansion_system=expansion_system), None
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    cluster = FakeCluster()
    for obj in objects:
        cluster.apply(obj)
    snapshot = ClusterSnapshot(evaluator, SnapshotConfig())
    gvks = gvks_of(cluster.list())
    ingester = WatchIngester(
        snapshot, cluster, gvks,
        on_error=lambda e: print(f"snapshot watch subscribe failed: {e}",
                                 file=sys.stderr)).start()
    residency = DeviceResidency(evaluator, mode=args.snapshot_residency)
    print(f"resident snapshot active: watching {len(gvks)} GVKs, resync "
          f"every {args.snapshot_resync_every} intervals, residency "
          f"{args.snapshot_residency}", file=sys.stderr)
    mgr = AuditManager(client, lister=cluster.list, config=config,
                       evaluator=evaluator, snapshot=snapshot,
                       residency=residency,
                       expansion_system=expansion_system)
    return mgr, ingester


def audit_once(mgr) -> int:
    run = mgr.audit()
    total = sum(run.total_violations.values())
    print(f"audit: {run.total_objects} objects, {total} violations "
          f"in {run.duration_s:.2f}s "
          f"(flatten_workers={run.flatten_workers}, "
          f"n_devices={run.n_devices}, "
          f"shard_chunks={run.shard_chunks})"
          + (f" [INCOMPLETE: {run.failed_chunks} chunks dropped, "
             f"{run.retried_chunks} retried]" if run.incomplete
             else ""), file=sys.stderr)
    for key, kept in sorted(run.kept.items()):
        for v in kept:
            print(f"  {key[0]}/{key[1]}: {v.kind} "
                  f"{v.namespace + '/' if v.namespace else ''}{v.name}: "
                  f"{v.message}")
    return 0


def start_audit_loop(audit_mgr):
    """``audit_mgr.run_forever()`` on a daemon thread, returned started.
    It runs beside the webhook's batcher thread, and both intern into the
    driver's vocab (flatten, parameter tables, vocab-derived tables), so
    the vocab's lock is armed first."""
    import threading

    vocab = audit_mgr.evaluator.driver.vocab
    if vocab._lock is None:
        vocab._lock = threading.RLock()
    auditor = threading.Thread(target=audit_mgr.run_forever,
                               name="audit-loop", daemon=True)
    auditor.start()
    return auditor


def mutation_handler(args, mutation_system, namespace_lookup,
                     excluder) -> tuple:
    """(handler, MutationBatcher or None) of ``/v1/mutate`` as
    ``--mutate-lane`` asks: the batched lane behind a started
    microbatcher, or the per-object reference handler."""
    if args.mutate_lane == "host":
        from gatekeeper_tpu_torch.webhook.mutation import MutationHandler

        return MutationHandler(mutation_system,
                               namespace_lookup=namespace_lookup,
                               process_excluder=excluder), None
    from gatekeeper_tpu_torch.mutlane import (BatchedMutationHandler,
                                              MutationBatcher, MutationLane)

    lane = MutationLane(mutation_system,
                        differential=args.mutate_lane == "differential",
                        device=args.device)
    batcher = MutationBatcher(lane).start()
    return BatchedMutationHandler(mutation_system, lane=lane,
                                  namespace_lookup=namespace_lookup,
                                  process_excluder=excluder,
                                  batcher=batcher), batcher


def serve(args, objects, client, audit_mgr, operations, mutation_system,
          expansion_system) -> int:
    """Serve the admission webhook (the ``webhook`` and
    ``mutation-webhook`` operations), with ``audit_mgr.run_forever()`` on
    a thread beside it (the ``audit`` operation), until SIGINT or SIGTERM;
    then stop the audit loop and drain.  The batcher threads and the audit
    thread share the device on its default stream."""
    import os
    import signal
    import threading

    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    namespaces = {name_of(o): o for o in objects
                  if gvk_of(o) == ("", "v1", "Namespace")}
    excluder = process_excluder(objects)
    server = batcher = mutation_batcher = None
    if operations & {"webhook", "mutation-webhook"}:
        try:
            validation = mutation = None
            if "webhook" in operations:
                batcher = Batcher(client,
                                  small_batch=args.webhook_small_batch).start()
                warm_batcher(client, batcher)
                validation = ValidationHandler(
                    client,
                    process_excluder=excluder,
                    namespace_lookup=namespaces.get,
                    batcher=batcher,
                    log_denies=args.log_denies,
                    failure_policy=args.webhook_failure_policy,
                    expansion_system=expansion_system,
                )
            if "mutation-webhook" in operations:
                mutation, mutation_batcher = mutation_handler(
                    args, mutation_system, namespaces.get, excluder)
            certfile = keyfile = None
            if args.certs_dir:
                certfile = os.path.join(args.certs_dir, "tls.crt")
                keyfile = os.path.join(args.certs_dir, "tls.key")
            server = WebhookServer(
                validation_handler=validation,
                mutation_handler=mutation,
                namespace_label_handler=NamespaceLabelHandler(),
                port=args.port,
                certfile=certfile,
                keyfile=keyfile,
                tls_min_version=args.tls_min_version,
                batcher=batcher,
                mutation_batcher=mutation_batcher,
            ).start()
        except BaseException:
            for b in (batcher, mutation_batcher):
                if b is not None:
                    b.stop()
            raise
        print(f"webhook serving on :{server.port} (operations "
              f"{sorted(operations)})", file=sys.stderr, flush=True)
    auditor = start_audit_loop(audit_mgr) if "audit" in operations \
        else None

    stopping = threading.Event()

    def _on_signal(signum, frame):
        print(f"signal {signum}: draining", file=sys.stderr, flush=True)
        if server is not None:
            server.begin_drain()
        stopping.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    while not stopping.wait(1.0):
        pass
    drained = True
    if auditor is not None:
        audit_mgr.stop()
    if server is not None:
        drained = server.stop()
    if auditor is not None:
        # a pass in flight finishes first; the loop exits at its next wait
        auditor.join(timeout=AUDIT_JOIN_S)
        if auditor.is_alive():
            print(f"WARNING: audit pass still running after "
                  f"{AUDIT_JOIN_S:.0f}s of drain; abandoned",
                  file=sys.stderr, flush=True)
    for b in (batcher, mutation_batcher):
        if b is not None:
            b.stop()  # idempotent (server.stop drained it already)
    print("drain complete" if drained else
          "WARNING: drain exceeded its budget; in-flight work abandoned",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
