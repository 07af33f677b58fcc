"""Entry point of the port: one audit sweep, or the admission webhook
beside the audit loop.

    python -m gatekeeper_tpu_torch --manifests DIR --once \
        [--collect reduced|masks] [--device cuda|cpu] \
        [--constraint-violations-limit N] [--audit-chunk-size N] \
        [--audit-source relist|snapshot] [--snapshot-residency auto|on|off]
    python -m gatekeeper_tpu_torch --manifests DIR [--port N] \
        [--certs-dir D] [--tls-min-version 1.2|1.3] [--log-denies] \
        [--webhook-small-batch N] [--webhook-failure-policy fail|ignore] \
        [--device cuda|cpu] [--audit-interval S] [--audit-source ...] \
        [--snapshot-resync-every N] [--snapshot-resync-rotate K]

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

``--audit-source snapshot`` audits the resident columnar snapshot
instead of relisting: the manifests populate an in-memory ``FakeCluster``
that a ``WatchIngester`` watches, the first pass builds the snapshot, and
with ``--snapshot-residency`` ``auto`` (on a CUDA device) or ``on`` its
columns and match masks stay on the device.  ``--once`` prints the same
lines in either mode.

Without ``--once`` the CLI serves ``/v1/admit``, ``/v1/admitlabel`` and
``/healthz`` on ``--port`` (0 picks a free port; stderr prints
``webhook serving on :PORT``) until SIGINT or SIGTERM, then drains.  Beside
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
    args = p.parse_args(argv)
    from gatekeeper_tpu_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now
    objects = load_manifests(args.manifests)
    client, driver = build_client(objects, device=args.device)
    print(f"templates: {len(client.templates())} "
          f"({len(driver.lowered_kinds())} on the device verdict path), "
          f"constraints: {len(client.constraints())}", file=sys.stderr)
    mgr, ingester = build_audit(args, objects, client, driver)
    try:
        if args.once:
            return audit_once(mgr)
        return serve(args, objects, client, mgr)
    finally:
        if ingester is not None:
            ingester.stop()


def build_audit(args, objects, client, driver) -> tuple:
    """(AuditManager, WatchIngester or None) as the flags ask: a relisting
    lister over the manifests, or the resident snapshot fed by a watch on a
    ``FakeCluster`` that holds them."""
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
        resync_rotate=args.snapshot_resync_rotate)
    if args.audit_source != "snapshot":
        return AuditManager(client, lister=lambda: iter(objects),
                            config=config, evaluator=evaluator), None
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
                       residency=residency)
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


def serve(args, objects, client, audit_mgr) -> int:
    """Serve the admission webhook, with ``audit_mgr.run_forever()`` on a
    thread beside it, until SIGINT or SIGTERM; then stop the audit loop and
    drain.  The batcher thread and the audit thread share the device on its
    default stream."""
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
    batcher = Batcher(client, small_batch=args.webhook_small_batch).start()
    try:
        warm_batcher(client, batcher)
        certfile = keyfile = None
        if args.certs_dir:
            certfile = os.path.join(args.certs_dir, "tls.crt")
            keyfile = os.path.join(args.certs_dir, "tls.key")
        server = WebhookServer(
            validation_handler=ValidationHandler(
                client,
                process_excluder=process_excluder(objects),
                namespace_lookup=namespaces.get,
                batcher=batcher,
                log_denies=args.log_denies,
                failure_policy=args.webhook_failure_policy,
            ),
            namespace_label_handler=NamespaceLabelHandler(),
            port=args.port,
            certfile=certfile,
            keyfile=keyfile,
            tls_min_version=args.tls_min_version,
            batcher=batcher,
        ).start()
    except BaseException:
        batcher.stop()
        raise
    print(f"webhook serving on :{server.port}", file=sys.stderr, flush=True)
    auditor = start_audit_loop(audit_mgr)

    stopping = threading.Event()

    def _on_signal(signum, frame):
        print(f"signal {signum}: draining", file=sys.stderr, flush=True)
        server.begin_drain()
        stopping.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    while not stopping.wait(1.0):
        pass
    audit_mgr.stop()
    drained = server.stop()
    # a pass in flight finishes first; the loop exits at its next wait
    auditor.join(timeout=AUDIT_JOIN_S)
    if auditor.is_alive():
        print(f"WARNING: audit pass still running after {AUDIT_JOIN_S:.0f}s "
              f"of drain; abandoned", file=sys.stderr, flush=True)
    batcher.stop()  # idempotent (server.stop drained it already)
    print("drain complete" if drained else
          "WARNING: drain exceeded its budget; in-flight work abandoned",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
