"""Entry point of the port: one audit sweep, or the admission webhook
beside the audit loop, over manifests or a live apiserver.

    python -m gatekeeper_tpu_torch --manifests DIR --once \
        [--collect reduced|masks|differential] [--device cuda|cpu] \
        [--constraint-violations-limit N] [--audit-chunk-size N] \
        [--audit-source relist|snapshot] [--snapshot-residency auto|on|off] \
        [--audit-expand]
    python -m gatekeeper_tpu_torch --manifests DIR [--port N] \
        [--certs-dir D] [--tls-min-version 1.2|1.3] [--log-denies] \
        [--webhook-small-batch N] [--webhook-failure-policy fail|ignore] \
        [--device cuda|cpu] [--audit-interval S] [--audit-source ...] \
        [--snapshot-resync-every N] [--snapshot-resync-rotate K] \
        [--audit-expand] [--mutate-lane batched|host|differential] \
        [--operation audit|webhook|mutation-webhook ...] \
        [--generation-swap on|off] [--webhook-workers N] [--reuse-port]
    (both modes also take [--extdata-lane batched|perkey|differential]
    [--extdata-max-keys N] [--extdata-fanout N]
    [--pipeline auto|on|off|differential] [--pipeline-flatten-workers N]
    [--flatten-workers N] [--flatten-lane auto|dict|raw|py|differential]
    [--mutate-ingest dict|raw|differential] [--compile-cache DIR]
    [--snapshot-spill DIR] [--snapshot-spill-compress none|zlib]
    [--snapshot-spill-delta] [--snapshot-spill-full-every N]
    [--kubeconfig FILE|in-cluster] [--management-manifests DIR]
    [--readiness-retries N] [--export-dir DIR] [--emit-audit-events]
    [--emit-admission-events] [--gatekeeper-namespace NS] ...)

The boot is the JAX CLI's: the controller ``Manager``
(``controller/manager.py``) starts over the cluster source, a
``KubeCluster`` under ``--kubeconfig`` or an in-memory ``FakeCluster``,
and reconciles ConstraintTemplates (each with a watch on its constraint
kind), constraints, Config and SyncSet (the synced inventory), mutators,
ExpansionTemplates, Providers, Connections and the webhook configuration
into the systems, writing a per-pod status object for each template and
for each object it refuses.  The YAML of ``--manifests`` (files or
directories, repeatable) is then applied to the source; the readiness
tracker expects every template and constraint the source held at boot.
``--device`` is where both the audit sweep and the webhook's batched
reviews run.

``--once`` runs one audit sweep on the device and prints the same summary
(stderr) and kept-violation lines (stdout) as ``python -m gatekeeper_tpu
--manifests DIR --once``.  Every object of the source is audited: the
manifests and the status objects the Manager wrote.  Under
``--kubeconfig`` the audit lists every listable GVK by discovery, in pages
of raw bytes (a GVK whose list fails is skipped), and the snapshot source
watches every such GVK, resuming from a spill's resourceVersions.

Mutators (``mutations.gatekeeper.sh``: Assign, AssignMetadata, ModifySet,
AssignImage) load into a ``MutationSystem`` and ExpansionTemplates
(``expansion.gatekeeper.sh``) into an ``ExpansionSystem`` over it.
``--audit-expand`` adds the audit's generator stage: every generator
object (a Deployment, under the reference's ``expand-deployments``
template) expands into its implied resultants, mutated with
``Source=Generated``, and those are audited on the device too, their
violations prefixed ``[Implied by <template>]``.

Provider manifests (``externaldata.gatekeeper.sh`` ``Provider``) load
into one ``ProviderCache``; a Provider that fails validation (a URL that
is not https, no ``caBundle``) is not loaded, and its status object
carries the error.  One
``ExtDataLane`` over that cache (``--extdata-lane``, default ``batched``)
is installed for the process: templates that call ``external_data`` join
``ext:`` tables on the device grid at admission and in the audit, their
keys deduped per batch and fetched in bulk (``--extdata-max-keys`` per
transport send, ``--extdata-fanout`` providers at once), and
``externalData`` Assign placeholders at ``/v1/mutate`` resolve through the
same lane.  ``perkey`` keeps external-data templates on the interpreter
with one provider call per key; ``differential`` runs the batched lane and
checks it against the per-key path.  stderr prints ``extdata lane: MODE``
when the mode is not ``batched``.

The relist sweep's schedule is ``--pipeline``: ``on`` runs the staged
host pipeline (flatten, dispatch, collect and fold on threads of their
own), ``off`` the serial schedule, ``differential`` both, raising on any
difference; ``auto`` (the default) resolves to serial, because the
port's stages share the interpreter lock and the pipeline measured
slower (``pipeline.resolve_schedule``).  The snapshot source always
evaluates serially.  stderr prints the schedule that runs and the
effective core count.
``--pipeline-flatten-workers`` sets the flatten stage's threads.
``--flatten-lane`` picks the sweep's columnizer (``raw`` serializes the
listed objects once and columnizes the bytes in C with the interpreter
lock released), ``--flatten-workers N`` fans raw-lane chunks over N
worker processes, and ``--mutate-ingest`` picks the ``/v1/mutate``
burst's columnizer.

``--audit-source snapshot`` audits the resident columnar snapshot
instead of relisting: a ``WatchIngester`` watches the cluster source, the
first pass builds the snapshot, and
with ``--snapshot-residency`` ``auto`` (on a CUDA device) or ``on`` its
columns and match masks stay on the device.  ``--once`` prints the same
lines in either mode.

Without ``--once`` the CLI serves ``/v1/admit``, ``/v1/mutate``,
``/v1/admitlabel`` and ``/healthz`` on ``--port`` (0 picks a free port;
stderr prints ``webhook serving on :PORT``) until SIGINT or SIGTERM, then
drains; ``/healthz`` answers 503 until the readiness tracker has observed
every expected template and constraint, then 200, both with the tracker's
stats.  ``/v1/admit`` reviews each generator object's resultants with it;
its namespace lookup reads the resident snapshot first, then the source
(under ``--kubeconfig`` a watch-fed cache with a GET fallback).
``/v1/mutate`` answers through the batched mutation lane and its
microbatcher (``--mutate-lane batched``, the default), the per-object
reference handler (``host``) or the batched lane checked against the
reference on every batch (``differential``).  ``--operation`` (repeatable;
default all) picks what the process runs, as the reference's
process split does: ``audit`` (the audit loop), ``webhook`` (validation)
and ``mutation-webhook`` (mutation); ``--once`` audits whatever it is
given.  Beside
the webhook a thread runs ``AuditManager.run_forever()``: a relist sweep
every ``--audit-interval`` seconds, or in snapshot mode a first full pass,
then an incremental tick per interval and every
``--snapshot-resync-every``-th interval the resync differential.  The
audit thread stops on drain.  ``--certs-dir`` serves TLS from its
``tls.crt`` and ``tls.key``, generating them when missing (under
``--kubeconfig`` through the certificate Secret, with the caBundle
injected into the webhook configurations), renewed by a rotation loop
every ``--cert-rotation-check-s``; ``--client-ca-file`` requires client
certificates.  Before serving, one grid-lane batch of the batcher's
largest size warms the device path.  ``--emit-admission-events`` and
``--emit-audit-events`` write Events to the source, ``--export-dir``
exports each audit's violations to disk, and ``--exempt-namespace*``,
``--fail-open-on-error`` and ``--log-stats-admission`` are the JAX CLI's.

The served process's lifecycle.  Boot, in this order: the Manager and the
manifests, templates installing through ``--compile-cache`` (lowered programs keyed by template digest and
the torch and CUDA versions; a warm boot lowers nothing), constraints,
data, mutators; with ``--audit-source snapshot`` and ``--snapshot-spill``
the spill loads before the first pass (a hit: the watch resubscribes from
the spilled resourceVersions and the loop starts with an incremental tick;
a miss: a clean relist), then the spill's generated verdicts; with
``--compile-cache`` the warm state (the sweep's hit-buffer sizing and the
last admission batch) replays; then the template generation coordinator
starts (``--generation-swap on``, the default: later template changes
compile on a background thread and swap in atomically; ``off`` lowers
them inline).  Drain, in this order: the webhook stops accepting and
finishes what it holds, the audit loop stops, the final spill, the warm
state's save, the coordinator's stop, and the worker processes, each
terminated and waited for in turn.  ``--webhook-workers N`` starts N - 1
children before anything touches the card (``python -m
gatekeeper_tpu_torch`` with this argv less ``--webhook-workers``,
``--operation`` and ``--once``, plus ``--reuse-port --operation webhook
--operation mutation-webhook``): each is a whole replica of the serving
stack with its own CUDA context, bound to the same port with
``SO_REUSEPORT``, and the audit runs in the parent only.  It needs an
explicit ``--port``; with ``--certs-dir`` a missing certificate pair is
generated before the children start, and only the parent rotates it;
``--once`` ignores it.

The served process's hooks are built before anything else, in the JAX
CLI's order, and uninstalled on every exit path: the span tracer
(``--trace FILE`` writes a Chrome trace at exit, after the drain;
``--trace-buffer`` serves the ring at ``/debug/traces`` only), the chaos
plan (``--chaos spec.json``), the drain coordinator, the overload
controller (``--overload-limiter on``, the default: an AIMD limiter and a
cost-bounded queue in front of both webhooks, shedding by failurePolicy,
its brownout ladder reaching the audit's device lane and the
external-data cache; ``--qos on`` adds priority lanes and tenant
fairness), cost attribution (``--cost-attribution on``, served at
``/debug/cost``), the flight recorder (``--flight-recorder 2048``,
``/debug/decisions``), the SLO degradation maps (``--slo-degradation``)
and the SLO engine (``--slo on``, ``/debug/slo``).  ``--once`` skips the
limiter, the flight recorder and the SLO engine.  ``/metrics`` serves the
process's registry, ``/debug/overload`` the controller's state and
``/debug/profile`` (with ``--enable-profile``) a cProfile.
``--webhook-deadline S`` bounds each admission's wall time: on expiry the
answer follows ``--webhook-failure-policy``.  A SIGTERM begins the drain
(``--shutdown-delay`` more seconds of serving with ``/healthz`` at 503,
then ``--drain-timeout`` for what the server holds); a second signal
while draining is ignored.  ``--shadow-candidate DIR`` (served only) loads
a candidate library on ``--device`` and installs a ``replay/shadow``
lane that decides a copy of every served admission against it off the
response path (``/debug/shadow``; ``--shadow-sink F`` records those
verdicts; its divergence objective joins the default SLO set).

``--fleet-config ROSTER`` is its own process shape (``fleet/run.py``): N
clusters' audits behind one runtime per template library, one packed
pass with ``--once`` or one per ``--audit-interval``; the other
single-cluster flags do not apply.

A ``Config`` named ``config`` is read for ``spec.sync.syncOnly`` (the
kinds synced into ``data.inventory``), ``spec.match`` (the per-process
namespace exclusions) and ``spec.validation.traces`` (per-request
traces).  CEL
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
# the interpreter's thread switch interval while serving (Python's default
# is 5 ms): small webhook batches take the per-review Rego interpreter,
# which holds the interpreter lock in pure Python, so at 5 ms the
# connection threads waited whole intervals to read a request or write an
# answer, and under 64 clients the limiter's queue timed out behind them
SERVING_SWITCH_INTERVAL_S = 0.001
# the served CLI's interpreter-lane threshold when --webhook-small-batch is
# not given: a grid batch costs ~0.2 s of host time plus ~3 ms a review on
# an H100's host against ~8 ms a review on the interpreter lane, so the
# lane pays off only past ~50 reviews (the JAX CLI's 8 is a TPU's
# crossover); below that, medium batches stalled every admission behind them
WEBHOOK_SMALL_BATCH = 32


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


def webhook_small_batch(args) -> int:
    """The served webhook's interpreter-lane threshold: the flag, else
    ``WEBHOOK_SMALL_BATCH``."""
    if args.webhook_small_batch is None:
        return WEBHOOK_SMALL_BATCH
    return args.webhook_small_batch


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


def new_client(device: str = "cuda", generation_swap: bool = False,
               compile_cache=None, metrics=None) -> tuple:
    """(client, driver), empty: a ``TorchDriver`` whose batched reviews run
    on ``device`` beside a ``CELDriver``, as the JAX CLI builds them.  With
    ``generation_swap`` the driver gets a (not yet started)
    ``GenerationCoordinator``, whose warm reads the client's constraints;
    ``compile_cache`` is a ``CompileCache`` the template installs go
    through."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget

    cel = CELDriver()
    driver = TorchDriver(device=device, cel_driver=cel,
                         generation_swap=generation_swap,
                         compile_cache=compile_cache, metrics=metrics)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    if driver.gen_coord is not None:
        driver.gen_coord.constraints_fn = client.constraints
    return client, driver


def build_client(objects, device: str = "cuda",
                 generation_swap: bool = False, compile_cache=None,
                 metrics=None):
    """(client, driver) of :func:`new_client` with every template and
    constraint of ``objects`` installed and the Config-synced inventory
    loaded (the benches' and tests' fixture; the CLI installs through the
    controller ``Manager``)."""
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    client, driver = new_client(device=device,
                                generation_swap=generation_swap,
                                compile_cache=compile_cache, metrics=metrics)
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


def new_extdata(mode: str = "batched", max_keys: int = 256,
                fanout: int = 4, metrics=None) -> tuple:
    """(ProviderCache, ExtDataLane): an empty cache and a lane over it in
    ``mode``, installed for the process (the webhook's batches, the audit
    sweep and the mutation placeholders all join through it)."""
    from gatekeeper_tpu_torch.extdata import lane as extlane
    from gatekeeper_tpu_torch.externaldata.providers import ProviderCache

    cache = ProviderCache(metrics=metrics)
    lane = extlane.ExtDataLane(cache, mode=mode, max_keys_per_call=max_keys,
                               metrics=metrics, fanout=fanout)
    extlane.install(lane)
    return cache, lane


def build_extdata(objects, mode: str = "batched", max_keys: int = 256,
                  fanout: int = 4, metrics=None) -> tuple:
    """:func:`new_extdata` with every Provider manifest of ``objects``
    loaded into the cache (a fixture; the CLI reconciles Providers through
    the controller ``Manager``).  A Provider that
    ``Provider.from_unstructured`` refuses is reported on stderr and not
    loaded."""
    from gatekeeper_tpu_torch.externaldata.providers import (PROVIDER_GROUP,
                                                             ProviderError)
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    cache, lane = new_extdata(mode=mode, max_keys=max_keys, fanout=fanout,
                              metrics=metrics)
    for obj in objects:
        group, _v, kind = gvk_of(obj)
        if group != PROVIDER_GROUP or kind != "Provider":
            continue
        try:
            cache.upsert(obj)
        except ProviderError as e:
            print(f"Provider {name_of(obj)} skipped: {e}", file=sys.stderr)
            continue
        # a lane wired to another cache still drops the provider's columns
        lane.invalidate(name_of(obj))
    return cache, lane


def build_mutation(objects, provider_cache=None) -> tuple:
    """(MutationSystem, ExpansionSystem) with every mutator and
    ExpansionTemplate of ``objects`` installed; the expansion system
    mutates resultants through the mutation system, and external-data
    placeholders resolve per key through ``provider_cache`` where no
    batched lane is active."""
    from gatekeeper_tpu_torch.expansion.system import (EXPANSION_GROUP,
                                                       ExpansionSystem)
    from gatekeeper_tpu_torch.mutation.mutators import (MUTATIONS_GROUP,
                                                        MUTATOR_KINDS)
    from gatekeeper_tpu_torch.mutation.system import MutationSystem
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    mutation_system = MutationSystem(provider_cache=provider_cache)
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
    p = build_parser()
    args = p.parse_args(argv)
    if args.fleet_config:
        # fleet mode is its own process shape (N clusters' audit planes
        # behind shared runtimes): the single-cluster wiring does not apply
        from gatekeeper_tpu_torch.fleet.run import run_fleet

        return run_fleet(args)
    workers = start_workers(p, args, argv)
    try:
        return run(args, workers)
    finally:
        stop_workers(workers)


def abandoned_audit() -> bool:
    """True when a drain left an audit pass running (``serve`` waits
    ``AUDIT_JOIN_S`` for it): its daemon thread may be inside torch or the
    native columnizer, which the interpreter's teardown would abort."""
    import threading

    return any(t.name == "audit-loop" and t.is_alive()
               for t in threading.enumerate())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gatekeeper_tpu_torch")
    p.add_argument("--manifests", action="append", default=[],
                   help="YAML file or directory (repeatable)")
    p.add_argument("--kubeconfig", default="",
                   help="run against a live Kubernetes apiserver (watch + "
                        "paged list informer plane); 'in-cluster' uses the "
                        "service-account environment")
    p.add_argument("--management-manifests", default="",
                   help="remote-cluster mode: status/secret state routes to "
                        "a separate management cluster seeded from this "
                        "directory (reference --enable-remote-cluster)")
    p.add_argument("--readiness-retries", type=int, default=0,
                   help="ingestion attempts allowed before a failing "
                        "resource's readiness expectation is cancelled; "
                        "-1 retries indefinitely (reference "
                        "--readiness-retries, object_tracker.go:36)")
    p.add_argument("--export-dir", default="",
                   help="enable disk export of audit violations")
    p.add_argument("--emit-admission-events", action="store_true",
                   help="emit K8s Events on admission violations "
                        "(reference --emit-admission-events)")
    p.add_argument("--admission-events-involved-namespace",
                   action="store_true",
                   help="emit admission Events in the violating object's "
                        "namespace instead of the gatekeeper namespace")
    p.add_argument("--emit-audit-events", action="store_true",
                   help="emit K8s Events on audit violations "
                        "(reference --emit-audit-events)")
    p.add_argument("--audit-events-involved-namespace",
                   action="store_true",
                   help="emit audit Events in the violating object's "
                        "namespace instead of the gatekeeper namespace")
    p.add_argument("--gatekeeper-namespace", default="gatekeeper-system",
                   help="namespace Events land in by default")
    p.add_argument("--log-stats-admission", action="store_true",
                   help="log per-request evaluation stats (reference "
                        "--log-stats-admission)")
    p.add_argument("--client-ca-file", default="",
                   help="require and verify client certificates against "
                        "this CA (reference --client-ca-name)")
    p.add_argument("--cert-rotation-check-s", type=float, default=3600.0,
                   help="cert expiry check interval for the rotation loop")
    p.add_argument("--fail-open-on-error", action="store_true",
                   help="admit (with a warning) when the review path raises "
                        "internally, instead of the reference's Errored "
                        "allowed=false code-500 response")
    p.add_argument("--exempt-namespace", action="append", default=[],
                   help="namespace allowed to set the ignore label "
                        "(repeatable; reference --exempt-namespace)")
    p.add_argument("--exempt-namespace-prefix", action="append", default=[],
                   help="namespace name prefix allowed to set the ignore "
                        "label (repeatable)")
    p.add_argument("--exempt-namespace-suffix", action="append", default=[],
                   help="namespace name suffix allowed to set the ignore "
                        "label (repeatable)")
    p.add_argument("--once", action="store_true",
                   help="run one audit sweep and exit (no server)")
    p.add_argument("--fleet-config", default="",
                   help="fleet mode: JSON roster of clusters "
                        "({'clusters': [{'id': ..., 'manifests': "
                        "[...]}], 'packChunks': 0}); one process runs "
                        "every cluster's audit plane behind shared "
                        "per-library runtimes (a second same-library "
                        "cluster boots with zero lowering) and packs small "
                        "clusters' same-group chunks into one dispatch. "
                        "Honors --compile-cache, --snapshot-spill "
                        "(per-cluster subdirs), --audit-interval, "
                        "--audit-chunk-size, --collect, --device, --once")
    p.add_argument("--collect", default="reduced",
                   choices=("reduced", "masks", "differential"),
                   help="what a sweep chunk brings back from the device: "
                        "'reduced' folds on the device (fused_fold), "
                        "'masks' ships the grid's first-k and folds on the "
                        "host (epilogue), 'differential' runs both per "
                        "chunk and raises on any difference")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) runs the hand-written kernels and "
                        "the grid evaluator on the card; cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--constraint-violations-limit", type=int, default=20)
    p.add_argument("--port", type=int, default=8443,
                   help="webhook port (0 picks a free one)")
    p.add_argument("--certs-dir", default="",
                   help="serve TLS using (or generating) certs in this dir")
    p.add_argument("--tls-min-version", default="1.3",
                   choices=["1.2", "1.3"])
    p.add_argument("--log-denies", action="store_true",
                   help="log structured deny events (reference --log-denies)")
    p.add_argument("--webhook-small-batch", type=int, default=None,
                   help="admission batches this size or smaller take the "
                        "per-review interpreter lane instead of the "
                        "device verdict grid (default 32, the crossover on "
                        "an H100's host; the lanes agree bit for bit)")
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
    p.add_argument("--extdata-lane", default="batched",
                   choices=["batched", "perkey", "differential"],
                   help="external-data resolution lane: 'batched' dedupes "
                        "provider keys across each admission burst / audit "
                        "chunk, bulk-fetches per provider into resident "
                        "columns and joins verdicts on device; 'perkey' "
                        "keeps the per-key ProviderCache reference path "
                        "(external-data templates stay on the exact "
                        "interpreter); 'differential' runs batched AND "
                        "asserts verdicts + resolved values bit-identical "
                        "to per-key")
    p.add_argument("--extdata-max-keys", type=int, default=256,
                   help="max keys per bulk provider call (the batched "
                        "lane chunks larger deduped miss lists into "
                        "multiple transport sends)")
    p.add_argument("--extdata-fanout", type=int, default=4,
                   help="per-provider concurrency of the batched lane's "
                        "bulk fetches: a chunk referencing N providers "
                        "lands their miss lists across this many threads "
                        "(1 = strictly serial, the pre-fanout behavior)")
    p.add_argument("--mutate-ingest", default="dict",
                   choices=["dict", "raw", "differential"],
                   help="/v1/mutate burst columnizer: 'dict' keeps the "
                        "dict-walk lane byte-for-byte; 'raw' serializes "
                        "each burst once and feeds the raw-bytes "
                        "threaded C columnizer (GIL released) — match "
                        "walks and patch emission still read the dict "
                        "objects, so outcomes are lane-invariant; "
                        "'differential' runs raw THEN dict per batch "
                        "and asserts the columns bit-identical")
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "on", "off", "differential"],
                   help="audit sweep schedule: 'on' runs the staged "
                        "host pipeline (list->flatten->dispatch->collect"
                        "->fold on separate threads, bounded queues); "
                        "'off' the serial eager-poll schedule; 'auto' "
                        "resolves to serial (the stages share the "
                        "interpreter lock, so they do not overlap); "
                        "'differential' runs both and asserts "
                        "bit-identical output (debugging)")
    p.add_argument("--pipeline-flatten-workers", type=int, default=0,
                   help="threads in the pipeline's flatten stage; 0 = "
                        "auto (2 when the host has >=4 effective cores). "
                        "The C columnizer already shards each chunk over "
                        "an internal pthread pool; extra workers overlap "
                        "the Python assembly slices across chunks")
    p.add_argument("--flatten-workers", type=int, default=0,
                   help="multiprocess flatten worker pool for sweep "
                        "chunks: fan contiguous RawJSON byte spans of "
                        "each chunk across N worker PROCESSES (each runs "
                        "the C columnizer against a batch-local vocab; "
                        "results merge into the shared vocab on the "
                        "flattening thread, bit-identical to in-process "
                        "— see ops/flatten.FlattenWorkerPool). 0 = the "
                        "exact in-process path (the 1-core default); "
                        "with --flatten-lane differential the worker "
                        "pool is additionally asserted column- and "
                        "vocab-identical per chunk")
    p.add_argument("--flatten-lane", default="auto",
                   choices=["auto", "dict", "raw", "py", "differential"],
                   help="sweep columnizer lane: 'auto' feeds raw JSON "
                        "bytes from the lister straight through the "
                        "threaded C columnizer when available (falling "
                        "back to the GIL-bound dict walker, then "
                        "Python); 'raw'/'dict'/'py' force a lane; "
                        "'differential' runs raw THEN dict per chunk "
                        "and asserts bit-identical columns (debugging)")
    p.add_argument("--operation", action="append", default=[],
                   help="audit|webhook|mutation-webhook (repeatable; "
                        "default all)")
    p.add_argument("--generation-swap", default="on", choices=["on", "off"],
                   help="template changes after boot: 'on' stages them, "
                        "compiles the next generation on a background "
                        "thread and swaps it in atomically (the serving "
                        "path never lowers); 'off' lowers inline.  Boot is "
                        "synchronous either way")
    p.add_argument("--compile-cache", default="",
                   help="directory of the on-disk compile cache: lowered "
                        "template programs keyed by (template digest, "
                        "engine, torch and CUDA versions, flatten-schema "
                        "version) with a vocab snapshot replay, and the "
                        "warm state; a warm restart or --once run lowers "
                        "nothing.  Workers share it")
    p.add_argument("--snapshot-spill", default="",
                   help="snapshot mode: directory of the on-disk spill of "
                        "the resident audit state (columns, vocab, row "
                        "ids, verdicts, per-GVK resourceVersions).  A valid "
                        "spill warm-starts the auditor; a corrupt or "
                        "drifted one is deleted and the boot relists.  "
                        "Spills are written off the audit thread after "
                        "each clean resync and at drain")
    p.add_argument("--snapshot-spill-compress", default="none",
                   choices=["none", "zlib"],
                   help="spill section codec; the loader reads either")
    p.add_argument("--snapshot-spill-delta", action="store_true",
                   help="incremental spills: per-group section files, and "
                        "a spill rewrites only the groups whose rows "
                        "changed since the last write")
    p.add_argument("--snapshot-spill-full-every", type=int, default=8,
                   help="delta spills: every Nth spill rewrites every "
                        "group and prunes orphaned files (default 8)")
    p.add_argument("--webhook-workers", type=int, default=1,
                   help="serve the webhook from N processes sharing one "
                        "port through SO_REUSEPORT (each a full replica of "
                        "the serving stack; the audit runs in the parent "
                        "only)")
    p.add_argument("--reuse-port", action="store_true",
                   help="bind the webhook port with SO_REUSEPORT (set for "
                        "--webhook-workers children)")
    add_hook_flags(p)
    return p


def add_hook_flags(p: argparse.ArgumentParser) -> None:
    """The served process's hook flags, with the JAX CLI's defaults and
    help."""
    p.add_argument("--shutdown-delay", type=float, default=0.0,
                   help="seconds to keep serving after SIGTERM before "
                        "shutting down (reference --shutdown-delay); "
                        "readiness answers 503 {draining:true} for the "
                        "whole window so the LB deregisters first")
    p.add_argument("--drain-timeout", type=float, default=10.0,
                   help="graceful-drain budget in seconds: after SIGTERM "
                        "(and --shutdown-delay) the listener stops "
                        "accepting and in-flight admissions + the "
                        "batcher queue drain to completion within this "
                        "budget — zero accepted verdicts lost")
    p.add_argument("--webhook-backlog", type=int, default=128,
                   help="kernel listen(2) accept-queue depth for the "
                        "webhook socket (unanswered TCP connects; "
                        "distinct from the overload limiter's cost-aware "
                        "admission queue, which holds ACCEPTED requests "
                        "waiting for a review slot)")
    p.add_argument("--overload-limiter", default="on",
                   choices=["on", "off"],
                   help="adaptive-concurrency admission gate in front of "
                        "the validating webhook (AIMD on review latency "
                        "vs a baseline EWMA + bounded cost-aware queue); "
                        "'on' is bit-identical to 'off' while unloaded "
                        "(differential-tested); sheds resolve per "
                        "--webhook-failure-policy")
    p.add_argument("--overload-max-inflight", type=int, default=64,
                   help="upper bound of the adaptive in-flight limit")
    p.add_argument("--overload-queue-depth", type=int, default=256,
                   help="max requests waiting in the admission queue "
                        "before sheds begin")
    p.add_argument("--overload-queue-cost", type=float, default=256e6,
                   help="max summed admission cost (object bytes x "
                        "matched-constraint estimate) queued before "
                        "sheds begin")
    p.add_argument("--qos", default="off", choices=["on", "off"],
                   help="per-tenant / per-priority admission QoS on the "
                        "overload path: priority lanes (system / "
                        "break-glass ahead of user traffic, shed last), "
                        "weighted-fair (deficit-round-robin) dequeue "
                        "across tenants, per-tenant inflight caps + "
                        "queue-cost budgets, and tenant-aware "
                        "displacement (the heaviest tenant sheds "
                        "first).  'off' (the default) keeps the single "
                        "cost-aware FIFO")
    p.add_argument("--qos-config", default="",
                   help="JSON file of QoS priority levels / tenant "
                        "weights / caps, mirroring the apiserver APF "
                        "PriorityLevel shape; empty = the built-in lane "
                        "set (kube-system + gatekeeper-system + system: "
                        "users ahead of break-glass ahead of everyone, "
                        "namespace as the tenant key)")
    p.add_argument("--qos-ledger-decay", default="events",
                   choices=["events", "slo-window"],
                   help="decay driver for the QoS displacement ledger "
                        "(who is 'heaviest'): 'events' (the default) "
                        "halves totals per fixed charge count — "
                        "deterministic replay; 'slo-window' halves them "
                        "per elapsed SLO short-window on the SLO "
                        "engine's clock")
    p.add_argument("--enable-profile", action="store_true",
                   help="serve /debug/profile?seconds=N (pprof equivalent)")
    p.add_argument("--chaos", default="",
                   help="fault-injection spec (JSON file: {\"seed\": 0, "
                        "\"faults\": [{\"site\": ..., \"mode\": sleep|"
                        "hang|error|partial, ...}]}) installed process-"
                        "wide — the deterministic chaos harness for "
                        "exercising the resilience layer")
    p.add_argument("--trace", default="",
                   help="write a Chrome trace-event JSON (Perfetto-"
                        "loadable) of the kept traces to this path on "
                        "exit; also serves the live tail-sampled ring "
                        "buffer at /debug/traces next to /metrics")
    p.add_argument("--trace-buffer", action="store_true",
                   help="enable the span tracer without a file export "
                        "(ring buffer served at /debug/traces only)")
    p.add_argument("--trace-slow-ms", type=float, default=0.0,
                   help="tail-sampling latency threshold: traces whose "
                        "root span is slower than this are ALWAYS kept; "
                        "the rest keep at --trace-sample (0 = no "
                        "threshold, keep per --trace-sample alone)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="keep probability for traces under the "
                        "--trace-slow-ms threshold (1.0 keeps all; 0.0 "
                        "is the empty sampler — span machinery runs, "
                        "nothing retained)")
    p.add_argument("--trace-seed", type=int, default=None,
                   help="seed the trace/span ID generator and sampler "
                        "(deterministic IDs for differential runs; "
                        "default: OS entropy)")
    p.add_argument("--cost-attribution", default="on",
                   choices=["on", "off"],
                   help="per-template cost attribution: shared device "
                        "passes apportion wall time across the "
                        "constraint grid by row occupancy "
                        "(gatekeeper_constraint_eval_seconds, "
                        "/debug/cost)")
    p.add_argument("--slo", default="on", choices=["on", "off"],
                   help="in-process SLO engine: declarative objectives "
                        "(admission/mutate P99, shed rate, audit "
                        "staleness) with multi-window burn rates — "
                        "gatekeeper_slo_* gauges, /debug/slo, breach "
                        "span events")
    p.add_argument("--slo-config", default="",
                   help="JSON file of SLO objectives (and optional burn "
                        "tiers) replacing the built-in defaults")
    p.add_argument("--slo-interval", type=float, default=10.0,
                   help="seconds between SLO engine evaluations")
    p.add_argument("--slo-brownout", action="store_true",
                   help="feed SLO burn into the overload brownout "
                        "ladder: a burning latency objective browns out "
                        "optional work (stale lookups, audit device-"
                        "lane yield) BEFORE the admission queue backs "
                        "up (off keeps the ladder queue-driven only)")
    p.add_argument("--slo-degradation", default="off",
                   choices=["on", "off"],
                   help="targeted degradation maps: each objective's "
                        "ordered, revocable action list (ns_cache_stale "
                        "-> extdata_stale -> shed_harder; "
                        "audit_yield_release -> resync_defer) activates "
                        "step-by-step on burn breach and releases in "
                        "reverse on recovery")
    p.add_argument("--flight-recorder", type=int, default=2048,
                   help="admission flight recorder: ring capacity of "
                        "structured admission/mutation/shed decision "
                        "records served at /debug/decisions?uid= "
                        "(0 disables)")
    p.add_argument("--flight-recorder-sink", default="",
                   help="append every flight-recorder decision to this "
                        "JSONL file (decision metadata only, never "
                        "object bodies — unless --flight-recorder-capture)")
    p.add_argument("--flight-recorder-sink-max-mb", type=float,
                   default=0.0,
                   help="rotate the sink when it reaches this many MB "
                        "(sink -> sink.1 -> sink.2 ...; 0 = unbounded)")
    p.add_argument("--flight-recorder-sink-keep", type=int, default=3,
                   help="rotated sink files retained past the live one "
                        "(oldest dropped on rotation)")
    p.add_argument("--shadow-candidate", action="append", default=[],
                   help="shadow canary: candidate library file or dir "
                        "(repeatable). Copies of served admissions are "
                        "decided against it off the response path "
                        "(replay/shadow.py); /debug/shadow, the "
                        "gatekeeper_shadow_* metrics and the "
                        "shadow-divergence-rate SLO objective carry the "
                        "promote/abort signal")
    p.add_argument("--shadow-sink", default="",
                   help="append shadow verdicts to this JSONL file (the "
                        "shadow flight-recorder stream)")
    p.add_argument("--flight-recorder-capture", action="store_true",
                   help="capture mode: sink lines additionally carry "
                        "the raw admission request. The in-memory ring "
                        "stays metadata-only; the sink then holds "
                        "Secrets-grade data")
    p.add_argument("--webhook-deadline", type=float, default=0.0,
                   help="per-admission wall-clock budget in seconds; on "
                        "expiry the request resolves per "
                        "--webhook-failure-policy instead of stalling "
                        "the apiserver (0 disables)")


class Hooks:
    """The served process's hooks, as :func:`build_hooks` installs them:
    every piece is a process-global install (``None`` where its flag
    leaves it off), and :meth:`close` stops and uninstalls them all."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.tracer = None
        self.chaos = None
        self.drain = None
        self.overload = None
        self.cost_attr = None
        self.flight_rec = None
        self.degradations = None
        self.slo_engine = None
        self.shadow = None  # replay/shadow.ShadowLane (--shadow-candidate)
        self.trace_path = ""

    def export_trace(self) -> None:
        """Write the kept traces as Chrome trace events (``--trace``)."""
        if self.tracer is None or not self.trace_path:
            return
        from gatekeeper_tpu_torch.observability import write_chrome_trace

        n = write_chrome_trace(self.trace_path, self.tracer)
        print(f"trace: {n} events ({self.tracer.kept} traces kept, "
              f"{self.tracer.sampled_out} sampled out) -> "
              f"{self.trace_path} (load in ui.perfetto.dev or "
              f"chrome://tracing)", file=sys.stderr)

    def close(self) -> None:
        from gatekeeper_tpu_torch.observability import (costattr, flightrec,
                                                        tracing)
        from gatekeeper_tpu_torch.replay import shadow
        from gatekeeper_tpu_torch.resilience import faults, overload

        if self.shadow is not None:
            shadow.uninstall()
            self.shadow.stop()
            if self.shadow.recorder is not None:
                self.shadow.recorder.close()  # flush the shadow sink
        if self.slo_engine is not None:
            self.slo_engine.stop()
        if self.flight_rec is not None:
            self.flight_rec.close()  # flush the JSONL sink
        for installed, uninstall in (
                (self.tracer, tracing.uninstall),
                (self.chaos, faults.uninstall),
                (self.overload, overload.uninstall),
                (self.cost_attr, costattr.uninstall),
                (self.flight_rec, flightrec.uninstall),
                (self.degradations, overload.uninstall_degradations)):
            if installed is not None:
                uninstall()
        if self.chaos is not None:
            faults.set_metrics_registry(None)


def build_hooks(args) -> Hooks:
    """Build and install the hooks the flags ask for, in the JAX CLI's
    order: tracer, chaos plan, drain coordinator, overload controller,
    cost attribution, flight recorder, degradations, SLO engine.  On a
    failure every piece installed so far is uninstalled before the error
    propagates."""
    from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry

    hooks = Hooks(MetricsRegistry())
    try:
        _install_hooks(args, hooks)
    except BaseException:
        hooks.close()
        raise
    return hooks


def _install_hooks(args, hooks: Hooks) -> None:
    from gatekeeper_tpu_torch.observability import costattr, flightrec, slo
    from gatekeeper_tpu_torch.resilience import overload

    metrics = hooks.metrics
    if args.trace or args.trace_buffer:
        from gatekeeper_tpu_torch.observability import tracing

        hooks.tracer = tracing.Tracer(
            seed=args.trace_seed,
            slow_threshold_s=(args.trace_slow_ms / 1000.0
                              if args.trace_slow_ms > 0 else None),
            sample_rate=args.trace_sample, metrics=metrics)
        hooks.trace_path = args.trace
        tracing.install(hooks.tracer)
        print("span tracer active"
              + (f" (export: {args.trace})" if args.trace else
                 " (ring buffer at /debug/traces)"), file=sys.stderr)
    if args.chaos:
        from gatekeeper_tpu_torch.resilience import faults

        faults.set_metrics_registry(metrics)
        hooks.chaos = faults.load_chaos_spec(args.chaos)
        faults.install(hooks.chaos)
        print(f"chaos harness active: {args.chaos}", file=sys.stderr)
    hooks.drain = overload.DrainCoordinator(metrics=metrics)
    if args.overload_limiter == "on" and not args.once:
        from gatekeeper_tpu_torch.resilience.qos import qos_from_args

        qos_cfg = qos_from_args(args.qos, args.qos_config)
        hooks.overload = overload.OverloadController(
            overload.OverloadConfig(
                max_inflight=args.overload_max_inflight,
                queue_depth=args.overload_queue_depth,
                queue_cost=args.overload_queue_cost,
                qos=qos_cfg),
            metrics=metrics)
        overload.install(hooks.overload)
        if qos_cfg is not None:
            print(f"admission QoS active: {len(qos_cfg.levels)} priority "
                  f"lanes ({', '.join(lv.name for lv in qos_cfg.levels)}),"
                  f" tenant key {qos_cfg.tenant_key}, inflight cap "
                  f"{qos_cfg.tenant_inflight_cap or 'none'} "
                  f"(/debug/overload)", file=sys.stderr)
    if args.cost_attribution == "on":
        hooks.cost_attr = costattr.CostAttribution(metrics=metrics)
        costattr.install(hooks.cost_attr)
        if hooks.overload is not None and args.qos == "on":
            # measured per-tenant evaluation cost decides who is heaviest
            hooks.overload.set_tenant_cost_input(
                hooks.cost_attr.tenant_totals)
    if args.flight_recorder > 0 and not args.once:
        hooks.flight_rec = flightrec.FlightRecorder(
            capacity=args.flight_recorder,
            sink_path=args.flight_recorder_sink or None,
            metrics=metrics,
            capture=args.flight_recorder_capture,
            sink_max_bytes=int(args.flight_recorder_sink_max_mb
                               * 1024 * 1024),
            sink_keep=args.flight_recorder_sink_keep)
        flightrec.install(hooks.flight_rec)
    if args.slo == "on" and not args.once:
        if args.slo_degradation == "on":
            hooks.degradations = overload.DegradationRegistry(
                metrics=metrics)
            overload.install_degradations(hooks.degradations)
        slo_kw: dict = {"degradations": hooks.degradations}
        if args.slo_config:
            cfg = slo.load_config(args.slo_config, hooks.degradations)
            slo_kw["objectives"] = cfg["objectives"]
            if cfg["tiers"]:
                slo_kw["tiers"] = cfg["tiers"]
        elif args.shadow_candidate:
            # the shadow canary's divergence-rate objective rides the
            # default set (an explicit --slo-config replaces the defaults
            # wholesale, the shadow objective included)
            from gatekeeper_tpu_torch.replay.shadow import SHADOW_OBJECTIVE

            slo_kw["objectives"] = (list(slo.DEFAULT_OBJECTIVES)
                                    + [SHADOW_OBJECTIVE])
        hooks.slo_engine = slo.SLOEngine(metrics, brownout=hooks.overload,
                                         **slo_kw)
        if args.slo_brownout and hooks.overload is not None:
            hooks.overload.set_slo_input(hooks.slo_engine.pressure)
        hooks.slo_engine.start(interval_s=args.slo_interval)
        print(f"SLO engine active: {len(hooks.slo_engine.objectives)} "
              f"objectives, tick every {args.slo_interval:.0f}s "
              f"(/debug/slo)"
              + (", degradation maps armed"
                 if hooks.degradations is not None else ""),
              file=sys.stderr)
    if args.qos == "on" and args.qos_ledger_decay == "slo-window" \
            and hooks.overload is not None:
        # displacement-ledger decay on the SLO window clock
        import time

        if hooks.slo_engine is not None:
            hooks.overload.set_qos_ledger_clock(
                hooks.slo_engine.window_clock,
                hooks.slo_engine.shortest_window_s())
        else:
            hooks.overload.set_qos_ledger_clock(time.monotonic, 300.0)
        print("qos ledger decay: slo-window", file=sys.stderr)


def worker_argv(argv) -> list:
    """A worker child's arguments: ``argv`` without ``--webhook-workers``,
    ``--operation`` (and their values) and ``--once``, plus ``--reuse-port
    --operation webhook --operation mutation-webhook
    --cert-rotation-check-s 0``, so the child serves the webhooks only,
    starts no grandchildren and leaves certificate rotation to the
    parent."""
    stripped: list = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--webhook-workers", "--operation"):
            skip = True
            continue
        if a.startswith(("--webhook-workers=", "--operation=")) \
                or a == "--once":
            continue
        stripped.append(a)
    return stripped + ["--reuse-port", "--operation", "webhook",
                       "--operation", "mutation-webhook",
                       # only the parent rotates certificates: N renewals
                       # would interleave into mismatched tls.crt/tls.key
                       "--cert-rotation-check-s", "0"]


def start_workers(parser, args, argv) -> list:
    """``--webhook-workers N``: start N - 1 child replicas (plain
    subprocesses, before this process touches the card) and mark the
    parent's own listener ``--reuse-port``.  Returns the children."""
    import os
    import signal
    import subprocess

    if args.webhook_workers > 1 and args.once:
        print("--webhook-workers ignored with --once (no servers run)",
              file=sys.stderr)
        args.webhook_workers = 1
    if args.webhook_workers <= 1:
        return []
    if args.port == 0:
        parser.error("--webhook-workers needs an explicit --port "
                     "(an ephemeral port cannot be shared)")
    if args.certs_dir and not os.path.exists(
            os.path.join(args.certs_dir, "tls.crt")):
        # generate the serving certificates before the children start: N
        # processes generating them at first boot would overwrite each
        # other's pairs
        from gatekeeper_tpu_torch.webhook.certs import generate_certs

        generate_certs(args.certs_dir)
    from gatekeeper_tpu_torch.pipeline import effective_cpu_count

    cores = effective_cpu_count()
    if cores < args.webhook_workers:
        print(f"WARNING: --webhook-workers {args.webhook_workers} on a "
              f"{cores}-core host: the workers will share the CPU; use at "
              f"most {max(1, cores)} here", file=sys.stderr)
    child = worker_argv(list(argv) if argv is not None else sys.argv[1:])
    procs = [subprocess.Popen([sys.executable, "-m", "gatekeeper_tpu_torch"]
                              + child)
             for _ in range(args.webhook_workers - 1)]
    print(f"webhook workers: {len(procs)} children (pids "
          f"{[w.pid for w in procs]}) beside this process", file=sys.stderr,
          flush=True)
    args.reuse_port = True
    # a signal during boot unwinds through main's finally, which stops the
    # children (serve installs its drain handler once it serves)
    signal.signal(signal.SIGTERM, _exit_on_signal)
    return procs


def _exit_on_signal(signum, frame):
    raise SystemExit(128 + signum)


def stop_workers(procs, timeout: float = 30.0) -> None:
    """Terminate the worker children, then wait for each in turn (each
    drains what it holds); one that outlives ``timeout`` is killed."""
    for w in procs:
        if w.poll() is None:
            w.terminate()
    for w in procs:
        try:
            w.wait(timeout=timeout)
        except Exception:
            w.kill()
            w.wait()


def run(args, workers=()) -> int:
    """Boot, then one audit sweep (``--once``) or serve until a signal;
    the boot and drain order are in the module docstring."""
    from gatekeeper_tpu_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now
    from gatekeeper_tpu_torch.observability.slo import SLOConfigError

    try:
        hooks = build_hooks(args)
    except SLOConfigError as e:
        # fail fast at boot: a malformed objective silently dropped is an
        # SLO that never pages
        print(f"slo config: {e}", file=sys.stderr)
        return 2
    try:
        return _run(args, hooks, workers)
    finally:
        hooks.close()


def _run(args, hooks: Hooks, workers) -> int:
    """The JAX CLI's boot (``gatekeeper_tpu/__main__.py``): the controller
    ``Manager`` starts over the cluster source, the manifests populate it,
    the evaluator and the audit plane come up, then one sweep or the
    server."""
    from gatekeeper_tpu_torch.controller.manager import (ALL_OPERATIONS,
                                                         Manager)
    from gatekeeper_tpu_torch.export.system import ExportSystem
    from gatekeeper_tpu_torch.sync.source import FileSource

    metrics = hooks.metrics
    operations = args.operation or list(ALL_OPERATIONS)
    compile_cache = None
    if args.compile_cache:
        from gatekeeper_tpu_torch.drivers.generation import CompileCache

        compile_cache = CompileCache(args.compile_cache, metrics=metrics)
    client, driver = new_client(
        device=args.device, generation_swap=args.generation_swap == "on",
        compile_cache=compile_cache, metrics=metrics)
    if args.shadow_candidate and not args.once:
        start_shadow(args, client, hooks)
    cluster, kube_cluster = build_cluster(args, metrics)
    export = ExportSystem()
    if args.export_dir:
        export.upsert_connection("disk", "disk", {"path": args.export_dir})
    provider_cache, lane = new_extdata(
        mode=args.extdata_lane, max_keys=args.extdata_max_keys,
        fanout=args.extdata_fanout, metrics=metrics)
    if args.extdata_lane != "batched":
        print(f"extdata lane: {args.extdata_lane}", file=sys.stderr)
    ctl = Manager(client, cluster, operations=operations,
                  provider_cache=provider_cache, extdata_lane=lane,
                  export_system=export, metrics=metrics,
                  readiness_retries=args.readiness_retries).start()
    audit_mgr = ingester = warm_cache = None
    try:
        if args.manifests:
            FileSource(*args.manifests).populate(cluster)
        ctl.tracker.all_populated()
        if compile_cache is not None:
            print(f"compile cache: {args.compile_cache} "
                  f"{compile_cache.stats()}", file=sys.stderr)
        print(f"templates: {len(client.templates())} "
              f"({len(driver.lowered_kinds())} on the device verdict path),"
              f" constraints: {len(client.constraints())}, mutators: "
              f"{len(ctl.mutation_system.mutators())}, expansion "
              f"templates: {len(ctl.expansion_system.templates())}",
              file=sys.stderr)
        if ctl.is_assigned("audit") or args.once:
            audit_mgr, ingester = audit_plane(
                args, client, driver, cluster, kube_cluster=kube_cluster,
                expansion_system=ctl.expansion_system, extdata_lane=lane,
                export_system=export, metrics=metrics)
            if args.compile_cache and not args.once:
                from gatekeeper_tpu_torch.drivers.generation import \
                    WarmStateCache

                warm_cache = WarmStateCache(args.compile_cache,
                                            metrics=metrics)
                rep = warm_cache.replay(driver, audit_mgr.evaluator)
                if rep["hit"]:
                    print(f"warm state replayed: {rep['hit_states']} "
                          f"hit-buffer states, admission warm batch "
                          f"{'run' if rep['warm_ref'] else 'absent'}",
                          file=sys.stderr)
        if args.once:
            rc = audit_once(audit_mgr)
            hooks.export_trace()
            return rc
        switch_s = sys.getswitchinterval()
        sys.setswitchinterval(SERVING_SWITCH_INTERVAL_S)
        try:
            return serve(args, client, ctl, audit_mgr, hooks, driver=driver,
                         cluster=cluster, kube_cluster=kube_cluster,
                         workers=workers, warm_cache=warm_cache)
        finally:
            sys.setswitchinterval(switch_s)
    finally:
        if driver.gen_coord is not None:
            driver.gen_coord.stop()
        if ingester is not None:
            ingester.stop()
        if kube_cluster is not None:
            kube_cluster.close()  # the Manager's and the namespace watches
        if args.flatten_workers:
            from gatekeeper_tpu_torch.ops.flatten import \
                shutdown_flatten_pools

            shutdown_flatten_pools()  # the worker processes exit with us


def start_shadow(args, client, hooks: Hooks) -> None:
    """The continuous shadow canary (``replay/shadow.py``): the candidate
    library loads on ``--device`` through the serving compile cache (a
    warmed candidate attaches with zero fresh lowerings), and the
    webhook's per-decision seam feeds the installed lane.  A candidate
    that fails to load disables the canary, never the server."""
    from gatekeeper_tpu_torch.gator import reader
    from gatekeeper_tpu_torch.observability import flightrec
    from gatekeeper_tpu_torch.replay import core, shadow

    try:
        docs = reader.read_sources(args.shadow_candidate)
        runtime = core.load_candidate(
            docs, compile_cache_dir=args.compile_cache,
            metrics=hooks.metrics, device=args.device)
        recorder = None
        if args.shadow_sink:
            recorder = flightrec.FlightRecorder(
                capacity=1024, sink_path=args.shadow_sink)
        lane = shadow.ShadowLane(
            runtime, serving_client=client, candidate_docs=docs,
            recorder=recorder, metrics=hooks.metrics).start()
        shadow.install(lane)
        hooks.shadow = lane
        if hooks.slo_engine is not None:
            # a divergence-rate breach aborts the canary (the objective
            # rides the engine whenever the lane is configured)
            lane.bind_slo(hooks.slo_engine)
        print(f"shadow canary active: {len(docs)} candidate docs "
              f"(/debug/shadow"
              + (", slo auto-abort armed" if hooks.slo_engine is not None
                 else "") + ")", file=sys.stderr)
    except Exception as e:
        print(f"shadow canary disabled: {e}", file=sys.stderr)


def build_cluster(args, metrics=None) -> tuple:
    """(cluster, kube_cluster): the source the controller ``Manager``
    reconciles from.  ``--kubeconfig`` makes it a ``KubeCluster`` over the
    apiserver (also returned as ``kube_cluster``, whose discovery the audit
    lister and the snapshot's watch use); otherwise an in-memory
    ``FakeCluster`` that ``--manifests`` populates.
    ``--management-manifests`` routes the gatekeeper-internal state (the
    status group and Secrets) to a second ``FakeCluster`` seeded from that
    directory."""
    from gatekeeper_tpu_torch.sync.source import FakeCluster, FileSource

    kube_cluster = None
    if args.kubeconfig:
        from gatekeeper_tpu_torch.sync.kube import KubeCluster, KubeConfig

        cfg = (KubeConfig.in_cluster() if args.kubeconfig == "in-cluster"
               else KubeConfig.from_kubeconfig(args.kubeconfig))
        kube_cluster = cluster = KubeCluster(cfg, metrics=metrics)
        print(f"informer plane: apiserver {cfg.server}", file=sys.stderr)
    else:
        cluster = FakeCluster()
    if args.management_manifests:
        from gatekeeper_tpu_torch.sync.routing import RoutingCluster

        mgmt = FakeCluster()
        FileSource(args.management_manifests).populate(mgmt)
        cluster = RoutingCluster(mgmt, cluster)
        if kube_cluster is not None:
            kube_cluster = cluster  # audit discovery routes via the target
    return cluster, kube_cluster


def build_audit(args, objects, client, driver,
                expansion_system=None, extdata_lane=None,
                metrics=None) -> tuple:
    """:func:`audit_plane` over a ``FakeCluster`` holding ``objects`` (the
    benches' fixture)."""
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    cluster = FakeCluster()
    for obj in objects:
        cluster.apply(obj)
    return audit_plane(args, client, driver, cluster,
                       expansion_system=expansion_system,
                       extdata_lane=extdata_lane, metrics=metrics)


def kube_lister(kube_cluster):
    """The audit's discovery-driven lister (auditResources,
    pkg/audit/manager.go:369-422): every listable GVK, paged.  A failed
    discovery skips the sweep and a failed list skips that GVK; neither
    ends the process."""
    def lister():
        try:
            gvks = kube_cluster.server_preferred_gvks()
        except Exception as e:
            print(f"audit discovery failed: {e}", file=sys.stderr)
            return
        for gvk in gvks:
            try:
                yield from kube_cluster.list_iter(gvk)
            except Exception as e:
                print(f"audit list {gvk}: {e}", file=sys.stderr)
    return lister


def audit_plane(args, client, driver, cluster, kube_cluster=None,
                expansion_system=None, extdata_lane=None,
                export_system=None, metrics=None) -> tuple:
    """(AuditManager, WatchIngester or None) as the flags ask, over
    ``cluster``: a relisting lister (under ``--kubeconfig`` the
    discovery-driven :func:`kube_lister` of ``kube_cluster``), or the
    resident snapshot fed by a watch on the same source.  With
    ``--audit-expand`` the manager expands generator objects through
    ``expansion_system``.  With ``--snapshot-spill`` the spill loads before
    the watch starts (its resourceVersions seed the ingester, so an
    apiserver resumes from them) and a ``SnapshotSpiller`` rides the
    manager; its extdata section goes through ``extdata_lane``.  Finished
    runs go to ``export_system`` and, with ``--emit-audit-events``, to
    Events on ``cluster``."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.pipeline import (effective_cpu_count,
                                               resolve_schedule)

    evaluator = SweepEvaluator(
        driver, device=args.device,
        violations_limit=args.constraint_violations_limit,
        collect=args.collect, flatten_lane=args.flatten_lane,
        flatten_workers=args.flatten_workers, metrics=metrics)
    relist = args.audit_source == "relist"
    print(f"audit schedule: {resolve_schedule(args.pipeline, relist)} "
          f"(--pipeline {args.pipeline}, {effective_cpu_count()} effective "
          f"cores)", file=sys.stderr)
    if kube_cluster is not None:
        lister = kube_lister(kube_cluster)
    else:
        def lister():
            return iter(cluster.list())
    event_sink = None
    if args.emit_audit_events:
        from gatekeeper_tpu_torch.sync import events

        event_sink = events.audit_event_sink(events.EventRecorder(
            cluster, "gatekeeper-audit",
            gk_namespace=args.gatekeeper_namespace,
            involved_namespace=args.audit_events_involved_namespace,
            on_error=lambda e: print(f"audit event emit failed: {e}",
                                     file=sys.stderr)))
    config = AuditConfig(
        interval_s=args.audit_interval,
        violations_limit=args.constraint_violations_limit,
        chunk_size=args.audit_chunk_size,
        pipeline=args.pipeline,
        pipeline_flatten_workers=args.pipeline_flatten_workers,
        audit_source=args.audit_source,
        resync_every=args.snapshot_resync_every,
        resync_rotate=args.snapshot_resync_rotate,
        expand_generated=args.audit_expand)
    seams = {"expansion_system": expansion_system, "metrics": metrics,
             "export_system": export_system, "event_sink": event_sink,
             "log_violations": args.log_denies}
    if args.audit_source != "snapshot":
        return AuditManager(client, lister=lister, config=config,
                            evaluator=evaluator, **seams), None
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, SnapshotSpill,
                                               SnapshotSpiller, WatchIngester,
                                               gvks_of, templates_digest)

    snapshot = ClusterSnapshot(evaluator, SnapshotConfig(), metrics=metrics)
    spill = spill_load = None
    if args.snapshot_spill:
        spill = SnapshotSpill(args.snapshot_spill, metrics=metrics,
                              compress=args.snapshot_spill_compress,
                              delta=args.snapshot_spill_delta,
                              full_every=args.snapshot_spill_full_every)
        spill_load = spill.load(
            snapshot, [c for c in client.constraints()
                       if c.actions_for(AUDIT_EP)],
            extdata_lane=extdata_lane, templates=templates_digest(client))
        if spill_load is not None:
            print(f"snapshot spill loaded: {spill_load['rows']} rows warm, "
                  f"zero relist (resubscribing from recorded rv)",
                  file=sys.stderr)
        else:
            print(f"snapshot spill miss ({spill.stats()['miss_reasons']}); "
                  f"booting with a clean relist", file=sys.stderr)
    if kube_cluster is not None:
        try:
            gvks = kube_cluster.server_preferred_gvks()
        except Exception as e:
            print(f"snapshot discovery failed: {e}", file=sys.stderr)
            gvks = []
    else:
        gvks = gvks_of(cluster.list())
    ingester = WatchIngester(
        snapshot, kube_cluster if kube_cluster is not None else cluster,
        gvks, from_rvs=(spill_load or {}).get("rvs"),
        on_error=lambda e: print(f"snapshot watch subscribe failed: {e}",
                                 file=sys.stderr)).start()
    residency = DeviceResidency(evaluator, mode=args.snapshot_residency,
                                metrics=metrics)
    if driver.gen_coord is not None:
        # a swap drops the device mirrors at once (new schemas)
        driver.gen_coord.attach_residency(residency)
    spiller = None
    if spill is not None:
        spiller = SnapshotSpiller(
            spill, snapshot, rvs_fn=ingester.resume_rvs,
            extdata_lane=extdata_lane,
            templates_fn=lambda: templates_digest(client))
    print(f"resident snapshot active: watching {len(gvks)} GVKs, resync "
          f"every {args.snapshot_resync_every} intervals, residency "
          f"{args.snapshot_residency}", file=sys.stderr)
    mgr = AuditManager(client, lister=lister, config=config,
                       evaluator=evaluator, snapshot=snapshot,
                       residency=residency, spiller=spiller, **seams)
    if spill_load is not None:
        mgr.restore_spill_aux(spill_load.get("aux") or {})
    return mgr, ingester


def audit_once(mgr) -> int:
    run = mgr.audit()
    if mgr.spiller is not None:
        # the next boot (or --once run) warm-starts off this spill
        mgr.spiller.spill_now()
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
                     excluder, coordinator=None, metrics=None,
                     overload=None) -> tuple:
    """(handler, MutationBatcher or None) of ``/v1/mutate`` as
    ``--mutate-lane`` asks: the batched lane behind a started
    microbatcher (gated by ``overload``, shedding by
    ``--webhook-failure-policy``), or the per-object reference handler.
    The lane's mutator programs recompile on ``coordinator``'s thread when
    given."""
    if args.mutate_lane == "host":
        from gatekeeper_tpu_torch.webhook.mutation import MutationHandler

        return MutationHandler(mutation_system,
                               namespace_lookup=namespace_lookup,
                               process_excluder=excluder), None
    from gatekeeper_tpu_torch.mutlane import (BatchedMutationHandler,
                                              MutationBatcher, MutationLane)

    lane = MutationLane(mutation_system,
                        differential=args.mutate_lane == "differential",
                        device=args.device, ingest=args.mutate_ingest,
                        coordinator=coordinator, metrics=metrics)
    batcher = MutationBatcher(lane, metrics=metrics).start()
    return BatchedMutationHandler(
        mutation_system, lane=lane, namespace_lookup=namespace_lookup,
        process_excluder=excluder, batcher=batcher, metrics=metrics,
        overload=overload,
        failure_policy=args.webhook_failure_policy), batcher


def namespace_lookup_for(cluster, kube_cluster=None):
    """The webhook's namespace lookup.  With a live apiserver it serves
    from a watch-fed cache with a GET fallback (the reference's cached
    client with API-reader fallback, policy.go:694-702), never a blocking
    GET per admission; otherwise it reads ``cluster``."""
    ns_gvk = ("", "v1", "Namespace")
    if kube_cluster is None:
        return lambda name: cluster.get(ns_gvk, "", name)
    ns_cache: dict = {}

    def on_event(ev):
        name = (ev.obj.get("metadata") or {}).get("name", "")
        if ev.type == "DELETED":
            ns_cache.pop(name, None)
        else:
            ns_cache[name] = ev.obj

    kube_cluster.subscribe(ns_gvk, on_event, replay=True)

    def lookup(name):
        hit = ns_cache.get(name)
        if hit is not None:
            return hit
        return kube_cluster.get(ns_gvk, "", name)
    return lookup


def serve(args, client, ctl, audit_mgr, hooks: Hooks, driver=None,
          cluster=None, kube_cluster=None, workers=(),
          warm_cache=None) -> int:
    """Serve the admission webhook (the ``webhook`` and
    ``mutation-webhook`` operations of the controller ``ctl``), with
    ``audit_mgr.run_forever()`` on a thread beside it (the ``audit``
    operation), until SIGINT or SIGTERM; then drain through ``hooks.drain``
    (a ``DrainCoordinator``): the webhook stops accepting and finishes what
    it holds, the audit loop stops, the final spill, the warm state's save
    to ``warm_cache``, the trace export, then the ``workers`` children,
    each terminated and waited for in turn.  ``/healthz`` answers 200 once
    ``ctl``'s readiness tracker is satisfied, with its stats.  ``driver``
    is the client's ``TorchDriver`` (its generation coordinator recompiles
    the mutation lane's programs and starts once the server serves).
    ``cluster`` is the Manager's source (namespace lookups, admission
    Events, the certificates' Secret under ``--kubeconfig``).  The batcher
    threads and the audit thread share the device on its default stream.
    A signal also terminates the children at once, so they drain
    alongside; a second signal while draining is ignored."""
    import os
    import signal
    import threading
    import time

    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    metrics = hooks.metrics
    drain = hooks.drain
    server = batcher = mutation_batcher = None
    rot_stop = threading.Event()
    # the drain's signal handler goes in before anything serves: a signal
    # between the serving line and its install would end the process
    # undrained
    stopping = threading.Event()

    def _on_signal(signum, frame):
        if not drain.begin(f"signal {signum}"):
            # a second signal while draining (the parent's stop_workers
            # terminates a child its own handler already signalled): a
            # print here could re-enter a print of the drain and raise
            return
        print(f"signal {signum}: draining"
              + (f" (serving {args.shutdown_delay:.0f}s more for LB "
                 f"deregistration)" if args.shutdown_delay else ""),
              file=sys.stderr, flush=True)
        if server is not None:
            server.begin_drain()  # healthz 503 + retire keep-alives
        for w in workers:  # the children start their own drains now
            if w.poll() is None:
                w.terminate()
        if args.shutdown_delay:
            time.sleep(args.shutdown_delay)
        stopping.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    if ctl.is_assigned("webhook") or ctl.is_assigned("mutation-webhook"):
        try:
            namespace_lookup = namespace_lookup_for(cluster, kube_cluster)
            batcher = Batcher(client, stats=args.log_stats_admission,
                              small_batch=webhook_small_batch(args),
                              metrics=metrics).start()
            validation = mutation = None
            if ctl.is_assigned("webhook"):
                warm_batcher(client, batcher)
                admission_sink = None
                if args.emit_admission_events:
                    from gatekeeper_tpu_torch.sync import events

                    admission_sink = events.admission_event_sink(
                        events.EventRecorder(
                            cluster, "gatekeeper-webhook",
                            gk_namespace=args.gatekeeper_namespace,
                            involved_namespace=(
                                args.admission_events_involved_namespace),
                            on_error=lambda e: print(
                                f"admission event emit failed: {e}",
                                file=sys.stderr)))
                validation = ValidationHandler(
                    client,
                    process_excluder=ctl.excluder,
                    namespace_lookup=namespace_lookup,
                    batcher=batcher,
                    log_denies=args.log_denies,
                    event_sink=admission_sink,
                    fail_open=args.fail_open_on_error,
                    failure_policy=("ignore" if args.fail_open_on_error
                                    else args.webhook_failure_policy),
                    expansion_system=ctl.expansion_system,
                    metrics=metrics,
                    deadline_budget_s=args.webhook_deadline,
                    trace_config=lambda: ctl.validation_traces,
                    log_stats=args.log_stats_admission,
                    overload=hooks.overload,
                    snapshot=getattr(audit_mgr, "snapshot", None),
                )
            if ctl.is_assigned("mutation-webhook"):
                mutation, mutation_batcher = mutation_handler(
                    args, ctl.mutation_system, namespace_lookup,
                    ctl.excluder,
                    coordinator=getattr(driver, "gen_coord", None),
                    metrics=metrics, overload=hooks.overload)
            certfile = keyfile = None
            if args.certs_dir:
                certfile, keyfile = serving_certs(args, kube_cluster)
            server = WebhookServer(
                validation_handler=validation,
                mutation_handler=mutation,
                namespace_label_handler=NamespaceLabelHandler(
                    exempt_namespaces=args.exempt_namespace,
                    exempt_prefixes=args.exempt_namespace_prefix,
                    exempt_suffixes=args.exempt_namespace_suffix),
                port=args.port,
                certfile=certfile,
                keyfile=keyfile,
                client_ca_file=args.client_ca_file or None,
                tls_min_version=args.tls_min_version,
                batcher=batcher,
                mutation_batcher=mutation_batcher,
                reuse_port=args.reuse_port,
                # the drain pulls readiness before the listener closes
                readiness_check=lambda: (not drain.draining
                                         and ctl.tracker.satisfied()),
                readiness_stats=ctl.tracker.stats,
                metrics=metrics,
                enable_profile=args.enable_profile,
                backlog=args.webhook_backlog,
                cost_attribution=hooks.cost_attr,
                slo_engine=hooks.slo_engine,
                flight_recorder=hooks.flight_rec,
            ).start()
        except BaseException:
            for b in (batcher, mutation_batcher):
                if b is not None:
                    b.stop()
            raise
        print(f"webhook serving on :{server.port} (operations "
              f"{sorted(ctl.operations)}, pid {os.getpid()})",
              file=sys.stderr, flush=True)
        if args.certs_dir and args.cert_rotation_check_s > 0:
            # <= 0 disables rotation (the worker children: only the
            # parent renews, or N renewals would race)
            from gatekeeper_tpu_torch.webhook.certs import rotation_loop

            threading.Thread(
                target=rotation_loop,
                args=(args.certs_dir, server, rot_stop,
                      args.cert_rotation_check_s),
                kwargs={"cluster": kube_cluster}, daemon=True,
                name="cert-rotation").start()
    # boot reconcile and warm are done: later template changes compile on
    # the generation thread and swap in off the serving path
    if ctl.begin_background_compile():
        print("generation swap active: template changes compile on a "
              "background thread", file=sys.stderr)
    auditor = start_audit_loop(audit_mgr) if audit_mgr is not None \
        and ctl.is_assigned("audit") else None

    while not stopping.wait(1.0):
        pass
    drain.begin("shutdown")
    rot_stop.set()
    drained = True
    if auditor is not None:
        audit_mgr.stop()
    if server is not None:
        # stops accepting, then drains in-flight handlers and both batcher
        # queues inside the budget before closing
        drained = server.stop(drain_timeout=args.drain_timeout)
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
    if audit_mgr is not None and audit_mgr.spiller is not None:
        # the final spill (the loop's exit wrote one too; this one also
        # covers a loop that never ran)
        audit_mgr.spiller.stop(flush=True)
    if warm_cache is not None:
        warm_cache.save(driver, audit_mgr.evaluator)
    hooks.export_trace()  # after the last span of the drain closed
    # the children drain in sequence, each finishing what it holds
    stop_workers(workers, timeout=max(5.0, args.drain_timeout))
    dt = drain.finish()
    print(f"drain complete in {dt:.2f}s" if drained else
          f"WARNING: drain exceeded --drain-timeout "
          f"{args.drain_timeout:.0f}s; in-flight work abandoned",
          file=sys.stderr, flush=True)
    return 0


def serving_certs(args, kube_cluster=None) -> tuple:
    """(certfile, keyfile) under ``--certs-dir``.  With a live apiserver
    the chain lives in the certificate Secret (one replica generates, all
    read it) and its caBundle goes into the webhook configurations;
    otherwise a missing pair is generated in place."""
    import os

    if kube_cluster is not None:
        from gatekeeper_tpu_torch.webhook.certs import ensure_cluster_certs

        certfile, keyfile = ensure_cluster_certs(kube_cluster,
                                                 args.certs_dir)
        args.certs_dir = os.path.dirname(certfile)
        return certfile, keyfile
    from gatekeeper_tpu_torch.webhook.certs import generate_certs

    if not os.path.exists(os.path.join(args.certs_dir, "tls.crt")):
        generate_certs(args.certs_dir)
    return (os.path.join(args.certs_dir, "tls.crt"),
            os.path.join(args.certs_dir, "tls.key"))


if __name__ == "__main__":
    code = main()
    if abandoned_audit():
        # skip the teardown the abandoned pass would abort (SIGABRT)
        sys.stdout.flush()
        sys.stderr.flush()
        import os

        os._exit(code)
    sys.exit(code)
