"""External data in the port (gatekeeper_tpu_torch/{externaldata,extdata},
the ``ext:`` tables of drivers/torch_driver.py and parallel/sweep.py, the
lane branch of mutation/system.py and the CLI's ``--extdata-*`` flags)
against the JAX package, on the CPU.

Both sides get the same seeded inputs and the same counting transport
stubs (in-process ``send_fn`` doubles; no network).  Held identical:
builtin responses and violation texts, resolved values and per-key
errors, transport call counts, verdicts per review, sweep totals and
violating rows, audit totals and kept lists, mutated objects, error texts
and ``/v1/mutate`` patches, in the ``batched``, ``perkey`` and
``differential`` lane modes."""

import copy
import http.client
import json
import os
import re
import socket
import subprocess
import sys
import threading

import pytest
import yaml

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.apis.constraints import \
    Constraint as JConstraint  # noqa: E402
from gatekeeper_tpu.apis.templates import \
    ConstraintTemplate as JTemplate  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.extdata import column as jcolumn  # noqa: E402
from gatekeeper_tpu.extdata import lane as jlane  # noqa: E402
from gatekeeper_tpu.externaldata import providers as jproviders  # noqa
from gatekeeper_tpu.mutation.system import \
    MutationSystem as JMutationSystem  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.parallel.sharded import \
    violation_rows as jviolation_rows  # noqa: E402
from gatekeeper_tpu.resilience.policy import \
    RetryPolicy as JRetry  # noqa: E402
from gatekeeper_tpu.target.review import \
    AugmentedUnstructured as JAU  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa
from gatekeeper_tpu.webhook.mutation import \
    MutationHandler as JMutationHandler  # noqa: E402
from gatekeeper_tpu.webhook.server import \
    admission_response as jresponse  # noqa: E402
from gatekeeper_tpu_torch.apis.constraints import \
    Constraint as TConstraint  # noqa: E402
from gatekeeper_tpu_torch.apis.templates import \
    ConstraintTemplate as TTemplate  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.extdata import column as tcolumn  # noqa: E402
from gatekeeper_tpu_torch.extdata import lane as tlane  # noqa: E402
from gatekeeper_tpu_torch.externaldata import \
    providers as tproviders  # noqa: E402
from gatekeeper_tpu_torch.mutation.system import \
    MutationSystem as TMutationSystem  # noqa: E402
from gatekeeper_tpu_torch.mutlane import (  # noqa: E402
    BatchedMutationHandler, MutationBatcher, MutationLane)
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import \
    violation_rows as tviolation_rows  # noqa: E402
from gatekeeper_tpu_torch.resilience.policy import \
    RetryPolicy as TRetry  # noqa: E402
from gatekeeper_tpu_torch.target.review import \
    AugmentedUnstructured as TAU  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402
from tests.test_extdata import (RULES_DIGEST, RULES_ERRORS,  # noqa: E402
                                TARGET, corpus)
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TRUSTED_PREFIX = "openpolicyagent/"


class Pkg:
    """One package's half of a differential: the same names on both."""

    def __init__(self, name, providers, lane, column, retry, constraint,
                 template, driver, target, au, mutation_system):
        self.name = name
        self.providers, self.lane, self.column = providers, lane, column
        self.retry, self.Constraint, self.Template = retry, constraint, \
            template
        self.driver, self.Target, self.AU = driver, target, au
        self.MutationSystem = mutation_system


JAX = Pkg("jax", jproviders, jlane, jcolumn, JRetry, JConstraint, JTemplate,
          lambda: TpuDriver(batch_bucket=8), JTarget, JAU, JMutationSystem)
PORT = Pkg("torch", tproviders, tlane, tcolumn, TRetry, TConstraint,
           TTemplate, lambda: TorchDriver(batch_bucket=8, device="cpu"),
           TTarget, TAU, TMutationSystem)
PKGS = (JAX, PORT)


class Transport:
    """``send_fn`` double, deterministic and counting.  ``trusted`` errors
    on keys that hold "bad"; ``digest`` errors on keys that hold
    "nodigest" and pins the rest (``@sha256:`` keys answer themselves).
    ``down`` makes every send raise; ``drop`` answers only every other
    key of a send (a partial response)."""

    def __init__(self):
        self.calls = 0
        self.keys_sent = 0
        self.down = False
        self.drop = False
        self.lock = threading.Lock()

    def __call__(self, provider, keys):
        with self.lock:
            self.calls += 1
            self.keys_sent += len(keys)
        if self.down:
            raise RuntimeError("transport down")
        items = []
        for i, k in enumerate(keys):
            if self.drop and i % 2:
                continue
            if provider.name == "trusted":
                items.append({"key": k, "error": f"untrusted: {k}"}
                             if "bad" in k else {"key": k, "value": k})
            elif "nodigest" in k:
                items.append({"key": k, "error": f"no digest for {k}"})
            else:
                items.append({"key": k, "value": k if "@sha256:" in k
                              else k + "@sha256:abc"})
        return {"response": {"items": items, "systemError": ""}}


class PrefixTransport(Transport):
    """The registry of the library configuration: ``trusted`` errors on
    images outside the library's trusted prefix, ``digest`` pins."""

    def __call__(self, provider, keys):
        with self.lock:
            self.calls += 1
            self.keys_sent += len(keys)
        items = []
        for k in keys:
            if provider.name == "trusted":
                items.append({"key": k, "value": k}
                             if k.startswith(TRUSTED_PREFIX)
                             else {"key": k, "error": f"untrusted: {k}"})
            else:
                items.append({"key": k, "value": k if "@sha256:" in k
                              else f"{k}@sha256:0000abcd"})
        return {"response": {"items": items, "systemError": ""}}


def make_lane(pkg, mode="batched", transport=None, cache_kw=None, **kw):
    """(lane, cache, transport): both providers over one transport, a
    fast retry so failure cases stay quick."""
    transport = transport or Transport()
    cache = pkg.providers.ProviderCache(
        send_fn=transport,
        retry=pkg.retry(attempts=2, base_s=0.001, cap_s=0.002,
                        dependency="externaldata"),
        **(cache_kw or {}))
    for name in ("trusted", "digest"):
        cache.upsert(pkg.providers.Provider(name=name, url=f"https://{name}",
                                            ca_bundle="x"))
    return pkg.lane.ExtDataLane(cache, mode=mode, **kw), cache, transport


def template_obj(kind, rego):
    return {"apiVersion": "templates.gatekeeper.sh/v1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": rego}]}}


def template(pkg, kind, rego):
    return pkg.Template.from_unstructured(template_obj(kind, rego))


def make_driver(pkg, lane=None, kinds=("K8sExtData", "K8sDigest")):
    rules = {"K8sExtData": RULES_ERRORS, "K8sDigest": RULES_DIGEST}
    d = pkg.driver()
    d.extdata_lane = lane
    cons = []
    for kind in kinds:
        d.add_template(template(pkg, kind, rules[kind]))
        con = pkg.Constraint(kind=kind, name=kind.lower(), match={},
                             parameters={}, enforcement_action="deny")
        d.add_constraint(con)
        cons.append(con)
    return d, cons


def reviews_of(pkg, pods):
    target = pkg.Target()
    return [target.handle_review(pkg.AU(object=p)) for p in pods]


def results(responses):
    return [sorted(((r.constraint or {}).get("kind"), r.msg)
                   for r in resp.results) for resp in responses]


# --- the builtin, with no lane and with one --------------------------------

def test_builtin_without_lane_fails_closed_like_jax():
    """With no lane the port's ``external_data`` answers one per-key error
    per key, as the JAX builtin does, so the reference docs' image
    template denies through its own ``response.errors`` rule (the port
    raised a RegoError here before)."""
    req = {"provider": "trusted", "keys": ["x", 7, "x", ["y"]]}
    assert tlane.builtin_fetch(req) == jlane.builtin_fetch(req)
    assert len(tlane.builtin_fetch(req)["errors"]) == 3
    pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p"},
           "spec": {"containers": [{"name": "c", "image": "x"}]}}
    out = {}
    for pkg in PKGS:
        assert pkg.lane.active() is None
        d, cons = make_driver(pkg, kinds=("K8sExtData",))
        assert not d.extdata_ready("K8sExtData")
        out[pkg.name] = results(d.query_batch(TARGET, cons,
                                              reviews_of(pkg, [pod])))
    assert out["torch"] == out["jax"] == [[(
        None, 'invalid images: [["x", "external data: no lane '
              'configured"]]')]]


@pytest.mark.parametrize("mode", ["batched", "perkey", "differential"])
def test_builtin_with_lane_matches_jax(mode):
    req = {"provider": "trusted", "keys": ["ok/a", "bad/b", 3, "ok/a"]}
    out = {}
    for pkg in PKGS:
        lane, _c, tr = make_lane(pkg, mode)
        with pkg.lane.activate(lane):
            out[pkg.name] = (pkg.lane.builtin_fetch(req), tr.calls)
        assert pkg.lane.active() is None
    assert out["torch"] == out["jax"]


# --- columns, dedupe, chunking, reconcile -----------------------------------

def test_provider_column_ttl_land_invalidate_matches_jax():
    out = {}
    for pkg in PKGS:
        clock = [0.0]
        col = pkg.column.ProviderColumn("p", ttl_s=10.0,
                                        clock=lambda: clock[0])
        seen = [col.missing(["a", "b", "a"])]
        col.land({"a": ("v", None), "b": (None, "boom")})
        v0 = col.version
        seen += [col.missing(["a", "b"]), col.get("a"), col.get("b")]
        clock[0] = 11.0  # TTL expiry: keys refetch, last values readable
        seen += [col.missing(["a", "b"]), col.get("a")]
        col.invalidate()
        seen += [col.version > v0, col.get("a"), len(col)]
        out[pkg.name] = seen
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["a", "b"] and out["torch"][-1] == 0


def test_lane_dedupes_chunks_and_reconciles_like_jax():
    out = {}
    for pkg in PKGS:
        lane, cache, tr = make_lane(pkg, max_keys_per_call=3)
        keys = [f"k{i}" for i in range(8)] * 4
        rec = [lane.ensure("trusted", keys), tr.calls, tr.keys_sent,
               lane.ensure("trusted", keys), tr.calls]
        rec.append(lane.resolve_keys("trusted", ["k1", "bad/z"]))
        rec.append(tr.calls)
        # a Provider reconcile drops the provider's column
        cache.upsert(pkg.providers.Provider(name="trusted",
                                            url="https://t2",
                                            ca_bundle="x"))
        rec += [len(lane.column("trusted")), lane.ensure("trusted", ["a"]),
                tr.calls]
        rec.append(lane.resolve_keys("nosuch", ["a"]))
        rec.append(lane.snapshot())
        out[pkg.name] = rec
    assert out["torch"] == out["jax"]
    # 8 unique keys at <= 3 per call: 3 sends; warm: none
    assert out["torch"][:5] == [8, 3, 8, 0, 3]
    err = out["torch"][-2]["a"]
    assert err[0] is None and "nosuch" in err[1]
    lane, _c, _t = make_lane(PORT, max_keys_per_call=3)
    lane.ensure("trusted", [f"k{i}" for i in range(8)] * 4)
    assert lane.perf == {"keys/trusted/fetched": 8, "bulk_calls/trusted": 3}


@pytest.mark.parametrize("fanout", [1, 4])
def test_ensure_many_matches_serial(fanout):
    keys = {"trusted": ["ok/x", "bad/x", "ok/y"],
            "digest": ["img@sha256:abc", "plain", "nodigest/z"]}
    serial, _c, tr_s = make_lane(PORT, fanout=1)
    for p, ks in sorted(keys.items()):
        serial.ensure(p, ks)
    out = {}
    for pkg in PKGS:
        lane, _c, tr = make_lane(pkg, fanout=fanout)
        n = lane.ensure_many(keys)
        out[pkg.name] = (n, tr.calls, {p: lane.resolve_keys(p, ks)
                                       for p, ks in keys.items()},
                         lane.ensure_many(keys), tr.calls)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 6 and out["torch"][1] == tr_s.calls == 2
    assert out["torch"][2] == {p: serial.resolve_keys(p, ks)
                               for p, ks in keys.items()}
    assert out["torch"][3:] == (0, 2)


# --- routing and the admission grid ------------------------------------------

def test_extdata_ready_routes_like_jax():
    for pkg in PKGS:
        d, _cons = make_driver(pkg)
        assert {"K8sExtData", "K8sDigest"} <= set(d.lowered_kinds()), \
            d.fallback_kinds()
        assert not d.extdata_ready("K8sExtData")  # no lane
        lane, _c, _t = make_lane(pkg, "perkey")
        d.extdata_lane = lane
        assert not d.extdata_ready("K8sDigest")  # perkey: interpreter
        for mode in ("batched", "differential"):
            lane.mode = mode
            assert d.extdata_ready("K8sExtData")
            assert d.extdata_ready("K8sDigest")
        d.extdata_lane = None
        with pkg.lane.activate(lane):  # the process-active lane
            assert d.extdata_ready("K8sExtData")


@pytest.mark.parametrize("mode", ["batched", "differential", "perkey"])
def test_query_batch_matches_jax_and_interpreter(mode):
    pods = corpus()
    out = {}
    for pkg in PKGS:
        lane, _c, tr = make_lane(pkg, mode)
        d, cons = make_driver(pkg, lane)
        reviews = reviews_of(pkg, pods)
        with pkg.lane.activate(lane):
            got = results(d.query_batch(TARGET, cons, reviews))
            cold = tr.calls
            again = results(d.query_batch(TARGET, cons, reviews))
            calls = (cold, tr.calls - cold)
            interp = [sorted(((r.constraint or {}).get("kind"), r.msg)
                             for con in cons
                             for r in d._interp.query(TARGET, [con],
                                                      rv).results)
                      for rv in reviews]
        out[pkg.name] = (got, calls)
        assert got == again == interp, pkg.name
    assert out["torch"] == out["jax"]
    assert any(out["torch"][0])
    if mode != "perkey":
        # one bulk send per provider; the warm second pass sends nothing
        # (the differential's per-key cross-check hits the warm cache)
        assert out["torch"][1] == (2, 0)


def test_grid_reads_ext_tables_on_the_device_path():
    """The batched grid evaluates the extdata kinds: ``prog.run`` gets the
    ``ext:`` tables, and the value sids it reads are covered by the vocab
    tables built after them."""
    lane, _c, _t = make_lane(PORT)
    d, cons = make_driver(PORT, lane)
    seen = []
    for kind in ("K8sExtData", "K8sDigest"):
        prog = d._programs[kind]
        run = prog.run

        def spy(batch, table, _run=run, **kw):
            seen.append(sorted(k for k in kw["extra_cols"]
                               if k.startswith("ext:")))
            return _run(batch, table, **kw)

        prog.run = spy
    d.query_batch(TARGET, cons, reviews_of(PORT, corpus()))
    assert seen == [["ext:trusted:ok", "ext:trusted:val"],
                    ["ext:digest:ok", "ext:digest:val"]]
    tables = lane.tables_for("digest", ["repo/y"], d.vocab)
    val = tables["ext:digest:val"]
    sid = d.vocab.lookup("repo/y")
    assert tables["ext:digest:ok"][sid]
    assert d.vocab.string(int(val[sid])) == "repo/y@sha256:abc"
    # a warm column returns the same arrays; a grown vocab rebuilds
    assert lane.tables_for("digest", ["repo/y"], d.vocab) is tables
    d.vocab.intern("late/key")
    lane.ensure("digest", ["late/key"])
    grown = lane.tables_for("digest", ["late/key"], d.vocab)
    assert grown is not tables
    assert grown["ext:digest:ok"][d.vocab.lookup("late/key")]


def test_one_lane_serves_drivers_with_other_vocabs():
    """The lane's tables index one vocab's sids: a second driver whose
    vocab interned other strings first must get tables of its own, not
    the first driver's (the column is warm and unchanged between them)."""
    lane, _c, tr = make_lane(PORT)
    pods = corpus()
    first, cons = make_driver(PORT, lane)
    second = TorchDriver(batch_bucket=8, device="cpu")
    for i in range(300):
        second.vocab.intern(f"shift-{i}")
    second.extdata_lane = lane
    second.add_template(template(PORT, "K8sExtData", RULES_ERRORS))
    second.add_template(template(PORT, "K8sDigest", RULES_DIGEST))
    for con in cons:
        second.add_constraint(con)
    with tlane.activate(lane):  # the interpreter renders through it
        got = [results(d.query_batch(TARGET, cons, reviews_of(PORT, pods)))
               for d in (first, second, first)]
        assert tr.calls == 2  # the second driver found the columns warm
        want = [sorted(((r.constraint or {}).get("kind"), r.msg)
                       for con in cons
                       for r in first._interp.query(TARGET, [con],
                                                    rv).results)
                for rv in reviews_of(PORT, pods)]
    assert any(want)
    assert got == [want] * 3


def test_threads_share_one_lane_and_vocab():
    """Served mode: the batcher, the mutation batcher and the audit loop
    share one lane and one vocab (its intern lock armed).  Batches with
    new image keys build tables while other threads intern; every batch
    must still read its own keys, and the vocab stays a bijection."""
    lane, _c, _t = make_lane(PORT)
    d, cons = make_driver(PORT, lane)
    d.vocab._lock = threading.RLock()
    pods = corpus()[:12]
    errors, outs = [], {}

    def worker(t):
        try:
            for r in range(4):
                img = f"ok/t{t}r{r}"
                extra = {"kind": "Pod", "metadata": {"name": img},
                         "spec": {"containers": [{"name": "c",
                                                  "image": img}]}}
                outs[(t, r)] = results(d.query_batch(
                    TARGET, cons, reviews_of(PORT, pods + [extra])))
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(e)

    with tlane.activate(lane):
        want = results(d.query_batch(TARGET, cons, reviews_of(PORT, pods)))
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(outs) == 24
    for (t, r), got in outs.items():
        img = f"ok/t{t}r{r}"
        assert got[:-1] == want
        assert got[-1] == [(None, f"image {img} is not pinned to its "
                                  "digest")]
    v = d.vocab
    assert all(v._to_id[s] == i for i, s in enumerate(v._to_str))


def test_differential_catches_tampered_column():
    for pkg in PKGS:
        lane, _c, _t = make_lane(pkg, "differential")
        d, cons = make_driver(pkg, lane)
        reviews = reviews_of(pkg, corpus()[:4])
        with pkg.lane.activate(lane):
            d.query_batch(TARGET, cons, reviews)
            col = lane.column("digest")
            key = sorted(col.snapshot())[0]
            col.land({key: ("tampered", None)})
            with pytest.raises(pkg.lane.ExtDataDivergence):
                d.query_batch(TARGET, cons, reviews)


# --- the audit sweep -----------------------------------------------------------

def sweep_pods():
    pods = []
    for i in range(120):
        img = f"bad/i{i % 7}" if i % 3 == 0 else f"ok/i{i % 11}"
        pods.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "uid": f"u{i}"},
                     "spec": {"containers": [{"name": "c", "image": img}]}})
    return pods


@pytest.mark.parametrize("collect", ["reduced", "masks"])
def test_sweep_matches_jax(collect):
    pods = sweep_pods()
    out = {}
    for pkg in PKGS:
        lane, _c, tr = make_lane(pkg)
        d, cons = make_driver(pkg, lane, kinds=("K8sExtData",))
        if pkg is JAX:
            ev = ShardedEvaluator(d, make_mesh(), collect=collect)
            rows_of = jviolation_rows
        else:
            ev = SweepEvaluator(d, device="cpu", collect=collect)
            rows_of = tviolation_rows
        with pkg.lane.activate(lane):
            res = ev.sweep(cons, pods, return_bits=True)["K8sExtData"]
            counts, bits = res[3], res[4]
            rows = sorted(rows_of(bits, 0, len(pods)).tolist())
            calls = tr.calls
            lane.mode = "perkey"
            left_out = ev.sweep(cons, pods)
        out[pkg.name] = (int(counts[0]), rows, calls, left_out)
        if pkg is PORT:
            assert ev.perf["extdata"] > 0
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 40 and out["torch"][2] == 1
    assert out["torch"][3] == {}


EXTDATA_CONSTRAINTS = [
    {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
     "metadata": {"name": name},
     "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}}
    for kind, name in (("K8sExtData", "trusted-images"),
                       ("K8sDigest", "pinned-images"))]


def library_client(pkg, objects):
    """The library (46 templates, sample constraints) plus both extdata
    templates, each with one constraint on v1 Pods."""
    if pkg is JAX:
        cel = JCELDriver()
        driver = TpuDriver(cel_driver=cel)
        client = JClient(target=JTarget(), drivers=[driver, cel],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        jload(client)
    else:
        cel = TCELDriver()
        driver = TorchDriver(cel_driver=cel, device="cpu")
        client = TClient(target=TTarget(), drivers=[driver, cel],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        tload(client)
    for kind, rules in (("K8sExtData", RULES_ERRORS),
                        ("K8sDigest", RULES_DIGEST)):
        client.add_template(template_obj(kind, rules))
    for con in EXTDATA_CONSTRAINTS:
        client.add_constraint(copy.deepcopy(con))
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    return client, driver


def canonical(run):
    kept = {key: sorted((v.message, v.kind, v.name, v.namespace)
                        for v in vs) for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept


@pytest.fixture(scope="module")
def library_objects():
    return make_cluster_objects(2000, seed=7)


@pytest.fixture(scope="module")
def jax_library_run(library_objects):
    lane, _c, tr = make_lane(JAX, transport=PrefixTransport())
    client, driver = library_client(JAX, library_objects)
    ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20)
    with jlane.activate(lane):
        run = JManager(client, lambda: iter(library_objects),
                       JConfig(chunk_size=512, pipeline="off"),
                       evaluator=ev).audit()
    return canonical(run), tr.calls


@pytest.mark.parametrize("source", ["relist", "snapshot"])
def test_library_audit_with_extdata_matches_jax(library_objects,
                                                jax_library_run, source):
    """The library plus both image templates through the port's
    ``AuditManager`` on the relist and on the snapshot lane (whose Pod
    group the residency declines: extdata joins keep host columns)."""
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    want, jcalls = jax_library_run
    lane, _c, tr = make_lane(PORT, transport=PrefixTransport())
    client, driver = library_client(PORT, library_objects)
    assert {"K8sExtData", "K8sDigest"} <= set(driver.lowered_kinds())
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20)
    cfg = TConfig(chunk_size=512, audit_source=source)
    ingester = None
    with tlane.activate(lane):
        if source == "relist":
            mgr = TManager(client, lambda: iter(library_objects), cfg,
                           evaluator=ev)
        else:
            cluster = FakeCluster()
            for o in library_objects:
                cluster.apply(o)
            snap = ClusterSnapshot(ev, SnapshotConfig())
            ingester = WatchIngester(snap, cluster,
                                     gvks_of(cluster.list())).start()
            residency = DeviceResidency(ev, mode="on")
            mgr = TManager(client, cluster.list, cfg, evaluator=ev,
                           snapshot=snap, residency=residency)
        try:
            got = canonical(mgr.audit())
        finally:
            if ingester is not None:
                ingester.stop()
    assert got == want
    totals = got[1]
    assert totals[("K8sExtData", "trusted-images")] > 0
    assert totals[("K8sDigest", "pinned-images")] > 0
    assert ev.perf["extdata"] > 0
    if source == "relist":
        assert tr.calls == jcalls
    else:
        assert any("external-data joins" in r
                   for r in residency._logged_reasons)
        assert mgr.perf.get("snapshot_host_chunks", 0) > 0


# --- mutation placeholders ------------------------------------------------------

def pin_image(policy):
    return {
        "apiVersion": "mutations.gatekeeper.sh/v1",
        "kind": "Assign",
        "metadata": {"name": "pin-image"},
        "spec": {
            "applyTo": [{"groups": [""], "versions": ["v1"],
                         "kinds": ["Pod"]}],
            "location": "spec.containers[name:*].image",
            "parameters": {"assign": {"externalData": {
                "provider": "digest", "dataSource": "ValueAtLocation",
                "failurePolicy": policy, "default": "fallback:latest"}}},
        },
    }


def mutate_pods():
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"m{i}", "namespace": "default"},
             "spec": {"containers": [
                 {"name": "a", "image": "repo/a"},
                 {"name": "b", "image": f"repo/b{i % 3}"},
                 {"name": "c", "image": "repo/nodigest" if i % 4 == 3
                  else "repo/a@sha256:abc"}]}}
            for i in range(8)]


def mutate_all(pkg, mode, policy):
    lane, cache, tr = make_lane(pkg, mode)
    ms = pkg.MutationSystem(provider_cache=cache)
    ms.upsert_unstructured(pin_image(policy))
    out = []
    with pkg.lane.activate(lane):
        for pod in mutate_pods():
            try:
                changed = ms.mutate(pod)
                out.append(("ok", changed, pod))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e)))
    return out, tr.calls


@pytest.mark.parametrize("policy", ["Fail", "Ignore", "UseDefault"])
def test_mutation_placeholders_match_jax(policy):
    want, jcalls = mutate_all(JAX, "batched", policy)
    got, calls = mutate_all(PORT, "batched", policy)
    perkey, _pcalls = mutate_all(PORT, "perkey", policy)
    assert got == want and calls == jcalls
    assert perkey == got
    kinds = {r[0] for r in got}
    assert kinds == ({"ok", "ProviderError"} if policy == "Fail"
                     else {"ok"})
    pinned = got[0][2]["spec"]["containers"]
    assert pinned[0]["image"] == "repo/a@sha256:abc"


def admission_body(obj, uid):
    meta = obj["metadata"]
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
                        "name": meta["name"],
                        "namespace": meta["namespace"],
                        "userInfo": {"username": "alice"}, "object": obj}}


def post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/mutate", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("policy", ["Fail", "Ignore"])
def test_v1_mutate_patches_match_jax_handler(policy):
    """``/v1/mutate`` of the port's ``WebhookServer`` (the batched
    mutation lane behind its batcher, placeholders through the batched
    extdata lane) answers what the JAX ``MutationHandler`` answers."""
    bodies = [admission_body(p, f"u{i}") for i, p in
              enumerate(mutate_pods())]
    jl, jcache, _jt = make_lane(JAX)
    js = JMutationSystem(provider_cache=jcache)
    js.upsert_unstructured(pin_image(policy))
    ref = JMutationHandler(js)
    with jlane.activate(jl):
        want = []
        for body in bodies:
            m = ref.handle(copy.deepcopy(body))
            want.append(jresponse(m.uid, m.allowed, m.message, m.code,
                                  warnings=m.warnings, patch=m.patch))
    tl, tcache, _tt = make_lane(PORT)
    ts = TMutationSystem(provider_cache=tcache)
    ts.upsert_unstructured(pin_image(policy))
    batcher = MutationBatcher(MutationLane(ts, device="cpu")).start()
    server = WebhookServer(
        mutation_handler=BatchedMutationHandler(ts, lane=batcher.lane,
                                                batcher=batcher),
        port=0, mutation_batcher=batcher).start()
    try:
        with tlane.activate(tl):
            got = [post(server.port, copy.deepcopy(b)) for b in bodies]
    finally:
        assert server.stop()
    assert got == want
    assert all("patch" in w["response"] or w["response"].get("status")
               for w in want)
    assert tl.perf.get("bulk_calls/digest", 0) > 0


# --- failure semantics (partial, retry then stale, breaker, schema) ----------

def failure_case(pkg, mode, case):
    """Per-key outcomes of one failure scenario on one lane mode."""
    ttl = {"response_ttl_s": 0.0} if case in ("stale", "breaker") else {}
    tr = Transport()
    lane, cache, _ = make_lane(pkg, mode, transport=tr, cache_kw=ttl,
                               **({"column_ttl_s": 0.0} if ttl else {}))
    keys = [f"ok/k{i}" for i in range(6)] + ["bad/x"]
    rec = []
    with pkg.lane.activate(lane):
        if case == "partial":
            tr.drop = True
            rec.append(lane.resolve_keys("trusted", keys))
            tr.drop = False
            calls = tr.calls
            rec.append(lane.resolve_keys("trusted", keys))
            rec.append(tr.calls - calls)  # dropped keys stay resident
        elif case == "stale":
            rec.append(lane.resolve_keys("trusted", keys))
            tr.down = True
            calls = tr.calls
            # the transport fails, the retry fails, the last good values
            # serve stale without an error
            rec.append(lane.resolve_keys("trusted", keys[:1]))
            rec.append(tr.calls - calls)
        elif case == "breaker":
            clean = lane.resolve_keys("trusted", keys)
            tr.down = True
            for _ in range(4):
                stale = {k: (v, bool(e)) for k, (v, e) in
                         lane.resolve_keys("trusted", keys).items()}
            calls = tr.calls
            rec.append(stale == {k: (v, bool(e))
                                 for k, (v, e) in clean.items()})
            rec.append(lane.cache._breaker("trusted").state)
            rec.append({k: (v, bool(e)) for k, (v, e) in
                        lane.resolve_keys("trusted", keys).items()})
            rec.append(tr.calls - calls)  # open: no transport
        elif case == "malformed":
            orig = lane.cache.fetch

            def rogue(provider, ks):
                res = dict(orig(provider, ks))
                if "ok/k1" in res:
                    res["ok/k1"] = "not a pair"
                if "ok/k2" in res:
                    res["ok/k2"] = ("v", 123)
                return res

            lane.cache.fetch = rogue
            rec.append(lane.resolve_keys("trusted", keys))
            if mode != "perkey":
                calls = tr.calls
                rec.append(lane.resolve_keys("trusted", keys))
                rec.append(tr.calls - calls)
                rec.append(lane.perf.get("keys/trusted/malformed")
                           if pkg is PORT else None)
    return rec


@pytest.mark.parametrize("case", ["partial", "stale", "breaker",
                                  "malformed"])
def test_failure_semantics_match_jax(case):
    for mode in ("batched", "perkey"):
        got = failure_case(PORT, mode, case)
        want = failure_case(JAX, mode, case)
        if case == "malformed" and mode != "perkey":
            assert got[-1] == 2
            got, want = got[:-1], want[:-1]
        assert got == want, (mode, got, want)
    batched = failure_case(PORT, "batched", case)
    perkey = failure_case(PORT, "perkey", case)
    if case == "partial":
        # perkey sends one key per call, so nothing is dropped there; the
        # batched lane surfaces every dropped key as a per-key error
        dropped = [k for k, (v, e) in batched[0].items()
                   if e and "key not returned" in e]
        assert dropped == ["ok/k1", "ok/k3", "ok/k5"]
        assert not any("key not returned" in (e or "")
                       for _v, e in perkey[0].values())
        assert batched[2] == 0
    elif case == "stale":
        assert batched[1] == perkey[1] == {"ok/k0": ("ok/k0", None)}
        assert batched[2] == perkey[2] == 2  # the send and its retry
    elif case == "breaker":
        assert batched == perkey
        assert batched[0] is True and batched[1] == "open"
        assert batched[3] == 0
    else:
        from gatekeeper_tpu_torch.extdata.lane import _MALFORMED

        assert batched[0]["ok/k1"] == batched[0]["ok/k2"] == \
            (None, _MALFORMED)
        assert batched[0]["ok/k0"] == ("ok/k0", None)
        assert batched[2] == 0


def test_response_schema_gate_matches_jax():
    landed = {
        "ok": ("v", None), "ok-err": (None, "boom"),
        "ok-nested": ({"a": [1, None]}, None), "wrong-arity": ("v",),
        "wrong-value": (object(), None), "wrong-error": ("v", 7),
        "not-a-pair": "v", 3: ("v", None),
    }
    got = tlane.validate_landed(landed)
    assert got == jlane.validate_landed(landed)
    assert got[1] == 5 and 3 not in got[0]
    assert got[0]["wrong-value"] == (None, tlane._MALFORMED)


# --- the CLI ---------------------------------------------------------------------

def closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_manifests(tmp_path):
    """The library's allowedrepos, both image templates, a Provider for
    each at a closed local port (every key fails closed: no network) and
    one Provider that is refused (no caBundle)."""
    from gatekeeper_tpu.webhook.certs import generate_certs

    ca = generate_certs(str(tmp_path / "certs"))["ca_bundle"]
    lib = os.path.join(ROOT, "library", "general", "allowedrepos")
    docs = []
    for f in ("template.yaml", "samples/constraint.yaml",
              "samples/example_allowed.yaml",
              "samples/example_disallowed.yaml"):
        with open(os.path.join(lib, f)) as fh:
            docs.append(fh.read())
    port = closed_port()
    extra = [template_obj(kind, rules) for kind, rules in
             (("K8sExtData", RULES_ERRORS), ("K8sDigest", RULES_DIGEST))]
    extra += copy.deepcopy(EXTDATA_CONSTRAINTS)
    for name in ("trusted", "digest"):
        extra.append({"apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                      "kind": "Provider", "metadata": {"name": name},
                      "spec": {"url": f"https://127.0.0.1:{port}/{name}",
                               "timeout": 2, "caBundle": ca}})
    extra.append({"apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                  "kind": "Provider", "metadata": {"name": "refused"},
                  "spec": {"url": "https://127.0.0.1:1/x"}})
    extra += [{"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": f"img-{i}", "namespace": "default"},
               "spec": {"containers": [{"name": "c", "image": img}]}}
              for i, img in enumerate(["openpolicyagent/opa:1",
                                       "nginx", "openpolicyagent/opa:1"])]
    docs.append(yaml.safe_dump_all(extra))
    os.makedirs(tmp_path / "m")
    for i, doc in enumerate(docs):
        (tmp_path / "m" / f"{i:02d}.yaml").write_text(doc)
    return tmp_path / "m"


@pytest.mark.parametrize("mode", ["batched", "perkey"])
def test_cli_once_with_providers_matches_jax_cli(tmp_path, mode):
    """``--once --extdata-lane MODE`` prints the JAX CLI's kept-violation
    lines.  Both controller planes write a status object for the refused
    Provider (not a line on stderr) and one per template, and both audits
    count them."""
    manifests = cli_manifests(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for pkg, extra in (("gatekeeper_tpu", []),
                       ("gatekeeper_tpu_torch", ["--device", "cpu"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(manifests),
             "--once", "--extdata-lane", mode, *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[pkg] = (p.stdout, int(m.group(1)), int(m.group(2)), p.stderr)
    jax_out, jax_n, jax_v, _ = outs["gatekeeper_tpu"]
    out, n, v, err = outs["gatekeeper_tpu_torch"]
    assert out == jax_out and v == jax_v
    assert "K8sExtData/trusted-images" in out
    assert "Provider refused skipped" not in err, err
    assert ("extdata lane: perkey" in err) == (mode == "perkey")
    assert jax_n == n
