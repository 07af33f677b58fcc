"""The port's batched admission path (``TorchDriver.query_batch`` in
gatekeeper_tpu_torch/drivers/torch_driver.py, on the CPU) against the JAX
package's ``TpuDriver.query_batch``, both with ``batch_bucket=16``, over
every template of ``library/`` (44 Rego, 2 CEL) with its sample constraint
and a
seeded population of 300 synthetic objects (Ingresses synced into the
inventory).  Per review the sorted (constraint name, message) lists must
be identical.  Further cases: ``render_messages=False``, ``cfg.stats``,
UPDATE reviews that carry an ``oldObject``, the inventory-referencing
``K8sUniqueIngressHost``, the per-batch upload memo, and the audit's
``_chunk_via_query_batch`` route for a kind the sweep leaves out."""

import copy
import glob
import os
from collections import Counter

import pytest
import torch

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.base import ReviewCfg as JCfg  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.target.review import \
    AugmentedUnstructured as JAug  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu.webhook.policy import \
    parse_admission_review as jparse  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.base import ReviewCfg as TCfg  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir import program as tprog  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.target.review import \
    AugmentedUnstructured as TAug  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook.policy import \
    parse_admission_review as tparse  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library")
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
N_OBJECTS = 300
TARGET = "admission.k8s.gatekeeper.sh"


def _population(n, seed):
    """Seeded synthetic objects plus two Ingresses that share a host (a
    K8sUniqueIngressHost violation each)."""
    objects = make_cluster_objects(n - 2, seed=seed)
    for name in ("dup-a", "dup-b"):
        objects.append({
            "apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"rules": [{"host": "shared.example.com"}]}})
    return objects


def _clients(objects, skip_kinds=(), library=None,
             driver_kw=(("device", "cpu"),)):
    jcel, tcel = JCELDriver(), TCELDriver()
    jd = TpuDriver(batch_bucket=16, cel_driver=jcel)
    jc = JClient(target=JTarget(), drivers=[jd, jcel],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    td = TorchDriver(batch_bucket=16, cel_driver=tcel, **dict(driver_kw))
    tc = TClient(target=TTarget(), drivers=[td, tcel],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert jload(jc, library=library, skip_kinds=skip_kinds) == \
        tload(tc, library=library, skip_kinds=skip_kinds)
    for o in objects:
        if o.get("kind") == "Ingress":
            jc.add_data(o)
            tc.add_data(o)
    return jd, jc, td, tc


@pytest.fixture(scope="module")
def lib():
    objects = _population(N_OBJECTS, seed=5)
    jd, jc, td, tc = _clients(objects)
    assert not td.fallback_kinds()
    return jd, jc, td, tc, objects


def _reviews(client, aug_cls, objects):
    return [client.target.handle_review(aug_cls(object=copy.deepcopy(o)))
            for o in objects]


def _cons(client):
    return sorted(client.constraints(), key=lambda c: c.key())


def _keyed(responses):
    return [sorted((r.constraint["metadata"]["name"], r.msg)
                   for r in qr.results) for qr in responses]


def _both(lib, objects=None, jreviews=None, treviews=None, kinds=None,
          **kw):
    jd, jc, td, tc, objs = lib
    objects = objs if objects is None else objects
    jreviews = jreviews or _reviews(jc, JAug, objects)
    treviews = treviews or _reviews(tc, TAug, objects)
    jcons = [c for c in _cons(jc) if kinds is None or c.kind in kinds]
    tcons = [c for c in _cons(tc) if kinds is None or c.kind in kinds]
    jcfg = JCfg(**kw.pop("cfg", {}))
    tcfg = TCfg(**vars(jcfg))
    want = jd.query_batch(TARGET, jcons, jreviews, jcfg, **kw)
    got = td.query_batch(TARGET, tcons, treviews, tcfg, **kw)
    return want, got


def test_query_batch_matches_jax(lib):
    want, got = _both(lib)
    assert len(got) == len(want) == N_OBJECTS
    assert _keyed(got) == _keyed(want)
    kinds = {r.constraint["kind"] for qr in got for r in qr.results}
    assert len(kinds) >= 10 and sum(map(len, _keyed(got))) > 100
    assert set(CEL_KINDS) <= kinds


def test_query_batch_stats_without_messages(lib):
    """``render_messages=False`` gives one empty-message result per hit;
    ``cfg.stats`` adds one batch StatsEntry to the first response."""
    want, got = _both(lib, render_messages=False, cfg={"stats": True})
    assert _keyed(got) == _keyed(want)
    assert all(r.msg == "" for qr in got for r in qr.results)
    assert sum(map(len, _keyed(got))) > 100
    assert [len(qr.stats_entries) for qr in got] == \
        [1] + [0] * (N_OBJECTS - 1)
    (entry,), (jentry,) = got[0].stats_entries, want[0].stats_entries
    assert entry.scope == jentry.scope == "batch"
    assert entry.stats_for == jentry.stats_for
    assert [s.name for s in entry.stats] == [s.name for s in jentry.stats] \
        == ["batchEvalNS", "flattenNS", "totalNS"]
    assert all(s.value > 0 and s.source == {"type": "engine",
                                            "value": "Torch"}
               for s in entry.stats)
    assert "device verdict" in lib[2].get_description_for_stat(
        "batchEvalNS")


def _update_bodies():
    """The library's UPDATE AdmissionReviews, plus a Pod whose service
    account changed (an UPDATE of an object with an oldObject) and the
    same Pod unchanged."""
    bodies = []
    for path in sorted(glob.glob(os.path.join(LIB, "*", "*", "samples",
                                              "update_*.yaml"))):
        bodies.extend(load_yaml_file(path))
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "default"},
           "spec": {"serviceAccountName": "new",
                    "containers": [{"name": "c", "image": "nginx"}]}}
    old = copy.deepcopy(pod)
    old["spec"]["serviceAccountName"] = "old"
    for i, prev in enumerate((old, pod)):
        bodies.append({"request": {
            "uid": f"u{i}", "operation": "UPDATE",
            "userInfo": {"username": "bob"},
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": "p", "namespace": "default",
            "object": pod, "oldObject": prev}})
    assert len(bodies) >= 5
    return bodies


def test_query_batch_update_with_old_object(lib):
    _jd, jc, _td, tc, _objs = lib
    bodies = _update_bodies()
    want, got = _both(
        lib, objects=[],
        jreviews=[jc.target.handle_review(jparse(copy.deepcopy(b)))
                  for b in bodies],
        treviews=[tc.target.handle_review(tparse(copy.deepcopy(b)))
                  for b in bodies],
        kinds={"K8sNoUpdateServiceAccount", "K8sRequiredLabels",
               "K8sAllowedRepos"})
    assert _keyed(got) == _keyed(want)
    hits = [r.constraint["kind"] for qr in got for r in qr.results]
    assert hits.count("K8sNoUpdateServiceAccount") == 2


def test_query_batch_inventory_join(lib):
    """K8sUniqueIngressHost joins each Ingress against the synced ones."""
    want, got = _both(lib, kinds={"K8sUniqueIngressHost"})
    assert _keyed(got) == _keyed(want)
    assert sum(map(len, _keyed(got))) > 0


def test_batch_cache_uploads_each_column_once(lib, monkeypatch):
    """Within one query_batch every batch column reaches the device once,
    however many kinds read it (the per-batch memo), and a second batch
    finds every vocab and inventory table in the driver's persistent
    cache."""
    _jd, _jc, td, tc, objects = lib
    seen: dict = {}  # (scope, id) -> uploads
    hits: Counter = Counter()
    dev_cached = tprog._dev_cached

    def counting_dev_cached(cache, a, device):
        scope = "shared" if cache is td._dev_cache else "batch"
        if id(a) in cache:
            hits[scope] += 1
        else:
            seen[scope, id(a)] = seen.get((scope, id(a)), 0) + 1
        return dev_cached(cache, a, device)

    monkeypatch.setattr(tprog, "_dev_cached", counting_dev_cached)
    reviews = _reviews(tc, TAug, objects[:40])
    td._dev_cache.clear()
    td.query_batch(TARGET, _cons(tc), reviews)
    batch_uploads = sum(v for (scope, _), v in seen.items()
                        if scope == "batch")
    assert max(seen.values()) == 1 and batch_uploads > 0
    # shared columns (object identity, labels, containers) are read by
    # many kinds: the memo answered more column requests than it uploaded
    assert hits["batch"] > batch_uploads
    seen.clear()
    hits.clear()
    td.query_batch(TARGET, _cons(tc), reviews)
    assert not [k for k in seen if k[0] == "shared"] and hits["shared"] > 0


@pytest.mark.parametrize("driver_kw", [(("device", "cpu"),), ()],
                         ids=["cpu-driver", "default-driver"])
def test_audit_query_batch_route_matches_jax(driver_kw):
    """An Ingress whose host is not a string makes K8sUniqueIngressHost's
    inventory table inexact: the sweep leaves the kind out and the audit
    hands it to the driver's query_batch, on the sweep's device, which
    runs the interpreter on it.  Totals and kept violations must equal the
    JAX audit's, also with the driver left at its default device (which a
    host without a card cannot resolve)."""
    objects = _population(400, seed=9)
    odd = copy.deepcopy(next(o for o in objects if o["kind"] == "Ingress"))
    odd["metadata"]["name"] = "odd-host"
    odd["spec"]["rules"][0]["host"] = 5
    objects.append(odd)
    skip = tuple(k for k in _all_kinds() if k not in (
        "K8sUniqueIngressHost", "K8sRequiredLabels"))
    jd, jc, td, tc = _clients(objects, skip_kinds=skip, driver_kw=driver_kw)
    assert not jd.inventory_exact("K8sUniqueIngressHost")
    assert not td.inventory_exact("K8sUniqueIngressHost")
    calls = []
    real = td.query_batch

    def spy(target, constraints, reviews, cfg=None, **kw):
        calls.append(sorted({c.kind for c in constraints}))
        assert kw["device"] == torch.device("cpu")
        return real(target, constraints, reviews, cfg, **kw)

    td.query_batch = spy
    want = JManager(jc, lambda: iter(objects),
                    JConfig(chunk_size=128, pipeline="off"),
                    evaluator=ShardedEvaluator(jd, make_mesh(1))).audit()
    got = TManager(tc, lambda: iter(objects), TConfig(chunk_size=128),
                   evaluator=SweepEvaluator(td, device="cpu")).audit()
    assert calls and all(c == ["K8sUniqueIngressHost"] for c in calls)

    def summary(run):
        return run.total_objects, dict(run.total_violations), {
            k: [(v.kind, v.namespace, v.name, v.message) for v in vs]
            for k, vs in run.kept.items()}

    assert summary(got) == summary(want)
    assert got.total_violations[("K8sUniqueIngressHost",
                                 "unique-ingress-host")] > 0


def _all_kinds():
    kinds = []
    for path in glob.glob(os.path.join(LIB, "*", "*", "template.yaml")):
        doc = load_yaml_file(path)[0]
        kinds.append(doc["spec"]["crd"]["spec"]["names"]["kind"])
    return kinds
