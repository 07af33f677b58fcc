"""The port's controller plane (``controller/{manager,upgrade}.py``,
``readiness/tracker.py``, ``sync/{aggregator,cachemanager,routing}.py``,
``export/system.py``, ``webhook/certs.py``) against the JAX package's,
over ``FakeCluster`` manifests from ``library/`` and inline fixtures:

- the ``Manager`` of each package booted over the same objects gives
  equal templates, constraints and lowered kinds, the same store (status
  objects, folded parent statuses and generated VAPs included), the same
  readiness stats, Config traces, mutators, expansion templates and
  providers, and the audits of both (JAX ``ShardedEvaluator``, port
  ``SweepEvaluator`` on the CPU) give identical totals and kept lists;
- the referential sync loop, the excluder's wipe and replay, the readiness
  tracker's budgets and latch, the requeue of a failing template, the
  status fold of two replicas, the readiness pruners, the stored-version
  upgrade, VAP generation under the webhook configuration's scope, the
  routing split, disk export and certificates, each as the JAX package's
  own tests hold them;
- the differences the port kept until this plane existed are gone: a
  refused Provider writes a status object, a template applied after boot
  reaches the client through the Manager (with generation swaps on), and
  the handler and audit seams the CLI wires (snapshot namespace lookup,
  validation traces, stats, export) behave as the JAX ones."""

import copy
import json
import os
import shutil
import time

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa
from gatekeeper_tpu.audit import manager as jaudit  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.controller import manager as jmanager  # noqa: E402
from gatekeeper_tpu.controller import upgrade as jupgrade  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.export import system as jexport  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.sync import source as jsource  # noqa: E402
from gatekeeper_tpu.target.review import \
    AugmentedUnstructured as JAugmented  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu_torch import __main__ as cli  # noqa: E402
from gatekeeper_tpu_torch.audit import manager as taudit  # noqa: E402
from gatekeeper_tpu_torch.controller import manager as tmanager  # noqa
from gatekeeper_tpu_torch.controller import upgrade as tupgrade  # noqa
from gatekeeper_tpu_torch.export import system as texport  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.readiness.tracker import Tracker  # noqa: E402
from gatekeeper_tpu_torch.sync import source as tsource  # noqa: E402
from gatekeeper_tpu_torch.sync.aggregator import \
    GVKAggregator  # noqa: E402
from gatekeeper_tpu_torch.sync.routing import (  # noqa: E402
    OPERATOR_NAMESPACE, RoutingCluster)
from gatekeeper_tpu_torch.target.review import \
    AugmentedUnstructured  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch.utils.unstructured import \
    load_yaml_file  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library", "general")
SUBSET = ("requiredlabels", "allowedrepos", "containerlimits",
          "uniqueingresshost", "containerlimitscel")
STATUS_GROUP = "status.gatekeeper.sh"
TEMPLATES_GVK = ("templates.gatekeeper.sh", "v1", "ConstraintTemplate")
TARGET = "admission.k8s.gatekeeper.sh"

# a template whose metadata.name is not its kind in lower case: refused
BAD_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1", "kind": "ConstraintTemplate",
    "metadata": {"name": "not-the-kind"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sBadName"}}},
             "targets": [{"target": TARGET, "rego": "package x\n"
                          "violation[{\"msg\": \"m\"}] { true }\n"}]}}
VAP_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1", "kind": "ConstraintTemplate",
    "metadata": {"name": "k8svaptest"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sVapTest"}}},
             "targets": [{"target": TARGET, "code": [{
                 "engine": "K8sNativeValidation",
                 "source": {"generateVAP": True, "validations": [{
                     "expression": "object != null", "message": "m"}]}}]}]}}
CONFIG = {
    "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
    "metadata": {"name": "config", "namespace": "gatekeeper-system"},
    "spec": {"sync": {"syncOnly": [
        {"group": "networking.k8s.io", "version": "v1", "kind": "Ingress"},
        {"group": "", "version": "v1", "kind": "Namespace"}]},
        "match": [{"processes": ["*"], "excludedNamespaces": ["kube-*"]}],
        "validation": {"traces": [{"user": "tracer",
                                   "kind": {"group": "", "version": "v1",
                                            "kind": "Pod"}}]}}}
PROVIDERS = [
    {"apiVersion": "externaldata.gatekeeper.sh/v1beta1", "kind": "Provider",
     "metadata": {"name": "trusted"},
     "spec": {"url": "https://provider.local/validate", "caBundle": "Zm9v",
              "timeout": 1}},
    {"apiVersion": "externaldata.gatekeeper.sh/v1beta1", "kind": "Provider",
     "metadata": {"name": "refused"}, "spec": {"url": "http://insecure"}}]
MUTATOR = {
    "apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
    "metadata": {"name": "pull-always"},
    "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                          "kinds": ["Pod"]}],
             "location": "spec.containers[name: *].imagePullPolicy",
             "parameters": {"assign": {"value": "Always"}}}}
EXPANSION = {
    "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
    "kind": "ExpansionTemplate", "metadata": {"name": "expand-deployments"},
    "spec": {"applyTo": [{"groups": ["apps"], "kinds": ["Deployment"],
                          "versions": ["v1"]}],
             "templateSource": "spec.template",
             "generatedGVK": {"group": "", "version": "v1",
                              "kind": "Pod"}}}

PKGS = {
    "jax": {"manager": jmanager, "source": jsource, "audit": jaudit,
            "export": jexport, "upgrade": jupgrade, "policy": jpolicy},
    "port": {"manager": tmanager, "source": tsource, "audit": taudit,
             "export": texport, "upgrade": tupgrade, "policy": tpolicy},
}


def _library_docs(names=SUBSET) -> list:
    docs = []
    for name in names:
        docs += load_yaml_file(os.path.join(LIB, name, "template.yaml"))
        docs += load_yaml_file(os.path.join(LIB, name, "samples",
                                            "constraint.yaml"))
    return docs


def _client(pkg, generation_swap=False):
    """(client, driver): each package's device driver beside a CEL
    driver, as its CLI builds them (the port on the CPU)."""
    if pkg == "jax":
        cel = JCELDriver()
        driver = TpuDriver(cel_driver=cel)
        client = JClient(target=JTarget(), drivers=[driver, cel],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        return client, driver
    return cli.new_client(device="cpu", generation_swap=generation_swap)


def _boot(pkg, docs, **kw):
    """(client, driver, cluster, manager): ``docs`` applied to a
    ``FakeCluster`` before the Manager starts, so the readiness tracker
    expects them (the boot listing), then every expectation populated."""
    client, driver = _client(pkg)
    cluster = PKGS[pkg]["source"].FakeCluster()
    for doc in docs:
        cluster.apply(copy.deepcopy(doc))
    mgr = PKGS[pkg]["manager"].Manager(client, cluster, **kw).start()
    mgr.tracker.all_populated()
    return client, driver, cluster, mgr


def _audit(pkg, client, driver, cluster):
    if pkg == "jax":
        ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20)
        cfg = jaudit.AuditConfig(chunk_size=128, pipeline="off")
        mgr = jaudit.AuditManager(client, lambda: iter(cluster.list()), cfg,
                                  evaluator=ev)
    else:
        ev = SweepEvaluator(driver, device="cpu", violations_limit=20)
        mgr = taudit.AuditManager(client, lambda: iter(cluster.list()),
                                  taudit.AuditConfig(chunk_size=128),
                                  evaluator=ev)
    run = mgr.audit()
    kept = {k: [(v.kind, v.namespace, v.name, v.message) for v in vs]
            for k, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


@pytest.fixture(scope="module")
def booted():
    """Both packages' Managers over the same boot state, each store as the
    Manager left it (the audit then writes constraint statuses stamped
    with its own time), and the result of each package's audit over its
    store."""
    docs = (_library_docs() + [BAD_TEMPLATE, VAP_TEMPLATE, CONFIG,
                               MUTATOR, EXPANSION] + PROVIDERS
            + [{"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                "kind": "K8sVapTest", "metadata": {"name": "vap-c"},
                "spec": {}}]
            + make_cluster_objects(300, seed=11))
    out = {}
    for pkg in PKGS:
        client, driver, cluster, mgr = _boot(pkg, docs)
        store = copy.deepcopy(cluster.list())
        out[pkg] = (client, driver, cluster, mgr,
                    _audit(pkg, client, driver, cluster), store)
    return out


def test_manager_boot_matches_jax(booted):
    got = {}
    for pkg, (client, driver, _cl, mgr, _run, store) in booted.items():
        got[pkg] = {
            "templates": sorted(t.kind for t in client.templates()),
            "constraints": sorted((c.kind, c.name)
                                  for c in client.constraints()),
            "lowered": sorted(driver.lowered_kinds()),
            "store": store,
            "readiness": mgr.tracker.stats(),
            "satisfied": mgr.tracker.satisfied(),
            "traces": mgr.validation_traces,
            "excluded": [mgr.excluder.is_excluded(p, ns)
                         for p in ("audit", "webhook", "sync")
                         for ns in ("kube-system", "default")],
            "mutators": sorted(str(m.id) for m in
                               mgr.mutation_system.mutators()),
            "expansions": sorted(t.name for t in
                                 mgr.expansion_system.templates()),
            "template_error": mgr.template_error("not-the-kind"),
        }
    assert got["port"] == got["jax"]
    g = got["port"]
    assert "K8sBadName" not in g["templates"]
    # a refused Provider is never observed nor cancelled, so readiness
    # waits on it in both packages (JAX controller/manager.py
    # _reconcile_provider); every other kind has what it expected
    short = {k: (v["expected"], v["observed"], v["cancelled"])
             for k, v in g["readiness"].items()
             if v["observed"] + v["cancelled"] < v["expected"]}
    assert not g["satisfied"] and short == {"providers": (2, 1, 0)}
    assert "lowercase" in g["template_error"]
    status = [o for o in g["store"]
              if o["apiVersion"].startswith(STATUS_GROUP)]
    by_kind = {}
    for o in status:
        by_kind.setdefault(o["kind"], []).append(o)
    # one per template (the refused one carries its error), one for the
    # refused Provider
    assert len(by_kind["ConstraintTemplatePodStatus"]) == len(SUBSET) + 2
    (prov,) = by_kind["ExternalDataProviderPodStatus"]
    assert prov["metadata"]["labels"][
        "internal.gatekeeper.sh/parent-name"] == "refused"
    assert prov["status"]["errors"]
    assert any(o["kind"] == "ValidatingAdmissionPolicy"
               for o in g["store"])
    assert g["traces"] == CONFIG["spec"]["validation"]["traces"]
    assert g["excluded"] == [True, False] * 3


def test_audits_of_both_stores_are_identical(booted):
    runs = {pkg: b[4] for pkg, b in booted.items()}
    assert runs["port"] == runs["jax"]
    n_objects, totals, kept, incomplete = runs["port"]
    assert not incomplete and sum(totals.values()) > 0
    # the store's status objects are audited too: the JAX CLI's count
    assert n_objects == len(booted["port"][5])


def test_referential_sync_through_the_manager(booted):
    """Config syncOnly -> watch -> inventory -> referential verdicts, and
    a delete clears them, alike in both packages."""
    inventory = load_yaml_file(os.path.join(
        LIB, "uniqueingresshost", "samples", "example_inventory.yaml"))[0]
    conflicting = load_yaml_file(os.path.join(
        LIB, "uniqueingresshost", "samples", "example_disallowed.yaml"))[0]
    got = {}
    for pkg, (client, _d, cluster, _m, _r, _s) in booted.items():
        aug = (JAugmented if pkg == "jax" else AugmentedUnstructured)
        cluster.apply(copy.deepcopy(inventory))
        msgs = [r.msg for r in client.review(
            aug(object=copy.deepcopy(conflicting)),
            enforcement_point=WEBHOOK_EP).results()]
        cluster.delete(copy.deepcopy(inventory))
        after = [r.msg for r in client.review(
            aug(object=copy.deepcopy(conflicting)),
            enforcement_point=WEBHOOK_EP).results()]
        got[pkg] = (sorted(msgs), sorted(after))
    assert got["port"] == got["jax"]
    assert any("conflicts" in m for m in got["port"][0])
    assert not any("conflicts" in m for m in got["port"][1])


def test_excluder_change_wipes_and_replays():
    got = {}
    for pkg in PKGS:
        client, _d, cluster, mgr = _boot(pkg, [])
        cfg = {"apiVersion": "config.gatekeeper.sh/v1alpha1",
               "kind": "Config", "metadata": {"name": "config"},
               "spec": {"sync": {"syncOnly": [
                   {"group": "", "version": "v1", "kind": "Pod"}]}}}
        cluster.apply(copy.deepcopy(cfg))
        for name, ns in (("p1", "kube-system"), ("p2", "default")):
            cluster.apply({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": name, "namespace": ns}})
        before = json.dumps(client.drivers[0]._interp._data.get(
            "inventory", {}), sort_keys=True)
        cfg["spec"]["match"] = [{"processes": ["sync"],
                                 "excludedNamespaces": ["kube-*"]}]
        cluster.apply(cfg)
        after = json.dumps(client.drivers[0]._interp._data.get(
            "inventory", {}), sort_keys=True)
        got[pkg] = (before, after)
    assert got["port"] == got["jax"]
    before, after = got["port"]
    assert '"p1"' in before and '"p1"' not in after and '"p2"' in after


def test_readiness_tracker_budgets_and_latch():
    t = Tracker()
    t.expect("templates", "a")
    t.expect("templates", "b")
    t.all_populated()
    assert not t.satisfied()
    t.observe("templates", "a")
    t.try_cancel("templates", "b")
    assert t.satisfied()
    # the retry budget (object_tracker.go:158-188)
    t = Tracker(retries=2)
    t.expect("templates", "bad")
    t.all_populated()
    assert not t.try_cancel("templates", "bad")
    assert not t.try_cancel("templates", "bad")
    assert t.stats()["templates"]["retrying"] == 1
    assert t.try_cancel("templates", "bad") and t.satisfied()
    t = Tracker(retries=-1)
    t.expect("templates", "bad")
    t.all_populated()
    assert not any(t.try_cancel("templates", "bad") for _ in range(10))
    assert not t.satisfied()
    # once satisfied the tracker latches: late expectations are no-ops
    t = Tracker()
    t.expect("templates", "a")
    t.all_populated()
    t.observe("templates", "a")
    assert t.satisfied()
    snap = t.stats()["templates"]
    assert snap["satisfied"] and snap["expected"] == 1
    t.expect("templates", "late")
    assert t.satisfied() and t.stats()["templates"] == snap


@pytest.mark.parametrize("retries", [-1, 1, 3])
def test_poisoned_template_budget(retries):
    """A template that never compiles: with -1 retries readiness wedges;
    a finite budget is spent (by the Manager's own requeue when nothing
    else reconciles) and serving goes ready, as in the JAX package."""
    good = load_yaml_file(os.path.join(LIB, "requiredlabels",
                                       "template.yaml"))[0]
    _c, _d, cluster, mgr = _boot("port", [good, BAD_TEMPLATE],
                                 readiness_retries=retries)
    if retries < 0:
        assert not mgr.tracker.satisfied()
        assert mgr.tracker.stats()["templates"]["cancelled"] == 0
        return
    if retries == 1:
        cluster.apply(copy.deepcopy(BAD_TEMPLATE))  # one more failure
    deadline = time.time() + 20
    while time.time() < deadline and not mgr.tracker.satisfied():
        time.sleep(0.1)
    st = mgr.tracker.stats()["templates"]
    assert st["satisfied"] and st["cancelled"] == 1 and st["observed"] == 1


def test_two_replicas_fold_per_pod_status():
    cluster = tsource.FakeCluster()
    for pod_name, ops in (("gatekeeper-audit-0", ["audit"]),
                          ("gatekeeper-webhook-0", ["webhook"])):
        client, _d = _client("port")
        tmanager.Manager(client, cluster, operations=ops,
                         pod_name=pod_name).start()
    t = load_yaml_file(os.path.join(LIB, "requiredlabels",
                                    "template.yaml"))[0]
    cluster.apply(copy.deepcopy(t))
    stored = cluster.get(TEMPLATES_GVK, "", t["metadata"]["name"])
    by_pod = stored["status"]["byPod"]
    assert [(e["id"], e["operations"]) for e in by_pod] == [
        ("gatekeeper-audit-0", ["audit"]),
        ("gatekeeper-webhook-0", ["webhook"])]
    assert stored["status"]["created"] is True
    cluster.apply(copy.deepcopy(t))  # converges: no reconcile echo
    assert cluster.get(TEMPLATES_GVK, "", t["metadata"]["name"])[
        "status"]["byPod"] == by_pod


def test_readiness_pruners():
    """Boot constraints become expectations; a kind that never compiles
    prunes them; unwatching a GVK prunes its data expectations."""
    t = load_yaml_file(os.path.join(LIB, "requiredlabels",
                                    "template.yaml"))[0]
    con = load_yaml_file(os.path.join(LIB, "requiredlabels", "samples",
                                      "constraint.yaml"))[0]
    ghost = {**copy.deepcopy(con), "metadata": {"name": "never"}}
    _c, _d, _cl, mgr = _boot("port", [t, con, ghost])
    st = mgr.tracker.stats()["constraints"]
    assert mgr.tracker.satisfied() and st["expected"] == 2
    orphan = {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
              "kind": "K8sBadName", "metadata": {"name": "orphan"},
              "spec": {}}
    _c, _d, _cl, mgr = _boot("port", [BAD_TEMPLATE, orphan])
    assert mgr.tracker.satisfied()
    _c, _d, cluster, mgr = _boot("port", [])
    mgr.tracker.for_kind("data")._populated = False
    mgr.tracker.expect("data", (("", "v1", "Secret"), "default", "ghost"))
    mgr.tracker.populated("data")
    cfg = {"apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
           "metadata": {"name": "config"},
           "spec": {"sync": {"syncOnly": [
               {"group": "", "version": "v1", "kind": "Secret"}]}}}
    cluster.apply(copy.deepcopy(cfg))
    assert not mgr.tracker.for_kind("data").satisfied()
    cfg["spec"]["sync"]["syncOnly"] = []
    cluster.apply(cfg)
    assert mgr.tracker.for_kind("data").satisfied()


def test_aggregator_reverse_index():
    agg = GVKAggregator()
    agg.upsert(("config", "config"), [("", "v1", "Pod"),
                                      ("", "v1", "Secret")])
    agg.upsert(("syncset", "s1"), [("", "v1", "Pod")])
    assert agg.gvks() == {("", "v1", "Pod"), ("", "v1", "Secret")}
    agg.remove(("config", "config"))
    assert agg.gvks() == {("", "v1", "Pod")}
    agg.remove(("syncset", "s1"))
    assert agg.gvks() == set()


def test_upgrade_prunes_stored_versions_like_jax():
    owned = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "k8srequiredlabels.constraints.gatekeeper.sh"},
        "spec": {"group": "constraints.gatekeeper.sh",
                 "versions": [{"name": "v1beta1", "served": True,
                               "storage": True}]},
        "status": {"storedVersions": ["v1alpha1", "v1beta1"]}}
    foreign = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "foos.example.com"},
        "spec": {"group": "example.com", "versions": [{"name": "v1"}]},
        "status": {"storedVersions": ["v1alpha1", "v1"]}}
    got = {}
    for pkg, mods in PKGS.items():
        cluster = mods["source"].FakeCluster()
        cluster.apply(copy.deepcopy(owned))
        cluster.apply(copy.deepcopy(foreign))
        runs = (mods["upgrade"].run_upgrade(cluster),
                mods["upgrade"].run_upgrade(cluster))
        got[pkg] = (runs, cluster.list(mods["upgrade"].CRD_GVK))
    assert got["port"] == got["jax"]
    runs, crds = got["port"]
    assert runs == (1, 0)
    assert crds[0]["status"]["storedVersions"] == ["v1beta1"]


def test_vap_follows_the_webhook_configuration_scope():
    got = {}
    vap_gvk = ("admissionregistration.k8s.io", "v1",
               "ValidatingAdmissionPolicy")
    for pkg in PKGS:
        _c, _d, cluster, _m = _boot(pkg, [VAP_TEMPLATE])
        before = copy.deepcopy(cluster.list(vap_gvk))
        cluster.apply({
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": "gatekeeper-validating-webhook"},
            "webhooks": [{
                "name": "validation.gatekeeper.sh",
                "namespaceSelector": {"matchExpressions": [{
                    "key": "admission.gatekeeper.sh/ignore",
                    "operator": "DoesNotExist"}]},
                "rules": [{"apiGroups": [""], "apiVersions": ["v1"],
                           "operations": ["CREATE", "UPDATE"],
                           "resources": ["pods"]}]}]})
        got[pkg] = (before, cluster.list(vap_gvk))
    assert got["port"] == got["jax"]
    before, after = got["port"]
    assert "namespaceSelector" not in before[0]["spec"]["matchConstraints"]
    mc = after[0]["spec"]["matchConstraints"]
    assert mc["resourceRules"][0]["resources"] == ["pods"]


def _secret(ns, name="tls-cert", data="x"):
    return {"apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": name, "namespace": ns},
            "data": {"tls.crt": data}}


def test_routing_splits_management_and_target():
    mgmt, target = tsource.FakeCluster(), tsource.FakeCluster()
    rc = RoutingCluster(mgmt, target)
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "default"}}
    status = {"apiVersion": f"{STATUS_GROUP}/v1beta1",
              "kind": "ConstraintPodStatus",
              "metadata": {"name": "s", "namespace": OPERATOR_NAMESPACE}}
    rc.apply(pod)
    rc.apply(status)
    rc.apply(_secret(OPERATOR_NAMESPACE))
    rc.apply(_secret("default", "app-secret"))
    assert target.list(("", "v1", "Pod")) == [pod]
    assert mgmt.list((STATUS_GROUP, "v1beta1", "ConstraintPodStatus")) == \
        [status]
    assert [s["metadata"]["name"] for s in mgmt.list(("", "v1", "Secret"))] \
        == ["tls-cert"]
    # a same-named cert Secret on the target: management wins the merge
    target.apply(_secret(OPERATOR_NAMESPACE, data="target-side"))
    op = [s for s in rc.list(("", "v1", "Secret"))
          if s["metadata"]["namespace"] == OPERATOR_NAMESPACE]
    assert len(op) == 1 and op[0]["data"]["tls.crt"] == "x"
    rc.delete(_secret(OPERATOR_NAMESPACE))
    assert mgmt.get(("", "v1", "Secret"), OPERATOR_NAMESPACE,
                    "tls-cert") is None
    seen = []
    rc.subscribe(("", "v1", "Pod"), lambda e: seen.append(e.obj),
                 replay=True)
    assert seen == [pod]
    # the Manager runs unmodified on a RoutingCluster
    client, _d = _client("port")
    tmanager.Manager(client, rc).start()
    rc.apply(load_yaml_file(os.path.join(LIB, "requiredlabels",
                                         "template.yaml"))[0])
    assert [t.kind for t in client.templates()] == ["K8sRequiredLabels"]
    assert mgmt.list((STATUS_GROUP, "v1beta1",
                      "ConstraintTemplatePodStatus"))


def test_status_write_failure_propagates_and_target_is_untouched():
    from gatekeeper_tpu_torch.sync.kube import KubeError

    class Failing(tsource.FakeCluster):
        def apply(self, obj):
            raise KubeError(500, "management apiserver down")

    rc = RoutingCluster(Failing(), tsource.FakeCluster())
    with pytest.raises(KubeError):
        rc.apply({"apiVersion": f"{STATUS_GROUP}/v1beta1",
                  "kind": "ConstraintTemplatePodStatus",
                  "metadata": {"name": "s",
                               "namespace": OPERATOR_NAMESPACE}})
    rc.apply({"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "p", "namespace": "default"}})
    assert rc.get(("", "v1", "Pod"), "default", "p") is not None


def test_disk_export_of_an_audit_matches_jax(tmp_path):
    """``export_system=`` on the audit manager: the disk driver's run file
    holds audit_started, one line per kept violation and audit_ended,
    as the JAX audit writes it; rotation keeps the newest N."""
    docs = _library_docs(("requiredlabels", "allowedrepos"))
    objects = make_cluster_objects(80, seed=2)
    got = {}
    for pkg, mods in PKGS.items():
        client, driver, _cl, _m = _boot(pkg, docs)
        export = mods["export"].ExportSystem()
        root = tmp_path / pkg
        export.upsert_connection("disk", "disk", {"path": str(root),
                                                  "maxAuditResults": 2})
        kw = {"pipeline": "off"} if pkg == "jax" else {}
        mgr = mods["audit"].AuditManager(
            client, lambda: iter(objects),
            mods["audit"].AuditConfig(chunk_size=64, **kw),
            export_system=export, log_violations=True)
        run = mgr.audit()
        run_file = root / f"audit_{run.timestamp.replace(':', '_')}.jsonl"
        lines = [json.loads(ln) for ln in run_file.read_text().splitlines()]
        for ln in lines:
            assert ln.pop("auditID") == run.timestamp
        # rotation keeps the newest maxAuditResults run files
        for i in range(4):
            export.publish_audit_started(f"run{i}")
            export.publish_audit_ended(f"run{i}")
        files = sorted(p for p in os.listdir(root)
                       if p.startswith("audit_"))
        got[pkg] = (files, lines)
    assert got["port"] == got["jax"]
    files, lines = got["port"]
    assert files == ["audit_run2.jsonl", "audit_run3.jsonl"]
    assert lines[0]["event"] == "audit_started"
    assert lines[-1]["event"] == "audit_ended"
    assert sum(ln["event"] == "violation" for ln in lines) > 0


def test_template_after_boot_reaches_the_client_through_the_manager():
    """With generation swaps on and the background lane started (the
    served CLI's state after boot), a template and its constraint applied
    to the source compile off the serving path and then deny."""
    client, driver = _client("port", generation_swap=True)
    cluster = tsource.FakeCluster()
    mgr = tmanager.Manager(client, cluster).start()
    mgr.tracker.all_populated()
    assert mgr.begin_background_compile()
    try:
        for doc in _library_docs(("requiredlabels",)):
            cluster.apply(copy.deepcopy(doc))
        driver.gen_coord.wait_idle(timeout=60)
        ns = {"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "no-owner"}}
        msgs = [r.msg for r in client.review(
            AugmentedUnstructured(object=ns),
            enforcement_point=WEBHOOK_EP).results()]
        assert any("owner" in m for m in msgs), msgs
        assert "K8sRequiredLabels" in driver.lowered_kinds()
        assert driver.gen_coord.swap_count >= 1
    finally:
        driver.gen_coord.stop()


class _Snapshot:
    def __init__(self, ns):
        self.ns = ns
        self.asked = []

    def namespace(self, name):
        self.asked.append(name)
        return self.ns if name == self.ns["metadata"]["name"] else None


def _pod_review(uid, user="alice", ns="team-a"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
                        "namespace": ns, "name": "p",
                        "userInfo": {"username": user},
                        "object": {"apiVersion": "v1", "kind": "Pod",
                                   "metadata": {"name": "p",
                                                "namespace": ns},
                                   "spec": {"containers": [
                                       {"name": "c",
                                        "image": "nginx"}]}}}}


def test_handler_seams_match_jax(caplog):
    """The warm snapshot lookup answers before the source, a Config trace
    sends its user's request past the batcher with a trace dump, stats
    are logged with ``log_stats``, and ``fail_open`` admits a review that
    raises: the same answers and log lines in both packages."""
    docs = _library_docs(("allowedrepos",))
    ns_obj = {"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "team-a", "labels": {"env": "prod"}}}
    got = {}
    for pkg, mods in PKGS.items():
        client, _d, _cl, _m = _boot(pkg, docs)
        snap = _Snapshot(ns_obj)
        source = []
        handler = mods["policy"].ValidationHandler(
            client, snapshot=snap,
            namespace_lookup=lambda n: source.append(n),
            trace_config=lambda: CONFIG["spec"]["validation"]["traces"],
            log_stats=True)
        caplog.clear()
        with caplog.at_level("INFO"):
            answers = [handler.handle(_pod_review("u1")),
                       handler.handle(_pod_review("u2", user="tracer")),
                       handler.handle(_pod_review("u3", ns="other"))]
        events = sorted(json.loads(r.getMessage())["event_type"]
                        for r in caplog.records
                        if r.getMessage().startswith("{"))

        class Broken:
            drivers = []

            def review(self, *a, **kw):
                raise RuntimeError("boom")

        opened = mods["policy"].ValidationHandler(Broken(), fail_open=True)
        broken = opened.handle(_pod_review("u4"))
        got[pkg] = ([(a.allowed, a.code, a.message) for a in answers],
                    snap.asked, source, events, opened.failure_policy,
                    (broken.allowed, broken.warnings))
    assert got["port"] == got["jax"]
    answers, asked, source, events, policy, broken = got["port"]
    assert answers[0][0] is False and "nginx" in answers[0][2]
    assert asked == ["team-a", "team-a", "other"] and source == ["other"]
    assert "admission_trace" in events and "admission_stats" in events
    assert policy == "ignore" and broken[0] is True


def test_refused_provider_writes_a_status_object(booted):
    """The port no longer reports a refused Provider on stderr: its
    Manager writes the error to the Provider's status object, as the JAX
    controller does (checked object for object in the boot test)."""
    _c, _d, cluster, mgr, _r, _s = booted["port"]
    st = cluster.get((STATUS_GROUP, "v1beta1",
                      "ExternalDataProviderPodStatus"), "gatekeeper-system",
                     f"{mgr.pod_name}-provider-refused")
    assert st is not None
    assert st["status"]["errors"] == [
        {"message": "provider refused: url must be https"}]
    assert mgr.provider_cache.get("trusted") is not None


def test_webhook_certs_and_rotation(tmp_path):
    """``generate_certs`` gives a chain that verifies, ``ensure_cluster_
    certs`` keeps it in the Secret and injects the caBundle, and the
    rotation loop renews a chain near expiry and reloads the server."""
    if shutil.which("openssl") is None:
        pytest.skip("needs the openssl binary")
    import ssl
    import subprocess
    import threading

    from gatekeeper_tpu_torch.webhook import certs

    out = certs.generate_certs(str(tmp_path / "a"))
    proc = subprocess.run(["openssl", "verify", "-CAfile", out["ca"],
                           out["cert"]], capture_output=True, text=True)
    assert "OK" in proc.stdout
    ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER).load_cert_chain(out["cert"],
                                                            out["key"])
    cluster = tsource.FakeCluster()
    cert, key = certs.ensure_cluster_certs(cluster, str(tmp_path / "b"))
    secret = cluster.get(("", "v1", "Secret"), "gatekeeper-system",
                         "gatekeeper-webhook-server-cert")
    assert secret is not None and os.path.exists(cert)
    again = certs.ensure_cluster_certs(cluster, str(tmp_path / "c"))
    assert open(again[0]).read() == open(cert).read()  # read, not remade

    class Server:
        reloads = 0

        def reload_certs(self):
            Server.reloads += 1

    stop = threading.Event()
    t = threading.Thread(target=certs.rotation_loop,
                         args=(str(tmp_path / "a"), Server(), stop, 0.05),
                         kwargs={"renew_before_s": 10 * 365 * 86400.0},
                         daemon=True)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and not Server.reloads:
        time.sleep(0.05)
    stop.set()
    t.join(timeout=30)
    assert Server.reloads >= 1 and not t.is_alive()


# the JAX CLI's flags the port leaves to later slices (ROADMAP queue 1)
QUEUED_FLAGS = {"--coordinator", "--evaluate-sidecar", "--num-processes",
                "--process-id", "--shard-chunks"}
SLICE_ARGV = [
    "--kubeconfig", "k.yaml", "--management-manifests", "mgmt",
    "--readiness-retries", "3", "--export-dir", "exp",
    "--emit-admission-events", "--admission-events-involved-namespace",
    "--emit-audit-events", "--audit-events-involved-namespace",
    "--gatekeeper-namespace", "gk", "--log-stats-admission",
    "--client-ca-file", "ca.pem", "--cert-rotation-check-s", "60",
    "--fail-open-on-error", "--exempt-namespace", "a",
    "--exempt-namespace", "b", "--exempt-namespace-prefix", "kube-",
    "--exempt-namespace-suffix=-sys", "--operation", "audit",
    "--operation", "status"]


class _Parsed(Exception):
    pass


def _jax_args(monkeypatch, argv):
    """The JAX CLI's namespace for ``argv`` (its parser is built inside
    ``main``, so the parse is caught on its way out)."""
    import argparse

    from gatekeeper_tpu import __main__ as jcli

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["ns"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        jcli.main(list(argv))
    monkeypatch.undo()
    return seen["ns"]


@pytest.mark.parametrize("argv", [[], SLICE_ARGV], ids=["defaults", "set"])
def test_cli_flags_are_the_jax_clis_less_the_queued_ones(monkeypatch, argv):
    """Every flag of the JAX CLI but the queued ones parses in the port,
    to the same value, defaults included; the port adds ``--device``."""
    import re

    def flags(path):
        with open(path) as f:
            return set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                                  f.read()))
    root = os.path.join(os.path.dirname(__file__), "..")
    jax_flags = flags(os.path.join(root, "gatekeeper_tpu", "__main__.py"))
    port_flags = flags(os.path.join(root, "gatekeeper_tpu_torch",
                                    "__main__.py"))
    assert jax_flags - port_flags == QUEUED_FLAGS
    assert port_flags - jax_flags == {"--device"}
    port = vars(cli.build_parser().parse_args(argv))
    jax = vars(_jax_args(monkeypatch, argv))
    queued = {f[2:].replace("-", "_") for f in QUEUED_FLAGS}
    assert {k: v for k, v in jax.items() if k not in queued} == \
        {k: v for k, v in port.items() if k != "device"}


def test_cli_once_with_management_manifests_matches_jax(tmp_path):
    """``--once --management-manifests DIR``: the status objects route to
    the management cluster, whose seed objects are audited beside the
    target's; both CLIs print the same lines and count the same objects."""
    import re
    import subprocess
    import sys

    import yaml

    target, mgmt = tmp_path / "target", tmp_path / "mgmt"
    target.mkdir()
    mgmt.mkdir()
    docs = _library_docs(("requiredlabels", "allowedrepos"))
    docs += make_cluster_objects(60, seed=4)
    (target / "all.yaml").write_text(yaml.safe_dump_all(docs))
    (mgmt / "secret.yaml").write_text(yaml.safe_dump(
        {"apiVersion": "v1", "kind": "Secret",
         "metadata": {"name": "gatekeeper-webhook-server-cert",
                      "namespace": "gatekeeper-system"},
         "data": {"tls.crt": "eA=="}}))
    root = os.path.join(os.path.dirname(__file__), "..")
    outs = {}
    for pkg, extra in (("gatekeeper_tpu", []),
                       ("gatekeeper_tpu_torch", ["--device", "cpu"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(target),
             "--management-manifests", str(mgmt), "--once", *extra],
            cwd=root, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[pkg] = (p.stdout, int(m.group(1)), int(m.group(2)))
    assert outs["gatekeeper_tpu_torch"] == outs["gatekeeper_tpu"]
    out, n, v = outs["gatekeeper_tpu_torch"]
    assert v > 0 and n > len(docs)
