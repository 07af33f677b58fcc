"""Kubernetes Events of the port (``sync/events.py``) against the JAX
package: the admission sink (``--emit-admission-events``) and the audit
sink (``--emit-audit-events``) write the same corev1 Event objects through
the same apiserver client, over the port's mock apiserver.  Names and
timestamps are per emit; every other field must be equal."""

import copy

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.audit import manager as jmanager  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.sync import events as jevents  # noqa: E402
from gatekeeper_tpu.sync.kube import KubeCluster as JKube  # noqa: E402
from gatekeeper_tpu.sync.kube import KubeConfig as JKubeConfig  # noqa
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu_torch.audit import manager as tmanager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.sync import events as tevents  # noqa: E402
from gatekeeper_tpu_torch.sync.kube import KubeCluster, KubeConfig  # noqa
from gatekeeper_tpu_torch.sync.mock_apiserver import \
    MockApiServer  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

TARGET = "admission.k8s.gatekeeper.sh"
TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sdenyall"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sDenyAll"}}},
             "targets": [{"target": TARGET, "rego": """
package k8sdenyall

violation[{"msg": msg}] {
  msg := sprintf("denied: %v", [input.review.object.metadata.name])
}
"""}]},
}
CONSTRAINT = {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
              "kind": "K8sDenyAll", "metadata": {"name": "deny-everything"},
              "spec": {}}
PACKAGES = ("jax", "port")


def _review(uid):
    return {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {
            "uid": uid,
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE", "name": "bad-pod", "namespace": "apps",
            "userInfo": {"username": "alice"},
            "object": {"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": "bad-pod", "namespace": "apps",
                                    "uid": "u-1", "resourceVersion": "5"},
                       "spec": {"containers": []}},
        }}


@pytest.fixture()
def servers():
    """One mock apiserver per package, so each side's Events stand
    alone."""
    srvs = {p: MockApiServer().start() for p in PACKAGES}
    yield srvs
    for srv in srvs.values():
        srv.stop()


def _world(pkg, url):
    """(client, cluster, (events, policy, audit manager) modules)."""
    if pkg == "jax":
        client = JClient(target=JTarget(), drivers=[TpuDriver()],
                         enforcement_points=["validation.gatekeeper.sh",
                                             "audit.gatekeeper.sh"])
        cluster = JKube(JKubeConfig(server=url))
        mods = (jevents, jpolicy, jmanager)
    else:
        client = TClient(target=TTarget(),
                         drivers=[TorchDriver(device="cpu")],
                         enforcement_points=["validation.gatekeeper.sh",
                                             "audit.gatekeeper.sh"])
        cluster = KubeCluster(KubeConfig(server=url))
        mods = (tevents, tpolicy, tmanager)
    client.add_template(copy.deepcopy(TEMPLATE))
    client.add_constraint(copy.deepcopy(CONSTRAINT))
    return client, cluster, mods


def _events(cluster) -> list:
    """The Events on the apiserver, without what differs per emit (the
    generated name, timestamps, the annotation carrying the audit id and
    the server's resourceVersion), in a stable order."""
    out = []
    for ev in cluster.list(("", "v1", "Event")):
        ev = copy.deepcopy(ev)
        for k in ("firstTimestamp", "lastTimestamp"):
            assert ev.pop(k)
        meta = ev["metadata"]
        meta.pop("resourceVersion", None)
        assert meta.pop("name").startswith(
            ev["involvedObject"]["name"] + ".")
        ann = meta.get("annotations") or {}
        if "auditTimestamp" in ann:
            assert ann.pop("auditTimestamp")
        out.append(ev)
    return sorted(out, key=repr)


def test_violation_ref_semantics_match_jax():
    for args in (("gatekeeper-system", "Pod", "p", "apps", "7", "u1",
                  "K8sDenyAll", "deny-everything", "", flag)
                 for flag in (False, True)):
        assert tevents.violation_ref(*args) == jevents.violation_ref(*args)
    ref = tevents.violation_ref("gatekeeper-system", "Pod", "p", "apps",
                                "7", "u1", "K8sDenyAll", "deny-everything",
                                "", False)
    assert ref["namespace"] == "gatekeeper-system"
    assert ref["uid"] == "Pod/apps/p/K8sDenyAll//deny-everything"


@pytest.mark.parametrize("involved", [False, True],
                         ids=["gk-namespace", "involved-namespace"])
def test_admission_events_match_jax(servers, involved):
    """A denied review writes one FailedAdmission Event per result, in the
    gatekeeper namespace or (involved) in the object's own, as the JAX
    handler's sink does."""
    got = {}
    for pkg in PACKAGES:
        client, cluster, (events, policy, _m) = _world(pkg,
                                                       servers[pkg].url)
        try:
            rec = events.EventRecorder(cluster, "gatekeeper-webhook",
                                       involved_namespace=involved)
            handler = policy.ValidationHandler(
                client, event_sink=events.admission_event_sink(rec))
            resp = handler.handle(_review(f"req-{pkg}"))
            assert not resp.allowed
            rec.close()
            got[pkg] = _events(cluster)
        finally:
            cluster.close()
    assert got["port"] == got["jax"]
    (ev,) = got["port"]
    assert ev["reason"] == "FailedAdmission"
    assert ev["source"]["component"] == "gatekeeper-webhook"
    assert ev["metadata"]["namespace"] == ("apps" if involved
                                           else "gatekeeper-system")
    assert "Constraint: deny-everything" in ev["message"]
    assert ev["metadata"]["annotations"]["request_username"] == "alice"


def test_audit_events_match_jax_and_aggregate(servers):
    """One AuditViolation Event per kept violation; a second pass over the
    same violations bumps ``count`` on the same Events (series
    aggregation), in both packages."""
    objs = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "apps"},
             "spec": {"containers": []}} for i in range(3)]
    got = {}
    for pkg in PACKAGES:
        client, cluster, (events, _p, manager) = _world(pkg,
                                                        servers[pkg].url)
        try:
            rec = events.EventRecorder(cluster, "gatekeeper-audit")
            kw = {"pipeline": "off"} if pkg == "jax" else {}
            mgr = manager.AuditManager(
                client, lister=lambda: iter(objs),
                config=manager.AuditConfig(violations_limit=20, **kw),
                event_sink=events.audit_event_sink(rec))
            run = mgr.audit()
            assert sum(run.total_violations.values()) == 3
            rec.flush()
            first = _events(cluster)
            mgr.audit()
            rec.close()
            got[pkg] = (first, _events(cluster))
        finally:
            cluster.close()
    assert got["port"] == got["jax"]
    first, second = got["port"]
    assert len(first) == 3 and len(second) == 3
    assert sorted(e["involvedObject"]["name"] for e in first) == \
        ["p0", "p1", "p2"]
    assert {e["count"] for e in first} == {1}
    assert {e["count"] for e in second} == {2}
    for ev in first:
        assert ev["reason"] == "AuditViolation"
        ann = ev["metadata"]["annotations"]
        assert ann["process"] == "audit"
        assert ann["constraint_name"] == "deny-everything"


def test_event_emit_failure_is_reported_never_raised():
    class Boom:
        def create(self, obj):
            raise RuntimeError("apiserver down")

    errors = []
    rec = tevents.EventRecorder(Boom(), "gatekeeper-webhook",
                                on_error=errors.append)
    rec.annotated_event({"kind": "Pod", "name": "p",
                         "namespace": "gatekeeper-system"}, {},
                        "FailedAdmission", "msg")
    rec.flush()
    rec.close()
    assert len(errors) == 1 and "apiserver down" in str(errors[0])


def test_aggregation_preserves_first_timestamp(servers):
    cluster = KubeCluster(KubeConfig(server=servers["port"].url))
    try:
        rec = tevents.EventRecorder(cluster, "gatekeeper-audit")
        ref = tevents.violation_ref("gatekeeper-system", "Pod", "p0",
                                    "apps", "", "", "K8sDenyAll", "c", "",
                                    False)
        rec.annotated_event(ref, {}, "AuditViolation", "m")
        rec.flush()
        first = cluster.list(("", "v1", "Event"))[0]["firstTimestamp"]
        rec.annotated_event(ref, {}, "AuditViolation", "m")
        rec.flush()
        (ev,) = cluster.list(("", "v1", "Event"))
        assert ev["count"] == 2 and ev["firstTimestamp"] == first
        rec.close()
    finally:
        cluster.close()
