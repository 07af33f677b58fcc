"""The port's apiserver source (``sync/kube.py`` ``KubeCluster``) and its
mock apiserver (``sync/mock_apiserver.py``), against the JAX package's:

- paged LIST, GET, discovery, create/replace/delete and the 409 and
  ``/status`` write loops, as the JAX package's own tests hold them;
- a JAX ``KubeCluster`` and the port's over one mock yield the same
  objects (raw-bytes pages included) and the same watch events, a 410
  relist with its DELETED diff included;
- the port's mock answers what the JAX mock answers;
- a watch resumed from a resourceVersion lists nothing; one older than
  the mock's compaction relists and synthesizes DELETED for vanished keys;
- the ``kube.request`` and ``kube.watch`` fault sites and the
  ``kube.request`` span;
- the controller ``Manager`` of each package over its own mock apiserver
  (seeded alike from ``library/``): equal templates, constraints and
  lowered kinds, equal status objects written to the apiserver, equal
  readiness stats, and the discovery-driven audit of each (raw pages)
  gives identical totals and kept lists;
- the served CLI under ``--kubeconfig`` with ``--device cpu``."""

import copy
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.sync import kube as jkube  # noqa: E402
from gatekeeper_tpu.sync import mock_apiserver as jmock  # noqa: E402
from gatekeeper_tpu_torch import __main__ as cli  # noqa: E402
from gatekeeper_tpu_torch.sync import kube as tkube  # noqa: E402
from gatekeeper_tpu_torch.sync.kube import (KubeCluster,  # noqa: E402
                                            KubeConfig)
from gatekeeper_tpu_torch.sync.mock_apiserver import \
    MockApiServer  # noqa: E402
from gatekeeper_tpu_torch.sync.source import (ADDED, DELETED,  # noqa: E402
                                              MODIFIED)
from gatekeeper_tpu_torch.utils.synthetic import \
    make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch.utils.unstructured import \
    load_yaml_file  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LIB = os.path.join(ROOT, "library", "general")
POD_GVK = ("", "v1", "Pod")
ING_GVK = ("networking.k8s.io", "v1", "Ingress")
STATUS_GROUP = "status.gatekeeper.sh"
TEMPLATES = ("requiredlabels", "allowedrepos", "containerlimits")
WAIT_S = 30.0


def pod(name, ns="default", labels=None):
    meta = {"name": name, "namespace": ns}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "c", "image": "x"}]}}


def wait_for(pred, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture()
def server():
    srv = MockApiServer().start()
    yield srv
    srv.stop()


@pytest.fixture()
def cluster(server):
    kc = KubeCluster(KubeConfig(server=server.url), page_limit=3,
                     watch_backoff_s=0.05, watch_timeout_s=20.0)
    yield kc
    kc.close()


def test_paged_list_get_and_raw_pages(server, cluster):
    for i in range(8):  # 8 objects with page_limit 3 -> 3 pages
        server.put_object(pod(f"p{i}"))
    objs = cluster.list(POD_GVK)
    assert [o["metadata"]["name"] for o in objs] == [f"p{i}"
                                                     for i in range(8)]
    assert all(o["kind"] == "Pod" and o["apiVersion"] == "v1"
               for o in objs)
    raw = list(cluster.list_iter(POD_GVK))  # raw_list is the default
    assert [json.loads(bytes(r.raw)) for r in raw] == objs
    assert server.requests[("list", "Pod")] == 3 + 3
    assert cluster.get(POD_GVK, "default", "p3")["metadata"]["name"] == "p3"
    assert cluster.get(POD_GVK, "default", "nope") is None


def test_apply_create_conflict_update_delete(server, cluster):
    cluster.apply(pod("a"))
    assert server._objects[("Pod", "default", "a")]
    cluster.apply(pod("a", labels={"v": "2"}))  # 409 -> GET + PUT
    stored = server._objects[("Pod", "default", "a")]
    assert stored["metadata"]["labels"] == {"v": "2"}
    cluster.delete(pod("a"))
    assert ("Pod", "default", "a") not in server._objects
    cluster.delete(pod("a"))  # idempotent


def _scripted(kube_mod, script):
    """A KubeCluster of ``kube_mod`` whose transport replays ``script``:
    each entry a KubeError to raise or a dict to return."""
    kc = kube_mod.KubeCluster(kube_mod.KubeConfig(server="http://unused"),
                              retry_attempts=1)
    calls = []

    def fake(method, path, body=None, timeout=30.0):
        calls.append((method, path))
        step = script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step

    kc._request_once = fake
    kc._discovery[("", "v1")] = {"Pod": ("pods", True)}
    return kc, calls


def _pod_rv(rv):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p", "namespace": "d",
                         "resourceVersion": rv}}


@pytest.mark.parametrize("case", ["conflict-then-ok", "conflict-exhausted",
                                  "status-conflict", "status-deleted"])
def test_write_loops_match_jax(case):
    """The 409 read-modify-write loop of ``apply`` and the ``/status`` loop
    of ``apply_status`` make the same calls and raise the same errors in
    both packages (the routed writes rely on them)."""
    def script(mod):
        err = mod.KubeError
        if case == "conflict-then-ok":
            return [err(409, "exists"), _pod_rv("7"), err(409, "c"),
                    _pod_rv("8"), {}]
        if case == "conflict-exhausted":
            return [err(409, "exists")] + [_pod_rv("7"), err(409, "c")] * 4
        if case == "status-conflict":
            return [_pod_rv("5"), err(409, "c"), _pod_rv("6"), {}]
        return [_pod_rv("5"), err(404, "status path"), err(404, "gone")]

    got = {}
    for name, mod in (("jax", jkube), ("port", tkube)):
        kc, calls = _scripted(mod, script(mod))
        write = kc.apply_status if case.startswith("status") else kc.apply
        try:
            write(_pod_rv("1"))
            status = None
        except mod.KubeError as e:
            status = e.status
        got[name] = (calls, status)
    assert got["port"] == got["jax"]
    calls, status = got["port"]
    assert status == (409 if case == "conflict-exhausted" else None)


def test_discovery_and_preferred_gvks(server, cluster):
    server.put_object({"apiVersion": "networking.k8s.io/v1",
                       "kind": "Ingress",
                       "metadata": {"name": "i", "namespace": "default"},
                       "spec": {"rules": [{"host": "a.com"}]}})
    assert cluster.list(ING_GVK)[0]["metadata"]["name"] == "i"
    gvks = cluster.server_preferred_gvks()
    assert POD_GVK in gvks and ING_GVK in gvks
    jc = jkube.KubeCluster(jkube.KubeConfig(server=server.url))
    try:
        assert jc.server_preferred_gvks() == gvks
    finally:
        jc.close()


def test_kubeconfig_parsing_matches_jax(tmp_path):
    import base64 as b64

    kc_path = tmp_path / "config"
    kc_path.write_text("""
apiVersion: v1
kind: Config
current-context: ctx
contexts:
- name: ctx
  context: {cluster: c1, user: u1}
clusters:
- name: c1
  cluster:
    server: https://example:6443
    certificate-authority-data: %s
users:
- name: u1
  user:
    token: sekrit
""" % b64.b64encode(b"CA PEM").decode())
    cfg = KubeConfig.from_kubeconfig(str(kc_path))
    jcfg = jkube.KubeConfig.from_kubeconfig(str(kc_path))
    assert (cfg.server, cfg.token, cfg.insecure) == \
        (jcfg.server, jcfg.token, jcfg.insecure) == \
        ("https://example:6443", "sekrit", False)
    assert open(cfg.ca_file, "rb").read() == b"CA PEM"


def _events_of(kc, gvk, stop):
    """Subscribe and collect (type, name, labels) in arrival order."""
    out = []
    cancel = kc.subscribe(gvk, lambda ev: out.append(
        (ev.type, ev.obj["metadata"]["name"],
         (ev.obj["metadata"].get("labels") or {}))), replay=True)
    stop.append(cancel)
    return out


def test_jax_and_port_clusters_yield_the_same_events(server):
    """Replay, live ADDED/MODIFIED/DELETED and a 410 relist (an object
    deleted behind the watch, a compacted history and a broken stream)
    arrive alike at a JAX KubeCluster and the port's over one mock."""
    for i in range(4):
        server.put_object(pod(f"p{i}"))
    kcs = {"jax": jkube.KubeCluster(jkube.KubeConfig(server=server.url),
                                    page_limit=3, watch_backoff_s=0.05),
           "port": KubeCluster(KubeConfig(server=server.url), page_limit=3,
                               watch_backoff_s=0.05)}
    cancels: list = []
    try:
        evs = {k: _events_of(kc, POD_GVK, cancels) for k, kc in kcs.items()}

        def settled(n):
            return wait_for(lambda: all(len(e) >= n for e in evs.values()))

        assert settled(4)
        server.put_object(pod("live"))
        server.put_object(pod("p1", labels={"x": "y"}))
        server.delete_object("Pod", "default", "p2")
        assert settled(7)
        with server._lock:  # gone behind both watches
            server._objects.pop(("Pod", "default", "p3"))
        server.compact()
        server.break_watches("Pod")
        assert wait_for(lambda: all(
            (DELETED, "p3", {}) in e for e in evs.values()))
        time.sleep(0.3)  # let both relists finish
        assert evs["port"] == evs["jax"]
        kinds = [t for t, _n, _l in evs["port"]]
        assert kinds[:4] == [ADDED] * 4
        assert (MODIFIED, "p1", {"x": "y"}) in evs["port"]
        assert (DELETED, "p2", {}) in evs["port"]
        # the relist re-announces survivors as MODIFIED, never DELETED
        assert not [e for e in evs["port"][7:] if e[0] == DELETED
                    and e[1] != "p3"]
    finally:
        for c in cancels:
            c()
        for kc in kcs.values():
            kc.close()


def test_port_mock_answers_as_the_jax_mock():
    """The same writes give the same discovery documents, pages (continue
    tokens included), GETs and 404s from both mocks."""
    srvs = {"jax": jmock.MockApiServer().start(),
            "port": MockApiServer().start()}
    try:
        for srv in srvs.values():
            for i in range(7):
                srv.put_object(pod(f"p{i}", ns=f"ns{i % 2}"))
            srv.put_object(pod("p3", ns="ns1", labels={"v": "2"}))
            srv.delete_object("Pod", "ns0", "p4")
        paths = ["/api", "/apis", "/api/v1", "/apis/apps/v1",
                 "/api/v1/pods?limit=3", "/api/v1/pods?limit=3&continue=3",
                 "/api/v1/pods?limit=3&continue=6",
                 "/api/v1/namespaces/ns1/pods/p3",
                 "/api/v1/namespaces/ns1/pods/nope", "/api/v1/nothings"]
        got = {}
        for name, srv in srvs.items():
            answers = []
            for path in paths:
                try:
                    with urllib.request.urlopen(srv.url + path,
                                                timeout=10) as r:
                        answers.append((r.status, json.loads(r.read())))
                except urllib.error.HTTPError as e:
                    answers.append((e.code, json.loads(e.read())))
            got[name] = answers
        assert got["port"] == got["jax"]
        assert got["port"][4][1]["metadata"]["continue"] == "3"
        assert srvs["port"].requests[("list", "Pod")] == 3
    finally:
        for srv in srvs.values():
            srv.stop()


def test_resume_from_rv_lists_nothing_and_compaction_relists(server):
    """``from_rv`` (the spill's warm resume): a watch resumed from a
    resourceVersion inside the mock's window makes no LIST and replays
    the events it missed; one older than a compaction answers 410 and
    relists, with a DELETED for a seeded key the server no longer has."""
    for i in range(3):
        server.put_object(pod(f"p{i}"))
    rv = str(server._rv)
    server.put_object(pod("missed"))
    kc = KubeCluster(KubeConfig(server=server.url), watch_backoff_s=0.05)
    out: list = []
    try:
        lists0 = server.requests[("list", "Pod")]
        cancel = kc.subscribe(
            POD_GVK, lambda ev: out.append((ev.type,
                                            ev.obj["metadata"]["name"])),
            from_rv=rv, seed_known=[("default", f"p{i}") for i in range(3)])
        assert wait_for(lambda: (ADDED, "missed") in out)
        assert server.requests[("list", "Pod")] == lists0
        cancel()
        # compacted past the resume point: 410, relist, synthetic DELETED
        server.compact()
        out.clear()
        cancel = kc.subscribe(
            POD_GVK, lambda ev: out.append((ev.type,
                                            ev.obj["metadata"]["name"])),
            from_rv=rv, seed_known=[("default", "p0"), ("default", "gone")])
        assert wait_for(lambda: (DELETED, "gone") in out)
        assert server.requests[("list", "Pod")] == lists0 + 1
        assert {n for t, n in out if t == MODIFIED} == {"p0"}
        assert {n for t, n in out if t == ADDED} == {"p1", "p2", "missed"}
        cancel()
    finally:
        kc.close()


class _Queue:
    """The ClusterSnapshot surface a WatchIngester feeds."""
    warm_loaded = False

    def __init__(self):
        self.events = []

    def enqueue(self, etype, obj):
        self.events.append((etype, obj["metadata"]["name"]))

    def keys_for_gvk(self, gvk):
        return []


def test_resume_marks_stay_inside_the_watch_window(server):
    """A spill records ``WatchIngester.resume_rvs()``: per GVK the version
    of the watch's list, then of each bookmark, so a restart resumes
    without a LIST even after the server's watch cache has rolled past
    the objects' own versions (the JAX ingester records the last event
    object's version, which 410s here)."""
    from gatekeeper_tpu_torch.snapshot.ingest import WatchIngester

    server.event_log_cap = 16
    for i in reversed(range(40)):  # the last in key order is the oldest
        server.put_object(pod(f"p{i:02d}"))
    kc = KubeCluster(KubeConfig(server=server.url), watch_backoff_s=0.05)
    q = _Queue()
    ing = WatchIngester(q, kc, [POD_GVK]).start()
    try:
        assert wait_for(lambda: len(q.events) == 40)
        assert wait_for(lambda: ing.resume_rvs()[POD_GVK] == str(server._rv))
        assert int(ing.rvs[POD_GVK]) < server._compacted_rv
        server.put_object(pod("late"))
        assert wait_for(lambda: ing.resume_rvs()[POD_GVK] == str(server._rv))
        marks = ing.resume_rvs()
    finally:
        ing.stop()
        kc.close()
    server.put_object(pod("after-the-spill"))
    lists0 = server.requests[("list", "Pod")]
    kc = KubeCluster(KubeConfig(server=server.url), watch_backoff_s=0.05)
    q2 = _Queue()
    ing = WatchIngester(q2, kc, [POD_GVK], from_rvs=marks).start()
    try:
        assert wait_for(lambda: ("ADDED", "after-the-spill") in q2.events)
        assert q2.events == [("ADDED", "after-the-spill")]
        assert server.requests[("list", "Pod")] == lists0
    finally:
        ing.stop()
        kc.close()


def test_close_does_not_wait_for_the_streams_next_line(server):
    """Cancelling or closing live watches returns at once, though every
    stream is blocked in a read until the server's next line (here a
    bookmark 30 s away)."""
    server.bookmark_interval_s = 30.0
    kc = KubeCluster(KubeConfig(server=server.url), watch_backoff_s=0.05)
    gvks = [POD_GVK, ING_GVK, ("", "v1", "Namespace"), ("", "v1", "Service")]
    try:
        cancels = [kc.subscribe(g, lambda ev: None) for g in gvks]
        assert wait_for(lambda: sum(n for (v, _k), n in
                                    server.requests.items()
                                    if v == "watch") == len(gvks))
        time.sleep(0.3)  # every stream now blocks in its read
        t0 = time.time()
        cancels[0]()
        kc.close()
        assert time.time() - t0 < 2.0
    finally:
        kc.close()


def test_kube_fault_sites_and_request_span(server):
    """An injected 503 at ``kube.request`` is retried; an injected 410 at
    ``kube.watch`` takes the relist path; every request runs in a
    ``kube.request`` span."""
    from gatekeeper_tpu_torch.observability import tracing
    from gatekeeper_tpu_torch.resilience import faults

    server.put_object(pod("a"))
    kc = KubeCluster(KubeConfig(server=server.url), watch_backoff_s=0.05)
    tracer = tracing.Tracer(seed=0)
    plan = faults.FaultPlan([
        {"site": "kube.request", "mode": "error", "status": 503,
         "times": 1},
        {"site": "kube.watch", "mode": "error", "status": 410, "times": 1}],
        seed=0)
    try:
        with tracing.activate(tracer), faults.inject(plan):
            assert [o["metadata"]["name"]
                    for o in kc.list(POD_GVK)] == ["a"]
            lists0 = server.requests[("list", "Pod")]
            out: list = []
            cancel = kc.subscribe(POD_GVK, lambda ev: out.append(ev.type))
            # the first stream cycle is failed with 410: relisted once
            assert wait_for(lambda: server.requests[("list", "Pod")]
                            >= lists0 + 2)
            cancel()
        names = {s["name"] for t in tracer.traces() for s in t["spans"]}
        assert "kube.request" in names
        assert plan.fired("kube.request") == 1
        assert plan.fired("kube.watch") == 1
    finally:
        kc.close()


def test_routing_cluster_over_live_target(server, cluster):
    """--management-manifests x --kubeconfig: status and Secrets stay on
    the management side while discovery and listing span the apiserver."""
    from gatekeeper_tpu_torch.sync.routing import RoutingCluster
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    mgmt = FakeCluster()
    routed = RoutingCluster(mgmt, cluster)
    server.put_object(pod("t1"))
    assert POD_GVK in routed.server_preferred_gvks()
    assert [o["metadata"]["name"] for o in routed.list_iter(POD_GVK)] == \
        ["t1"]
    routed.apply({"apiVersion": f"{STATUS_GROUP}/v1beta1",
                  "kind": "ConstraintTemplatePodStatus",
                  "metadata": {"name": "pod-x",
                               "namespace": "gatekeeper-system"},
                  "status": {"id": "pod-x"}})
    assert mgmt.get((STATUS_GROUP, "v1beta1", "ConstraintTemplatePodStatus"),
                    "gatekeeper-system", "pod-x") is not None
    assert "ConstraintTemplatePodStatus" not in \
        [k for (k, _ns, _n) in server._objects]


# --- the controller plane over an apiserver, both packages --------------

def _library_docs() -> list:
    docs = []
    for name in TEMPLATES:
        docs += load_yaml_file(os.path.join(LIB, name, "template.yaml"))
        docs += load_yaml_file(os.path.join(LIB, name, "samples",
                                            "constraint.yaml"))
    return docs


def _seed(srv, objects) -> None:
    """The library subset, the resources of its constraint kinds and of
    the per-pod status kinds (an installed Gatekeeper's CRDs; the mock
    does not derive resources from CRDs) and ``objects``."""
    from gatekeeper_tpu_torch.controller.manager import STATUS_KIND_FOR

    for kind in sorted(set(STATUS_KIND_FOR.values())):
        srv.add_resource(kind, STATUS_GROUP, "v1beta1",
                         kind.lower() + "es", True)
    for doc in _library_docs():
        if doc["kind"] != "ConstraintTemplate":
            srv.add_resource(doc["kind"], "constraints.gatekeeper.sh",
                             "v1beta1", doc["kind"].lower(), False)
    for doc in _library_docs() + objects:
        srv.put_object(copy.deepcopy(doc))


def _jax_plane(url):
    from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu.client.client import Client
    from gatekeeper_tpu.controller.manager import Manager
    from gatekeeper_tpu.drivers.tpu_driver import TpuDriver
    from gatekeeper_tpu.parallel.sharded import ShardedEvaluator, make_mesh
    from gatekeeper_tpu.target.target import K8sValidationTarget

    driver = TpuDriver()
    client = Client(target=K8sValidationTarget(), drivers=[driver],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    kc = jkube.KubeCluster(jkube.KubeConfig(server=url),
                           watch_backoff_s=0.05)
    mgr = Manager(client, kc).start()

    def lister():  # the JAX CLI's discovery-driven lister
        for gvk in kc.server_preferred_gvks():
            yield from kc.list_iter(gvk)

    def audit():
        ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20)
        return AuditManager(client, lister, AuditConfig(
            chunk_size=256, pipeline="off"), evaluator=ev).audit(), ev
    return client, driver, kc, mgr, audit


def _port_plane(url):
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.controller.manager import Manager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver = cli.new_client(device="cpu")
    kc = KubeCluster(KubeConfig(server=url), watch_backoff_s=0.05)
    mgr = Manager(client, kc).start()

    def audit():
        ev = SweepEvaluator(driver, device="cpu", violations_limit=20)
        return AuditManager(client, cli.kube_lister(kc), AuditConfig(
            chunk_size=256), evaluator=ev).audit(), ev
    return client, driver, kc, mgr, audit


def _status_objects(srv) -> list:
    with srv._lock:
        objs = [copy.deepcopy(o) for (k, _ns, _n), o in
                sorted(srv._objects.items())
                if o.get("apiVersion", "").startswith(STATUS_GROUP)]
    for o in objs:
        o["metadata"].pop("resourceVersion", None)
    return objs


def _folded(srv) -> dict:
    """Template name -> its ``status`` as the status controller folded
    it onto the ConstraintTemplate."""
    with srv._lock:
        return {n: copy.deepcopy(o.get("status"))
                for (k, _ns, n), o in srv._objects.items()
                if k == "ConstraintTemplate"}


def test_manager_over_apiservers_matches_jax():
    objects = make_cluster_objects(240, seed=7)
    srvs = {"jax": MockApiServer().start(), "port": MockApiServer().start()}
    planes = {}
    try:
        for name, srv in srvs.items():
            _seed(srv, objects)
        for name, make in (("jax", _jax_plane), ("port", _port_plane)):
            planes[name] = make(srvs[name].url)
        for name, (_c, _d, _kc, mgr, _a) in planes.items():
            mgr.tracker.all_populated()
            assert wait_for(mgr.tracker.satisfied), \
                (name, mgr.tracker.stats())
            assert wait_for(lambda srv=srvs[name]: all(
                (st or {}).get("byPod") for st in _folded(srv).values()))
        got = {}
        for name, (client, driver, _kc, mgr, audit) in planes.items():
            run, ev = audit()
            kept = {k: [(v.kind, v.namespace, v.name, v.message)
                        for v in vs] for k, vs in run.kept.items()}
            got[name] = {
                "templates": sorted(t.kind for t in client.templates()),
                "constraints": sorted((c.kind, c.name)
                                      for c in client.constraints()),
                "lowered": sorted(driver.lowered_kinds()),
                "status": _status_objects(srvs[name]),
                "folded": _folded(srvs[name]),
                "readiness": mgr.tracker.stats(),
                "audit": (run.total_objects, dict(run.total_violations),
                          kept, run.incomplete)}
            if name == "port":
                assert ev.perf.get("flatten_chunks/raw", 0) > 0
        assert got["port"] == got["jax"]
        st = got["port"]
        assert len(st["templates"]) == len(TEMPLATES) == len(st["lowered"])
        assert sum(o["kind"] == "ConstraintTemplatePodStatus"
                   for o in st["status"]) == len(TEMPLATES)
        assert st["readiness"]["templates"]["expected"] == len(TEMPLATES)
        assert st["readiness"]["constraints"]["expected"] == len(TEMPLATES)
        assert sum(st["audit"][1].values()) > 0
    finally:
        for _c, _d, kc, _m, _a in planes.values():
            kc.close()
        for srv in srvs.values():
            srv.stop()


# --- the served CLI over the mock apiserver -----------------------------

def _kubeconfig(path, url) -> str:
    path.write_text(f"""apiVersion: v1
kind: Config
current-context: mock
contexts:
- name: mock
  context: {{cluster: mock, user: mock}}
clusters:
- name: mock
  cluster: {{server: "{url}"}}
users:
- name: mock
  user: {{}}
""")
    return str(path)


def _post(port, body) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/admit", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["response"]


def _ns_review(uid, name, labels=None):
    ns = {"apiVersion": "v1", "kind": "Namespace",
          "metadata": {"name": name, **({"labels": labels}
                                        if labels else {})}}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Namespace"},
                        "name": name, "object": ns}}


def test_cli_serves_over_kubeconfig(server, tmp_path):
    """``--kubeconfig`` boots through the Manager over the apiserver:
    ``/healthz`` carries the readiness stats, a review is denied by a
    constraint that arrived by watch, a constraint written after boot
    changes a later answer, the template's status object, the audit's and
    the admissions' Events reach the apiserver, and ``--export-dir``
    holds the audit's violations."""
    _seed(server, make_cluster_objects(120, seed=3))
    export = tmp_path / "export"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--kubeconfig",
         _kubeconfig(tmp_path / "kubeconfig", server.url), "--port", "0",
         "--device", "cpu", "--audit-source", "snapshot",
         "--audit-interval", "0.5", "--emit-audit-events",
         "--emit-admission-events", "--export-dir", str(export)],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    err_lines: list = []
    try:
        port = None
        for line in proc.stderr:
            err_lines.append(line)
            m = re.search(r"webhook serving on :(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "".join(err_lines)
        threading.Thread(target=lambda: err_lines.extend(proc.stderr),
                         daemon=True).start()
        health = {}

        def ready():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                    health.update(json.loads(r.read()))
                    return True
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert "readiness" in json.loads(e.read())
                return False
        assert wait_for(ready, 60), "".join(err_lines)
        assert health["ready"] is True
        assert health["readiness"]["templates"]["expected"] == len(TEMPLATES)
        resp = _post(port, _ns_review("u-1", "no-owner"))
        assert resp["allowed"] is False
        assert "[all-must-have-owner]" in resp["status"]["message"]
        # a constraint written to the apiserver after boot
        kc = KubeCluster(KubeConfig(server=server.url))
        try:
            kc.apply({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                      "kind": "K8sRequiredLabels",
                      "metadata": {"name": "all-must-have-team"},
                      "spec": {"match": {"kinds": [{
                          "apiGroups": [""], "kinds": ["Namespace"]}]},
                          "parameters": {"labels": [{"key": "team"}]}}})
        finally:
            kc.close()
        assert wait_for(lambda: "[all-must-have-team]" in (_post(
            port, _ns_review("u-2", "owned", {"owner": "me.agilebank.demo"}))
            .get("status") or {}).get("message", ""), 60)
        kinds = {k for (k, _ns, _n) in server._objects}
        assert "ConstraintTemplatePodStatus" in kinds
        assert wait_for(lambda: {"gatekeeper-audit", "gatekeeper-webhook"}
                        <= {o.get("source", {}).get("component")
                            for (k, _ns, _n), o in list(
                                server._objects.items())
                            if k == "Event"}, 60)
        assert wait_for(lambda: any(
            '"violation"' in p.read_text() or "violation" in p.read_text()
            for p in export.glob("**/*") if p.is_file()), 60)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        assert proc.returncode == 0, "".join(err_lines)
        text = "".join(err_lines)
        assert f"informer plane: apiserver {server.url}" in text
        assert "drain complete" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
