"""The port's validating webhook (gatekeeper_tpu_torch/webhook/, on the CPU)
against the JAX package's: ``ValidationHandler`` with a ``Batcher`` on both
lanes (``small_batch=0``: every batch takes the grid lane through
``review_batch``/``query_batch``; ``small_batch=64``: every batch takes the
per-review interpreter lane) over the library's ``samples/example_*.yaml``
objects and UPDATE reviews as AdmissionReview bodies, the handler's fast
paths (service-account bypass, namespace exclusion, template/constraint
validation), the failure policy on a review error, and HTTP round trips
through ``WebhookServer`` on an ephemeral port."""

import copy
import glob
import http.client
import json
import os
import threading
import time

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.sync.process import \
    ProcessExcluder as JExcluder  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu.webhook.namespacelabel import \
    NamespaceLabelHandler as JLabel  # noqa: E402
from gatekeeper_tpu.webhook.server import \
    admission_response as jresponse  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.sync.process import \
    ProcessExcluder as TExcluder  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402
from gatekeeper_tpu_torch.webhook.namespacelabel import \
    NamespaceLabelHandler as TLabel  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library")
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")


def admission_body(obj: dict, uid: str, operation: str = "CREATE",
                   username: str = "alice") -> dict:
    """An AdmissionReview for ``obj`` as the apiserver would send it."""
    api = obj.get("apiVersion", "")
    group, _, version = api.rpartition("/")
    meta = obj.get("metadata") or {}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {
                "uid": uid, "operation": operation,
                "kind": {"group": group, "version": version,
                         "kind": obj.get("kind", "")},
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", ""),
                "userInfo": {"username": username},
                "object": obj}}


def _samples(pattern):
    docs = []
    for path in sorted(glob.glob(os.path.join(LIB, "*", "*", "samples",
                                              pattern))):
        docs.extend(d for d in load_yaml_file(path) if isinstance(d, dict))
    return docs


@pytest.fixture(scope="module")
def env():
    objects = _samples("example_*.yaml")
    assert len(objects) >= 100
    bodies = [admission_body(o, f"uid-{i}") for i, o in enumerate(objects)]
    bodies += _samples("update_*.yaml")
    jc = JClient(target=JTarget(), drivers=[TpuDriver()],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    td = TorchDriver(device="cpu")
    tc = TClient(target=TTarget(), drivers=[td],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert jload(jc, skip_kinds=CEL_KINDS) == tload(tc, skip_kinds=CEL_KINDS)
    for o in objects:
        if o["kind"] == "Ingress":
            jc.add_data(o)
            tc.add_data(o)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o["kind"] == "Namespace"}
    return jc, tc, td, bodies, namespaces


def _verdict(v) -> tuple:
    return v.allowed, v.code, v.message, sorted(v.warnings)


def _handle_all(handler, batcher, bodies) -> list:
    """Every body through ``handler`` from its own thread; the batcher
    starts once all of them are queued, so batches fill to max_batch."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = handler.handle(copy.deepcopy(bodies[i]))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while batcher.queue_depth() < len(bodies):
        assert time.monotonic() < deadline, "reviews never queued"
        time.sleep(0.01)
    batcher.start()
    try:
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        batcher.stop()
    return out


@pytest.mark.parametrize("small_batch,lane", [(0, "grid"), (64, "interp")])
def test_handler_with_batcher_matches_jax(env, small_batch, lane):
    jc, tc, _td, bodies, namespaces = env
    results = {}
    for name, pol, client in (("jax", jpolicy, jc), ("port", tpolicy, tc)):
        batcher = pol.Batcher(client, small_batch=small_batch)
        handler = pol.ValidationHandler(client,
                                        namespace_lookup=namespaces.get,
                                        batcher=batcher)
        results[name] = [_verdict(v)
                         for v in _handle_all(handler, batcher, bodies)]
        if name == "port":
            assert batcher.lane_counts == {lane: 2}
            assert batcher.batch_sizes == {64: 1, len(bodies) - 64: 1}
    assert results["port"] == results["jax"]
    denied = [v for v in results["port"] if not v[0]]
    assert len(denied) >= 40 and all(v[1] == 403 for v in denied)


def _pod(namespace="default", **spec):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p", "namespace": namespace},
            "spec": {"containers": [{"name": "c", "image": "nginx",
                                     **spec}]}}


def _gatekeeper_bodies():
    """(label, body) for the handler's fast paths."""
    template = load_yaml_file(os.path.join(
        LIB, "general", "requiredlabels", "template.yaml"))[0]
    bad_template = copy.deepcopy(template)
    bad_template["metadata"]["name"] = "notthekind"  # != lower(kind)
    constraint = load_yaml_file(os.path.join(
        LIB, "general", "requiredlabels", "samples", "constraint.yaml"))[0]
    bad_constraint = copy.deepcopy(constraint)
    bad_constraint["spec"]["match"]["labelSelector"] = {
        "matchExpressions": [{"key": "a", "operator": "Sometimes"}]}
    privileged = _pod(securityContext={"privileged": True})
    return [
        ("service-account bypass", admission_body(
            privileged, "sa", username="system:serviceaccount:"
            "gatekeeper-system:gatekeeper-admin")),
        ("excluded namespace", admission_body(
            _pod("kube-system", securityContext={"privileged": True}),
            "ex")),
        ("reviewed", admission_body(privileged, "rv")),
        ("template", admission_body(template, "t1")),
        ("malformed template", admission_body(bad_template, "t2")),
        ("constraint", admission_body(constraint, "c1")),
        ("malformed constraint", admission_body(bad_constraint, "c2")),
        ("template delete", admission_body(bad_template, "t3",
                                           operation="DELETE")),
    ]


def test_fast_paths_match_jax(env):
    jc, tc, _td, _bodies, namespaces = env
    match = [{"processes": ["webhook"], "excludedNamespaces": ["kube-*"]}]
    jh = jpolicy.ValidationHandler(
        jc, process_excluder=JExcluder.from_config_match(match),
        namespace_lookup=namespaces.get)
    th = tpolicy.ValidationHandler(
        tc, process_excluder=TExcluder.from_config_match(match),
        namespace_lookup=namespaces.get)
    got = {}
    for label, body in _gatekeeper_bodies():
        want = _verdict(jh.handle(copy.deepcopy(body)))
        got[label] = _verdict(th.handle(copy.deepcopy(body)))
        assert got[label] == want, label
    assert got["service-account bypass"] == (True, 200, "", [])
    assert got["excluded namespace"] == (True, 200, "", [])
    assert got["reviewed"][:2] == (False, 403)
    assert got["template"] == got["constraint"] == (True, 200, "", [])
    assert got["malformed template"][:2] == (False, 422)
    assert got["malformed constraint"][:2] == (False, 422)
    assert "Sometimes" in got["malformed constraint"][2]
    assert got["template delete"] == (True, 200, "", [])


def test_mutator_is_admitted_with_a_warning(env):
    """Mutators cannot be validated until the mutation slice is ported."""
    _jc, tc, _td, _bodies, _ns = env
    assign = {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
              "metadata": {"name": "a"}, "spec": {}}
    v = tpolicy.ValidationHandler(tc).handle(admission_body(assign, "m"))
    assert _verdict(v) == (True, 200, "", [
        "Assign not validated: mutation/expansion not ported"])


@pytest.mark.parametrize("policy", ["fail", "ignore"])
def test_failure_policy_on_a_raising_driver(env, monkeypatch, policy):
    """A driver that raises inside the grid lane: Fail denies with code
    500, Ignore admits with a warning, both with the JAX package's text."""
    jc, tc, td, _bodies, namespaces = env

    def boom(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(jc.drivers[0], "query_batch", boom)
    monkeypatch.setattr(td, "query_batch", boom)
    body = admission_body(_pod(securityContext={"privileged": True}), "f")
    got = {}
    for name, pol, client in (("jax", jpolicy, jc), ("port", tpolicy, tc)):
        batcher = pol.Batcher(client, small_batch=0)
        handler = pol.ValidationHandler(client, batcher=batcher,
                                        namespace_lookup=namespaces.get,
                                        failure_policy=policy)
        (v,) = _handle_all(handler, batcher, [body])
        got[name] = _verdict(v)
    assert got["port"] == got["jax"]
    if policy == "fail":
        assert got["port"] == (False, 500, "review failed: device lost", [])
    else:
        assert got["port"] == (True, 200, "",
                               ["review failed: device lost"])


@pytest.fixture
def server(env):
    _jc, tc, _td, _bodies, namespaces = env
    batcher = tpolicy.Batcher(tc).start()
    srv = WebhookServer(
        validation_handler=tpolicy.ValidationHandler(
            tc, namespace_lookup=namespaces.get, batcher=batcher),
        namespace_label_handler=TLabel(), port=0, batcher=batcher).start()
    assert srv.port > 0
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        yield conn
    finally:
        conn.close()
        assert srv.stop()


def _call(conn, method, path, body=None):
    data = None if body is None else json.dumps(body)
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_http_round_trip_matches_jax(env, server):
    """One keep-alive connection: /v1/admit twice (a deny and an allow),
    then /v1/admitlabel, /healthz and the unported paths."""
    jc, _tc, _td, _bodies, namespaces = env
    jh = jpolicy.ValidationHandler(jc, namespace_lookup=namespaces.get)
    allowed = []
    for uid, obj in (("deny", _pod(securityContext={"privileged": True})),
                     ("allow", namespaces["default"] if "default" in
                      namespaces else _pod())):
        body = admission_body(obj, uid)
        v = jh.handle(copy.deepcopy(body))
        want = jresponse(v.uid, v.allowed, v.message, v.code, v.warnings)
        assert _call(server, "POST", "/v1/admit", body) == (200, want)
        allowed.append(want["response"]["allowed"])
    assert allowed[0] is False
    ns = {"apiVersion": "v1", "kind": "Namespace",
          "metadata": {"name": "team",
                       "labels": {"admission.gatekeeper.sh/ignore": "x"}}}
    body = admission_body(ns, "label")
    r = JLabel().handle(copy.deepcopy(body))
    want = jresponse(r.uid, r.allowed, r.message, r.code)
    assert _call(server, "POST", "/v1/admitlabel", body) == (200, want)
    assert want["response"]["status"]["code"] == 403
    assert _call(server, "GET", "/healthz") == (200, {"ready": True})
    for method, path in (("GET", "/metrics"), ("POST", "/v1/mutate"),
                         ("GET", "/debug/traces")):
        assert _call(server, method, path, {} if method == "POST"
                     else None)[0] == 404


def test_tls_round_trip(tmp_path):
    """``certfile``/``keyfile`` serve HTTPS at the minimum TLS version;
    certificates from the JAX package's generator (the port's is not
    ported yet), verified against their CA."""
    import ssl

    from gatekeeper_tpu.webhook.certs import generate_certs

    paths = generate_certs(str(tmp_path))
    srv = WebhookServer(namespace_label_handler=TLabel(), port=0,
                        certfile=paths["cert"], keyfile=paths["key"],
                        tls_min_version="1.2").start()
    ctx = ssl.create_default_context(cafile=paths["ca"])
    conn = http.client.HTTPSConnection("127.0.0.1", srv.port, timeout=60,
                                       context=ctx)
    try:
        assert _call(conn, "GET", "/healthz") == (200, {"ready": True})
        assert conn.sock.version() in ("TLSv1.2", "TLSv1.3")
    finally:
        conn.close()
        assert srv.stop()
