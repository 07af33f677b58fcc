"""The port's mutation (gatekeeper_tpu_torch/mutation/, mutlane/ and the
``/v1/mutate`` route of webhook/server.py, on the CPU) against the JAX
package's: the batched ``MutationLane`` over a mixed registry (6 mutators
the prefilter lowers, 2 host-only: the registry of the JAX package's own
mutation bench) and a seeded corpus with objects whose walks error, the
prefilter's would-change/would-error grids (both routes: the host numpy
fast path and the compiled program), ``MutationSystem.mutate_batch``,
``/v1/mutate`` through the port's ``WebhookServer`` (batched lane with its
microbatcher, and the per-object handler) against the JAX handlers, the
structural validation of Mutators and ExpansionTemplates at ``/v1/admit``,
``--operation`` gating of the served CLI, and ``--audit-expand --once``
against the JAX CLI."""

import copy
import http.client
import json
import os
import random
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.mutation.device import \
    MutationPrefilter as JPrefilter  # noqa: E402
from gatekeeper_tpu.mutation.system import \
    MutationSystem as JSystem  # noqa: E402
from gatekeeper_tpu.mutlane import MutationLane as JLane  # noqa: E402
from gatekeeper_tpu.sync.process import \
    ProcessExcluder as JExcluder  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.webhook.mutation import \
    MutationHandler as JHandler  # noqa: E402
from gatekeeper_tpu.webhook.server import \
    admission_response as jresponse  # noqa: E402
from gatekeeper_tpu_torch.mutation.device import \
    MutationPrefilter as TPrefilter  # noqa: E402
from gatekeeper_tpu_torch.mutation.system import \
    MutationSystem as TSystem  # noqa: E402
from gatekeeper_tpu_torch.mutlane import (  # noqa: E402
    BatchedMutationHandler, MutationBatcher, MutationLane)
from gatekeeper_tpu_torch.sync.process import \
    ProcessExcluder as TExcluder  # noqa: E402
from gatekeeper_tpu_torch.webhook.mutation import \
    MutationHandler as THandler  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


# --- fixtures: the mutation bench's registry and corpus ---------------------

def assign(name, location, value, extra=None, kinds=("Pod",)):
    params = {"assign": {"value": value}}
    params.update(extra or {})
    return {
        "apiVersion": "mutations.gatekeeper.sh/v1",
        "kind": "Assign", "metadata": {"name": name},
        "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                              "kinds": list(kinds)}],
                 "location": location, "parameters": params},
    }


def assign_meta(name, location, value):
    return {
        "apiVersion": "mutations.gatekeeper.sh/v1beta1",
        "kind": "AssignMetadata", "metadata": {"name": name},
        "spec": {"location": location,
                 "parameters": {"assign": {"value": value}}},
    }


def mixed_registry():
    """6 lowered + 2 host-only mutators: the batched fragment AND the
    fallback path both live in every burst."""
    return [
        assign("pull-policy",
               "spec.containers[name: *].imagePullPolicy", "Always"),
        assign("host-network", "spec.hostNetwork", False),
        assign("run-as-nonroot",
               "spec.securityContext.runAsNonRoot", True),
        assign("priority", "spec.priority", 100),
        assign_meta("owner-label", "metadata.labels.owner",
                    "platform-team"),
        assign_meta("audit-ann", "metadata.annotations.audited", "true"),
        {
            "apiVersion": "mutations.gatekeeper.sh/v1",
            "kind": "ModifySet", "metadata": {"name": "topo-keys"},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Service"]}],
                     "location": "spec.topologyKeys",
                     "parameters": {"operation": "merge",
                                    "values": {"fromList": ["zone"]}}},
        },
        assign("dns-policy-cond", "spec.dnsPolicy", "ClusterFirst",
               extra={"assignIf": {"in": ["Default"]}}),
    ]


def systems(registry=None):
    """(JAX MutationSystem, port MutationSystem) over the same mutators."""
    js, ts = JSystem(), TSystem()
    for m in registry if registry is not None else mixed_registry():
        js.upsert_unstructured(copy.deepcopy(m))
        ts.upsert_unstructured(copy.deepcopy(m))
    return js, ts


def weird_obj(rng, i):
    """Objects whose walks error: containers that are not lists,
    securityContext scalars, labels that are not a map."""
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": f"weird-{i}"}}
    spec = {}
    r = rng.random()
    if r < 0.4:
        spec["containers"] = rng.choice(
            ["notalist", {"a": {}}, 5,
             [{"name": "app", "imagePullPolicy": 7}]])
    elif r < 0.7:
        spec["securityContext"] = rng.choice(["bogus", 3, []])
    else:
        spec["priority"] = rng.choice(["100", True])
        obj["metadata"]["labels"] = "notadict"
    obj["spec"] = spec
    return obj


def corpus(n=200, seed=29, weird=24):
    rng = random.Random(seed)
    objects = make_cluster_objects(n, seed=seed)
    objects += [weird_obj(rng, i) for i in range(weird)]
    rng.shuffle(objects)
    return objects


def outcome(o):
    return (o.changed, o.patch, o.error, o.obj, o.lane, o.iterations)


# --- the batched lane -------------------------------------------------------

def test_lane_outcomes_match_jax():
    """Every outcome (changed, patch, error text, converged object, lane,
    iterations) equals the JAX lane's; the device, multi and host lanes
    all run."""
    js, ts = systems()
    objs = corpus()
    want = JLane(js).mutate_objects(copy.deepcopy(objs), want_objects=True)
    lane = MutationLane(ts, device="cpu")
    got = lane.mutate_objects(copy.deepcopy(objs), want_objects=True)
    assert [outcome(o) for o in got] == [outcome(o) for o in want]
    assert {"device", "multi", "host"} <= {o.lane for o in got}
    assert sum(o.error is not None for o in got) > 0
    # the lane's burst classification is the host numpy fast path
    pre = lane.compiled().prefilter
    assert pre.perf["np_eval_rows"] > 0 and pre.perf["program_rows"] == 0


@pytest.mark.parametrize("source", ["", "Original", "Generated"])
def test_lane_differential_mode_holds(source):
    """``differential=True`` asserts every burst against the per-object
    reference path; it must raise nothing on the corpus."""
    _js, ts = systems()
    lane = MutationLane(ts, differential=True, device="cpu")
    objs = corpus(120, seed=31, weird=16)
    for i in range(0, len(objs), 64):
        lane.mutate_objects(copy.deepcopy(objs[i:i + 64]), source=source)


def test_lane_recompiles_on_registry_revision():
    js, ts = systems()
    lane = MutationLane(ts, device="cpu")
    first = lane.compiled()
    assert lane.compiled() is first
    ts.upsert_unstructured(assign("priority", "spec.priority", 7))
    js.upsert_unstructured(assign("priority", "spec.priority", 7))
    assert lane.compiled() is not first
    objs = corpus(60, seed=3, weird=4)
    want = JLane(js).mutate_objects(copy.deepcopy(objs))
    got = lane.mutate_objects(copy.deepcopy(objs))
    assert [outcome(o) for o in got] == [outcome(o) for o in want]


def test_lane_raises_without_a_card_unless_cpu_is_asked():
    import torch

    _js, ts = systems()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            MutationLane(ts)
        with pytest.raises(RuntimeError, match="is_available"):
            TPrefilter()
        with pytest.raises(RuntimeError, match="is_available"):
            ts.mutate_batch(corpus(8, seed=1, weird=0))


# --- the prefilter grids ----------------------------------------------------

def test_prefilter_grids_match_jax_on_both_routes():
    """would_change / would_error ([M, N], through the compiled program
    on the device) equal the JAX package's bit for bit, and the host
    numpy route of the lane (relevance + error rows) equals them too."""
    js, ts = systems()
    objs = corpus(160, seed=11, weird=24)
    jpre, tpre = JPrefilter(), TPrefilter(device="cpu")
    jact, tact = js.active(), ts.active()
    lowered = [tpre.add_mutator(m) for m in tact]
    assert [jpre.add_mutator(m) for m in jact] == lowered
    assert sum(lowered) == 6
    assert {str(k): v for k, v in tpre.unsupported().items()} == \
        {str(k): v for k, v in jpre.unsupported().items()}
    wc = tpre.would_change(tact, objs)
    we = tpre.would_error(tact, objs)
    assert tpre.perf["program_rows"] == 2 * 6 * len(objs)
    assert tpre.perf["np_eval_rows"] == 0
    assert np.array_equal(wc, jpre.would_change(jact, objs))
    assert np.array_equal(we, jpre.would_error(jact, objs))
    assert wc.any() and we.any() and not (wc & we).any()
    low = [m for m, ok in zip(tact, lowered) if ok]
    rows = [i for i, ok in enumerate(lowered) if ok]
    rel, batch = tpre.relevance_and_batch(low, objs)
    assert np.array_equal(rel, (wc | we)[rows])
    for mi, m in enumerate(low):
        assert np.array_equal(tpre.error_row(m, batch, len(objs)),
                              we[rows[mi]])
    assert tpre.perf["np_eval_rows"] == 2 * len(low) * len(objs)


def test_prefilter_keeps_float32_inexact_values_on_the_host():
    """A numeric Assign whose value is not float32-exact stays host-only
    (the grid compares float32 columns)."""
    _js, ts = systems([assign("prio", "spec.priority", 16777217)])
    pre = TPrefilter(device="cpu")
    assert not pre.add_mutator(ts.active()[0])
    assert "float32" in pre.unsupported()[ts.active()[0].id]


def test_mutate_batch_matches_per_object_mutate_and_jax():
    """``mutate_batch`` (grid prefilter on the device for an all-lowered
    registry, every object walked otherwise) equals per-object ``mutate``
    and the JAX package's ``mutate_batch``."""
    objs = corpus(100, seed=17, weird=0)
    for reg in (mixed_registry(), mixed_registry()[:6]):
        js, ts = systems(reg)
        batch, ref, jbatch = (copy.deepcopy(objs) for _ in range(3))
        changed = ts.mutate_batch(batch, device="cpu")
        want = [ts.mutate(o) for o in ref]
        assert changed == want and batch == ref
        assert js.mutate_batch(jbatch) == changed and jbatch == batch
    pre = ts.__dict__["_prefilter"]
    assert pre.perf["program_rows"] > 0 and pre.device.type == "cpu"


# --- /v1/mutate ---------------------------------------------------------------

def admission_body(obj, uid, operation="CREATE"):
    group, _, version = obj.get("apiVersion", "").rpartition("/")
    meta = obj.get("metadata") or {}
    req = {"uid": uid, "operation": operation,
           "kind": {"group": group, "version": version,
                    "kind": obj.get("kind", "")},
           "name": meta.get("name", ""),
           "namespace": meta.get("namespace", ""),
           "userInfo": {"username": "alice"}, "object": obj}
    if operation == "DELETE":
        req.update(object=None, oldObject=obj)
    elif operation == "UPDATE":
        req["oldObject"] = obj
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}


def mutate_traffic(n=160, seed=5):
    """(bodies, namespaces): CREATEs, every 7th an UPDATE, every 11th a
    DELETE; Namespaces of the corpus for the handlers' lookups."""
    objs = corpus(n, seed=seed, weird=20)
    bodies = []
    for i, obj in enumerate(objs):
        op = "DELETE" if i % 11 == 10 else "UPDATE" if i % 7 == 6 \
            else "CREATE"
        bodies.append(admission_body(obj, f"m-{i}", op))
    namespaces = {o["metadata"]["name"]: o for o in objs
                  if o.get("kind") == "Namespace"}
    return bodies, namespaces


EXCLUDED = [{"excludedNamespaces": ["ns-1*"],
             "processes": ["mutation-webhook"]}]


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("lane", ["batched", "host"])
def test_v1_mutate_matches_jax_handler(lane):
    """Every /v1/mutate answer of the port's server (patch bytes, message,
    uid) equals the JAX per-object handler's AdmissionReview, DELETE
    passthrough and excluded namespaces included."""
    js, ts = systems()
    bodies, namespaces = mutate_traffic()
    ref = JHandler(js, namespace_lookup=namespaces.get,
                   process_excluder=JExcluder.from_config_match(EXCLUDED))
    excluder = TExcluder.from_config_match(EXCLUDED)
    batcher = None
    if lane == "batched":
        batcher = MutationBatcher(MutationLane(ts, device="cpu")).start()
        handler = BatchedMutationHandler(
            ts, lane=batcher.lane, namespace_lookup=namespaces.get,
            process_excluder=excluder, batcher=batcher)
    else:
        handler = THandler(ts, namespace_lookup=namespaces.get,
                           process_excluder=excluder)
    server = WebhookServer(mutation_handler=handler, port=0,
                           mutation_batcher=batcher).start()
    try:
        kinds = {"patch": 0, "message": 0, "plain": 0}
        for body in bodies:
            got = post(server.port, "/v1/mutate", copy.deepcopy(body))
            m = ref.handle(copy.deepcopy(body))
            want = jresponse(m.uid, m.allowed, m.message, m.code,
                             warnings=m.warnings, patch=m.patch)
            assert got == want, body["request"]["uid"]
            r = got["response"]
            kinds["patch" if "patch" in r else
                  "message" if "status" in r else "plain"] += 1
        assert min(kinds.values()) > 0, kinds
        # a DELETE and an excluded namespace pass through unmutated
        deletes = [b for b in bodies if b["request"]["operation"]
                   == "DELETE"]
        assert "patch" not in post(server.port, "/v1/mutate",
                                   deletes[0])["response"]
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "x", "namespace": "ns-12"},
               "spec": {"containers": [{"name": "c", "image": "i"}]}}
        assert "patch" not in post(server.port, "/v1/mutate",
                                   admission_body(pod, "x"))["response"]
        pod["metadata"]["namespace"] = "ns-2"
        assert "patch" in post(server.port, "/v1/mutate",
                               admission_body(pod, "y"))["response"]
    finally:
        assert server.stop()
    if batcher is not None:
        assert batcher.queue_depth() == 0


MALFORMED = [
    # Assign on metadata is refused by the mutator parser
    assign("bad-meta", "metadata.labels.x", "v"),
    # a location that does not parse
    assign("bad-path", "spec.containers[name: foo.image", "v"),
    {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
     "kind": "AssignMetadata", "metadata": {"name": "bad-value"},
     "spec": {"location": "metadata.labels.team",
              "parameters": {"assign": {"value": 5}}}},
    {"apiVersion": "expansion.gatekeeper.sh/v1alpha1",
     "kind": "ExpansionTemplate", "metadata": {"name": "no-source"},
     "spec": {"applyTo": [{"groups": ["apps"], "versions": ["v1"],
                           "kinds": ["Deployment"]}],
              "generatedGVK": {"group": "", "version": "v1",
                               "kind": "Pod"}}},
    {"apiVersion": "expansion.gatekeeper.sh/v1alpha1",
     "kind": "ExpansionTemplate", "metadata": {"name": "no-gvk"},
     "spec": {"templateSource": "spec.template"}},
]


@pytest.mark.parametrize("obj", MALFORMED,
                         ids=[m["metadata"]["name"] for m in MALFORMED])
def test_malformed_mutator_or_expansion_template_denied_422(obj):
    """A malformed Mutator or ExpansionTemplate at /v1/admit gets 422 with
    the JAX package's message; a well-formed one is admitted."""
    from gatekeeper_tpu.client.client import Client as JClient
    from gatekeeper_tpu.drivers.rego_driver import RegoDriver as JRego
    from gatekeeper_tpu.target.target import K8sValidationTarget as JTarget
    from gatekeeper_tpu.webhook.policy import \
        ValidationHandler as JValidation
    from gatekeeper_tpu_torch.client.client import Client as TClient
    from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver as TRego
    from gatekeeper_tpu_torch.target.target import \
        K8sValidationTarget as TTarget
    from gatekeeper_tpu_torch.webhook.policy import \
        ValidationHandler as TValidation

    jh = JValidation(JClient(target=JTarget(), drivers=[JRego()]))
    th = TValidation(TClient(target=TTarget(), drivers=[TRego()]))
    body = admission_body(obj, "v-1")
    want, got = jh.handle(copy.deepcopy(body)), th.handle(copy.deepcopy(body))
    assert (got.allowed, got.code, got.message, got.warnings) == \
        (want.allowed, want.code, want.message, want.warnings)
    assert got.code == 422 and not got.allowed and got.message
    good = mixed_registry()[0]
    ok = th.handle(admission_body(good, "v-2"))
    assert ok.allowed and ok.code == 200 and not ok.warnings


# --- the CLI ----------------------------------------------------------------

EXPAND_DEPLOYMENTS = {
    "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
    "kind": "ExpansionTemplate",
    "metadata": {"name": "expand-deployments"},
    "spec": {"applyTo": [{"groups": ["apps"], "versions": ["v1"],
                          "kinds": ["Deployment"]}],
             "templateSource": "spec.template",
             "generatedGVK": {"group": "", "version": "v1",
                              "kind": "Pod"}},
}


def cli_manifests(tmp_path, n_objects=150):
    """A manifest directory: three library templates with their sample
    constraints, the mixed registry, ``expand-deployments`` and seeded
    cluster objects (Deployments with pod templates among them)."""
    import yaml

    lib = os.path.join(ROOT, "library", "general")
    docs = []
    for name in ("allowedrepos", "containerlimits", "disallowedtags"):
        for f in ("template.yaml", "samples/constraint.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                docs.append(fh.read())
    extra = mixed_registry() + [EXPAND_DEPLOYMENTS] + \
        make_cluster_objects(n_objects, seed=13)
    docs.append(yaml.safe_dump_all(extra))
    for i, doc in enumerate(docs):
        (tmp_path / f"{i:02d}.yaml").write_text(doc)
    return tmp_path


def test_cli_audit_expand_once_matches_jax_cli(tmp_path):
    """``--once --audit-expand`` prints the JAX CLI's kept-violation lines,
    ``[Implied by expand-deployments]`` ones included, over the same
    objects: both audit one ConstraintTemplatePodStatus per template."""
    cli_manifests(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for pkg, extra in (("gatekeeper_tpu", []),
                       ("gatekeeper_tpu_torch", ["--device", "cpu"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(tmp_path),
             "--once", "--audit-expand", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[pkg] = (p.stdout, int(m.group(1)), int(m.group(2)))
    jax_out, jax_n, jax_v = outs["gatekeeper_tpu"]
    out, n, v = outs["gatekeeper_tpu_torch"]
    assert out == jax_out and v == jax_v
    assert "[Implied by expand-deployments]" in out
    assert jax_n == n


def test_cli_operation_gating(tmp_path):
    """``--operation mutation-webhook`` serves /v1/mutate only (/v1/admit
    answers allowed with no review) and builds no audit; ``webhook``
    serves /v1/admit only; the default serves both webhooks, with the
    expansion system behind /v1/admit, and the snapshot audit loop."""
    cli_manifests(tmp_path, n_objects=20)
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "ns-1"},
           "spec": {"containers": [{"name": "c", "image": "bad/x:latest"}]}}
    dep = {"apiVersion": "apps/v1", "kind": "Deployment",
           "metadata": {"name": "d", "namespace": "ns-1"},
           "spec": {"template": {"spec": {"containers": [
               {"name": "c", "image": "bad/x:latest"}]}}}}
    for ops, mutates, reviews in ((["mutation-webhook"], True, False),
                                  (["webhook"], False, True),
                                  ([], True, True)):
        args = [a for op in ops for a in ("--operation", op)]
        proc = subprocess.Popen(
            [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
             str(tmp_path), "--port", "0", "--device", "cpu",
             "--audit-source", "snapshot", *args],
            cwd=ROOT, stderr=subprocess.PIPE, text=True)
        try:
            port = None
            head = []
            for line in proc.stderr:
                head.append(line)
                m = re.search(r"webhook serving on :(\d+)", line)
                if m:
                    port = int(m.group(1))
                    break
            assert port, "the server never printed its port"
            # the audit (here the resident snapshot) is built only for
            # the audit operation
            assert any("resident snapshot active" in ln
                       for ln in head) is (not ops)
            r = post(port, "/v1/mutate", admission_body(pod, "m"))
            assert ("patch" in r["response"]) is mutates
            r = post(port, "/v1/admit", admission_body(dep, "a"))
            assert (not r["response"]["allowed"]) is reviews
            if reviews:
                assert "[Implied by expand-deployments]" in \
                    r["response"]["status"]["message"]
            proc.send_signal(signal.SIGTERM)
            _out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            assert "drain complete" in err
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
