"""``gator`` in the port (``gatekeeper_tpu_torch/gator/``) against the JAX
package's, on the CPU: the same inputs from the in-repo ``library/`` go
through both CLIs (in process) and their libraries, and the outputs must
be equal.

- ``gator test`` per library directory and over the whole library (every
  ``-o`` form, ``--deny-only``, the exit code), an AdmissionReview fixture
  whose Deployment expands to an implied Pod, and DELETE fixtures;
- ``gator verify``: all 46 library suites, case by case, ``_assert_case``
  and the CLI's printed report;
- ``gator sync``, ``expand`` (the host lane byte for byte; the batched and
  differential lanes in the port), ``generate-vap`` and ``policy`` (install
  trees file by file);
- ``gator decisions`` and ``triage``: offline over a rotated sink, and live
  against each package's own ``WebhookServer``;
- ``--device cuda`` without a card raises for every command that puts work
  on the device.

``gator bench`` is held in ``test_torch_gator_bench.py``, ``gator replay``
in ``test_torch_replay.py``."""

import contextlib
import copy
import glob
import hashlib
import io
import json
import os
import re
import tarfile
import time
import urllib.request

import pytest
import torch
import yaml

from gatekeeper_tpu.gator import cli as jcli
from gatekeeper_tpu.gator import decisions_cmd as jdecisions
from gatekeeper_tpu.gator import generate_vap_cmd as jvap
from gatekeeper_tpu.gator import policy_cmd as jpolicy
from gatekeeper_tpu.gator import reader as jreader
from gatekeeper_tpu.gator import sync_cmd as jsync
from gatekeeper_tpu.gator import triage_cmd as jtriage
from gatekeeper_tpu.gator import verify as jverify
from gatekeeper_tpu.gator.test import test as jtest
from gatekeeper_tpu_torch.gator import cli as tcli
from gatekeeper_tpu_torch.gator import decisions_cmd as tdecisions
from gatekeeper_tpu_torch.gator import generate_vap_cmd as tvap
from gatekeeper_tpu_torch.gator import policy_cmd as tpolicy
from gatekeeper_tpu_torch.gator import reader as treader
from gatekeeper_tpu_torch.gator import sync_cmd as tsync
from gatekeeper_tpu_torch.gator import triage_cmd as ttriage
from gatekeeper_tpu_torch.gator import verify as tverify
from gatekeeper_tpu_torch.gator.test import test as ttest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LIBRARY = os.path.join(ROOT, "library")
TEMPLATE_DIRS = sorted(
    os.path.relpath(os.path.dirname(p), ROOT) for p in
    glob.glob(os.path.join(LIBRARY, "*", "*", "template.yaml")))
CEL_DIRS = [d for d in TEMPLATE_DIRS
            if "K8sNativeValidation" in open(
                os.path.join(ROOT, d, "template.yaml")).read()]


def run(main, argv) -> tuple:
    """(exit code, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv, port_global=("--device", "cpu")) -> tuple:
    """The JAX CLI's and the port's (exit code, stdout) on ``argv``, run
    from the repo root; the port gets ``--device cpu`` first."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        j = run(jcli.main, list(argv))
        t = run(tcli.main, [*port_global, *argv])
    finally:
        os.chdir(cwd)
    return j[:2], t[:2]


def test_the_library_has_its_46_templates_and_suites():
    assert len(TEMPLATE_DIRS) == 46
    assert len(tverify.find_suites([LIBRARY])) == 46
    assert len(CEL_DIRS) >= 2


# --- gator test ---------------------------------------------------------------

@pytest.mark.parametrize("libdir", TEMPLATE_DIRS)
def test_gator_test_per_library_directory(libdir):
    j, t = both(["test", "-f", libdir, "-o", "json"])
    assert t == j
    assert json.loads(t[1] or "[]") or t[0] == 0


@pytest.fixture(scope="module")
def library_responses():
    """Both packages' ``gator test`` over the whole library, once."""
    jobjs = jreader.read_sources([LIBRARY])
    tobjs = treader.read_sources([LIBRARY])
    assert jobjs == tobjs
    return jtest(jobjs).results(), ttest(tobjs).results()


@pytest.mark.parametrize("output", ["", "json", "yaml"])
@pytest.mark.parametrize("deny_only", [False, True])
def test_gator_test_whole_library_formats(library_responses, output,
                                          deny_only):
    jres, tres = library_responses
    assert len(tres) == len(jres) > 100
    if deny_only:
        jres = [r for r in jres if jcli._enforceable_failure(r)]
        tres = [r for r in tres if tcli._enforceable_failure(r)]
        assert len(tres) == len(jres) > 0  # every sample constraint denies
    assert tcli._format_results(tres, output) == \
        jcli._format_results(jres, output)


def test_gator_test_whole_library_cli_exit_code():
    j, t = both(["test", "-f", "library", "--deny-only"])
    assert t == j and t[0] == 1 and t[1]


# the expand phase's ExpansionTemplate, the library's allowedrepos template
# and sample constraint (Pods only), and a Deployment whose pod template
# uses a repo outside the allowed one
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


def deployment(name="web", image="evil.io/web:1"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": 2, "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {"containers": [{"name": name, "image": image}]}}}}


def admission_review(obj, operation="CREATE"):
    group, _, version = obj["apiVersion"].rpartition("/")
    req = {"uid": f"fixture-{obj['metadata']['name']}",
           "operation": operation,
           "kind": {"group": group, "version": version, "kind": obj["kind"]},
           "name": obj["metadata"]["name"],
           "namespace": obj["metadata"].get("namespace", ""),
           "userInfo": {"username": "dev"}, "object": obj}
    if operation == "DELETE":
        req["oldObject"] = req.pop("object")
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}


def library_docs(*dirs) -> list:
    docs = []
    for d in dirs:
        docs += treader.read_sources(
            [os.path.join(LIBRARY, d, "template.yaml"),
             os.path.join(LIBRARY, d, "samples", "constraint.yaml")])
    return docs


def _results(responses) -> list:
    return json.loads(tcli._format_results(responses.results(), "json"))


@pytest.mark.parametrize("case", ["admission", "bare", "delete"])
def test_gator_test_admission_review_fixtures(case):
    base = library_docs("general/allowedrepos") + [EXPAND_DEPLOYMENTS]
    obj = deployment()
    fixture = {"admission": admission_review(obj), "bare": obj,
               "delete": admission_review(obj, "DELETE")}[case]
    j = _results(jtest(copy.deepcopy(base + [fixture]), include_cel=False))
    t = _results(ttest(copy.deepcopy(base + [fixture]), include_cel=False))
    assert t == j
    implied = [r["msg"] for r in t if "[Implied by expand-deployments]"
               in r["msg"]]
    # a deleted object never expands; the others imply a violating Pod
    assert bool(implied) == (case != "delete"), t


def test_gator_test_delete_reviews_the_old_object():
    """A DELETE AdmissionReview of a Namespace without the required label:
    reviewed against its ``oldObject`` (the request object is copied from
    it), in both packages, and the fixture is not mutated."""
    ns = {"apiVersion": "v1", "kind": "Namespace",
          "metadata": {"name": "del-ns"}}
    fixture = admission_review(ns, "DELETE")
    docs = library_docs("general/requiredlabels") + [fixture]
    before = copy.deepcopy(docs)
    j = _results(jtest(copy.deepcopy(docs)))
    t = _results(ttest(docs))
    assert t == j and len(t) >= 1
    assert docs == before


# --- gator verify -------------------------------------------------------------

SUITES = sorted(os.path.relpath(p, ROOT)
                for p in tverify.find_suites([LIBRARY]))


def _suite_shape(sr) -> tuple:
    return (sr.error, sr.skipped, sr.failed(), [
        (t.name, t.error, t.skipped,
         [(c.name, c.error, c.skipped, list(c.prints)) for c in t.cases])
        for t in sr.tests])


@pytest.mark.parametrize("suite", SUITES)
def test_verify_suite_matches_jax(suite):
    path = os.path.join(ROOT, suite)
    j = _suite_shape(jverify.run_suite(path))
    t = _suite_shape(tverify.run_suite(path))
    assert t == j
    assert not t[2], t  # the suite passes


class _R:
    def __init__(self, msg):
        self.msg = msg


ASSERT_CASES = [
    ([{"violations": 2}], ["foo is bad", "bar is bad"]),
    ([{"violations": 1, "message": "foo"}], ["foo is bad", "bar is bad"]),
    ([{"violations": "no"}], []),
    ([{"violations": False}], ["x"]),
    ([{}], ["foo is bad"]),
    ([{}], []),
    ([{"violations": 3}], ["foo is bad", "bar is bad"]),
    ([{"violations": "maybe"}], ["foo"]),
    ([{"message": "(unclosed"}], ["foo"]),
    (None, ["foo"]),
]


@pytest.mark.parametrize("assertions,msgs", ASSERT_CASES)
def test_assert_case_matches_jax(assertions, msgs):
    results = [_R(m) for m in msgs]
    assert tverify._assert_case(assertions, results) == \
        jverify._assert_case(assertions, results)


def _no_durations(text: str) -> str:
    return re.sub(r"\(\d+\.\d+s\)", "(Ts)", text)


def jax_verify_report(paths) -> tuple:
    """(exit code, report) of the JAX ``gator verify`` on ``paths``, built
    as its ``run_cli`` builds them (its ``print_result`` binds the
    ``sys.stdout`` of import time, which no in-process redirect reaches)."""
    buf = io.StringIO()
    failed = False
    for s in jverify.find_suites(paths):
        sr = jverify.run_suite(s)
        jverify.print_result(sr, out=buf)
        failed |= sr.failed()
    return int(failed), buf.getvalue()


def test_verify_cli_prints_the_jax_report(tmp_path):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        j = jax_verify_report(["library"])
        t = run(tcli.main, ["verify", "library"])
    finally:
        os.chdir(cwd)
    assert t[0] == j[0] == 0
    assert _no_durations(t[1]) == _no_durations(j[1])
    assert len(re.findall(r"^ok\t", t[1], re.M)) == 46
    # a failing case: the same report and exit code 1
    suite = tmp_path / "suite.yaml"
    lib = os.path.join(LIBRARY, "general", "requiredlabels")
    suite.write_text(yaml.safe_dump({
        "apiVersion": "test.gatekeeper.sh/v1alpha1", "kind": "Suite",
        "tests": [{"name": "wrong", "template": f"{lib}/template.yaml",
                   "constraint": f"{lib}/samples/constraint.yaml",
                   "cases": [{"name": "allowed-said-denied",
                              "object": f"{lib}/samples/example_allowed.yaml",
                              "assertions": [{"violations": "yes"}]}]}]}))
    j = jax_verify_report([str(suite)])
    t = run(tcli.main, ["verify", str(suite)])
    assert t[0] == j[0] == 1
    assert _no_durations(t[1]) == _no_durations(j[1])
    assert "--- FAIL: wrong/allowed-said-denied" in t[1]


# --- gator sync ---------------------------------------------------------------

SYNCSET = {"apiVersion": "syncset.gatekeeper.sh/v1alpha1", "kind": "SyncSet",
           "metadata": {"name": "s"},
           "spec": {"gvks": [{"group": "networking.k8s.io", "version": "v1",
                              "kind": "Ingress"}]}}
CONFIG = {"apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
          "metadata": {"name": "config"},
          "spec": {"sync": {"syncOnly": [
              {"group": "networking.k8s.io", "version": "v1",
               "kind": "Ingress"}]}}}


@pytest.mark.parametrize("source", [None, SYNCSET, CONFIG])
def test_sync_missing_requirements_matches_jax(source, tmp_path):
    t = treader.read_sources([os.path.join(
        LIBRARY, "general", "uniqueingresshost", "template.yaml")])
    docs = t + ([source] if source else [])
    want = jsync.missing_requirements(copy.deepcopy(docs))
    assert tsync.missing_requirements(docs) == want
    assert bool(want) == (source is None)
    f = tmp_path / "docs.json"
    f.write_text(json.dumps(docs))
    j, p = both(["sync", "test", "-f", str(f)])
    assert p == j and p[0] == (1 if source is None else 0)


# --- gator expand -------------------------------------------------------------

def expand_inputs(tmp_path) -> str:
    docs = [EXPAND_DEPLOYMENTS, deployment("web"),
            deployment("api", "openpolicyagent/api:2"),
            {**deployment("cron"), "kind": "CronJob",
             "apiVersion": "batch/v1"},
            {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
             "metadata": {"name": "pull-policy"},
             "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                   "kinds": ["Pod"]}],
                      "location": "spec.containers[name: *]."
                                  "imagePullPolicy",
                      "parameters": {"assign": {"value": "Always"}}}}]
    f = tmp_path / "expand.yaml"
    f.write_text(yaml.safe_dump_all(docs))
    return str(f)


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_expand_host_lane_is_the_jax_output_byte_for_byte(tmp_path, fmt):
    f = expand_inputs(tmp_path)
    j, t = both(["expand", "-f", f, "--format", fmt])
    assert t == j and t[0] == 0
    assert t[1].count("imagePullPolicy: Always" if fmt == "yaml"
                      else '"imagePullPolicy": "Always"') == 2


@pytest.mark.parametrize("lane", ["batched", "differential"])
def test_expand_device_lanes_equal_the_host_walk(tmp_path, lane):
    f = expand_inputs(tmp_path)
    host = run(tcli.main, ["expand", "-f", f])
    rc, out, err = run(tcli.main, ["--device", "cpu", "expand", "-f", f,
                                   "--lane", lane])
    assert rc == 0 and out == host[1]
    if lane == "differential":
        assert "batched lane identical to the host walk (2 resultants)" \
            in err


# --- gator generate-vap -------------------------------------------------------

@pytest.mark.parametrize("libdir", CEL_DIRS)
@pytest.mark.parametrize("require", [False, True])
def test_generate_vap_matches_jax(libdir, require):
    argv = ["generate-vap", "-f", libdir]
    if require:
        argv.append("--require-generate-vap")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        j = run(jcli.main, argv)
        t = run(tcli.main, argv)
    finally:
        os.chdir(cwd)
    assert t == j
    if not require:
        assert t[0] == 0 and "ValidatingAdmissionPolicy" in t[1]


def test_generate_vap_over_the_whole_library_matches_jax():
    objs = treader.read_sources([LIBRARY])
    t_docs, t_skipped = tvap.generate(objs)
    j_docs, j_skipped = jvap.generate(copy.deepcopy(objs))
    assert t_docs == j_docs and t_skipped == j_skipped
    assert len(t_docs) >= 2 * len(CEL_DIRS) - 2


# --- gator policy -------------------------------------------------------------

@pytest.fixture()
def catalog(tmp_path):
    """The JAX policy tests' catalog: a tar.gz bundle in two versions and
    an OCI image layout whose one layer is a tar.gz bundle."""
    lib = os.path.join(LIBRARY, "general")
    bundles = tmp_path / "bundles"
    bundles.mkdir()
    with tarfile.open(bundles / "requiredlabels-1.1.2.tar.gz", "w:gz") as tf:
        tf.add(os.path.join(lib, "requiredlabels"), arcname="requiredlabels")
    oci = bundles / "allowedrepos-oci"
    (oci / "blobs" / "sha256").mkdir(parents=True)
    layer = tmp_path / "layer.tgz"
    with tarfile.open(layer, "w:gz") as tf:
        tf.add(os.path.join(lib, "allowedrepos"), arcname="allowedrepos")
    lb = layer.read_bytes()
    ld = hashlib.sha256(lb).hexdigest()
    (oci / "blobs" / "sha256" / ld).write_bytes(lb)
    manifest = json.dumps({"schemaVersion": 2, "layers": [
        {"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
         "digest": f"sha256:{ld}"}]}).encode()
    md = hashlib.sha256(manifest).hexdigest()
    (oci / "blobs" / "sha256" / md).write_bytes(manifest)
    (oci / "index.json").write_text(json.dumps(
        {"schemaVersion": 2, "manifests": [{"digest": f"sha256:{md}"}]}))
    (oci / "oci-layout").write_text('{"imageLayoutVersion": "1.0.0"}')
    cat = tmp_path / "catalog.yaml"
    cat.write_text(yaml.safe_dump({"policies": [
        {"name": "requiredlabels",
         "description": "Requires resources to contain specified labels.",
         "versions": [
             {"version": "1.1.1",
              "ref": "bundles/requiredlabels-1.1.2.tar.gz"},
             {"version": "1.1.2",
              "ref": "bundles/requiredlabels-1.1.2.tar.gz"}]},
        {"name": "allowedrepos",
         "description": "Allowed repos (OCI layout bundle).",
         "versions": [{"version": "2.0.0",
                       "ref": "bundles/allowedrepos-oci"}]}]}))
    return str(cat)


def _tree(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


POLICY_STEPS = [
    ["search", "labels"], ["search"],
    ["install", "requiredlabels", "--version", "1.1.1"],
    ["install", "requiredlabels"],  # refused: already installed
    ["upgrade", "requiredlabels"], ["upgrade", "requiredlabels"],
    ["install", "allowedrepos"], ["list"],
    ["remove", "requiredlabels"], ["remove", "requiredlabels"], ["list"],
    ["install", "nosuch"],
]


def test_policy_steps_and_install_trees_match_jax(catalog, tmp_path):
    trees = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        target = str(tmp_path / name)
        outs = []
        for step in POLICY_STEPS:
            argv = ["policy", *step]
            if step[0] != "remove" and step[0] != "list":
                argv += ["--catalog", catalog]
            if step[0] != "search":
                argv += ["--target", target]
            outs.append(run(main, argv))
        trees[name] = (outs, _tree(target))
    assert trees["port"][0] == trees["jax"][0]
    assert trees["port"][1] == trees["jax"][1]
    assert "allowedrepos/suite.yaml" in trees["port"][1]
    assert [rc for rc, _o, _e in trees["port"][0]] == \
        [0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 1]
    # the installed OCI bundle passes the port's verify
    rc, out, _err = run(tcli.main, ["verify", str(tmp_path / "port")])
    assert rc == 0 and "--- ok: allowed-repos" in out


def test_policy_refusals_match_jax(tmp_path):
    for mod in (jpolicy, tpolicy):
        with pytest.raises(mod.PolicyError, match="no network egress"):
            mod.load_catalog("oci://example.com/cat")
        with pytest.raises(mod.PolicyError, match="no network egress"):
            mod.fetch_bundle("https://x/y.tgz", ".", str(tmp_path / "d"))
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tf:
        info = tarfile.TarInfo("../../escape.txt")
        info.size = 0
        tf.addfile(info, fileobj=None)
    for mod in (jpolicy, tpolicy):
        with pytest.raises(mod.PolicyError, match="unsafe path"):
            mod.fetch_bundle(str(evil), ".", str(tmp_path / "dest"))
    assert not (tmp_path.parent / "escape.txt").exists()


# --- gator decisions and triage -----------------------------------------------

def rotated_sink(tmp_path, flightrec, ovl, name: str) -> str:
    """A rotated flight-recorder sink written through ``flightrec`` on an
    injected wall clock: six allows, then four decisions under the
    ``ns_cache_stale`` degradation (the last one shed), then a torn
    line."""
    sink = str(tmp_path / name)
    wall = {"t": 1000.0}
    rec = flightrec.FlightRecorder(sink_path=sink, wall=lambda: wall["t"],
                                   sink_max_bytes=300, sink_keep=8)
    reg = ovl.DegradationRegistry()
    ovl.install_degradations(reg)
    try:
        for i in range(6):
            wall["t"] += 1
            rec.record("validate", "allow", uid=f"ok-{i}", tenant="team-a")
        reg.activate("ns_cache_stale", "admission-latency-p99")
        for i in range(4):
            wall["t"] += 1
            rec.record("validate", "shed" if i == 3 else "allow",
                       uid=f"deg-{i}", reason="chaos" if i == 3 else "")
    finally:
        ovl.uninstall_degradations()
        rec.close()
    assert rec.rotations > 0
    with open(sink, "a") as f:
        f.write('{"torn": ')
    return sink


@pytest.fixture()
def sinks(tmp_path):
    from gatekeeper_tpu.observability import flightrec as jflight
    from gatekeeper_tpu.resilience import overload as jovl
    from gatekeeper_tpu_torch.observability import flightrec as tflight
    from gatekeeper_tpu_torch.resilience import overload as tovl

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    j = rotated_sink(tmp_path / "a", jflight, jovl, "decisions.jsonl")
    t = rotated_sink(tmp_path / "b", tflight, tovl, "decisions.jsonl")
    spill = tmp_path / "spill" / "cluster-a"
    spill.mkdir(parents=True)
    (spill / "snapshot.json").write_text("{}")
    return j, t, str(tmp_path / "spill")


def _sans_sink(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "sink"}


@pytest.mark.parametrize("filters", [
    {}, {"uid": "deg-3"}, {"kinds": {"shed"}}, {"tenant": "team-a"},
    {"since": 1003.0, "until": 1008.0}, {"limit": 2}])
def test_decisions_reader_matches_jax(sinks, filters):
    j, t, _spill = sinks
    want = jdecisions.read_decisions(j, **filters)
    got = tdecisions.read_decisions(t, **filters)
    assert _sans_sink(got) == _sans_sink(want)
    assert got["truncated"] == 1 and got["rotated_files"] > 1


@pytest.mark.parametrize("output", ["", "json"])
def test_decisions_cli_matches_jax(sinks, output):
    j, t, _spill = sinks
    argv = ["decisions", "--decision", "allow,shed", "-o", output]
    jr = run(jcli.main, argv + ["-f", j])
    tr = run(tcli.main, argv + ["-f", t])
    assert tr[0] == jr[0] == 0
    assert tr[1].replace(t, "SINK") == jr[1].replace(j, "SINK")


def test_triage_offline_matches_jax(sinks):
    j, t, spill = sinks
    jb = jtriage.collect_offline(j, spill=spill)
    tb = ttriage.collect_offline(t, spill=spill)
    for b in (jb, tb):
        b["sink"] = b["decisions"]["sink"] = "SINK"
        b["spill"]["clusters"][0]["newest_mtime"] = 0.0
    assert tb == jb
    jr, tr = jtriage.build_report(jb), ttriage.build_report(tb)
    assert tr == jr
    assert ttriage.render(tb, tr) == jtriage.render(jb, jr)
    assert tr["degraded"][0]["action"] == "ns_cache_stale"
    jc = run(jcli.main, ["triage", "-f", j])
    tc = run(tcli.main, ["triage", "-f", t])
    assert tc[0] == jc[0] == 0
    assert tc[1].replace(t, "SINK") == jc[1].replace(j, "SINK")
    assert run(tcli.main, ["triage"])[0] == 2


def serve_and_triage(pkg: str, device_driver) -> tuple:
    """One package's ``WebhookServer`` on the CPU (the requiredlabels
    template and sample constraint, the flight recorder, cost attribution
    and the SLO engine as the served CLI wires them), six admissions
    (three denied), then ``collect_live`` + ``build_report`` through that
    package's triage."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    constraints = mod("apis.constraints")
    M = mod("metrics.registry")
    costattr = mod("observability.costattr")
    flightrec = mod("observability.flightrec")
    slo = mod("observability.slo")
    policy = mod("webhook.policy")
    triage = mod("gator.triage_cmd")
    client = mod("client.client").Client(
        target=mod("target.target").K8sValidationTarget(),
        drivers=[device_driver],
        enforcement_points=[constraints.WEBHOOK_EP])
    for doc in library_docs("general/requiredlabels"):
        (client.add_template if doc["kind"] == "ConstraintTemplate"
         else client.add_constraint)(doc)
    m = M.MetricsRegistry()
    attr = costattr.CostAttribution(metrics=m)
    rec = flightrec.FlightRecorder(metrics=m)
    eng = slo.SLOEngine(m, objectives=list(slo.DEFAULT_OBJECTIVES))
    batcher = policy.Batcher(client, small_batch=0, metrics=m).start()
    handler = policy.ValidationHandler(client, batcher=batcher, metrics=m)
    srv = mod("webhook.server").WebhookServer(
        validation_handler=handler, metrics=m, port=0,
        cost_attribution=attr, slo_engine=eng, flight_recorder=rec).start()
    try:
        with costattr.activate(attr), flightrec.activate(rec):
            for i in range(6):
                labels = {"owner": "me.agilebank.demo"} if i % 2 else {}
                body = {"apiVersion": "admission.k8s.io/v1",
                        "kind": "AdmissionReview",
                        "request": {"uid": f"ns-{i}", "operation": "CREATE",
                                    "kind": {"group": "", "version": "v1",
                                             "kind": "Namespace"},
                                    "name": f"ns-{i}", "namespace": "",
                                    "userInfo": {"username": "it"},
                                    "object": {"apiVersion": "v1",
                                               "kind": "Namespace",
                                               "metadata": {
                                                   "name": f"ns-{i}",
                                                   "labels": labels}}}}
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/admit",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as r:
                    json.loads(r.read())
            eng.tick()
            bundle = triage.collect_live(f"http://127.0.0.1:{srv.port}")
    finally:
        srv.stop()
        batcher.stop()
    bundle["collected_at"] = time.time()
    return bundle, triage.build_report(bundle)


def _live_shape(bundle: dict, report: dict) -> dict:
    decisions = bundle["decisions"]["decisions"]
    return {
        "errors": {k: bundle[k].get("error") for k in
                   ("slo", "cost", "overload", "traces", "decisions")},
        "decisions": sorted((e["uid"], e["decision"]) for e in decisions),
        "decision_counts": report["decision_counts"],
        "objectives": sorted(ev["name"] for ev in
                             bundle["slo"].get("objectives", [])),
        "objectives_total": report["objectives_total"],
        "breaching": [ev["name"] for ev in report["breaching"]],
        "degraded": report["degraded"],
        "top_templates": [t["template"] for t in report["top_templates"]],
        "recent_sheds": report["recent_sheds"], "chains": report["chains"],
    }


def test_triage_live_matches_jax_against_each_webhook_server():
    from gatekeeper_tpu.drivers.tpu_driver import TpuDriver
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver

    jb, jr = serve_and_triage("gatekeeper_tpu", TpuDriver())
    tb, tr = serve_and_triage("gatekeeper_tpu_torch",
                              TorchDriver(device="cpu"))
    assert _live_shape(tb, tr) == _live_shape(jb, jr)
    assert tr["decision_counts"] == {"allow": 3, "deny": 3}
    assert not tr["chains"]


# --- the device flag ----------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["bench", "-f", "library/general/allowedrepos", "--engine", "tpu"],
    ["bench", "-f", "library/general/allowedrepos", "--engine", "sweep"],
    ["replay", "-f", "sink.jsonl", "--candidate", "library/general"],
    ["expand", "-f", "library/general/allowedrepos", "--lane", "batched"],
    ["--device", "cuda", "expand", "-f", "library/general/allowedrepos",
     "--lane", "differential"],
])
def test_device_commands_raise_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            run(tcli.main, argv)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("argv", [
    ["test", "-f", "library/general/allowedrepos"],
    ["verify", "library/general/allowedrepos"],
    ["bench", "-f", "library/general/allowedrepos", "--engine", "rego",
     "-n", "1"],
    ["expand", "-f", "library/general/allowedrepos"],
])
def test_interpreter_commands_ignore_the_device(argv):
    """The commands that run only the interpreters behave as in the JAX
    package under the default ``--device cuda``, card or not."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rc, out, _err = run(tcli.main, argv)
        jrc, jout, _jerr = run(jcli.main, argv)
    finally:
        os.chdir(cwd)
    assert rc == jrc
    if argv[0] in ("test", "expand"):
        assert out == jout


def test_global_flags_are_parsed_before_the_command():
    assert run(tcli.main, ["--device", "tpu", "test"])[0] == 2
    assert run(tcli.main, ["--device=cpu"])[0] == 0
    assert tcli._global_flag(["--device", "cpu", "bench", "--device",
                              "cuda"], "--device") == (
        "cpu", ["bench", "--device", "cuda"])
    assert run(tcli.main, ["nosuch"])[0] == 2
