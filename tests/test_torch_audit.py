"""The port's audit sweep (gatekeeper_tpu_torch/audit/manager.py over
parallel/sweep.py, on the CPU with the plain fold versions) against the
JAX package's ``AuditManager`` with ``ShardedEvaluator(make_mesh(1))``:
the whole library (44 Rego and 2 CEL templates, each side with its CEL
driver), seeded synthetic objects,
chunks of 512, on both collect lanes.  Object counts, per-constraint
totals and the kept (constraint, kind, namespace/name, message) lists must
be identical.  One more case compares ``python -m gatekeeper_tpu_torch
--manifests DIR --once`` with the JAX package's CLI, and one serves the
port's webhook from the CLI (``--port 0``) and posts one admission."""

import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
N_OBJECTS = 2000
N_EXACT = 800  # exact totals render every hit: a shorter prefix
CHUNK = 512


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=7)


@pytest.fixture(scope="module")
def jax_runs():
    """(JAX collect lane, exact, n) -> summary of the JAX audit."""
    return {}


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _jax_run(objects, collect, exact):
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                          collect=collect)
    cfg = JConfig(chunk_size=CHUNK, exact_totals=exact, pipeline="off")
    return JManager(client, lambda: iter(objects), cfg,
                    evaluator=ev).audit()


def _port_run(objects, collect, exact):
    cel = TCELDriver()
    driver = TorchDriver(cel_driver=cel)
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert tload(client) == (46, 46)
    assert set(CEL_KINDS) <= set(driver.lowered_kinds())
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        collect=collect)
    cfg = TConfig(chunk_size=CHUNK, exact_totals=exact)
    return TManager(client, lambda: iter(objects), cfg,
                    evaluator=ev).audit()


@pytest.mark.parametrize("collect,exact,n", [
    ("reduced", False, N_OBJECTS), ("masks", False, N_OBJECTS),
    ("masks", True, N_EXACT), ("reduced", True, N_EXACT)])
def test_library_audit_matches_jax(objects, jax_runs, collect, exact, n):
    # exact totals do not depend on the JAX collect lane (the JAX package's
    # own tests hold its lanes equal): the port's reduced lane is held
    # against the JAX masks lane's run
    jcollect = "masks" if exact else collect
    key = (jcollect, exact, n)
    if key not in jax_runs:
        jax_runs[key] = _summary(_jax_run(objects[:n], jcollect, exact))
    want = jax_runs[key]
    got = _summary(_port_run(objects[:n], collect, exact))
    assert got[0] == want[0] == n
    assert sum(want[1].values()) > 0
    assert all(want[1][key] > 0 for key in want[1] if key[0] in CEL_KINDS)
    assert got == want


def test_collect_lanes_agree_exact_totals(objects):
    """Exact-totals chunks on the reduced lane ship complete hit lists
    (with overflow fallback to the masks lane); they must fold to the
    masks lane's result."""
    assert _summary(_port_run(objects[:N_EXACT], "reduced", True)) == \
        _summary(_port_run(objects[:N_EXACT], "masks", True))


def _manifest_dir(tmp_path, names=("requiredlabels", "allowedrepos",
                                   "containerlimits")):
    lib = os.path.join(ROOT, "library", "general")
    docs = []
    for name in names:
        for f in ("template.yaml", "samples/constraint.yaml",
                  "samples/example_allowed.yaml",
                  "samples/example_disallowed.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                docs.append(fh.read())
    for i, doc in enumerate(docs):
        (tmp_path / f"{i:02d}.yaml").write_text(doc)
    return tmp_path


@pytest.mark.parametrize("names", [
    ("requiredlabels", "allowedrepos", "containerlimits"),
    ("requiredlabels", "allowedrepos", "containerlimits",
     "containerlimitscel", "noprivileged")], ids=["rego", "rego+cel"])
def test_cli_once_matches_jax_cli(tmp_path, names):
    _manifest_dir(tmp_path, names)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for pkg, extra in (("gatekeeper_tpu", []),
                       ("gatekeeper_tpu_torch", ["--device", "cpu"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(tmp_path),
             "--once", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[pkg] = (p.stdout, int(m.group(1)), int(m.group(2)))
    jax_out, jax_n, jax_v = outs["gatekeeper_tpu"]
    out, n, v = outs["gatekeeper_tpu_torch"]
    assert out == jax_out and out.count("\n") >= len(names)
    assert v == jax_v
    cel_kinds = {ln.split("/")[0].strip() for ln in out.splitlines()} & \
        set(CEL_KINDS)
    assert cel_kinds == (set(CEL_KINDS) if "noprivileged" in names
                         else set())
    # the JAX CLI also audits the ConstraintTemplatePodStatus object its
    # controller writes per template; the port has no controller plane
    assert jax_n == n + len(names)


def test_cli_serves_admission(tmp_path):
    """``python -m gatekeeper_tpu_torch --manifests DIR --port 0 --device
    cpu`` prints its port, answers /healthz and a /v1/admit deny with the
    constraint's message, and drains and exits 0 on SIGTERM.  Without
    ``--device cpu`` it runs on the card, so without one it refuses to
    start."""
    import torch

    _manifest_dir(tmp_path)
    if not torch.cuda.is_available():
        p = subprocess.run(
            [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
             str(tmp_path), "--port", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert "torch.cuda.is_available() is False" in p.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(tmp_path), "--port", "0", "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"webhook serving on :(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "the server never printed its port"
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ready": True}
        ns = {"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "no-owner"}}
        body = {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {"uid": "u-1", "operation": "CREATE",
                            "kind": {"group": "", "version": "v1",
                                     "kind": "Namespace"},
                            "name": "no-owner", "object": ns}}
        req = urllib.request.Request(
            base + "/v1/admit", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            resp = json.loads(r.read())["response"]
        assert resp["uid"] == "u-1" and resp["allowed"] is False
        assert resp["status"]["code"] == 403
        assert resp["status"]["message"].startswith(
            "[all-must-have-owner] All namespaces must have an `owner` "
            "label")
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "drain complete" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
