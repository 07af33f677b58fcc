"""The port's audit sweep (gatekeeper_tpu_torch/audit/manager.py over
parallel/sweep.py, on the CPU with the plain fold versions) against the
JAX package's ``AuditManager`` with ``ShardedEvaluator(make_mesh(1))``:
the library without its two CEL templates, seeded synthetic objects,
chunks of 512, on both collect lanes.  Object counts, per-constraint
totals and the kept (constraint, kind, namespace/name, message) lists must
be identical.  One more case compares ``python -m gatekeeper_tpu_torch
--manifests DIR --once`` with the JAX package's CLI."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
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


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _jax_run(objects, collect, exact):
    driver = TpuDriver()
    client = JClient(target=JTarget(), drivers=[driver],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client, skip_kinds=CEL_KINDS)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                          collect=collect)
    cfg = JConfig(chunk_size=CHUNK, exact_totals=exact, pipeline="off")
    return JManager(client, lambda: iter(objects), cfg,
                    evaluator=ev).audit()


def _port_run(objects, collect, exact):
    driver = TorchDriver()
    client = TClient(target=TTarget(), drivers=[driver],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    tload(client, skip_kinds=CEL_KINDS)
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
    ("masks", True, N_EXACT)])
def test_library_audit_matches_jax(objects, collect, exact, n):
    want = _summary(_jax_run(objects[:n], collect, exact))
    got = _summary(_port_run(objects[:n], collect, exact))
    assert got[0] == want[0] == n
    assert sum(want[1].values()) > 0
    assert got == want


def test_collect_lanes_agree_exact_totals(objects):
    """Exact-totals chunks on the reduced lane ship complete hit lists
    (with overflow fallback to the masks lane); they must fold to the
    masks lane's result."""
    assert _summary(_port_run(objects[:N_EXACT], "reduced", True)) == \
        _summary(_port_run(objects[:N_EXACT], "masks", True))


def test_cli_once_matches_jax_cli(tmp_path):
    lib = os.path.join(ROOT, "library", "general")
    docs = []
    for name in ("requiredlabels", "allowedrepos", "containerlimits"):
        for f in ("template.yaml", "samples/constraint.yaml",
                  "samples/example_allowed.yaml",
                  "samples/example_disallowed.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                docs.append(fh.read())
    for i, doc in enumerate(docs):
        (tmp_path / f"{i:02d}.yaml").write_text(doc)
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
    assert out == jax_out and out.count("\n") >= 3
    assert v == jax_v
    # the JAX CLI also audits the ConstraintTemplatePodStatus object its
    # controller writes per template; the port has no controller plane
    assert jax_n == n + 3
