"""The sweep's differential collect lane (gatekeeper_tpu_torch/parallel/
sweep.py ``collect="differential"``) against the JAX package's
(``ShardedEvaluator(collect="differential")``), on the CPU (the plain
versions of both fold kernels).

- An audit of 600 synthetic objects over an 8-template library slice at
  chunks of 64, on the budgeted path and with exact totals: totals and
  kept lists equal the JAX differential run's and the port's reduced
  lane's; ``collect_differential_ok`` equals the chunks dispatched through
  both lanes (``differential_chunks``).
- A tampered reduced result — the plain ``fused_fold`` dropping one hit,
  miscounting the occupancy, or keeping another index — raises
  ``collect differential: ...``.
- One chunk at ``pad_n`` > 0xFFFF (65,600 Namespaces, one constraint): the
  reduced lane's ``[counts, occ]`` rows in place of the u16|u16 word, held
  against the masks lane and the JAX package's differential run.
- The staged pipeline (``pipeline="on"``: dispatches on one thread, the
  reduced lane's overflow re-dispatches from the collect thread) with a
  thread switch forced every few microseconds: both lanes of a chunk
  stay paired, and the run equals the serial one.
- ``python -m gatekeeper_tpu_torch --collect differential --once --device
  cpu`` prints the JAX CLI's stdout.

Tolerance: exact equality throughout."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa
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
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa
from gatekeeper_tpu_torch.audit.manager import (AuditConfig,  # noqa: E402
                                                AuditManager)
from gatekeeper_tpu_torch.client.client import Client  # noqa: E402
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import \
    TorchDriver  # noqa: E402
from gatekeeper_tpu_torch.ops import fold  # noqa: E402
from gatekeeper_tpu_torch.parallel import sweep  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import (library_dir,  # noqa
                                                  load_library)
from gatekeeper_tpu_torch.utils.unstructured import \
    load_yaml_file  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
KEEP = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits",
        "K8sDisallowedTags", "K8sHttpsOnly", "K8sReplicaLimits",
        "K8sPSPAllowPrivilegeEscalationContainer", "K8sNoPrivileged")
N_OBJECTS = 600
CHUNK = 64


def _skip():
    kinds = [load_yaml_file(p)[0]["spec"]["crd"]["spec"]["names"]["kind"]
             for p in glob.glob(os.path.join(library_dir(), "*", "*",
                                             "template.yaml"))]
    assert set(KEEP) <= set(kinds)
    return tuple(k for k in kinds if k not in KEEP)


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=11)


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _port_world(objects, collect):
    cel = CELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    load_library(client, skip_kinds=_skip())
    assert set(driver.lowered_kinds()) == set(KEEP)
    ev = sweep.SweepEvaluator(driver, device="cpu", violations_limit=20,
                              collect=collect)
    return client, ev


def _port_run(objects, collect, exact):
    client, ev = _port_world(objects, collect)
    run = AuditManager(client, lambda: iter(objects),
                       AuditConfig(chunk_size=CHUNK, exact_totals=exact),
                       evaluator=ev).audit()
    return run, ev


def _jax_run(objects, exact):
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client, skip_kinds=_skip())
    ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                          collect="differential")
    run = JManager(client, lambda: iter(objects),
                   JConfig(chunk_size=CHUNK, exact_totals=exact,
                           pipeline="off"), evaluator=ev).audit()
    return run, ev


@pytest.mark.parametrize("exact", [False, True], ids=["budgeted", "exact"])
def test_differential_audit_matches_jax_and_reduced(objects, exact):
    run, ev = _port_run(objects, "differential", exact)
    jrun, jev = _jax_run(objects, exact)
    got = _summary(run)
    assert got[0] == N_OBJECTS and sum(got[1].values()) > 0
    assert not got[3]
    assert got == _summary(jrun)
    assert got == _summary(_port_run(objects, "reduced", exact)[0])
    chunks = ev.perf.get("differential_chunks", 0)
    assert chunks > 0
    assert ev.perf["collect_differential_ok"] == chunks
    # the JAX lane held as many chunks (the chunking is the same)
    assert jev.perf["collect_differential_ok"] == \
        ev.perf["collect_differential_ok"]
    assert ev.perf.get("collect_differential_fallbacks", 0) == \
        jev.perf.get("collect_differential_fallbacks", 0)


def _tampered(how):
    plain = fold.fused_fold

    def tampered(raw, mask, k):
        idx, valid, counts, occ = plain(raw, mask, k)
        idx, valid = idx.clone(), valid.clone()
        counts, occ = counts.clone(), occ.clone()
        rows = torch.nonzero(counts > 1).reshape(-1)
        if rows.numel():
            r = int(rows[0])
            if how == "totals":  # one hit dropped
                last = int(valid[r].sum()) - 1
                valid[r, last] = False
                counts[r] -= 1
            elif how == "occ":
                occ[r] += 1
            else:  # the kept selection names another object
                idx[r, 0] = idx[r, 1]
        return idx, valid, counts, occ

    return tampered


@pytest.mark.parametrize("how,message", [
    ("totals", "totals differ"), ("occ", "device occupancy"),
    ("kept", "kept selection differs")])
def test_a_tampered_reduced_result_raises(objects, monkeypatch, how,
                                          message):
    client, ev = _port_world(objects, "differential")
    monkeypatch.setattr(fold, "fused_fold", _tampered(how))
    cons = [c for c in client.constraints()
            if c.kind == "K8sRequiredLabels"]
    with pytest.raises(RuntimeError, match="collect differential: "
                       + message):
        ev.sweep(cons, _namespaces(CHUNK))


def _namespaces(n):
    out = []
    for i in range(n):
        labels = {"owner": "me.agilebank.demo"} if i % 3 else {}
        out.append({"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": f"ns-{i}", "labels": labels}})
    return out


def test_a_chunk_past_0xffff_rows(monkeypatch):
    """pad_n = 131,072: the reduced lane ships separate ``counts`` and
    ``occ`` rows; both lanes and the JAX differential agree."""
    objs = _namespaces(65_600)
    want = sum(1 for o in objs if not o["metadata"]["labels"])
    client, ev = _port_world(objs, "differential")
    cons = [c for c in client.constraints()
            if c.kind == "K8sRequiredLabels"]
    assert len(cons) == 1
    seen = []
    plain_reduce = ev._reduce

    def spy(raw, mask, budget, complete, hit_cap, k, pad_n):
        out = plain_reduce(raw, mask, budget, complete, hit_cap, k, pad_n)
        seen.append((pad_n, out.shape[0] - 1 - hit_cap))
        return out

    monkeypatch.setattr(ev, "_reduce", spy)
    out = ev.sweep(cons, objs)
    (_cons, idx, valid, counts, _bits), = out.values()
    assert int(counts[0]) == want
    assert seen == [(131072, 2)]  # [counts, occ]: two rows of C=1
    assert ev.perf["collect_differential_ok"] == 1
    assert np.sort(idx[0][valid[0]]).tolist() == \
        [i for i, o in enumerate(objs) if not o["metadata"]["labels"]][:20]
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    jclient = JClient(target=JTarget(), drivers=[driver, cel],
                      enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(jclient, skip_kinds=_skip())
    jev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                           collect="differential")
    jcons = [c for c in jclient.constraints()
             if c.kind == "K8sRequiredLabels"]
    (_jc, jidx, jvalid, jcounts, _jb), = jev.sweep(jcons, objs).values()
    assert np.asarray(jcounts).tolist() == counts.tolist()
    assert np.asarray(jidx)[np.asarray(jvalid)].tolist() == \
        idx[valid].tolist()
    assert jev.perf["collect_differential_ok"] == 1


@pytest.mark.parametrize("exact", [False, True], ids=["budgeted", "exact"])
def test_pipelined_differential_keeps_each_chunks_lanes_paired(objects,
                                                               exact):
    serial = _summary(_port_run(objects, "differential", exact)[0])
    client, ev = _port_world(objects, "differential")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        mgr = AuditManager(client, lambda: iter(objects),
                           AuditConfig(chunk_size=CHUNK, exact_totals=exact,
                                       pipeline="on"),
                           evaluator=ev)
        run = mgr.audit()
    finally:
        sys.setswitchinterval(old)
    assert mgr.perf.get("pipelined") == 1.0
    assert not mgr.perf.get("degraded_to_serial")
    assert ev.perf.get("differential_chunks", 0) > 0
    assert ev.perf["collect_differential_ok"] == \
        ev.perf["differential_chunks"]
    assert _summary(run) == serial


def _manifest_dir(tmp_path):
    lib = os.path.join(ROOT, "library", "general")
    i = 0
    for name in ("requiredlabels", "allowedrepos", "containerlimits",
                 "noprivileged"):
        for f in ("template.yaml", "samples/constraint.yaml",
                  "samples/example_allowed.yaml",
                  "samples/example_disallowed.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                (tmp_path / f"{i:02d}.yaml").write_text(fh.read())
            i += 1


def test_cli_once_differential_matches_jax_cli(tmp_path):
    _manifest_dir(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for pkg, extra in (("gatekeeper_tpu", []),
                       ("gatekeeper_tpu_torch", ["--device", "cpu"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(tmp_path),
             "--once", "--collect", "differential",
             "--audit-chunk-size", "4", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[pkg] = (p.stdout, m.group(1), m.group(2))
    assert outs["gatekeeper_tpu_torch"] == outs["gatekeeper_tpu"]
    assert outs["gatekeeper_tpu"][0].count("\n") >= 4
