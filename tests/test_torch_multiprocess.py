"""The port's audit across processes (``parallel/distributed.py``): two
``python -m gatekeeper_tpu_torch --once --coordinator ... --num-processes 2
--process-id i`` processes join a gloo process group on the CPU, each with
two logical shards (``GATEKEEPER_LOCAL_DEVICE_COUNT=2``: a 4-shard global
mesh), and sweep the same manifests.  Both must print the same summary,
equal to the port's and the JAX package's single-process CLI.  The
manifests are the three templates of the JAX package's
``tests/multihost_worker.py`` (``__graft_entry__``) with its constraints
and 200 of its pods, so the case stays fast.  A peer that never joins, a
peer killed mid-sweep and ranks fed different objects must each end in an
error (exit 1) well inside the test's own time limit, never a hang."""

import json
import os
import re
import socket
import subprocess
import sys
import time

import pytest
import yaml

pytest.importorskip("jax")

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import __graft_entry__ as g  # noqa: E402

CHUNK = 16
LIMIT_S = 120  # each child's own time limit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _constraints() -> list:
    match = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
    out = [{"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": {"match": match}}
           for kind, name in (("K8sPSPPrivilegedContainer", "no-priv"),
                              ("K8sPSPHostNamespace", "no-host-ns"))]
    for i in range(4):
        out.append({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                    "kind": "K8sRequiredLabels",
                    "metadata": {"name": f"labels-{i}"},
                    "spec": {"match": match, "parameters": {"labels": [
                        {"key": "owner", "allowedRegex": "^team-"},
                        {"key": f"lab{i}", "allowedRegex": ""}]}}})
    return out


def _manifests(path, n_pods: int = 200):
    os.makedirs(path, exist_ok=True)
    templates = [g._PRIV_TEMPLATE, g._REQ_LABELS_TEMPLATE,
                 g._HOST_NS_TEMPLATE]
    docs = [dict(t, apiVersion="templates.gatekeeper.sh/v1")
            for t in templates] + _constraints() + g._make_pods(n_pods)
    with open(os.path.join(path, "all.yaml"), "w") as f:
        yaml.safe_dump_all(docs, f)
    return str(path)


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               GATEKEEPER_LOCAL_DEVICE_COUNT="2",
               GATEKEEPER_DIST_TIMEOUT_S="30")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _cli(pkg, manifests, *extra):
    return [sys.executable, "-m", pkg, "--manifests", manifests, "--once",
            "--audit-chunk-size", str(CHUNK), *extra]


def _ranks(manifests, extra=(), env=None, per_rank=None):
    """Start both ranks, wait for both (killing both if either runs past
    its limit); returns [(rc, stdout, stderr)] in rank order."""
    port = _free_port()
    procs = []
    for i in range(2):
        argv = _cli("gatekeeper_tpu_torch", manifests, "--device", "cpu",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(i), *extra)
        if per_rank:
            argv = per_rank(i, argv)
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env or _env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _audit_line(err: str) -> str:
    m = re.search(r"audit: (\d+) objects, (\d+) violations", err)
    assert m, err[-3000:]
    return m.group(0)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    return _manifests(tmp_path_factory.mktemp("mp"))


@pytest.fixture(scope="module")
def single(manifests):
    """(stdout, audit line) of the port's and the JAX package's one-process
    CLI, which must agree."""
    out = {}
    for pkg, extra in (("gatekeeper_tpu", ()),
                       ("gatekeeper_tpu_torch", ("--device", "cpu"))):
        p = subprocess.run(_cli(pkg, manifests, *extra), cwd=ROOT,
                           env=_env(GATEKEEPER_LOCAL_DEVICE_COUNT="1"),
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        out[pkg] = (p.stdout, _audit_line(p.stderr))
    assert out["gatekeeper_tpu"] == out["gatekeeper_tpu_torch"]
    assert out["gatekeeper_tpu"][0].count("\n") > 50
    return out["gatekeeper_tpu"]


@pytest.mark.parametrize("collect", ["reduced", "masks", "differential"])
def test_two_ranks_print_the_single_process_summary(manifests, single,
                                                    collect):
    outs = _ranks(manifests, ("--shard-chunks", "2", "--collect", collect))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        assert f"joined global mesh: process {i}/2" in err
        assert "n_devices=4, shard_chunks=2" in err
        assert (out, _audit_line(err)) == single
    assert outs[0][1] == outs[1][1]


_INFO = r"""
import json, sys
from gatekeeper_tpu_torch.parallel import distributed
from gatekeeper_tpu_torch.parallel.mesh import make_mesh
distributed.init_distributed(sys.argv[1], 2, int(sys.argv[2]),
                             local_device_count=int(sys.argv[3]),
                             device="cpu", timeout_s=30)
mesh = make_mesh(device="cpu")
print(json.dumps({"info": distributed.process_info(), "size": mesh.size,
                  "ranks": [r for r, _d in mesh.shards],
                  "local": [i for i, _d in mesh.local]}))
"""


def test_process_info_and_the_global_mesh():
    """Rank 0 with 2 shards and rank 1 with 1: a 3-shard mesh in rank
    order, as JAX's global device list."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _INFO, f"127.0.0.1:{port}", str(i),
         str(2 - i)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    got = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT_S)
            assert p.returncode == 0, err[-3000:]
            got.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert got[0] == {"info": [0, 2, 2, 3], "size": 3, "ranks": [0, 0, 1],
                      "local": [0, 1]}
    assert got[1] == {"info": [1, 2, 1, 3], "size": 3, "ranks": [0, 0, 1],
                      "local": [2]}


def test_a_peer_that_never_joins_ends_in_an_error(manifests):
    port = _free_port()
    t0 = time.monotonic()
    p = subprocess.run(
        _cli("gatekeeper_tpu_torch", manifests, "--device", "cpu",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", "0"),
        cwd=ROOT, env=_env(GATEKEEPER_DIST_TIMEOUT_S="5"),
        capture_output=True, text=True, timeout=LIMIT_S)
    assert p.returncode != 0
    assert time.monotonic() - t0 < 60
    assert "1/2 clients joined" in p.stderr or "Timed out" in p.stderr


def test_a_peer_killed_mid_sweep_ends_in_an_error(manifests, tmp_path):
    """Rank 1 stalls in its first dispatch (a chaos sleep) and is killed:
    rank 0's gather fails, the mesh breaks, every later chunk drops at
    once and ``--once`` exits 1."""
    spec = tmp_path / "stall.json"
    spec.write_text(json.dumps({"seed": 0, "faults": [
        {"site": "device.dispatch", "mode": "sleep", "delay_s": 60}]}))
    port = _free_port()
    base = _cli("gatekeeper_tpu_torch", manifests, "--device", "cpu",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "2")
    r0 = subprocess.Popen(base + ["--process-id", "0"], cwd=ROOT,
                          env=_env(), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    r1 = subprocess.Popen(base + ["--process-id", "1", "--chaos",
                                  str(spec)], cwd=ROOT, env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    try:
        deadline = time.monotonic() + LIMIT_S
        while "joined global mesh" not in (r1.stderr.readline() or "") \
                and time.monotonic() < deadline:
            pass
        time.sleep(2.0)  # rank 0 reaches its first gather
        r1.kill()
        r1.wait()
        t0 = time.monotonic()
        _out, err = r0.communicate(timeout=LIMIT_S)
    finally:
        for p in (r0, r1):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert r0.returncode == 1, err[-3000:]
    assert time.monotonic() - t0 < 60
    assert "mesh broken: gather failed" in err
    assert "INCOMPLETE" in err


def test_ranks_fed_different_objects_break_the_mesh(manifests, tmp_path):
    """Rank 1 lists more pods: the chunk tags differ at the first gather
    that pairs different chunks, and both ranks exit 1 instead of merging
    them."""
    other = _manifests(tmp_path / "other", n_pods=230)

    def per_rank(i, argv):
        return [other if a == manifests and i == 1 else a for a in argv]

    outs = _ranks(manifests, per_rank=per_rank)
    for rc, _out, err in outs:
        assert rc == 1, err[-3000:]
        assert "mesh broken: ranks gathered different chunks" in err
