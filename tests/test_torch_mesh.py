"""The port's sweep over a device mesh (``parallel/mesh.py`` and the
sharded ``parallel/sweep.py``), on logical CPU shards, against the JAX
package's ``ShardedEvaluator`` on ``make_mesh(1)`` and on a 4-device
``make_mesh(4)`` (the conftest gives JAX 8 virtual CPU devices).

The corpus is the whole library (44 Rego and 2 CEL templates) over
``make_cluster_objects(600, seed=11)``, the shape of the JAX package's
``tests/test_multichip_sharded.py``, in chunks of 64.  Every case must
give bit-identical totals, kept lists and rendered messages: the three
collect lanes with and without exact totals on 2 and 4 shards, a forced
hit-buffer overflow on each lane, ``shard_chunks`` 0/2/4 on the relist and
on a snapshot step, the pipelined schedule, and the residency's logged
fallback on a mesh of more than one shard."""

import copy

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.parallel.sharded import ShardedEvaluator  # noqa: E402
from gatekeeper_tpu.parallel.sharded import \
    make_mesh as jmake_mesh  # noqa: E402
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
from gatekeeper_tpu_torch.parallel import sweep as sweep_mod  # noqa: E402
from gatekeeper_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,  # noqa: E402
                                           DeviceResidency, SnapshotConfig,
                                           WatchIngester, gvks_of)
from gatekeeper_tpu_torch.snapshot import \
    device_residency as residency_mod  # noqa: E402
from gatekeeper_tpu_torch.sync.source import FakeCluster  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

N_OBJECTS = 600
CHUNK = 64


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=11)


@pytest.fixture(scope="module")
def jax_world(objects):
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    return client, driver, {}


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _jax(jax_world, objects, exact, n_devices, shard_chunks=0):
    """The JAX audit on the masks lane (the JAX package's own tests hold
    its lanes equal), cached per configuration."""
    client, driver, cache = jax_world
    key = (exact, n_devices, shard_chunks)
    if key not in cache:
        ev = ShardedEvaluator(driver, jmake_mesh(n_devices),
                              violations_limit=20, collect="masks")
        cfg = JConfig(chunk_size=CHUNK, exact_totals=exact, pipeline="off",
                      shard_chunks=shard_chunks)
        run = JManager(client, lambda: iter(objects), cfg,
                       evaluator=ev).audit()
        assert run.n_devices == n_devices
        cache[key] = _summary(run)
    return cache[key]


def _port_client(objects):
    cel = TCELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel)
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert tload(client) == (46, 46)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    return client, driver


def _cpu_mesh(d):
    return make_mesh(device="cpu", devices=["cpu"] * d)


def _port(objects, collect, exact, d, shard_chunks=0, pipeline="off"):
    client, driver = _port_client(objects)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        collect=collect, mesh=_cpu_mesh(d))
    cfg = TConfig(chunk_size=CHUNK, exact_totals=exact, pipeline=pipeline,
                  shard_chunks=shard_chunks)
    mgr = TManager(client, lambda: iter(objects), cfg, evaluator=ev)
    run = mgr.audit()
    assert run.n_devices == d and run.shard_chunks == shard_chunks
    return run, ev, mgr


def _counted_folds(monkeypatch):
    """{(kernel wrapper, C, N): calls} of the plain fold versions the CPU
    wrappers run."""
    from gatekeeper_tpu_torch.ops import fold

    seen: dict = {}
    for name in ("fused_fold", "epilogue"):
        real = getattr(fold, name)

        def counted(grid, *args, _real=real, _name=name):
            key = (_name, grid.shape[0], grid.shape[1])
            seen[key] = seen.get(key, 0) + 1
            return _real(grid, *args)

        monkeypatch.setattr(fold, name, counted)
    return seen


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("collect,exact", [
    ("reduced", False), ("masks", False), ("differential", False),
    ("reduced", True), ("masks", True), ("differential", True)])
def test_mesh_audit_matches_jax(objects, jax_world, monkeypatch, collect,
                                exact, d):
    seen = _counted_folds(monkeypatch)
    run, ev, _mgr = _port(objects, collect, exact, d, shard_chunks=d)
    got = _summary(run)
    assert got == _jax(jax_world, objects, exact, 1)
    assert got == _jax(jax_world, objects, exact, 4, shard_chunks=4)
    assert sum(got[1].values()) > 0 and not got[3]
    # every dispatch folds each of its d shards through a fold kernel at
    # the shard's width: (C, pad_n / d)
    widths = {n for (_name, _c, n) in seen}
    assert widths and all(n % 8 == 0 for n in widths)
    assert max(widths) <= CHUNK
    if collect != "masks" and not exact:
        assert sum(v for (name, _c, _n), v in seen.items()
                   if name == "fused_fold") % d == 0
    if collect == "differential":
        assert ev.perf["collect_differential_ok"] >= 1


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("collect,exact", [
    ("reduced", False), ("reduced", True), ("differential", True)])
def test_forced_hit_buffer_overflow(objects, jax_world, monkeypatch, collect,
                                    exact, d):
    """Tiny hit buffers: every shard's selection overflows, every rank
    re-dispatches the chunk through the masks lane (decided from the
    merged values) and the verdicts stay the JAX package's."""
    monkeypatch.setattr(sweep_mod, "hit_bucket",
                        lambda need, cap: min(need, 2))
    real = SweepEvaluator._hit_state_for

    def tiny(self, kinds, pad_n):
        fresh = (kinds, pad_n) not in self._hit_state
        st = real(self, kinds, pad_n)
        if fresh:
            st["cap"] = 2
        return st

    monkeypatch.setattr(SweepEvaluator, "_hit_state_for", tiny)
    run, ev, _mgr = _port(objects, collect, exact, d)
    assert ev.perf.get("collect_fallbacks", 0) > 0
    assert _summary(run) == _jax(jax_world, objects, exact, 1)


@pytest.mark.parametrize("shard_chunks", [0, 2, 4])
def test_shard_chunks_on_the_relist(objects, jax_world, shard_chunks):
    run, ev, _mgr = _port(objects, "reduced", False, 2,
                          shard_chunks=shard_chunks)
    assert _summary(run) == _jax(jax_world, objects, False, 1)
    plain = _port(objects, "reduced", False, 2)[1]
    if shard_chunks > 1:
        # K same-group chunks pack into one dispatch
        assert ev.dispatch_count < plain.dispatch_count


def test_shard_chunks_kept_order_follows_dispatch_as_in_jax():
    """A constraint whose kinds span two kind groups (a wildcard match)
    keeps its first k violations in dispatch order, which the packing
    shifts: the port keeps what the JAX package keeps, with and without
    ``shard_chunks``, and totals never move."""
    import os

    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    lib = os.path.join(os.path.dirname(__file__), "..", "library",
                       "general")
    docs = [load_yaml_file(os.path.join(lib, name, f))[0]
            for name in ("requiredlabels", "allowedrepos")
            for f in ("template.yaml", "samples/constraint.yaml")]
    docs[1]["spec"]["match"] = {}  # the labels constraint matches any kind
    objs = []
    for i in range(40):
        kind = "Service" if i < 20 and i % 2 else "Pod"
        o = {"apiVersion": "v1", "kind": kind,
             "metadata": {"name": f"o{i}", "namespace": "default"}}
        if kind == "Pod":
            o["spec"] = {"containers": [{"name": "c", "image": "x/y"}]}
        objs.append(o)

    def world(client_cls, driver, target):
        client = client_cls(target=target, drivers=[driver],
                            enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        for t, c in ((docs[0], docs[1]), (docs[2], docs[3])):
            client.add_template(copy.deepcopy(t))
            client.add_constraint(copy.deepcopy(c))
        return client

    got = {}
    for k in (0, 2):
        jd = TpuDriver()
        jrun = JManager(world(JClient, jd, JTarget()), lambda: iter(objs),
                        JConfig(chunk_size=2, exact_totals=False,
                                shard_chunks=k, violations_limit=3,
                                pipeline="off"),
                        evaluator=ShardedEvaluator(jd, jmake_mesh(1),
                                                   violations_limit=3)
                        ).audit()
        td = TorchDriver(device="cpu")
        trun = TManager(world(TClient, td, TTarget()), lambda: iter(objs),
                        TConfig(chunk_size=2, exact_totals=False,
                                shard_chunks=k, violations_limit=3),
                        evaluator=SweepEvaluator(td, device="cpu",
                                                 violations_limit=3,
                                                 mesh=_cpu_mesh(2))
                        ).audit()
        assert _summary(trun) == _summary(jrun)
        got[k] = _summary(trun)
    assert got[0][1] == got[2][1]  # totals
    key = ("K8sRequiredLabels", "all-must-have-owner")
    assert [v[2] for v in got[0][2][key]] == ["default/o0", "default/o2",
                                              "default/o1"]
    assert [v[2] for v in got[2][2][key]] == ["default/o0", "default/o2",
                                              "default/o4"]


def test_pipelined_schedule_on_a_mesh(objects, jax_world):
    run, _ev, mgr = _port(objects, "reduced", True, 2, shard_chunks=2,
                          pipeline="on")
    assert mgr.perf.get("pipelined") == 1.0
    assert _summary(run) == _jax(jax_world, objects, True, 1)


@pytest.mark.parametrize("shard_chunks", [0, 2, 4])
def test_snapshot_step_on_a_mesh(objects, jax_world, monkeypatch,
                                 shard_chunks):
    """A snapshot's first pass over a 2-shard mesh with residency on: the
    residency declines the mesh (logged once), the host-column lane
    serves, and the verdicts equal the JAX relist."""
    logged = []
    monkeypatch.setattr(residency_mod, "log_event",
                        lambda *a, **kw: logged.append((a, kw)))
    client, driver = _port_client(objects)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        mesh=_cpu_mesh(2))
    cluster = FakeCluster()
    for o in objects:
        cluster.apply(copy.deepcopy(o))
    snap = ClusterSnapshot(ev, SnapshotConfig())
    res = DeviceResidency(ev, mode="on")
    mgr = TManager(client, lambda: iter(cluster.list()),
                   TConfig(audit_source="snapshot", chunk_size=CHUNK,
                           exact_totals=False, shard_chunks=shard_chunks),
                   evaluator=ev, snapshot=snap, residency=res)
    ing = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
    try:
        run = mgr.audit()
    finally:
        ing.stop()
    assert _summary(run) == _jax(jax_world, objects, False, 1)
    assert res.upload_count == 0 and not res.available()
    reasons = [kw.get("reason") for _a, kw in logged
               if kw.get("event_type") == "residency_fallback"]
    assert reasons == ["multi-device mesh (resident gather is "
                       "single-device)"]


def test_make_mesh_shapes_and_errors():
    m = make_mesh(device="cpu", devices=["cpu"] * 4)
    assert m.size == 4 and m.shape == {"data": 4, "model": 1}
    assert [i for i, _d in m.local] == [0, 1, 2, 3]
    assert make_mesh(2, device="cpu", devices=["cpu"] * 4).size == 2
    assert make_mesh(device="cpu", devices=["cpu"] * 4,
                     model_parallel=2).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="not divisible by mp=3"):
        make_mesh(device="cpu", devices=["cpu"] * 4, model_parallel=3)
    with pytest.raises(ValueError, match="model_parallel"):
        SweepEvaluator(None, device="cpu",
                       mesh=make_mesh(device="cpu", devices=["cpu"] * 2,
                                      model_parallel=2))
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="holds no shard"):
        Mesh([(1, "cpu")], rank=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            make_mesh()
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            make_mesh(devices=["cuda:0"])


def test_pad_and_spans_split_on_byte_boundaries():
    ev = SweepEvaluator(None, device="cpu", mesh=_cpu_mesh(3))
    assert [ev._pad(n) for n in (1, 24, 25, 100)] == [24, 24, 48, 192]
    assert ev._spans(48) == [(0, 0, 16, torch.device("cpu")),
                             (1, 16, 32, torch.device("cpu")),
                             (2, 32, 48, torch.device("cpu"))]
    one = SweepEvaluator(None, device="cpu")
    assert one.mesh.size == 1 and [one._pad(n) for n in (1, 9)] == [8, 16]


def test_merged_masks_lane_keeps_the_lowest_first_k():
    """The host merge of per-shard first-k: shard order, then index
    order, the first k valid slots kept, totals summed."""
    ev = SweepEvaluator(None, device="cpu", violations_limit=3,
                        mesh=_cpu_mesh(2))
    # C=2 over pad_n=32 (16 rows a shard); row 0 hits 14, 15 | 16, 20;
    # row 1 only in shard 1 at 17
    s0 = np.array([[14, 15, 0, 1, 1, 0, 2], [0, 0, 0, 0, 0, 0, 0]],
                  np.int32)
    s1 = np.array([[0, 4, 0, 1, 1, 0, 2], [1, 0, 0, 1, 0, 0, 1]],
                  np.int32)
    packed, bits = ev._merge_masks([[s0], [s1]], 32, False)
    assert bits is None
    assert packed.tolist() == [[14, 15, 16, 1, 1, 1, 4],
                               [17, 0, 0, 1, 0, 0, 1]]
