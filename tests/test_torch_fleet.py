"""Fleet mode in the port (gatekeeper_tpu_torch/fleet/) against the JAX
package's (gatekeeper_tpu/fleet/), on the CPU (the port's plain fold
versions).

One module-scoped story runs in both packages over the same roster: four
clusters (a and b share a 5-template library slice, c runs a subset of it,
d a disjoint slice), a packed fleet pass over every row, independent
per-cluster references, per-cluster spills and a restart.  Tolerance:
exact equality throughout — per-cluster totals, kept (constraint, kind,
namespace/name, message) lists and verdict-store row ids equal the JAX
fleet's and the port's own independent sweeps; dispatch counts, shared
boots and compile-cache hits equal the JAX fleet's.  The last case runs
``python -m gatekeeper_tpu_torch --fleet-config F --once --device cpu``
beside the JAX CLI over a 4-cluster roster on disk."""

from __future__ import annotations

import copy
import glob
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import gatekeeper_tpu.drivers.tpu_driver as JTD  # noqa: E402
import gatekeeper_tpu_torch.drivers.torch_driver as TTD  # noqa: E402
from gatekeeper_tpu.apis.constraints import AUDIT_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.generation import \
    CompileCache as JCompileCache  # noqa: E402
from gatekeeper_tpu.fleet import FleetEvaluator as JFleet  # noqa: E402
from gatekeeper_tpu.fleet import load_fleet_config as jload_cfg  # noqa
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.sync.source import FakeCluster as JFake  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa
from gatekeeper_tpu_torch.audit.manager import (AuditConfig,  # noqa: E402
                                                AuditManager)
from gatekeeper_tpu_torch.client.client import Client  # noqa: E402
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.generation import \
    CompileCache  # noqa: E402
from gatekeeper_tpu_torch.fleet import (FleetEvaluator,  # noqa: E402
                                        check_cluster_id, load_fleet_config)
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,  # noqa: E402
                                           SnapshotConfig, SnapshotSpill,
                                           templates_digest)
from gatekeeper_tpu_torch.snapshot.persist import MISS_CLUSTER  # noqa
from gatekeeper_tpu_torch.sync.source import FakeCluster  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import (library_dir,  # noqa
                                                  load_library)
from gatekeeper_tpu_torch.utils.unstructured import \
    load_yaml_file  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
_KEEP = 5  # library-A slice: a bounded lowering wall
SIZES = {"a": (48, 1), "b": (48, 7), "c": (32, 3), "d": (24, 5)}


def _all_kinds():
    paths = sorted(
        glob.glob(os.path.join(library_dir(), "general", "*",
                               "template.yaml")) +
        glob.glob(os.path.join(library_dir(), "pod-security-policy", "*",
                               "template.yaml")))
    return [load_yaml_file(p)[0]["spec"]["crd"]["spec"]["names"]["kind"]
            for p in paths]


def _skips():
    kinds = _all_kinds()
    return {"libA": tuple(kinds[_KEEP:]),            # templates 0..4
            "libC": tuple(kinds[3:]),                # 0..2 (overlap A)
            "libD": tuple(kinds[:_KEEP] + kinds[8:])}  # 5..7 (disjoint)


def _port_builder(cache_dir, skip):
    def build():
        cel = CELDriver()
        driver = TTD.TorchDriver(device="cpu", cel_driver=cel,
                                 compile_cache=CompileCache(str(cache_dir)))
        client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                        enforcement_points=[AUDIT_EP])
        load_library(client, skip_kinds=skip)
        ev = SweepEvaluator(driver, device="cpu", violations_limit=20)
        return client, driver, ev

    return build


def _jax_builder(cache_dir, skip):
    def build():
        cel = JCELDriver()
        tpu = JTD.TpuDriver(cel_driver=cel,
                            compile_cache=JCompileCache(str(cache_dir)))
        client = JClient(target=JTarget(), drivers=[tpu, cel],
                         enforcement_points=[AUDIT_EP])
        jload(client, skip_kinds=skip)
        ev = ShardedEvaluator(tpu, make_mesh(1), violations_limit=20)
        return client, tpu, ev

    return build


def _source(cls, n, seed):
    src = cls()
    for o in make_cluster_objects(n, seed=seed):
        src.apply(copy.deepcopy(o))
    return src


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _gids(fc, run):
    return {ck: [g for g, _c, _m in fc.snapshot.verdicts.rows(ck)]
            for ck in run.total_violations}


def _story(tmp, fleet_cls, builder, source_cls, manager_cls, config_cls,
           snapshot_cls, snapshot_config_cls, lowers_mod):
    """The fleet story of tests/test_fleet.py in one package: returns a
    dict of what the tests compare."""
    cache_dir = tmp / "cache"
    spill_root = tmp / "spill"
    skips = _skips()
    lowers = [0]
    orig = lowers_mod.lower_template

    def counting(*a, **k):
        lowers[0] += 1
        return orig(*a, **k)

    lowers_mod.lower_template = counting
    try:
        fleet = fleet_cls(chunk_size=64, exact_totals=False,
                          spill_root=str(spill_root))
        sources = {cid: _source(source_cls, n, seed)
                   for cid, (n, seed) in SIZES.items()}
        fleet.add_cluster("a", sources["a"], "libA",
                          builder(cache_dir, skips["libA"]))
        fleet.sweep(full=True)  # warm library A at the 48-row geometry
        low0 = lowers[0]
        fcb = fleet.add_cluster("b", sources["b"], "libA",
                                builder(cache_dir, skips["libA"]))
        run_b_first = fcb.sweep_independent(full=True)
        second = {"lowers_delta": lowers[0] - low0,
                  "shared_boots": fleet.shared_boots,
                  "same_runtime": fcb.runtime is
                  fleet.clusters["a"].runtime,
                  "first_objects": run_b_first.total_objects}
        low1 = lowers[0]
        fcc = fleet.add_cluster("c", sources["c"], "libC",
                                builder(cache_dir, skips["libC"]))
        subset = {"fresh_lowers": lowers[0] - low1,
                  "hits": fcc.runtime.driver._compile_cache.stats()["hits"]}
        fleet.add_cluster("d", sources["d"], "libD",
                          builder(cache_dir, skips["libD"]))
        # THE packed pass over all four clusters, every row re-dirtied
        for fc in fleet.clusters.values():
            for _store, rows in fc.snapshot.all_rows().items():
                fc.snapshot._dirty.update(g for g, _p in rows)
        d0 = {rt.key: rt.evaluator.dispatch_count
              for rt in fleet.runtimes()}
        p0, u0 = fleet.packed_dispatches, fleet.unpacked_dispatches
        packed = fleet.sweep(full=True)
        dispatches = {
            "device": sum(rt.evaluator.dispatch_count - d0[rt.key]
                          for rt in fleet.runtimes()),
            "packed": fleet.packed_dispatches - p0,
            "unpacked": fleet.unpacked_dispatches - u0}
        out = {"fleet": fleet, "sources": sources,
               "cache_dir": cache_dir, "spill_root": spill_root,
               "second": second, "subset": subset,
               "dispatches": dispatches,
               "packed": {cid: _summary(r) for cid, r in packed.items()},
               "packed_runs": packed,
               "gids": {cid: _gids(fleet.clusters[cid], r)
                        for cid, r in packed.items()},
               "statuses": {cid: dict(fc.statuses)
                            for cid, fc in fleet.clusters.items()}}
        refs, ref_gids = {}, {}
        for cid, fc in fleet.clusters.items():
            rt = fc.runtime
            snap = snapshot_cls(rt.evaluator, snapshot_config_cls())
            cfg = config_cls(audit_source="snapshot", chunk_size=64,
                             exact_totals=False)
            if hasattr(cfg, "pipeline"):
                cfg.pipeline = "off"
            run = manager_cls(rt.client, lister=fc.lister, config=cfg,
                              evaluator=rt.evaluator,
                              snapshot=snap).audit()
            refs[cid] = _summary(run)
            ref_gids[cid] = {
                ck: [g for g, _c, _m in snap.verdicts.rows(ck)]
                for ck in run.total_violations}
        out["refs"], out["ref_gids"] = refs, ref_gids
        fleet.spill_all()
        return out
    finally:
        lowers_mod.lower_template = orig


@pytest.fixture(scope="module")
def port_ctx(tmp_path_factory):
    ctx = _story(tmp_path_factory.mktemp("port-fleet"), FleetEvaluator,
                 _port_builder, FakeCluster, AuditManager, AuditConfig,
                 ClusterSnapshot, SnapshotConfig, TTD)
    yield ctx
    ctx["fleet"].stop()


@pytest.fixture(scope="module")
def jax_ctx(tmp_path_factory):
    from gatekeeper_tpu.audit.manager import AuditConfig as JConfig
    from gatekeeper_tpu.snapshot import ClusterSnapshot as JSnap
    from gatekeeper_tpu.snapshot import SnapshotConfig as JSnapCfg

    ctx = _story(tmp_path_factory.mktemp("jax-fleet"), JFleet,
                 _jax_builder, JFake, JManager, JConfig, JSnap, JSnapCfg,
                 JTD)
    yield ctx
    ctx["fleet"].stop()


def _canon(summary, limit=20):
    """(objects, totals, kept) in the order-free form the JAX package's
    canonical verdict compare uses: kept lists sorted per constraint."""
    n, totals, kept, incomplete = summary
    return n, totals, {k: sorted(v) for k, v in kept.items()}, incomplete


def test_cluster_id_validation():
    assert check_cluster_id("prod-eu.1_a") == "prod-eu.1_a"
    for bad in ("", "..", "a/b", "a b", "x\n"):
        with pytest.raises(ValueError):
            check_cluster_id(bad)


@pytest.mark.parametrize("cid", sorted(SIZES))
def test_packed_clusters_match_jax_and_independent_sweeps(port_ctx, jax_ctx,
                                                          cid):
    got = port_ctx["packed"][cid]
    assert _canon(got) == _canon(port_ctx["refs"][cid])
    assert port_ctx["gids"][cid] == port_ctx["ref_gids"][cid]
    assert _canon(got) == _canon(jax_ctx["packed"][cid])
    assert port_ctx["gids"][cid] == jax_ctx["gids"][cid]
    assert not got[3]


def test_dispatch_counts_match_jax(port_ctx, jax_ctx):
    assert port_ctx["dispatches"] == jax_ctx["dispatches"]
    assert port_ctx["dispatches"]["packed"] > 0
    # a+b (one runtime, 2 groups each at chunk 64) would pay 4 dispatches
    # alone; packed they share
    assert port_ctx["dispatches"]["device"] < 4 + 2 + 2


def test_statuses_are_per_cluster(port_ctx, jax_ctx):
    for cid, run in port_ctx["packed_runs"].items():
        statuses = port_ctx["statuses"][cid]
        assert statuses, f"no statuses for {cid}"
        for key, status in statuses.items():
            assert status["totalViolations"] == \
                run.total_violations.get(key, 0)
        assert {k: s["totalViolations"] for k, s in statuses.items()} == \
            {k: s["totalViolations"]
             for k, s in jax_ctx["statuses"][cid].items()}


def test_second_same_library_cluster_boots_free(port_ctx, jax_ctx):
    sc = port_ctx["second"]
    assert sc["same_runtime"]
    assert sc["lowers_delta"] == 0, "second cluster paid a lowering"
    assert sc["first_objects"] == 48
    assert sc == jax_ctx["second"]


def test_overlapping_library_shares_disk_cache(port_ctx, jax_ctx):
    assert port_ctx["subset"]["fresh_lowers"] == 0
    assert port_ctx["subset"]["hits"] >= 3
    assert port_ctx["subset"] == jax_ctx["subset"]


def test_spill_restart_warm(port_ctx):
    """A restarted two-cluster fleet boots from the spills (zero rows
    evaluated on the first pass) with the packed sweep's verdicts."""
    spill_root = str(port_ctx["spill_root"])
    assert sorted(os.listdir(spill_root)) == ["a", "b", "c", "d"]
    fleet2 = FleetEvaluator(chunk_size=64, exact_totals=False,
                            spill_root=spill_root)
    skip = _skips()["libA"]
    try:
        for cid in ("a", "b"):
            fleet2.add_cluster(cid, port_ctx["sources"][cid], "libA",
                               _port_builder(port_ctx["cache_dir"], skip))
        fa, fb = fleet2.clusters["a"], fleet2.clusters["b"]
        assert fa.warm_booted and fb.warm_booted
        runs = fleet2.sweep(full=None)
        for cid, fc in (("a", fa), ("b", fb)):
            assert fc.manager.perf.get("snapshot_rows_evaluated", 0) == 0
            assert _canon(_summary(runs[cid])) == \
                _canon(port_ctx["packed"][cid])
    finally:
        fleet2.stop()


def test_warm_root_round_trip(port_ctx, tmp_path):
    """``warm_root``: save_warm_all() persists each runtime's warm state
    (the sweep's hit-buffer sizing) and a fresh fleet's runtime replays it
    at build time."""
    warm_root = str(tmp_path / "warm")
    skip = _skips()["libA"]
    fleet1 = FleetEvaluator(chunk_size=64, exact_totals=False,
                            warm_root=warm_root)
    try:
        fleet1.add_cluster("wa", _source(FakeCluster, 24, 17), "libA",
                           _port_builder(port_ctx["cache_dir"], skip))
        rt1 = fleet1.clusters["wa"].runtime
        assert rt1.warm_cache is not None
        assert not rt1.warm_replayed["hit"]  # nothing persisted yet
        first = fleet1.sweep(full=True)["wa"]
        states = dict(rt1.evaluator.warm_state()["hit_state"])
        assert states
        assert fleet1.save_warm_all() == 1
    finally:
        fleet1.stop()
    fleet2 = FleetEvaluator(chunk_size=64, exact_totals=False,
                            warm_root=warm_root)
    try:
        fleet2.add_cluster("wa", _source(FakeCluster, 24, 17), "libA",
                           _port_builder(port_ctx["cache_dir"], skip))
        rt2 = fleet2.clusters["wa"].runtime
        assert rt2.warm_replayed["hit"]
        assert rt2.warm_replayed["hit_states"] == len(states)
        assert rt2.evaluator.warm_state()["hit_state"] == states
        again = fleet2.sweep(full=True)["wa"]
        assert _canon(_summary(again)) == _canon(_summary(first))
    finally:
        fleet2.stop()


def test_spill_cluster_mismatch_counted_not_deleted(port_ctx):
    """Pointing cluster x at b's spill dir: a counted ``cluster`` miss and
    a clean relist; the foreign spill survives untouched."""
    fleet = port_ctx["fleet"]
    rt = fleet.clusters["b"].runtime
    root = str(port_ctx["spill_root"])
    spill = SnapshotSpill(os.path.join(root, "b"), cluster_id="x")
    snap = ClusterSnapshot(rt.evaluator, SnapshotConfig())
    out = spill.load(snap, rt.audit_constraints(),
                     templates=templates_digest(rt.client))
    assert out is None
    assert spill.miss_reasons == {MISS_CLUSTER: 1}
    assert snap.stale
    assert os.path.exists(os.path.join(root, "b", "snapshot.json"))


def test_fleet_config_round_trip(tmp_path):
    p = tmp_path / "clusters.json"
    p.write_text(json.dumps({
        "clusters": [{"id": "a", "manifests": ["ma"]},
                     {"id": "b", "manifests": ["mb"]}],
        "packChunks": 3}))
    cfg, jcfg = load_fleet_config(str(p)), jload_cfg(str(p))
    assert [(c.cluster_id, c.manifests) for c in cfg.clusters] == \
        [(c.cluster_id, c.manifests) for c in jcfg.clusters] == \
        [("a", ["ma"]), ("b", ["mb"])]
    assert cfg.pack_chunks == jcfg.pack_chunks == 3
    for bad in ({"clusters": [{"id": "a"}, {"id": "a"}]}, {"clusters": []},
                {"clusters": [{"id": "a/b"}]}):
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError):
            load_fleet_config(str(p))
        with pytest.raises(ValueError):
            jload_cfg(str(p))


def _roster(tmp_path) -> str:
    """Four cluster dirs (library slices + synthetic objects) and the
    roster naming them."""
    skips = _skips()
    libs = {"a": "libA", "b": "libA", "c": "libC", "d": "libD"}
    roster = {"clusters": []}
    for cid, (n, seed) in SIZES.items():
        d = tmp_path / cid
        d.mkdir()
        for path in sorted(glob.glob(os.path.join(
                library_dir(), "*", "*", "template.yaml"))):
            tdoc = load_yaml_file(path)[0]
            kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
            if kind not in _all_kinds() or kind in skips[libs[cid]]:
                continue
            name = os.path.basename(os.path.dirname(path))
            docs = [tdoc] + load_yaml_file(os.path.join(
                os.path.dirname(path), "samples", "constraint.yaml"))
            (d / f"{name}.yaml").write_text(
                "\n---\n".join(json.dumps(x) for x in docs))
        (d / "objects.yaml").write_text("\n---\n".join(
            json.dumps(o) for o in make_cluster_objects(n, seed=seed)))
        roster["clusters"].append({"id": cid, "manifests": [str(d)]})
    path = tmp_path / "clusters.json"
    path.write_text(json.dumps(roster))
    return str(path)


_TIMING = re.compile(r" in \d+\.\d+s|, \d+\.\d+s$")


def _cli(module, roster, extra=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--fleet-config", roster, "--once",
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    lines = [_TIMING.sub("", ln) for ln in proc.stderr.splitlines()
             if ln.startswith(("cluster ", "fleet"))]
    return proc.returncode, proc.stdout, lines


def test_fleet_cli_prints_the_jax_cli_lines(tmp_path):
    roster = _roster(tmp_path)
    rc, out, lines = _cli("gatekeeper_tpu_torch", roster,
                          ("--device", "cpu"))
    jrc, jout, jlines = _cli("gatekeeper_tpu", roster)
    assert rc == jrc == 0
    assert out == jout
    assert lines == jlines
    assert sum(ln.startswith("fleet audit [") for ln in lines) == 4
    assert any("shared runtime" in ln for ln in lines)
