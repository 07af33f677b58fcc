"""The port's resident snapshot (gatekeeper_tpu_torch/snapshot/ over
audit/manager.py's snapshot lane and parallel/sweep.py's resident lane, on
the CPU) against the JAX package's snapshot lane.

One corpus on both sides: the first 6 library templates plus both CEL
ones, ``make_cluster_objects(300, seed=7)``, a ``FakeCluster`` per package
fed the same churn, chunks of 48 (the groups span several chunks).  Three
managers walk the same steps — a full pass, a clean tick, a second full
pass, label churn on 7 rows, a delete, a re-add of the deleted key,
appends that grow a group's capacity, deletes that compact it:

- JAX: ``ShardedEvaluator(make_mesh(1))`` with ``DeviceResidency("on")``;
- the port, resident: ``SweepEvaluator(device="cpu")`` with
  ``DeviceResidency(mode="on")``;
- the port, host columns: no residency.

After every step the totals and kept lists, the vocab's intern order and
every group's store rows (``row_signature``) of both port lanes must equal
JAX's exactly; the resident mask mirror must equal JAX's ``mask_host``.
Every comparison is exact."""

import copy
import glob
import os
import re
import signal
import subprocess
import sys
import threading
import time

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
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.parallel.sharded import \
    pack_transfer_cols as jpack  # noqa: E402
from gatekeeper_tpu.snapshot import ClusterSnapshot as JSnapshot  # noqa
from gatekeeper_tpu.snapshot import DeviceResidency as JResidency  # noqa
from gatekeeper_tpu.snapshot import SnapshotConfig as JSnapConfig  # noqa
from gatekeeper_tpu.snapshot import WatchIngester as JIngester  # noqa
from gatekeeper_tpu.snapshot import gvks_of as jgvks_of  # noqa: E402
from gatekeeper_tpu.snapshot import row_signature as jrow_sig  # noqa
from gatekeeper_tpu.sync.source import FakeCluster as JCluster  # noqa
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import (library_dir,  # noqa: E402
                                            make_cluster_objects)
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir.program import (pack_batch_cols,  # noqa: E402
                                             slim_cols)
from gatekeeper_tpu_torch.parallel.sweep import (  # noqa: E402
    SweepEvaluator, gather_resident, pack_transfer_cols,
    unpack_transfer_cols)
from gatekeeper_tpu_torch.snapshot import (  # noqa: E402
    ClusterSnapshot, DeviceResidency, SnapshotConfig, WatchIngester,
    concat_group_rows, gvks_of, row_signature)
from gatekeeper_tpu_torch.sync.source import FakeCluster  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_OBJECTS = 300
CHUNK = 48
KEEP = 6  # the first 6 library templates, plus both CEL ones
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
STEPS = ("audit", "tick_clean", "audit_warm", "churn7", "delete", "readd",
         "grow", "compact")


def _skip_kinds() -> tuple:
    paths = sorted(
        glob.glob(os.path.join(library_dir(), "general", "*",
                               "template.yaml")) +
        glob.glob(os.path.join(library_dir(), "pod-security-policy", "*",
                               "template.yaml")))
    kinds = [load_yaml_file(p)[0]["spec"]["crd"]["spec"]["names"]["kind"]
             for p in paths]
    keep = set(kinds[:KEEP]) | set(CEL_KINDS)
    return tuple(k for k in kinds if k not in keep)


def _jax_client():
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client, skip_kinds=_skip_kinds())
    return client, driver


def _port_client():
    cel = TCELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel)
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert tload(client, skip_kinds=_skip_kinds()) == (KEEP + 2, KEEP + 2)
    assert set(CEL_KINDS) <= set(driver.lowered_kinds())
    return client, driver


class _Lane:
    """One manager over its own cluster, snapshot and ingester."""

    def __init__(self, pkg: str, objects, residency: bool,
                 collect: str = "reduced", exact: bool = False):
        self.pkg = pkg
        if pkg == "jax":
            self.client, self.driver = _jax_client()
            self.cluster = JCluster()
            self.ev = ShardedEvaluator(self.driver, make_mesh(1),
                                       violations_limit=20,
                                       collect=collect)
            self.snap = JSnapshot(self.ev, JSnapConfig())
            self.res = JResidency(self.ev, mode="on") if residency \
                else None
            cfg = JConfig(audit_source="snapshot", chunk_size=CHUNK,
                          exact_totals=exact, pipeline="off")
            mgr_cls, ing_cls, gv = JManager, JIngester, jgvks_of
        else:
            self.client, self.driver = _port_client()
            self.cluster = FakeCluster()
            self.ev = SweepEvaluator(self.driver, device="cpu",
                                     violations_limit=20, collect=collect)
            self.snap = ClusterSnapshot(self.ev, SnapshotConfig())
            self.res = DeviceResidency(self.ev, mode="on") if residency \
                else None
            cfg = TConfig(audit_source="snapshot", chunk_size=CHUNK,
                          exact_totals=exact)
            mgr_cls, ing_cls, gv = TManager, WatchIngester, gvks_of
        for o in objects:
            self.cluster.apply(copy.deepcopy(o))
        self.mgr = mgr_cls(self.client, lambda: iter(self.cluster.list()),
                           cfg, evaluator=self.ev, snapshot=self.snap,
                           residency=self.res)
        self.ing = ing_cls(self.snap, self.cluster,
                           gv(self.cluster.list())).start()

    def pump(self):
        self.ing.pump()


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _signatures(snap, sig) -> dict:
    """{group kinds: [(gid, row signature)] over live rows}."""
    out = {}
    for store in snap._groups.values():
        if store.batch is None:
            continue
        out[tuple(sorted(store.group))] = [
            (store.gids[p], sig(store.batch, p))
            for p in store.live_positions()]
    return out


def _masks(res, snap) -> dict:
    out = {}
    for store in snap._groups.values():
        rg = res._groups.get(id(store)) if res is not None else None
        if rg is not None and rg.store is store:
            out[tuple(sorted(store.group))] = rg.mask_host.copy()
    return out


def _churn(lanes, step: str, objects, extra) -> None:
    """Apply one step's watch churn to every lane's cluster."""
    for lane in lanes:
        cl = lane.cluster
        if step == "churn7":
            for j in range(7):
                o = copy.deepcopy(objects[j])
                o.setdefault("metadata", {}).setdefault(
                    "labels", {})["churn"] = "r1"
                cl.apply(o)
        elif step == "delete":
            cl.delete(copy.deepcopy(objects[3]))
        elif step == "readd":
            cl.apply(copy.deepcopy(objects[3]))
        elif step == "grow":
            for i, o in enumerate(extra):
                o = copy.deepcopy(o)
                o["metadata"]["name"] = f"grow-{i}"
                cl.apply(o)
        elif step == "compact":
            pods = [o for o in cl.list() if o["kind"] == "Pod"]
            for o in pods[: len(pods) // 2]:
                cl.delete(copy.deepcopy(o))
            for o in pods[len(pods) // 2: len(pods) // 2 + 5]:
                o = copy.deepcopy(o)
                o["metadata"].setdefault("labels", {})["churn"] = "r2"
                cl.apply(o)
        lane.pump()


def _step(lane, step: str):
    if step in ("audit", "audit_warm"):
        return lane.mgr.audit()
    return lane.mgr.audit_tick()


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=7)


@pytest.fixture(scope="module")
def extra_pods():
    """Pods enough to grow the Pod group's capacity past a power of two."""
    more = make_cluster_objects(700, seed=8)
    return [o for o in more if o["kind"] == "Pod"][:150]


@pytest.fixture(scope="module")
def walk(objects, extra_pods):
    """step -> {lane: recorded state} after walking every step on the JAX
    resident lane and both port lanes."""
    lanes = {"jax": _Lane("jax", objects, residency=True),
             "res": _Lane("port", objects, residency=True),
             "host": _Lane("port", objects, residency=False)}
    out = {}
    try:
        for step in STEPS:
            _churn(lanes.values(), step, objects, extra_pods)
            rec = {}
            for name, lane in lanes.items():
                up0 = lane.res.upload_count if lane.res else 0
                pa0 = lane.res.patch_count if lane.res else 0
                run = _step(lane, step)
                sig = jrow_sig if lane.pkg == "jax" else row_signature
                rec[name] = {
                    "summary": _summary(run),
                    "vocab": list(lane.driver.vocab._to_str),
                    "sigs": _signatures(lane.snap, sig),
                    "masks": _masks(lane.res, lane.snap),
                    "tick_h2d": lane.mgr.perf.get("tick_h2d_bytes"),
                    "uploads": (lane.res.upload_count - up0) if lane.res
                    else 0,
                    "patches": (lane.res.patch_count - pa0) if lane.res
                    else 0,
                    "resident_bytes": lane.res.resident_bytes()
                    if lane.res else 0,
                    "rows": lane.mgr.perf.get("last_rows_evaluated"),
                }
                if name == "res":
                    rec[name]["dev_equal"] = all(
                        torch.equal(rg.mask_dev,
                                    torch.from_numpy(rg.mask_host))
                        for rg in lane.res._groups.values())
                    rec[name]["dead_false"] = all(
                        not rg.mask_host[:, [
                            p for p in range(rg.cap)
                            if p >= rg.store.n_rows
                            or not rg.store.live[p]]].any()
                        for rg in lane.res._groups.values()
                        if rg.mutation_mark == rg.store.mutations)
                    rec[name]["host_chunks"] = lane.mgr.perf.get(
                        "snapshot_host_chunks", 0.0)
            out[step] = rec
        out["_lanes"] = lanes
        yield out
    finally:
        for lane in lanes.values():
            lane.ing.stop()


# --- (a) the JAX snapshot against the port's, step by step ----------------

@pytest.mark.parametrize("step", STEPS)
def test_snapshot_step_matches_jax(walk, step):
    rec = walk[step]
    want = rec["jax"]
    assert want["summary"][0] > 0
    for lane in ("res", "host"):
        got = rec[lane]
        assert got["summary"] == want["summary"], lane
        assert got["vocab"] == want["vocab"], lane
        assert got["sigs"] == want["sigs"], lane
    if step == "audit":
        assert sum(want["summary"][1].values()) > 0
        assert {k for (k, _n), v in want["summary"][1].items() if v} \
            >= set(CEL_KINDS)


# --- (b) resident against host columns inside the port --------------------

@pytest.mark.parametrize("step", STEPS)
def test_resident_mask_mirror_matches_jax(walk, step):
    rec = walk[step]
    got, want = rec["res"]["masks"], rec["jax"]["masks"]
    assert got.keys() == want.keys() and got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert rec["res"]["dev_equal"]
    assert rec["res"]["dead_false"]
    assert rec["res"]["host_chunks"] == 0


def test_resident_byte_counts(walk):
    res = {step: walk[step]["res"] for step in STEPS}
    assert res["audit"]["uploads"] >= 1 and res["audit"]["tick_h2d"] > 0
    # nothing dirty, nothing evaluated
    assert res["tick_clean"]["rows"] == 0
    # a second full pass over unchanged rows: every cache hits
    assert res["audit_warm"]["rows"] > 0
    assert res["audit_warm"]["tick_h2d"] == 0
    assert res["audit_warm"]["uploads"] == 0
    # the dirty tick: a scatter of the dirty rows, well under the resident
    # bytes
    churn = res["churn7"]
    assert churn["patches"] >= 1 and churn["uploads"] == 0
    assert 0 < churn["rows"] <= 7
    assert 0 < churn["tick_h2d"] < churn["resident_bytes"]
    # capacity growth and compaction move positions: full re-uploads
    assert res["grow"]["uploads"] >= 1
    assert res["compact"]["uploads"] >= 1
    assert walk["compact"]["jax"]["uploads"] == res["compact"]["uploads"]


# --- (c) both collect lanes, both resident reduced variants ---------------

@pytest.mark.parametrize("collect,exact", [
    ("reduced", False), ("masks", False), ("reduced", True),
    ("masks", True)])
def test_collect_lanes_and_exact_totals(objects, walk, collect, exact):
    """Each (collect lane, exact totals) pair on the resident lane equals
    the host-column lane with the same settings and, with exact totals
    off, the JAX walk's first two steps."""
    lanes = [_Lane("port", objects, residency=True, collect=collect,
                   exact=exact),
             _Lane("port", objects, residency=False, collect=collect,
                   exact=exact)]
    try:
        runs = [[_summary(lane.mgr.audit())] for lane in lanes]
        _churn(lanes, "churn7", objects, [])
        for lane, out in zip(lanes, runs):
            out.append(_summary(lane.mgr.audit_tick()))
    finally:
        for lane in lanes:
            lane.ing.stop()
    assert runs[0] == runs[1]
    if not exact:
        assert runs[0] == [walk["audit"]["jax"]["summary"],
                           walk["churn7"]["jax"]["summary"]]


def test_resident_reduced_variants_agree(walk):
    """The complete variant (snapshot ticks) and the budgeted one (which
    runs ``fold.fused_fold`` on the gathered chunk) against host-column
    dispatches of the same rows."""
    lane = walk["_lanes"]["res"]
    ev, snap, res = lane.ev, lane.snap, lane.res
    checked = 0
    for store in snap.routed_stores():
        rg = res.prepare(store)
        if rg is None:
            continue
        positions = store.live_positions()[:CHUNK]
        objs = [store.row_obj(p) for p in positions]
        for complete in (True, False):
            got = ev.sweep_collect(ev.sweep_dispatch(
                ev.sweep_flatten_resident(rg, positions,
                                          return_bits=complete)))
            batch = store.slice_rows(positions, ev._pad(len(positions)))
            want = ev.sweep_collect(ev.sweep_dispatch(
                ev.sweep_flatten_from_batch(store.cons, batch, objs,
                                            return_bits=complete,
                                            alias=store.alias)))
            assert got.keys() == want.keys()
            for kind in want:
                g, w = got[kind], want[kind]
                for a, b in zip(g[1:4], w[1:4]):
                    np.testing.assert_array_equal(a, b)
                if complete:
                    for ci in range(len(g[0])):
                        np.testing.assert_array_equal(g[4].rows(ci),
                                                      w[4].rows(ci))
            checked += 1
    assert checked >= 2


# --- (d) the seams -----------------------------------------------------------

def test_evict_then_tick_repromotes(objects):
    lanes = [_Lane("port", objects, residency=True),
             _Lane("port", objects, residency=False)]
    try:
        for lane in lanes:
            lane.mgr.audit()
        res = lanes[0].res
        assert res.evict_all("test") >= 1 and res.resident_bytes() == 0
        uploads = res.upload_count
        _churn(lanes, "churn7", objects, [])
        a, b = (_summary(lane.mgr.audit_tick()) for lane in lanes)
        assert a == b
        assert res.upload_count > uploads and res.resident_bytes() > 0
        assert lanes[0].mgr.perf.get("snapshot_host_chunks", 0) == 0
    finally:
        for lane in lanes:
            lane.ing.stop()


def test_added_constraint_rechunks_without_relist(objects):
    lane = _Lane("port", objects, residency=True)
    try:
        lane.mgr.audit()
        relists = []
        lister = lane.mgr.lister
        lane.mgr.lister = lambda: relists.append(1) or lister()
        uploads = lane.res.upload_count
        gen = lane.snap.generation
        orig = next(c for c in lane.client.constraints()
                    if c.kind == "K8sNoPrivileged")
        con = copy.deepcopy(orig.raw)
        con["metadata"]["name"] = "no-privileged-2"
        lane.client.add_constraint(con)
        run = lane.mgr.audit_tick()
        assert lane.snap.rechunk_count == 1 and not relists
        assert lane.snap.generation == gen + 1
        assert lane.res.upload_count > uploads  # mirror rebuilt
        assert lane.mgr.perf.get("snapshot_host_chunks", 0) == 0
        key = ("K8sNoPrivileged", "no-privileged-2")
        assert run.total_violations[key] > 0
        assert run.total_violations[key] == \
            run.total_violations[orig.key()]
        lane.mgr.lister = lister
        lane.mgr.audit_resync()
        assert lane.mgr.last_resync_diff is None
    finally:
        lane.ing.stop()


def test_resync_clean_then_catches_corruption(objects):
    lane = _Lane("port", objects, residency=True)
    try:
        lane.mgr.audit()
        _churn([lane], "churn7", objects, [])
        run = lane.mgr.audit_resync()
        assert lane.mgr.last_resync_diff is None and not run.incomplete
        store = max(lane.snap.routed_stores(), key=lambda s: s.n_rows)
        pos = store.live_positions()[0]
        store.batch.name_sid[pos] = store.batch.name_sid[pos] + 1
        run = lane.mgr.audit_resync()
        assert lane.mgr.last_resync_diff is not None
        assert "columns differ" in lane.mgr.last_resync_diff
        assert run.incomplete and lane.snap.stale
    finally:
        lane.ing.stop()


def test_rotated_resync_covers_every_row(objects):
    """``resync_rotate=K``: each resync proves one key-hash slice; a
    corrupted row is caught by the resync whose slice holds it."""
    lane = _Lane("port", objects, residency=True)
    try:
        lane.mgr.config.resync_rotate = 2
        lane.mgr.audit()
        for _ in range(2):
            lane.mgr.audit_resync()
            assert lane.mgr.last_resync_diff is None
        store = max(lane.snap.routed_stores(), key=lambda s: s.n_rows)
        store.batch.name_sid[store.live_positions()[0]] += 1
        diffs = []
        for _ in range(2):
            lane.mgr.audit_resync()
            diffs.append(lane.mgr.last_resync_diff)
        assert sum(d is not None for d in diffs) == 1
    finally:
        lane.ing.stop()


def test_concat_group_rows_equals_slice(walk):
    """Two segments of one store concatenate to the slice of their rows."""
    lane = walk["_lanes"]["host"]
    store = max(lane.snap.routed_stores(), key=lambda s: s.n_rows)
    pos = store.live_positions()[:40]
    got = concat_group_rows([(store, pos[:15]), (store, pos[15:])], 64)
    want = store.slice_rows(pos, 64)
    for i in range(len(pos)):
        assert row_signature(got, i) == row_signature(want, i)
    gcols, wcols = pack_batch_cols(got), pack_batch_cols(want)
    assert gcols.keys() == wcols.keys()


def test_residency_modes(walk):
    lane = walk["_lanes"]["host"]
    auto = DeviceResidency(lane.ev, mode="auto")
    assert not auto.available()  # a CPU evaluator declines
    assert all(auto.prepare(s) is None for s in lane.snap.routed_stores())
    assert not DeviceResidency(lane.ev, mode="off").available()
    assert DeviceResidency(lane.ev, mode="on").available()
    with pytest.raises(ValueError):
        DeviceResidency(lane.ev, mode="bogus")


def test_pack_transfer_cols_layout_and_aliases(walk):
    """The stats-free layout equals the JAX package's on the same columns;
    unpacking views the buffers, an alias is the same tensor, and empty
    stats pack the stats-free layout, as in the JAX package."""
    lane = walk["_lanes"]["res"]
    aliased = 0
    for store in lane.snap.routed_stores():
        rg = lane.res.prepare(store)
        positions = store.live_positions()[:CHUNK]
        batch = store.slice_rows(positions, 64)
        cols = slim_cols(pack_batch_cols(batch), rg.needs)
        bufs, layout = pack_transfer_cols(cols, 64)
        jbufs, jlayout = jpack(cols, 64, stats=None)
        assert layout == jlayout
        assert bufs.keys() == jbufs.keys()
        for dt in bufs:
            np.testing.assert_array_equal(bufs[dt], jbufs[dt])
        tbufs = {dt: torch.from_numpy(b) for dt, b in bufs.items()}
        out = unpack_transfer_cols(tbufs, layout, 64)
        for key, sub, wdt, _off, _tail, _w, _dt, ref in layout:
            got = out[key] if sub is None else out[key][sub]
            want = cols[key] if sub is None else cols[key][sub]
            np.testing.assert_array_equal(got.numpy(), want)
            if wdt == "alias":
                src = out[ref[0]] if ref[1] is None else out[ref[0]][ref[1]]
                assert got is src
                aliased += 1
            else:
                assert got.data_ptr() >= tbufs[wdt].data_ptr()  # a view
        ebufs, elayout = pack_transfer_cols(cols, 64, stats={})
        assert elayout == layout == jpack(cols, 64, stats={})[1]
        for dt in bufs:
            np.testing.assert_array_equal(ebufs[dt], bufs[dt])
    assert aliased > 0


def test_gather_resident_masks_out_pad_slots():
    """Pad slots (index -1) gather row 0 under a False mask column, so a
    match of row 0 never counts twice."""
    col = np.arange(8, dtype=np.int32).reshape(4, 2)
    bufs, layout = pack_transfer_cols({"c": {"sid": col}}, 4)
    dev = {dt: torch.from_numpy(b) for dt, b in bufs.items()}
    mask = torch.ones((3, 4), dtype=torch.bool)
    idx = torch.tensor([2, 0, -1, -1], dtype=torch.int32)
    cols, got = gather_resident(idx, dev, mask, layout, 4)
    np.testing.assert_array_equal(cols["c"]["sid"].numpy(),
                                  col[[2, 0, 0, 0]])
    assert got.tolist() == [[True, True, False, False]] * 3


# --- (e) the CLI ------------------------------------------------------------

def _manifest_dir(tmp_path):
    lib = os.path.join(ROOT, "library", "general")
    docs = []
    for name in ("requiredlabels", "allowedrepos", "containerlimits",
                 "containerlimitscel", "noprivileged"):
        for f in ("template.yaml", "samples/constraint.yaml",
                  "samples/example_allowed.yaml",
                  "samples/example_disallowed.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                docs.append(fh.read())
    for i, doc in enumerate(docs):
        (tmp_path / f"{i:02d}.yaml").write_text(doc)
    return tmp_path


def test_cli_snapshot_once_matches_relist(tmp_path):
    _manifest_dir(tmp_path)
    outs = {}
    for source, extra in (("relist", []), ("snapshot", []),
                          ("snapshot", ["--snapshot-residency", "on",
                                        "--collect", "masks"])):
        p = subprocess.run(
            [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
             str(tmp_path), "--once", "--device", "cpu", "--audit-source",
             source, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        assert m, p.stderr
        outs[(source, bool(extra))] = (p.stdout, m.groups())
        if source == "snapshot":
            assert "resident snapshot active" in p.stderr
    want = outs[("relist", False)]
    assert want[0].count("\n") >= 5 and int(want[1][1]) > 0
    assert outs[("snapshot", False)] == want
    assert outs[("snapshot", True)] == want


def _lines_until(stream, needle: str, timeout_s: float) -> list:
    """Lines of ``stream`` read on a thread until one holds ``needle``;
    fails with the lines seen so far if none does within ``timeout_s``."""
    seen: list = []
    found = threading.Event()

    def read():
        for line in stream:
            seen.append(line)
            if needle in line:
                found.set()
                return

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(timeout_s):
        pytest.fail(f"no {needle!r} line within {timeout_s:.0f}s; "
                    f"stderr so far: {''.join(seen)}")
    return seen


def test_cli_serves_snapshot_audit_loop(tmp_path):
    """Served snapshot mode runs the audit loop beside the webhook: a
    first pass builds the snapshot, ticks and a clean resync follow, and
    SIGTERM stops both and drains."""
    _manifest_dir(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(tmp_path), "--port", "0", "--device", "cpu",
         "--audit-source", "snapshot", "--snapshot-residency", "on",
         "--audit-interval", "0.2", "--snapshot-resync-every", "2"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        seen = _lines_until(proc.stderr, "snapshot_resync_clean", 120)
        assert any("webhook serving on" in ln for ln in seen), seen
        assert any("snapshot_rebuilt" in ln for ln in seen), seen
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "drain complete" in err
        assert "snapshot_resync_diverged" not in "".join(seen) + err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# --- the served process's two threads -----------------------------------

def _admission_body(obj: dict, uid: str) -> dict:
    api = obj.get("apiVersion", "")
    group, _, version = api.rpartition("/")
    meta = obj.get("metadata") or {}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {
                "uid": uid, "operation": "CREATE",
                "kind": {"group": group, "version": version,
                         "kind": obj.get("kind", "")},
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", ""),
                "userInfo": {"username": "alice"},
                "object": obj}}


def _answer(v) -> tuple:
    # the grid lane lists deny lines by kind: compare them as a set
    return v.allowed, v.code, sorted(v.message.split("\n")), \
        sorted(v.warnings)


def _churned(objects, j: int) -> dict:
    o = copy.deepcopy(objects[10 + j])
    o["metadata"].setdefault("labels", {})["churn"] = f"loop-{j}"
    return o


def _serve_round(objects, bodies, concurrent: bool) -> dict:
    """One port lane that audits its snapshot and answers ``bodies``
    through the webhook handler and its batcher, with the same label churn
    on 24 rows: either as the served CLI runs them (the audit loop on its
    thread, started by ``start_audit_loop``, beside 4 admission threads
    while the churn lands) or one step after another on one thread."""
    from gatekeeper_tpu_torch.__main__ import start_audit_loop
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)

    lane = _Lane("port", objects, residency=True)
    answers = [None] * len(bodies)
    passes = {"tick": 0, "resync": 0}
    diffs = []  # each resync's first difference during the loop
    try:
        lane.mgr.audit()
        batcher = Batcher(lane.client, small_batch=0).start()
        handler = ValidationHandler(lane.client, batcher=batcher)
        try:
            if not concurrent:
                for j in range(24):
                    lane.cluster.apply(_churned(objects, j))
                lane.mgr.audit_tick()
                for i, body in enumerate(bodies):
                    answers[i] = _answer(handler.handle(copy.deepcopy(body)))
            else:
                assert lane.driver.vocab._lock is None
                for name in passes:
                    fn = getattr(lane.mgr, f"audit_{name}")

                    def counted(fn=fn, name=name):
                        passes[name] += 1
                        run = fn()
                        if name == "resync":
                            diffs.append(lane.mgr.last_resync_diff)
                        return run

                    setattr(lane.mgr, f"audit_{name}", counted)
                lane.mgr.config.interval_s = 0.01
                lane.mgr.config.resync_every = 4
                switch = sys.getswitchinterval()
                sys.setswitchinterval(1e-5)  # interleave the threads finely
                try:
                    loop = start_audit_loop(lane.mgr)
                    assert lane.driver.vocab._lock is not None

                    def client(part):
                        for i in part:
                            answers[i] = _answer(
                                handler.handle(copy.deepcopy(bodies[i])))

                    clients = [threading.Thread(
                        target=client, args=(range(c, len(bodies), 4),))
                        for c in range(4)]
                    for t in clients:
                        t.start()
                    for j in range(24):
                        lane.cluster.apply(_churned(objects, j))
                        time.sleep(0.01)
                    for t in clients:
                        t.join(timeout=300)
                        assert not t.is_alive()
                    during = dict(passes)
                    lane.mgr.stop()
                    loop.join(timeout=300)
                    assert not loop.is_alive()
                finally:
                    sys.setswitchinterval(switch)
                assert during["tick"] >= 2 and during["resync"] >= 1, during
                lane.mgr.audit_tick()  # what the loop had not pumped yet
        finally:
            batcher.stop()
        run = lane.mgr.audit()
        lane.mgr.audit_resync()
        vocab = lane.driver.vocab
        return {"answers": answers, "summary": _summary(run),
                "strings": list(vocab._to_str), "ids": dict(vocab._to_id),
                "resync_diff": lane.mgr.last_resync_diff,
                "loop_diffs": diffs}
    finally:
        lane.ing.stop()


class _YieldingDict(dict):
    """A vocab ``_to_id`` that sleeps inside every insert, between an
    intern's choice of the new id and its append: without the vocab's
    lock another thread's intern lands in that gap."""

    def __setitem__(self, key, value):
        time.sleep(0.0002)
        super().__setitem__(key, value)


def test_armed_vocab_lock_keeps_interns_a_bijection(walk):
    """Python interns from three threads and a native columnizer flatten
    from a fourth, into one vocab whose lock is armed as
    ``start_audit_loop`` arms it, with a thread switch forced inside
    every intern: every string gets one id and every id one string."""
    from gatekeeper_tpu_torch.ops.flatten import Flattener, Vocab

    vocab = Vocab()
    vocab._to_id = _YieldingDict(vocab._to_id)
    vocab._lock = threading.RLock()
    store = max(walk["_lanes"]["host"].snap.routed_stores(),
                key=lambda s: s.n_rows)
    fl = Flattener(store.schema, vocab)
    rows = [store.row_obj(p) for p in store.live_positions()[:40]]

    def interns(t):
        for i in range(150):
            vocab.intern(f"t{t}-{i}")

    def flattens():
        for _ in range(5):
            fl.flatten(copy.deepcopy(rows))

    threads = [threading.Thread(target=interns, args=(t,))
               for t in range(3)] + [threading.Thread(target=flattens)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    strings = vocab._to_str
    assert len(set(strings)) == len(strings) == len(vocab._to_id)
    assert all(vocab._to_id[s] == i for i, s in enumerate(strings))
    assert {f"t{t}-{i}" for t in range(3) for i in range(150)} <= \
        set(strings)


def test_audit_loop_beside_admissions_matches_serial(objects):
    """The served process's audit thread and the webhook's batcher thread
    intern into one vocab: with the audit loop ticking (and resyncing)
    while admissions and churn arrive, every answer, the final audit and
    the vocab's string set equal a one-thread run of the same work, and
    the vocab stays a bijection (no id given to two strings); no resync
    of the loop mistakes an admission's new strings for its own."""
    more = make_cluster_objects(200, seed=11)
    bodies = []
    for i, o in enumerate(more[:96]):
        o = copy.deepcopy(o)
        o["metadata"]["name"] = f"adm-{i}"
        o["metadata"].setdefault("labels", {})["adm"] = f"v{i}"
        bodies.append(_admission_body(o, f"uid-{i}"))
    serial = _serve_round(objects, bodies, concurrent=False)
    served = _serve_round(objects, bodies, concurrent=True)
    assert None not in served["answers"]
    assert served["answers"] == serial["answers"]
    assert any(not a[0] for a in serial["answers"])
    assert served["summary"] == serial["summary"]
    for rec in (serial, served):
        strings = rec["strings"]
        assert len(rec["ids"]) == len(strings)
        assert all(rec["ids"][s] == i for i, s in enumerate(strings))
        assert rec["resync_diff"] is None
    assert set(served["strings"]) == set(serial["strings"])
    # the admissions' interns never read as the resync's own
    assert not [d for d in served["loop_diffs"] if d and "vocab" in d]
    assert {f"adm-{i}" for i in range(len(bodies))} <= set(served["strings"])
