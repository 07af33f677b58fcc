"""The port's snapshot spill (gatekeeper_tpu_torch/snapshot/persist.py and
the spill surface of snapshot/store.py, on the CPU) against the JAX
package's.

One world on both sides: four library templates (three Rego, the CEL
``K8sNoPrivileged``) with their sample constraints over
``make_cluster_objects(300, seed=13)`` in a ``FakeCluster``, audited
through the resident snapshot (chunks of 64).  Each package takes a first
pass, spills it, loads the spill into a fresh snapshot and ticks: totals
and kept violations must equal the first pass's and the other package's,
and the tick must evaluate no row.  Further cases: the ``zlib`` codec,
delta spills (only the dirtied group is rewritten), torn, corrupt,
plan-drifted, schema-drifted and version-drifted spills (rejected,
deleted, rebuilt by a relist), the extdata section with its remaining
TTLs, the residency's whole upload of an adopted group, a spill the JAX
package wrote (a ``version`` miss that imports nothing of it), the
background spiller, the audit manager's hooks and the CLI."""

import copy
import glob
import hashlib
import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.extdata.lane import ExtDataLane as JExtLane  # noqa
from gatekeeper_tpu.externaldata.providers import \
    ProviderCache as JProviderCache  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.snapshot import ClusterSnapshot as JSnapshot  # noqa
from gatekeeper_tpu.snapshot import DeviceResidency as JResidency  # noqa
from gatekeeper_tpu.snapshot import SnapshotConfig as JSnapConfig  # noqa
from gatekeeper_tpu.snapshot import SnapshotSpill as JSpill  # noqa: E402
from gatekeeper_tpu.snapshot import WatchIngester as JIngester  # noqa
from gatekeeper_tpu.snapshot import gvks_of as jgvks_of  # noqa: E402
from gatekeeper_tpu.snapshot import \
    templates_digest as jtemplates_digest  # noqa: E402
from gatekeeper_tpu.sync.source import FakeCluster as JCluster  # noqa
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.extdata.lane import ExtDataLane  # noqa: E402
from gatekeeper_tpu_torch.externaldata.providers import \
    ProviderCache  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.snapshot import (  # noqa: E402
    ClusterSnapshot, DeviceResidency, SnapshotConfig, SnapshotSpill,
    SnapshotSpiller, WatchIngester, gvks_of, templates_digest)
from gatekeeper_tpu_torch.sync.source import FakeCluster  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
LIB = os.path.join(ROOT, "library")
TEMPLATES = ("general/requiredlabels", "general/allowedrepos",
             "general/containerlimits", "general/noprivileged")
N_OBJECTS = 300
CHUNK = 64


def _docs():
    out = []
    for rel in TEMPLATES:
        d = os.path.join(LIB, rel)
        out.append((load_yaml_file(os.path.join(d, "template.yaml"))[0],
                    load_yaml_file(os.path.join(d, "samples",
                                                "constraint.yaml"))[0]))
    return out


DOCS = _docs()


def _edited_docs():
    """The set with allowedrepos's message changed (a template edit that
    leaves the constraint spec and the lowered schemas alone)."""
    docs = copy.deepcopy(DOCS)
    tgt = docs[1][0]["spec"]["targets"][0]
    tgt["rego"] = tgt["rego"].replace("has an invalid image repo",
                                      "uses an image outside the repos")
    return docs


class _World:
    """One package's snapshot audit stack over its own cluster."""

    def __init__(self, pkg: str, objects, residency: bool = False,
                 docs=None, collect: str = "reduced"):
        self.pkg = pkg
        jax = pkg == "jax"
        cel = JCELDriver() if jax else TCELDriver()
        self.driver = (TpuDriver(cel_driver=cel) if jax else
                       TorchDriver(device="cpu", cel_driver=cel))
        self.client = (JClient if jax else TClient)(
            target=JTarget() if jax else TTarget(),
            drivers=[self.driver, cel],
            enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        for t, c in docs or DOCS:
            self.client.add_template(copy.deepcopy(t))
            self.client.add_constraint(copy.deepcopy(c))
        self.cluster = JCluster() if jax else FakeCluster()
        for o in objects:
            self.cluster.apply(copy.deepcopy(o))
        if jax:
            self.ev = ShardedEvaluator(self.driver, make_mesh(1),
                                       violations_limit=20, collect=collect)
            self.snap = JSnapshot(self.ev, JSnapConfig())
            self.res = JResidency(self.ev, mode="on") if residency else None
            cfg = JConfig(audit_source="snapshot", chunk_size=CHUNK,
                          pipeline="off")
        else:
            self.ev = SweepEvaluator(self.driver, device="cpu",
                                     violations_limit=20, collect=collect)
            self.snap = ClusterSnapshot(self.ev, SnapshotConfig())
            self.res = DeviceResidency(self.ev, mode="on") if residency \
                else None
            cfg = TConfig(audit_source="snapshot", chunk_size=CHUNK)
        self.mgr = (JManager if jax else TManager)(
            self.client, lambda: iter(self.cluster.list()), cfg,
            evaluator=self.ev, snapshot=self.snap, residency=self.res)
        self.ing = None

    def templates(self) -> str:
        return (jtemplates_digest if self.pkg == "jax"
                else templates_digest)(self.client)

    def audit_cons(self) -> list:
        return [c for c in self.client.constraints()
                if c.actions_for(AUDIT_EP)]

    def watch(self, from_rvs=None):
        ing_cls, gv = ((JIngester, jgvks_of) if self.pkg == "jax"
                       else (WatchIngester, gvks_of))
        self.ing = ing_cls(self.snap, self.cluster, gv(self.cluster.list()),
                           from_rvs=from_rvs).start()
        return self.ing

    def spill(self, root, **kw):
        return (JSpill if self.pkg == "jax" else SnapshotSpill)(
            str(root), **kw)

    def save(self, spill) -> dict:
        return spill.save(self.snap, rvs=dict(self.ing.rvs),
                          templates=self.templates())

    def load(self, spill, **kw):
        return spill.load(self.snap, self.audit_cons(),
                          templates=self.templates(), **kw)

    def close(self) -> None:
        if self.ing is not None:
            self.ing.stop()


def _summary(run):
    kept = {key: sorted((v.constraint.kind, v.kind,
                         f"{v.namespace}/{v.name}", v.message) for v in vs)
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _tick(world) -> tuple:
    """(summary, rows evaluated) of one incremental tick."""
    r0 = world.mgr.perf.get("snapshot_rows_evaluated", 0.0)
    run = world.mgr.audit_tick()
    return _summary(run), world.mgr.perf["snapshot_rows_evaluated"] - r0


def _first_pass(pkg, objects, **kw):
    w = _World(pkg, objects, **kw)
    w.watch()
    return w, _summary(w.mgr.audit())


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=13)


@pytest.fixture(scope="module")
def jax_first(objects):
    w, s = _first_pass("jax", objects)
    w.close()
    assert s[1] and sum(s[1].values()) > 10 and not s[3]
    return s


def _churn(world, objects) -> None:
    o = copy.deepcopy(next(x for x in objects if x["kind"] == "Pod"))
    o["metadata"].setdefault("labels", {})["churn"] = "after-load"
    o["spec"]["containers"][0]["securityContext"] = {"privileged": True}
    world.cluster.apply(o)
    if world.ing is not None:
        world.ing.pump()


# --- round trip against JAX -------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "zlib", "delta"])
def test_spill_round_trip_matches_jax(objects, jax_first, tmp_path, mode):
    """Both packages: first pass, spill, load into a fresh world (a hit),
    warm tick (no row evaluated), then one churned Pod and a tick: every
    summary equal across packages and the warm tick equal to the first
    pass."""
    kw = {"compress": "zlib"} if mode == "zlib" else (
        {"delta": True} if mode == "delta" else {})
    got = {}
    for pkg in ("jax", "port"):
        a, first = _first_pass(pkg, objects)
        root = tmp_path / pkg
        res = a.save(a.spill(root, **kw))
        assert res["ok"], res
        a.close()
        b = _World(pkg, objects)
        spill = b.spill(root, **kw)
        loaded = b.load(spill)
        assert loaded is not None and loaded["rows"] == N_OBJECTS
        assert spill.stats()["load_hits"] == 1
        assert b.snap.warm_loaded
        b.watch(from_rvs=loaded["rvs"])
        warm, rows = _tick(b)
        assert rows == 0
        _churn(b, objects)
        churned, rows = _tick(b)
        assert rows == 1
        b.close()
        got[pkg] = (first, warm, churned, res["bytes"])
    assert got["port"][0] == jax_first
    assert got["port"][1] == got["port"][0] == got["jax"][1]
    assert got["port"][2] == got["jax"][2] != got["port"][1]
    if mode == "zlib":
        assert got["port"][3] < 0.6 * pickle_size(tmp_path / "port")


def pickle_size(root) -> int:
    """Bytes the spill's sections would take uncompressed."""
    header = json.load(open(os.path.join(str(root), "snapshot.json")))
    import zlib

    return sum(len(zlib.decompress(open(os.path.join(str(root), n),
                                        "rb").read()))
               for n in header["sections"])


def test_delta_spill_rewrites_only_dirty_groups(objects, tmp_path):
    """A delta spill after one churned Pod rewrites the rows, vocab and
    aux sections and the Pod group alone, as the JAX package's does; the
    loaded result equals the live snapshot's tick."""
    stats = {}
    for pkg in ("jax", "port"):
        a, _first = _first_pass(pkg, objects)
        spill = a.spill(tmp_path / pkg, delta=True)
        assert a.save(spill)["ok"]
        _churn(a, objects)
        live = _tick(a)[0]
        r2 = a.save(spill)
        assert r2["ok"]
        n_groups = len(a.snap._groups)
        stats[pkg] = (spill.stats()["delta_spills"],
                      spill.stats()["groups_skipped"], n_groups)
        if pkg == "port":
            assert r2["sections_written"] == 3 + 1
        a.close()
        b = _World(pkg, objects)
        b_spill = b.spill(tmp_path / pkg, delta=True)
        loaded = b.load(b_spill)
        assert loaded is not None
        _churn(b, objects)  # the cluster as the spilling process left it
        b.watch(from_rvs=loaded["rvs"])
        # the churned row was spilled clean (evaluated before the second
        # spill), so the warm tick evaluates nothing
        assert _tick(b) == (live, 0)
        b.close()
    assert stats["port"] == stats["jax"]
    assert stats["port"][0] == 1 and stats["port"][1] == stats["port"][2] - 1


def _tamper(root, case: str) -> None:
    path = lambda n: os.path.join(str(root), n)  # noqa: E731
    if case == "torn":
        raw = open(path("snapshot.rows.pkl"), "rb").read()
        open(path("snapshot.rows.pkl"), "wb").write(raw[: len(raw) // 2])
    elif case == "corrupt":
        raw = bytearray(open(path("snapshot.vocab.pkl"), "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path("snapshot.vocab.pkl"), "wb").write(bytes(raw))
    elif case in ("version", "schema"):
        header = json.load(open(path("snapshot.json")))
        if case == "version":
            header["torch"] = "0.0.0"
        else:
            rows = pickle.loads(open(path("snapshot.rows.pkl"), "rb").read())
            for g in rows["groups"]:
                g["schema"] = "0" * 64
            raw = pickle.dumps(rows)
            open(path("snapshot.rows.pkl"), "wb").write(raw)
            header["sections"]["snapshot.rows.pkl"] = {
                "sha256": hashlib.sha256(raw).hexdigest(),
                "bytes": len(raw)}
        json.dump(header, open(path("snapshot.json"), "w"))


@pytest.mark.parametrize("case", ["torn", "corrupt", "plan", "schema",
                                  "version"])
def test_rejected_spill_is_deleted_and_rebuilt(objects, jax_first, tmp_path,
                                               case):
    """Each drifted or damaged spill is a counted miss of its reason, its
    files are deleted, and the fresh world's relist pass equals the JAX
    package's first pass (the plan case: the relist of its own edited
    template set)."""
    a, _first = _first_pass("port", objects)
    assert a.save(a.spill(tmp_path))["ok"]
    a.close()
    if case != "plan":
        _tamper(tmp_path, case)
    docs = _edited_docs() if case == "plan" else None
    b = _World("port", objects, docs=docs)
    spill = b.spill(tmp_path)
    assert b.load(spill) is None
    assert spill.stats()["miss_reasons"] == {
        "torn": {"corrupt": 1}, "corrupt": {"corrupt": 1},
        "plan": {"plan": 1}, "schema": {"schema": 1},
        "version": {"version": 1}}[case]
    assert not glob.glob(os.path.join(str(tmp_path), "snapshot*"))
    assert not b.snap.warm_loaded
    b.watch()
    rebuilt = _summary(b.mgr.audit())
    if case == "plan":
        c = _World("port", objects, docs=docs)
        c.watch()
        assert rebuilt == _summary(c.mgr.audit())
        assert any("outside the repos" in m for ks in rebuilt[2].values()
                   for *_x, m in ks)
        c.close()
    else:
        assert rebuilt == jax_first
    b.close()


def test_cluster_mismatch_is_a_miss_that_keeps_the_spill(objects,
                                                         tmp_path):
    a, _first = _first_pass("port", objects)
    assert a.save(a.spill(tmp_path, cluster_id="east"))["ok"]
    a.close()
    b = _World("port", objects)
    spill = b.spill(tmp_path, cluster_id="west")
    assert b.load(spill) is None
    assert spill.stats()["miss_reasons"] == {"cluster": 1}
    assert os.path.exists(os.path.join(str(tmp_path), "snapshot.json"))
    assert b.load(b.spill(tmp_path, cluster_id="east")) is not None


def test_vocab_that_is_not_a_prefix_is_a_miss(objects, tmp_path):
    a, _first = _first_pass("port", objects)
    assert a.save(a.spill(tmp_path))["ok"]
    a.close()
    b = _World("port", objects)
    b.driver.vocab.intern("interned-before-the-load")
    spill = b.spill(tmp_path)
    assert b.load(spill) is None
    assert spill.stats()["miss_reasons"] == {"vocab": 1}
    assert os.path.exists(os.path.join(str(tmp_path), "snapshot.json"))


# --- the extdata section ------------------------------------------------------

def test_extdata_section_keeps_remaining_ttl(objects, tmp_path):
    """Columns ride the aux section with each key's remaining TTL; the
    downtime between the spill and the load consumes it, and what it
    expired is dropped, in both packages alike."""
    entries = {"openpolicyagent/opa:1": (100.0, "ok", None),
               "nginx:2": (6.0, "", "untrusted"),
               "busybox:3": (40.0, "ok", None)}
    landed = {}
    for pkg in ("jax", "port"):
        lane_cls, cache_cls = ((JExtLane, JProviderCache) if pkg == "jax"
                               else (ExtDataLane, ProviderCache))
        a, _first = _first_pass(pkg, objects)
        b = _World(pkg, objects)
        # the TTL clock runs from here: spill, 10 s of downtime, load
        t0 = time.monotonic()
        lane = lane_cls(cache_cls(), column_ttl_s=120.0)
        lane.column("trusted").import_entries(dict(entries))
        spill = a.spill(tmp_path / pkg)
        assert spill.save(a.snap, rvs=dict(a.ing.rvs), extdata_lane=lane,
                          templates=a.templates())["ok"]
        a.close()
        hp = os.path.join(str(tmp_path / pkg), "snapshot.json")
        header = json.load(open(hp))
        header["saved_at"] -= 10.0
        json.dump(header, open(hp, "w"))
        fresh = lane_cls(cache_cls(), column_ttl_s=120.0)
        assert b.load(b.spill(tmp_path / pkg), extdata_lane=fresh)
        landed[pkg] = (fresh.export_columns(), time.monotonic() - t0)
    for pkg, (cols, window) in landed.items():
        col = cols["trusted"]
        assert col["ttl_s"] == 120.0
        assert sorted(col["entries"]) == [
            "busybox:3", "openpolicyagent/opa:1"], pkg
        for key, (remaining, value, error) in col["entries"].items():
            assert (value, error) == entries[key][1:]
            # the clocks differ (wall for the downtime, monotonic for the
            # TTL), hence the half-second margin either side
            want = entries[key][0] - 10.0
            assert want - window - 0.5 < remaining <= want + 0.5, pkg


# --- residency of adopted groups ----------------------------------------------

def test_adopted_group_uploads_whole_on_first_prepare(objects, tmp_path):
    """A group adopted from a spill is a new store whose layout version
    moved: its first prepare is a whole upload (no patch), and the mask
    mirror equals the one the spilling process had, and JAX's."""
    a, _first = _first_pass("port", objects, residency=True)
    want_masks = {tuple(sorted(rg.store.group)): rg.mask_host.copy()
                  for rg in a.res._groups.values()}
    assert a.save(a.spill(tmp_path))["ok"]
    a.close()
    j, _jfirst = _first_pass("jax", objects, residency=True)
    jax_masks = {tuple(sorted(rg.store.group)): rg.mask_host.copy()
                 for rg in j.res._groups.values()}
    j.close()
    b = _World("port", objects, residency=True)
    loaded = b.load(b.spill(tmp_path))
    assert loaded is not None
    stores = [s for s in b.snap.routed_stores() if s.lowered]
    assert stores and all(s.layout_version == 1 and s.mutations >= 1
                          for s in stores)
    for store in stores:
        rg = b.res.prepare(store)
        assert rg is not None
    assert b.res.upload_count == len(stores) and b.res.patch_count == 0
    got = {tuple(sorted(rg.store.group)): rg.mask_host
           for rg in b.res._groups.values()}
    assert sorted(got) == sorted(want_masks) == sorted(jax_masks)
    for key, m in got.items():
        np.testing.assert_array_equal(m, want_masks[key])
        np.testing.assert_array_equal(m, jax_masks[key])
    b.watch(from_rvs=loaded["rvs"])
    run = _summary(b.mgr.audit())
    assert run == _first
    assert b.res.upload_count == len(stores)


# --- a spill the JAX package wrote --------------------------------------------

_PORT_LOAD = r"""
import copy, json, sys
from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot, SnapshotSpill,
                                           templates_digest)
from gatekeeper_tpu_torch.target.target import K8sValidationTarget
docs = json.loads(sys.stdin.read())
cel = CELDriver()
driver = TorchDriver(device="cpu", cel_driver=cel)
client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                enforcement_points=[WEBHOOK_EP, AUDIT_EP])
for t, c in docs:
    client.add_template(t)
    client.add_constraint(c)
snap = ClusterSnapshot(SweepEvaluator(driver, device="cpu"))
spill = SnapshotSpill(sys.argv[1])
got = spill.load(snap, [c for c in client.constraints()
                        if c.actions_for(AUDIT_EP)],
                 templates=templates_digest(client))
print(json.dumps({"hit": got is not None, "stats": spill.stats(),
                  "imported": sorted(m for m in sys.modules
                                     if m.split(".")[0] in
                                     ("gatekeeper_tpu", "jax", "jaxlib"))}))
"""


def test_jax_written_spill_is_a_version_miss(objects, tmp_path):
    """The JAX package's spill (its sections pickle gatekeeper_tpu
    classes) is rejected on its header's jax/jaxlib fields before a
    section is read: a ``version`` miss that deletes it, in a fresh
    process that must not import gatekeeper_tpu, jax or jaxlib."""
    j, _first = _first_pass("jax", objects)
    assert j.save(j.spill(tmp_path))["ok"]
    j.close()
    assert "jax" in json.load(open(os.path.join(str(tmp_path),
                                                "snapshot.json")))
    proc = subprocess.run([sys.executable, "-c", _PORT_LOAD, str(tmp_path)],
                          input=json.dumps(DOCS), capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["hit"] is False and out["imported"] == []
    assert out["stats"]["miss_reasons"] == {"version": 1}
    assert not os.path.exists(os.path.join(str(tmp_path), "snapshot.json"))


# --- the spiller and the audit manager's hooks ----------------------------------

def test_spiller_writes_off_thread_and_flushes_on_stop(objects, tmp_path):
    a, _first = _first_pass("port", objects)
    spill = a.spill(tmp_path)
    spiller = SnapshotSpiller(spill, a.snap, rvs_fn=lambda: dict(a.ing.rvs),
                              templates_fn=a.templates)
    spiller.request(wait=True)
    assert spiller.last_result["ok"] and spill.spill_count == 1
    assert spiller._thread.name == "snapshot-spill"
    assert spill.stats()["last_capture_s"] > 0
    spiller.stop(flush=True)
    assert spill.spill_count == 2 and not spiller._thread.is_alive()
    spiller.request()  # stopped: ignored
    assert spill.spill_count == 2
    a.close()


def test_audit_manager_spills_after_a_clean_resync_and_at_exit(objects,
                                                               tmp_path):
    """A clean resync requests a background spill; a manager over the
    loaded spill starts its loop with a tick (no full pass) and spills
    again when the loop stops."""
    a = _World("port", objects)
    a.watch()
    spill = a.spill(tmp_path)
    a.mgr.attach_spiller(SnapshotSpiller(
        spill, a.snap, rvs_fn=lambda: dict(a.ing.rvs),
        templates_fn=a.templates))
    first = _summary(a.mgr.audit())
    a.mgr.audit_resync()
    assert a.mgr.last_resync_diff is None
    deadline = time.monotonic() + 30
    while spill.spill_count < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert spill.spill_count == 1
    a.mgr.spiller.stop(flush=False)
    a.close()

    b = _World("port", objects)
    b_spill = b.spill(tmp_path)
    loaded = b.load(b_spill)
    assert loaded is not None and loaded["aux"] == {"gen_verdicts": {}}
    b.watch(from_rvs=loaded["rvs"])
    b.mgr.attach_spiller(SnapshotSpiller(
        b_spill, b.snap, rvs_fn=lambda: dict(b.ing.rvs),
        templates_fn=b.templates))
    b.mgr.restore_spill_aux(loaded["aux"])
    passes = []
    tick, full = b.mgr.audit_tick, b.mgr.audit
    b.mgr.audit_tick = lambda: passes.append("tick") or tick()
    b.mgr.audit = lambda: passes.append("full") or full()
    b.mgr.config.interval_s = 0.05
    b.mgr.config.resync_every = 0
    t = threading.Thread(target=b.mgr.run_forever, daemon=True)
    t.start()
    while len(passes) < 2 and t.is_alive():
        time.sleep(0.02)
    b.mgr.stop()
    t.join(30)
    assert not t.is_alive()
    assert passes[0] == "tick" and "full" not in passes
    assert b.mgr.perf["snapshot_rows_evaluated"] == 0
    assert b_spill.spill_count == 1  # the exit flush
    assert _summary(b.mgr.audit_tick()) == first
    b.close()


# --- the CLI ----------------------------------------------------------------

def test_cli_snapshot_spill_warm_boot(objects, tmp_path):
    """``--once --audit-source snapshot --snapshot-spill DIR`` twice: the
    first misses (cold) and spills, the second loads the spill; both print
    the relist run's stdout."""
    mdir = tmp_path / "m"
    mdir.mkdir()
    for i, (t, c) in enumerate(DOCS):
        with open(mdir / f"t{i}.yaml", "w") as f:
            json.dump(t, f)
        with open(mdir / f"c{i}.yaml", "w") as f:
            json.dump(c, f)
    with open(mdir / "objects.yaml", "w") as f:
        f.write("\n---\n".join(json.dumps(o) for o in objects[:120]))
    outs = []
    for source, extra in (("relist", []),
                          ("snapshot", ["--snapshot-spill",
                                        str(tmp_path / "sp")]),
                          ("snapshot", ["--snapshot-spill",
                                        str(tmp_path / "sp"),
                                        "--snapshot-spill-compress",
                                        "zlib"])):
        p = subprocess.run(
            [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
             str(mdir), "--once", "--device", "cpu", "--audit-source",
             source, *extra], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        assert p.returncode == 0, p.stderr
        m = re.search(r"audit: (\d+) objects, (\d+) violations", p.stderr)
        outs.append((p.stdout, m.groups(), p.stderr))
    assert outs[0][0].count("\n") >= 5
    assert outs[1][:2] == outs[2][:2] == outs[0][:2]
    assert "snapshot spill miss ({'cold': 1})" in outs[1][2]
    assert "snapshot spill loaded: " in outs[2][2]
