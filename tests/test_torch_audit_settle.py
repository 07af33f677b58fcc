"""The audit manager's settle (``AuditManager._settling``) on the CPU: a
pass that built or replaced the long-lived audit state ends with one full
collection and ``gc.freeze()``, so later full collections leave that state
out of their walk.

- after a manager's first pass, relist and snapshot, one settle has frozen
  the state (the verdict store's rows are in no generation);
- a pass with nothing changed neither settles nor unfreezes;
- a constraint added between passes, or a snapshot invalidated, unfreezes,
  rebuilds and settles again, and a cycle the rebuild dropped is reclaimed
  by that pass;
- the freeze has one owner in the process: a manager whose failed pass
  left its state unfrozen, then frozen by another manager's settle,
  still reclaims that state's cycles when it rebuilds;
- ticks over churned rows leave no cyclic garbage in the frozen set, and
  a cycle a tick drops waits there for the next rebuild (the freeze's
  cost);
- totals, kept lists and messages equal those of a manager that never
  settles over the same objects;
- the collector hook counts only full collections under ``gc_full`` and
  ``gc_full_s``, and the settle's collection lands in ``gc/gc_settle``."""

import contextlib
import copy
import gc
import weakref

import pytest

from gatekeeper_tpu_torch.__main__ import new_client
from gatekeeper_tpu_torch.audit.manager import (AuditConfig, AuditManager,
                                                unfreeze_settled)
from gatekeeper_tpu_torch.observability import tracing
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot, DeviceResidency,
                                           SnapshotConfig, WatchIngester,
                                           gvks_of)
from gatekeeper_tpu_torch.sync.source import FakeCluster
from gatekeeper_tpu_torch.utils.synthetic import (load_library,
                                                  make_cluster_objects)

N_OBJECTS = 600
CHUNK = 256


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=11)


@pytest.fixture(autouse=True)
def _unfreeze():
    """Each test starts and ends with no settle's freeze held."""
    unfreeze_settled()
    yield
    unfreeze_settled()


class _Cycle:
    def __init__(self):
        self.me = self


@contextlib.contextmanager
def _lane(objects, source, settles=True):
    """(manager, cluster, ingester): an AuditManager over its own client,
    evaluator and (``snapshot``) watched cluster and snapshot, else None
    for the last two; ``settles=False`` gives one that never settles."""
    client, driver = new_client(device="cpu")
    load_library(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        collect="reduced")
    cfg = AuditConfig(chunk_size=CHUNK, exact_totals=False,
                      audit_source=source)
    cluster = ing = None
    if source == "snapshot":
        cluster = FakeCluster()
        for o in objects:
            cluster.apply(o)
        snap = ClusterSnapshot(ev, SnapshotConfig())
        ing = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
        mgr = AuditManager(client, cluster.list, cfg, evaluator=ev,
                           snapshot=snap,
                           residency=DeviceResidency(ev, mode="on"))
    else:
        mgr = AuditManager(client, lambda: iter(objects), cfg, evaluator=ev)
    if not settles:
        mgr._settling = contextlib.nullcontext
    try:
        yield mgr, cluster, ing
    finally:
        if ing is not None:
            ing.stop()


@contextlib.contextmanager
def _manager(objects, source, settles=True):
    with _lane(objects, source, settles) as (mgr, _cluster, _ing):
        yield mgr


def _summary(run):
    kept = {key: [(v.kind, v.namespace, v.name, v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _tracked(obj) -> bool:
    return any(o is obj for g in range(3) for o in gc.get_objects(g))


def _add_constraint(client):
    raw = copy.deepcopy(next(c for c in client.constraints()
                             if c.kind == "K8sRequiredLabels").raw)
    raw["metadata"]["name"] = "settle-extra"
    client.add_constraint(raw)


@pytest.mark.parametrize("source", ["relist", "snapshot"])
def test_the_first_pass_settles_and_the_second_does_not(objects, source):
    with _manager(objects, source) as mgr:
        first = _summary(mgr.audit())
        assert first[0] == N_OBJECTS and not first[3]
        assert mgr.perf["gc_settles"] == 1
        # what the pass dropped after its settle leaves the frozen set
        assert mgr.perf["gc_frozen"] >= gc.get_freeze_count() > 0
        assert mgr.perf["gc_settle"] > 0.0
        if source == "snapshot":
            assert not _tracked(mgr.snapshot.verdicts._rows)
        else:
            assert not _tracked(mgr)
        fresh = [[]]
        assert _tracked(fresh)
        unfreezes = mgr.perf.get("gc_unfreezes", 0.0)
        assert _summary(mgr.audit()) == first
        assert mgr.perf["gc_settles"] == 1
        assert mgr.perf.get("gc_unfreezes", 0.0) == unfreezes


@pytest.mark.parametrize("change", ["constraint", "invalidate"])
def test_a_replaced_state_unfreezes_and_settles_again(objects, change):
    with _manager(objects, "snapshot") as mgr:
        mgr.audit()
        snap = mgr.snapshot
        generation = snap.generation
        # a cycle held by the state the next pass replaces (the verdict
        # store's rows), frozen with it
        cycle = _Cycle()
        snap.verdicts._rows[("Settle", "cycle")] = {-1: [1, cycle]}
        dead = weakref.ref(cycle)
        del cycle
        gc.freeze()
        if change == "constraint":
            _add_constraint(mgr.client)
        else:
            snap.invalidate()
        run = mgr.audit()
        assert run.total_objects == N_OBJECTS and not run.incomplete
        assert snap.generation > generation
        assert mgr.perf["gc_unfreezes"] >= 1
        assert mgr.perf["gc_settles"] == 2
        assert dead() is None
        assert not _tracked(snap.verdicts._rows)
        if change == "constraint":
            assert ("K8sRequiredLabels", "settle-extra") in \
                run.total_violations


def test_a_relist_settles_again_after_a_constraint_is_added(objects):
    with _manager(objects, "relist") as mgr:
        mgr.audit()
        _add_constraint(mgr.client)
        mgr.audit()
        assert mgr.perf["gc_settles"] == 2
        assert mgr.perf["gc_unfreezes"] == 1
        mgr.audit()
        assert mgr.perf["gc_settles"] == 2
        # any unfreeze is followed by a settle, whoever lifted the freeze
        assert unfreeze_settled()
        mgr.audit()
        mgr.audit()
        assert mgr.perf["gc_settles"] == 3
        assert mgr.perf["gc_unfreezes"] == 1


def test_a_failed_pass_then_another_settle_still_reclaims_on_rebuild(
        objects):
    with _manager(objects, "snapshot") as a, \
            _manager(objects, "snapshot") as b:
        a.audit()
        b.audit()
        assert a.perf["gc_settles"] == b.perf["gc_settles"] == 1
        # a's state replaced by a pass that unfreezes, then raises
        a.snapshot.invalidate()

        def fail(full):
            raise RuntimeError("pass failed")

        a._audit_snapshot_impl = fail
        with pytest.raises(RuntimeError):
            a.audit()
        del a._audit_snapshot_impl
        assert a.perf["gc_unfreezes"] == 1 and a.perf["gc_settles"] == 1
        # a cycle a's rebuild will drop, frozen by b's rebuild's settle
        cycle = _Cycle()
        a.snapshot.verdicts._rows[("Settle", "cycle")] = {-1: [1, cycle]}
        dead = weakref.ref(cycle)
        del cycle
        b.snapshot.invalidate()
        b.audit()
        assert b.perf["gc_settles"] == 2
        gc.collect()
        assert dead() is not None
        run = a.audit()
        assert run.total_objects == N_OBJECTS and not run.incomplete
        assert a.perf["gc_unfreezes"] == 2 and a.perf["gc_settles"] == 2
        assert dead() is None
        # both states are frozen again; b's next pass does nothing
        b.audit()
        assert b.perf["gc_settles"] == 2
        assert not _tracked(a.snapshot.verdicts._rows)
        assert not _tracked(b.snapshot.verdicts._rows)


def test_ticks_over_churn_hold_only_the_cycles_they_drop(objects):
    with _lane(objects, "snapshot") as (mgr, cluster, ing):
        mgr.audit()
        verdicts = mgr.snapshot.verdicts
        # a cycle held by every row's entry, frozen as a settle would
        cycle = _Cycle()
        for rows in verdicts._rows.values():
            for entry in rows.values():
                entry.append(cycle)
        dead = weakref.ref(cycle)
        del cycle, rows, entry
        gc.freeze()
        frozen = gc.get_freeze_count()
        for t in range(3):
            for o in objects:
                o = copy.deepcopy(o)
                o["metadata"].setdefault("labels", {})["churn"] = f"r{t}"
                cluster.apply(o)
            ing.pump()
            assert mgr.audit_tick().total_objects == N_OBJECTS
        assert mgr.perf["gc_settles"] == 1
        assert "gc_unfreezes" not in mgr.perf
        assert not any(len(entry) > 2 for rows in verdicts._rows.values()
                       for entry in rows.values())
        gc.collect()
        # the ticks dropped the cycle, and it waits for the next unfreeze;
        # the churned rows they replaced were freed by their counts
        assert dead() is not None
        assert gc.get_freeze_count() < frozen
        mgr.snapshot.invalidate()
        mgr.audit()
        assert dead() is None and mgr.perf["gc_settles"] == 2
        # what the freeze held after ticks over a third of the rows each:
        # no cyclic garbage at all
        for t in range(3):
            for o in objects[t::3]:
                o = copy.deepcopy(o)
                o["metadata"].setdefault("labels", {})["churn"] = f"s{t}"
                cluster.apply(o)
            ing.pump()
            mgr.audit_tick()
        gc.collect()
        assert unfreeze_settled()
        assert gc.collect() == 0


@pytest.mark.parametrize("source", ["relist", "snapshot"])
def test_settled_passes_answer_as_an_unsettled_manager(objects, source):
    with _manager(objects, source, settles=False) as plain:
        want = [_summary(plain.audit()) for _ in range(2)]
        assert "gc_settles" not in plain.perf
    with _manager(objects, source) as mgr:
        got = [_summary(mgr.audit()) for _ in range(2)]
        assert mgr.perf["gc_settles"] == 1
    assert got == want


def test_audit_tick_settles_only_when_the_tick_rebuilt(objects):
    with _manager(objects, "snapshot") as mgr:
        mgr.audit()
        mgr.audit_tick()
        assert mgr.perf["gc_settles"] == 1
        mgr.snapshot.invalidate()
        mgr.audit_tick()
        assert mgr.perf["gc_settles"] == 2


def test_the_hook_counts_only_full_collections():
    perf = {}

    def add(key, v):
        perf[key] = perf.get(key, 0.0) + v

    with tracing.CollectorHook(add):
        gc.collect(0)
        gc.collect(1)
        assert "gc_full" not in perf and "gc_full_s" not in perf
        gc.collect()
    assert perf["gc_full"] == 1.0
    assert 0.0 < perf["gc_full_s"] <= perf["gc"]
    assert perf["gc"] > perf["gc_full_s"]  # the two young collections


def test_the_settle_lands_in_its_own_phase_and_span(objects):
    tracer = tracing.Tracer(seed=0)
    with _manager(objects, "relist") as mgr:
        with tracing.activate(tracer):
            mgr.audit()
        perf = mgr.perf
    assert perf["gc/gc_settle"] > 0.0
    assert perf["gc_full"] >= 1 and perf["gc_full_s"] >= perf["gc/gc_settle"]
    assert sum(v for k, v in perf.items() if k.startswith("gc/")) == \
        pytest.approx(perf["gc"])
    spans = [sp for tr in tracer.traces() for sp in tr["spans"]]
    settle = [sp for sp in spans if sp["name"] == "audit.gc_settle"]
    assert len(settle) == 1
    assert settle[0]["duration_s"] == perf["gc_settle"]
    assert settle[0]["attributes"]["frozen"] == perf["gc_frozen"]
    assert settle[0]["attributes"]["collected"] >= 0
    by_id = {sp["span_id"]: sp for sp in spans}
    assert by_id[settle[0]["parent_id"]]["name"] == "audit.sweep"
    full = [sp for sp in spans if sp["name"] == "python.gc"
            and sp["parent_id"] == settle[0]["span_id"]]
    assert len(full) == 1 and full[0]["attributes"]["phase"] == "gc_settle"
