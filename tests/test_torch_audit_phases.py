"""The audit's phase clock (``observability/tracing.py`` ``phase`` and
``CollectorHook``) and the phases the port's audit times with it, on the
CPU:

- ``phase`` adds its seconds through its owner's ``add`` with or without
  a tracer, opens its span only with one, and then with the counter's own
  two readings; nested phases and a raising body;
- the collector hook charges a collection to ``gc`` and to the innermost
  open phase, and makes a ``python.gc`` span of a full collection only
  under a tracer;
- ``list_route`` times the chunk source, not its consumer;
- a relist pass and a resident snapshot pass over a small library cluster
  fill their counters, the spans equal the counters the benchmark reads,
  and totals and kept violations are the same with the tracer on and off;
- ``export.host_spans`` laid on a CPU ``torch.profiler`` trace through the
  benchmark harness's window anchor puts an op run inside a span inside
  that span's interval;
- no audit, sweep or snapshot module opens a profiler range."""

import gc
import glob
import os
import sys
import time

import pytest
import torch

from gatekeeper_tpu_torch.__main__ import new_client
from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry
from gatekeeper_tpu_torch.observability import export, tracing
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot, DeviceResidency,
                                           SnapshotConfig, WatchIngester,
                                           gvks_of)
from gatekeeper_tpu_torch.sync.source import FakeCluster
from gatekeeper_tpu_torch.utils.synthetic import (load_library,
                                                  make_cluster_objects)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
N_OBJECTS = 2000
CHUNK = 512


class _Perf(dict):
    def add(self, key, dt):
        self[key] = self.get(key, 0.0) + dt


def _spans(tracer) -> list:
    return [sp for tr in tracer.traces() for sp in tr["spans"]]


# --- the clock -------------------------------------------------------------

def test_phase_counts_without_a_tracer_and_opens_no_span():
    perf = _Perf()
    assert tracing.active_tracer() is None
    with tracing.phase(perf.add, "upload", "device.upload", n=3) as ph:
        assert tracing.open_phases()[-1] == "upload"
        assert ph.span is tracing.NOOP_SPAN
        assert tracing.current_span() is None
        time.sleep(0.002)
    assert tracing.open_phases() == []
    assert perf["upload"] == ph.dt >= 0.002


def test_phase_span_is_the_counters_interval():
    perf = _Perf()
    tracer = tracing.Tracer(seed=0)
    with tracing.activate(tracer):
        with tracing.span("audit.sweep"):
            before = time.perf_counter()
            with tracing.phase(perf.add, "dispatch", "device.launch",
                               n=7) as ph:
                time.sleep(0.003)
            after = time.perf_counter()
    spans = {sp["name"]: sp for sp in _spans(tracer)}
    launch = spans["device.launch"]
    assert launch["duration_s"] == perf["dispatch"] == ph.dt
    assert before <= launch["start_mono"] <= after - perf["dispatch"]
    assert launch["parent_id"] == spans["audit.sweep"]["span_id"]
    assert launch["attributes"] == {"n": 7}


def test_nested_phases_and_a_raising_body():
    perf = _Perf()
    tracer = tracing.Tracer(seed=0)
    with tracing.activate(tracer):
        with tracing.span("audit.sweep"):
            with tracing.phase(perf.add, "outer", "audit.outer"):
                with tracing.phase(perf.add, "inner", "audit.inner"):
                    assert tracing.open_phases() == ["outer", "inner"]
                    time.sleep(0.001)
                with pytest.raises(ValueError):
                    with tracing.phase(perf.add, "boom", "audit.boom"):
                        time.sleep(0.001)
                        raise ValueError("boom")
                assert tracing.open_phases() == ["outer"]
            assert tracing.open_phases() == []
    spans = {sp["name"]: sp for sp in _spans(tracer)}
    assert perf["boom"] >= 0.001 and perf["inner"] >= 0.001
    assert perf["outer"] >= perf["inner"] + perf["boom"]
    assert spans["audit.boom"]["status"] == "error"
    assert spans["audit.inner"]["parent_id"] == \
        spans["audit.outer"]["span_id"]
    assert spans["audit.boom"]["duration_s"] == perf["boom"]
    # a phase with no span name times its counter only
    with tracing.activate(tracer):
        with tracing.phase(perf.add, "quiet") as ph:
            assert ph.span is tracing.NOOP_SPAN
    assert perf["quiet"] >= 0.0


@pytest.mark.parametrize("traced", [False, True])
def test_a_collection_lands_in_the_innermost_phase(traced):
    perf = _Perf()
    hook = tracing.CollectorHook(perf.add)
    tracer = tracing.Tracer(seed=0)
    with tracing.activate(tracer) if traced else _nothing():
        with tracing.span("audit.sweep"), hook, hook:
            assert gc.callbacks.count(hook) == 1
            with tracing.phase(perf.add, "outer", "audit.outer"):
                with tracing.phase(perf.add, "inner"):
                    gc.collect()
            gc.collect(0)
    assert hook not in gc.callbacks
    assert perf["gc/inner"] > 0.0
    assert perf["gc"] == pytest.approx(sum(
        v for k, v in perf.items() if k.startswith("gc/")))
    assert perf["gc/none"] > 0.0  # the young collection outside the phases
    names = [sp["name"] for sp in _spans(tracer)]
    if traced:
        gcs = [sp for sp in _spans(tracer) if sp["name"] == "python.gc"]
        outer = next(sp for sp in _spans(tracer)
                     if sp["name"] == "audit.outer")
        assert len(gcs) == 1  # the full collection, not the young one
        assert gcs[0]["parent_id"] == outer["span_id"]
        assert gcs[0]["attributes"]["phase"] == "inner"
        assert gcs[0]["duration_s"] == pytest.approx(perf["gc/inner"])
    else:
        assert names == []


def test_a_full_collection_under_the_tracers_lock_does_not_block():
    """A collection can interrupt code that holds the tracer's lock (an
    allocation inside ``end_span``): the hook opens its span later."""
    import threading

    perf = _Perf()
    hook = tracing.CollectorHook(perf.add)
    tracer = tracing.Tracer(seed=0)

    def pass_():
        with tracing.activate(tracer), tracing.span("audit.sweep"), hook:
            with tracer._lock:
                gc.collect()

    t = threading.Thread(target=pass_, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert [sp["name"] for sp in _spans(tracer)].count("python.gc") == 1


def test_a_full_collection_span_keeps_its_time_and_thread():
    """The ``python.gc`` span opens when the hook is released, on the
    releasing thread, but is drawn where its collection ran: inside its
    parent's wall interval and on the collecting thread."""
    import threading

    perf = _Perf()
    hook = tracing.CollectorHook(perf.add)
    tracer = tracing.Tracer(seed=0)

    def worker(root):
        with tracing.activate(tracer), \
                tracing.span("audit.worker", parent=root):
            time.sleep(0.01)
            gc.collect()
            time.sleep(0.01)

    with tracing.activate(tracer), tracing.span("audit.sweep") as root, \
            hook:
        t = threading.Thread(target=worker, args=(root,), name="collecting",
                             daemon=True)
        t.start()
        t.join(30)
        time.sleep(0.05)  # the hook's release lies well after the worker
    assert not t.is_alive()
    spans = _spans(tracer)
    parent = next(sp for sp in spans if sp["name"] == "audit.worker")
    (gcs,) = [sp for sp in spans if sp["name"] == "python.gc"]
    assert gcs["parent_id"] == parent["span_id"]
    assert parent["start_ts"] <= gcs["start_ts"]
    assert gcs["start_ts"] + gcs["duration_s"] <= \
        parent["start_ts"] + parent["duration_s"]
    assert (gcs["thread_id"], gcs["thread_name"]) == \
        (parent["thread_id"], "collecting")
    assert parent["start_mono"] <= gcs["start_mono"] <= \
        parent["start_mono"] + parent["duration_s"]
    events = {ev["name"]: ev for ev in export.chrome_trace(
        tracer.traces())["traceEvents"] if ev.get("ph") == "X"}
    assert events["audit.worker"]["ts"] <= events["python.gc"]["ts"] <= \
        events["audit.worker"]["ts"] + events["audit.worker"]["dur"]
    assert events["python.gc"]["tid"] == events["audit.worker"]["tid"]


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# --- list and route --------------------------------------------------------

def _tiny_manager(lister, chunk=4):
    client, _driver = new_client(device="cpu")
    return AuditManager(client, lister, AuditConfig(chunk_size=chunk))


def _pods(n):
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "default"}}
            for i in range(n)]


def test_list_route_leaves_the_consumer_out():
    mgr = _tiny_manager(lambda: iter(_pods(12)))
    for _objs, _cons in mgr._chunk_source([], False, [0]):
        time.sleep(0.05)  # the consumer's time
    assert 0.0 < mgr.perf["list_route"] < 0.05


def test_list_route_counts_a_slow_lister():
    def slow():
        for obj in _pods(12):
            time.sleep(0.01)  # one page of the apiserver
            yield obj

    mgr = _tiny_manager(slow)
    chunks = list(mgr._chunk_source([], False, [0]))
    assert len(chunks) == 3
    assert mgr.perf["list_route"] >= 0.12


# --- the audit's phases ----------------------------------------------------

@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=7)


def _stack(objects):
    client, driver = new_client(device="cpu")
    load_library(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        collect="reduced")
    return client, ev


def _summary(run):
    kept = {key: [(v.kind, v.namespace, v.name, v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


@pytest.fixture(scope="module")
def relist(objects):
    """(manager, evaluator, untraced summary, traced summary, manager perf
    and evaluator perf of the traced pass, tracer)."""
    metrics = MetricsRegistry()
    client, ev = _stack(objects)
    mgr = AuditManager(client, lambda: iter(objects),
                       AuditConfig(chunk_size=CHUNK, exact_totals=False),
                       evaluator=ev, metrics=metrics)
    plain = _summary(mgr.audit())
    m0, e0 = dict(mgr.perf), dict(ev.perf)
    tracer = tracing.Tracer(seed=0)
    with tracing.activate(tracer):
        traced = _summary(mgr.audit())
    return (mgr, ev, plain, traced, _delta(mgr.perf, m0),
            _delta(ev.perf, e0), tracer, metrics)


def test_relist_pass_fills_its_counters(relist):
    mgr, ev, plain, _t, mperf, eperf, _tr, metrics = relist
    assert plain[0] == N_OBJECTS and not plain[3]
    for key in ("list_route", "render", "fold_render", "status_write",
                "gc"):
        assert mperf[key] > 0.0, key
    assert mperf["n_renders"] > 0
    assert mperf["render"] < mperf["fold_render"]
    assert eperf["dispatches"] >= 4  # 2,000 objects in chunks of 512
    assert ev.perf["dispatches"] == ev.dispatch_count
    assert "n_eager_collects" not in mgr.perf
    assert sum(v for k, v in mperf.items() if k.startswith("gc/")) == \
        pytest.approx(mperf["gc"])
    assert "gatekeeper_audit_collector_seconds" in metrics.render()


def test_relist_spans_are_the_counters_the_benchmark_reads(relist):
    _m, _ev, _p, _t, mperf, eperf, tracer, _mx = relist
    spans = _spans(tracer)
    total = {}
    for sp in spans:
        total[sp["name"]] = total.get(sp["name"], 0.0) + sp["duration_s"]
    for name, perf, key in (("ops.flatten.columnize", eperf, "flatten"),
                            ("device.upload", eperf, "upload"),
                            ("device.launch", eperf, "dispatch"),
                            ("device.collect", eperf, "collect"),
                            ("audit.list_route", mperf, "list_route"),
                            ("audit.fold_render", mperf, "fold_render")):
        assert total[name] == pytest.approx(perf[key], rel=1e-9,
                                            abs=1e-12), name
    by_id = {sp["span_id"]: sp["name"] for sp in spans}
    parents = {(sp["name"], by_id.get(sp["parent_id"])) for sp in spans}
    assert ("device.upload", "device.sweep_dispatch") in parents
    assert ("device.launch", "device.sweep_dispatch") in parents
    assert ("audit.list_route", "audit.sweep") in parents
    folds = [sp for sp in spans if sp["name"] == "audit.chunk.collect_fold"]
    assert sum(sp["attributes"]["renders"] for sp in folds) == \
        mperf["n_renders"]
    assert sum(sp["attributes"]["render_s"] for sp in folds) == \
        pytest.approx(mperf["render"], abs=1e-4)


def test_relist_answers_the_same_with_the_tracer_on(relist):
    _m, _ev, plain, traced, *_rest = relist
    assert traced == plain


def _snapshot_pass(objects, traced):
    client, ev = _stack(objects)
    cluster = FakeCluster()
    for o in objects:
        cluster.apply(o)
    snap = ClusterSnapshot(ev, SnapshotConfig())
    ing = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
    res = DeviceResidency(ev, mode="on")
    mgr = AuditManager(client, cluster.list,
                       AuditConfig(chunk_size=CHUNK, exact_totals=False,
                                   audit_source="snapshot"),
                       evaluator=ev, snapshot=snap, residency=res)
    tracer = tracing.Tracer(seed=0)
    try:
        first = _summary(mgr.audit())
        m0 = dict(mgr.perf)
        with tracing.activate(tracer) if traced else _nothing():
            run = _summary(mgr.audit())
    finally:
        ing.stop()
    return first, run, _delta(mgr.perf, m0), tracer


def test_snapshot_pass_fills_its_phases(objects):
    first, plain, mperf, _tr = _snapshot_pass(objects, traced=False)
    assert plain == first and plain[0] == N_OBJECTS
    for key in ("snapshot_ready", "snapshot_rows", "snapshot_collect",
                "status_write", "fold_render", "render", "gc"):
        assert mperf[key] > 0.0, key
    # exact totals off: the renders happen in the collect, not the fold
    assert mperf["snapshot_collect"] >= mperf["render"]
    _f, traced, tperf, tracer = _snapshot_pass(objects, traced=True)
    assert traced == plain
    names = {sp["name"] for sp in _spans(tracer)}
    assert {"snapshot.ready", "snapshot.rows", "snapshot.collect",
            "audit.status_write", "audit.fold_render"} <= names
    coll = [sp for sp in _spans(tracer) if sp["name"] == "snapshot.collect"]
    assert len(coll) == 1
    assert coll[0]["duration_s"] == tperf["snapshot_collect"]
    assert coll[0]["attributes"]["renders"] == tperf["n_renders"]


# --- the program's spans on the profiler's clock ---------------------------

def test_host_spans_lie_on_the_profilers_clock(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        from harness import trace
    finally:
        sys.path.pop(0)
    seen = {}
    analyse = trace.analyse

    def spy(events, host):
        seen["events"], seen["host"] = events, host
        return analyse(events, host)

    monkeypatch.setattr(trace, "analyse", spy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    perf = _Perf()
    tracer = tracing.Tracer(seed=0)
    a = torch.randn(256, 256)
    spans: list = []

    def sweep():
        with tracing.activate(tracer):
            with tracing.span("audit.sweep"):
                time.sleep(0.02)
                with tracing.phase(perf.add, "dispatch", "device.launch"):
                    time.sleep(0.02)
                    torch.mm(a, a)
                    time.sleep(0.02)
                time.sleep(0.02)
        spans.extend(export.host_spans(tracer.traces()))

    trace.profiled(sweep, spans)
    (launch,) = [(s0, s1) for name, s0, s1 in seen["host"]
                 if name == "device.launch"]
    assert launch[1] - launch[0] == pytest.approx(perf["dispatch"] * 1e6)
    mms = [e.time_range for e in seen["events"] if e.name == "aten::mm"]
    assert mms
    for tr in mms:
        assert launch[0] < tr.start <= tr.end < launch[1]
    # the op runs 20 ms into the phase, as the host clock had it
    assert tr.start - launch[0] == pytest.approx(20_000, abs=10_000)


def test_the_audit_paths_open_no_profiler_range():
    for sub in ("audit", "parallel", "snapshot", "observability"):
        for path in glob.glob(os.path.join(ROOT, "gatekeeper_tpu_torch", sub,
                                           "*.py")):
            with open(path) as f:
                text = f.read()
            assert "record_function" not in text, path
            assert "nvtx" not in text.lower(), path
