"""The port's observability layer (gatekeeper_tpu_torch/observability/ and
metrics/registry.py) against the JAX package's copies on the same inputs:
span trees (ids from one seed, timestamps from injected clocks), parent
links across the validating Batcher's thread, the W3C ``traceparent``
round trip, the Chrome trace export, the metrics text for one call
sequence, the cost-attribution closure, flight-recorder records with the
``/debug/decisions?uid=`` payload, and SLO burn rates over the same
registry samples.  Every comparison is exact: the clocks are injected;
the only values normalized are thread ids and the exemplar timestamps of
the OpenMetrics text (the registry reads the wall clock there)."""

import http.client
import json
import re
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.metrics import registry as jreg  # noqa: E402
from gatekeeper_tpu.observability import costattr as jcost  # noqa: E402
from gatekeeper_tpu.observability import export as jexport  # noqa: E402
from gatekeeper_tpu.observability import flightrec as jflight  # noqa: E402
from gatekeeper_tpu.observability import slo as jslo  # noqa: E402
from gatekeeper_tpu.observability import tracing as jtracing  # noqa: E402
from gatekeeper_tpu.resilience import overload as jovl  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu.webhook import server as jserver  # noqa: E402
from gatekeeper_tpu_torch.metrics import registry as treg  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    costattr as tcost  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    export as texport  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    flightrec as tflight  # noqa: E402
from gatekeeper_tpu_torch.observability import slo as tslo  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    tracing as ttracing  # noqa: E402
from gatekeeper_tpu_torch.resilience import overload as tovl  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402
from gatekeeper_tpu_torch.webhook import server as tserver  # noqa: E402

JAX = {"reg": jreg, "cost": jcost, "export": jexport, "flight": jflight,
       "slo": jslo, "tracing": jtracing, "ovl": jovl, "policy": jpolicy,
       "server": jserver}
PORT = {"reg": treg, "cost": tcost, "export": texport, "flight": tflight,
        "slo": tslo, "tracing": ttracing, "ovl": tovl, "policy": tpolicy,
        "server": tserver}


class _Tick:
    """A clock that advances ``step`` on every read."""

    def __init__(self, start: float, step: float):
        self.t = start
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _tracer(pkg, **kw):
    return pkg["tracing"].Tracer(seed=11, clock=_Tick(0.0, 0.001),
                                 wall=_Tick(1.7e9, 0.001), **kw)


def _normalized(traces: list) -> list:
    """Thread ids differ between runs; everything else must not."""
    out = []
    for tr in traces:
        tr = dict(tr)
        tr["spans"] = [{k: v for k, v in sp.items() if k != "thread_id"}
                       for sp in tr["spans"]]
        out.append(tr)
    return out


def _span_scenario(pkg) -> list:
    tracing = pkg["tracing"]
    tracer = _tracer(pkg)
    with tracing.activate(tracer):
        with tracing.span("webhook.request", path="/v1/admit") as root:
            tracing.set_attribute("uid", "u1")
            with tracing.span("webhook.review", kind="Pod"):
                tracing.add_event("retry", attempt=1)
                with tracing.span("device.query_batch", n=3):
                    pass
            done = threading.Event()

            def worker():
                # cross-thread: the parent travels explicitly
                with tracing.span("webhook.batcher.flush", parent=root,
                                  batch_size=3):
                    pass
                done.set()

            threading.Thread(target=worker, name="worker").start()
            assert done.wait(10)
        try:
            with tracing.span("audit.sweep"):
                raise ValueError("boom")
        except ValueError:
            pass
        remote = tracing.parse_traceparent(
            "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
        with tracing.span("webhook.request", parent=remote):
            header = tracing.format_traceparent()
    assert tracing.active_tracer() is None
    return [_normalized(tracer.traces()), header,
            {k: v for k, v in tracer.snapshot().items() if k != "traces"}]


def test_span_trees_match():
    got, want = _span_scenario(PORT), _span_scenario(JAX)
    assert got == want
    traces = got[0]
    names = {sp["name"]: sp for sp in traces[0]["spans"]}
    assert names["webhook.batcher.flush"]["parent_id"] == \
        names["webhook.request"]["span_id"]
    assert names["webhook.batcher.flush"]["thread_name"] == "worker"
    assert traces[1]["spans"][0]["status"] == "error"
    # the remote parent's trace id carries through; the span is the root
    assert got[1].startswith("00-0af7651916cd43dd8448eb211c80319c-")


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b71692033-01",
    "garbage", "", None])
def test_traceparent_round_trip(header):
    def round_trip(tracing):
        ctx = tracing.parse_traceparent(header)
        if ctx is None:
            return None
        tracer = tracing.Tracer(seed=3)
        with tracing.activate(tracer):
            with tracing.span("x", parent=ctx) as sp:
                return (ctx.trace_id, ctx.span_id, sp.parent_id,
                        tracing.format_traceparent())

    assert round_trip(ttracing) == round_trip(jtracing)


class _Responses:
    stats_entries: list = []

    def results(self):
        return []


class _StubClient:
    drivers: list = []

    def constraints(self):
        return []

    def review(self, augmented, **kw):
        return _Responses()

    def review_batch(self, reviews, **kw):
        return [_Responses() for _ in reviews]


def _body(uid: str) -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
                        "namespace": "team-a",
                        "userInfo": {"username": "alice"},
                        "object": {"apiVersion": "v1", "kind": "Pod",
                                   "metadata": {"name": "p",
                                                "namespace": "team-a"}}}}


def _batcher_tree(pkg) -> list:
    """The span tree of one admission through the Batcher's grid lane:
    (name, parent name, thread is the batch thread) per span."""
    tracing = pkg["tracing"]
    tracer = tracing.Tracer(seed=5)
    batcher = pkg["policy"].Batcher(_StubClient(), small_batch=0).start()
    handler = pkg["policy"].ValidationHandler(_StubClient(),
                                              batcher=batcher)
    try:
        with tracing.activate(tracer):
            with tracing.span("webhook.request"):
                resp = handler.handle(_body("u1"))
    finally:
        batcher.stop()
    assert resp.allowed
    (trace,) = tracer.traces()
    by_id = {sp["span_id"]: sp for sp in trace["spans"]}
    main = threading.get_ident()
    return sorted((sp["name"],
                   by_id[sp["parent_id"]]["name"] if sp["parent_id"]
                   else None, sp["thread_id"] != main,
                   sorted(sp["attributes"].items()))
                  for sp in trace["spans"])


def test_batcher_flush_parents_into_the_request_trace():
    got = _batcher_tree(PORT)
    assert got == _batcher_tree(JAX)
    rows = {name: (parent, other_thread)
            for name, parent, other_thread, _a in got}
    assert rows["webhook.batcher.flush"] == ("webhook.batcher.enqueue",
                                             True)
    assert rows["webhook.batcher.enqueue"] == ("webhook.review", False)
    assert rows["webhook.review"] == ("webhook.request", False)


def test_chrome_export_matches(tmp_path):
    got, want = (_span_scenario(p)[0] for p in (PORT, JAX))

    def events(pkg, traces):
        doc = pkg["export"].chrome_trace(traces)
        return doc, pkg["export"].format_span_summary(traces), \
            pkg["export"].top_spans_by_self_time(traces)

    assert events(PORT, got) == events(JAX, want)
    # the written file loads as JSON with one X event per span
    tracer = _tracer(PORT)
    with ttracing.activate(tracer):
        with ttracing.span("device.sweep_dispatch"):
            with ttracing.span("device.sweep_collect"):
                pass
    path = str(tmp_path / "trace.json")
    n = texport.write_chrome_trace(path, tracer)
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert n == len(doc["traceEvents"]) and len(xs) == 2


_EXEMPLAR_TS = re.compile(r"( \d+\.\d+)$", re.M)


def _metrics_scenario(pkg) -> tuple:
    reg = pkg["reg"]
    m = reg.MetricsRegistry()
    rng = np.random.default_rng(2)
    tracing = pkg["tracing"]
    tracer = tracing.Tracer(seed=1)
    with tracing.activate(tracer):
        for i in range(60):
            status = ("allow", "deny", "shed")[int(rng.integers(0, 3))]
            m.inc_counter(reg.REQUEST_COUNT, {"admission_status": status})
            with tracing.span("webhook.request"):
                m.observe(reg.REQUEST_DURATION, float(rng.gamma(2, 0.01)))
            m.observe(reg.WEBHOOK_BATCH_SIZE, int(rng.integers(1, 65)))
        m.set_gauge(reg.OVERLOAD_INFLIGHT_LIMIT, 8)
        m.set_gauge(reg.AUDIT_LAST_RUN_INCOMPLETE, 1.0)
        m.inc_counter(reg.RESILIENCE_FAULTS, {"site": "device.dispatch",
                                              "mode": "error"}, value=2.0)
        for t in range(140):  # past the label-cardinality guard
            m.inc_counter(reg.CONSTRAINT_EVAL, {"template": f"K{t}"},
                          value=0.5)
    hist = m.get_histogram(reg.REQUEST_DURATION)
    # exemplars carry the wall time of their observation
    hist["exemplar_reservoir"] = [[e[:2] for e in bucket] for bucket in
                                  hist["exemplar_reservoir"]]
    hist["exemplars"] = [e if e is None else e[:2]
                         for e in hist["exemplars"]]
    return (m.render(), _EXEMPLAR_TS.sub("", m.render(openmetrics=True)),
            hist)


def test_metrics_render_matches():
    got, want = _metrics_scenario(PORT), _metrics_scenario(JAX)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert "gatekeeper_metrics_dropped_labels_count" in got[0]
    assert "# EOF" in got[1] and " # {trace_id=" in got[1]


def _cost_scenario(pkg) -> tuple:
    cost = pkg["cost"]
    attr = cost.CostAttribution(metrics=pkg["reg"].MetricsRegistry())
    rng = np.random.default_rng(4)
    walls = []
    with cost.activate(attr):
        for _ in range(30):
            wall = float(rng.uniform(0.001, 0.05))
            rows = {f"K{k}": int(rng.integers(0, 500))
                    for k in range(int(rng.integers(1, 8)))}
            walls.append(wall)
            attr.attribute(wall, {k: 1.0 + r for k, r in rows.items()},
                           cost.EP_AUDIT, cost.PHASE_DISPATCH, rows=rows)
        attr.attribute(0.01, {"A": 0.0, "B": 0.0}, cost.EP_WEBHOOK,
                       cost.PHASE_DISPATCH)  # zero weights: even split
        attr.record("K1", cost.EP_AUDIT, cost.PHASE_RENDER, 0.002, rows=1)
        attr.record_tenant("team-a", cost.EP_WEBHOOK, 0.004, cost=900.0)
    assert cost.active() is None
    return attr.snapshot(), sum(walls), attr.total_seconds(
        cost.EP_AUDIT, cost.PHASE_DISPATCH), attr.tenant_totals()


def test_cost_attribution_closes_and_matches():
    got, want = _cost_scenario(PORT), _cost_scenario(JAX)
    assert got == want
    _snap, walls, dispatch_total, tenants = got
    # per-template shares sum back to the parent walls
    assert dispatch_total == pytest.approx(walls, rel=1e-12)
    assert tenants == {"team-a": pytest.approx(0.004)}


def _flight_scenario(pkg) -> tuple:
    flight = pkg["flight"]
    rec = flight.FlightRecorder(capacity=8, wall=_Tick(1.7e9, 0.5),
                                max_message=40)
    ctl = pkg["ovl"].OverloadController(pkg["ovl"].OverloadConfig())
    decisions = [("validate", "allow", "u1", ""), ("validate", "deny", "u2",
                                                   "x" * 100),
                 ("validate", "shed", "u1", ""), ("mutate", "error", "u3",
                                                  "bad patch"),
                 ("validate", "deadline", "u4", "budget")]
    for i in range(3):
        for ep, dec, uid, msg in decisions:
            rec.record(ep, dec, uid=f"{uid}-{i % 2}", obj_kind="Pod",
                       name="p", namespace="team-a", operation="CREATE",
                       message=msg, cost=1024.0,
                       reason="queue_full" if dec == "shed" else "",
                       overload=ctl, tenant="team-a")
    server = pkg["server"].WebhookServer(port=0, flight_recorder=rec)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        pages = []
        for path in ("/debug/decisions?uid=u1-0",
                     "/debug/decisions?limit=3&decision=shed,deny",
                     "/debug/decisions?limit=bad"):
            conn.request("GET", path)
            r = conn.getresponse()
            pages.append((r.status, json.loads(r.read())))
        conn.close()
    finally:
        server.stop()
    return pages, rec.snapshot(uid="u2-1"), rec.recorded


def test_flight_recorder_records_and_uid_view_match():
    got, want = _flight_scenario(PORT), _flight_scenario(JAX)
    assert got == want
    (status, page), _p2, (bad, _b) = got[0]
    assert status == 200 and bad == 400
    assert page["decisions"] and all(d["uid"] == "u1-0"
                                     for d in page["decisions"])


def _slo_scenario(pkg) -> list:
    reg = pkg["reg"]
    m = reg.MetricsRegistry()
    fake = {"t": 0.0}
    objectives = [
        {"name": "lat-p90", "type": "latency", "metric": "lat_seconds",
         "threshold": 0.1, "target": 0.9},
        {"name": "shed-rate", "type": "ratio",
         "bad_metric": reg.REQUEST_COUNT,
         "bad_labels": {"admission_status": "shed"},
         "total_metric": reg.REQUEST_COUNT, "target": 0.99},
    ]
    eng = pkg["slo"].SLOEngine(
        m, objectives=objectives,
        tiers=[{"name": "page", "short_s": 60.0, "long_s": 300.0,
                "burn": 2.0}],
        clock=lambda: fake["t"], wall=lambda: 1.7e9 + fake["t"])
    rng = np.random.default_rng(8)
    out = [eng.tick()]
    for minute in range(1, 9):
        slow = minute in (3, 4)
        for _ in range(40):
            m.observe("lat_seconds", float(rng.gamma(2.0, 0.5 if slow
                                                      else 0.01)))
            shed = slow and rng.random() < 0.3
            m.inc_counter(reg.REQUEST_COUNT, {
                "admission_status": "shed" if shed else "allow"})
        fake["t"] = 60.0 * minute
        out.append(eng.tick())
    out.append(eng.pressure())
    return out


def test_slo_burn_rates_match():
    got, want = _slo_scenario(PORT), _slo_scenario(JAX)
    assert got == want
    breaches = [ev["breach"] for tick in got[1:-1]
                for ev in tick["objectives"] if ev["name"] == "lat-p90"]
    assert any(breaches) and not breaches[-1]  # breached, then recovered
