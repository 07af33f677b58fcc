"""The port's shadow canary lane (gatekeeper_tpu_torch/replay/shadow.py)
against the JAX package's (gatekeeper_tpu/replay/shadow.py), on the CPU.

The 13 cases of tests/test_shadow.py, on the port: the served answers with
a lane active equal the lane-off answers; would_allow / would_deny /
would_error and a swallowed lane crash; the full queue drops the oldest;
unserved answers are skipped; promote applies the candidate to the serving
client and abort ends shadowing; the divergence-rate SLO objective sums
the divergence kinds; ``GET``/``POST /debug/shadow``; the SLO auto-abort
on a rising edge and never on a promoted lane.  Where a case counts
decisions or divergences, the JAX lane runs the same bodies against the
same candidate and the counts must be equal (tolerance: exact).  One more
case drives ``--shadow-candidate`` through the port's served CLI."""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.replay import core as jcore  # noqa: E402
from gatekeeper_tpu.replay import shadow as jshadow  # noqa: E402
from gatekeeper_tpu_torch.gator import reader  # noqa: E402
from gatekeeper_tpu_torch.metrics import registry as M  # noqa: E402
from gatekeeper_tpu_torch.metrics.registry import \
    MetricsRegistry  # noqa: E402
from gatekeeper_tpu_torch.observability import flightrec  # noqa: E402
from gatekeeper_tpu_torch.observability.slo import (SLOEngine,  # noqa
                                                    SLOObjective)
from gatekeeper_tpu_torch.replay import core, shadow  # noqa: E402
from gatekeeper_tpu_torch.replay.shadow import (SHADOW_OBJECTIVE,  # noqa
                                                ShadowLane)
from gatekeeper_tpu_torch.utils.unstructured import name_of  # noqa: E402
from gatekeeper_tpu_torch.webhook.policy import \
    ValidationResponse  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_replay", os.path.join(ROOT, "tools", "bench_replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stop(*runtimes) -> None:
    for rt in runtimes:
        gc = getattr(rt.driver, "gen_coord", None)
        if gc is not None:
            gc.stop()


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """Serving (the 3-template library) and candidate (the library less
    one deny-firing constraint) runtimes of both packages, each package
    over its own compile cache, plus the traffic split by the serving
    verdict."""
    bench = _load_bench()
    cache_dir = str(tmp_path_factory.mktemp("shadow-cc"))
    jcache_dir = str(tmp_path_factory.mktemp("shadow-jcc"))
    full = bench._library_docs(3)
    bodies = bench._admission_bodies(40, seed=5)
    serving = core.load_candidate(full, compile_cache_dir=cache_dir,
                                  device="cpu")
    served = [serving.handler.handle(copy.deepcopy(b)) for b in bodies]
    denied = [b for b, r in zip(bodies, served) if not r.allowed]
    allowed = [b for b, r in zip(bodies, served) if r.allowed]
    assert denied and allowed, "traffic mix regressed; reseed the bodies"
    drop = sorted(core.recorded_constraints(
        next(r for r in served if not r.allowed).message))[0]
    minus = [d for d in full
             if not (reader.is_constraint(d) and name_of(d) == drop)]
    candidate = core.load_candidate(minus, compile_cache_dir=cache_dir,
                                    device="cpu")
    solely = [b for b, r in zip(bodies, served)
              if not r.allowed and core.recorded_constraints(r.message)
              == {drop}]
    assert solely, f"no admission denied solely by {drop}"
    jserving = jcore.load_candidate(full, compile_cache_dir=jcache_dir)
    jcandidate = jcore.load_candidate(minus, compile_cache_dir=jcache_dir)
    out = {"cache_dir": cache_dir, "full": full, "minus": minus,
           "drop": drop, "serving": serving, "candidate": candidate,
           "jserving": jserving, "jcandidate": jcandidate,
           "bodies": bodies, "denied": denied, "allowed": allowed,
           "solely": solely}
    yield out
    _stop(serving, candidate, jserving, jcandidate)


def _fields(resp):
    return (resp.allowed, resp.message, resp.code,
            tuple(resp.warnings), resp.uid, resp.retry_after_s)


def _shadowed(mod, lane_runtime, handler, bodies, **kw):
    """Serve ``bodies`` through ``handler`` with a started lane of module
    ``mod`` active; returns (lane, served fields) after the drain."""
    lane = mod.ShadowLane(lane_runtime, **kw).start()
    try:
        with mod.activate(lane):
            served = [_fields(handler.handle(copy.deepcopy(b)))
                      for b in bodies]
        lane.drain()
    finally:
        lane.stop()
    return lane, served


def _counts(lane):
    return (lane.submitted, lane.evaluated, lane.lane_errors,
            lane.dropped, lane.skipped, dict(lane.decisions),
            dict(lane.divergences))


# --- 1. the serving-identity pin -------------------------------------------

def test_shadow_lane_never_alters_served_response(ctx):
    handler = ctx["serving"].handler
    baseline = [_fields(handler.handle(copy.deepcopy(b)))
                for b in ctx["bodies"]]
    lane, shadowed = _shadowed(shadow, ctx["candidate"], handler,
                               ctx["bodies"], max_queue=256)
    assert shadowed == baseline
    assert lane.submitted == len(ctx["bodies"])
    assert lane.evaluated == lane.submitted and lane.lane_errors == 0
    jlane, _ = _shadowed(jshadow, ctx["jcandidate"],
                         ctx["jserving"].handler, ctx["bodies"],
                         max_queue=256)
    assert _counts(lane) == _counts(jlane)


# --- 2. divergence detection -----------------------------------------------

def test_shadow_reports_would_allow(ctx):
    metrics = MetricsRegistry()
    rec = flightrec.FlightRecorder(capacity=64)
    lane, _ = _shadowed(shadow, ctx["candidate"], ctx["serving"].handler,
                        ctx["solely"], recorder=rec, metrics=metrics)
    assert lane.divergences["would_allow"] == len(ctx["solely"])
    snap = lane.snapshot()
    assert snap["divergence_rate"] > 0
    assert snap["recent_divergences"]
    for d in snap["recent_divergences"]:
        assert d["served"] == "deny" and d["shadow"] == "allow"
    assert metrics.get_counter(M.SHADOW_DIVERGENCE,
                               {"kind": "would_allow"}) == \
        len(ctx["solely"])
    entries = rec.snapshot()["decisions"]
    assert entries and all(e["endpoint"] == "shadow" for e in entries)
    assert any(e.get("divergence") == "would_allow"
               and e.get("served") == "deny" for e in entries)
    jlane, _ = _shadowed(jshadow, ctx["jcandidate"],
                         ctx["jserving"].handler, ctx["solely"])
    assert _counts(lane) == _counts(jlane)
    jsnap = jlane.snapshot()
    for key in ("divergence_rate", "recent_divergences", "decisions",
                "divergences"):
        assert snap[key] == jsnap[key], key


def test_shadow_reports_would_deny(ctx):
    # the inverse deployment: serving = minus, candidate = the full library
    lane, served = _shadowed(shadow, ctx["serving"],
                             ctx["candidate"].handler, ctx["solely"])
    assert all(f[0] for f in served)  # the minus library allows these
    assert lane.divergences["would_deny"] == len(ctx["solely"])
    jlane, _ = _shadowed(jshadow, ctx["jserving"],
                         ctx["jcandidate"].handler, ctx["solely"])
    assert _counts(lane) == _counts(jlane)


def test_shadow_reports_would_error_and_swallows_lane_crash(ctx,
                                                            monkeypatch):
    lane = ShadowLane(ctx["candidate"]).start()
    try:
        monkeypatch.setattr(
            ctx["candidate"].client, "review_batch",
            lambda reviews, **kw: [RuntimeError("boom")] * len(reviews))
        with shadow.activate(lane):
            for b in ctx["allowed"][:3]:
                ctx["serving"].handler.handle(copy.deepcopy(b))
        lane.drain()
        assert lane.divergences["would_error"] == 3
        assert lane.decisions["error"] == 3
    finally:
        lane.stop()
    lane2 = ShadowLane(ctx["candidate"]).start()
    try:
        def _raise(reviews, **kw):
            raise RuntimeError("candidate down")

        monkeypatch.setattr(ctx["candidate"].client, "review_batch",
                            _raise)
        with shadow.activate(lane2):
            resp = ctx["serving"].handler.handle(
                copy.deepcopy(ctx["allowed"][0]))
            assert resp.allowed  # serving unaffected
        lane2.drain()
        assert lane2.lane_errors == 1 and lane2.evaluated == 0
    finally:
        lane2.stop()


# --- 3. backpressure --------------------------------------------------------

def test_shadow_full_queue_drops_oldest_never_blocks(ctx):
    metrics = MetricsRegistry()
    lane = ShadowLane(ctx["candidate"], max_queue=4, metrics=metrics)
    body = {"request": {"uid": "q", "userInfo": {"username": "u"}}}
    for _ in range(10):
        assert lane.submit(dict(body), ValidationResponse(allowed=True))
    assert lane.submitted == 10
    assert lane.dropped == 6
    assert lane._queue.qsize() == 4
    assert metrics.counter_total(M.SHADOW_DROPPED) == 6
    assert metrics.get_gauge(M.SHADOW_QUEUE_DEPTH) == 4


def test_shadow_skips_unserved_decisions(ctx):
    lane = ShadowLane(ctx["candidate"])
    body = {"request": {"uid": "e"}}
    for code in (500, 504):
        assert not lane.submit(dict(body), ValidationResponse(
            allowed=False, code=code))
    assert lane.skipped == 2 and lane.submitted == 0
    assert lane._queue.qsize() == 0


# --- 4. promote / abort -----------------------------------------------------

def test_promote_applies_candidate_to_serving(ctx):
    serving = core.load_candidate(ctx["minus"],
                                  compile_cache_dir=ctx["cache_dir"],
                                  device="cpu")
    try:
        body = ctx["solely"][0]
        assert serving.handler.handle(copy.deepcopy(body)).allowed
        lane = ShadowLane(ctx["candidate"], serving_client=serving.client,
                          candidate_docs=ctx["full"])
        out = lane.promote()
        assert out["state"] == "promoted" and lane.state == "promoted"
        assert out["applied"]["templates"] == 3
        assert out["applied"]["constraints"] > 0
        assert "errors" not in out
        resp = serving.handler.handle(copy.deepcopy(body))
        assert not resp.allowed and ctx["drop"] in resp.message
        assert not lane.submit({"request": {}},
                               ValidationResponse(allowed=True))
    finally:
        _stop(serving)


def test_abort_stops_shadowing(ctx):
    lane = ShadowLane(ctx["candidate"]).start()
    out = lane.abort(reason="divergence SLO breached")
    assert out == {"state": "aborted",
                   "reason": "divergence SLO breached"}
    assert not lane.submit({"request": {}},
                           ValidationResponse(allowed=True))


# --- 5. the SLO objective ---------------------------------------------------

def test_shadow_slo_objective_sums_divergence_kinds(ctx):
    metrics = MetricsRegistry()
    bodies = ctx["solely"][:2] + ctx["allowed"][:3]
    lane, _ = _shadowed(shadow, ctx["candidate"], ctx["serving"].handler,
                        bodies, metrics=metrics)
    assert lane.evaluated == 5
    obj = SLOObjective(SHADOW_OBJECTIVE)
    bad, total = obj.sample(metrics, 0.0)
    assert bad == sum(lane.divergences.values()) == 2
    assert total == 5
    assert obj.target == SHADOW_OBJECTIVE["target"]
    assert SHADOW_OBJECTIVE == jshadow.SHADOW_OBJECTIVE


# --- 6. /debug/shadow -------------------------------------------------------

def _http(url, body=None):
    req = urllib.request.Request(
        url, data=(json.dumps(body).encode() if body is not None
                   else None),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_debug_shadow_endpoint(ctx):
    serving = core.load_candidate(ctx["minus"],
                                  compile_cache_dir=ctx["cache_dir"],
                                  device="cpu")
    lane = ShadowLane(ctx["candidate"], serving_client=serving.client,
                      candidate_docs=ctx["full"])
    srv = WebhookServer(port=0).start()
    base = f"http://127.0.0.1:{srv.port}/debug/shadow"
    try:
        with shadow.activate(lane):
            doc = _http(base)
            assert doc["state"] == "shadowing"
            assert set(doc) >= {"submitted", "evaluated", "divergences",
                                "divergence_rate", "recent_divergences"}
            jdoc = jshadow.ShadowLane(ctx["jcandidate"]).snapshot()
            assert set(doc) == set(jdoc)
            with pytest.raises(urllib.error.HTTPError) as e:
                _http(base, {"action": "bogus"})
            assert e.value.code == 400
            out = _http(base, {"action": "promote"})
            assert out["state"] == "promoted"
            assert out["applied"]["templates"] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(base)
        assert e.value.code == 404
    finally:
        srv.stop()
        _stop(serving)


def test_debug_shadow_abort_endpoint(ctx):
    lane = ShadowLane(ctx["candidate"])
    srv = WebhookServer(port=0).start()
    base = f"http://127.0.0.1:{srv.port}/debug/shadow"
    try:
        with shadow.activate(lane):
            out = _http(base, {"action": "abort", "reason": "slo"})
            assert out == {"state": "aborted", "reason": "slo"}
    finally:
        srv.stop()


def _engine(fake, m):
    return SLOEngine(
        m, objectives=[SHADOW_OBJECTIVE],
        tiers=[{"name": "page", "short_s": 60.0, "long_s": 300.0,
                "burn": 2.0}],
        clock=lambda: fake["t"], wall=lambda: 1_000_000.0 + fake["t"])


def test_slo_breach_auto_aborts_shadow_lane():
    """A RISING-EDGE breach of the divergence objective aborts a shadowing
    lane; a continued breach never re-fires (edge, not level)."""
    fake = {"t": 0.0}
    m = MetricsRegistry()
    eng = _engine(fake, m)
    lane = ShadowLane(runtime=None)
    lane.bind_slo(eng)
    eng.tick()
    m.inc_counter("shadow_decisions_count", value=100.0)
    fake["t"] = 60.0
    out = eng.tick()
    assert not out["objectives"][0]["breach"]
    assert lane.state == "shadowing"
    m.inc_counter("shadow_divergence_count", {"kind": "verdict"},
                  value=50.0)
    m.inc_counter("shadow_decisions_count", value=50.0)
    fake["t"] = 120.0
    out = eng.tick()
    assert out["objectives"][0]["breach"]
    assert lane.state == "aborted"
    assert "slo auto-abort" in lane.abort_reason
    assert SHADOW_OBJECTIVE["name"] in lane.abort_reason
    lane.state = "shadowing"
    m.inc_counter("shadow_divergence_count", {"kind": "verdict"},
                  value=50.0)
    m.inc_counter("shadow_decisions_count", value=50.0)
    fake["t"] = 121.0
    out = eng.tick()
    assert out["objectives"][0]["breach"]
    assert lane.state == "shadowing"


def test_slo_auto_abort_spares_promoted_lane():
    fake = {"t": 0.0}
    m = MetricsRegistry()
    eng = _engine(fake, m)
    lane = ShadowLane(runtime=None)
    lane.bind_slo(eng)
    lane.state = "promoted"
    eng.tick()
    m.inc_counter("shadow_divergence_count", value=50.0)
    m.inc_counter("shadow_decisions_count", value=50.0)
    fake["t"] = 60.0
    out = eng.tick()
    assert out["objectives"][0]["breach"]
    assert lane.state == "promoted"


# --- 7. the served CLI ------------------------------------------------------

def test_served_cli_shadow_candidate(ctx, tmp_path):
    """``--shadow-candidate DIR --shadow-sink F`` on the served port CLI:
    stderr says the canary is active with the SLO auto-abort armed,
    ``/debug/shadow`` answers, the lane shadows every served admission,
    and SIGTERM flushes the sink."""
    serve_dir, cand_dir = tmp_path / "serve", tmp_path / "cand"
    for d, docs in ((serve_dir, ctx["full"]), (cand_dir, ctx["minus"])):
        d.mkdir()
        (d / "library.yaml").write_text(
            "\n---\n".join(json.dumps(x) for x in docs))
    sink = tmp_path / "shadow.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(serve_dir), "--port", "0", "--device", "cpu",
         "--shadow-candidate", str(cand_dir), "--shadow-sink", str(sink),
         "--audit-interval", "3600"],
        cwd=ROOT, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    lines = []
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "webhook serving on :" in line:
                port = int(line.split("webhook serving on :")[1].split()[0])
        assert port, "".join(lines)
        assert any("shadow canary active: " in ln
                   and "slo auto-abort armed" in ln for ln in lines), lines
        bodies = ctx["solely"] + ctx["allowed"][:3]
        for b in bodies:
            _http(f"http://127.0.0.1:{port}/v1/admit", b)
        doc = {}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            doc = _http(f"http://127.0.0.1:{port}/debug/shadow")
            if doc["evaluated"] + doc["lane_errors"] >= len(bodies):
                break
            time.sleep(0.1)
        assert doc["state"] == "shadowing"
        assert doc["evaluated"] == len(bodies) and doc["lane_errors"] == 0
        assert doc["divergences"] == {"would_allow": len(ctx["solely"])}
    finally:
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=120)[1]
    assert proc.returncode == 0, "".join(lines) + rest
    recs = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert len(recs) == len(bodies)
    assert all(r["endpoint"] == "shadow" for r in recs)
