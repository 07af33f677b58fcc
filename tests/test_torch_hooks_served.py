"""The served process's hooks in the port against the JAX package, over the
in-repo ``library/`` corpus (five of its templates with their sample
constraints where the JAX side runs, so its programs compile in seconds):

- the overload limiter on and unloaded answers exactly as limiter off
  (the port alone, the whole library, on the grid lane);
- an audit under a ``device.dispatch`` error spec with ``chunk_retries=1``
  equals the unfaulted run, with the JAX audit's retried and dropped
  counts under that spec; with more faults than retries the dropped chunk
  leaves the run ``INCOMPLETE`` in both, with equal totals;
- a ``webhook.review`` hang under a 0.3 s deadline answers allow plus a
  warning (failurePolicy Ignore) or a 504 deny (Fail) in both, within the
  budget plus slack;
- a shed answers 429 with ``Retry-After`` under Fail, over HTTP, as the
  JAX server does;
- the reduced lane's attribution rows (the fused fold's ``occ``, its plain
  version here) equal the masks lane's host sums chunk by chunk, and both
  equal the JAX package's per-template rows;
- after one scripted served scenario ``/metrics`` carries the JAX server's
  metric families, less the named ones this port leaves out;
- the CLI parses every hook flag with the JAX CLI's defaults.

Every comparison is exact but the deadline's wall time (budget + 2 s
slack)."""

import argparse
import copy
import glob
import http.client
import json
import os
import re
import threading
import time

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit import manager as jmanager  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.metrics import registry as jreg  # noqa: E402
from gatekeeper_tpu.observability import costattr as jcost  # noqa: E402
from gatekeeper_tpu.observability import flightrec as jflight  # noqa: E402
from gatekeeper_tpu.observability import slo as jslo  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.resilience import faults as jfaults  # noqa: E402
from gatekeeper_tpu.resilience import overload as jovl  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu.webhook import server as jserver  # noqa: E402
from gatekeeper_tpu_torch import __main__ as cli  # noqa: E402
from gatekeeper_tpu_torch.audit import manager as tmanager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.metrics import registry as treg  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    costattr as tcost  # noqa: E402
from gatekeeper_tpu_torch.observability import \
    flightrec as tflight  # noqa: E402
from gatekeeper_tpu_torch.observability import slo as tslo  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.resilience import faults as tfaults  # noqa: E402
from gatekeeper_tpu_torch.resilience import overload as tovl  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402
from gatekeeper_tpu_torch.webhook import server as tserver  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library")
SUBSET = ("general/allowedrepos", "general/requiredlabels",
          "general/containerlimits", "general/httpsonly",
          "pod-security-policy/allowprivilegeescalation")
N_OBJECTS = 600
CHUNK = 64

JAX = {"reg": jreg, "cost": jcost, "flight": jflight, "slo": jslo,
       "faults": jfaults, "ovl": jovl, "policy": jpolicy, "server": jserver,
       "manager": jmanager}
PORT = {"reg": treg, "cost": tcost, "flight": tflight, "slo": tslo,
        "faults": tfaults, "ovl": tovl, "policy": tpolicy,
        "server": tserver, "manager": tmanager}


def _subset_docs() -> list:
    docs = []
    for rel in SUBSET:
        docs += load_yaml_file(os.path.join(LIB, rel, "template.yaml"))
        docs += load_yaml_file(os.path.join(LIB, rel, "samples",
                                            "constraint.yaml"))
    return docs


def _client(pkg, metrics=None):
    """(client, driver) over the subset, each side with its own driver."""
    if pkg is JAX:
        driver = TpuDriver(metrics=metrics)
        client = JClient(target=JTarget(), drivers=[driver],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    else:
        driver = TorchDriver(device="cpu", metrics=metrics)
        client = TClient(target=TTarget(), drivers=[driver],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    for doc in _subset_docs():
        if doc["kind"] == "ConstraintTemplate":
            client.add_template(copy.deepcopy(doc))
    for doc in _subset_docs():
        if doc["kind"] != "ConstraintTemplate":
            client.add_constraint(copy.deepcopy(doc))
    return client, driver


def _evaluator(pkg, driver, collect="reduced", metrics=None):
    if pkg is JAX:
        return ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                                collect=collect, metrics=metrics)
    return SweepEvaluator(driver, device="cpu", violations_limit=20,
                          collect=collect, metrics=metrics)


def _manager(pkg, client, ev, objects, metrics=None):
    mod = pkg["manager"]
    kw = {"pipeline": "off"} if pkg is JAX else {}
    return mod.AuditManager(client, lambda: iter(objects),
                            mod.AuditConfig(chunk_size=CHUNK,
                                            chunk_retries=1, **kw),
                            evaluator=ev, metrics=metrics)


@pytest.fixture(scope="module")
def worlds():
    """pkg name -> (client, driver, reduced evaluator, masks evaluator)."""
    objects = make_cluster_objects(N_OBJECTS, seed=21)
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        client, driver = _client(pkg)
        out[name] = (client, driver, _evaluator(pkg, driver),
                     _evaluator(pkg, driver, "masks"))
    assert sorted(out["jax"][1].lowered_kinds()) == \
        sorted(out["port"][1].lowered_kinds())
    assert len(out["port"][1].lowered_kinds()) == len(SUBSET)
    return objects, out


def _summary(run) -> tuple:
    kept = {key: [(v.kind, f"{v.namespace}/{v.name}", v.message)
                  for v in vs] for key, vs in run.kept.items()}
    return (run.total_objects, dict(run.total_violations), kept,
            run.incomplete, run.retried_chunks, run.failed_chunks)


def _chaos_audit(pkg, world, objects, spec):
    client, _driver, ev, _masks = world
    mgr = _manager(pkg, client, ev, objects)
    if spec is None:
        return _summary(mgr.audit())
    faults = pkg["faults"]
    with faults.inject(faults.FaultPlan(spec["faults"], seed=0)):
        return _summary(mgr.audit())


@pytest.mark.parametrize("spec,retried,failed", [
    ({"faults": [{"site": "device.dispatch", "mode": "error",
                  "times": 1}]}, 1, 0),
    ({"faults": [{"site": "device.dispatch", "mode": "error",
                  "times": 2, "after": 3}]}, 1, 1),
], ids=["once", "beyond-retries"])
def test_chaos_audit_matches_jax(worlds, spec, retried, failed):
    objects, w = worlds
    bare = _chaos_audit(PORT, w["port"], objects, None)
    assert bare == _chaos_audit(JAX, w["jax"], objects, None)
    got = _chaos_audit(PORT, w["port"], objects, spec)
    want = _chaos_audit(JAX, w["jax"], objects, spec)
    assert got == want
    assert got[4:] == (retried, failed)
    if failed:
        assert got[3] is True  # INCOMPLETE
        # only the dropped chunk's share is missing
        assert all(got[1][k] <= bare[1][k] for k in bare[1])
        assert sum(got[1].values()) < sum(bare[1].values())
    else:
        assert got[:4] == bare[:4]


class _RowsAttribution:
    """A CostAttribution that also keeps each dispatch attribution's rows,
    in call order."""

    def __init__(self, cost):
        self.attr = cost.CostAttribution()
        self.calls: list = []
        inner = self.attr.attribute

        def attribute(wall, weights, ep, phase, rows=None):
            if phase == cost.PHASE_DISPATCH and ep == cost.EP_AUDIT:
                self.calls.append(dict(rows or {}))
            return inner(wall, weights, ep, phase, rows=rows)

        self.attr.attribute = attribute


def _attribution_rows(pkg, world, objects, lane):
    client, _driver, reduced, masks = world
    ev = reduced if lane == "reduced" else masks
    cap = _RowsAttribution(pkg["cost"])
    with pkg["cost"].activate(cap.attr):
        run = _manager(pkg, client, ev, objects).audit()
    totals: dict = {}
    for rows in cap.calls:
        for kind, n in rows.items():
            totals[kind] = totals.get(kind, 0) + n
    closure = cap.attr.total_seconds(pkg["cost"].EP_AUDIT,
                                     pkg["cost"].PHASE_DISPATCH)
    return cap.calls, totals, run, closure


def test_attribution_rows_reduced_equal_masks_and_jax(worlds):
    objects, w = worlds
    rc, rt, rrun, rclosure = _attribution_rows(PORT, w["port"], objects,
                                               "reduced")
    mc, mt, mrun, _ = _attribution_rows(PORT, w["port"], objects, "masks")
    assert len(rc) == len(mc) > 1
    assert rc == mc  # chunk by chunk: fold occ == host mask sums
    assert rrun.total_violations == mrun.total_violations
    assert rclosure > 0
    _jc, jt, _jrun, _ = _attribution_rows(JAX, w["jax"], objects,
                                          "reduced")
    assert rt == mt == jt
    assert sum(rt.values()) > 0


def _samples() -> list:
    docs = []
    for path in sorted(glob.glob(os.path.join(LIB, "*", "*", "samples",
                                              "example_*.yaml"))):
        docs.extend(d for d in load_yaml_file(path) if isinstance(d, dict))
    return docs


def _body(obj: dict, uid: str) -> dict:
    api = obj.get("apiVersion", "")
    group, _, version = api.rpartition("/")
    meta = obj.get("metadata") or {}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": group, "version": version,
                                 "kind": obj.get("kind", "")},
                        "name": meta.get("name", ""),
                        "namespace": meta.get("namespace", ""),
                        "userInfo": {"username": "alice"}, "object": obj}}


def test_limiter_on_unloaded_equals_limiter_off():
    """The whole library on the grid lane, groups of 6 concurrent
    reviews (under the limiter's initial 8): no shed, and every answer
    equals limiter off's."""
    cel = TCELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel)
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert tload(client) == (46, 46)
    objects = _samples()
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o["kind"] == "Namespace"}
    bodies = [_body(o, f"u{i}") for i, o in enumerate(objects)]
    answers = {}
    for mode in ("off", "on"):
        ctl = tovl.OverloadController(tovl.OverloadConfig()) \
            if mode == "on" else None
        batcher = tpolicy.Batcher(client, small_batch=0).start()
        handler = tpolicy.ValidationHandler(
            client, namespace_lookup=namespaces.get, batcher=batcher,
            overload=ctl)
        out = [None] * len(bodies)
        try:
            for lo in range(0, len(bodies), 6):
                def one(i):
                    out[i] = handler.handle(copy.deepcopy(bodies[i]),
                                            cost_hint=2048)

                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(lo, min(lo + 6, len(bodies)))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
        finally:
            batcher.stop()
        answers[mode] = [(v.allowed, v.code, v.message, sorted(v.warnings),
                          v.retry_after_s) for v in out]
        if ctl is not None:
            assert ctl.shed_count == 0
            assert batcher.lane_counts["grid"] > 0
    assert answers["on"] == answers["off"]
    assert any(not a[0] for a in answers["on"])  # non-vacuous: denies


class _Slow:
    """A review stub: the hang is the fault site's, not the client's."""

    drivers: list = []

    def constraints(self):
        return []

    def review(self, augmented, **kw):
        class R:
            stats_entries: list = []

            def results(self):
                return []
        return R()


@pytest.mark.parametrize("policy", ["ignore", "fail"])
def test_review_hang_under_deadline(policy):
    spec = [{"site": "webhook.review", "mode": "hang", "delay_s": 3.0}]
    got = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        faults = pkg["faults"]
        reg = pkg["reg"].MetricsRegistry()
        handler = pkg["policy"].ValidationHandler(
            _Slow(), deadline_budget_s=0.3, failure_policy=policy,
            metrics=reg)
        with faults.inject(faults.FaultPlan(spec)):
            t0 = time.perf_counter()
            v = handler.handle(_body({"apiVersion": "v1", "kind": "Pod",
                                      "metadata": {"name": "p"}}, "h1"))
            wall = time.perf_counter() - t0
        assert wall < 0.3 + 2.0
        got[name] = (v.allowed, v.code, v.message, v.warnings, v.uid,
                     reg.get_counter(pkg["reg"].RESILIENCE_DEADLINE_EXCEEDED,
                                     {"component": "webhook",
                                      "policy": policy}))
    assert got["port"] == got["jax"]
    if policy == "ignore":
        assert got["port"][0] is True and got["port"][3]
    else:
        assert got["port"][:2] == (False, 504)
    assert got["port"][5] == 1


def _http(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Retry-After"), r.read()
    finally:
        conn.close()


def test_shed_answers_429_with_retry_after_under_fail():
    got = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        ctl = pkg["ovl"].OverloadController(pkg["ovl"].OverloadConfig())
        handler = pkg["policy"].ValidationHandler(
            _Slow(), failure_policy="fail", overload=ctl)
        srv = pkg["server"].WebhookServer(validation_handler=handler,
                                          port=0).start()
        faults = pkg["faults"]
        plan = faults.FaultPlan([{"site": "webhook.overload",
                                  "mode": "error", "delay_s": 2.0,
                                  "times": 1}])
        try:
            with faults.inject(plan):
                shed = _http(srv.port, "POST", "/v1/admit",
                             _body({"apiVersion": "v1", "kind": "Pod",
                                    "metadata": {"name": "p"}}, "s1"))
                after = _http(srv.port, "POST", "/v1/admit",
                              _body({"apiVersion": "v1", "kind": "Pod",
                                     "metadata": {"name": "p"}}, "s2"))
        finally:
            srv.stop()
        got[name] = (shed[0], shed[1], json.loads(shed[2]), after[0],
                     after[1], json.loads(after[2]), ctl.shed_count)
    assert got["port"] == got["jax"]
    status, retry, doc, *_ = got["port"]
    assert (status, retry) == (200, "2")
    assert doc["response"]["allowed"] is False
    assert doc["response"]["status"]["code"] == 429
    assert got["port"][4] is None and got["port"][5]["response"]["allowed"]


# Families the JAX server shows after the scenario below that the port does
# not emit: none since the snapshot store's own gauges and counters were
# ported.
LEFT_OUT: set = set()
# Families the port adds after the scenario: its collector gauge
# (audit/manager.py AUDIT_COLLECTOR_SECONDS).
PORT_ONLY = {"gatekeeper_audit_collector_seconds"}


def _families(text: str) -> set:
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def _snapshot_pass(pkg, client, driver, objects, reg) -> None:
    """A snapshot-source audit and one tick over a watched cluster."""
    if pkg is JAX:
        from gatekeeper_tpu.snapshot import (ClusterSnapshot, WatchIngester,
                                             gvks_of)
        from gatekeeper_tpu.sync.source import FakeCluster
    else:
        from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                                   WatchIngester, gvks_of)
        from gatekeeper_tpu_torch.sync.source import FakeCluster
    cluster = FakeCluster()
    for obj in objects:
        cluster.apply(copy.deepcopy(obj))
    ev = _evaluator(pkg, driver, metrics=reg)
    snap = ClusterSnapshot(ev, metrics=reg)
    ing = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
    mod = pkg["manager"]
    kw = {"pipeline": "off"} if pkg is JAX else {}
    mgr = mod.AuditManager(client, cluster.list,
                           mod.AuditConfig(chunk_size=CHUNK,
                                           audit_source="snapshot", **kw),
                           evaluator=ev, snapshot=snap, metrics=reg)
    try:
        mgr.audit()
        mgr.audit_tick()
    finally:
        ing.stop()


def _served_families(pkg, objects) -> set:
    """One scripted served scenario: a relist audit, a snapshot audit and
    tick, three admissions (one shed), an SLO tick, then ``/metrics``."""
    reg = pkg["reg"].MetricsRegistry()
    client, driver = _client(pkg, metrics=reg)
    ev = _evaluator(pkg, driver, metrics=reg)
    ctl = pkg["ovl"].OverloadController(pkg["ovl"].OverloadConfig(),
                                        metrics=reg)
    attr = pkg["cost"].CostAttribution(metrics=reg)
    rec = pkg["flight"].FlightRecorder(metrics=reg)
    pkg["faults"].set_metrics_registry(reg)
    batcher = pkg["policy"].Batcher(client, metrics=reg).start()
    srv = pkg["server"].WebhookServer(
        validation_handler=pkg["policy"].ValidationHandler(
            client, batcher=batcher, metrics=reg, overload=ctl,
            failure_policy="fail"),
        port=0, batcher=batcher, metrics=reg, cost_attribution=attr,
        flight_recorder=rec).start()
    faults = pkg["faults"]
    try:
        with pkg["cost"].activate(attr), pkg["flight"].activate(rec), \
                pkg["ovl"].activate(ctl), faults.inject(faults.FaultPlan(
                    [{"site": "webhook.overload", "mode": "error",
                      "after": 2, "times": 1}])):
            _manager(pkg, client, ev, objects[:200], metrics=reg).audit()
            _snapshot_pass(pkg, client, driver, objects[:200], reg)
            for i, obj in enumerate(objects[:3]):
                status, _r, _b = _http(srv.port, "POST", "/v1/admit",
                                       _body(obj, f"m{i}"))
                assert status == 200
            pkg["slo"].SLOEngine(reg).tick()
            status, _r, text = _http(srv.port, "GET", "/metrics")
    finally:
        srv.stop()
        faults.set_metrics_registry(None)
    assert status == 200
    return _families(text.decode())


def test_metrics_families_match_jax(worlds):
    objects, _w = worlds
    port = _served_families(PORT, objects)
    jax = _served_families(JAX, objects)
    assert LEFT_OUT <= jax
    assert not PORT_ONLY & jax
    assert port == (jax - LEFT_OUT) | PORT_ONLY
    assert {"gatekeeper_validation_request_count",
            "gatekeeper_snapshot_rows", "gatekeeper_snapshot_patch_count",
            "gatekeeper_resilience_faults_injected_count",
            "gatekeeper_constraint_eval_seconds",
            "gatekeeper_audit_last_run_end_time"} <= port


HOOK_DESTS = (
    "shutdown_delay", "drain_timeout", "webhook_backlog", "overload_limiter",
    "overload_max_inflight", "overload_queue_depth", "overload_queue_cost",
    "qos", "qos_config", "qos_ledger_decay", "enable_profile", "chaos",
    "trace", "trace_buffer", "trace_slow_ms", "trace_sample", "trace_seed",
    "cost_attribution", "slo", "slo_config", "slo_interval",
    "slo_brownout", "slo_degradation", "flight_recorder",
    "flight_recorder_sink", "flight_recorder_sink_max_mb",
    "flight_recorder_sink_keep", "flight_recorder_capture",
    "webhook_deadline")

HOOK_ARGV = [
    "--shutdown-delay", "2", "--drain-timeout", "3", "--webhook-backlog",
    "64", "--overload-limiter", "off", "--overload-max-inflight", "16",
    "--overload-queue-depth", "32", "--overload-queue-cost", "1e6",
    "--qos", "on", "--qos-config", "q.json", "--qos-ledger-decay",
    "slo-window", "--enable-profile", "--chaos", "c.json", "--trace",
    "t.json", "--trace-buffer", "--trace-slow-ms", "5", "--trace-sample",
    "0.5", "--trace-seed", "9", "--cost-attribution", "off", "--slo", "off",
    "--slo-config", "s.json", "--slo-interval", "2", "--slo-brownout",
    "--slo-degradation", "on", "--flight-recorder", "0",
    "--flight-recorder-sink", "f.jsonl", "--flight-recorder-sink-max-mb",
    "4", "--flight-recorder-sink-keep", "2", "--flight-recorder-capture",
    "--webhook-deadline", "0.3"]


class _Parsed(Exception):
    pass


def _jax_args(monkeypatch, argv) -> argparse.Namespace:
    """The JAX CLI's namespace for ``argv``: its parser is built inside
    ``main``, so the parse is caught on its way out."""
    from gatekeeper_tpu import __main__ as jcli

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["ns"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        jcli.main(list(argv))
    monkeypatch.undo()
    return seen["ns"]


@pytest.mark.parametrize("argv", [[], HOOK_ARGV], ids=["defaults", "set"])
def test_cli_parses_hook_flags_like_jax(monkeypatch, argv):
    port = cli.build_parser().parse_args(argv)
    jax = _jax_args(monkeypatch, argv)
    for dest in HOOK_DESTS:
        assert getattr(port, dest) == getattr(jax, dest), dest


def test_cli_serves_under_a_short_switch_interval(monkeypatch):
    """While the CLI serves, the interpreter switches threads every
    ``SERVING_SWITCH_INTERVAL_S``; the caller's interval is back after."""
    import sys

    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    seen = []
    monkeypatch.setattr(
        cli, "serve",
        lambda *a, **k: seen.append(sys.getswitchinterval()) or 0)
    before = sys.getswitchinterval()
    args = cli.build_parser().parse_args(
        ["--manifests", library_dir(), "--port", "0", "--device", "cpu"])
    assert cli.run(args) == 0
    assert seen == [cli.SERVING_SWITCH_INTERVAL_S]
    assert sys.getswitchinterval() == before


@pytest.mark.parametrize("argv,want", [
    ([], cli.WEBHOOK_SMALL_BATCH), (["--webhook-small-batch", "8"], 8),
    (["--webhook-small-batch", "0"], 0)])
def test_cli_interpreter_lane_threshold(argv, want):
    """The served webhook's interpreter lane takes batches up to the
    port's crossover unless ``--webhook-small-batch`` says otherwise; the
    flag parses to the JAX CLI's ``None`` when absent."""
    args = cli.build_parser().parse_args(argv)
    assert cli.webhook_small_batch(args) == want
    assert cli.WEBHOOK_SMALL_BATCH == 32
