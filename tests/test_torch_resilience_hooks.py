"""The port's resilience hooks (gatekeeper_tpu_torch/resilience/) against
the JAX package's: the same inputs, made from a seed with numpy, through
both copies, compared exactly (no wall time enters a compared value):

- a chaos spec and seed fire the same fault sequence in both ``FaultPlan``s;
- one latency-sample sequence gives the same ``AdaptiveLimiter`` limit
  trajectory;
- a ``QoSQueue`` fed the same tickets and tenants dequeues them in the same
  order;
- ``OverloadController`` on an injected clock gives the same shed reasons
  and brownout levels;
- ``yield_device_lane`` yields at level 2 and honours
  ``audit_yield_release``;
- ``DrainCoordinator`` makes the same state transitions.

Each package keeps its own process-global installs, so each scenario runs
once per package with that package's modules."""

import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.resilience import faults as jfaults  # noqa: E402
from gatekeeper_tpu.resilience import overload as jovl  # noqa: E402
from gatekeeper_tpu.resilience import qos as jqos  # noqa: E402
from gatekeeper_tpu_torch.resilience import faults as tfaults  # noqa: E402
from gatekeeper_tpu_torch.resilience import overload as tovl  # noqa: E402
from gatekeeper_tpu_torch.resilience import qos as tqos  # noqa: E402

SITES = ("webhook.review", "device.dispatch", "externaldata.send",
         "mutation.batch", "pipeline.stage.flatten", "ops.flatten_raw")


def _chaos_spec(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"seed": int(rng.integers(0, 1 << 16)), "faults": [
        {"site": "device.dispatch", "mode": "error",
         "times": int(rng.integers(1, 4)), "after": int(rng.integers(0, 3))},
        {"site": "webhook.*", "mode": "sleep", "delay_s": 0.25,
         "probability": float(rng.uniform(0.2, 0.8))},
        {"site": "externaldata.send", "mode": "partial", "fraction": 0.5,
         "every": int(rng.integers(1, 4))},
        {"site": "pipeline.stage.*", "mode": "hang",
         "probability": float(rng.uniform(0.1, 0.5))},
    ]}


def _fault_sequence(faults, spec: dict, calls) -> tuple:
    """(per-call outcome, plan events) of ``calls`` under ``spec``; the
    plan's sleeps are recorded, not slept."""
    slept: list = []
    doc = dict(spec)
    plan = faults.FaultPlan(doc["faults"], seed=doc["seed"],
                            sleep=slept.append)
    out = []
    with faults.inject(plan):
        for site in calls:
            before = len(slept)
            try:
                action = faults.fault_point(site, n=1)
            except faults.FaultError as e:
                out.append(("error", str(e)))
                continue
            if action is not None:
                out.append((action.mode, action.spec.fraction))
            elif len(slept) > before:
                out.append(("slept", slept[-1]))
            else:
                out.append(None)
    assert faults.active_plan() is None  # the scope restored the globals
    return out, list(plan.events)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_plans_fire_the_same_sequence(seed):
    rng = np.random.default_rng(100 + seed)
    calls = [SITES[i] for i in rng.integers(0, len(SITES), 400)]
    spec = _chaos_spec(seed)
    jax_seq = _fault_sequence(jfaults, spec, calls)
    port_seq = _fault_sequence(tfaults, spec, calls)
    assert port_seq == jax_seq
    assert any(o is not None for o in port_seq[0])


def test_chaos_spec_loads_alike(tmp_path):
    import json

    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(_chaos_spec(5)))
    jp = jfaults.load_chaos_spec(str(path))
    tp = tfaults.load_chaos_spec(str(path))
    assert [vars(s) for s in tp.specs] == [vars(s) for s in jp.specs]
    assert tp.seed == jp.seed
    for faults in (jfaults, tfaults):
        with pytest.raises(ValueError):
            faults.load_chaos_spec({"faults": [{"site": "x",
                                                "mode": "explode"}]})


@pytest.mark.parametrize("seed", [0, 7])
def test_limiter_trajectory_matches(seed):
    """Bursts of slow samples (back-off) between fast ones (recovery),
    released at varying in-flight depths."""
    rng = np.random.default_rng(seed)
    steps = []  # (latency samples of one step, released together)
    for phase in range(12):
        slow = phase % 3 == 1
        for _ in range(8):
            depth = int(rng.integers(6, 16) if slow else
                        rng.integers(1, 3))
            base = 0.2 if slow else 0.01
            steps.append([float(v) for v in
                          rng.gamma(4.0, base / 4.0, depth)])

    def trajectory(ovl):
        lim = ovl.AdaptiveLimiter(ovl.OverloadConfig(
            seed=seed, initial_inflight=8, max_inflight=32))
        out = []
        for lats in steps:
            held = 0
            while held < len(lats) and lim.try_acquire():
                held += 1
            for lat in lats[:held]:
                lim.release(lat)
            out.append((held, lim.limit, lim.baseline_s))
        return out

    jt, pt = trajectory(jovl), trajectory(tovl)
    assert pt == jt
    limits = {lim for _h, lim, _b in pt}
    assert min(limits) < 8 < max(limits)  # it backed off and recovered


def _qos_script(seed: int):
    rng = np.random.default_rng(seed)
    tenants = ["team-a", "team-b", "team-c", "kube-system"]
    script = []
    for i in range(120):
        tenant = tenants[int(rng.integers(0, len(tenants)))]
        level = "system" if tenant == "kube-system" else "user"
        script.append((i, tenant, level, float(rng.choice(
            [256.0, 1024.0, 4096.0, 16384.0]))))
    return script


@pytest.mark.parametrize("seed", [0, 3])
def test_qos_queue_dequeues_in_the_same_order(seed):
    script = _qos_script(seed)

    def order(qos):
        cfg = qos.QoSConfig(quantum=1024.0, tenant_weights={"team-b": 2},
                            tenant_queue_cost=200000.0)
        levels = {lv.name: lv for lv in cfg.levels}
        q = qos.QoSQueue(cfg)
        decisions = []
        for seq, tenant, level, cost in script:
            ok, victim, reason = q.enqueue(
                qos.Ticket(seq, tenant, levels[level], cost), 48, 1e18)
            decisions.append((seq, ok, getattr(victim, "seq", None),
                              reason))
            if seq % 3 == 2:  # interleave dequeues with arrivals
                t = q.pick_next(lambda tn: 0)
                decisions.append(("pick", getattr(t, "seq", None)))
        while True:
            t = q.pick_next(lambda tn: 0)
            if t is None:
                break
            decisions.append(("pick", t.seq))
        return decisions, q.snapshot()

    assert order(tqos) == order(jqos)


def test_tenant_keys_and_classification_match():
    reqs = [{"namespace": "team-a", "userInfo": {"username": "alice"}},
            {"namespace": "", "userInfo": {
                "username": "system:serviceaccount:kube-system:x"}},
            {"namespace": "gatekeeper-system",
             "userInfo": {"username": "system:admin"}},
            {"namespace": "b", "userInfo": {"username": "break-glass"}}]

    def keys(qos):
        cfg = qos.QoSConfig()
        return [(qos.tenant_of_request(r),
                 cfg.classify(r["namespace"],
                              r["userInfo"]["username"]).name)
                for r in reqs]

    assert keys(tqos) == keys(jqos)


class _Clock:
    """Advances by ``step`` seconds on every read."""

    def __init__(self, step: float):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _controller_run(ovl):
    """Shed reasons and brownout levels of one scripted sequence on one
    thread: a held slot, then queue-full, queue-cost and queue-timeout
    sheds, a chaos shed, and the ladder driven by queue fill."""
    ctl = ovl.OverloadController(
        ovl.OverloadConfig(min_inflight=1, max_inflight=1,
                           initial_inflight=1, queue_depth=1,
                           queue_cost=100.0, queue_timeout_s=1.0,
                           brownout1_enter=0.1, brownout1_exit=0.0,
                           brownout2_enter=0.5, brownout2_exit=0.25),
        clock=_Clock(0.4))
    out = []
    gate = ctl.admit(1.0)
    gate.__enter__()  # the one slot is held
    for cost in (500.0, 1.0):  # over the cost bound, then a timeout
        try:
            with ctl.admit(cost):
                out.append("admitted")
        except ovl.Shed as e:
            out.append((e.reason, e.retry_after_s))
        out.append(("level", ctl.brownout_level()))
    ctl.config.queue_depth = 0
    try:
        with ctl.admit(1.0):
            out.append("admitted")
    except ovl.Shed as e:
        out.append((e.reason, e.retry_after_s))
    ctl.config.queue_depth = 10
    for qlen in (1, 6, 3, 2, 0, 7, 0):
        with ctl._cv:
            ctl._queue_len = qlen
            ctl._pressure_locked()
        out.append(("level", qlen, ctl.brownout_level()))
    gate.__exit__(None, None, None)
    faults = jfaults if ovl is jovl else tfaults
    with faults.inject(faults.FaultPlan([{"site": "webhook.overload",
                                          "mode": "error", "times": 1}])):
        for _ in range(2):
            try:
                with ctl.admit(1.0):
                    out.append("admitted")
            except ovl.Shed as e:
                out.append((e.reason, e.retry_after_s))
    snap = ctl.snapshot()
    out.append(("shed_count", ctl.shed_count, snap.get("brownout_level"),
                snap.get("inflight_limit")))
    return out


def test_overload_controller_sheds_and_brownout_match():
    jt, pt = _controller_run(jovl), _controller_run(tovl)
    assert pt == jt
    reasons = [o[0] for o in pt if isinstance(o, tuple)]
    assert {"queue_cost", "queue_timeout", "queue_full", "chaos"} \
        <= set(reasons)
    assert ("level", 6, 2) in pt and ("level", 2, 1) in pt


def _yield_run(ovl):
    ctl = ovl.OverloadController(ovl.OverloadConfig(),
                                 sleep=lambda s: None)
    out = [ovl.yield_device_lane()]  # nothing installed
    with ovl.activate(ctl):
        for level in (0, 1, 2):
            with ctl._cv:
                ctl._brownout = level
            out.append(ovl.yield_device_lane(max_wait_s=0.05,
                                             poll_s=0.01))
        reg = ovl.DegradationRegistry()
        with ovl.activate_degradations(reg):
            reg.activate(ovl.AUDIT_YIELD_RELEASE, objective="staleness")
            out.append(ovl.yield_device_lane(max_wait_s=0.05, poll_s=0.01))
            reg.release(ovl.AUDIT_YIELD_RELEASE, objective="staleness")
            out.append(ovl.yield_device_lane(max_wait_s=0.05, poll_s=0.01))
    out.append(ovl.active_controller() is None
               and ovl.active_degradations() is None)
    return out


def test_yield_device_lane_honours_audit_yield_release():
    jt, pt = _yield_run(jovl), _yield_run(tovl)
    assert pt == jt
    assert pt[:3] == [0.0, 0.0, 0.0]
    assert pt[3] == pytest.approx(0.05)  # level 2 yields, bounded
    assert pt[4] == 0.0  # released by the staleness objective
    assert pt[5] == pytest.approx(0.05)
    assert pt[6] is True


def _drain_run(ovl):
    from gatekeeper_tpu.metrics.registry import MetricsRegistry as JReg
    from gatekeeper_tpu_torch.metrics.registry import \
        MetricsRegistry as TReg

    reg = (JReg if ovl is jovl else TReg)()
    d = ovl.DrainCoordinator(metrics=reg, clock=_Clock(0.5))
    out = [(d.state, d.draining)]
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        d.begin("signal 15"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.append(sorted(results))
    out.append((d.state, d.draining, d.begin("shutdown")))
    out.append(d.finish())
    out.append((d.state, d.finish(), d.wait_stopped(0)))
    out.append(reg.render().count("gatekeeper_drain_seconds"))
    return out


def test_drain_coordinator_transitions_match():
    jt, pt = _drain_run(jovl), _drain_run(tovl)
    assert pt == jt
    assert pt[0] == ("serving", False)
    assert pt[1] == [False, False, False, True]  # first caller wins
    assert pt[2] == ("draining", True, False)
    assert pt[4][0] == "stopped"


def test_freed_slot_goes_to_the_oldest_waiter():
    """The port's FIFO queue hands a freed slot to its oldest waiter: an
    arrival while someone waits queues behind it.  (The JAX controller
    lets the arrival take the slot first, which starved queued requests
    into ``queue_timeout`` sheds under a 64-client burst; ROADMAP queue
    3.)"""
    ctl = tovl.OverloadController(tovl.OverloadConfig(
        min_inflight=1, max_inflight=1, initial_inflight=1, queue_depth=4,
        queue_timeout_s=10.0))
    order: list = []
    holder = ctl.admit(1.0)
    holder.__enter__()

    def waiter():
        with ctl.admit(1.0):
            order.append("queued first")

    t = threading.Thread(target=waiter)
    t.start()
    for _ in range(500):
        if ctl.snapshot()["queue_depth"] == 1:
            break
        threading.Event().wait(0.01)
    assert ctl.snapshot()["queue_depth"] == 1
    holder.__exit__(None, None, None)  # the slot is free; the waiter's turn
    with ctl.admit(1.0):  # arrives later: queues behind the waiter
        order.append("arrived later")
    t.join(10)
    assert order == ["queued first", "arrived later"]
    assert ctl.shed_count == 0 and ctl.snapshot()["queue_depth"] == 0
