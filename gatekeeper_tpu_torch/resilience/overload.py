"""Overload protection for the serving path: adaptive concurrency,
cost-aware load shedding, brownout ladder, graceful-drain state machine.

The resilience layer (policy.py) protects the server from *dependency*
failures; this module protects it from *its own* overload.  The
reference delegates this tier to kube-apiserver's API Priority and
Fairness (the webhook rides the apiserver's own flow control); we are
our own server, so we carry our own limiter, in the gradient/AIMD
adaptive-concurrency shape production inference gateways use:

- :class:`AdaptiveLimiter` — AIMD on observed review latency vs a
  seeded-deterministic baseline EWMA.  Latency above
  ``threshold × baseline`` over an update window multiplicatively
  decreases the in-flight limit; healthy windows additively increase
  it.  Deterministic for a given (seed, sample sequence), so tests
  replay the exact limit trajectory.
- :class:`OverloadController` — the admission gate in front of
  ``ValidationHandler``: a bounded **cost-aware queue** (cost = object
  bytes × matched-constraint estimate) holds requests that arrive while
  the limiter is full; a request that cannot queue (bounds exceeded,
  queue-wait timeout) is **shed** by raising :class:`Shed`, which the
  webhook maps onto the request's ``failurePolicy`` exactly like a
  deadline miss (Ignore = allow + warning annotation, Fail = 429 with
  Retry-After).
- **Brownout ladder** — before any validation request is shed, the
  controller degrades expensive *optional* work first, driven by queue
  pressure: level 1 serves namespace-label lookups and external-data
  joins stale-from-cache; level 2 additionally makes the audit sweep
  yield the device lane (:func:`yield_device_lane`).  Level 0 is
  bit-identical to no limiter at all (the overload differential test
  pins this).
- :class:`DrainCoordinator` — the graceful-drain state machine
  (``serving → draining → stopped``) wired into ``__main__``: on
  SIGTERM readiness flips 503, the listener stops accepting, in-flight
  handlers and the Batcher queue drain within ``--drain-timeout``, the
  tracer/metrics flush, worker children drain in sequence — zero
  in-flight verdicts lost.

Activation mirrors faults.py: :func:`install` process-global (the CLI),
:func:`activate` contextvar-free scoped helper for tests, and cheap
module-level reads (:func:`current_brownout`) for consumers on other
layers (externaldata, audit).

Copy of ``gatekeeper_tpu/resilience/overload.py`` with one fix: the FIFO
admission queue hands a freed slot to its oldest waiter.  The JAX
controller lets a new arrival take a freed slot before the queued
waiters (they poll every 50 ms), so under a closed-loop burst queued
requests starve until ``queue_timeout_s`` and shed.
"""

from __future__ import annotations

import json
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional


class Shed(Exception):
    """The admission gate refused this request (queue bounds exceeded,
    queue-wait timeout, or an injected ``webhook.overload`` chaos
    fault).  The webhook resolves it per the request's failurePolicy —
    never by dropping the connection."""

    def __init__(self, reason: str = "overload",
                 retry_after_s: float = 1.0):
        super().__init__(f"request shed under overload ({reason}); "
                         f"retry in {retry_after_s:.1f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class OverloadConfig:
    """Knobs for the limiter + admission queue + brownout ladder."""

    # per-tenant / per-priority QoS (resilience/qos.py): a parsed
    # QoSConfig replaces the single FIFO with priority lanes +
    # weighted-fair (deficit-round-robin) dequeue across tenants,
    # per-tenant inflight caps / queue-cost budgets, and tenant-aware
    # displacement.  None (the compat default, `--qos off`) keeps the
    # single-FIFO path bit-identical (differential-tested).
    qos: Optional[object] = None

    # adaptive concurrency (AIMD)
    min_inflight: int = 1
    max_inflight: int = 64
    initial_inflight: int = 8
    ewma_alpha: float = 0.1  # baseline EWMA smoothing
    latency_threshold: float = 2.0  # window avg > threshold*baseline: back off
    decrease_factor: float = 0.7  # multiplicative decrease
    increase_step: float = 1.0  # additive increase per healthy window
    update_window: int = 16  # samples per AIMD decision
    # fraction of *congested* samples fed to the baseline EWMA (seeded
    # RNG): the baseline tracks slow drift without learning queueing
    # delay as the new normal
    congested_sample_p: float = 0.05
    seed: int = 0
    # cost-aware admission queue (cost = object bytes x matched-constraint
    # estimate); both bounds shed when exceeded
    queue_depth: int = 256
    queue_cost: float = 256e6
    queue_timeout_s: float = 1.0  # max wait for a limiter slot
    shed_retry_after_s: float = 1.0
    # brownout ladder thresholds on queue fill fraction
    # (max of depth-fill and cost-fill), with exit hysteresis
    brownout1_enter: float = 0.05
    brownout1_exit: float = 0.0
    brownout2_enter: float = 0.5
    brownout2_exit: float = 0.25


class AdaptiveLimiter:
    """AIMD in-flight limiter against a seeded-deterministic latency
    baseline EWMA.

    The baseline learns from samples observed while the lane was
    *uncongested* (in-flight at release time ≤ half the limit) plus a
    seeded ``congested_sample_p`` trickle of loaded samples, so a
    sustained overload cannot teach the limiter that queueing delay is
    normal.  Every decision is a pure function of (config, seed, sample
    sequence): tests replay the exact limit trajectory."""

    def __init__(self, config: Optional[OverloadConfig] = None,
                 metrics=None):
        self.config = config or OverloadConfig()
        c = self.config
        self.metrics = metrics
        self._limit = float(
            min(c.max_inflight, max(c.min_inflight, c.initial_inflight)))
        self._inflight = 0
        self._baseline: Optional[float] = None
        self._win_sum = 0.0
        self._win_n = 0
        self._rng = random.Random(c.seed)
        self._lock = threading.Lock()
        self._export()

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def baseline_s(self) -> Optional[float]:
        with self._lock:
            return self._baseline

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight < int(self._limit):
                self._inflight += 1
                return True
            return False

    def cancel(self) -> None:
        """Give back a slot WITHOUT a latency sample (the QoS
        dispatcher speculatively acquires before picking a ticket; a
        pick that comes back empty must not feed the AIMD window)."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def release(self, latency_s: float) -> None:
        c = self.config
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            # uncongested at release: this sample measured service time,
            # not queueing — feed the baseline
            uncongested = (self._inflight + 1) <= max(
                1, int(self._limit) // 2)
            if self._baseline is None:
                self._baseline = latency_s
            elif uncongested or self._rng.random() < c.congested_sample_p:
                self._baseline += c.ewma_alpha * (
                    latency_s - self._baseline)
            self._win_sum += latency_s
            self._win_n += 1
            if self._win_n >= c.update_window:
                avg = self._win_sum / self._win_n
                self._win_sum, self._win_n = 0.0, 0
                if self._baseline and \
                        avg > c.latency_threshold * self._baseline:
                    self._limit = max(float(c.min_inflight),
                                      self._limit * c.decrease_factor)
                else:
                    self._limit = min(float(c.max_inflight),
                                      self._limit + c.increase_step)
        self._export()

    def _export(self) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        self.metrics.set_gauge(M.OVERLOAD_INFLIGHT_LIMIT, self.limit)


def estimate_cost(review_body: dict, cost_hint: int = 0,
                  constraint_count: Optional[Callable[[str], int]] = None
                  ) -> float:
    """Admission cost = object bytes × matched-constraint estimate.

    ``cost_hint`` is the HTTP Content-Length when the server knows it
    (the cheap path); otherwise the request object is sized by one
    compact serialize.  ``constraint_count(kind)`` is the caller's
    cached matched-constraint estimator (ValidationHandler caches per
    kind)."""
    req = review_body.get("request") or {}
    nbytes = int(cost_hint or 0)
    if nbytes <= 0:
        obj = req.get("object")
        if obj is not None:
            try:
                nbytes = len(json.dumps(obj, separators=(",", ":")))
            except (TypeError, ValueError):
                nbytes = 1024
        else:
            nbytes = 64
    n_cons = 1
    if constraint_count is not None:
        kind = ((req.get("kind") or {}).get("kind", "")) or ""
        try:
            n_cons = max(1, int(constraint_count(kind)))
        except Exception:
            n_cons = 1
    return float(max(1, nbytes)) * n_cons


# --- degradation registry (per-objective SLO degradation maps) ------------

# built-in action names: the vocabulary objectives' ``degradation``
# maps draw from.  Consumers poll :func:`degradation_active` — the
# registry holds WHO degraded WHAT and why; the consumers stay dumb.
NS_CACHE_STALE = "ns_cache_stale"
EXTDATA_STALE = "extdata_stale"
SHED_HARDER = "shed_harder"
AUDIT_YIELD_RELEASE = "audit_yield_release"
RESYNC_DEFER = "resync_defer"
DEVICE_RESIDENCY_EVICT = "device_residency_evict"

BUILTIN_ACTIONS = {
    NS_CACHE_STALE:
        "serve namespace-label lookups stale-from-cache",
    EXTDATA_STALE:
        "serve external-data joins stale from resident columns",
    SHED_HARDER:
        "halve the admission queue bounds so overload sheds earlier",
    AUDIT_YIELD_RELEASE:
        "stop yielding the device lane to admissions (audit catches up)",
    RESYNC_DEFER:
        "defer the audit's periodic full resync",
    DEVICE_RESIDENCY_EVICT:
        "demote device-resident snapshot groups back to host columns "
        "(frees HBM; ticks re-pay the H2D wire until release)",
}


class DegradationRegistry:
    """Named, revocable degradation actions the SLO engine activates
    per objective (observability/slo.py degradation maps).

    Where the brownout ladder is one scalar — queue pressure degrades
    EVERYTHING a level at a time — the registry is targeted: a
    breaching ``admission-latency-p99`` activates ``ns_cache_stale``
    without touching the audit lane, and a breaching
    ``audit-snapshot-staleness`` releases the audit's device-lane
    yield without staling the webhook's caches.  Activations are
    reference-held per (action, cluster): several objectives may hold
    the same action; the action releases only when the last holder
    lets go.  Cluster-scoped activations (fleet mode) never leak:
    a consumer asking with ``cluster="b"`` sees only global (``""``)
    and ``"b"``-scoped activations."""

    def __init__(self, metrics=None):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._known = dict(BUILTIN_ACTIONS)
        self._hooks: dict = {}  # name -> (on_activate, on_release)
        # (action, cluster) -> set of holder objective names
        self._active: dict = {}
        self.transitions = 0  # total activate/release edges

    # --- registration ----------------------------------------------------
    def register(self, name: str, description: str = "",
                 on_activate=None, on_release=None) -> None:
        """Declare an action (consumers: overload controller, the
        ProviderCache, the AuditManager).  ``on_activate(cluster)`` /
        ``on_release(cluster)`` fire on the action's rising/falling
        edge; exceptions are swallowed — degradation must never take
        the server down."""
        with self._lock:
            self._known[name] = description or self._known.get(name, "")
            if on_activate is not None or on_release is not None:
                self._hooks[name] = (on_activate, on_release)

    def known(self) -> set:
        with self._lock:
            return set(self._known)

    def describe(self, name: str) -> str:
        with self._lock:
            return self._known.get(name, "")

    def validate(self, actions, where: str = "") -> None:
        """Raise ``ValueError`` naming the first unknown action — the
        boot-time check behind ``--slo-config`` degradation maps."""
        known = self.known()
        for a in actions:
            if a not in known:
                raise ValueError(
                    f"{where or 'degradation map'}: unknown degradation "
                    f"action {a!r} (registered: {sorted(known)})")

    # --- activation ------------------------------------------------------
    def activate(self, name: str, objective: str = "",
                 cluster: str = "") -> bool:
        """Hold ``name`` active on behalf of ``objective`` (scoped to
        ``cluster``; ``""`` = global).  True on the rising edge."""
        with self._lock:
            if name not in self._known:
                raise ValueError(f"unknown degradation action {name!r}")
            holders = self._active.setdefault((name, cluster), set())
            rising = not holders
            holders.add(objective or "")
            if rising:
                self.transitions += 1
        self._export(name, objective, cluster, 1.0)
        if rising:
            self._fire(name, cluster, 0)
        return rising

    def release(self, name: str, objective: str = "",
                cluster: str = "") -> bool:
        """Let go of ``name``; True on the falling edge (last holder
        released)."""
        with self._lock:
            holders = self._active.get((name, cluster))
            if holders is None:
                return False
            holders.discard(objective or "")
            falling = not holders
            if falling:
                del self._active[(name, cluster)]
                self.transitions += 1
        self._export(name, objective, cluster, 0.0)
        if falling:
            self._fire(name, cluster, 1)
        return falling

    def is_active(self, name: str, cluster: str = "") -> bool:
        """Does this action bind a consumer scoped to ``cluster``?
        Global activations bind every scope; cluster-scoped ones bind
        only their own cluster (the fleet isolation pin)."""
        with self._lock:
            if self._active.get((name, "")):
                return True
            return bool(cluster and self._active.get((name, cluster)))

    def active(self) -> list:
        """[{action, cluster, objectives}] snapshot, sorted — the
        ``/debug/overload`` + flight-recorder view."""
        with self._lock:
            return [{"action": n, "cluster": c,
                     "objectives": sorted(hs)}
                    for (n, c), hs in sorted(self._active.items())]

    def active_names(self) -> list:
        """Compact ``action`` / ``action@cluster`` strings (the
        flight-recorder overload snapshot)."""
        with self._lock:
            return [n if not c else f"{n}@{c}"
                    for (n, c) in sorted(self._active)]

    def _export(self, name, objective, cluster, value) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        labels = {"objective": objective or "", "action": name}
        if cluster:
            labels["cluster"] = cluster
        self.metrics.set_gauge(M.SLO_DEGRADATION, value, labels)

    def _fire(self, name, cluster, which) -> None:
        hooks = self._hooks.get(name)
        if hooks is None or hooks[which] is None:
            return
        try:
            hooks[which](cluster)
        except Exception:
            pass


class OverloadController:
    """The admission gate: limiter slot or bounded cost-aware queue or
    shed.  ``admit(cost)`` is the single seam the webhook wraps its
    review in; the measured time inside is the latency sample the
    limiter adapts on."""

    def __init__(self, config: Optional[OverloadConfig] = None,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.config = config or OverloadConfig()
        self.metrics = metrics
        self.limiter = AdaptiveLimiter(self.config, metrics=metrics)
        self._clock = clock
        self._sleep = sleep
        self._cv = threading.Condition()
        self._queue_len = 0
        self._queue_cost = 0.0
        # the FIFO queue's waiters, oldest first: one Event each, set when
        # a slot may be free for the head (see _queue_for_slot)
        from collections import deque as _deque

        self._waiters = _deque()
        self._brownout = 0
        self.shed_count = 0  # total sheds (tests/introspection)
        # optional SLO-burn pressure input (observability/slo.py): a
        # callable -> 0..1 folded into the brownout fill alongside queue
        # pressure, so a burning latency objective can brown out optional
        # work BEFORE the queue itself backs up.  None (the default)
        # keeps the queue-only behavior bit-identical.
        self._slo_input = None
        # per-tenant / per-priority QoS (resilience/qos.py): when the
        # config carries a QoSConfig the admission queue is the
        # priority-lane DRR queue; None keeps the single FIFO
        self._queue_qos = None
        self._tenant_inflight: dict = {}
        # per-priority-lane inflight (QoS mode): the demand-aware
        # assuredConcurrencyShares input — a lane at its assured
        # concurrency yields freed slots to lower lanes with demand
        self._lane_inflight: dict = {}
        self._exported_tenants: set = set()
        self._seq = 0
        self._tenant_cost_input = None
        # the deterministic dequeue/shed trajectory (QoS mode only):
        # ("grant", seq, tenant, priority) / ("shed", seq, tenant,
        # reason) in decision order — identical (config, seed, arrival
        # order) replays it exactly (pinned in tests; /debug/overload
        # reports its length)
        from collections import deque as _deque

        self.trajectory = _deque(maxlen=16384)
        self._ledger_qos = None
        if self.config.qos is not None:
            from gatekeeper_tpu_torch.resilience.qos import (QoSQueue,
                                                       TenantCostLedger)

            self._ledger_qos = TenantCostLedger()
            self._queue_qos = QoSQueue(self.config.qos,
                                       heaviness=self._heaviness,
                                       cap_fn=self._tenant_cap)

    def _tenant_cap(self) -> int:
        """The per-tenant inflight cap in force: the configured
        ``tenantInflightCap`` scaled by the AIMD limiter's CURRENT limit
        over ``max_inflight`` (floor 1).  A cap chosen as a fraction of
        healthy capacity keeps that fraction when the limiter collapses
        — a static 8 over a collapsed limit of 4 would hand one tenant
        every slot and void the isolation guarantee.  0 (no configured
        cap) stays unbounded."""
        cap = self.config.qos.tenant_inflight_cap
        if cap <= 0:
            return 0
        base = max(1, self.config.max_inflight)
        lim = self.limiter.limit
        if lim >= base:
            return cap
        return max(1, (cap * lim + base - 1) // base)

    # --- admission -------------------------------------------------------
    @contextmanager
    def admit(self, cost: float = 1.0, tenant: str = "", priority=None):
        """Admission gate: acquire a limiter slot (immediately or via the
        bounded queue) or raise :class:`Shed`.  The body's wall time is
        the limiter's latency sample.

        ``tenant``/``priority`` (a :class:`qos.PriorityLevel`) engage
        the QoS queue when the controller was built with a QoSConfig
        (see :meth:`route`); with QoS off both are ignored and the path
        is the single FIFO, bit-identical."""
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        # the chaos seam for this tier: error mode forces a shed (the
        # failurePolicy plumbing downstream is what's under test);
        # sleep/hang stall the gate like a saturated queue would
        fault_point("webhook.overload",
                    error_factory=lambda spec: Shed(
                        reason="chaos",
                        retry_after_s=spec.delay_s or 1.0))
        if self._queue_qos is None:
            # a free slot goes to the queue's head first: an arrival takes
            # one directly only while nobody waits
            with self._cv:
                fast = not self._waiters and self.limiter.try_acquire()
            if not fast:
                self._queue_for_slot(cost)  # raises Shed on refusal
        else:
            from gatekeeper_tpu_torch.resilience import qos as _qos

            tenant = tenant or _qos.CLUSTER_TENANT
            if priority is None:
                priority = self.config.qos.classify("", "")
            self._qos_admit(cost, tenant, priority)  # raises Shed
        t0 = self._clock()
        try:
            yield
        finally:
            self.limiter.release(self._clock() - t0)
            with self._cv:
                if self._queue_qos is not None:
                    n = self._tenant_inflight.get(tenant, 0) - 1
                    if n <= 0:
                        self._tenant_inflight.pop(tenant, None)
                    else:
                        self._tenant_inflight[tenant] = n
                    ln = self._lane_inflight.get(priority.name, 0) - 1
                    if ln <= 0:
                        self._lane_inflight.pop(priority.name, None)
                    else:
                        self._lane_inflight[priority.name] = ln
                    self._dispatch_locked()
                    self._pressure_locked()
                    self._cv.notify_all()
                elif self._waiters:
                    self._waiters[0].set()  # the head takes the slot

    # --- QoS path (resilience/qos.py) ------------------------------------
    def route(self, review_body: dict) -> tuple:
        """(tenant, PriorityLevel) of an AdmissionReview body under the
        active QoS config; ("", None) with QoS off.  The webhook
        handlers call this once and pass the result to :meth:`admit`
        (and to the flight recorder / cost grid as the tenant axis)."""
        if self._queue_qos is None:
            return "", None
        from gatekeeper_tpu_torch.resilience import qos as _qos

        req = review_body.get("request") or {}
        cfg = self.config.qos
        tenant = _qos.tenant_of_request(req, cfg.tenant_key)
        level = cfg.classify(
            req.get("namespace", "") or "",
            ((req.get("userInfo") or {}).get("username", "")) or "")
        return tenant, level

    def _heaviness(self, tenant: str) -> float:
        """Displacement ranking: the internal decayed admitted-cost
        ledger plus (when wired) the cost-attribution ``{tenant}``
        axis — "shed the heaviest tenant first" keys on measured cost,
        not arrival order."""
        h = self._ledger_qos.heaviness(tenant) \
            if self._ledger_qos is not None else 0.0
        if self._tenant_cost_input is not None:
            try:
                ext = self._tenant_cost_input() or {}
                # seconds-scale attribution vs bytes-scale ledger: weigh
                # the external axis up so measured eval cost dominates
                # once present
                h += float(ext.get(tenant, 0.0)) * 1e6
            except Exception:
                pass  # attribution must never break admission
        return h

    def set_tenant_cost_input(self, fn) -> None:
        """Wire a per-tenant cost source (callable -> {tenant: cost},
        e.g. ``CostAttribution.tenant_totals``); None disconnects."""
        with self._cv:
            self._tenant_cost_input = fn

    def _qos_admit(self, cost: float, tenant: str, level) -> None:
        from gatekeeper_tpu_torch.resilience.qos import Ticket

        c = self.config
        cap = self._tenant_cap()
        q_depth, q_cost = self._queue_bounds()
        with self._cv:
            t = Ticket(self._seq, tenant, level, cost)
            self._seq += 1
            # fast path: nothing queued ahead, tenant under its cap, a
            # free slot — grant without touching the queue (an idle
            # server admits with zero scheduling overhead)
            if self._queue_qos.depth == 0 and not (
                    cap > 0
                    and self._tenant_inflight.get(tenant, 0) >= cap) \
                    and self.limiter.try_acquire():
                self._grant_locked(t)
                return
            admitted, victim, reason = self._queue_qos.enqueue(
                t, q_depth, q_cost)
            if victim is not None:
                # tenant-aware displacement: the heaviest tenant's
                # newest ticket pays instead of this arrival
                self.trajectory.append(
                    ("shed", victim.seq, victim.tenant, "displaced"))
                self._cv.notify_all()
            if not admitted:
                self.trajectory.append(("shed", t.seq, tenant, reason))
                self._pressure_locked()
                self._shed_locked(reason, tenant=tenant,
                                  priority=level.name)
            self._pressure_locked()
            self._dispatch_locked()
            end = self._clock() + max(0.0, c.queue_timeout_s)
            try:
                while not t.granted and t.shed is None:
                    remaining = end - self._clock()
                    if remaining <= 0:
                        # remove() False means the dispatcher granted or
                        # displaced this ticket concurrently with the
                        # timeout expiry — shedding then would leak the
                        # already-acquired slot; fall through and let
                        # the ticket's own state decide
                        if self._queue_qos.remove(t):
                            self.trajectory.append(
                                ("shed", t.seq, tenant, "queue_timeout"))
                            self._shed_locked("queue_timeout",
                                              tenant=tenant,
                                              priority=level.name)
                        break
                    self._cv.wait(min(remaining, 0.05))
                if t.shed is not None:
                    # displaced while waiting (trajectory already
                    # recorded at the displacement decision)
                    self._shed_locked(t.shed, tenant=tenant,
                                      priority=level.name)
            finally:
                self._pressure_locked()

    def _grant_locked(self, t) -> None:
        t.granted = True
        self._tenant_inflight[t.tenant] = \
            self._tenant_inflight.get(t.tenant, 0) + 1
        self._lane_inflight[t.level.name] = \
            self._lane_inflight.get(t.level.name, 0) + 1
        if self._ledger_qos is not None:
            self._ledger_qos.charge(t.tenant, t.cost)
        self.trajectory.append(
            ("grant", t.seq, t.tenant, t.level.name))

    def _dispatch_locked(self) -> None:
        """Hand freed limiter slots to queued tickets in QoS order:
        strict priority across lanes, DRR across tenants, per-tenant
        inflight caps honored (call under ``_cv``)."""
        q = self._queue_qos
        granted = False
        while q.depth:
            if not self.limiter.try_acquire():
                break
            t = q.pick_next(
                lambda tn: self._tenant_inflight.get(tn, 0),
                lane_inflight_of=lambda nm: self._lane_inflight.get(nm, 0),
                limit=int(self.limiter.limit))
            if t is None:
                # every queued tenant is at its inflight cap: the slot
                # goes back without an AIMD sample
                self.limiter.cancel()
                break
            self._grant_locked(t)
            granted = True
        if granted:
            self._pressure_locked()
            self._cv.notify_all()

    def _queue_bounds(self) -> tuple:
        """(depth, cost) queue bounds in force: the configured bounds,
        halved while the ``shed_harder`` degradation action is active
        (a breaching latency objective's last resort — shed earlier
        instead of queueing deeper).  Inactive = bit-identical."""
        c = self.config
        if degradation_active(SHED_HARDER):
            return max(1, c.queue_depth // 2), c.queue_cost / 2.0
        return c.queue_depth, c.queue_cost

    def _queue_for_slot(self, cost: float) -> None:
        """Wait in the FIFO queue for a limiter slot, or shed.  Only the
        head acquires; a release (or the head leaving) sets the head's
        event, so waiters neither poll nor race later arrivals for a
        freed slot (the JAX package's queue lets an arrival take a freed
        slot first, starving queued waiters into ``queue_timeout``)."""
        c = self.config
        q_depth, q_cost = self._queue_bounds()
        with self._cv:
            depth_full = self._queue_len + 1 > q_depth
            cost_full = self._queue_cost + cost > q_cost
            if depth_full or cost_full:
                self._shed_locked(
                    "queue_cost" if cost_full and not depth_full
                    else "queue_full")
            self._queue_len += 1
            self._queue_cost += cost
            self._pressure_locked()
            waiter = threading.Event()
            self._waiters.append(waiter)
            end = self._clock() + max(0.0, c.queue_timeout_s)
        try:
            while True:
                with self._cv:
                    if self._waiters[0] is waiter and \
                            self.limiter.try_acquire():
                        return
                    remaining = end - self._clock()
                    if remaining <= 0:
                        self._shed_locked("queue_timeout")
                    waiter.clear()
                waiter.wait(remaining)
        finally:
            with self._cv:
                self._waiters.remove(waiter)
                self._queue_len -= 1
                self._queue_cost -= cost
                self._pressure_locked()
                if self._waiters:
                    self._waiters[0].set()  # the next head's turn

    def _shed_locked(self, reason: str, tenant: str = "",
                     priority: str = "") -> None:
        self.shed_count += 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            labels = {"reason": reason}
            # QoS mode: the shed counter grows {tenant, priority} axes
            # (bounded by the registry's cardinality guard); the legacy
            # path keeps the {reason}-only labelset bit-identical
            if tenant:
                labels["tenant"] = tenant
            if priority:
                labels["priority"] = priority
            self.metrics.inc_counter(M.OVERLOAD_SHED, labels)
        try:
            from gatekeeper_tpu_torch.utils.logging import log_event

            log_event("warning", "request shed under overload",
                      event_type="overload_shed", reason=reason,
                      queue_depth=self._queue_len,
                      inflight_limit=self.limiter.limit,
                      **({"tenant": tenant} if tenant else {}),
                      **({"priority": priority} if priority else {}))
        except Exception:
            pass
        raise Shed(reason=reason,
                   retry_after_s=self.config.shed_retry_after_s)

    # --- brownout ladder -------------------------------------------------
    def _pressure_locked(self) -> None:
        """Recompute queue fill + brownout level (call under _cv)."""
        c = self.config
        if self._queue_qos is not None:
            # the QoS queue owns depth/cost; mirror into the legacy
            # fields so the ladder math (and its metrics) stay one code
            # path for both modes
            self._queue_len = self._queue_qos.depth
            self._queue_cost = self._queue_qos.cost_total
            self._export_qos_locked()
        fill = 0.0
        if c.queue_depth > 0:
            fill = max(fill, self._queue_len / c.queue_depth)
        if c.queue_cost > 0:
            fill = max(fill, self._queue_cost / c.queue_cost)
        if self._slo_input is not None:
            try:
                fill = max(fill, min(1.0, float(self._slo_input())))
            except Exception:
                pass  # the SLO engine must never break admission
        lvl = self._brownout
        if fill >= c.brownout2_enter or \
                (lvl >= 2 and fill > c.brownout2_exit):
            new = 2
        elif fill >= c.brownout1_enter or \
                (lvl >= 1 and fill > c.brownout1_exit):
            new = 1
        else:
            new = 0
        if new != lvl:
            self._brownout = new
            try:
                from gatekeeper_tpu_torch.utils.logging import log_event

                log_event("warning" if new > lvl else "info",
                          "overload brownout level change",
                          event_type="overload_brownout",
                          brownout_from=lvl, brownout_to=new,
                          queue_fill=round(fill, 3))
            except Exception:
                pass
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.OVERLOAD_QUEUE_DEPTH, self._queue_len)
            self.metrics.set_gauge(M.OVERLOAD_BROWNOUT, self._brownout)

    def set_slo_input(self, fn) -> None:
        """Wire an SLO-burn pressure source (callable -> 0..1, e.g.
        ``SLOEngine.pressure``); None disconnects."""
        with self._cv:
            self._slo_input = fn
            self._pressure_locked()

    def set_qos_ledger_clock(self, clock, half_life_s: float) -> None:
        """``--qos-ledger-decay slo-window``: drive the displacement
        ledger's decay from the SLO engine's window clock (totals halve
        per elapsed ``half_life_s``) instead of the event counter —
        "heaviest tenant" then ages on the same timebase the burn-rate
        windows use.  No-op with QoS off; ``clock=None`` restores the
        bit-identical event-count default."""
        with self._cv:
            if self._ledger_qos is not None:
                self._ledger_qos.set_clock(clock, half_life_s)

    def refresh_pressure(self) -> int:
        """Recompute the brownout level outside a queue event (the SLO
        engine calls this each tick so burn changes move the ladder even
        while the queue is idle).  Returns the level."""
        with self._cv:
            self._pressure_locked()
            return self._brownout

    def _export_qos_locked(self) -> None:
        """Per-lane / per-tenant gauges (QoS mode; call under _cv).
        Tenants that left the queue zero out instead of lingering at
        their last value."""
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        q = self._queue_qos
        for lane in q.lanes:
            self.metrics.set_gauge(M.OVERLOAD_LANE_DEPTH, lane.depth(),
                                   {"priority": lane.level.name})
        current = set(q.tenant_cost) | set(self._tenant_inflight)
        for tn in self._exported_tenants - current:
            self.metrics.set_gauge(M.OVERLOAD_TENANT_COST, 0.0,
                                   {"tenant": tn})
            self.metrics.set_gauge(M.OVERLOAD_TENANT_INFLIGHT, 0,
                                   {"tenant": tn})
        for tn in current:
            self.metrics.set_gauge(M.OVERLOAD_TENANT_COST,
                                   q.tenant_cost.get(tn, 0.0),
                                   {"tenant": tn})
            self.metrics.set_gauge(M.OVERLOAD_TENANT_INFLIGHT,
                                   self._tenant_inflight.get(tn, 0),
                                   {"tenant": tn})
        self._exported_tenants = current

    def brownout_level(self) -> int:
        with self._cv:
            return self._brownout

    def queue_depth(self) -> int:
        with self._cv:
            if self._queue_qos is not None:
                return self._queue_qos.depth
            return self._queue_len

    def snapshot(self) -> dict:
        """The ``/debug/overload`` payload: limiter + ladder state, and
        (QoS mode) the full lane view — per-priority queue depths,
        per-tenant queued cost / deficit / weight / inflight, the
        heaviness ranking displacement keys on, and the trajectory
        length (the deterministic dequeue/shed event count)."""
        with self._cv:
            out = {
                "mode": "qos" if self._queue_qos is not None else "fifo",
                "brownout": self._brownout,
                "inflight": self.limiter.inflight,
                "inflight_limit": self.limiter.limit,
                "queue_depth": (self._queue_qos.depth
                                if self._queue_qos is not None
                                else self._queue_len),
                "queue_cost": round(
                    self._queue_qos.cost_total
                    if self._queue_qos is not None
                    else self._queue_cost, 1),
                "shed_count": self.shed_count,
            }
            reg = active_degradations()
            if reg is not None:
                # targeted SLO degradations in force (the /debug/
                # overload + gator triage view of the maps)
                out["degraded"] = reg.active()
            if self._queue_qos is not None:
                cfg = self.config.qos
                out["qos"] = self._queue_qos.snapshot()
                out["qos"]["tenant_inflight"] = dict(self._tenant_inflight)
                out["qos"]["lane_inflight"] = dict(self._lane_inflight)
                out["qos"]["tenant_inflight_cap"] = cfg.tenant_inflight_cap
                out["qos"]["tenant_queue_cost"] = cfg.tenant_queue_cost
                if self._ledger_qos is not None:
                    out["qos"]["tenant_heaviness"] = {
                        t: round(v, 1) for t, v in sorted(
                            self._ledger_qos.totals().items(),
                            key=lambda kv: -kv[1])[:32]}
                out["qos"]["trajectory_len"] = len(self.trajectory)
            return out


# --- activation (mirrors faults.py: process-global + scoped) --------------

_active: list = [None]


def install(controller: Optional[OverloadController]) -> None:
    """Process-global activation (the serving entrypoint)."""
    _active[0] = controller


def uninstall() -> None:
    _active[0] = None


@contextmanager
def activate(controller: OverloadController):
    """Scoped activation for tests; restores the previous controller."""
    prev = _active[0]
    _active[0] = controller
    try:
        yield controller
    finally:
        _active[0] = prev


def active_controller() -> Optional[OverloadController]:
    return _active[0]


def current_brownout() -> int:
    """Brownout level of the installed controller (0 when none) — the
    cheap cross-layer read for optional-work consumers (externaldata
    stale serves, audit device-lane yield)."""
    ctl = _active[0]
    if ctl is None:
        return 0
    return ctl.brownout_level()


# the degradation registry rides the same pattern, separately
# installable: scalar brownout (--slo-brownout) and targeted maps
# (--slo-degradation) compose — consumers OR the two signals
_degradations: list = [None]


def install_degradations(reg: Optional[DegradationRegistry]) -> None:
    """Process-global DegradationRegistry (the serving entrypoint)."""
    _degradations[0] = reg


def uninstall_degradations() -> None:
    _degradations[0] = None


@contextmanager
def activate_degradations(reg: DegradationRegistry):
    """Scoped registry activation for tests."""
    prev = _degradations[0]
    _degradations[0] = reg
    try:
        yield reg
    finally:
        _degradations[0] = prev


def active_degradations() -> Optional[DegradationRegistry]:
    return _degradations[0]


def degradation_active(name: str, cluster: str = "") -> bool:
    """Is the named degradation action in force for this scope?  The
    cheap cross-layer read consumers OR with :func:`current_brownout`
    (False when no registry is installed — bit-identical default)."""
    reg = _degradations[0]
    return reg is not None and reg.is_active(name, cluster)


def yield_device_lane(level: int = 2, max_wait_s: float = 0.25,
                      poll_s: float = 0.01, cluster: str = "") -> float:
    """Brownout level-2 hook for the audit sweep: while the webhook lane
    is under heavy queue pressure, the sweep pauses before submitting its
    next chunk so admission batches win the device.  Bounded by
    ``max_wait_s`` per call — audit degrades, it never stalls.  Returns
    the seconds actually yielded.

    A breaching audit-staleness objective activates
    ``audit_yield_release`` (scoped to ``cluster`` in fleet mode):
    the audit stops ceding the device so it can catch up — staleness
    outranks latency once the staleness objective itself is paging."""
    if degradation_active(AUDIT_YIELD_RELEASE, cluster):
        return 0.0
    ctl = _active[0]
    if ctl is None or ctl.brownout_level() < level:
        return 0.0
    waited = 0.0
    while waited < max_wait_s and ctl.brownout_level() >= level:
        ctl._sleep(poll_s)
        waited += poll_s
    if waited and ctl.metrics is not None:
        from gatekeeper_tpu_torch.metrics import registry as M

        ctl.metrics.inc_counter(
            M.RESILIENCE_DEGRADED,
            {"component": "audit", "to": "device_lane_yield"})
    return waited


# --- graceful drain -------------------------------------------------------

SERVING, DRAINING, STOPPED = "serving", "draining", "stopped"


class DrainCoordinator:
    """The shutdown state machine: ``serving → draining → stopped``.

    ``begin()`` is idempotent and first-caller-wins (SIGTERM may arrive
    twice); readiness checks gate on :attr:`draining` so the LB pulls
    the pod before the listener closes.  ``finish()`` records the drain
    duration into ``gatekeeper_drain_seconds``."""

    def __init__(self, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._state = SERVING
        self._begun_at: Optional[float] = None
        self.drain_seconds: Optional[float] = None
        self._stopped = threading.Event()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._state != SERVING

    def begin(self, reason: str = "") -> bool:
        """Enter DRAINING; True for the first caller only."""
        with self._lock:
            if self._state != SERVING:
                return False
            self._state = DRAINING
            self._begun_at = self._clock()
        try:
            from gatekeeper_tpu_torch.utils.logging import log_event

            log_event("info", "graceful drain started",
                      event_type="drain_started", reason=reason)
        except Exception:
            pass
        return True

    def finish(self) -> float:
        """Enter STOPPED; records and returns the drain duration."""
        with self._lock:
            if self._state == STOPPED:
                return self.drain_seconds or 0.0
            dt = (self._clock() - self._begun_at
                  if self._begun_at is not None else 0.0)
            self._state = STOPPED
            self.drain_seconds = dt
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.DRAIN_SECONDS, dt)
        self._stopped.set()
        return dt

    def wait_stopped(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)
