"""Per-tenant, per-priority admission QoS for the overload path.

The overload controller's admission gate holds waiting requests in ONE cost-aware FIFO; at
millions-of-users scale a single noisy tenant posting 2MB ConfigMaps
starves kube-system and break-glass traffic — the exact failure mode
kube-apiserver's API Priority & Fairness (APF) exists to solve.  This
module is the APF-shaped replacement the :class:`OverloadController`
mounts when ``--qos on``:

- **Priority lanes** (:class:`PriorityLevel`, configured by a
  ``--qos-config`` JSON mirroring APF's PriorityLevelConfiguration
  shape): strict-priority dequeue across lanes, so system / break-glass
  namespaces are always served ahead of user traffic and shed last.
- **Weighted-fair dequeue across tenants** (:class:`QoSQueue`): within
  a lane, tenants (namespace or serviceaccount, per ``tenantKey``) are
  scheduled by deficit round robin — each visit credits
  ``quantum × weight`` and a ticket is served when the tenant's deficit
  covers its admission cost, so weights hold in COST units even under
  heavily skewed object sizes (a tenant of 2MB ConfigMaps gets the same
  byte share as a tenant of 2KB Pods, not the same request share).
- **Per-tenant inflight caps and queue-cost budgets**: one tenant can
  neither occupy every limiter slot nor fill the shared queue.
- **Tenant-aware displacement**: when the queue overflows, the shed
  target is the newest queued ticket of the HEAVIEST tenant (decayed
  admitted-cost ledger, optionally fed by the cost-attribution
  ``{tenant}`` axis) in the lowest-priority lane — not whoever happens
  to arrive mid-burst — and only if the newcomer outranks it.

Everything here is deterministic: scheduling state advances only on
(enqueue, pick, release) events, the ledger decays by event count, and
ties break lexicographically — identical (config, seed, arrival order)
replays the exact dequeue/shed trajectory (pinned in tests).  The
module is lock-free by design: every method is called under the
OverloadController's condition-variable lock.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

TENANT_NAMESPACE = "namespace"
TENANT_SERVICEACCOUNT = "serviceaccount"

# tenant label for cluster-scoped objects / anonymous users: every
# request maps to SOME tenant so the fairness math has no escape hatch
CLUSTER_TENANT = "_cluster"


@dataclass(frozen=True)
class PriorityLevel:
    """One APF-shaped priority lane.  ``order`` is the dequeue rank
    (lower dequeues first, sheds last); a level with no selectors is a
    catch-all.

    ``shares`` (APF's ``assuredConcurrencyShares``) makes dequeue
    demand-aware: when ANY level declares shares > 0, a lane already
    holding its assured fraction of the limiter (``ceil(limit x shares /
    sum shares)``) yields freed slots to lower-priority lanes with
    queued demand — so a pathological system-lane flood is bounded too,
    instead of starving user traffic forever under strict priority.
    All-zero shares (the default) keeps strict priority bit-identical."""

    name: str
    order: int
    namespaces: tuple = ()
    namespace_prefixes: tuple = ()
    users: tuple = ()
    user_prefixes: tuple = ()
    shares: int = 0

    def matches(self, namespace: str, username: str) -> bool:
        if not (self.namespaces or self.namespace_prefixes
                or self.users or self.user_prefixes):
            return True  # catch-all
        if namespace and namespace in self.namespaces:
            return True
        if namespace and any(namespace.startswith(p)
                             for p in self.namespace_prefixes):
            return True
        if username and username in self.users:
            return True
        if username and any(username.startswith(p)
                            for p in self.user_prefixes):
            return True
        return False


def default_levels() -> list:
    """The built-in lane set (used when --qos-config names none):
    system traffic (kube-system / gatekeeper's own namespace / node and
    apiserver identities) ahead of break-glass ahead of everyone."""
    return [
        PriorityLevel(
            name="system", order=0,
            namespaces=("kube-system", "gatekeeper-system"),
            namespace_prefixes=("kube-",),
            user_prefixes=("system:node:", "system:apiserver",
                           "system:kube-")),
        PriorityLevel(
            name="break-glass", order=10,
            namespace_prefixes=("break-glass",),
            user_prefixes=("break-glass:",)),
        PriorityLevel(name="user", order=100),
    ]


@dataclass
class QoSConfig:
    """Parsed ``--qos-config`` (see :func:`load_qos_config`)."""

    tenant_key: str = TENANT_NAMESPACE
    levels: list = field(default_factory=default_levels)
    tenant_weights: dict = field(default_factory=dict)
    default_weight: float = 1.0
    # 0 disables the bound
    tenant_inflight_cap: int = 0
    tenant_queue_cost: float = 0.0
    # DRR credit per ring visit for a weight-1 tenant, in admission-cost
    # units (object bytes x matched constraints); sized near a typical
    # small object so byte-skew fairness engages within a few visits
    quantum: float = 16384.0

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(
            self.tenant_weights.get(tenant, self.default_weight)))

    def classify(self, namespace: str, username: str) -> PriorityLevel:
        for lv in self.levels:
            if lv.matches(namespace, username):
                return lv
        return self.levels[-1]


def load_qos_config(path: str) -> QoSConfig:
    """Parse a ``--qos-config`` JSON file.  Shape (every field
    optional, mirroring APF's PriorityLevelConfiguration spirit)::

        {"tenantKey": "namespace" | "serviceaccount",
         "priorityLevels": [
           {"name": "system",
            "matchNamespaces": ["kube-system"],
            "matchNamespacePrefixes": ["kube-"],
            "matchUsers": [], "matchUserPrefixes": ["system:node:"]},
           {"name": "user"}],          # no selectors = catch-all
         "tenantWeights": {"team-a": 4},
         "defaultTenantWeight": 1,
         "tenantInflightCap": 8,
         "tenantQueueCost": 64000000,
         "quantum": 16384}

    Lane order is list position (first = highest priority, sheds
    last)."""
    with open(path) as f:
        doc = json.load(f)
    return parse_qos_config(doc)


def parse_qos_config(doc: dict) -> QoSConfig:
    cfg = QoSConfig()
    key = doc.get("tenantKey", cfg.tenant_key)
    if key not in (TENANT_NAMESPACE, TENANT_SERVICEACCOUNT):
        raise ValueError(f"qos tenantKey must be {TENANT_NAMESPACE}|"
                         f"{TENANT_SERVICEACCOUNT}, got {key!r}")
    cfg.tenant_key = key
    raw_levels = doc.get("priorityLevels") or []
    if raw_levels:
        levels = []
        for i, lv in enumerate(raw_levels):
            levels.append(PriorityLevel(
                name=str(lv.get("name") or f"level{i}"),
                order=int(lv.get("order", i * 10)),
                namespaces=tuple(lv.get("matchNamespaces") or ()),
                namespace_prefixes=tuple(
                    lv.get("matchNamespacePrefixes") or ()),
                users=tuple(lv.get("matchUsers") or ()),
                user_prefixes=tuple(lv.get("matchUserPrefixes") or ()),
                shares=int(lv.get("assuredConcurrencyShares", 0)),
            ))
        levels.sort(key=lambda l: (l.order, l.name))
        cfg.levels = levels
    cfg.tenant_weights = {str(k): float(v) for k, v in
                          (doc.get("tenantWeights") or {}).items()}
    cfg.default_weight = float(doc.get("defaultTenantWeight", 1.0))
    cfg.tenant_inflight_cap = int(doc.get("tenantInflightCap", 0))
    cfg.tenant_queue_cost = float(doc.get("tenantQueueCost", 0.0))
    cfg.quantum = float(doc.get("quantum", cfg.quantum))
    return cfg


_SA_PREFIX = "system:serviceaccount:"


def normalize_serviceaccount(username: str) -> Optional[str]:
    """The canonical ``system:serviceaccount:<ns>:<name>`` triple, or
    None when ``username`` is not a well-formed serviceaccount identity.

    ``userInfo.username`` is attacker-influenced on impersonation /
    proxy paths, so the serviceaccount tenant key must not trust it
    verbatim: only an EXACT case-sensitive prefix with exactly two
    non-empty, whitespace-free segments (k8s namespace/SA names — ':'
    is not legal in either) normalizes; anything else (extra segments,
    empty parts, case games like ``System:ServiceAccount:...``) is not
    a serviceaccount and must not be billed as one."""
    if not username.startswith(_SA_PREFIX):
        return None
    rest = username[len(_SA_PREFIX):]
    parts = rest.split(":")
    if len(parts) != 2:
        return None
    ns, name = parts
    if not ns or not name:
        return None
    if ns != ns.strip() or name != name.strip() or " " in ns or \
            " " in name:
        return None
    return _SA_PREFIX + ns + ":" + name


def tenant_of_request(req: dict, tenant_key: str = TENANT_NAMESPACE,
                      cluster: str = "") -> str:
    """Tenant identity of an AdmissionReview ``request`` dict — the
    attribution key shared by QoS, the flight recorder and the cost
    grid's ``{tenant}`` axis.  Under the serviceaccount key, SA-shaped
    usernames normalize through :func:`normalize_serviceaccount`;
    malformed SA triples fold into the cluster tenant (a spoofed-looking
    identity must not mint itself a fresh fair-share queue), and non-SA
    users keep their username.

    ``cluster`` (fleet mode) prefixes the tenant with the serving
    cluster's id — the cluster → tenant → priority routing key: every
    cluster's namespaces get their OWN fair-share queues (``team-a`` on
    cluster-1 and ``team-a`` on cluster-2 are different tenants, with
    independent DRR deficits, inflight caps and displacement ledgers),
    while priority classification stays request-derived — one cluster's
    user flood ranks below every cluster's system lane and can never
    displace it."""
    if tenant_key == TENANT_SERVICEACCOUNT:
        user = ((req.get("userInfo") or {}).get("username", "")) or ""
        if not user:
            tenant = CLUSTER_TENANT
        elif user.lower().startswith(_SA_PREFIX) or \
                user.startswith(_SA_PREFIX):
            tenant = normalize_serviceaccount(user) or CLUSTER_TENANT
        else:
            tenant = user
    else:
        ns = req.get("namespace", "") or ""
        tenant = ns or CLUSTER_TENANT
    return f"{cluster}:{tenant}" if cluster else tenant


class TenantCostLedger:
    """Decayed per-tenant admitted-cost totals — the "who is heaviest"
    input for displacement.  Decay is by EVENT COUNT (every
    ``half_every`` charges all totals halve), not wall time, so a
    replayed admission sequence reproduces the exact heaviness
    trajectory.

    ``set_clock`` (``--qos-ledger-decay slo-window``) arms the optional
    WALL-WINDOW decay driver instead: totals halve once per elapsed
    ``half_life_s`` of the supplied clock — the SLO engine's window
    clock, so "heaviest" ages on the same timebase the burn-rate
    windows use, and an idle gap forgets a past burst the way a burn
    window does (event-count decay can hold a dead tenant heavy
    forever when traffic stops).  Unarmed (the default) the ledger is
    bit-identical to the event-count behavior."""

    def __init__(self, half_every: int = 512):
        self.half_every = max(1, int(half_every))
        self._cost: dict = {}
        self._n = 0
        # wall-window decay driver (None = event-count decay)
        self._clock = None
        self._half_life_s = 0.0
        self._last_half = 0.0

    def set_clock(self, clock, half_life_s: float) -> None:
        """Arm (or, with ``clock=None``, disarm) wall-window decay."""
        if clock is None or half_life_s <= 0:
            self._clock = None
            self._half_life_s = 0.0
            return
        self._clock = clock
        self._half_life_s = float(half_life_s)
        self._last_half = clock()

    def _halve(self) -> None:
        self._cost = {t: c / 2.0 for t, c in self._cost.items()
                      if c / 2.0 > 1.0}

    def charge(self, tenant: str, cost: float) -> None:
        if self._clock is not None:
            # elapsed windows predate this charge: decay FIRST, then
            # land the new cost at full weight
            now = self._clock()
            while now - self._last_half >= self._half_life_s:
                self._halve()
                self._last_half += self._half_life_s
                if not self._cost:
                    # nothing left to decay: snap the window forward so
                    # a long idle gap costs O(1), not O(gap/half_life)
                    self._last_half = now
                    break
            self._cost[tenant] = self._cost.get(tenant, 0.0) \
                + max(0.0, cost)
            return
        self._cost[tenant] = self._cost.get(tenant, 0.0) + max(0.0, cost)
        self._n += 1
        if self._n % self.half_every == 0:
            self._halve()

    def totals(self) -> dict:
        return dict(self._cost)

    def heaviness(self, tenant: str) -> float:
        return self._cost.get(tenant, 0.0)


class Ticket:
    """One queued admission waiting for a limiter slot."""

    __slots__ = ("seq", "tenant", "level", "cost", "granted", "shed")

    def __init__(self, seq: int, tenant: str, level: PriorityLevel,
                 cost: float):
        self.seq = seq
        self.tenant = tenant
        self.level = level
        self.cost = cost
        self.granted = False
        self.shed: Optional[str] = None  # shed reason once decided


class _Lane:
    """Per-priority-level DRR state: tenant FIFOs, the tenant ring in
    activation order, deficits, and the rotating ring index."""

    __slots__ = ("level", "queues", "ring", "deficit", "rr")

    def __init__(self, level: PriorityLevel):
        self.level = level
        self.queues: dict = {}  # tenant -> deque[Ticket]
        self.ring: list = []  # active tenants, activation order
        self.deficit: dict = {}
        self.rr = 0

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())


class QoSQueue:
    """The priority-lane + deficit-round-robin admission queue.

    All methods must be called under the owning controller's lock; the
    queue itself is pure state + deterministic decisions."""

    def __init__(self, config: QoSConfig,
                 heaviness: Optional[Callable[[str], float]] = None,
                 cap_fn: Optional[Callable[[], int]] = None):
        self.config = config
        self._heaviness = heaviness or (lambda tenant: 0.0)
        # live per-tenant inflight cap: the owning
        # controller derives it from the AIMD limiter's CURRENT limit so
        # isolation survives limit collapse — a static cap of 8 over a
        # collapsed limit of 4 would let one tenant own every slot.
        # None keeps the static config cap.
        self._cap_fn = cap_fn
        self.lanes = [_Lane(lv) for lv in config.levels]
        self._by_level = {lv.name: lane
                          for lv, lane in zip(config.levels, self.lanes)}
        self.depth = 0
        self.cost_total = 0.0
        self.tenant_cost: dict = {}  # queued cost per tenant, all lanes
        # demand-aware shares engage only when some level declares them
        # (all-zero keeps the strict-priority dequeue bit-identical,
        # including the seeded trajectory pins)
        self._shares_total = sum(max(0, lv.shares)
                                 for lv in config.levels)

    def assured_cap(self, level: PriorityLevel, limit: int) -> int:
        """APF assured-concurrency value of one lane under the CURRENT
        limiter limit: ``ceil(limit x shares / sum shares)``, floor 1.
        0 = the lane declared no shares (unbounded under strict
        priority)."""
        if self._shares_total <= 0 or level.shares <= 0 or limit <= 0:
            return 0
        return max(1, -(-limit * level.shares // self._shares_total))

    def effective_cap(self) -> int:
        """The per-tenant inflight cap in force NOW (0 = unbounded)."""
        if self._cap_fn is not None:
            return self._cap_fn()
        return self.config.tenant_inflight_cap

    # --- enqueue / shed ordering ---------------------------------------
    def enqueue(self, t: Ticket, queue_depth: int, queue_cost: float
                ) -> tuple:
        """Admit ``t`` to its lane or decide a shed.  Returns
        ``(admitted, victim, reason)``: ``admitted`` False means the
        NEWCOMER sheds with ``reason``; a non-None ``victim`` is a
        previously queued ticket displaced to make room (its waiter
        sheds with reason ``displaced``)."""
        c = self.config
        if c.tenant_queue_cost > 0 and \
                self.tenant_cost.get(t.tenant, 0.0) + t.cost \
                > c.tenant_queue_cost:
            return False, None, "tenant_queue_cost"
        # bound semantics mirror the single FIFO exactly: 0 is a
        # zero-capacity queue (every queued arrival overflows), not
        # "unlimited"
        depth_full = self.depth + 1 > queue_depth
        cost_full = self.cost_total + t.cost > queue_cost
        victim = None
        if depth_full or cost_full:
            victim = self._displacement_victim(t)
            if victim is None:
                return False, None, \
                    "queue_cost" if cost_full and not depth_full \
                    else "queue_full"
            self.remove(victim)
            victim.shed = "displaced"
        self._push(t)
        return True, victim, ""

    def _load(self, tenant: str) -> float:
        """Displacement weight of a tenant: measured admitted cost (the
        decayed ledger, optionally cost-attribution-fed) PLUS its
        currently queued demand — a burst's queued wall makes its
        tenant "heaviest" immediately, before the ledger has learned
        anything about it."""
        return self._heaviness(tenant) + self.tenant_cost.get(tenant, 0.0)

    def _displacement_victim(self, newcomer: Ticket) -> Optional[Ticket]:
        """Tenant-aware shed ordering: from the LOWEST-priority nonempty
        lane, the newest queued ticket of the heaviest tenant — and only
        if the newcomer outranks it (higher lane, or same lane and a
        strictly lighter tenant).  System lanes therefore shed last, and
        the mid-burst arrival order stops deciding who pays."""
        for lane in reversed(self.lanes):
            if lane.depth() == 0:
                continue
            victim_lv = lane.level
            if newcomer.level.order > victim_lv.order:
                return None  # newcomer ranks below every queued ticket
            # heaviest tenant in this lane; ties break lexicographically
            # (deterministic replay)
            tenant = max(
                (tn for tn in lane.queues if lane.queues[tn]),
                key=lambda tn: (self._load(tn), tn))
            if newcomer.level.order == victim_lv.order:
                same = tenant == newcomer.tenant
                if same or self._load(newcomer.tenant) >= \
                        self._load(tenant):
                    return None  # not lighter: the newcomer pays
            return lane.queues[tenant][-1]
        return None

    def _push(self, t: Ticket) -> None:
        lane = self._by_level[t.level.name]
        q = lane.queues.get(t.tenant)
        if q is None:
            q = lane.queues[t.tenant] = deque()
        if t.tenant not in lane.ring:
            lane.ring.append(t.tenant)
            lane.deficit.setdefault(t.tenant, 0.0)
        q.append(t)
        self.depth += 1
        self.cost_total += t.cost
        self.tenant_cost[t.tenant] = \
            self.tenant_cost.get(t.tenant, 0.0) + t.cost

    def remove(self, t: Ticket) -> bool:
        """Drop a queued ticket (timeout, displacement)."""
        lane = self._by_level[t.level.name]
        q = lane.queues.get(t.tenant)
        if q is None or t not in q:
            return False
        q.remove(t)
        self._account_out(t, lane)
        return True

    def _account_out(self, t: Ticket, lane: _Lane) -> None:
        self.depth -= 1
        self.cost_total -= t.cost
        nc = self.tenant_cost.get(t.tenant, 0.0) - t.cost
        if nc <= 1e-9:
            self.tenant_cost.pop(t.tenant, None)
        else:
            self.tenant_cost[t.tenant] = nc
        if not lane.queues.get(t.tenant):
            lane.queues.pop(t.tenant, None)
            lane.deficit.pop(t.tenant, None)
            if t.tenant in lane.ring:
                # keep rr pointing at the ring element after the removed
                # tenant so rotation order survives membership churn
                idx = lane.ring.index(t.tenant)
                pos = lane.rr % len(lane.ring)
                lane.ring.pop(idx)
                if idx < pos:
                    pos -= 1
                lane.rr = pos % len(lane.ring) if lane.ring else 0

    # --- weighted-fair dequeue -----------------------------------------
    def pick_next(self, inflight_of: Callable[[str], int],
                  lane_inflight_of: Optional[Callable[[str], int]] = None,
                  limit: int = 0) -> Optional[Ticket]:
        """The next ticket to grant a freed limiter slot: strict
        priority across lanes; deficit round robin across tenants within
        a lane (credit ``quantum x weight`` per unaffordable visit,
        serve when the deficit covers the head's cost); tenants at the
        per-tenant inflight cap are skipped without losing their turn.
        Returns None when nothing is serviceable (empty, or every queued
        tenant is at its cap).

        With ``assuredConcurrencyShares`` configured (and the caller
        supplying per-lane inflight + the live limit), a lane already at
        its assured concurrency yields the slot to a lower-priority lane
        with queued demand — then a work-conserving second pass hands it
        back if nothing below could actually take it."""
        if self._shares_total > 0 and lane_inflight_of is not None \
                and limit > 0:
            for li, lane in enumerate(self.lanes):
                if lane.depth() == 0:
                    continue
                cap = self.assured_cap(lane.level, limit)
                if cap and lane_inflight_of(lane.level.name) >= cap and \
                        any(l2.depth() for l2 in self.lanes[li + 1:]):
                    continue  # bounded: lower-priority demand goes first
                t = self._pick_lane(lane, inflight_of)
                if t is not None:
                    return t
        for lane in self.lanes:
            t = self._pick_lane(lane, inflight_of)
            if t is not None:
                return t
        return None

    def _serviceable(self, lane: _Lane, tenant: str,
                     inflight_of: Callable[[str], int]) -> bool:
        if not lane.queues.get(tenant):
            return False
        cap = self.effective_cap()
        return not (cap > 0 and inflight_of(tenant) >= cap)

    def _pick_lane(self, lane: _Lane,
                   inflight_of: Callable[[str], int]) -> Optional[Ticket]:
        ring = lane.ring
        ok = [tn for tn in ring
              if self._serviceable(lane, tn, inflight_of)]
        if not ok:
            return None
        # bounded search: every full ring rotation credits each
        # serviceable tenant once, so the costliest head is affordable
        # within ceil(max_cost / (quantum x min_weight)) rotations
        max_cost = max(lane.queues[tn][0].cost for tn in ok)
        min_w = min(self.config.weight(tn) for tn in ok)
        rotations = int(max_cost / (self.config.quantum * min_w)) + 2
        for _ in range(rotations * len(ring)):
            tn = ring[lane.rr % len(ring)]
            if not self._serviceable(lane, tn, inflight_of):
                lane.rr += 1
                continue
            head = lane.queues[tn][0]
            if lane.deficit.get(tn, 0.0) >= head.cost:
                lane.deficit[tn] = lane.deficit.get(tn, 0.0) - head.cost
                lane.queues[tn].popleft()
                # rr stays on this tenant: remaining deficit serves its
                # next head first (classic DRR spends the round's credit)
                self._account_out(head, lane)
                return head
            lane.deficit[tn] = lane.deficit.get(tn, 0.0) + \
                self.config.quantum * self.config.weight(tn)
            lane.rr += 1
        return None  # unreachable: the rotation bound always affords

    # --- introspection ---------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/debug/overload`` lane view."""
        lanes = []
        for lane in self.lanes:
            tenants = {
                tn: {"queued": len(q),
                     "queued_cost": round(sum(t.cost for t in q), 1),
                     "deficit": round(lane.deficit.get(tn, 0.0), 1),
                     "weight": self.config.weight(tn)}
                for tn, q in sorted(lane.queues.items()) if q}
            lanes.append({
                "priority": lane.level.name,
                "order": lane.level.order,
                "shares": lane.level.shares,
                "queued": lane.depth(),
                "tenants": tenants,
            })
        return {
            "tenant_key": self.config.tenant_key,
            "queued": self.depth,
            "queued_cost": round(self.cost_total, 1),
            # the cap in force NOW (AIMD-derived when the limiter has
            # collapsed below max_inflight; 0 = unbounded)
            "tenant_inflight_cap": self.effective_cap(),
            "lanes": lanes,
        }


def qos_from_args(qos: str, qos_config: str) -> Optional[QoSConfig]:
    """CLI plumbing: ``--qos off`` (the compat default) returns None —
    the controller keeps the single-FIFO path bit-identical;
    ``--qos on`` loads ``--qos-config`` or the built-in lane set."""
    if qos != "on":
        return None
    if qos_config:
        return load_qos_config(qos_config)
    return QoSConfig()
