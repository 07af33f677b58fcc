"""In-process SLO engine: declarative objectives, multi-window burn rates.

"Are we inside our latency/staleness objective" becomes a scrape (the
``gatekeeper_slo_*`` gauges) and an endpoint (``/debug/slo``) instead of
a dashboard-side query.  Objectives are declarative dicts (JSON-able —
the ``--slo-config`` file format), three types:

- ``latency`` — a histogram metric + a threshold: the SLI is the
  fraction of observations answered within ``threshold`` seconds
  (computed from the lifetime buckets, so it pairs exactly with the
  exemplar-carrying series on ``/metrics``); ``target`` is the
  objective (e.g. 0.99 = "99% under threshold").
- ``ratio`` — a bad-event counter over a total counter (e.g. shed rate):
  the SLI is the good fraction, ``target`` the floor.
- ``staleness`` — a unix-timestamp gauge (e.g. the audit sweep's last
  end time): the SLI is its age in seconds, ``threshold`` the ceiling.

Burn rate follows the SRE-workbook shape: over a lookback window, the
bad fraction divided by the error budget ``(1 - target)``; 1.0 burns the
budget exactly at the objective's natural rate, 14.4 burns a 30-day
budget in 2 days.  Each *tier* pairs a short and a long window with a
burn threshold — a breach needs BOTH windows hot (the long window
filters blips, the short one ends the alert quickly once recovered).

Each :meth:`SLOEngine.tick` samples the registry into a bounded ring,
evaluates every objective, exports ``gatekeeper_slo_{sli_value,
burn_rate,compliant,breach_count}``, emits an ``slo.breach`` span on the
enter transition, and refreshes the overload controller's pressure when
wired (``OverloadController.set_slo_input`` — the brownout ladder
consumes SLO burn as one more pressure signal).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

# the default objective set: names are part of the observability
# registry (tools/observability_registry.md, cross-checked by
# tools/lint_observability.py) — new objectives must land there too
DEFAULT_OBJECTIVES = [
    {
        "name": "admission-latency-p99",
        "type": "latency",
        "metric": "validation_request_duration_seconds",
        "threshold": 0.25,
        "target": 0.99,
        "description": "99% of admission reviews answer within 250ms",
        # the objective's degradation map (--slo-degradation): on a
        # burn breach the engine activates these IN ORDER — cheapest
        # reversible action first, shedding last — and releases them
        # all on the falling edge.  Inert without a DegradationRegistry
        "degradation": ["ns_cache_stale", "extdata_stale",
                        "shed_harder"],
    },
    {
        "name": "mutation-latency-p99",
        "type": "latency",
        "metric": "mutation_request_duration_seconds",
        "threshold": 0.25,
        "target": 0.99,
        "description": "99% of mutate reviews answer within 250ms",
        "degradation": ["ns_cache_stale", "shed_harder"],
    },
    {
        "name": "admission-shed-rate",
        "type": "ratio",
        "bad_metric": "validation_request_count",
        "bad_labels": {"admission_status": "shed"},
        "total_metric": "validation_request_count",
        "target": 0.99,
        "description": "at most 1% of admissions shed under overload",
        # shedding too much: make everything else cheaper before
        # touching the gate itself
        "degradation": ["ns_cache_stale", "extdata_stale"],
    },
    {
        "name": "audit-snapshot-staleness",
        "type": "staleness",
        "gauge": "audit_last_run_end_time",
        "threshold": 600.0,
        "description": "audit verdicts at most 10 minutes stale",
        # a stale audit stops being polite: reclaim the device lane,
        # then stop paying for full resyncs until caught up
        "degradation": ["audit_yield_release", "resync_defer"],
    },
]

# every objective field load_config / SLOObjective accepts — an unknown
# key fails at parse time (the boot-time --slo-config contract), not as
# a mid-run KeyError
_OBJECTIVE_FIELDS = frozenset({
    "name", "type", "metric", "threshold", "target", "description",
    "labels", "bad_metric", "bad_labels", "total_metric",
    "total_labels", "gauge", "degradation", "cluster",
})


class SLOConfigError(ValueError):
    """A ``--slo-config`` document failed validation; the message
    carries the file, line/field, and what was wrong — boot fails fast
    instead of KeyError-ing mid-run."""

# burn-rate alert tiers: (name, short window s, long window s, burn
# threshold) — the SRE-workbook page/ticket pair scaled to a 30d budget
DEFAULT_TIERS = (
    {"name": "page", "short_s": 300.0, "long_s": 3600.0, "burn": 14.4},
    {"name": "ticket", "short_s": 1800.0, "long_s": 21600.0, "burn": 6.0},
)


class SLOObjective:
    """One parsed objective (see module docstring for the dict format)."""

    def __init__(self, spec: dict):
        if not isinstance(spec, dict):
            raise ValueError(f"objective must be a JSON object, got "
                             f"{type(spec).__name__}")
        self.spec = dict(spec)
        if not spec.get("name"):
            raise ValueError("objective is missing the 'name' field")
        self.name = spec["name"]
        unknown = sorted(set(spec) - _OBJECTIVE_FIELDS)
        if unknown:
            raise ValueError(
                f"objective {self.name!r}: unknown field "
                f"{unknown[0]!r} (accepted: {sorted(_OBJECTIVE_FIELDS)})")
        self.type = spec.get("type", "latency")
        if self.type not in ("latency", "ratio", "staleness"):
            raise ValueError(f"objective {self.name!r}: unknown type "
                             f"{self.type!r}")
        self.description = spec.get("description", "")
        try:
            self.target = float(spec.get("target", 0.99))
            self.threshold = float(spec.get("threshold", 0.0))
        except (TypeError, ValueError):
            raise ValueError(f"objective {self.name!r}: 'target'/"
                             f"'threshold' must be numbers") from None
        self.metric = spec.get("metric", "")
        self.labels = spec.get("labels")
        self.bad_metric = spec.get("bad_metric", "")
        self.bad_labels = spec.get("bad_labels")
        self.total_metric = spec.get("total_metric", "")
        self.total_labels = spec.get("total_labels")
        self.gauge = spec.get("gauge", "")
        # ordered degradation map: the named actions this objective may
        # activate on breach (validated against the DegradationRegistry
        # when one is wired; inert otherwise)
        deg = spec.get("degradation", [])
        if not isinstance(deg, (list, tuple)) or \
                any(not isinstance(a, str) or not a for a in deg):
            raise ValueError(f"objective {self.name!r}: 'degradation' "
                             f"must be a list of action names")
        self.degradation = list(deg)
        # fleet scope: a non-empty cluster pins every metric lookup to
        # that cluster's labeled series, and scopes the objective's
        # degradation activations so cluster A never degrades cluster B
        cluster = spec.get("cluster", "")
        if not isinstance(cluster, str):
            raise ValueError(f"objective {self.name!r}: 'cluster' must "
                             f"be a string")
        self.cluster = cluster
        self.budget = max(1e-9, 1.0 - self.target)

    def _scoped(self, base):
        """Metric labels in force: the spec's, plus the cluster axis
        when this objective is fleet-scoped."""
        if not self.cluster:
            return base
        out = dict(base or {})
        out["cluster"] = self.cluster
        return out

    # --- cumulative (bad, total) sampling --------------------------------
    def sample(self, metrics, wall: float):
        """Cumulative (bad, total) counters at this instant — the ring
        entries burn rates difference over.  Staleness objectives return
        their instantaneous age instead (no accumulation)."""
        if self.type == "latency":
            h = metrics.get_histogram(self.metric,
                                      self._scoped(self.labels))
            if h is None:
                return (0.0, 0.0)
            within = 0
            cum = 0
            for i, n in enumerate(h["buckets"]):
                cum += n
                if i < len(h["bounds"]) and \
                        h["bounds"][i] <= self.threshold + 1e-12:
                    within = cum
            return (float(h["count"] - within), float(h["count"]))
        if self.type == "ratio":
            # labels=None sums ACROSS labelsets (shadow divergence is
            # labeled {kind} but the objective wants the sum); an exact
            # labelset filters to one series.  Cluster-scoped
            # objectives sum across the labelsets carrying their
            # cluster (plus any configured label pairs) — one
            # cluster's series out of the fleet's shared registry
            if self.cluster:
                bad = metrics.counter_total(
                    self.bad_metric, match=self._scoped(self.bad_labels))
                total = metrics.counter_total(
                    self.total_metric,
                    match=self._scoped(self.total_labels))
                return (float(bad), float(total))
            if self.bad_labels is None:
                bad = metrics.counter_total(self.bad_metric)
            else:
                bad = metrics.get_counter(self.bad_metric,
                                          self.bad_labels)
            if self.total_labels is None:
                total = metrics.counter_total(self.total_metric)
            else:
                total = metrics.get_counter(self.total_metric,
                                            self.total_labels)
            return (float(bad), float(total))
        # staleness: age of the gauge timestamp (gauge unset = age 0 —
        # nothing has run yet, nothing is stale yet)
        ts = metrics.get_gauge(self.gauge, self._scoped(self.labels))
        age = max(0.0, wall - float(ts)) if ts else 0.0
        return (age, -1.0)  # total=-1 marks "instantaneous value"


class SLOEngine:
    """Evaluates objectives against the metrics registry on ``tick()``.

    ``clock`` is the monotonic ring clock and ``wall`` the exemplar /
    staleness clock — injectable so tests replay exact trajectories."""

    def __init__(self, metrics, objectives: Optional[Sequence] = None,
                 tiers: Optional[Sequence] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 ring_capacity: int = 4096,
                 brownout=None,
                 degradations=None,
                 escalate_hold_s: float = 30.0):
        self.metrics = metrics
        self.objectives = [
            o if isinstance(o, SLOObjective) else SLOObjective(o)
            for o in (objectives if objectives is not None
                      else DEFAULT_OBJECTIVES)]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.tiers = [dict(t) for t in (tiers or DEFAULT_TIERS)]
        self._clock = clock
        self._wall = wall
        # ring of (t, {objective: (bad_cum, total_cum)}) samples
        self._ring: deque = deque(maxlen=ring_capacity)
        self._breached: dict = {}  # objective -> bool (edge detection)
        self._last_eval: dict = {}
        self._lock = threading.Lock()
        # optional OverloadController: tick() refreshes its pressure so
        # SLO burn feeds the brownout ladder (set_slo_input must point
        # back at self.pressure for the signal to be consumed)
        self.brownout = brownout
        # optional DegradationRegistry (resilience/overload.py): tick()
        # then drives each breaching objective's degradation MAP —
        # activate the next mapped action after escalate_hold_s of
        # sustained breach, release them all on the falling edge.  None
        # keeps the scalar --slo-brownout path the only feedback loop
        # (bit-identical to the pre-map engine)
        self.degradations = degradations
        self.escalate_hold_s = float(escalate_hold_s)
        if degradations is not None:
            for o in self.objectives:
                degradations.validate(
                    o.degradation, where=f"objective {o.name!r}")
        self._deg_level: dict = {}  # objective -> active action count
        self._deg_at: dict = {}  # objective -> clock of last transition
        # every activation/release edge in decision order — identical
        # (config, clock, metric sequence) replays it exactly (pinned)
        self.degradation_trajectory: deque = deque(maxlen=4096)
        # (objective_filter, fn) called on each breach RISING EDGE —
        # "" matches every objective; see on_breach()
        self._breach_hooks: list = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def window_clock(self) -> Callable[[], float]:
        """The monotonic clock the burn windows run on — consumers that
        want to age state on the SLO timebase (e.g. the QoS displacement
        ledger under ``--qos-ledger-decay slo-window``) read it here so
        an injected test clock drives them too."""
        return self._clock

    def shortest_window_s(self) -> float:
        """The tightest burn-tier short window — the natural half-life
        for window-driven decay consumers."""
        return min((float(t["short_s"]) for t in self.tiers),
                   default=300.0)

    # --- loop ------------------------------------------------------------
    def start(self, interval_s: float = 10.0) -> "SLOEngine":
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the SLO engine must never take the server down
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # --- breach hooks -----------------------------------------------------
    def on_breach(self, fn, objective: str = "") -> None:
        """Register ``fn(objective_name, eval_dict)`` to fire on a
        breach RISING EDGE only (not on every breached tick — re-arming
        requires the objective to recover first).  ``objective`` filters
        to one objective name; ``""`` fires for all.  Hook exceptions
        are swallowed: the engine must never take the server down."""
        self._breach_hooks.append((objective, fn))

    # --- evaluation -------------------------------------------------------
    def tick(self) -> dict:
        """Sample + evaluate + export; returns the ``/debug/slo``
        payload for this instant."""
        from gatekeeper_tpu_torch.metrics import registry as M
        from gatekeeper_tpu_torch.observability import tracing

        now = self._clock()
        wall = self._wall()
        sample = {o.name: o.sample(self.metrics, wall)
                  for o in self.objectives}
        with self._lock:
            self._ring.append((now, sample))
            evals = [self._evaluate_locked(o, now, sample[o.name])
                     for o in self.objectives]
        for o, ev in zip(self.objectives, evals):
            o_name = ev["name"]
            self.metrics.set_gauge(M.SLO_SLI, ev["sli"],
                                   {"objective": o_name})
            self.metrics.set_gauge(M.SLO_COMPLIANT,
                                   1.0 if ev["compliant"] else 0.0,
                                   {"objective": o_name})
            for wname, rate in ev["burn"].items():
                self.metrics.set_gauge(M.SLO_BURN_RATE, rate,
                                       {"objective": o_name,
                                        "window": wname})
            was = self._breached.get(o_name, False)
            if ev["breach"] and not was:
                self.metrics.inc_counter(M.SLO_BREACHES,
                                         {"objective": o_name})
                # breach transitions land in the trace timeline too: a
                # root span (visible without any ambient request) plus an
                # event on whatever span is ambient
                with tracing.span("slo.breach", objective=o_name,
                                  sli=ev["sli"], tier=ev["breach_tier"]):
                    pass
                tracing.add_event("slo_breach", objective=o_name,
                                  sli=ev["sli"])
                try:
                    from gatekeeper_tpu_torch.utils.logging import log_event

                    log_event("warning", "SLO burn-rate breach",
                              event_type="slo_breach", objective=o_name,
                              sli=ev["sli"], tier=ev["breach_tier"])
                except Exception:
                    pass
                for want, fn in list(self._breach_hooks):
                    if want and want != o_name:
                        continue
                    try:
                        fn(o_name, ev)
                    except Exception:
                        pass
            self._breached[o_name] = ev["breach"]
            self._degrade_step(o, ev, now)
        payload = {
            "generated_at": wall,
            "pressure": self._pressure_from(evals),
            "tiers": self.tiers,
            "objectives": evals,
        }
        with self._lock:
            self._last_eval = payload
        if self.brownout is not None:
            try:
                self.brownout.refresh_pressure()
            except Exception:
                pass
        return payload

    def _window_burn(self, objective: SLOObjective, now: float,
                     window_s: float, cur) -> float:
        """Burn rate over the trailing window: Δbad/Δtotal scaled by the
        error budget.  Staleness objectives burn as age/threshold."""
        bad, total = cur
        if total < 0:  # instantaneous (staleness)
            return (bad / objective.threshold) if objective.threshold \
                else 0.0
        base = None
        older = None  # newest sample just OUTSIDE the window
        for t, sample in self._ring:
            if now - t <= window_s:
                base = sample.get(objective.name)
                break
            older = sample.get(objective.name)
        if base is None:
            # tick gap wider than the window: difference against the
            # newest pre-window sample instead of the whole lifetime
            base = older if older is not None else (0.0, 0.0)
        d_bad = max(0.0, bad - base[0])
        d_total = max(0.0, total - base[1])
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / objective.budget

    def _evaluate_locked(self, o: SLOObjective, now: float, cur) -> dict:
        bad, total = cur
        if total < 0:
            sli = bad  # staleness: the age itself
            compliant = sli <= o.threshold
        elif total > 0:
            sli = 1.0 - bad / total  # good fraction, lifetime
            compliant = sli >= o.target
        else:
            sli = 1.0
            compliant = True
        burns: dict = {}
        breach = False
        breach_tier = ""
        for tier in self.tiers:
            bs = self._window_burn(o, now, tier["short_s"], cur)
            bl = self._window_burn(o, now, tier["long_s"], cur)
            burns[f"{int(tier['short_s'])}s"] = round(bs, 4)
            burns[f"{int(tier['long_s'])}s"] = round(bl, 4)
            if bs >= tier["burn"] and bl >= tier["burn"] and not breach:
                breach = True
                breach_tier = tier["name"]
        if total < 0 and not compliant:
            # staleness has no budget to burn down: out of objective IS
            # the breach (age past the ceiling pages immediately)
            breach = True
            breach_tier = breach_tier or "page"
        return {
            "name": o.name,
            "type": o.type,
            "description": o.description,
            "cluster": o.cluster,
            "target": o.target,
            "threshold": o.threshold,
            "sli": round(sli, 6),
            "compliant": compliant,
            "burn": burns,
            "breach": breach,
            "breach_tier": breach_tier,
        }

    # --- degradation maps -------------------------------------------------
    def _degrade_step(self, o: SLOObjective, ev: dict,
                      now: float) -> None:
        """Drive one objective's degradation map off its breach state:
        rising edge activates the first mapped action; a breach held
        past ``escalate_hold_s`` since the last transition escalates to
        the next; the falling edge releases every held action in
        reverse order.  Pure function of (map, clock, breach sequence)
        — an injected clock replays the exact trajectory."""
        reg = self.degradations
        ev["degradation"] = list(o.degradation)
        if reg is None or not o.degradation:
            ev["degradation_active"] = []
            return
        level = self._deg_level.get(o.name, 0)
        if ev["breach"]:
            if level == 0:
                self._deg_transition(o, o.degradation[0], ev, now, True)
                level = 1
            elif level < len(o.degradation) and \
                    now - self._deg_at.get(o.name, now) >= \
                    self.escalate_hold_s:
                self._deg_transition(o, o.degradation[level], ev, now,
                                     True)
                level += 1
            else:
                ev["degradation_active"] = list(o.degradation[:level])
                return
            self._deg_level[o.name] = level
            self._deg_at[o.name] = now
        elif level > 0:
            # falling edge: revoke deepest-first — the map unwinds the
            # way it wound up
            for action in reversed(o.degradation[:level]):
                self._deg_transition(o, action, ev, now, False)
            level = 0
            self._deg_level[o.name] = 0
            self._deg_at[o.name] = now
        ev["degradation_active"] = list(o.degradation[:level])

    def _deg_transition(self, o: SLOObjective, action: str, ev: dict,
                        now: float, activate: bool) -> None:
        from gatekeeper_tpu_torch.observability import tracing

        if activate:
            self.degradations.activate(action, objective=o.name,
                                       cluster=o.cluster)
        else:
            self.degradations.release(action, objective=o.name,
                                      cluster=o.cluster)
        event = "activate" if activate else "release"
        self.degradation_trajectory.append({
            "t": round(now, 6), "objective": o.name, "action": action,
            "cluster": o.cluster, "event": event,
        })
        # the transition lands in the trace timeline (a root span,
        # visible without any ambient request) and the event stream
        with tracing.span("slo.degrade", objective=o.name,
                          action=action, cluster=o.cluster,
                          event=event, sli=ev["sli"]):
            pass
        tracing.add_event("slo_degrade", objective=o.name,
                          action=action, event=event)
        try:
            from gatekeeper_tpu_torch.utils.logging import log_event

            log_event("warning" if activate else "info",
                      f"SLO degradation {event}",
                      event_type="slo_degrade", objective=o.name,
                      action=action, cluster=o.cluster, sli=ev["sli"])
        except Exception:
            pass

    def _pressure_from(self, evals) -> float:
        """0..1 brownout input: the hottest objective's fastest-tier burn
        relative to that tier's threshold, capped at 1 — at 1.0 the
        ladder sees SLO burn as a full queue would look."""
        if not self.tiers:
            return 0.0
        tier = self.tiers[0]
        wname = f"{int(tier['short_s'])}s"
        p = 0.0
        for ev in evals:
            p = max(p, ev["burn"].get(wname, 0.0) / tier["burn"])
        return min(1.0, p)

    # --- consumers --------------------------------------------------------
    def pressure(self) -> float:
        """The brownout-ladder input (see ``_pressure_from``); reads the
        last tick's evaluation — wire via
        ``OverloadController.set_slo_input(engine.pressure)``."""
        with self._lock:
            return float(self._last_eval.get("pressure", 0.0))

    def snapshot(self, cluster: Optional[str] = None) -> dict:
        """The ``/debug/slo`` payload (last tick; {} before the first).
        ``cluster`` filters to one cluster's fleet-scoped objectives
        plus the global (unscoped) ones — the ``?cluster=`` view."""
        with self._lock:
            out = dict(self._last_eval)
        if cluster is not None and out:
            out = dict(out)
            out["cluster"] = cluster
            out["objectives"] = [
                ev for ev in out.get("objectives", [])
                if ev.get("cluster", "") in ("", cluster)]
        return out

    def degraded(self) -> dict:
        """objective -> [active actions], for every objective holding
        at least one (the triage cross-link source)."""
        out: dict = {}
        for o in self.objectives:
            lvl = self._deg_level.get(o.name, 0)
            if lvl:
                out[o.name] = list(o.degradation[:lvl])
        return out


def per_cluster_objectives(cluster_ids: Sequence[str],
                           base: Optional[Sequence] = None) -> list:
    """Fleet-scoped objective set: every base objective cloned once per
    cluster as ``name@cluster`` with the ``cluster`` axis set, so SLIs
    read that cluster's labeled series and degradation actions scope to
    it.  ``base`` defaults to :data:`DEFAULT_OBJECTIVES`."""
    out: list = []
    for cid in cluster_ids:
        for spec in (base if base is not None else DEFAULT_OBJECTIVES):
            spec = dict(spec.spec if isinstance(spec, SLOObjective)
                        else spec)
            spec["name"] = f"{spec['name']}@{cid}"
            spec["cluster"] = cid
            out.append(SLOObjective(spec))
    return out


def load_config(path: str, degradations=None) -> dict:
    """{"objectives": [SLOObjective...], "tiers": [...] or None,
    "actions": [names registered]}.

    Fails fast with :class:`SLOConfigError` naming the line (malformed
    JSON) or the objective index + field (bad spec); degradation-map
    action names are validated against ``degradations`` (a
    DegradationRegistry) when given.

    A top-level ``"actions"`` list registers CUSTOM degradation actions
    into ``degradations`` BEFORE the objective maps validate, so an
    objective may name them: each entry is ``{"name": ...,
    "description": ...}`` (description optional, unknown fields
    rejected).  Config-registered actions have no built-in consumer —
    they surface through ``degradation_active`` polls and the registry's
    activate/release hooks, which is exactly what operator-side
    consumers (and the built-in ``device_residency_evict`` poll in
    snapshot/device_residency.py) key on."""
    import json

    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise SLOConfigError(
            f"{path}:{e.lineno}:{e.colno}: malformed JSON: "
            f"{e.msg}") from None
    specs = doc if isinstance(doc, list) else doc.get("objectives", [])
    tiers = None if isinstance(doc, list) else (doc.get("tiers") or None)
    actions = [] if isinstance(doc, list) else (doc.get("actions") or [])
    if not isinstance(specs, list):
        raise SLOConfigError(f"{path}: 'objectives' must be a list")
    if not isinstance(actions, list):
        raise SLOConfigError(f"{path}: 'actions' must be a list")
    registered: list = []
    for i, a in enumerate(actions):
        if not isinstance(a, dict):
            raise SLOConfigError(
                f"{path}: actions[{i}]: must be an object")
        name = a.get("name")
        if not name or not isinstance(name, str):
            raise SLOConfigError(
                f"{path}: actions[{i}]: missing or non-string 'name'")
        desc = a.get("description", "")
        if not isinstance(desc, str):
            raise SLOConfigError(
                f"{path}: actions[{i}]: 'description' must be a string")
        unknown = set(a) - {"name", "description"}
        if unknown:
            raise SLOConfigError(
                f"{path}: actions[{i}]: unknown field(s) "
                f"{sorted(unknown)}")
        if degradations is not None:
            degradations.register(name, desc)
        registered.append(name)
    objectives: list = []
    for i, spec in enumerate(specs):
        try:
            objectives.append(SLOObjective(spec))
        except ValueError as e:
            raise SLOConfigError(
                f"{path}: objectives[{i}]: {e}") from None
    if tiers is not None:
        if not isinstance(tiers, list):
            raise SLOConfigError(f"{path}: 'tiers' must be a list")
        for i, t in enumerate(tiers):
            if not isinstance(t, dict) or not t.get("name"):
                raise SLOConfigError(
                    f"{path}: tiers[{i}]: must be an object with a "
                    f"'name'")
            for field in ("short_s", "long_s", "burn"):
                try:
                    float(t[field])
                except (KeyError, TypeError, ValueError):
                    raise SLOConfigError(
                        f"{path}: tiers[{i}]: missing or non-numeric "
                        f"field {field!r}") from None
    if degradations is not None:
        for i, o in enumerate(objectives):
            try:
                degradations.validate(
                    o.degradation, where=f"objective {o.name!r}")
            except ValueError as e:
                raise SLOConfigError(
                    f"{path}: objectives[{i}]: {e}") from None
    return {"objectives": objectives, "tiers": tiers,
            "actions": registered}
