"""Deterministic, seeded fault-injection seam (the chaos harness; copy of
``gatekeeper_tpu/resilience/faults.py``).

Production serving stacks prove their failure paths by *injecting* the
failures, not by waiting for them (the chaos-seam discipline of
fault-tolerant serving systems; cf. PAPERS.md entries on gray-failure
detection).  This module is the single seam: code on a dangerous boundary
calls :func:`fault_point` with a dotted site name —

    fault_point("externaldata.send", provider=name)

— and, with no active plan (the default), that call is one contextvar
read plus one global read: nanoseconds, no locks, no behavior change.
With a plan active, matching specs fire deterministically (seeded RNG,
count-based gates — the same spec file replays the same fault sequence).

Sites threaded through the stack:

- ``webhook.review``        the admission review path (policy.py)
- ``externaldata.send``     provider transport (externaldata/providers.py)
- ``kube.request``          every apiserver HTTP call (sync/kube.py)
- ``pipeline.stage.<name>`` each staged-pipeline worker (pipeline/executor.py)
- ``device.dispatch``       device batch dispatch (drivers/torch_driver.py,
                            parallel/sweep.py)

Modes: ``sleep`` (added latency), ``hang`` (a long stall — deadline
budgets must cut it), ``error`` (raise; sites may map the spec onto their
own exception type via ``error_factory``, e.g. an apiserver 500), and
``partial`` (returned to the caller — only sites that understand partial
responses act on it; everyone else is unaffected).

Activation: :func:`inject` (contextvar-scoped, for tests and per-request
scoping), :func:`install` (process-global, the ``--chaos spec.json`` CLI
flag — worker threads spawned before the contextvar was set still see
it).  Every fired injection counts into
``gatekeeper_resilience_faults_injected_count{site,mode}`` and emits a
structured log line.
"""

from __future__ import annotations

import contextvars
import fnmatch
import json
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class FaultError(Exception):
    """The default injected exception (error-mode faults with no
    site-supplied ``error_factory``)."""


@dataclass
class FaultSpec:
    """One injection rule.  ``site`` is an fnmatch pattern
    (``pipeline.stage.*`` matches every stage worker)."""

    site: str
    mode: str = "error"  # sleep | hang | error | partial
    delay_s: float = 0.05  # sleep duration; hang defaults to 30s if unset
    error: str = "injected fault"
    status: int = 500  # error-mode hint for HTTP-shaped sites (kube)
    times: int = -1  # fire at most N times (-1 = unlimited)
    after: int = 0  # skip the first N matching calls
    every: int = 1  # then fire on every Nth matching call
    probability: float = 1.0  # gated by the plan's seeded RNG when < 1
    # partial-mode payload hint (e.g. fraction of keys a provider returns)
    fraction: float = 0.5

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        known = {f for f in FaultSpec.__dataclass_fields__}
        bad = set(d) - known
        if bad:
            raise ValueError(f"chaos spec: unknown fault fields {sorted(bad)}")
        if "site" not in d:
            raise ValueError("chaos spec: fault entry needs a 'site'")
        spec = FaultSpec(**d)
        if spec.mode not in ("sleep", "hang", "error", "partial"):
            raise ValueError(f"chaos spec: unknown mode {spec.mode!r}")
        return spec


@dataclass
class FaultAction:
    """What a fired spec asks the site to do.  Returned from
    :func:`fault_point` ONLY for partial mode (sleep/hang/error are
    executed inside the seam); callers that ignore the return value are
    transparently unaffected by partial specs."""

    mode: str
    spec: FaultSpec
    site: str


class FaultPlan:
    """A set of specs + deterministic firing state.

    The same (specs, seed) pair replays the same fault sequence for the
    same sequence of ``fault_point`` calls — chaos runs are reproducible
    and differential-testable."""

    def __init__(self, specs, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs = [s if isinstance(s, FaultSpec) else
                      FaultSpec.from_dict(s) for s in (specs or [])]
        self.seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._calls: dict = {}  # spec idx -> matching-call count
        self._fired: dict = {}  # spec idx -> fired count
        self.events: list = []  # [(site, mode, n_fired)] in fire order

    # --- introspection ---------------------------------------------------
    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self.events)
            return sum(1 for s, _m, _n in self.events if s == site)

    # --- the hot path ----------------------------------------------------
    def check(self, site: str) -> Optional[FaultAction]:
        """Return the action to take at ``site`` (None = no fault).  Count
        and RNG state advance under the lock so concurrent sites fire
        deterministically *per spec* (firing order across threads is the
        arrival order of the calls)."""
        action = None
        for i, spec in enumerate(self.specs):
            if not fnmatch.fnmatch(site, spec.site):
                continue
            with self._lock:
                n = self._calls.get(i, 0)
                self._calls[i] = n + 1
                if n < spec.after:
                    continue
                if spec.every > 1 and (n - spec.after) % spec.every != 0:
                    continue
                fired = self._fired.get(i, 0)
                if spec.times >= 0 and fired >= spec.times:
                    continue
                if spec.probability < 1.0 and \
                        self._rng.random() >= spec.probability:
                    continue
                self._fired[i] = fired + 1
                self.events.append((site, spec.mode, fired + 1))
            action = FaultAction(spec.mode, spec, site)
            break  # first matching spec wins
        return action

    def sleep_for(self, action: FaultAction) -> None:
        d = action.spec.delay_s
        if action.mode == "hang" and d <= 0.05:
            d = 30.0  # a hang with no explicit delay is a long stall
        self._sleep(d)


# --- activation ----------------------------------------------------------

_ctx_plan: contextvars.ContextVar = contextvars.ContextVar(
    "gatekeeper_fault_plan", default=None)
_global_plan: list = [None]  # process-scoped (CLI --chaos; worker threads)
_metrics: list = [None]  # MetricsRegistry sink for fired injections


def set_metrics_registry(registry) -> None:
    """Route fired-injection counters into a MetricsRegistry
    (``gatekeeper_resilience_faults_injected_count{site,mode}``)."""
    _metrics[0] = registry


def install(plan: Optional[FaultPlan]) -> None:
    """Process-global activation (the ``--chaos spec.json`` flag): every
    thread sees the plan, including workers spawned before the call."""
    _global_plan[0] = plan


def uninstall() -> None:
    _global_plan[0] = None


@contextmanager
def inject(plan: FaultPlan, process: bool = True):
    """Scoped activation for tests: sets the contextvar (same-thread
    sites) and — by default — the process-global too, so sites running on
    worker threads (batcher, pipeline stages, watch loops) observe the
    plan.  Restores both on exit."""
    token = _ctx_plan.set(plan)
    prev = _global_plan[0]
    if process:
        _global_plan[0] = plan
    try:
        yield plan
    finally:
        _ctx_plan.reset(token)
        if process:
            _global_plan[0] = prev


def active_plan() -> Optional[FaultPlan]:
    plan = _ctx_plan.get()
    if plan is None:
        plan = _global_plan[0]
    return plan


def load_chaos_spec(path_or_dict) -> FaultPlan:
    """Parse a ``--chaos`` spec: ``{"seed": 0, "faults": [{...}, ...]}``
    (see README "Failure semantics" for the format)."""
    doc = path_or_dict
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("chaos spec must be a JSON object")
    return FaultPlan(doc.get("faults", []), seed=int(doc.get("seed", 0)))


# --- the injection point -------------------------------------------------

def fault_point(site: str,
                error_factory: Optional[Callable[[FaultSpec], BaseException]]
                = None,
                **ctx: Any) -> Optional[FaultAction]:
    """Injection seam.  No active plan: near-zero cost, returns None.

    With a plan: sleep/hang stall here, error raises here (through
    ``error_factory`` when the site maps faults onto its own exception
    type), partial returns the action for the site to interpret.  ``ctx``
    rides into the structured log line only."""
    plan = _ctx_plan.get()
    if plan is None:
        plan = _global_plan[0]
        if plan is None:
            return None
    action = plan.check(site)
    if action is None:
        return None
    _record(site, action.mode, ctx)
    if action.mode in ("sleep", "hang"):
        plan.sleep_for(action)
        return None
    if action.mode == "error":
        exc = (error_factory(action.spec) if error_factory is not None
               else FaultError(f"{site}: {action.spec.error}"))
        raise exc
    return action  # partial


def _record(site: str, mode: str, ctx: dict) -> None:
    reg = _metrics[0]
    if reg is not None:
        from gatekeeper_tpu_torch.metrics import registry as M

        reg.inc_counter(M.RESILIENCE_FAULTS,
                        {"site": site, "mode": mode})
    try:
        from gatekeeper_tpu_torch.observability import tracing

        # a --chaos run with --trace shows exactly where each fault
        # landed: the injection becomes an event on the ambient span
        tracing.add_event("fault_injected", site=site, mode=mode)
    except Exception:
        pass
    try:
        from gatekeeper_tpu_torch.utils.logging import log_event

        log_event("info", "fault injected", event_type="fault_injected",
                  fault_site=site, fault_mode=mode,
                  **{f"fault_{k}": str(v) for k, v in ctx.items()})
    except Exception:
        pass  # the chaos seam must never add a failure mode of its own
