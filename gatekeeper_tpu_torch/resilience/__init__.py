"""Resilience layer: fault-injection seam + deadline/retry/breaker policies
+ overload protection.

``faults`` is the deterministic chaos seam (contextvar-scoped injection
points threaded through the webhook, external-data, apiserver, pipeline
and device-dispatch paths); ``policy`` is the unified failure-handling
layer (deadline budgets, jittered exponential retry, per-dependency
circuit breakers, graceful-degradation hooks); ``overload`` is the
self-protection tier (AIMD adaptive concurrency, cost-aware load
shedding, brownout ladder, graceful-drain state machine).  Every
injection, retry, breaker transition, deadline miss, shed and brownout
flows into the metrics registry (``gatekeeper_resilience_*`` /
``gatekeeper_overload_*``) and the structured log stream.
"""

from gatekeeper_tpu_torch.resilience.faults import (  # noqa: F401
    FaultError,
    FaultPlan,
    FaultSpec,
    fault_point,
    inject,
    install,
    load_chaos_spec,
    set_metrics_registry,
    uninstall,
)
from gatekeeper_tpu_torch.resilience.overload import (  # noqa: F401
    AdaptiveLimiter,
    DrainCoordinator,
    OverloadConfig,
    OverloadController,
    Shed,
)
from gatekeeper_tpu_torch.resilience.policy import (  # noqa: F401
    BreakerOpen,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    current_deadline,
    deadline_scope,
)
