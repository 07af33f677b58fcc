"""Observability layer: spans, cost attribution, SLOs, flight recorder.

``tracing`` is the dependency-free span tracer (trace/span IDs, parent
links, events, contextvar propagation, W3C traceparent interop, tail-
sampled ring buffer); ``export`` renders kept traces as Chrome
trace-event JSON (Perfetto-loadable) and self-time summaries.  The
tracer is the one timeline that connects the webhook HTTP path, the
batcher lane, device dispatch, and every audit-sweep pipeline stage —
with the resilience layer's retries, breaker transitions, deadline
misses and injected faults attached as span events.

On top of the timeline, three production answers (README
"Observability"):

- ``costattr`` — per-template cost attribution: shared device passes
  apportion their wall time across the constraint grid by row
  occupancy ("which policy is expensive" at ``/debug/cost``);
- ``slo`` — declarative objectives with multi-window burn rates
  ("are we inside our objective" at ``/debug/slo``, breach span
  events, a pressure input for the overload brownout ladder);
- ``flightrec`` — the admission flight recorder: a bounded ring of
  every admission/mutation/shed decision ("why was THIS request shed"
  at ``/debug/decisions?uid=``), with an optional JSONL sink.

Metrics cross-link the three: histogram buckets carry trace-id
exemplars, decisions carry trace ids, and attribution shares carry the
enforcement point — so a slow P99 bucket walks to its span, its cost
cell, and its decision record.
"""

from gatekeeper_tpu_torch.observability import (  # noqa: F401
    costattr,
    flightrec,
    slo,
)
from gatekeeper_tpu_torch.observability.costattr import (  # noqa: F401
    CostAttribution,
)
from gatekeeper_tpu_torch.observability.flightrec import (  # noqa: F401
    FlightRecorder,
)
from gatekeeper_tpu_torch.observability.slo import (  # noqa: F401
    SLOEngine,
    SLOObjective,
)
from gatekeeper_tpu_torch.observability.export import (  # noqa: F401
    chrome_trace,
    format_span_summary,
    host_spans,
    top_spans_by_self_time,
    write_chrome_trace,
)
from gatekeeper_tpu_torch.observability.tracing import (  # noqa: F401
    NOOP_SPAN,
    CollectorHook,
    Span,
    SpanContext,
    Tracer,
    activate,
    active_tracer,
    add_event,
    current_span,
    enabled,
    format_traceparent,
    install,
    open_phases,
    parse_traceparent,
    phase,
    set_attribute,
    span,
    uninstall,
    use_span,
)
