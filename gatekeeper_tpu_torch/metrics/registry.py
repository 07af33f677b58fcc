"""Metrics registry with Prometheus text exposition.

Reference: pkg/metrics (OTel registry + prometheus exporter) and the
per-subsystem reporters (webhook request count/duration, audit
last_run_time/violations, constraint counts, sync gauges — names per
website/docs/metrics.md).  Here: a dependency-free registry producing the
Prometheus exposition format, served by the webhook server or scraped via
``render()``.

Distributions are **fixed-bucket histograms** (the earlier reservoir
summary computed quantiles over a ``deque(maxlen=4096)`` window while
``_sum``/``_count`` were lifetime — a biased pairing once the series
outlived the window).  Buckets are lifetime-cumulative like the sums, so
``_bucket``/``_sum``/``_count`` always describe the same population;
the old ``name{quantile="..."}`` series stay as a compat shim estimated
from the buckets.  Each bucket carries **exemplars** (trace ids of
observations that landed in it) so a slow P99 bucket links straight to a
``/debug/traces`` span; exemplars render in the OpenMetrics format
(negotiated by Accept on ``/metrics``).  Exemplar retention is a
per-bucket **reservoir sample** (size ``EXEMPLAR_RESERVOIR``, seeded
RNG): each traced observation enters the reservoir with probability
``K/seen``, so a burst of boring observations cannot evict the whole
history the way last-write-wins did — the retained set stays a uniform
sample over the bucket's lifetime, and the RENDERED exemplar pins the
bucket's max-value observation (the most latency-interesting trace).

Label sets are **bounded per metric name** (``max_label_sets``): at
production churn an unbounded ``{template}``/``{tenant}`` label set is a
memory leak, so overflow series fold into an ``other`` label value and
``gatekeeper_metrics_dropped_labels_count`` counts the folds.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import defaultdict
from typing import Optional, Sequence

import threading

PREFIX = "gatekeeper_"

# default bucket bounds: *_seconds metrics get latency-shaped buckets
# (sub-ms to tens of seconds — admission reviews sit in the ms decades,
# audit sweeps in the seconds decades); everything else (batch sizes,
# convergence iterations) gets power-of-two count buckets
DURATION_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 1024.0)

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4"

# per-bucket exemplar reservoir size (uniform sample over the bucket's
# traced observations; see the module docstring)
EXEMPLAR_RESERVOIR = 4


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((labels or {}).items()))


# exemplar source: the ambient span's trace id (resolved lazily so the
# registry has no import-time dependency on the tracer; with no tracer
# installed current_span() is one contextvar read returning None)
_cur_span_fn = None


def _exemplar_trace_id() -> str:
    global _cur_span_fn
    if _cur_span_fn is None:
        try:
            from gatekeeper_tpu_torch.observability.tracing import current_span
        except Exception:  # pragma: no cover — package half-installed
            return ""
        _cur_span_fn = current_span
    s = _cur_span_fn()
    if s is None:
        return ""
    return getattr(s, "trace_id", "") or ""


class MetricsRegistry:
    def __init__(self, max_label_sets: int = 128):
        self._counters: dict = defaultdict(float)
        self._gauges: dict = {}
        self._hist: dict = {}
        # per-metric-name distinct-labelset registry (cardinality guard)
        self.max_label_sets = max(1, int(max_label_sets))
        self._series_labels: dict = {}
        self._bucket_overrides: dict = {}
        self._lock = threading.Lock()
        # seeded: reservoir eviction replays identically run-to-run
        import random

        self._ex_rng = random.Random(0)

    # --- cardinality guard ---------------------------------------------
    def _bounded_labels(self, name: str, labels: Optional[dict]) -> tuple:
        """Label key for storage, bounded per metric name: a labelset
        beyond ``max_label_sets`` folds every value into ``other`` and
        counts the fold (call under self._lock)."""
        lk = _labels_key(labels)
        if not lk:
            return lk
        seen = self._series_labels.setdefault(name, set())
        if lk in seen:
            return lk
        if len(seen) >= self.max_label_sets:
            self._counters[(DROPPED_LABELS, ())] += 1
            return tuple((k, "other") for k, _v in lk)
        seen.add(lk)
        return lk

    # --- instruments --------------------------------------------------
    def inc_counter(self, name: str, labels: Optional[dict] = None,
                    value: float = 1.0) -> None:
        with self._lock:
            self._counters[(name, self._bounded_labels(name, labels))] \
                += value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        with self._lock:
            self._gauges[(name, self._bounded_labels(name, labels))] = value

    def counter_total(self, name: str,
                      match: Optional[dict] = None) -> float:
        """Sum of a counter across all label sets (test/introspection).
        ``match`` keeps only labelsets carrying every given (k, v) pair
        — the fleet-scoped SLO lookups sum one cluster's series."""
        want = set((match or {}).items())
        with self._lock:
            return sum(v for (n, lk), v in self._counters.items()
                       if n == name and want.issubset(set(lk)))

    def set_buckets(self, name: str, bounds: Sequence[float]) -> None:
        """Override the bucket bounds a metric name will use.  Applies to
        series created AFTER the call (histogram state is per-series and
        bounds are fixed at first observation)."""
        with self._lock:
            self._bucket_overrides[name] = tuple(sorted(float(b)
                                                        for b in bounds))

    def buckets_for(self, name: str) -> tuple:
        ov = self._bucket_overrides.get(name)
        if ov is not None:
            return ov
        return DURATION_BUCKETS if name.endswith("_seconds") \
            else COUNT_BUCKETS

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None) -> None:
        tid = _exemplar_trace_id()
        with self._lock:
            key = (name, self._bounded_labels(name, labels))
            h = self._hist.get(key)
            if h is None:
                bounds = self.buckets_for(name)
                h = self._hist[key] = {
                    "count": 0, "sum": 0.0, "min": None, "max": None,
                    "bounds": bounds,
                    # per-bucket (NOT cumulative) counts; index len(bounds)
                    # is the +Inf bucket.  Cumulation happens at render.
                    "buckets": [0] * (len(bounds) + 1),
                    # rendered exemplar per bucket: (trace_id, value,
                    # unix_ts) — the reservoir's max-value entry
                    "exemplars": [None] * (len(bounds) + 1),
                    # reservoir state per bucket: retained entries +
                    # traced-observation count (the sampling denominator)
                    "ex_res": [[] for _ in range(len(bounds) + 1)],
                    "ex_seen": [0] * (len(bounds) + 1),
                }
            h["count"] += 1
            h["sum"] += value
            if h["min"] is None or value < h["min"]:
                h["min"] = value
            if h["max"] is None or value > h["max"]:
                h["max"] = value
            i = bisect.bisect_left(h["bounds"], value)
            h["buckets"][i] += 1
            if tid:
                # reservoir sampling: entry j of n survives with
                # probability K/n — a burst can no longer evict the
                # bucket's whole exemplar history (last-write-wins did)
                entry = (tid, float(value), time.time())
                h["ex_seen"][i] += 1
                res = h["ex_res"][i]
                if len(res) < EXEMPLAR_RESERVOIR:
                    res.append(entry)
                else:
                    j = self._ex_rng.randrange(h["ex_seen"][i])
                    if j < EXEMPLAR_RESERVOIR:
                        res[j] = entry
                # the RENDERED exemplar pins the bucket's max-value
                # observation (the most latency-interesting trace,
                # deterministic: first writer wins ties) — a burst of
                # faster observations can never displace it
                cur = h["exemplars"][i]
                if cur is None or entry[1] > cur[1]:
                    h["exemplars"][i] = entry

    def timed(self, name: str, labels: Optional[dict] = None):
        registry = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.observe(name, time.perf_counter() - self.t0, labels)

        return _Timer()

    # --- exposition ----------------------------------------------------
    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text format (the prometheus exporter equivalent).

        ``openmetrics=True`` renders the OpenMetrics flavor (negotiated
        by the Accept header on ``/metrics``): exemplars ride the
        ``_bucket`` lines and the page ends with ``# EOF``; the legacy
        flavor instead appends the compat ``name{quantile=...}`` series
        estimated from the buckets (the pre-histogram summary names)."""
        lines = []
        typed: set = set()  # one # TYPE line per metric name

        def type_line(name, kind):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {PREFIX}{name} {kind}")

        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                type_line(name, "counter")
                lines.append(f"{PREFIX}{name}{_fmt(labels)} {_num(v)}")
            for (name, labels), v in sorted(self._gauges.items()):
                type_line(name, "gauge")
                lines.append(f"{PREFIX}{name}{_fmt(labels)} {_num(v)}")
            for (name, labels), h in sorted(self._hist.items()):
                type_line(name, "histogram")
                cum = 0
                for i, n in enumerate(h["buckets"]):
                    cum += n
                    bounds = h["bounds"]
                    le = _num(bounds[i]) if i < len(bounds) else "+Inf"
                    line = (f"{PREFIX}{name}_bucket"
                            f"{_fmt(labels + (('le', le),))} {cum}")
                    ex = h["exemplars"][i]
                    if openmetrics and ex is not None:
                        tid, val, ts = ex
                        line += (f' # {{trace_id="{_escape_label(tid)}"}} '
                                 f"{_num(val)} {ts:.3f}")
                    lines.append(line)
                lines.append(
                    f"{PREFIX}{name}_sum{_fmt(labels)} {_num(h['sum'])}")
                lines.append(
                    f"{PREFIX}{name}_count{_fmt(labels)} {h['count']}")
                if not openmetrics and h["count"]:
                    # compat shim: the summary-era quantile series, now
                    # estimated from the lifetime buckets (the reservoir
                    # window's recency bias is gone — quantiles and
                    # sum/count describe the same population)
                    for q in (0.5, 0.9, 0.99):
                        ql = labels + (("quantile", str(q)),)
                        est = _bucket_quantile(h, q)
                        lines.append(
                            f"{PREFIX}{name}{_fmt(ql)} {_num(est)}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def get_counter(self, name: str, labels: Optional[dict] = None) -> float:
        return self._counters.get((name, _labels_key(labels)), 0.0)

    def get_gauge(self, name: str, labels: Optional[dict] = None):
        return self._gauges.get((name, _labels_key(labels)))

    def get_histogram(self, name: str,
                      labels: Optional[dict] = None) -> Optional[dict]:
        """Histogram state snapshot for one series (test/introspection):
        {count, sum, min, max, bounds, buckets (non-cumulative),
        exemplars (rendered, one per bucket), exemplar_reservoir (the
        per-bucket retained sample)}; None when the series does not
        exist."""
        with self._lock:
            h = self._hist.get((name, _labels_key(labels)))
            if h is None:
                return None
            out = dict(h)
            out["buckets"] = list(h["buckets"])
            out["exemplars"] = list(h["exemplars"])
            out["exemplar_reservoir"] = [list(r) for r in h["ex_res"]]
            out.pop("ex_res", None)
            out.pop("ex_seen", None)
            return out


def _bucket_quantile(h: dict, q: float) -> float:
    """Quantile estimate from bucket counts, linearly interpolated
    within the landing bucket (the histogram_quantile shape); the +Inf
    bucket clamps to the observed max."""
    count = h["count"]
    if not count:
        return 0.0
    target = q * count
    bounds = h["bounds"]
    cum = 0
    for i, n in enumerate(h["buckets"]):
        if not n:
            continue
        prev = cum
        cum += n
        if cum >= target:
            hi = bounds[i] if i < len(bounds) else (h["max"] or 0.0)
            lo = bounds[i - 1] if 0 < i <= len(bounds) else 0.0
            if not math.isfinite(hi):
                return h["max"] or lo
            frac = (target - prev) / n
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
    return h["max"] or 0.0


def _escape_label(v) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote and newline must be escaped or the scrape corrupts
    (one bad label value breaks every series after it on the page)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{%s}" % inner


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


# canonical metric names (reference: website/docs/metrics.md)
REQUEST_COUNT = "validation_request_count"
REQUEST_DURATION = "validation_request_duration_seconds"
MUTATION_REQUEST_COUNT = "mutation_request_count"
MUTATION_REQUEST_DURATION = "mutation_request_duration_seconds"
VIOLATIONS = "violations"
AUDIT_DURATION = "audit_duration_seconds"
AUDIT_LAST_RUN = "audit_last_run_time"
AUDIT_LAST_RUN_END = "audit_last_run_end_time"
AUDIT_LAST_RUN_INCOMPLETE = "audit_last_run_incomplete"
CONSTRAINT_TEMPLATES = "constraint_templates"
CONSTRAINTS = "constraints"
MUTATOR_INGESTION = "mutator_ingestion_count"
MUTATOR_CONFLICTS = "mutator_conflicting_count"
SYNC = "sync"
WATCH_GVKS = "watch_manager_watched_gvk"
# staged host-pipeline instrumentation (pipeline/executor.py via the
# audit manager): per-stage busy seconds / occupancy (busy over pipeline
# wall) / input-queue depth high-water, all labelled {stage=...}, plus
# the device-idle proxy (1 - head-of-line device wait / wall)
PIPELINE_STAGE_SECONDS = "audit_pipeline_stage_seconds"
PIPELINE_STAGE_OCCUPANCY = "audit_pipeline_stage_occupancy"
PIPELINE_QUEUE_HIGHWATER = "audit_pipeline_queue_depth_highwater"
PIPELINE_DEVICE_IDLE = "audit_pipeline_device_idle_fraction"
# device lowering coverage: templates whose compile lowered onto the device
# verdict path vs templates that fell back to the exact interpreter
# (labelled {kind=..., engine=rego|cel}); a user template silently losing
# the device speedup shows up here and in `gator bench` output
LOWERING_LOWERED = "lowering_lowered_count"
LOWERING_FALLBACK = "lowering_fallback_count"
# resilience layer (resilience/faults.py + resilience/policy.py): every
# injected fault, retry, breaker transition, deadline miss, stale serve
# and degradation is observable — the chaos differential asserts on these
RESILIENCE_FAULTS = "resilience_faults_injected_count"  # {site, mode}
RESILIENCE_RETRIES = "resilience_retry_count"  # {dependency}
RESILIENCE_BREAKER_STATE = "resilience_breaker_state"  # {dependency} gauge
RESILIENCE_BREAKER_TRANSITIONS = \
    "resilience_breaker_transition_count"  # {dependency, from, to}
RESILIENCE_DEADLINE_EXCEEDED = \
    "resilience_deadline_exceeded_count"  # {component, policy}
RESILIENCE_STALE_SERVED = "resilience_stale_served_count"  # {dependency}
RESILIENCE_DEGRADED = "resilience_degraded_count"  # {component, to}
RESILIENCE_CHUNKS_FAILED = "resilience_audit_chunks_failed_count"
# sweep-level pipeline aggregates (the ROADMAP's "read stage_busy_sum_s
# vs wall_s + device_idle_fraction" numbers, scraped instead of dug out
# of the bench JSON): wall seconds of the last pipelined sweep, the sum
# of stage busy seconds across stages (> wall == measured overlap), and
# the device-idle proxy already exported above
PIPELINE_WALL = "audit_pipeline_wall_seconds"
PIPELINE_STAGE_BUSY_SUM = "audit_pipeline_stage_busy_sum_seconds"
# span tracer (observability/tracing.py): tail-sampler outcomes — how
# many finished traces the ring buffer kept vs sampled out
TRACE_KEPT = "trace_traces_kept_count"
TRACE_SAMPLED_OUT = "trace_traces_sampled_out_count"
# flatten lanes (ops/flatten.py + parallel/sharded.py sweep_flatten):
# which columnizer lane each sweep chunk actually took {lane=raw|dict|
# py|differential:*}, and the last chunk's host flatten throughput —
# the ROADMAP's "flatten is the sweep ceiling" number, scrapeable
FLATTEN_LANE = "flatten_lane_count"
FLATTEN_OBJECTS_PER_SECOND = "flatten_objects_per_second"
# host-parallel flatten worker pool (--flatten-workers, ops/flatten.py
# FlattenWorkerPool): effective worker processes of the last sweep
# chunk, aggregate columnize throughput per worker-second, the parent-
# side merge (intern + remap + concat) cost, and pool-unavailable
# fallbacks to the in-process columnizer
FLATTEN_WORKER_COUNT = "flatten_worker_count"
FLATTEN_WORKER_OBJECTS_PER_SECOND = "flatten_worker_objects_per_second"
FLATTEN_WORKER_MERGE_SECONDS = "flatten_worker_merge_seconds"
FLATTEN_WORKER_FALLBACKS = "flatten_worker_fallback_count"
# batched external-data join lane (extdata/lane.py): bulk transport
# calls per provider (one fetch per max_keys_per_call chunk of the
# deduped miss list), per-key outcomes (warm = resident column hit with
# zero transport, fetched = landed through a bulk call, perkey = the
# reference lane's single-key fetches), and the resident column size —
# together the "round-trips collapsed" story EXTDATA_BENCH measures
EXTDATA_BULK_CALLS = "extdata_bulk_calls_count"  # {provider}
EXTDATA_KEYS = "extdata_keys_count"  # {provider, outcome}
EXTDATA_COLUMN_KEYS = "extdata_column_keys"  # gauge {provider}
# webhook serving-lane contention:
# in-flight admission handlers per worker, time a review spent queued in
# the batcher lane before its batch ran, and the coalesced batch sizes —
# enough to tell an accept-queue convoy from device-lane convoying
WEBHOOK_INFLIGHT = "webhook_inflight_requests"  # gauge (per process)
WEBHOOK_INFLIGHT_HIGHWATER = "webhook_inflight_highwater"  # gauge
WEBHOOK_QUEUE_WAIT = "webhook_batch_queue_wait_seconds"  # histogram
WEBHOOK_BATCH_SIZE = "webhook_batch_size"  # histogram
# overload protection (resilience/overload.py): the adaptive limiter's
# current in-flight limit, the cost-aware admission queue's depth, the
# brownout ladder level (0 = normal, 1 = optional work stale, 2 = audit
# yields the device lane), sheds by reason, and the measured duration of
# the last graceful drain
OVERLOAD_INFLIGHT_LIMIT = "overload_inflight_limit"  # gauge
OVERLOAD_QUEUE_DEPTH = "overload_queue_depth"  # gauge
OVERLOAD_BROWNOUT = "overload_brownout_level"  # gauge
OVERLOAD_SHED = "overload_shed_count"  # {reason[, tenant, priority]}
# per-tenant / per-priority QoS (resilience/qos.py, --qos on): queued
# admissions per priority lane, queued admission cost and in-flight
# reviews per tenant — the isolation story ("is tenant A starving B")
# as three scrapeable series, all bounded by the cardinality guard
OVERLOAD_LANE_DEPTH = "overload_lane_queue_depth"  # gauge {priority}
OVERLOAD_TENANT_COST = "overload_tenant_queue_cost"  # gauge {tenant}
OVERLOAD_TENANT_INFLIGHT = "overload_tenant_inflight"  # gauge {tenant}
DRAIN_SECONDS = "drain_seconds"  # gauge
# resident columnar snapshot (gatekeeper_tpu/snapshot/): live rows,
# rows dirtied by watch events and awaiting (re)evaluation, tombstoned
# slot fraction (compaction folds them out past a threshold), applied
# row patches {type=add|modify|delete}, and the wall seconds of the
# last full-resync differential
SNAPSHOT_ROWS = "snapshot_rows"  # gauge
SNAPSHOT_DIRTY = "snapshot_dirty_rows"  # gauge
SNAPSHOT_TOMBSTONE_FRACTION = "snapshot_tombstone_fraction"  # gauge
SNAPSHOT_PATCHES = "snapshot_patch_count"  # {type}
SNAPSHOT_RESYNC_SECONDS = "snapshot_resync_seconds"  # gauge
# phase-2 interning (ops.flatten.flatten_phase2): distinct patch-batch
# strings resolved from the row-id-keyed owned-string cache vs. strings
# that had to probe/intern into the cluster-sized global vocab
SNAPSHOT_INTERN_HITS = "snapshot_intern_cache_hits"  # gauge
SNAPSHOT_INTERN_PROBES = "snapshot_intern_global_probes"  # gauge
# snapshot spill (snapshot/persist.py): wall seconds + bytes of the last
# on-disk spill write, boot loads served warm, and boot loads that fell
# back to a relist {reason=cold|corrupt|version|plan|vocab|schema}
SNAPSHOT_SPILL_SECONDS = "snapshot_spill_seconds"  # gauge
SNAPSHOT_SPILL_BYTES = "snapshot_spill_bytes"  # gauge
SNAPSHOT_SPILL_LOAD_HITS = "snapshot_spill_load_hits"
SNAPSHOT_SPILL_LOAD_MISS = "snapshot_spill_load_miss_count"  # {reason}
# device-resident snapshot lane (snapshot/device_residency.py): HBM
# bytes held by resident column/mask mirrors, host->device bytes the
# last audit tick actually shipped (a warm clean-rows resident tick
# reads ZERO), and groups demoted back to host columns (generation
# swaps, SLO `device_residency_evict` breaches)
SNAPSHOT_RESIDENT_BYTES = "snapshot_resident_bytes"  # gauge
TICK_H2D_BYTES = "tick_h2d_bytes"  # gauge {cluster}
RESIDENCY_EVICTIONS = "residency_evictions_total"
# batched mutation + expansion lane (gatekeeper_tpu/mutlane/): batched
# lane passes, objects routed to the authoritative host walk {reason},
# emitted RFC-6902 patch ops, and convergence iterations per applied
# object (1 = already at fixed point)
MUTATION_BATCH = "mutation_batch_count"
MUTATION_FALLBACK = "mutation_fallback_count"  # {reason}
MUTATION_PATCH_OPS = "mutation_patch_ops_count"
MUTATION_CONVERGENCE = "mutation_convergence_iterations"  # histogram
# registry self-observation: labelset folds by the cardinality guard
# (an unbounded {template}/{tenant} label set is a memory leak at
# production churn; overflow series fold into an `other` label value)
DROPPED_LABELS = "metrics_dropped_labels_count"
# per-template cost attribution (observability/costattr.py): device
# dispatch / host flatten / exact-render wall seconds apportioned across
# the constraint grid {template, enforcement_point, phase} — "which
# policy is expensive" as a query (served at /debug/cost, summarized by
# `gator bench --attribution`)
CONSTRAINT_EVAL = "constraint_eval_seconds"
# SLO engine (observability/slo.py): declarative objectives evaluated
# in-process — the SLI value, multi-window burn rates {objective,
# window}, compliance gauge, and breach transitions
SLO_SLI = "slo_sli_value"  # gauge {objective}
SLO_BURN_RATE = "slo_burn_rate"  # gauge {objective, window}
SLO_COMPLIANT = "slo_compliant"  # gauge {objective} (1 in-SLO)
SLO_BREACHES = "slo_breach_count"  # {objective}
# per-objective degradation maps: 1 while the named action is held
# active by a breaching objective ({cluster} added for fleet-scoped
# objectives), 0 on the falling-edge release
SLO_DEGRADATION = "slo_degradation_active"  # gauge {objective, action}
# admission flight recorder (observability/flightrec.py): decisions
# captured into the bounded ring (served at /debug/decisions)
FLIGHTREC_DECISIONS = "flightrec_decisions_recorded_count"  # {decision}
# fleet mode (gatekeeper_tpu/fleet/): one evaluator multiplexing N
# clusters behind shared compile/executable caches — cluster and
# library-runtime counts, clusters that attached to an ALREADY-BUILT
# runtime (the zero-lowering boot), packed device dispatches vs the
# dispatches N independent sweeps would have paid, rows swept per
# cluster, and the wall seconds of the last fleet pass
FLEET_CLUSTERS = "fleet_clusters"  # gauge
FLEET_RUNTIMES = "fleet_library_runtimes"  # gauge
FLEET_SHARED_BOOTS = "fleet_runtime_shared_boot_count"
FLEET_PACKED_DISPATCHES = "fleet_packed_dispatch_count"
FLEET_UNPACKED_DISPATCHES = "fleet_unpacked_dispatch_count"
FLEET_SWEPT_ROWS = "fleet_swept_rows_count"  # {cluster}
FLEET_SWEEP_SECONDS = "fleet_sweep_seconds"  # gauge
# generations (drivers/generation.py, --generation-swap on): the serving
# generation id, wall seconds of the last background build, completed
# swaps, and the on-disk compile cache's outcomes — a warm restart shows
# hit_count == template count and zero fresh lowering
GENERATION_ID = "generation_id"  # gauge
GENERATION_COMPILE_SECONDS = "generation_compile_seconds"  # gauge
GENERATION_SWAP_COUNT = "generation_swap_count"
GENERATION_CACHE_HIT = "generation_cache_hit_count"
GENERATION_CACHE_MISS = "generation_cache_miss_count"  # {reason}
# shadow canary + decision replay (gatekeeper_tpu/replay/): the shadow
# lane evaluates copies of live admissions against a candidate library
# off the response path; divergence{kind} vs decisions is the canary's
# promote/abort signal (the shadow-divergence-rate SLO objective), and
# replay_* covers the offline `gator replay` time machine
SHADOW_DECISIONS = "shadow_decisions_count"  # {decision}
SHADOW_DIVERGENCE = "shadow_divergence_count"  # {kind}
SHADOW_DROPPED = "shadow_dropped_count"
SHADOW_QUEUE_DEPTH = "shadow_queue_depth"  # gauge
REPLAY_RECORDS = "replay_records_count"  # {outcome}
REPLAY_DIVERGENCE = "replay_divergence_count"  # {kind}
REPLAY_SECONDS = "replay_seconds"  # gauge
# adversarial corpus + chaos soak (gatekeeper_tpu/fuzz/): corpus cases
# generated per scenario family, soak requests driven per endpoint,
# divergences any armed differential lane reported (zero on a clean
# run), verdicts lost at drain (requests that never answered), and the
# last soak's wall seconds
FUZZ_CASES = "fuzz_corpus_cases_count"  # {family}
FUZZ_SOAK_REQUESTS = "fuzz_soak_requests_count"  # {endpoint}
FUZZ_SOAK_DIVERGENCE = "fuzz_soak_divergence_count"  # {lane}
FUZZ_SOAK_LOST = "fuzz_soak_lost_verdicts_count"
FUZZ_SOAK_SECONDS = "fuzz_soak_seconds"  # gauge
