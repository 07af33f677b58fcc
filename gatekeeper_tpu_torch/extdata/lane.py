"""ExtDataLane: dedupe once per batch, call once per provider, join on
the device.

Port of ``gatekeeper_tpu/extdata/lane.py``.  External data is an input to
BOTH validation and mutation, but the per-key path (``ProviderCache.fetch``
with one key per call) is a per-object interpreter loop in disguise: at
burst scale the provider round-trips dominate the verdict math.  This lane
batches the join:

- **key extraction + dedupe** — provider keys referenced by lowered
  templates are pulled from the already-interned vocab sids of the
  flattened batch (drivers/torch_driver.extdata_cols) and deduped across
  the whole admission burst / audit chunk; mutation placeholders dedupe
  across a convergence pass the same way.
- **one bulk call per (provider, batch)** — ``ensure`` funnels the
  deduped miss list through ``ProviderCache.fetch`` in
  ``max_keys_per_call`` chunks: ONE transport send per chunk, with the
  retry / breaker / stale-fallback semantics preserved PER KEY (transport
  failure = per-key stale or error entries, exactly what the per-key path
  would have produced).
- **resident columns** — responses land in :class:`ProviderColumn`
  (TTL + invalidation on Provider reconcile), so steady-state bursts
  hit warm columns with zero transport calls.
- **device join** — ``tables_for`` turns a column into vocab-padded
  ``ext:<provider>:{ok,val}`` arrays the constraint grid reads through
  ir/nodes.ExtDataOk / ExtDataValueSid (two gathers in ir/program.py, on
  the card).

Lane modes (``--extdata-lane``):

- ``batched``: all of the above (the default).
- ``perkey``: the authoritative reference — every resolution is a
  single-key ``ProviderCache.fetch`` and external-data templates stay on
  the exact interpreter (no device tables).
- ``differential``: batched AND per-key per resolution, resolved values
  asserted identical (:class:`ExtDataDivergence` on mismatch); the
  driver additionally asserts grid verdicts == interpreter verdicts for
  external-data templates.

Activation: :func:`install` for the process (``--extdata-lane`` CLI),
:func:`activate` for scoped tests; the Rego ``external_data`` builtin and
the mutation system read :func:`active`.

The counts go to a metrics registry (``metrics=``) as in the JAX package,
and also into the lane's plain ``perf`` dict: ``bulk_calls/<provider>``
(one per transport send of the batched path) and
``keys/<provider>/<outcome>`` (``warm``, ``fetched``, ``perkey``,
``malformed``).  Each bulk fetch runs in an ``extdata.join`` span.
"""

from __future__ import annotations

import contextvars
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np

from gatekeeper_tpu_torch.extdata.column import ProviderColumn

MODES = ("batched", "perkey", "differential")

# per-key error for keys that were requested but never landed (should
# not happen: ProviderCache.fetch answers every key, value or error)
_NOT_LANDED = "external data: key not resolved"

# the declared provider-response entry schema at the ProviderColumns
# ingest boundary: key -> (json-typed value, error-string-or-None)
_JSON_TYPES = (type(None), bool, int, float, str, list, dict)
_MALFORMED = "malformed provider response"


def validate_landed(landed: dict) -> tuple:
    """Response-schema gate at the ProviderColumns ingest boundary.

    Whatever the transport/cache layer handed back, only well-formed
    ``key -> (json-value, error-or-None)`` entries may land in a
    resident column.  A malformed entry becomes the already-pinned
    per-key failure semantics — an error entry the placeholder failure
    policy handles — never a crash, never a poisoned column; a non-str
    key (nothing requested it, nothing could read it) drops.  Returns
    ``(clean_entries, n_malformed)``."""
    out: dict = {}
    bad = 0
    for key, entry in landed.items():
        if not isinstance(key, str):
            bad += 1
            continue
        if isinstance(entry, (tuple, list)) and len(entry) == 2 \
                and isinstance(entry[0], _JSON_TYPES) \
                and (entry[1] is None or isinstance(entry[1], str)):
            out[key] = (entry[0], entry[1])
        else:
            bad += 1
            out[key] = (None, _MALFORMED)
    return out, bad


class ExtDataDivergence(AssertionError):
    """The batched join disagreed with the per-key reference."""


class ExtDataLane:
    def __init__(self, cache, mode: str = "batched",
                 column_ttl_s: Optional[float] = None,
                 max_keys_per_call: int = 256,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 fanout: int = 4):
        if mode not in MODES:
            raise ValueError(f"extdata lane mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.cache = cache  # externaldata.providers.ProviderCache
        self.mode = mode
        self.column_ttl_s = (cache.response_ttl_s if column_ttl_s is None
                             else column_ttl_s)
        self.max_keys_per_call = max(1, int(max_keys_per_call))
        self.metrics = metrics
        self._clock = clock
        # per-provider bulk-fetch concurrency (ensure_many): a chunk
        # referencing N providers lands their miss lists across a small
        # thread pool instead of serially; 1 = serial (bit-identical)
        self.fanout = max(1, int(fanout))
        self._pool = None  # lazy ThreadPoolExecutor, daemon threads
        self._columns: dict[str, ProviderColumn] = {}
        # (provider, id(vocab)) -> (weakref to the vocab, column version,
        # covered vocab len, tables dict): reusable for that vocab while
        # the column is unchanged and every requested key sid is under the
        # covered length (sids interned after the build would clip out of
        # range = a silent miss).  The tables index one vocab's sids, so
        # drivers with other vocabs sharing the lane get their own entry
        # (the JAX lane keys on the provider alone)
        self._table_cache: dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        # bulk calls and keys by outcome (see the module docstring)
        self.perf: dict = {}
        self._perf_lock = threading.Lock()
        # provider reconcile -> column invalidation (Provider manifests
        # load through ProviderCache.upsert/remove)
        add = getattr(cache, "add_listener", None)
        if add is not None:
            add(self._on_provider_change)

    # --- residency -------------------------------------------------------
    def device_join(self) -> bool:
        """True when external-data templates may ride the device grid
        (batched/differential); perkey keeps them on the interpreter."""
        return self.mode != "perkey"

    def column(self, provider: str) -> ProviderColumn:
        with self._lock:
            col = self._columns.get(provider)
            if col is None:
                col = ProviderColumn(provider, ttl_s=self.column_ttl_s,
                                     clock=self._clock)
                self._columns[provider] = col
            return col

    def export_columns(self) -> dict:
        """Spill payload: every resident ProviderColumn's entries with
        per-key remaining TTL (the snapshot spill's extdata section)."""
        with self._lock:
            cols = dict(self._columns)
        return {p: {"ttl_s": col.ttl_s,
                    "entries": col.export_entries()}
                for p, col in cols.items()}

    def import_columns(self, payload: dict, elapsed_s: float = 0.0
                       ) -> int:
        """Re-land spilled columns; ``elapsed_s`` (the wall time since
        the spill was written) consumes each key's remaining TTL, and
        expired keys drop on load — a warm restart re-fetches only what
        actually expired.  Returns total keys landed."""
        landed = 0
        for provider, rec in (payload or {}).items():
            col = self.column(provider)
            landed += col.import_entries(rec.get("entries") or {},
                                         elapsed_s=elapsed_s)
        return landed

    def invalidate(self, provider: Optional[str] = None) -> None:
        with self._lock:
            cols = ([self._columns[provider]]
                    if provider in self._columns else
                    list(self._columns.values()) if provider is None else [])
            if provider is None:
                self._table_cache.clear()
            else:
                for key in [k for k in self._table_cache
                            if k[0] == provider]:
                    del self._table_cache[key]
        for col in cols:
            col.invalidate()

    def _on_provider_change(self, name: str) -> None:
        self.invalidate(name)

    def _count(self, key: str, n: int) -> None:
        if n:
            with self._perf_lock:
                self.perf[key] = self.perf.get(key, 0) + n

    def _count_keys(self, provider: str, outcome: str, n: int) -> None:
        self._count(f"keys/{provider}/{outcome}", n)
        if n and self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.EXTDATA_KEYS, {"provider": provider, "outcome": outcome},
                value=float(n))

    def ensure(self, provider: str, keys) -> int:
        """Land every requested key into the provider's column (bulk
        fetch of the deduped miss list, ``max_keys_per_call`` per
        transport send).  Returns the number of keys fetched — 0 is the
        warm-column steady state.  Transport-level failures never raise:
        ProviderCache.fetch degrades per key (stale / error), and an
        unknown provider lands a per-key error for every key."""
        from gatekeeper_tpu_torch.observability import tracing

        col = self.column(provider)
        missing = col.missing(keys)
        n_req = len({k for k in keys})
        self._count_keys(provider, "warm", n_req - len(missing))
        if not missing:
            return 0
        with tracing.span("extdata.join", provider=provider,
                          n_keys=n_req, n_miss=len(missing)):
            landed: dict = {}
            for i in range(0, len(missing), self.max_keys_per_call):
                chunk = missing[i:i + self.max_keys_per_call]
                try:
                    res = self.cache.fetch(provider, chunk)
                except Exception as e:  # unknown provider etc.
                    res = {k: (None, str(e)) for k in chunk}
                landed.update(res)
                self._count(f"bulk_calls/{provider}", 1)
                if self.metrics is not None:
                    from gatekeeper_tpu_torch.metrics import registry as M

                    self.metrics.inc_counter(
                        M.EXTDATA_BULK_CALLS, {"provider": provider})
            landed, n_bad = validate_landed(landed)
            self._count_keys(provider, "malformed", n_bad)
            col.land(landed)
        self._count_keys(provider, "fetched", len(missing))
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.EXTDATA_COLUMN_KEYS, len(col),
                                   {"provider": provider})
        return len(missing)

    def ensure_many(self, requests: dict) -> int:
        """Land several providers' key sets concurrently: one
        :meth:`ensure` per provider, fanned across a small thread pool
        (``fanout``).  Per-key failure semantics are exactly the serial
        path's — each worker runs the unchanged ``ensure`` (bulk
        ``ProviderCache.fetch`` with per-key retry/breaker/stale
        degradation), they just overlap in wall time.  Returns total
        keys fetched (0 = every column warm)."""
        items = [(p, ks) for p, ks in sorted(requests.items()) if ks]
        if not items:
            return 0
        if len(items) == 1 or self.fanout <= 1:
            return sum(self.ensure(p, ks) for p, ks in items)
        # only cold providers pay a worker; warm ones answer inline
        cold = [(p, ks) for p, ks in items
                if self.column(p).missing(ks)]
        total = sum(self.ensure(p, ks) for p, ks in items
                    if (p, ks) not in cold)
        if not cold:
            return total
        if len(cold) == 1:
            return total + self.ensure(*cold[0])
        pool = self._pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = self._pool = ThreadPoolExecutor(
                max_workers=self.fanout,
                thread_name_prefix="extdata-fanout")
        futures = [pool.submit(self.ensure, p, ks) for p, ks in cold]
        return total + sum(f.result() for f in futures)

    # --- resolution ------------------------------------------------------
    def _resolve_perkey(self, provider: str, keys) -> dict:
        """The authoritative per-key reference: one ProviderCache.fetch
        per key (a transport round-trip per cold key)."""
        out: dict = {}
        for k in keys:
            if k in out:
                continue
            try:
                out[k] = self.cache.fetch(provider, [k])[k]
            except Exception as e:
                out[k] = (None, str(e))
        self._count_keys(provider, "perkey", len(out))
        return out

    def _resolve_batched(self, provider: str, keys) -> dict:
        self.ensure(provider, keys)
        col = self.column(provider)
        out: dict = {}
        for k in keys:
            if k in out:
                continue
            hit = col.get(k)
            out[k] = hit if hit is not None else (None, _NOT_LANDED)
        return out

    def resolve_keys(self, provider: str, keys) -> dict:
        """``key -> (value, error-or-None)`` for deduped ``keys`` under
        the active lane mode.  ``differential`` resolves through BOTH
        paths and raises :class:`ExtDataDivergence` on any value/error
        mismatch."""
        keys = [k for k in keys]
        if self.mode == "perkey":
            return self._resolve_perkey(provider, keys)
        out = self._resolve_batched(provider, keys)
        if self.mode == "differential":
            ref = self._resolve_perkey(provider, keys)
            for k, got in out.items():
                want = ref.get(k)
                if got != want:
                    raise ExtDataDivergence(
                        f"extdata differential: provider {provider!r} "
                        f"key {k!r}: batched={got!r} perkey={want!r}")
        return out

    def resolve_placeholders(self, placeholders) -> dict:
        """Batch-resolve mutation placeholders: ONE lane resolution per
        provider over the deduped key set.  Returns
        ``(provider, key) -> (value, error-or-None)``; failure-policy
        interpretation stays with the caller (mutation/system.py), so
        Fail/Ignore/UseDefault semantics are exactly the per-key
        path's."""
        by_provider: dict = {}
        for ph in placeholders:
            by_provider.setdefault(ph.provider, []).append(ph.original_value)
        if self.mode != "perkey" and len(by_provider) > 1:
            # multi-provider burst: land every provider's misses in one
            # fan-out, then resolve from the warm columns (the perkey
            # reference keeps its strictly serial per-key transport)
            self.ensure_many(by_provider)
        out: dict = {}
        for provider, keys in sorted(by_provider.items()):
            resolved = self.resolve_keys(provider, keys)
            for k, ve in resolved.items():
                out[(provider, k)] = ve
        return out

    # --- device join tables ---------------------------------------------
    def tables_for(self, provider: str, keys, vocab) -> dict:
        """Vocab-padded join arrays for one provider after ensuring all
        ``keys`` (strings, already interned by the flatten) are landed:

        - ``ext:<provider>:ok``  bool[Vpad]  — key resolved, no per-key
          error (the ``responses`` membership test);
        - ``ext:<provider>:val`` int32[Vpad] — sid of the resolved value
          when it is a string, -2 for resolved non-string values, -3 for
          unresolved keys.

        Arrays are cached per (vocab, column version, covered vocab
        length), so a warm column returns the identical numpy objects and
        the
        evaluators' device table caches skip the upload.  The build holds
        the vocab's intern lock (``Vocab.held``): it reads ``len(vocab)``
        as its covered length and then interns value strings, and another
        thread's intern between the two would be a sid the table misses.
        Callers build every vocab-derived table after this call."""
        from gatekeeper_tpu_torch.ir.program import _vpad

        self.ensure(provider, keys)
        col = self.column(provider)
        ver = col.version
        slot = (provider, id(vocab))
        with self._lock:
            cached = self._table_cache.get(slot)
        if cached is not None and cached[0]() is vocab and cached[1] == ver:
            covered = cached[2]
            if all(0 <= vocab.lookup(k) < covered for k in keys):
                return cached[3]
        with vocab.held():
            covered = len(vocab)
            vp = _vpad(covered)
            ok = np.zeros(vp, bool)
            val = np.full(vp, -3, np.int32)
            for key, (v, e) in col.snapshot().items():
                sid = vocab.lookup(key)
                if not (0 <= sid < covered):
                    continue  # resident key never interned: nothing reads it
                if e is None:
                    ok[sid] = True
                    val[sid] = vocab.intern(v) if isinstance(v, str) else -2
        tables = {f"ext:{provider}:ok": ok, f"ext:{provider}:val": val}
        with self._lock:
            for key in [k for k, e in self._table_cache.items()
                        if e[0]() is None]:
                del self._table_cache[key]  # that vocab was collected
            self._table_cache[slot] = (weakref.ref(vocab), ver, covered,
                                       tables)
        return tables

    def snapshot(self) -> dict:
        """Introspection (tests / debug): per-provider residency."""
        with self._lock:
            cols = dict(self._columns)
        return {
            "mode": self.mode,
            "providers": {p: {"keys": len(c), "version": c.version}
                          for p, c in sorted(cols.items())},
        }


# --- activation -------------------------------------------------------------

_ctx_lane: contextvars.ContextVar = contextvars.ContextVar(
    "extdata_lane", default=None)
_global_lane: list = [None]


def install(lane: Optional[ExtDataLane]) -> None:
    """Process-global activation (the ``--extdata-lane`` CLI path):
    webhook handler threads, the audit thread and the batcher all see
    one lane."""
    _global_lane[0] = lane


def uninstall() -> None:
    _global_lane[0] = None


@contextmanager
def activate(lane: ExtDataLane, process: bool = True):
    """Scoped activation for tests; restores both scopes on exit."""
    token = _ctx_lane.set(lane)
    prev = _global_lane[0]
    if process:
        _global_lane[0] = lane
    try:
        yield lane
    finally:
        _ctx_lane.reset(token)
        if process:
            _global_lane[0] = prev


def active() -> Optional[ExtDataLane]:
    lane = _ctx_lane.get()
    if lane is None:
        lane = _global_lane[0]
    return lane


# --- the Rego builtin's fetch (lang/rego/builtins.py delegates here) ------

def builtin_fetch(req):
    """``external_data({"provider": p, "keys": [...]})`` — the reference
    response shape: ``{"responses": [[key, value], ...], "errors":
    [[key, err], ...], "status_code": 200, "system_error": ""}``.

    Transport-level failures surface as PER-KEY errors (the
    ProviderCache stale/error fallback), never as ``system_error`` —
    the lowered device join and this host reference agree on that
    single encoding.  Keys dedupe on first occurrence; non-string keys
    are per-key errors (the device join's non-string subjects read
    not-resolved the same way).  With no lane active every key errors —
    external-data policies fail closed toward their template's own
    error handling."""
    from gatekeeper_tpu_torch.lang.rego.builtins import UNDEFINED

    if not isinstance(req, dict):
        return UNDEFINED
    provider = req.get("provider")
    keys = req.get("keys")
    if not isinstance(provider, str) or not isinstance(keys, list):
        return UNDEFINED
    uniq: list = []
    seen: set = set()
    for k in keys:
        marker = k if isinstance(k, (str, int, float, bool)) else repr(k)
        if (type(marker), marker) in seen:
            continue
        seen.add((type(marker), marker))
        uniq.append(k)
    str_keys = [k for k in uniq if isinstance(k, str)]
    lane = active()
    if lane is None:
        resolved = {k: (None, "external data: no lane configured")
                    for k in str_keys}
    else:
        resolved = lane.resolve_keys(provider, str_keys)
    responses: list = []
    errors: list = []
    for k in uniq:
        if not isinstance(k, str):
            errors.append([k, "external data: key is not a string"])
            continue
        v, e = resolved.get(k, (None, _NOT_LANDED))
        if e:
            errors.append([k, e])
        else:
            responses.append([k, v])
    return {"responses": responses, "errors": errors,
            "status_code": 200, "system_error": ""}
