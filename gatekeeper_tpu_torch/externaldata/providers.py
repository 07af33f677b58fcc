"""External data providers: cache, validation, batched resolution.

Reference: the framework's externaldata package + Provider CRD
(main.go:420-458); mutation placeholder resolution batches per-provider
calls with mTLS and a 5s timeout (mutation/system_external_data.go:21-221);
responses may be TTL-cached.  The transport is pluggable (``send_fn``) so
tests and offline runs need no network; the default transport posts the
ExternalData ProviderRequest JSON over HTTPS.

Copy of ``gatekeeper_tpu/externaldata/providers.py`` (host-only), hooks
included: the ``traceparent`` header of ``default_send``, the metrics
counters, the ``externaldata.send`` span and fault site (with its
``partial`` truncation) and the stale serving of ``fetch`` under an
overload brownout or the ``extdata_stale`` degradation.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from gatekeeper_tpu_torch.utils.unstructured import deep_get, gvk_of, name_of

PROVIDER_GROUP = "externaldata.gatekeeper.sh"


class ProviderError(Exception):
    pass


@dataclass
class Provider:
    name: str
    url: str
    timeout_s: float = 5.0
    ca_bundle: str = ""
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_unstructured(obj: dict) -> "Provider":
        group, _, kind = gvk_of(obj)
        if kind != "Provider" or group != PROVIDER_GROUP:
            raise ProviderError(f"not a Provider: {group}/{kind}")
        name = name_of(obj)
        spec = obj.get("spec") or {}
        url = spec.get("url", "")
        if not url:
            raise ProviderError(f"provider {name}: missing spec.url")
        if not url.startswith("https://"):
            # reference: provider URLs must use HTTPS (webhook validation of
            # Provider resources, policy.go:564-580)
            raise ProviderError(f"provider {name}: url must be https")
        if not spec.get("caBundle"):
            raise ProviderError(f"provider {name}: caBundle required")
        return Provider(
            name=name,
            url=url,
            timeout_s=float(spec.get("timeout", 5) or 5),
            ca_bundle=spec.get("caBundle", ""),
            raw=obj,
        )


def default_send(provider: Provider, keys: list) -> dict:
    """POST an ExternalData ProviderRequest (reference request shape)."""
    import base64
    import ssl
    import urllib.request

    body = json.dumps({
        "apiVersion": "externaldata.gatekeeper.sh/v1beta1",
        "kind": "ProviderRequest",
        "request": {"keys": keys},
    }).encode()
    # the provider's private CA (spec.caBundle, required by validation) must
    # anchor the TLS verification
    ctx = ssl.create_default_context(
        cadata=base64.b64decode(provider.ca_bundle).decode()
    )
    headers = {"Content-Type": "application/json"}
    # traceparent emit: the provider can join its own processing span to
    # the admission/audit trace that triggered this fetch
    from gatekeeper_tpu_torch.observability import tracing

    tp = tracing.format_traceparent()
    if tp is not None:
        headers[tracing.TRACEPARENT_HEADER] = tp
    req = urllib.request.Request(
        provider.url, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=provider.timeout_s,
                                context=ctx) as resp:
        return json.loads(resp.read())


class ProviderCache:
    """Provider registry + response TTL cache + batched resolution.

    Resilience (resilience/policy.py): each provider gets a circuit
    breaker; transport failures retry with seeded-jitter exponential
    backoff bounded by the ambient request deadline.  When the breaker is
    open — or the transport keeps failing — keys present in the TTL cache
    are served STALE (the reference's external-data TTL-cache fallback)
    and counted in ``gatekeeper_resilience_stale_served_count``; keys
    with no cached value surface a per-key error that flows into the
    placeholder failure-policy semantics (Fail | Ignore | UseDefault)."""

    def __init__(self, send_fn: Optional[Callable] = None,
                 response_ttl_s: float = 180.0,
                 metrics=None,
                 retry=None,  # resilience.policy.RetryPolicy
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 30.0):
        self._providers: dict[str, Provider] = {}
        self._responses: dict[tuple, tuple] = {}  # (provider, key) -> (t, val)
        self.send_fn = send_fn or default_send
        self.response_ttl_s = response_ttl_s
        self.metrics = metrics
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        if retry is None:
            from gatekeeper_tpu_torch.resilience.policy import RetryPolicy

            retry = RetryPolicy(attempts=3, base_s=0.05, cap_s=1.0,
                                dependency="externaldata", metrics=metrics)
        self.retry = retry
        self._breakers: dict[str, Any] = {}
        self._lock = threading.Lock()
        # provider-change listeners (name) — the extdata lane registers
        # its column invalidation here so a Provider reconcile from
        # (the CLI's manifest load) drops the resident join columns
        self._listeners: list = []

    def add_listener(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, name: str) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(name)
            except Exception:
                pass  # invalidation must never break reconcile

    def _breaker(self, provider_name: str):
        from gatekeeper_tpu_torch.resilience.policy import CircuitBreaker

        with self._lock:
            b = self._breakers.get(provider_name)
            if b is None:
                b = CircuitBreaker(
                    f"externaldata/{provider_name}",
                    failure_threshold=self.breaker_threshold,
                    reset_timeout_s=self.breaker_reset_s,
                    metrics=self.metrics)
                self._breakers[provider_name] = b
            return b

    def upsert(self, obj_or_provider) -> Provider:
        p = (obj_or_provider if isinstance(obj_or_provider, Provider)
             else Provider.from_unstructured(obj_or_provider))
        with self._lock:
            self._providers[p.name] = p
            self._drop_responses(p.name)
        self._notify(p.name)
        return p

    def remove(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)
            self._drop_responses(name)
        self._notify(name)

    def _drop_responses(self, name: str) -> None:
        """Reconcile invalidation (call under the lock): a Provider spec
        change (URL, CA, timeout) voids its cached answers — stale-serve
        fallbacks must not resurrect responses from the OLD endpoint."""
        for key in [k for k in self._responses if k[0] == name]:
            del self._responses[key]

    def get(self, name: str) -> Optional[Provider]:
        return self._providers.get(name)

    # --- resolution (reference: system_external_data.go) ----------------
    def _send(self, provider: Provider, keys: list) -> dict:
        """One transport round-trip through the chaos seam.  A partial
        fault truncates the item list (the provider 'answered' for only a
        fraction of the keys); the missing keys surface per-key 'key not
        returned' errors downstream."""
        from gatekeeper_tpu_torch.observability import tracing
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        with tracing.span("externaldata.send", provider=provider.name,
                          n_keys=len(keys)):
            action = fault_point("externaldata.send",
                                 provider=provider.name, n_keys=len(keys))
            resp = self.send_fn(provider, keys)
            if action is not None and action.mode == "partial":
                items = deep_get(resp, ("response", "items"), []) or []
                keep = int(len(items) * action.spec.fraction)
                resp = {"response": {
                    "items": items[:keep],
                    "systemError": deep_get(resp,
                                            ("response", "systemError"),
                                            ""),
                }}
            system_error = deep_get(resp, ("response", "systemError"), "")
            if system_error:
                raise ProviderError(
                    f"provider {provider.name}: {system_error}")
            return resp

    def _serve_stale(self, provider_name: str, keys: list, out: dict,
                     reason: str) -> None:
        """Fill ``out`` for ``keys`` from expired TTL-cache entries
        (graceful degradation); keys never fetched get a per-key error
        that the placeholder failure policy interprets."""
        n_stale = 0
        with self._lock:
            for key in keys:
                hit = self._responses.get((provider_name, key))
                if hit is not None:
                    out[key] = hit[1]
                    n_stale += 1
                else:
                    out[key] = (None, f"provider {provider_name}: {reason}; "
                                      "no cached value")
        if n_stale and self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.RESILIENCE_STALE_SERVED,
                {"dependency": f"externaldata/{provider_name}"},
                value=float(n_stale))

    def fetch(self, provider_name: str, keys: list) -> dict:
        """Returns key -> (value, error-string-or-None); TTL-cached.
        Transport failures retry with jittered backoff (deadline-bounded);
        a tripped breaker — or exhausted retries — serves stale cache
        entries and per-key errors instead of raising."""
        provider = self._providers.get(provider_name)
        if provider is None:
            raise ProviderError(f"provider {provider_name!r} not found")
        now = time.monotonic()
        out: dict = {}
        missing = []
        with self._lock:
            for key in keys:
                hit = self._responses.get((provider_name, key))
                if hit and now - hit[0] < self.response_ttl_s:
                    out[key] = hit[1]
                else:
                    missing.append(key)
        if not missing:
            return out
        from gatekeeper_tpu_torch.resilience import overload as _overload

        if _overload.current_brownout() >= 1 or \
                _overload.degradation_active(_overload.EXTDATA_STALE):
            # overload brownout (resilience/overload.py) — or a
            # breaching SLO objective holding the extdata_stale
            # degradation action: external-data joins are the expensive
            # optional work degraded BEFORE any admission is shed —
            # expired cache entries serve stale, keys never fetched
            # flow into the placeholder failure policy
            self._serve_stale(provider_name, missing, out,
                              "overload brownout")
            return out
        breaker = self._breaker(provider_name)
        if not breaker.allow():
            self._serve_stale(provider_name, missing, out,
                              "circuit breaker open")
            return out
        try:
            resp = self.retry.call(self._send, provider, missing)
        except Exception as e:
            breaker.record_failure()
            self._serve_stale(provider_name, missing, out, str(e))
            return out
        breaker.record_success()
        items = deep_get(resp, ("response", "items"), []) or []
        if not isinstance(items, list):
            items = []  # schema drift: every key degrades below
        got = {}
        for item in items:
            # response-schema hardening: a misbehaving provider may
            # return non-dict items or non-string keys/errors — skip or
            # coerce so the affected keys degrade to the per-key
            # "key not returned" error instead of crashing the batch
            if not isinstance(item, dict):
                continue
            key = item.get("key")
            if not isinstance(key, str):
                continue
            err = item.get("error")
            if err is not None and not isinstance(err, str):
                err = str(err)
            got[key] = (item.get("value"), err or None)
        with self._lock:
            for key in missing:
                value = got.get(key, (None, "key not returned"))
                self._responses[(provider_name, key)] = (now, value)
                out[key] = value
        return out

    def prefetch(self, pairs) -> None:
        """Concurrently warm the response cache for (provider, key) pairs
        (reference: async batch joins — the dispatcher overlaps provider
        RTTs instead of fetching serially).  Errors are swallowed here and
        surface through resolve()'s failure-policy semantics."""
        from concurrent.futures import ThreadPoolExecutor

        by_provider: dict = {}
        for provider, key in pairs:
            by_provider.setdefault(provider, set()).add(key)
        if len(by_provider) <= 1:
            for provider, keys in by_provider.items():
                try:
                    self.fetch(provider, sorted(keys, key=repr))
                except Exception:
                    pass
            return
        with ThreadPoolExecutor(max_workers=min(8, len(by_provider))) as ex:
            futures = [
                ex.submit(self.fetch, provider, sorted(keys, key=repr))
                for provider, keys in by_provider.items()
            ]
            for f in futures:
                try:
                    f.result()
                except Exception:
                    pass

    def resolve(self, placeholder) -> Any:
        """Resolve one mutation placeholder (failure policy semantics:
        Fail | Ignore | UseDefault)."""
        # ValueAtLocation: key = the pre-mutation value at the location;
        # Username: key = the admission username (caller sets original_value)
        key = placeholder.original_value
        try:
            result = self.fetch(placeholder.provider, [key])
            value, err = result[key]
            if err:
                raise ProviderError(err)
            return value
        except Exception as e:
            policy = placeholder.failure_policy
            if policy == "UseDefault":
                return placeholder.default
            if policy == "Ignore":
                return placeholder.original_value
            raise
