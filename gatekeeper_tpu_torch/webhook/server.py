"""Admission webhook HTTP server.

Port of ``gatekeeper_tpu/webhook/server.py``: a threaded stdlib HTTP
server speaking the AdmissionReview v1 protocol on ``/v1/admit`` (the
validating handler, webhook/policy.py), ``/v1/mutate`` (the mutating
handler, webhook/mutation.py or the batched mutlane/webhook.py; its answer
carries a base64 JSONPatch) and ``/v1/admitlabel`` (the namespace-label
guard, webhook/namespacelabel.py), with ``/healthz`` for readiness (and
the readiness tracker's stats, ``readiness_stats``).  TLS is optional
(``certfile``/``keyfile``, reloaded by :meth:`WebhookServer.reload_certs`
when the rotation loop renews them); ``client_ca_file`` requires and
verifies client certificates (mTLS).  ``reuse_port`` binds with
``SO_REUSEPORT``, so the replicas of ``--webhook-workers`` share one port
and the kernel spreads connections over them.

Beside them the observability surface: ``/metrics`` (Prometheus text, or
OpenMetrics with exemplars when the scraper asks), ``/debug/profile``
(with ``enable_profile``), ``/debug/traces``, ``/debug/cost``,
``/debug/slo``, ``/debug/decisions``, ``/debug/overload`` and
``/debug/shadow`` (the shadow canary: GET its counters, POST
``{"action": "promote"|"abort"}``); each answers 404 until its piece is
enabled.  Every POST runs under a
``webhook.request`` span that takes in and echoes a W3C ``traceparent``,
with the ``webhook.request`` fault site inside it.  A shed answer under
failurePolicy=Fail carries ``Retry-After``.
"""

from __future__ import annotations

import base64
import json
import socket
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from gatekeeper_tpu_torch.observability import tracing

ADMIT_PATH = "/v1/admit"
MUTATE_PATH = "/v1/mutate"
ADMIT_LABEL_PATH = "/v1/admitlabel"
HEALTH_PATH = "/healthz"
METRICS_PATH = "/metrics"
PROFILE_PATH = "/debug/profile"
TRACES_PATH = "/debug/traces"
COST_PATH = "/debug/cost"
SLO_PATH = "/debug/slo"
DECISIONS_PATH = "/debug/decisions"
OVERLOAD_PATH = "/debug/overload"
SHADOW_PATH = "/debug/shadow"
MAX_BODY_BYTES = 64 * 1024 * 1024  # the apiserver's admission payload bound


def admission_response(uid: str, allowed: bool, message: str = "",
                       code: int = 200, warnings=None, patch=None) -> dict:
    resp: dict = {"uid": uid, "allowed": allowed}
    if message or code != 200:
        resp["status"] = {"code": code if not allowed else 200,
                          "message": message}
    if warnings:
        resp["warnings"] = list(warnings)
    if patch is not None:
        resp["patchType"] = "JSONPatch"
        resp["patch"] = base64.b64encode(
            json.dumps(patch).encode()
        ).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": resp,
    }


class WebhookServer:
    def __init__(
        self,
        validation_handler=None,
        namespace_label_handler=None,
        mutation_handler=None,
        host: str = "127.0.0.1",
        port: int = 8443,  # 0 binds an ephemeral port (see .port)
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
        tls_min_version: str = "1.3",  # reference --webhook-tls-min-version
        batcher=None,  # Batcher to drain inside stop() (zero-loss shutdown)
        mutation_batcher=None,  # MutationBatcher, drained the same way
        reuse_port: bool = False,  # SO_REUSEPORT multi-process serving
        readiness_check=None,  # callable -> bool
        readiness_stats=None,  # callable -> dict (per-kind tracker stats)
        client_ca_file: Optional[str] = None,  # mTLS: require client certs
        metrics=None,  # MetricsRegistry for /metrics exposition
        enable_profile: bool = False,  # pprof-equivalent /debug/profile
        backlog: int = 128,  # --webhook-backlog: kernel accept queue
        cost_attribution=None,  # CostAttribution for /debug/cost
        slo_engine=None,  # SLOEngine for /debug/slo
        flight_recorder=None,  # FlightRecorder for /debug/decisions
    ):
        self.validation_handler = validation_handler
        self.namespace_label_handler = namespace_label_handler
        self.mutation_handler = mutation_handler
        self.batcher = batcher
        self.mutation_batcher = mutation_batcher
        self.readiness_check = readiness_check
        self.readiness_stats = readiness_stats
        self.metrics = metrics
        self.enable_profile = enable_profile
        # the debug surface next to /metrics: explicit instances win; None
        # falls back to the process-global actives
        self._cost_attribution = cost_attribution
        self._slo_engine = slo_engine
        self._flight_recorder = flight_recorder
        # graceful drain (resilience/overload.DrainCoordinator drives the
        # process view; this event is the server-local view): once set,
        # /healthz answers 503 {"draining": true} and every reply closes
        # its connection
        self._draining = threading.Event()
        # admissions being handled by this process and the high-water mark
        # (each --webhook-workers replica exports its own)
        self._inflight = 0
        self._inflight_highwater = 0
        self._inflight_lock = threading.Lock()
        outer = self

        def _track_inflight(delta: int) -> None:
            # always counted (the drain waits on it), exported only with
            # a metrics registry
            with outer._inflight_lock:
                outer._inflight += delta
                if outer._inflight > outer._inflight_highwater:
                    outer._inflight_highwater = outer._inflight
                cur, hi = outer._inflight, outer._inflight_highwater
            if outer.metrics is None:
                return
            from gatekeeper_tpu_torch.metrics import registry as m

            outer.metrics.set_gauge(m.WEBHOOK_INFLIGHT, cur)
            outer.metrics.set_gauge(m.WEBHOOK_INFLIGHT_HIGHWATER, hi)

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: the default 1.0 closes the connection
            # after every response (every response sets Content-Length, as
            # 1.1 persistence requires)
            protocol_version = "HTTP/1.1"
            # the stdlib writes a response as two send()s (header block,
            # body); with Nagle on, the body segment stalls on the client's
            # delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                if self.path == HEALTH_PATH:
                    if outer._draining.is_set():
                        self._reply(503, {"ready": False, "draining": True},
                                    close=True)
                        return
                    ready = (outer.readiness_check is None
                             or outer.readiness_check())
                    body = {"ready": bool(ready)}
                    if outer.readiness_stats is not None:
                        # per-kind expectation stats (ready_tracker.go:133)
                        body["readiness"] = outer.readiness_stats()
                    self._reply(200 if ready else 503, body)
                elif self.path.startswith(PROFILE_PATH) and \
                        outer.enable_profile:
                    self._profile()
                elif self.path == TRACES_PATH:
                    # the tail-sampled span ring (Tracer.snapshot)
                    tracer = tracing.active_tracer()
                    if tracer is None:
                        self._reply(404, {"error": "tracing not enabled "
                                                   "(run with --trace)"})
                    else:
                        self._reply(200, tracer.snapshot())
                elif self.path == COST_PATH:
                    from gatekeeper_tpu_torch.observability import costattr

                    attr = outer._cost_attribution or costattr.active()
                    if attr is None:
                        self._reply(404, {"error": "cost attribution not "
                                                   "enabled (run with "
                                                   "--cost-attribution on)"})
                    else:
                        self._reply(200, attr.snapshot())
                elif self.path == SLO_PATH or \
                        self.path.startswith(SLO_PATH + "?"):
                    eng = outer._slo_engine
                    if eng is None:
                        self._reply(404, {"error": "SLO engine not "
                                                   "enabled (run with "
                                                   "--slo on)"})
                    else:
                        q = parse_qs(urlparse(self.path).query)
                        cluster = (q.get("cluster") or [None])[0]
                        snap = eng.snapshot(cluster=cluster)
                        if not snap:
                            eng.tick()
                            snap = eng.snapshot(cluster=cluster)
                        self._reply(200, snap)
                elif self.path == OVERLOAD_PATH:
                    from gatekeeper_tpu_torch.resilience import overload

                    ctl = overload.active_controller()
                    if ctl is None:
                        self._reply(404, {"error": "overload limiter not "
                                                   "enabled (run with "
                                                   "--overload-limiter "
                                                   "on)"})
                    else:
                        self._reply(200, ctl.snapshot())
                elif self.path == SHADOW_PATH:
                    # the shadow canary lane: candidate-against-serving
                    # divergence counters, recent divergent rows, the
                    # promote/abort state (POST to act)
                    from gatekeeper_tpu_torch.replay import shadow as _shadow

                    lane = _shadow.active()
                    if lane is None:
                        self._reply(404, {"error": "shadow lane not "
                                                   "enabled (run with "
                                                   "--shadow-candidate)"})
                    else:
                        self._reply(200, lane.snapshot())
                elif self.path.startswith(DECISIONS_PATH):
                    # the flight recorder: every decision in the ring, or
                    # one uid's history (?uid=)
                    from gatekeeper_tpu_torch.observability import flightrec

                    rec = outer._flight_recorder or flightrec.active()
                    if rec is None:
                        self._reply(404, {"error": "flight recorder not "
                                                   "enabled (run with "
                                                   "--flight-recorder N)"})
                        return
                    q = parse_qs(urlparse(self.path).query)
                    uid = (q.get("uid") or [""])[0]
                    try:
                        limit = int((q.get("limit") or ["100"])[0])
                        # time range: unix seconds, half-open [since, until)
                        since = (q.get("since") or [None])[0]
                        until = (q.get("until") or [None])[0]
                        since = float(since) if since else None
                        until = float(until) if until else None
                    except ValueError:
                        self._reply(400, {"error": "bad limit/since/until"})
                        return
                    kinds = {k for v in (q.get("decision") or [])
                             for k in v.split(",") if k}
                    tenant = (q.get("tenant") or [None])[0]
                    cluster = (q.get("cluster") or [None])[0]
                    self._reply(200, rec.snapshot(
                        uid=uid or None, limit=limit, since=since,
                        until=until, kinds=kinds or None, tenant=tenant,
                        cluster=cluster))
                elif self.path == METRICS_PATH and outer.metrics is not None:
                    # content negotiation: OpenMetrics (exemplars + # EOF)
                    # when the scraper asks, the classic text otherwise
                    from gatekeeper_tpu_torch.metrics.registry import (
                        OPENMETRICS_CONTENT_TYPE, TEXT_CONTENT_TYPE)

                    om = "application/openmetrics-text" in (
                        self.headers.get("Accept", "") or "")
                    self._send_bytes(
                        outer.metrics.render(openmetrics=om).encode(),
                        OPENMETRICS_CONTENT_TYPE if om
                        else TEXT_CONTENT_TYPE)
                else:
                    self._reply(404, {"error": "not found"})

            def _profile(self):
                # pprof-equivalent: profile this process for ?seconds=N
                # (default 2) and return cProfile stats text
                import cProfile
                import io
                import pstats

                q = parse_qs(urlparse(self.path).query)
                secs = min(float(q.get("seconds", ["2"])[0]), 30.0)
                prof = cProfile.Profile()
                prof.enable()
                time.sleep(secs)
                prof.disable()
                buf = io.StringIO()
                pstats.Stats(prof, stream=buf).sort_stats(
                    "cumulative").print_stats(50)
                self._send_bytes(buf.getvalue().encode(), "text/plain")

            def _send_bytes(self, data: bytes, content_type: str):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                if self.headers.get("Content-Length") is None:
                    # an undrained chunked body would desync a kept-alive
                    # connection: require a length (411) AND close
                    self._reply(411, {"error": "Content-Length required"},
                                close=True)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._reply(400, {"error": "bad Content-Length"},
                                close=True)
                    return
                if length < 0 or length > MAX_BODY_BYTES:
                    # negative would make rfile.read block until client EOF
                    self._reply(400 if length < 0 else 413,
                                {"error": "bad Content-Length"}, close=True)
                    return
                raw = self.rfile.read(length) if length else b""
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    # the declared length may have lied: don't trust the
                    # stream position for another request
                    self._reply(400, {"error": "invalid JSON body"},
                                close=True)
                    return
                if not isinstance(body, dict):
                    self._reply(400, {"error": "body is not an object"},
                                close=True)
                    return
                uid = ((body.get("request") or {}).get("uid", "")) or ""
                _track_inflight(+1)
                # W3C trace-context ingest: a traceparent header parents
                # the request span into the caller's trace; absent or
                # malformed starts a fresh trace
                remote = tracing.parse_traceparent(
                    self.headers.get(tracing.TRACEPARENT_HEADER))
                try:
                    with tracing.span("webhook.request", parent=remote,
                                      path=self.path, uid=uid):
                        from gatekeeper_tpu_torch.resilience.faults import \
                            fault_point

                        fault_point("webhook.request", path=self.path)
                        if self.path == ADMIT_PATH:
                            # the body's wire size is the cheap half of the
                            # overload cost estimate (object bytes x
                            # matched constraints)
                            self._admit(body, uid, cost_hint=length)
                        elif self.path == MUTATE_PATH:
                            self._mutate(body, uid, cost_hint=length)
                        elif self.path == ADMIT_LABEL_PATH:
                            self._admit_label(body, uid)
                        elif self.path == SHADOW_PATH:
                            self._shadow_action(body)
                        else:
                            self._reply(404, {"error": "not found"})
                except Exception as e:
                    # handler bug: admission.Errored equivalent — a
                    # well-formed allowed=false code-500 response
                    self._reply(200, admission_response(
                        uid, False, message=f"webhook error: {e}", code=500))
                finally:
                    _track_inflight(-1)

            def _admit(self, body, uid, cost_hint=0):
                h = outer.validation_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                v = (h.handle(body, cost_hint=cost_hint)
                     if _accepts_cost_hint(h) else h.handle(body))
                self._reply(200, admission_response(
                    v.uid or uid, v.allowed, v.message, v.code, v.warnings),
                    headers=_retry_after(v))

            def _mutate(self, body, uid, cost_hint=0):
                h = outer.mutation_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                # the batched handler takes the wire size as the overload
                # cost hint; the per-object handler does not
                m = (h.handle(body, cost_hint=cost_hint)
                     if _accepts_cost_hint(h) else h.handle(body))
                self._reply(200, admission_response(
                    m.uid or uid, m.allowed, m.message,
                    getattr(m, "code", 200),
                    warnings=getattr(m, "warnings", None), patch=m.patch),
                    headers=_retry_after(m))

            def _admit_label(self, body, uid):
                h = outer.namespace_label_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                r = h.handle(body)
                self._reply(200, admission_response(
                    r.uid or uid, r.allowed, r.message, r.code))

            def _shadow_action(self, body):
                # POST /debug/shadow {"action": "promote"|"abort"}: promote
                # applies the candidate docs to the serving client (the
                # generation-swap ride); abort stops shadowing
                from gatekeeper_tpu_torch.replay import shadow as _shadow

                lane = _shadow.active()
                if lane is None:
                    self._reply(404, {"error": "shadow lane not enabled "
                                               "(run with "
                                               "--shadow-candidate)"})
                    return
                action = (body or {}).get("action", "")
                if action == "promote":
                    self._reply(200, lane.promote())
                elif action == "abort":
                    self._reply(200, lane.abort(
                        reason=(body or {}).get("reason", "")))
                else:
                    self._reply(400, {"error": "action must be "
                                               "promote|abort"})

            def _reply(self, status: int, payload: dict,
                       close: bool = False, headers: Optional[dict] = None):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                # traceparent emit: callers correlate their timeline with
                # the server-side request span
                tp = tracing.format_traceparent()
                if tp is not None:
                    tracing.set_attribute("http.status", status)
                    self.send_header(tracing.TRACEPARENT_HEADER, tp)
                if close or outer._draining.is_set():
                    # also sets close_connection: the socket drops after
                    # this response
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)

        class _Server(ThreadingHTTPServer):
            # the socketserver default backlog of 5 resets bursts of
            # concurrent connects (the apiserver opens many at once)
            request_queue_size = backlog

            def server_bind(self):
                if reuse_port:
                    # N worker processes bind the same port and the kernel
                    # load-balances connections across them
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

        self._server = _Server((host, port), Handler)
        self._certfile, self._keyfile = certfile, keyfile
        self._ssl_ctx = None
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            ctx.minimum_version = {
                "1.2": ssl.TLSVersion.TLSv1_2,
                "1.3": ssl.TLSVersion.TLSv1_3,
            }.get(tls_min_version, ssl.TLSVersion.TLSv1_3)
            if client_ca_file:
                # reference --client-ca-name: verify the apiserver's client
                # certificate against this CA
                ctx.load_verify_locations(client_ca_file)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._ssl_ctx = ctx
            self._server.socket = ctx.wrap_socket(self._server.socket,
                                                  server_side=True)
        self._thread: Optional[threading.Thread] = None

    def reload_certs(self):
        """Hot-reload the certificate chain (rotation loop); new
        connections pick up the refreshed chain."""
        if self._ssl_ctx is not None and self._certfile:
            self._ssl_ctx.load_cert_chain(self._certfile, self._keyfile)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "WebhookServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="webhook-server")
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """/healthz answers 503 {"draining": true} and replies close their
        connections; the listener keeps accepting until :meth:`stop`."""
        self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def stop(self, drain_timeout: float = 5.0) -> bool:
        """Zero-loss shutdown: stop accepting, then drain in-flight
        handlers AND both batcher queues (validating and mutating) within
        ``drain_timeout`` before closing.  Returns True when the drain
        completed inside the budget."""
        t0 = time.perf_counter()
        self.begin_drain()
        batchers = [b for b in (self.batcher, self.mutation_batcher)
                    if b is not None]
        with tracing.span("server.drain"):
            self._server.shutdown()  # listener stops accepting
            deadline = t0 + max(0.0, drain_timeout)
            while time.perf_counter() < deadline:
                if self.inflight() == 0 and all(
                        b.queue_depth() == 0 for b in batchers):
                    break
                time.sleep(0.005)
            drained = self.inflight() == 0
            for b in batchers:
                # nothing new can arrive: drain whatever is still queued
                # (abandoned deadline-missed entries included)
                b.stop(timeout=max(0.1, deadline - time.perf_counter()))
                drained = drained and b.queue_depth() == 0
            self._server.server_close()
            tracing.set_attribute("drained", drained)
            tracing.set_attribute("inflight_at_close", self.inflight())
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as m

            self.metrics.set_gauge(m.DRAIN_SECONDS, time.perf_counter() - t0)
        if self._thread:
            self._thread.join(timeout=2)
        return drained


def _accepts_cost_hint(handler) -> bool:
    """Whether ``handler.handle`` takes the ``cost_hint`` keyword (the
    overload-gated handlers do; plain handlers do not).  Read once from
    its signature and cached on the handler."""
    accepts = getattr(handler, "_accepts_cost_hint", None)
    if accepts is None:
        import inspect

        accepts = "cost_hint" in inspect.signature(
            handler.handle).parameters
        try:
            handler._accepts_cost_hint = accepts
        except AttributeError:
            pass
    return accepts


def _retry_after(resp) -> Optional[dict]:
    """The HTTP ``Retry-After`` header of a shed answer under
    failurePolicy=Fail (the AdmissionReview carries code 429)."""
    retry_after = getattr(resp, "retry_after_s", 0.0)
    if not retry_after:
        return None
    return {"Retry-After": str(max(1, int(retry_after + 0.999)))}
