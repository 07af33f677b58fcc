"""Admission webhook HTTP server.

Port of ``gatekeeper_tpu/webhook/server.py``: a threaded stdlib HTTP
server speaking the AdmissionReview v1 protocol on ``/v1/admit`` (the
validating handler, webhook/policy.py), ``/v1/mutate`` (the mutating
handler, webhook/mutation.py or the batched mutlane/webhook.py; its answer
carries a base64 JSONPatch) and ``/v1/admitlabel`` (the namespace-label
guard, webhook/namespacelabel.py), with ``/healthz`` for readiness.  TLS
is optional (``certfile``/``keyfile``).  ``reuse_port`` binds with
``SO_REUSEPORT``, so the replicas of ``--webhook-workers`` share one port
and the kernel spreads connections over them.

Not ported yet: ``/metrics`` and the ``/debug/*`` surface (they answer
404), tracing, mTLS and cert rotation.
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

ADMIT_PATH = "/v1/admit"
MUTATE_PATH = "/v1/mutate"
ADMIT_LABEL_PATH = "/v1/admitlabel"
HEALTH_PATH = "/healthz"
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
    ):
        self.validation_handler = validation_handler
        self.namespace_label_handler = namespace_label_handler
        self.mutation_handler = mutation_handler
        self.batcher = batcher
        self.mutation_batcher = mutation_batcher
        # graceful drain: once set, /healthz answers 503 {"draining": true}
        # and every reply closes its connection
        self._draining = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        outer = self

        def _track_inflight(delta: int) -> None:
            with outer._inflight_lock:
                outer._inflight += delta

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
                    else:
                        self._reply(200, {"ready": True})
                else:
                    self._reply(404, {"error": "not found"})

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
                try:
                    if self.path == ADMIT_PATH:
                        self._admit(body, uid)
                    elif self.path == MUTATE_PATH:
                        self._mutate(body, uid)
                    elif self.path == ADMIT_LABEL_PATH:
                        self._admit_label(body, uid)
                    else:
                        self._reply(404, {"error": "not found"})
                except Exception as e:
                    # handler bug: admission.Errored equivalent — a
                    # well-formed allowed=false code-500 response
                    self._reply(200, admission_response(
                        uid, False, message=f"webhook error: {e}", code=500))
                finally:
                    _track_inflight(-1)

            def _admit(self, body, uid):
                h = outer.validation_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                v = h.handle(body)
                self._reply(200, admission_response(
                    v.uid or uid, v.allowed, v.message, v.code, v.warnings))

            def _mutate(self, body, uid):
                h = outer.mutation_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                m = h.handle(body)
                self._reply(200, admission_response(
                    m.uid or uid, m.allowed, m.message, m.code,
                    warnings=m.warnings, patch=m.patch))

            def _admit_label(self, body, uid):
                h = outer.namespace_label_handler
                if h is None:
                    self._reply(200, admission_response(uid, True))
                    return
                r = h.handle(body)
                self._reply(200, admission_response(
                    r.uid or uid, r.allowed, r.message, r.code))

            def _reply(self, status: int, payload: dict,
                       close: bool = False):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if close or outer._draining.is_set():
                    # also sets close_connection: the socket drops after
                    # this response
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)

        class _Server(ThreadingHTTPServer):
            # the socketserver default backlog of 5 resets bursts of
            # concurrent connects (the apiserver opens many at once)
            request_queue_size = 128

            def server_bind(self):
                if reuse_port:
                    # N worker processes bind the same port and the kernel
                    # load-balances connections across them
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

        self._server = _Server((host, port), Handler)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            ctx.minimum_version = {
                "1.2": ssl.TLSVersion.TLSv1_2,
                "1.3": ssl.TLSVersion.TLSv1_3,
            }.get(tls_min_version, ssl.TLSVersion.TLSv1_3)
            self._server.socket = ctx.wrap_socket(self._server.socket,
                                                  server_side=True)
        self._thread: Optional[threading.Thread] = None

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
            b.stop(timeout=max(0.1, deadline - time.perf_counter()))
            drained = drained and b.queue_depth() == 0
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=2)
        return drained
