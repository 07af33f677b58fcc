"""The device-owning Evaluate sidecar.

The deployment shape of SURVEY.md §7: the control plane (webhook serving,
reconcile controllers, status writeback) runs in one process with no
accelerator; THIS process owns the card (a ``TorchDriver`` with its
``CELDriver`` and a ``SweepEvaluator``) and exposes only the Driver.Query
seam (ref seam: pkg/drivers/k8scel/driver.go:162 behind the framework
client).  One method table feeds two transports: gRPC (``serve``, where
``grpc`` is imported) and ``Loopback``, an in-process transport that hands
request bytes to the same handlers and returns response bytes, for hosts
without ``grpc``.

Run:  python -m gatekeeper_tpu_torch.rpc.sidecar --port 9090 [--device cpu]
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Optional

from gatekeeper_tpu_torch.rpc import MAX_MESSAGE_BYTES, SERVICE, load_pb2

pb = load_pb2()

# the loopback transport's thread pool, the size of ``serve``'s default one
LOOPBACK_WORKERS = 8


def _review_from_pb(target, rv) -> object:
    from gatekeeper_tpu_torch.target.review import (AdmissionRequest,
                                                    AugmentedReview)

    doc = json.loads(rv.admission_request_json or b"{}")
    req = AdmissionRequest(
        uid=doc.get("uid", ""),
        kind=doc.get("kind") or {},
        resource=doc.get("resource") or {},
        sub_resource=doc.get("subResource", ""),
        name=doc.get("name", ""),
        namespace=doc.get("namespace", ""),
        operation=doc.get("operation", ""),
        user_info=doc.get("userInfo") or {},
        object=doc.get("object"),
        old_object=doc.get("oldObject"),
        dry_run=bool(doc.get("dryRun", False)),
        options=doc.get("options"),
    )
    ns = json.loads(rv.namespace_json) if rv.namespace_json else None
    aug = AugmentedReview(admission_request=req, namespace=ns,
                          source=rv.source or "Original",
                          is_admission=rv.is_admission)
    return target.handle_review(aug)


class EvaluateServicer:
    """State + request handlers; one instance owns the device.  ``device``
    is ``"cuda"`` unless the caller asks for ``"cpu"``; without a card
    ``"cuda"`` raises."""

    def __init__(self, violations_limit: int = 20, device: str = "cuda"):
        from gatekeeper_tpu_torch import resolve_device
        from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
        from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
        from gatekeeper_tpu_torch.parallel.mesh import make_mesh
        from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
        from gatekeeper_tpu_torch.target.target import K8sValidationTarget

        self.device = resolve_device(device)
        self.cel = CELDriver()
        self.driver = TorchDriver(device=device, cel_driver=self.cel)
        self.target = K8sValidationTarget()
        self.evaluator = SweepEvaluator(self.driver, device=device,
                                        violations_limit=violations_limit,
                                        mesh=make_mesh(device=device))
        self._constraints: dict = {}  # (kind, name) -> Constraint
        # one reentrant lock serializes ALL state-touching RPCs: the
        # driver/evaluator internals (vocab interning, program caches,
        # device tables) are not thread-safe, and the audit schedule keeps
        # more than one Sweep in flight
        self._lock = threading.RLock()

    # --- Reconcile ----------------------------------------------------
    def reconcile(self, req: "pb.ReconcileRequest", ctx):
        from gatekeeper_tpu_torch.apis.constraints import Constraint
        from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate

        resp = pb.ReconcileResponse()
        try:
            with self._lock:
                if req.verb == "add_template":
                    t = ConstraintTemplate.from_unstructured(
                        json.loads(req.object_json))
                    self.driver.add_template(t)
                elif req.verb == "remove_template":
                    self.driver.remove_template(req.kind)
                    for key in [k for k in self._constraints
                                if k[0] == req.kind]:
                        self._constraints.pop(key, None)
                elif req.verb == "add_constraint":
                    con = Constraint.from_unstructured(
                        json.loads(req.object_json))
                    self.driver.add_constraint(con)
                    self._constraints[(con.kind, con.name)] = con
                elif req.verb == "remove_constraint":
                    con = Constraint.from_unstructured(
                        json.loads(req.object_json))
                    self.driver.remove_constraint(con)
                    self._constraints.pop((con.kind, con.name), None)
                elif req.verb == "add_data":
                    self.driver.add_data(self.target.name, list(req.path),
                                         json.loads(req.object_json))
                elif req.verb == "remove_data":
                    self.driver.remove_data(self.target.name,
                                            list(req.path))
                elif req.verb == "wipe_data":
                    self.driver.wipe_data()
                else:
                    resp.error = f"unknown verb {req.verb!r}"
        except Exception as e:
            resp.error = str(e)
        resp.lowered.extend(self.driver.lowered_kinds())
        return resp

    # --- QueryBatch (admission lane) ----------------------------------
    def query_batch(self, req: "pb.QueryBatchRequest", ctx):
        from gatekeeper_tpu_torch.drivers.base import ReviewCfg

        resp = pb.QueryBatchResponse()
        try:
            reviews = [_review_from_pb(self.target, rv)
                       for rv in req.reviews]
            with self._lock:
                cons = list(self._constraints.values())
                if req.constraint_keys:
                    want = set(req.constraint_keys)
                    cons = [c for c in cons
                            if f"{c.kind}/{c.name}" in want]
                results = self.driver.query_batch(
                    self.target.name, cons, reviews,
                    ReviewCfg(enforcement_point=req.enforcement_point
                              or "webhook.gatekeeper.sh"),
                    render_messages=req.render_messages,
                )
            for qr in results:
                rr = resp.responses.add()
                for r in qr.results:
                    out = rr.results.add()
                    out.constraint_json = json.dumps(
                        r.constraint).encode()
                    out.msg = r.msg
                    details = (r.metadata or {}).get("details")
                    if details is not None:
                        out.details_json = json.dumps(details).encode()
        except Exception as e:
            resp.error = str(e)
        return resp

    # --- Sweep (audit chunk lane) -------------------------------------
    def sweep(self, req: "pb.SweepRequest", ctx):
        from gatekeeper_tpu_torch.audit.manager import AuditManager
        from gatekeeper_tpu_torch.drivers.base import ReviewCfg
        from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
        from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
        from gatekeeper_tpu_torch.utils.rawjson import RawJSON

        resp = pb.SweepResponse()
        try:
            # the wire bytes ARE the flatten input: RawJSON defers dict
            # materialization to slow paths and rendering, and the native
            # columnizer parses the bytes with the GIL released
            objects = [RawJSON(bytes(b)) for b in req.object_json]
            limit = req.violations_limit or 20
            ep = req.enforcement_point or "audit.gatekeeper.sh"
            cfg = ReviewCfg(enforcement_point=ep)
            # split lock: flatten + submit hold it (vocab and parameter
            # tables and the constraint snapshot are not thread-safe), the
            # device wait (sweep_collect) runs outside it, so a second
            # Sweep RPC flattens chunk N+1 while chunk N evaluates
            with self._lock:
                cons = list(self._constraints.values())
                if req.constraint_keys:
                    want = set(req.constraint_keys)
                    cons = [c for c in cons
                            if f"{c.kind}/{c.name}" in want]
                # honor the CALLER's top-k capacity (config drift between
                # control plane and sidecar must not truncate silently)
                self.evaluator.violations_limit = limit
                pending = self.evaluator.sweep_submit(
                    cons, objects, return_bits=req.exact_totals)
            swept = self.evaluator.sweep_collect(pending)
            with self._lock:
                # the template/constraint set may have changed while the
                # device wait ran unlocked: a concurrently-removed kind's
                # hits are dropped (the reference audit likewise reviews
                # against the then-current set), never allowed to error
                # the whole chunk
                live_kinds = {c.kind for c in self._constraints.values()}
                swept = {kind: hits for kind, hits in swept.items()
                         if kind in live_kinds}
                review_cache: dict = {}

                def review_of(oi):
                    r = review_cache.get(oi)
                    if r is None:
                        r = self.target.handle_review(
                            AugmentedUnstructured(
                                object=objects[oi],
                                source=SOURCE_ORIGINAL))
                        review_cache[oi] = r
                    return r

                def render(con, oi):
                    try:
                        return self.driver.render_query(
                            self.target.name, con, review_of(oi),
                            cfg).results
                    except Exception:
                        # template torn down between the liveness
                        # snapshot and this render: drop the hit
                        return []

                handled = set(swept)
                for con, total, kept_list in AuditManager.fold_swept(
                        swept, len(objects), render, limit,
                        req.exact_totals):
                    cs = resp.constraints.add()
                    cs.kind, cs.name = con.kind, con.name
                    cs.total = total
                    for oi, msg, details in kept_list:
                        kv = cs.kept.add()
                        kv.object_index = oi
                        kv.msg = msg
                        if details is not None:
                            kv.details_json = json.dumps(details).encode()
                # constraints the device sweep did not cover (non-lowered
                # or inventory-inexact kinds): exact engines per pair,
                # restricted to constraints still registered (the rest
                # lane must not query a concurrently-removed template)
                live = {(c.kind, c.name) for c in
                        self._constraints.values()}
                rest = [c for c in cons if c.kind not in handled
                        and (c.kind, c.name) in live]
                if not rest:
                    return resp
                by_con: dict = {}
                reviews = [review_of(oi) for oi in range(len(objects))]
                responses = self.driver.query_batch(
                    self.target.name, rest, reviews, cfg)
                for oi, qr in enumerate(responses):
                    for r in qr.results:
                        ckey = (r.constraint.get("kind", ""),
                                (r.constraint.get("metadata") or {})
                                .get("name", ""))
                        by_con.setdefault(ckey, []).append((oi, r))
                for con in rest:
                    cs = resp.constraints.add()
                    cs.kind, cs.name = con.kind, con.name
                    hits = by_con.get((con.kind, con.name), [])
                    cs.total = len(hits)
                    for oi, r in hits[:limit]:
                        kv = cs.kept.add()
                        kv.object_index = oi
                        kv.msg = r.msg
                        d = (r.metadata or {}).get("details")
                        if d is not None:
                            kv.details_json = json.dumps(d).encode()
        except Exception as e:
            resp.error = str(e)
        return resp

    # --- Status -------------------------------------------------------
    def status(self, req: "pb.StatusRequest", ctx):
        import torch

        resp = pb.StatusResponse()
        resp.lowered.extend(self.driver.lowered_kinds())
        for k, v in self.driver.fallback_kinds().items():
            resp.fallback[k] = v
        if self.device.type == "cuda":
            resp.platform = "gpu"
            resp.n_devices = torch.cuda.device_count()
        else:
            resp.platform = "cpu"
            resp.n_devices = 1
        with self._lock:
            resp.n_constraints = len(self._constraints)
        resp.n_templates = len(self.driver.lowered_kinds()) + len(
            self.driver.fallback_kinds())
        return resp


def _methods(servicer) -> dict:
    """The service's method table: name -> (handler, request class,
    response class)."""
    return {
        "Reconcile": (servicer.reconcile, pb.ReconcileRequest,
                      pb.ReconcileResponse),
        "QueryBatch": (servicer.query_batch, pb.QueryBatchRequest,
                       pb.QueryBatchResponse),
        "Sweep": (servicer.sweep, pb.SweepRequest, pb.SweepResponse),
        "Status": (servicer.status, pb.StatusRequest, pb.StatusResponse),
    }


def _handler(servicer):
    """The grpc generic handler over :func:`_methods`."""
    import grpc

    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString)
        for name, (fn, req_cls, resp_cls) in _methods(servicer).items()
    }
    return grpc.method_handlers_generic_handler(SERVICE, handlers)


class Loopback:
    """An in-process transport to ``servicer``: ``(method, request_bytes,
    timeout) -> Future[response bytes]``.  Each call deserializes the
    request and serializes the response with the codec, as a gRPC server
    does, on a pool of ``LOOPBACK_WORKERS`` threads (``serve``'s default
    pool); the caller waits at most ``timeout`` at the future's
    ``result``."""

    def __init__(self, servicer):
        self._methods = _methods(servicer)
        self._pool = futures.ThreadPoolExecutor(
            max_workers=LOOPBACK_WORKERS,
            thread_name_prefix="evaluate-loopback")

    def __call__(self, method: str, request: bytes, timeout=None):
        if method not in self._methods:
            raise ValueError(f"method {method!r} is not in service "
                             f"{SERVICE}")
        return self._pool.submit(self._call, method, request)

    def _call(self, method: str, request: bytes) -> bytes:
        fn, req_cls, _resp_cls = self._methods[method]
        return fn(req_cls.FromString(request), None).SerializeToString()

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def serve(port: int = 9090, violations_limit: int = 20,
          max_workers: int = 8, device: str = "cuda") -> tuple:
    """Start the sidecar's gRPC server on 127.0.0.1:``port`` (0: any free
    port); returns (grpc.Server, bound port, servicer)."""
    import grpc

    servicer = EvaluateServicer(violations_limit=violations_limit,
                                device=device)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                 ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)],
    )
    server.add_generic_rpc_handlers((_handler(servicer),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind 127.0.0.1:{port}")
    server.start()
    return server, bound, servicer


def main(argv: Optional[list] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="gatekeeper-tpu-torch-sidecar")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument("--violations-limit", type=int, default=20)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the sidecar evaluates: the card (default; "
                        "raises without one) or the CPU")
    args = p.parse_args(argv)
    server, bound, servicer = serve(args.port, args.violations_limit,
                                    device=args.device)
    print(f"evaluate sidecar serving on 127.0.0.1:{bound} "
          f"(device: {servicer.device})", file=sys.stderr, flush=True)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=2)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
