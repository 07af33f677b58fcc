"""Client side of the Evaluate sidecar seam.

``RemoteDriver`` implements the Driver protocol by replicating template/
constraint/data lifecycle into the sidecar (Reconcile) and evaluating via
QueryBatch: the control-plane process never touches the accelerator.
``RemoteEvaluator`` is the audit chunk lane: one Sweep RPC per chunk,
returning rendered kept violations + totals (the whole audit middle runs
in the sidecar; ref shape pkg/audit/manager.go:668-774 collapsed into one
call).

Both ride a transport, ``(method, request_bytes, timeout) ->
Future[response bytes]``: a gRPC channel to ``address`` (``grpc`` is
imported only then), or ``rpc.sidecar.Loopback(servicer)`` in process.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.apis.constraints import Constraint
from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate
from gatekeeper_tpu_torch.client.types import QueryResponse, Result
from gatekeeper_tpu_torch.drivers.base import ReviewCfg
from gatekeeper_tpu_torch.rpc import MAX_MESSAGE_BYTES, SERVICE, load_pb2
from gatekeeper_tpu_torch.target.review import GkReview

pb = load_pb2()

DRIVER_NAME = "Torch-remote"


class RemoteError(Exception):
    pass


class _GrpcTransport:
    """Request bytes to a gRPC channel's unary methods of the service
    (bytes in and out: the codec runs in ``_Stub``)."""

    def __init__(self, channel):
        self._calls = {
            method: channel.unary_unary(f"/{SERVICE}/{method}")
            for method in ("Reconcile", "QueryBatch", "Sweep", "Status")}

    def __call__(self, method: str, request: bytes, timeout=None):
        return self._calls[method].future(request, timeout=timeout)


class _Reply:
    """A call in flight: ``done()`` without waiting, ``result()`` the
    decoded response."""

    __slots__ = ("_future", "_resp_cls", "_timeout")

    def __init__(self, future, resp_cls, timeout):
        self._future = future
        self._resp_cls = resp_cls
        self._timeout = timeout

    def done(self) -> bool:
        return self._future.done()

    def result(self):
        return self._resp_cls.FromString(
            self._future.result(timeout=self._timeout))


class _Unary:
    def __init__(self, transport, method: str, resp_cls):
        self._transport = transport
        self._method = method
        self._resp_cls = resp_cls

    def future(self, request, timeout=None) -> _Reply:
        return _Reply(self._transport(self._method,
                                      request.SerializeToString(), timeout),
                      self._resp_cls, timeout)

    def __call__(self, request, timeout=None):
        return self.future(request, timeout).result()


class _Stub:
    """The service's unary stubs over a transport."""

    def __init__(self, transport):
        self.reconcile = _Unary(transport, "Reconcile", pb.ReconcileResponse)
        self.query_batch = _Unary(transport, "QueryBatch",
                                  pb.QueryBatchResponse)
        self.sweep = _Unary(transport, "Sweep", pb.SweepResponse)
        self.status = _Unary(transport, "Status", pb.StatusResponse)


def _review_to_pb(review: GkReview) -> "pb.Review":
    req = review.request
    doc = {
        "uid": req.uid, "kind": req.kind, "resource": req.resource,
        "subResource": req.sub_resource, "name": req.name,
        "namespace": req.namespace, "operation": req.operation,
        "userInfo": req.user_info, "object": req.object,
        "oldObject": req.old_object, "dryRun": req.dry_run,
        "options": req.options,
    }
    out = pb.Review(admission_request_json=json.dumps(doc).encode(),
                    source=getattr(review, "source", "") or "",
                    is_admission=bool(getattr(review, "is_admission",
                                              False)))
    if review.namespace:  # the Namespace OBJECT (GkReview.namespace)
        out.namespace_json = json.dumps(review.namespace).encode()
    return out


def _results_from_pb(rr, target: str) -> list:
    out = []
    for r in rr.results:
        metadata = {}
        if r.details_json:
            metadata["details"] = json.loads(r.details_json)
        out.append(Result(
            target=target,
            msg=r.msg,
            constraint=json.loads(r.constraint_json or b"{}"),
            metadata=metadata,
        ))
    return out


class RemoteDriver:
    """Driver protocol over the Evaluate sidecar at ``address`` (gRPC), or
    over ``transport`` (e.g. ``rpc.sidecar.Loopback(servicer)``)."""

    def __init__(self, address: str = "", timeout_s: float = 120.0,
                 transport=None):
        self.address = address
        self.timeout_s = timeout_s
        self._channel = None
        if transport is None:
            import grpc

            self._channel = grpc.insecure_channel(
                address,
                options=[("grpc.max_receive_message_length",
                          MAX_MESSAGE_BYTES),
                         ("grpc.max_send_message_length",
                          MAX_MESSAGE_BYTES)],
            )
            transport = _GrpcTransport(self._channel)
        self._transport = transport
        self._stub = _Stub(transport)

    def name(self) -> str:
        return DRIVER_NAME

    # --- lifecycle (replicated to the sidecar) ------------------------
    def has_source_for(self, template: ConstraintTemplate) -> bool:
        # static source check: rego or K8sNativeValidation (mirrors the
        # sidecar's TorchDriver+CELDriver acceptance without compiling)
        from gatekeeper_tpu_torch.apis.templates import ENGINE_REGO
        from gatekeeper_tpu_torch.drivers.cel_driver import parse_source

        if template.targets[0].source_for(ENGINE_REGO) is not None:
            return True
        return parse_source(template) is not None

    def _reconcile(self, **kwargs) -> "pb.ReconcileResponse":
        resp = self._stub.reconcile(pb.ReconcileRequest(**kwargs),
                                    timeout=self.timeout_s)
        if resp.error:
            raise RemoteError(resp.error)
        return resp

    def add_template(self, template: ConstraintTemplate) -> None:
        self._reconcile(verb="add_template",
                        object_json=json.dumps(template.raw).encode())

    def remove_template(self, template_kind: str) -> None:
        self._reconcile(verb="remove_template", kind=template_kind)

    def add_constraint(self, constraint: Constraint) -> None:
        self._reconcile(verb="add_constraint",
                        object_json=json.dumps(constraint.raw).encode())

    def remove_constraint(self, constraint: Constraint) -> None:
        self._reconcile(verb="remove_constraint",
                        object_json=json.dumps(constraint.raw).encode())

    def add_data(self, target: str, path: Sequence[str],
                 data: Any) -> None:
        self._reconcile(verb="add_data", path=list(path),
                        object_json=json.dumps(data).encode())

    def remove_data(self, target: str, path: Sequence[str]) -> None:
        self._reconcile(verb="remove_data", path=list(path))

    def wipe_data(self) -> None:
        self._reconcile(verb="wipe_data")

    # --- evaluation ---------------------------------------------------
    def query(self, target, constraints, review, cfg=None) -> QueryResponse:
        responses = self.query_batch(target, constraints, [review], cfg)
        return responses[0]

    def query_batch(self, target: str, constraints, reviews,
                    cfg: Optional[ReviewCfg] = None,
                    render_messages: bool = True) -> list:
        cfg = cfg or ReviewCfg()
        req = pb.QueryBatchRequest(
            enforcement_point=cfg.enforcement_point or "",
            render_messages=render_messages,
        )
        # restrict evaluation to the caller's constraint slice server-side
        # (per-request device work must not scale with the full set)
        req.constraint_keys.extend(
            f"{c.kind}/{c.name}" for c in constraints)
        req.reviews.extend(_review_to_pb(r) for r in reviews)
        resp = self._stub.query_batch(req, timeout=self.timeout_s)
        if resp.error:
            raise RemoteError(resp.error)
        want = {(c.kind, c.name) for c in constraints}
        out = []
        for rr in resp.responses:
            qr = QueryResponse()
            for r in _results_from_pb(rr, target):
                ckind = r.constraint.get("kind", "")
                cname = (r.constraint.get("metadata") or {}).get("name", "")
                # the sidecar evaluates its full constraint set; filter to
                # the caller's slice (Driver.Query contract)
                if (ckind, cname) in want:
                    qr.results.append(r)
            out.append(qr)
        return out

    def _status(self) -> "pb.StatusResponse":
        return self._stub.status(pb.StatusRequest(), timeout=self.timeout_s)

    def lowered_kinds(self) -> list:
        return list(self._status().lowered)

    def fallback_kinds(self) -> dict:
        return dict(self._status().fallback)

    def dump(self) -> dict:
        status = self._status()
        return {
            "lowered": list(status.lowered),
            "fallback": dict(status.fallback),
            "sidecar": {"devices": status.n_devices,
                        "platform": status.platform},
        }

    def get_description_for_stat(self, stat_name: str) -> str:
        return ""

    def close(self):
        if self._channel is not None:
            self._channel.close()


class RemoteEvaluator:
    """Audit chunk lane over the sidecar: ``sweep_submit`` sends the RPC
    and returns at once (the host lists and serializes the next chunk
    meanwhile); ``sweep_collect`` waits for it.

    ``renders = True``: responses carry rendered kept violations +
    totals, so the AuditManager folds them directly instead of rendering
    host-side."""

    renders = True

    def __init__(self, driver: RemoteDriver, violations_limit: int = 20,
                 exact_totals: bool = False):
        self.driver = driver
        self.violations_limit = violations_limit
        self.exact_totals = exact_totals

    def sweep_submit(self, constraints, objects, return_bits=False):
        req = pb.SweepRequest(
            violations_limit=self.violations_limit,
            exact_totals=return_bits or self.exact_totals,
        )
        # restrict the sweep to the caller's constraint slice (the audit
        # passes only audit-actionable constraints)
        req.constraint_keys.extend(
            f"{c.kind}/{c.name}" for c in constraints)
        req.object_json.extend(
            json.dumps(o).encode() for o in objects)
        return self.driver._stub.sweep.future(
            req, timeout=self.driver.timeout_s)

    def sweep_collect(self, pending):
        if pending is None or isinstance(pending, dict):
            return pending or {}
        resp = pending.result()
        if resp.error:
            raise RemoteError(resp.error)
        out = {}
        for cs in resp.constraints:
            kept = [
                (kv.object_index, kv.msg,
                 json.loads(kv.details_json) if kv.details_json else None)
                for kv in cs.kept
            ]
            out[(cs.kind, cs.name)] = (int(cs.total), kept)
        return out

    def sweep(self, constraints, objects, return_bits=False):
        return self.sweep_collect(
            self.sweep_submit(constraints, objects, return_bits))
