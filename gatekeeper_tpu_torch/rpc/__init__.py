"""The seam between the control plane and the device-owning sidecar.

``evaluate.proto`` is the wire contract (service ``gatekeeper.tpu.v1.
Evaluate``); ``evaluate_pb2.py`` is its codec, written by hand against it,
so neither this package nor its client needs ``google.protobuf`` or
``grpc`` to import.  ``sidecar.py`` serves the contract over gRPC (``grpc``
is imported where a server starts) and over an in-process loopback that
carries the same request and response bytes."""

from __future__ import annotations

SERVICE = "gatekeeper.tpu.v1.Evaluate"
MAX_MESSAGE_BYTES = 256 * 1024 * 1024  # gRPC send and receive limits


def load_pb2():
    """The codec module (there is no generated file to refresh)."""
    from gatekeeper_tpu_torch.rpc import evaluate_pb2

    return evaluate_pb2
