"""Multi-process wiring for the evaluation plane.

Port of ``gatekeeper_tpu/parallel/distributed.py``.  The JAX package boots
a multi-controller JAX runtime (one process per host, one global device
mesh, XLA's collectives on the interconnect); here each process is one
``torch.distributed`` rank of a gloo process group.  After
:func:`init_distributed` returns, ``parallel/mesh.make_mesh()`` spans every
rank: each rank contributes ``local_device_count`` shards (default 1, on
its own card, ``cuda:{process_id % torch.cuda.device_count()}``), and a
sweep chunk's object axis splits over the global shard list.

Every process feeds the same full batch, as every JAX process does: each
rank lists and flattens the whole chunk (so vocab ids agree on every
rank), uploads and evaluates only its own shards' rows, folds them with
the hand-written kernels, and the per-shard results meet in ONE
``all_gather_object`` per collected chunk (:func:`gather_shards`), in
chunk order, from the collecting thread.  Every rank then merges the same
shard list and renders the same kept violations.

The gather runs over gloo, not NCCL: the payload (a few KB per chunk on
the reduced lane, ``C x N/8`` bytes on the masks lane) is already in host
memory when it is gathered, and two ranks on one card cannot share an
NCCL communicator ("duplicate GPU").

``local_device_count`` plays the part of JAX's virtual CPU devices
(``--xla_force_host_platform_device_count``): it is the CPU test shape and
the one-card shape of two ranks.  The ``GATEKEEPER_LOCAL_DEVICE_COUNT``
environment variable gives it to a process started by the CLI, as
``XLA_FLAGS`` does for the JAX CLI; ``GATEKEEPER_DIST_TIMEOUT_S`` bounds
every rendezvous and collective (default 300 s), so a dead peer ends in an
error, never a hang.  A failed or mismatched gather (each payload carries
its chunk's tag, which must be the same on every rank: a retry on one rank
alone would pair different chunks) breaks the mesh for good: every later
gather raises :class:`MeshError` at once, so a pass drops its remaining
chunks without waiting, and ``python -m gatekeeper_tpu_torch --once`` exits
1 (``broken()``).
"""

from __future__ import annotations

import atexit
import datetime
import os
import time
from typing import Optional

LOCAL_COUNT_ENV = "GATEKEEPER_LOCAL_DEVICE_COUNT"
TIMEOUT_ENV = "GATEKEEPER_DIST_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 300.0

# set by init_distributed: this rank's shard count and device, and every
# rank's (shard count, device string), in rank order; "broken" the first
# gather failure
_STATE: dict = {}


class MeshError(RuntimeError):
    """A gather across ranks failed, or the ranks gathered different
    chunks: the mesh cannot serve another gather."""


def broken() -> str:
    """Why the mesh broke ("" while it serves)."""
    return _STATE.get("broken", "")


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_count: Optional[int] = None,
                     device: str = "cuda",
                     timeout_s: Optional[float] = None) -> None:
    """Join the process group before any device work.  ``device`` is the
    rank's device kind: ``"cuda"`` (the default) requires a card, raises
    without one, and pins this rank to ``cuda:{process_id % count}``;
    ``"cpu"`` must be asked for.  ``local_device_count``: the shards this
    rank contributes to a default mesh (else ``$GATEKEEPER_LOCAL_DEVICE_
    COUNT``, else 1).  Raises when a peer does not join within the
    timeout."""
    import torch
    import torch.distributed as dist

    from gatekeeper_tpu_torch import resolve_device

    dev = resolve_device(device)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..."
                         f"{num_processes - 1}")
    if local_device_count is None:
        local_device_count = int(os.environ.get(LOCAL_COUNT_ENV) or 1)
    if local_device_count < 1:
        raise ValueError(f"local_device_count {local_device_count} < 1")
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if timeout_s is None:
        timeout_s = float(os.environ.get(TIMEOUT_ENV) or DEFAULT_TIMEOUT_S)
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is "
                           "already initialized")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    ranks: list = [None] * num_processes
    dist.all_gather_object(ranks, (local_device_count, str(dev)))
    _STATE.clear()
    _STATE.update(rank=process_id, world=num_processes, device=dev,
                  local=local_device_count, ranks=ranks)
    atexit.register(shutdown)


def initialized() -> bool:
    """Whether this process joined a process group of more than one
    rank through :func:`init_distributed`."""
    return bool(_STATE) and _STATE["world"] > 1


def state() -> dict:
    """This rank's recorded layout (empty before :func:`init_distributed`)."""
    return dict(_STATE)


def process_info() -> tuple:
    """(process_id, num_processes, local_devices, global_devices)."""
    if _STATE:
        return (_STATE["rank"], _STATE["world"], _STATE["local"],
                sum(c for c, _d in _STATE["ranks"]))
    import torch

    local = torch.cuda.device_count() if torch.cuda.is_available() else \
        int(os.environ.get(LOCAL_COUNT_ENV) or 1)
    return 0, 1, local, local


def gather_shards(local: list, tag) -> tuple:
    """Every rank's ``local`` list concatenated in rank order (one
    ``all_gather_object`` over the process group), and the seconds the
    gather took.  ``tag`` names the chunk; every rank must gather the same
    one.  Raises :class:`MeshError` (and breaks the mesh) when the gather
    fails or the tags differ."""
    import torch.distributed as dist

    if broken():
        raise MeshError(f"mesh broken: {broken()}")
    t0 = time.perf_counter()
    out: list = [None] * _STATE["world"]
    try:
        dist.all_gather_object(out, (tag, local))
    except Exception as e:
        _STATE["broken"] = f"gather failed: {e}"
        raise MeshError(_STATE["broken"]) from e
    dt = time.perf_counter() - t0
    tags = [t for t, _part in out]
    if any(t != tag for t in tags):
        _STATE["broken"] = f"ranks gathered different chunks: {tags}"
        raise MeshError(_STATE["broken"])
    return [x for _t, part in out for x in part], dt


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()
