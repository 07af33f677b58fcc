"""The sweep's device mesh: an ordered list of data shards.

Port of ``make_mesh`` (``gatekeeper_tpu/parallel/sharded.py``).  A JAX mesh
names devices on a ``(data, model)`` grid and XLA places the sharded
arrays; here a :class:`Mesh` is the ordered global shard list (the rank
that owns each shard and its ``torch.device``), and ``parallel/sweep.py``
splits a chunk's object axis over it: shard ``s`` of ``D`` holds rows
``[s * pad_n / D, (s + 1) * pad_n / D)``.  Shards may repeat a device (two
shards on one card, or logical shards on the CPU).  The ``model`` axis is
kept for the JAX shape and must be 1 for a sweep: no caller in either
package shards the constraint axis.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from gatekeeper_tpu_torch import resolve_device
from gatekeeper_tpu_torch.parallel import distributed


class Mesh:
    """``shards``: ``(rank, torch.device)`` per shard in global order (the
    device of another rank's shard as that rank reported it).  ``size``,
    ``shape = {"data": D, "model": M}``, ``local``: ``(shard index,
    device)`` of this process's shards."""

    def __init__(self, shards: Sequence[tuple], model_parallel: int = 1,
                 rank: int = 0):
        self.shards = tuple((int(r), torch.device(d)) for r, d in shards)
        self.size = len(self.shards)
        if self.size == 0:
            raise ValueError("a mesh needs at least one device")
        if self.size % model_parallel != 0:
            raise ValueError(f"{self.size} devices not divisible by "
                             f"mp={model_parallel}")
        self.shape = {"data": self.size // model_parallel,
                      "model": model_parallel}
        self.rank = rank
        self.ranks = tuple(sorted({r for r, _d in self.shards}))
        self.local = tuple((i, d) for i, (r, d) in enumerate(self.shards)
                           if r == rank)
        if not self.local:
            raise ValueError(f"process {rank} holds no shard of the mesh")

    @property
    def spans_processes(self) -> bool:
        """Whether shards live in more than one process (the sweep then
        gathers every collected chunk's shard results)."""
        return len(self.ranks) > 1

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, shape={self.shape}, "
                f"devices={[str(d) for _r, d in self.shards]})")


def single(device) -> Mesh:
    """A one-shard mesh on ``device`` in this process."""
    return Mesh([(distributed.state().get("rank", 0), device)],
                rank=distributed.state().get("rank", 0))


def _local_devices(device: str, devices) -> list:
    if devices is not None:
        out = [resolve_device(str(d)) for d in devices]
        for d in out:
            if d.type == "cuda" and d.index is None:
                raise ValueError(f"name the card of a mesh device: {d}")
        return out
    dev = resolve_device(device)
    st = distributed.state()
    if st:
        rank_dev = st["device"]
        if dev.type != rank_dev.type:
            raise ValueError(f"mesh device {dev} on a rank that joined "
                             f"on {rank_dev}")
        return [rank_dev] * st["local"]
    if dev.type == "cuda":
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * int(os.environ.get(distributed.LOCAL_COUNT_ENV) or 1)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: str = "cuda", devices=None) -> Mesh:
    """A (data, model) mesh.  By default it covers every card this process
    sees (``"cuda"``, raising without one) or ``$GATEKEEPER_LOCAL_DEVICE_
    COUNT`` logical CPU shards (``"cpu"``); after
    :func:`distributed.init_distributed` it covers every rank's shards, in
    rank order.  ``devices`` lists this process's shards explicitly
    (repeats allowed).  ``n_devices`` keeps the first that many shards, as
    the JAX ``make_mesh`` keeps the first devices."""
    local = _local_devices(device, devices)
    st = distributed.state()
    rank = st.get("rank", 0)
    if distributed.initialized():
        shards = []
        for r, (count, dev) in enumerate(st["ranks"]):
            if r == rank:
                if len(local) != count:
                    raise ValueError(
                        f"process {rank} joined with {count} shards, not "
                        f"{len(local)}")
                shards += [(r, d) for d in local]
            else:
                shards += [(r, dev)] * count
    else:
        shards = [(rank, d) for d in local]
    if n_devices is not None:
        shards = shards[:n_devices]
    mesh = Mesh(shards, model_parallel=model_parallel, rank=rank)
    if mesh.spans_processes and len(mesh.ranks) != st["world"]:
        raise ValueError(f"a mesh over ranks {list(mesh.ranks)} of "
                         f"{st['world']}: a sweep's gather needs every rank")
    return mesh
