"""The audit sweep's verdict fold: hand-written CUDA kernels + plain twins.

Port of ``gatekeeper_tpu/ops/pallas_topk.py``.  Per constraint row of a
``[C, N]`` bool verdict grid the fold yields the FIRST k violating object
indices (lowest index first: the reference's LimitQueue) and the exact
violation count; the fused variant takes the RAW grid plus the match mask
and also yields the mask occupancy.

- :func:`fused_fold` replaces ``_fused_fold_kernel`` (``fused_fold_pallas``),
  the default reduced collect lane.
- :func:`epilogue` replaces ``_epilogue_kernel``
  (``topk_violations_counts_pallas``), the masks collect lane.

Both launch ``csrc/fold.cu`` on a CUDA tensor (the source's header says
what bounds the kernel and how it is laid out) and run the plain PyTorch
version on a CPU tensor.  On a CUDA tensor the wrapper launches the kernel
or raises; it never falls back.  Each wrapper counts its launches in a
plain int attribute (``fused_fold.launches``, ``epilogue.launches``).

Contract (bit-identical to the JAX package's): ``idx [C, k]`` int32 with
invalid slots 0, ``valid [C, k]`` bool, ``counts [C]`` int32 and, fused,
``occ [C]`` int32; ``k`` is clipped to N.
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.ops import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = cuda_build.load("fold")
    if not getattr(lib, "_gk_typed", False):
        lib.gk_fused_fold.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.gk_fused_fold.restype = _I
        lib.gk_epilogue.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
        lib.gk_epilogue.restype = _I
        lib._gk_typed = True
    return lib


def topk_violations(verdicts: torch.Tensor, k: int) -> tuple:
    """Per-row top-k violating indices, lowest index first: (idx [C, k]
    int32, valid [C, k] bool).  ``torch.topk`` over the index score
    ``violation * (N - index)``; invalid slots carry arbitrary indices
    (consumers gate on ``valid``).  The plain twin of the JAX package's
    ``parallel.sharded.topk_violations``."""
    c, n = verdicts.shape
    k = min(k, n)
    idxs = torch.arange(n, dtype=torch.int32, device=verdicts.device)
    score = torch.where(verdicts, n - idxs, 0).to(torch.int32)
    top_scores, top_idx = torch.topk(score, k, dim=1)
    return top_idx.to(torch.int32), top_scores > 0


def epilogue_plain(grid: torch.Tensor, k: int) -> tuple:
    """Plain version of :func:`epilogue`."""
    idx, valid = topk_violations(grid, k)
    return (torch.where(valid, idx, 0), valid,
            grid.sum(dim=1, dtype=torch.int32))


def fused_fold_plain(grid_raw: torch.Tensor, mask: torch.Tensor,
                     k: int) -> tuple:
    """Plain version of :func:`fused_fold`."""
    masked = grid_raw & mask
    idx, valid, counts = epilogue_plain(masked, k)
    return idx, valid, counts, mask.sum(dim=1, dtype=torch.int32)


def _check(name: str, *grids: torch.Tensor) -> None:
    g0 = grids[0]
    for g in grids:
        if g.dtype != torch.bool:
            raise TypeError(f"{name}: grid dtype {g.dtype}, want torch.bool")
        if g.dim() != 2 or g.shape != g0.shape:
            raise ValueError(f"{name}: grid shape {tuple(g.shape)}, want "
                             f"[C, N] equal to {tuple(g0.shape)}")
        if g.device != g0.device:
            raise ValueError(f"{name}: grids on {g.device} and {g0.device}")
        if not g.is_contiguous():
            raise ValueError(f"{name}: grid must be contiguous")
    if g0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {g0.device}")


def _outputs(c: int, k: int, device) -> tuple:
    return (torch.empty((c, k), dtype=torch.int32, device=device),
            torch.empty((c, k), dtype=torch.bool, device=device),
            torch.empty((c,), dtype=torch.int32, device=device))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def epilogue(grid: torch.Tensor, k: int) -> tuple:
    """(idx [C,k] i32, valid [C,k] bool, counts [C] i32) of an
    already-masked verdict grid."""
    _check("epilogue", grid)
    if grid.device.type == "cpu":
        return epilogue_plain(grid, k)
    c, n = grid.shape
    k = min(k, n)
    idx, valid, counts = _outputs(c, k, grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gk_epilogue(grid.data_ptr(), c, n, k, idx.data_ptr(),
                                valid.data_ptr(), counts.data_ptr(), stream)
    _raise_on(rc, "epilogue")
    epilogue.launches += 1
    return idx, valid, counts


def fused_fold(grid_raw: torch.Tensor, mask: torch.Tensor, k: int) -> tuple:
    """(idx [C,k] i32, valid [C,k] bool, counts [C] i32, occ [C] i32) from
    the RAW verdict grid and the match mask in one pass."""
    _check("fused_fold", grid_raw, mask)
    if grid_raw.device.type == "cpu":
        return fused_fold_plain(grid_raw, mask, k)
    c, n = grid_raw.shape
    k = min(k, n)
    idx, valid, counts = _outputs(c, k, grid_raw.device)
    occ = torch.empty((c,), dtype=torch.int32, device=grid_raw.device)
    with torch.cuda.device(grid_raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gk_fused_fold(
            grid_raw.data_ptr(), mask.data_ptr(), c, n, k, idx.data_ptr(),
            valid.data_ptr(), counts.data_ptr(), occ.data_ptr(), stream)
    _raise_on(rc, "fused_fold")
    fused_fold.launches += 1
    return idx, valid, counts, occ


epilogue.launches = 0
fused_fold.launches = 0
