"""numpy -> torch hand-over for the grid evaluator.

The parameter tables (``build_param_table``) and batch columns
(``pack_batch_cols`` + vocab/inventory tables) are numpy on the host, in
the layout the JAX package builds them.  :func:`tensors_from_numpy` moves
them to the port's device with the dtypes the JAX package evaluates them
in: JAX runs without 64-bit types, so int64 becomes int32 and float64
becomes float32; every other dtype is kept.
"""

from __future__ import annotations

import numpy as np
import torch

_CANON = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
          np.dtype(np.float64): np.float32}


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    want = _CANON.get(a.dtype)
    if want is not None:
        a = a.astype(want)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tensors_from_numpy(param_table: dict, cols: dict, device) -> tuple:
    """(params, cols) as tensors on ``device``.  ``param_table``: name ->
    [C, ...] array; ``cols``: column key -> array or {field: array}, plus
    shared ``fn:``/``st:``/``inv:``/``ext:`` tables.  Dict order is kept
    (the evaluator reads the parameter table in insertion order)."""
    device = torch.device(device)
    params = {k: to_tensor(v, device) for k, v in param_table.items()}
    out: dict = {}
    for key, val in cols.items():
        if isinstance(val, dict):
            out[key] = {k: to_tensor(v, device) for k, v in val.items()}
        else:
            out[key] = to_tensor(val, device)
    return params, out
