"""The port's verdict fold (gatekeeper_tpu_torch/ops/fold.py) against the
JAX package's: the plain PyTorch versions must equal the Pallas kernels
(run in interpret mode on the CPU, as tests/test_pallas_topk.py runs them)
and the XLA top-k twin, bit for bit — ``idx`` compared where ``valid``.
The CUDA kernels themselves run only on a card (marked ``cuda``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from gatekeeper_tpu.ops.pallas_topk import (  # noqa: E402
    fused_fold_pallas, topk_violations_counts_pallas)
from gatekeeper_tpu.parallel.sharded import \
    topk_violations as jax_topk  # noqa: E402
from gatekeeper_tpu_torch.ops import fold  # noqa: E402


def _np(x):
    return np.asarray(x)


def _same_selection(iv_a, iv_b):
    (ia, va), (ib, vb) = iv_a, iv_b
    assert np.array_equal(_np(va), _np(vb)), "valid masks differ"
    assert np.array_equal(np.where(_np(va), _np(ia), -1),
                          np.where(_np(vb), _np(ib), -1)), \
        "selected indices differ under the valid mask"


def _epilogue_agree(verdicts: np.ndarray, k: int):
    g = torch.from_numpy(verdicts)
    ti, tv, tc = fold.epilogue(g, k)
    pi, pv, pc = topk_violations_counts_pallas(jnp.asarray(verdicts), k)
    _same_selection((ti.numpy(), tv.numpy()), (pi, pv))
    _same_selection((ti.numpy(), tv.numpy()),
                    jax_topk(jnp.asarray(verdicts), k))
    assert np.array_equal(tc.numpy(), _np(pc))
    assert np.array_equal(tc.numpy(), verdicts.sum(axis=1))
    # the kernel contract: invalid slots carry index 0
    assert not ti.numpy()[~tv.numpy()].any()


def _fold_agree(grid: np.ndarray, mask: np.ndarray, k: int):
    ti, tv, tc, to = fold.fused_fold(torch.from_numpy(grid),
                                     torch.from_numpy(mask), k)
    pi, pv, pc, po = fused_fold_pallas(jnp.asarray(grid), jnp.asarray(mask),
                                       k)
    masked = grid & mask
    _same_selection((ti.numpy(), tv.numpy()), (pi, pv))
    _same_selection((ti.numpy(), tv.numpy()),
                    jax_topk(jnp.asarray(masked), min(k, grid.shape[1])))
    assert np.array_equal(tc.numpy(), _np(pc))
    assert np.array_equal(to.numpy(), _np(po))
    assert np.array_equal(to.numpy(), mask.sum(axis=1))
    assert not ti.numpy()[~tv.numpy()].any()


def test_dense_sparse_empty_rows():
    rng = np.random.default_rng(0)
    v = rng.random((46, 4096)) < 0.01      # sparse
    v[3] = False                            # empty row
    v[7] = True                             # full row
    v[11, -1] = True                        # lone hit at the tail
    _epilogue_agree(v, 20)


def test_k_larger_than_hits_and_row():
    rng = np.random.default_rng(1)
    v = rng.random((5, 64)) < 0.2
    _epilogue_agree(v, 20)
    _epilogue_agree(v, 64)


@pytest.mark.parametrize("k", [1, 126, 127, 128, 200])
def test_k_edges(k):
    rng = np.random.default_rng(3)
    v = rng.random((4, 512)) < 0.3
    _epilogue_agree(v, k)
    _fold_agree(v, rng.random((4, 512)) < 0.6, k)


@pytest.mark.parametrize("c", [1, 7, 8, 9, 46])
def test_rows_not_multiple_of_8(c):
    rng = np.random.default_rng(2)
    v = rng.random((c, 512)) < 0.05
    _epilogue_agree(v, 20)
    _fold_agree(v, rng.random((c, 512)) < 0.5, 20)


def test_fused_fold_matches_jax_fold():
    rng = np.random.default_rng(4)
    grid = rng.random((46, 4096)) < 0.02
    mask = rng.random((46, 4096)) < 0.7
    grid[5] = True                          # full row
    mask[9] = False                         # fully out-of-scope row
    grid[13] = False                        # clean row
    mask[21, :7] = True                     # sliver-scoped row
    _fold_agree(grid, mask, 20)


def test_fused_fold_k_not_below_n():
    rng = np.random.default_rng(5)
    grid = rng.random((4, 64)) < 0.3
    mask = rng.random((4, 64)) < 0.5
    _fold_agree(grid, mask, 64)    # k == n
    _fold_agree(grid, mask, 200)   # k > n: clamped


def test_first_k_are_lowest_indices():
    v = np.zeros((2, 256), bool)
    hits = [5, 17, 99, 100, 255]
    v[0, hits] = True
    idx, valid, counts = fold.epilogue(torch.from_numpy(v), 3)
    assert idx[0, :3].tolist() == hits[:3]
    assert valid[0].tolist() == [True, True, True]
    assert not valid[1].any()
    assert counts.tolist() == [5, 0]


def test_wrapper_checks_inputs_and_counts_only_launches():
    g = torch.zeros((3, 16), dtype=torch.bool)
    with pytest.raises(TypeError):
        fold.epilogue(g.to(torch.uint8), 4)
    with pytest.raises(ValueError):
        fold.fused_fold(g, torch.zeros((3, 8), dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        fold.epilogue(torch.zeros((16, 3), dtype=torch.bool).t(), 4)
    before = (fold.fused_fold.launches, fold.epilogue.launches)
    fold.fused_fold(g, g, 4)
    fold.epilogue(g, 4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fold.fused_fold.launches, fold.epilogue.launches) == before


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k,density", [
    (44, 32768, 20, 0.3), (44, 32768, 20, 0.001), (44, 32768, 20, 0.0),
    (1, 32768, 20, 0.01), (45, 32768, 20, 0.01), (44, 4096, 128, 0.1),
    (44, 4096, 200, 0.1), (3, 33, 40, 0.5)])
def test_cuda_kernels_match_plain(cuda_card, c, n, k, density):
    rng = np.random.default_rng(c * 7 + k)
    grid = torch.from_numpy(rng.random((c, n)) < density).to(cuda_card)
    mask = torch.from_numpy(rng.random((c, n)) < 0.7).to(cuda_card)
    launches = fold.fused_fold.launches
    got = fold.fused_fold(grid, mask, k)
    assert fold.fused_fold.launches == launches + 1
    for a, b in zip(got, fold.fused_fold_plain(grid, mask, k)):
        assert torch.equal(a, b)
    masked = grid & mask
    for a, b in zip(fold.epilogue(masked, k),
                    fold.epilogue_plain(masked, k)):
        assert torch.equal(a, b)
