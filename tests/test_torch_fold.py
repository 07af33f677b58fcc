"""The port's verdict fold (gatekeeper_tpu_torch/ops/fold.py) against the
JAX package's: the plain PyTorch versions must equal the Pallas kernels
(run in interpret mode on the CPU, as tests/test_pallas_topk.py runs them)
and the XLA top-k twin, bit for bit — ``idx`` compared where ``valid``.
The kernel's launch plan (``fold_plan``) and a numpy emulation of its
segmented algorithm (per-segment counts -> cluster offsets -> row ranks ->
first k) are held to the plain versions here; the CUDA kernels themselves
run only on a card (marked ``cuda``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.ops import fold


def _jax():
    """The JAX package's fold functions, imported inside the test that
    compares with them: a machine with the card and without JAX still runs
    this module's ``cuda`` tests (``pytest --noconftest``)."""
    jax = pytest.importorskip("jax")
    from gatekeeper_tpu.ops.pallas_topk import (
        fused_fold_pallas, topk_violations_counts_pallas)
    from gatekeeper_tpu.parallel.sharded import topk_violations

    return SimpleNamespace(jnp=jax.numpy, fused_fold=fused_fold_pallas,
                           epilogue=topk_violations_counts_pallas,
                           topk=topk_violations)


def _np(x):
    return np.asarray(x)


def _same_selection(iv_a, iv_b):
    (ia, va), (ib, vb) = iv_a, iv_b
    assert np.array_equal(_np(va), _np(vb)), "valid masks differ"
    assert np.array_equal(np.where(_np(va), _np(ia), -1),
                          np.where(_np(vb), _np(ib), -1)), \
        "selected indices differ under the valid mask"


def _epilogue_agree(verdicts: np.ndarray, k: int):
    ref = _jax()
    g = torch.from_numpy(verdicts)
    ti, tv, tc = fold.epilogue(g, k)
    pi, pv, pc = ref.epilogue(ref.jnp.asarray(verdicts), k)
    _same_selection((ti.numpy(), tv.numpy()), (pi, pv))
    _same_selection((ti.numpy(), tv.numpy()),
                    ref.topk(ref.jnp.asarray(verdicts), k))
    assert np.array_equal(tc.numpy(), _np(pc))
    assert np.array_equal(tc.numpy(), verdicts.sum(axis=1))
    # the kernel contract: invalid slots carry index 0
    assert not ti.numpy()[~tv.numpy()].any()


def _fold_agree(grid: np.ndarray, mask: np.ndarray, k: int):
    ref = _jax()
    ti, tv, tc, to = fold.fused_fold(torch.from_numpy(grid),
                                     torch.from_numpy(mask), k)
    pi, pv, pc, po = ref.fused_fold(ref.jnp.asarray(grid),
                                    ref.jnp.asarray(mask), k)
    masked = grid & mask
    _same_selection((ti.numpy(), tv.numpy()), (pi, pv))
    _same_selection((ti.numpy(), tv.numpy()),
                    ref.topk(ref.jnp.asarray(masked), min(k, grid.shape[1])))
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
    before = (fold.fused_fold.launches, fold.epilogue.launches,
              sum(fold.fused_fold.shapes.values()),
              sum(fold.epilogue.shapes.values()))
    fold.fused_fold(g, g, 4)
    fold.epilogue(g, 4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fold.fused_fold.launches, fold.epilogue.launches,
            sum(fold.fused_fold.shapes.values()),
            sum(fold.epilogue.shapes.values())) == before


PLAN_NS = [1, 8, 15, 16, 33, 512, 1000, 4096, 8192, 16384, 32768, 65536,
           200003]


def _passes(s: int, n: int) -> int:
    """Passes a cluster of s blocks makes over a row of n bytes."""
    return -(-n // (s * fold.THREADS * fold.CHUNK))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", PLAN_NS)
def test_fold_plan_covers_each_index_once(n, aligned):
    s, vec = fold.fold_plan(n, aligned)
    # grid (C, S) with cluster (1, S, 1): S divides the grid's y
    assert s in (1, 2, 4, 8)
    assert vec == (aligned and n % 16 == 0)
    seg = fold.THREADS * fold.CHUNK
    passes = _passes(s, n)
    assert (passes - 1) * s * seg < n <= passes * s * seg
    assert passes == 1 or s == fold.MAX_CLUSTER
    covered = np.zeros(n, np.int64)
    for p in range(passes):
        for r in range(s):
            lo = p * s * seg + r * seg
            covered[lo:min(lo + seg, n)] += 1
    assert (covered == 1).all()


def test_fold_plan_at_the_sweeps_shapes():
    # chunks of 32,768 and the path's smaller kind groups (8,192, 16,384)
    assert fold.fold_plan(32768, True) == (8, True)
    assert fold.fold_plan(16384, True) == (4, True)
    assert fold.fold_plan(8192, True) == (2, True)
    assert fold.fold_plan(512, True) == (1, True)
    assert fold.fold_plan(32768, False) == (8, False)


def _emulate(grid: np.ndarray, mask, k: int, aligned: bool = True):
    """The kernel's algorithm in numpy, at the plan's own segmentation:
    warp scans and warp totals give each thread's chunk its place in the
    block's segment, segment counts summed over lower cluster ranks (and
    earlier passes) give the segment's offset in the row, and a hit whose
    row rank is < k writes its index there."""
    c, n = grid.shape
    k = min(k, n)
    s, _vec = fold.fold_plan(n, aligned)
    t, b = fold.THREADS, fold.CHUNK
    passes = _passes(s, n)
    width = passes * s * t * b

    def cells(a):
        out = np.zeros((c, width), bool)
        out[:, :n] = a
        return out.reshape(c, passes, s, t, b)

    hit = cells(grid)
    if mask is not None:
        scope = cells(mask)
        hit &= scope
    cnt = hit.sum(-1)                                   # [c, p, s, t]
    lanes = cnt.reshape(c, passes, s, t // 32, 32)
    incl = np.cumsum(lanes, -1)                         # warp scans
    warp_tot = incl[..., -1]
    start = ((np.cumsum(warp_tot, -1) - warp_tot)[..., None]
             + incl - lanes).reshape(c, passes, s, t)
    seg_hits = warp_tot.sum(-1)                         # [c, p, s]
    pass_hits = seg_hits.sum(-1)                        # [c, p]
    offset = ((np.cumsum(pass_hits, -1) - pass_hits)[..., None]
              + np.cumsum(seg_hits, -1) - seg_hits)
    below = np.cumsum(hit, -1) - hit                    # bits below, in-thread
    rank = offset[..., None, None] + start[..., None] + below
    index = np.arange(width).reshape(passes, s, t, b)
    idx = np.zeros((c, k), np.int32)
    for r in range(c):
        take = hit[r] & (rank[r] < k)
        idx[r, rank[r][take]] = index[take]
    counts = pass_hits.sum(-1).astype(np.int32)
    valid = np.arange(k)[None, :] < np.minimum(counts, k)[:, None]
    if mask is None:
        return idx, valid, counts
    return idx, valid, counts, scope.sum((1, 2, 3, 4)).astype(np.int32)


SEGMENT = fold.THREADS * fold.CHUNK  # bytes a block owns per pass


def _edge_rows(c: int, n: int, seg: int, rng) -> np.ndarray:
    """Rows cycling through: hits on both sides of every segment edge (and
    at 0 and n-1), hits only in the last segment, one hit per segment, an
    empty row, a full row, a sparse random row."""
    g = np.zeros((c, n), bool)
    edges = np.arange(seg, n, seg)
    last = ((n - 1) // seg) * seg
    for r in range(c):
        case = r % 6
        if case == 0:
            g[r, np.concatenate([edges - 1, edges, [0, n - 1]])] = True
        elif case == 1:
            g[r, last:] = rng.random(n - last) < 0.3
        elif case == 2:
            starts = np.arange(0, n, seg)
            span = np.minimum(starts + seg, n) - starts
            g[r, starts + (rng.random(starts.size) * span).astype(int)] = True
        elif case == 4:
            g[r] = True
        elif case == 5:
            g[r] = rng.random(n) < 0.002
    return g


@pytest.mark.parametrize("c,n,k", [
    (12, 32768, 3),        # first k inside the first segment
    (12, 32768, 20),       # k spans several segments
    (12, 32768, 200),      # k past the hits of most rows
    (3, 8192, 20),         # the path's kind groups: two blocks per row
    (6, 16384, 20),        # four blocks per row
    (6, 65536, 20),        # two passes
    (6, 200003, 20),       # byte path, seven passes
    (6, 262144, 40),       # 16-byte path, eight passes
    (6, 1000, 20), (6, 33, 40), (6, 8, 20)])
@pytest.mark.parametrize("aligned", [True, False])
def test_segmented_emulation_equals_plain(c, n, k, aligned):
    rng = np.random.default_rng(n + k)
    grid = _edge_rows(c, n, SEGMENT, rng)
    mask = (rng.random((c, n)) < 0.7) | grid
    mask[1] = rng.random(n) < 0.5   # last-segment hits half out of scope
    got = _emulate(grid, mask, k, aligned)
    want = fold.fused_fold_plain(torch.from_numpy(grid),
                                 torch.from_numpy(mask), k)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    got = _emulate(grid & mask, None, k, aligned)
    want = fold.epilogue_plain(torch.from_numpy(grid & mask), k)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k,rows", [
    (44, 32768, 20, 0.3), (44, 32768, 20, 0.001), (44, 32768, 20, 0.0),
    (1, 32768, 20, 0.01), (45, 32768, 20, 0.01), (44, 4096, 128, 0.1),
    (44, 4096, 200, 0.1), (3, 33, 40, 0.5), (6, 8, 20, 0.5),
    (70000, 16, 4, 0.3),  # more rows than a grid's y dimension holds
    (12, 32768, 3, "edges"), (12, 32768, 200, "edges"),
    (3, 8192, 20, "edges"), (6, 16384, 20, "edges"),
    (6, 65536, 20, "edges"), (6, 262144, 40, "edges"),
    (6, 200003, 20, "edges"), (44, 32768, 20, "misaligned"),
    (6, 1000, 20, "misaligned")])
def test_cuda_kernels_match_plain(cuda_card, c, n, k, rows):
    rng = np.random.default_rng(c * 7 + k)
    mask = rng.random((c, n)) < 0.7
    if isinstance(rows, float):
        g = rng.random((c, n)) < rows
    else:
        g = _edge_rows(c, n, SEGMENT, rng)
        # the edge hits in scope, but for row 1: its hits of the last
        # segment half out of scope
        mask |= g
        mask[1] = rng.random(n) < 0.5
    grid = torch.from_numpy(g).to(cuda_card)
    mask = torch.from_numpy(mask).to(cuda_card)
    masked = grid & mask
    if rows == "misaligned":
        grid, mask, masked = (_misaligned(t) for t in (grid, mask, masked))
    launches = fold.fused_fold.launches
    got = fold.fused_fold(grid, mask, k)
    assert fold.fused_fold.launches == launches + 1
    for a, b in zip(got, fold.fused_fold_plain(grid, mask, k)):
        assert torch.equal(a, b)
    for a, b in zip(fold.epilogue(masked, k),
                    fold.epilogue_plain(masked, k)):
        assert torch.equal(a, b)
