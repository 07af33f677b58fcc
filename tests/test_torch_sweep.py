"""The reduced lane of the port's sweep (gatekeeper_tpu_torch/parallel/
sweep.py) picks its hit coordinates without ``torch.nonzero``, on the
budgeted path (the kept selection) and on the exact-totals path (every
set cell of the grid): :func:`select_hits` must give, bit for bit, the
coordinates that the nonzero-and-pad formulation gives (the JAX package's
``jnp.nonzero(sel, size=hit_cap)``), for a hit buffer below, at and above
the selection and for no hits, and ``_reduce`` must not call
``torch.nonzero`` on either path."""

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.ops import fold
from gatekeeper_tpu_torch.parallel import sweep


def _nonzero_padded(flat, size, fill):
    """``jnp.nonzero(flat, size=size, fill_value=fill)`` through
    ``torch.nonzero`` (which makes the host wait for the device)."""
    nz = torch.nonzero(flat).reshape(-1)[:size]
    out = torch.full((size,), fill, dtype=torch.int64)
    out[: nz.shape[0]] = nz
    return out


def _nonzero_hits(sel, idx, hit_cap, pad_n, sentinel):
    """The formulation with ``torch.nonzero`` that select_hits replaces."""
    c_total, k_eff = sel.shape
    pos = _nonzero_padded(sel.reshape(-1), hit_cap, c_total * k_eff)
    safe = torch.clamp(pos, max=c_total * k_eff - 1)
    oi = idx.reshape(-1)[safe].to(torch.int64)
    return torch.where(pos < c_total * k_eff, (pos // k_eff) * pad_n + oi,
                       sentinel).to(torch.int32)


def _selection(rng, c, pad_n, k, density):
    raw = torch.from_numpy(rng.random((c, pad_n)) < density)
    mask = torch.from_numpy(rng.random((c, pad_n)) < 0.8)
    idx, valid, counts, _occ = fold.fused_fold(raw, mask, k)
    budget = torch.from_numpy(rng.integers(0, k + 1, c).astype(np.int32))
    want = torch.minimum(counts, budget)
    sel = valid & (torch.arange(idx.shape[1])[None, :] < want[:, None])
    return raw, mask, budget.numpy(), idx, sel


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cap", ["below", "equal", "above", "one"])
def test_select_hits_equals_nonzero_formulation(seed, cap):
    rng = np.random.default_rng(seed)
    c, pad_n, k = 9, 256, 20
    _raw, _mask, _budget, idx, sel = _selection(rng, c, pad_n, k, 0.05)
    nsel = int(sel.sum())
    assert nsel > 1
    hit_cap = {"below": nsel // 2, "equal": nsel, "above": nsel + 37,
               "one": 1}[cap]
    sentinel = c * pad_n
    got = sweep.select_hits(sel, idx, hit_cap, pad_n, sentinel)
    want = _nonzero_hits(sel, idx, hit_cap, pad_n, sentinel)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("hit_cap", [1, 16, 64])
def test_select_hits_with_no_hits(hit_cap):
    sel = torch.zeros((5, 20), dtype=torch.bool)
    idx = torch.zeros((5, 20), dtype=torch.int32)
    got = sweep.select_hits(sel, idx, hit_cap, 512, 5 * 512)
    assert torch.equal(got, _nonzero_hits(sel, idx, hit_cap, 512, 5 * 512))
    assert (got == 5 * 512).all()


def test_select_hits_keeps_any_selection_order():
    """A selection that is not a per-row prefix still comes out in
    row-major order."""
    rng = np.random.default_rng(9)
    sel = torch.from_numpy(rng.random((7, 20)) < 0.4)
    idx = torch.from_numpy(rng.integers(0, 1024, (7, 20)).astype(np.int32))
    for hit_cap in (1, 5, int(sel.sum()), 200):
        assert torch.equal(sweep.select_hits(sel, idx, hit_cap, 1024, 7168),
                           _nonzero_hits(sel, idx, hit_cap, 1024, 7168))


def _forbid_nonzero(monkeypatch):
    def nonzero(*args, **kwargs):
        raise AssertionError("torch.nonzero called: the host would sync")
    monkeypatch.setattr(torch, "nonzero", nonzero)


@pytest.mark.parametrize("hit_cap", [0, 16, 64, 180])
def test_budgeted_reduce_never_calls_nonzero(monkeypatch, hit_cap):
    rng = np.random.default_rng(11)
    c, pad_n, k = 9, 256, 20
    raw, mask, budget_np, idx, sel = _selection(rng, c, pad_n, k, 0.05)
    want_hits = _nonzero_hits(sel, idx, hit_cap, pad_n, c * pad_n)
    ev = sweep.SweepEvaluator(driver=None, device="cpu", violations_limit=k)
    _forbid_nonzero(monkeypatch)
    out = ev._reduce(raw, mask, budget_np, False, hit_cap, k, pad_n)
    # [counts|occ (u16|u16) per row | nsel | hits(hit_cap)]
    assert out.shape == (c + 1 + hit_cap,)
    assert int(out[c]) == int(sel.sum())
    assert torch.equal(out[c + 1:], want_hits)


def _exact_hits(grid, hit_cap, pad_n):
    """The old exact-totals coordinates: ``nonzero`` over the whole
    [C, pad_n] grid, padded with the C * pad_n sentinel."""
    c = grid.shape[0]
    return _nonzero_padded(grid.reshape(-1), hit_cap, c * pad_n).to(
        torch.int32)


def test_patched_nonzero_raises(monkeypatch):
    """The patch the tests below rely on takes hold."""
    _forbid_nonzero(monkeypatch)
    with pytest.raises(AssertionError, match="torch.nonzero"):
        _exact_hits(torch.ones((2, 8), dtype=torch.bool), 4, 8)


CAPS = ["below", "equal", "above", "none"]


def _exact_reduce(seed, cap, monkeypatch=None):
    """(exact-totals reduce output, torch.nonzero-and-pad coordinates, C,
    hit count) over a random grid with a hit buffer below, at or above the
    hit count, or a grid with no hits.  With ``monkeypatch`` the reduce
    runs with ``torch.nonzero`` made to raise."""
    rng = np.random.default_rng(12 + seed)
    c, pad_n = 7, 128
    density = 0.0 if cap == "none" else 0.08
    raw, mask, _b, _i, _s = _selection(rng, c, pad_n, 20, density)
    grid = raw & mask
    nhits = int(grid.sum())
    hit_cap = {"below": max(1, nhits // 3), "equal": nhits,
               "above": nhits + 29, "none": 16}[cap]
    assert (nhits > 1) != (cap == "none")
    want = _exact_hits(grid, hit_cap, pad_n)
    ev = sweep.SweepEvaluator(driver=None, device="cpu", violations_limit=20)
    if monkeypatch is not None:
        _forbid_nonzero(monkeypatch)
    out = ev._reduce(raw, mask, None, True, hit_cap, 20, pad_n)
    # [counts|occ (u16|u16) per row | nsel | hits(hit_cap)]
    assert out.shape == (c + 1 + hit_cap,)
    return out, want, c, nhits


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cap", CAPS)
def test_exact_totals_reduce_still_uses_nonzero(seed, cap):
    """The exact-totals branch ships every set cell of ``raw & mask`` as
    flat coordinates; they still equal the ``torch.nonzero``-and-pad
    coordinates bit for bit."""
    out, want, c, nhits = _exact_reduce(seed, cap)
    assert int(out[c]) == nhits
    assert torch.equal(out[c + 1:], want)


@pytest.mark.parametrize("cap", CAPS)
def test_exact_totals_reduce_never_calls_nonzero(monkeypatch, cap):
    """The exact-totals branch gets those coordinates without calling
    ``torch.nonzero`` (the host does not wait on the device)."""
    out, want, c, nhits = _exact_reduce(1, cap, monkeypatch)
    assert int(out[c]) == nhits
    assert torch.equal(out[c + 1:], want)
