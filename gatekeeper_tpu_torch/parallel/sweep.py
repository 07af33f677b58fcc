"""The audit sweep on one device: flatten -> dispatch -> collect.

Port of the single-device path of ``gatekeeper_tpu/parallel/sharded.py``
(``ShardedEvaluator``).  A sweep chunk is flattened to columns on the host
(``sweep_flatten``), its columns, parameter tables, shared lookup tables
and match mask go to the device as tensors and every template's [C, N]
verdict grid is evaluated there (``sweep_dispatch``), and the folded
result comes back in one small array (``sweep_collect``).

Collect lanes (``collect=``):

- ``reduced`` (the default): the grid never leaves the device.  Per
  constraint the violation totals, the mask occupancy and the kept
  selection (first k hits under the caller's remaining budget) fold on
  the device — through the hand-written ``ops/fold.fused_fold`` kernel —
  into ``[counts|occ (u16|u16) | nsel | hits(hit_cap)]``.  Exact-totals
  chunks (``return_bits``) ship EVERY hit coordinate instead, in an
  adaptive buffer that falls back to the masks lane on overflow.
- ``masks``: the host-fold reference lane.  ``ops/fold.epilogue`` yields
  per-constraint first-k + totals (``[idx(k) | valid(k) | count]``), and
  exact-totals chunks also ship the bit-packed grid.
- ``differential``: every chunk goes through BOTH lanes, in one hold of
  the dispatch lock, so a budgeted chunk runs both fold kernels; the
  collect raises ``RuntimeError("collect differential: ...")`` on the
  first difference in totals, in the hit rows of exact-totals chunks, in
  the kept selection under the chunk's budget, or between the device
  ``occ`` and the host mask sums.  ``perf`` counts
  ``differential_chunks`` per chunk dispatched through both lanes,
  ``collect_differential_ok`` per chunk held and
  ``collect_differential_fallbacks`` where the reduced side overflowed
  into its masks-lane re-dispatch (two masks folds are then compared).

Sweep inputs: a chunk of listed objects (``sweep_flatten``), rows of the
resident snapshot's host columns (``sweep_flatten_from_batch``), or rows
of a device-resident snapshot group (``sweep_flatten_resident``: the
columns and match masks already live on the device as the stats-free
``pack_transfer_cols`` buffers of ``snapshot/device_residency.py``; the
chunk gathers them by an index vector on the device, and both collect
lanes fold the gathered grid exactly as they fold a host chunk's).

Transfers of a host chunk: its per-object columns cross in ONE copy per
dtype (``pack_transfer_cols`` into page-locked staging, then
``unpack_transfer_cols`` views on the device), the match mask and the
reduced lane's kept budget in one more; vocab/inventory/extdata tables
and parameter tables cross only when their content caches miss.  The
chunk's result comes back by a copy into page-locked host memory that the
dispatch enqueues before it records the chunk's CUDA event, so a collect
waits on that event alone, never on chunks dispatched after it.
Dispatches are serialized by a lock: the staged pipeline dispatches on
one thread while the reduced lane's overflow fallback re-dispatches from
the collect thread.  ``flatten_workers`` fans raw-lane chunks across
``ops/flatten.FlattenWorkerPool`` processes, forked when the evaluator is
built (before any pipeline thread starts).

Hooks, as in the JAX package: the ``ops.flatten.columnize``,
``device.sweep_dispatch`` and ``device.sweep_collect`` spans (the dispatch
span times the enqueue, the collect span the wait on the chunk's event),
the flatten metrics, and the ``device.dispatch`` fault site, taken before
the dispatch lock so a ``hang`` on one thread never blocks the overflow
re-dispatch of another.  Cost attribution apportions each chunk's dispatch
wall to templates by mask occupancy: the masks lane by the host masks'
sums, the reduced lane by the ``occ`` half of the fused fold's packed word,
read from the host copy the collect already fetched (no extra transfer).

Meshes (``mesh=``, ``parallel/mesh.py``): a chunk pads to ``8 * D``
doubled (``D`` data shards), shard ``s`` holds rows ``[s * pad_n / D, (s
+ 1) * pad_n / D)``.  Each of this process's shards uploads only its rows
of the packed columns and of the mask (the shared tables and the
parameter tables are replicated, one content cache per device), runs the
grid on its rows and folds its own ``[C, N/D]`` through the SAME
hand-written kernels.  The collect merges the shards' results on the host
(with a mesh over processes, after one gather of every rank's shards,
``parallel/distributed.py``): totals and occupancy sum, each shard's
first-k moves to its rows and the lowest-index-first merge keeps the
first k, the kept budget clips after the merge, exact-totals hit
coordinates are sorted back into canonical order, and every adaptive
decision (overflow re-dispatch, hit-buffer sizing, masks-lane pinning)
reads the merged values, so every rank takes it.  Where the JAX package
leaves its Pallas kernels on a mesh of more than one device for XLA's
gathering ``top_k`` (``sharded.py:904-907``), the port keeps its kernels.

Wire narrowing: :meth:`SweepEvaluator.warm_pass` gathers the corpus column
stats (:func:`col_stats_update`, :func:`merge_pad_stats`), and every
dispatch after it packs with them (:func:`pack_transfer_cols` with
``stats``: narrow dtypes, constant elision, dictionary remap), widened
back on the device by :func:`unpack_transfer_cols`.  The resident lane's
layout stays stats-free.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gatekeeper_tpu_torch import resolve_device
from gatekeeper_tpu_torch.ir import masks as masks_mod
from gatekeeper_tpu_torch.ir.convert import to_tensor
from gatekeeper_tpu_torch.ir.program import (build_param_table, col_key,
                                             is_table_key, needed_fields,
                                             pack_batch_cols, slim_cols,
                                             vocab_tables)
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.observability import costattr, tracing
from gatekeeper_tpu_torch.ops import fold
from gatekeeper_tpu_torch.ops.flatten import (Flattener, Schema,
                                              flatten_worker_spans,
                                              get_flatten_pool)
from gatekeeper_tpu_torch.parallel import distributed
from gatekeeper_tpu_torch.parallel import mesh as mesh_mod
from gatekeeper_tpu_torch.parallel.mesh import Mesh
from gatekeeper_tpu_torch.resilience.faults import fault_point


COLLECT_LANES = ("reduced", "masks", "differential")

# budgeted-lane hit-buffer steps: 0 for drained-budget chunks, three small
# steps for the steady-state trickle, then the full per-chunk capacity
_HIT_STEPS = (0, 16, 64, 256)

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # np.packbits order: MSB first

# numpy dtype string of a packed column buffer -> its torch dtype on the
# device.  int64/float64 narrow to int32/float32 as ``ir.convert.to_tensor``
# narrows every host-lane column (JAX's canonical dtypes), so a resident
# column holds the same values in the same dtype as its host twin; every
# other dtype is kept as it is.
_TORCH_DTYPES = {"|b1": torch.bool, "|i1": torch.int8, "|u1": torch.uint8,
                 "<i2": torch.int16, "<i4": torch.int32, "<i8": torch.int32,
                 "<f4": torch.float32, "<f8": torch.float32,
                 # the narrowed wire's stores: nibble pairs in bytes, and
                 # uint16 as the same bits in int16 (widened on the device)
                 "|n1": torch.uint8, "<u2": torch.int16}

_PARAM_CACHE_CAP = 32  # parameter-table sets kept on the device

# device -> the uint8 bit-shift vector of packbits/unpackbits: made once,
# only ever read, so neither costs a host-to-device copy per call
_SHIFTS: dict = {}


def _shifts(device) -> torch.Tensor:
    t = _SHIFTS.get(device)
    if t is None:
        t = _SHIFTS[device] = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8,
                                           device=device)
    return t


def hit_bucket(need: int, cap: int) -> int:
    """Smallest hit-buffer size covering ``need`` selected hits (``cap`` =
    the exhaustive bound, e.g. C*k for a kept selection)."""
    if need <= 0:
        return 0
    for b in _HIT_STEPS[1:]:
        if need <= b < cap:
            return b
    return cap


class HitRows:
    """Device-reduced violation coordinates for one kind's constraint
    rows: flat ``ci * pad_n + oi`` coords, canonically sorted
    (constraint-major, ascending object index).  ``rows(ci)`` yields the
    violating object indices of local constraint ``ci`` exactly as
    ``np.nonzero(np.unpackbits(bits[ci], count=n))[0]`` would."""

    __slots__ = ("flat", "pad_n", "n", "c", "_starts")

    def __init__(self, flat: np.ndarray, pad_n: int, n: int, c: int):
        self.flat = flat
        self.pad_n = pad_n
        self.n = n
        self.c = c
        self._starts = np.searchsorted(
            flat, np.arange(c + 1, dtype=np.int64) * pad_n)

    def rows(self, ci: int) -> np.ndarray:
        lo, hi = self._starts[ci], self._starts[ci + 1]
        oi = self.flat[lo:hi] - ci * self.pad_n
        return oi[oi < self.n]


def violation_rows(bits_or_hits, ci: int, n: int) -> np.ndarray:
    """Violating object indices of local constraint ``ci`` from either
    collect shape: bit-packed verdict rows (masks lane) or
    :class:`HitRows` (reduced lane)."""
    if isinstance(bits_or_hits, HitRows):
        return bits_or_hits.rows(ci)
    return np.nonzero(np.unpackbits(bits_or_hits[ci], count=n))[0]


def relevant_template_kinds(constraints) -> dict:
    """template (constraint) kind -> frozenset of object kinds its
    constraints' ``spec.match.kinds`` can match, or None for wildcard
    (any entry with kinds ``*``/absent, or no kinds matcher at all).

    This is the reference's --audit-match-kind-only prefilter semantics
    (pkg/audit/manager.go:427-483) applied per template: a SUPERSET by
    construction (apiGroups and the other matchers still gate on device),
    so routing by it never changes verdicts."""
    rel: dict = {}
    for con in constraints:
        ks: set = set()
        wild = False
        entries = (con.match or {}).get("kinds") or []
        if not entries:
            wild = True
        for e in entries:
            kk = e.get("kinds") or []
            if not kk or "*" in kk:
                wild = True
            ks.update(k for k in kk if k != "*")
        prev = rel.get(con.kind)
        if wild or prev is None and con.kind in rel:
            rel[con.kind] = None
        elif prev is None and con.kind not in rel:
            rel[con.kind] = frozenset(ks)
        elif prev is not None:
            rel[con.kind] = prev | frozenset(ks)
    return rel


def make_kind_router(constraints):
    """obj kind -> frozenset of template kinds that could match it — the
    kind-bucketed sweep router.  Objects whose group is empty cannot
    violate anything: the audit skips them, and grouped chunks only
    flatten/ship/evaluate the group's schemas."""
    rel = relevant_template_kinds(constraints)
    wild = frozenset(t for t, ks in rel.items() if ks is None)
    cache: dict = {}

    def group_of(obj_kind: str) -> frozenset:
        g = cache.get(obj_kind)
        if g is None:
            g = wild | frozenset(
                t for t, ks in rel.items()
                if ks is not None and obj_kind in ks)
            cache[obj_kind] = g
        return g

    return group_of


def unpackbits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """``np.unpackbits(bits, axis=1, count=n)`` as bool, on the device."""
    out = (bits[..., None] >> _shifts(bits.device)) & 1
    return out.reshape(bits.shape[0], -1)[:, :n].to(torch.bool)


def packbits(grid: torch.Tensor) -> torch.Tensor:
    """``np.packbits(grid, axis=1)`` (uint8, MSB first), on the device."""
    c, n = grid.shape
    pad = (-n) % 8
    g = grid.to(torch.uint8)
    if pad:
        g = torch.nn.functional.pad(g, (0, pad))
    return (g.reshape(c, -1, 8) << _shifts(grid.device)).sum(
        dim=-1).to(torch.uint8)


def select_hits(sel: torch.Tensor, idx: torch.Tensor, hit_cap: int,
                pad_n: int, sentinel: int) -> torch.Tensor:
    """The first ``hit_cap`` set slots of ``sel`` [C, k], in row-major
    order, as flat ``row * pad_n + idx[row, j]`` coordinates (int32) padded
    with ``sentinel``: the coordinates of ``nonzero(sel)[:hit_cap]``.  Each
    set slot's place is the running count of set slots before it; slots
    past ``hit_cap`` scatter into one extra slot that is dropped.  Static
    shapes throughout, so the host never waits on the device."""
    flat = sel.reshape(-1)
    place = torch.cumsum(flat, 0) - 1
    dest = torch.where(flat & (place < hit_cap), place, hit_cap)
    rows = torch.arange(sel.shape[0], dtype=torch.int64, device=sel.device)
    coords = (rows[:, None] * pad_n + idx.to(torch.int64)).reshape(-1)
    out = torch.full((hit_cap + 1,), sentinel, dtype=torch.int64,
                     device=sel.device)
    out.scatter_(0, dest, coords)
    return out[:hit_cap].to(torch.int32)


_DICT_CAP = 254  # distinct values above this: no u1 dictionary remap


def col_stats_update(stats: dict, cols: dict) -> None:
    """Accumulate corpus-wide per-column (min, max, const-value,
    distinct-values, integral-float) over the per-object transfer columns
    of one chunk (a copy of the JAX package's, pure numpy).  Consumed by
    :func:`pack_transfer_cols` to pick narrow wire dtypes, elide
    corpus-constant columns and dictionary-remap low-cardinality columns,
    with a layout that is the same for every chunk of the run."""
    for key in cols:
        if is_table_key(key):
            continue
        val = cols[key]
        items = sorted(val.items()) if isinstance(val, dict) \
            else [(None, val)]
        for sub, a in items:
            a = np.asarray(a)
            if a.size == 0:
                continue
            amn = a.min().item()
            amx = a.max().item()
            vals: Optional[frozenset] = None
            if a.dtype.str in ("<i4", "<i8"):
                # distinct-set tracking for the u1 dictionary remap
                # (low-cardinality wide-range columns, e.g. label-key
                # sids); capped: a high-cardinality column drops out
                u = np.unique(a)
                if len(u) <= _DICT_CAP:
                    vals = frozenset(int(x) for x in u)
            # float columns holding only integral values (ports, replica
            # counts) can ride integer wire dtypes
            intf = (a.dtype.str == "<f4"
                    and bool(np.all(a == np.trunc(a))))
            prev = stats.get((key, sub))
            if prev is None:
                stats[(key, sub)] = (amn, amx,
                                     amn if amn == amx else None, vals,
                                     intf)
            else:
                mn, mx, cv = prev[0], prev[1], prev[2]
                pv = prev[3] if len(prev) > 3 else None
                if pv is None or vals is None:
                    vals = None  # some chunk already overflowed the cap
                else:
                    vals = pv | vals
                    if len(vals) > _DICT_CAP:
                        vals = None
                stats[(key, sub)] = (
                    min(mn, amn), max(mx, amx),
                    cv if (cv is not None and amn == amx == cv) else None,
                    vals,
                    intf and (len(prev) < 5 or prev[4]))


_PAD_BY_SUB = {"kind": 0, "num": 0.0, "sid": -1, "idx": -1, "count": 0}


def merge_pad_stats(stats: dict) -> None:
    """Fold the ragged families' pad values into corpus column stats: the
    warm pass scans chunks at their own widths, the sweeps after it pad
    every chunk to the corpus width targets, which can add pad values a
    scanned chunk never held.  Merging them keeps the wire layout the
    same for every padded chunk."""
    for (key, sub), st in list(stats.items()):
        if not key.startswith(("rg:", "rks:", "mk:", "pi:", "ks:")):
            continue
        pad = _PAD_BY_SUB.get(sub)
        if pad is None:
            continue
        mn, mx, cv = st[0], st[1], st[2]
        vals = st[3] if len(st) > 3 else None
        intf = st[4] if len(st) > 4 else False
        ncv = cv if cv == pad else None
        if vals is not None:
            vals = vals | {int(pad)} if not isinstance(pad, float) else vals
            if len(vals) > _DICT_CAP:
                vals = None
        stats[(key, sub)] = (min(mn, pad), max(mx, pad), ncv, vals, intf)


def _wire_dtype(dt: str, mn: float, mx: float) -> tuple:
    """(store dtype str, bias) for a column whose corpus range is [mn,
    mx].  Integer columns with mn >= -1 ride unsigned narrow types with a
    +1 bias (the -1 missing-value sentinel becomes 0); ``"|n1"`` marks a
    nibble (two values per byte); everything else travels as it is."""
    if dt in ("<i4", "<i8", "|i1") and mn >= -1:
        if mx + 1 <= 0xF:
            return "|n1", 1
        if mx + 1 <= 0xFF:
            return "|u1", 1
        if mx + 1 <= 0xFFFF:
            return "<u2", 1
    return dt, 0


def pack_transfer_cols(cols: dict, pad_n: int,
                       stats: Optional[dict] = None, alloc=None) -> tuple:
    """Pack every per-object column into ONE ``[pad_n, W]`` buffer per
    wire dtype (port of ``gatekeeper_tpu/parallel/sharded.py``: the same
    buffers and layout for the same columns and stats).

    Each column occupies ``w`` columns of its wire dtype's buffer at
    offset ``off`` (a ``[pad_n, *tail]`` column flattens to ``w =
    prod(tail)``).  The same numpy array under two keys (prefix-axis
    dedup, ``ops/flatten.dedup_schema``) packs once and becomes an
    ``alias`` entry.  Table columns (``fn:``/``st:``/``inv:``/``ext:``)
    are left out.

    ``stats`` (``{(key, sub): (min, max, const|None, values|None,
    integral)}`` from :func:`col_stats_update` over the corpus, which
    ``SweepEvaluator.warm_pass`` gathers) turns on the wire narrowing:
    integer columns whose corpus range fits ride ``|n1`` (two values per
    byte), ``|u1`` or ``<u2`` with a +1 bias, integral float columns
    alike; corpus-constant columns ship as a layout scalar (``const``);
    a wide-range column of at most 254 distinct values ships ``|u1``
    dictionary indices with the sorted values in the layout.  A chunk
    outside the corpus stats falls back to a wider dtype for that column,
    never to a wrong value.  Without stats every row set of one schema
    packs to the same layout, with no narrowing.

    Returns ``({wire dtype str: buf}, layout)``, layout a tuple of
    ``(key, sub, wire dtype | "alias" | "const", off, tail, w, dtype str,
    bias | const value | dictionary values | (alias key, alias sub))``.
    ``alloc(wire dtype str, shape)``, when given, returns the array each
    buffer is written into (the sweep's page-locked staging, of the
    buffer's device dtype: int64/float64 columns narrow to int32/float32
    in the copy, as ``torch_dtype`` maps them); else each buffer is a new
    array of the wire dtype."""
    parts: dict = {}
    widths: dict = {}
    layout: list = []
    seen: dict = {}  # id(array) -> (key, sub): identity alias dedup
    for key in sorted(k for k in cols if not is_table_key(k)):
        val = cols[key]
        items = sorted(val.items()) if isinstance(val, dict) \
            else [(None, val)]
        for sub, a in items:
            ref = seen.get(id(a))
            if ref is not None:
                layout.append((key, sub, "alias", 0, (), 0, a.dtype.str,
                               ref))
                continue
            seen[id(a)] = (key, sub)
            a = np.ascontiguousarray(a)
            dt = a.dtype.str
            tail = a.shape[1:]
            st = stats.get((key, sub)) if stats is not None else None
            dict_vals = None
            narrowable = dt in ("<i4", "<i8", "|i1") or (
                dt == "<f4" and st is not None and len(st) > 4 and st[4])
            if st is not None and (st[2] is not None or narrowable) \
                    and a.size:
                amn = a.min().item()
                amx = a.max().item()
                if st[2] is not None and amn == amx == st[2]:
                    # corpus-constant and this chunk agrees: elide
                    layout.append((key, sub, "const", 0, tail, 0, dt,
                                   st[2]))
                    continue
                eff_mn = min(st[0], amn)
                eff_mx = max(st[1], amx)
                if not narrowable:
                    wdt, bias = dt, 0
                elif dt == "<f4":
                    # integral-float column: an integer wire dtype, if
                    # this chunk is integral too and the range fits
                    wdt, bias = _wire_dtype("<i4", eff_mn, eff_mx)
                    if wdt == "<i4" or not bool(np.all(a == np.trunc(a))):
                        wdt, bias = dt, 0
                else:
                    wdt, bias = _wire_dtype(dt, eff_mn, eff_mx)
                dct = st[3] if len(st) > 3 else None
                if dct is not None and wdt not in ("|u1", "|n1"):
                    # u1 dictionary remap; values outside the corpus
                    # dictionary fall back to the plain narrowed dtype
                    dv = np.array(sorted(dct), np.int64)
                    idx = np.searchsorted(dv, a.ravel())
                    idx_c = np.minimum(idx, len(dv) - 1)
                    if bool(np.all(dv[idx_c] == a.ravel())):
                        a = idx_c.astype(np.uint8).reshape(a.shape)
                        wdt, bias = "|u1", 0
                        dict_vals = tuple(int(x) for x in dv)
            else:
                wdt, bias = dt, 0
            w = int(np.prod(tail, dtype=np.int64)) if a.ndim > 1 else 1
            if wdt == "|n1" and w % 2:
                wdt = "|u1"  # nibble pairs need an even element count
            if wdt == "|n1":
                b = (a + bias).astype(np.uint8).reshape(pad_n, w)
                a = b[:, 0::2] | (b[:, 1::2] << 4)
                store_w = w // 2
            elif bias:
                a = (a + bias).astype(np.dtype(wdt))
                store_w = w
            else:
                store_w = w
            off = widths.get(wdt, 0)
            parts.setdefault(wdt, []).append(a.reshape(pad_n, store_w))
            layout.append((key, sub, wdt, off, tail, w, dt,
                           dict_vals if dict_vals is not None else bias))
            widths[wdt] = off + store_w
    bufs = {}
    for wdt, ps in parts.items():
        if alloc is None:
            bufs[wdt] = np.concatenate(ps, axis=1)
        else:
            bufs[wdt] = np.concatenate(ps, axis=1, casting="same_kind",
                                       out=alloc(wdt, (pad_n, widths[wdt])))
    return bufs, tuple(layout)


# (dictionary values, dtype, device) -> the values as a device tensor: a
# layout's dictionaries are made once per device and only ever read
_DICTS: dict = {}
_DICTS_CAP = 4096


def _dict_values(vals: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    key = (vals, dtype, str(device))
    t = _DICTS.get(key)
    if t is None:
        if len(_DICTS) >= _DICTS_CAP:
            _DICTS.clear()
        t = _DICTS[key] = torch.tensor(vals, dtype=torch.int64).to(
            dtype).to(device)
    return t


def unpack_transfer_cols(bufs: dict, layout: tuple, pad_n: int,
                         device=None) -> dict:
    """The cols dict back from :func:`pack_transfer_cols` buffers (numpy
    or tensors; ``pad_n`` rows).  A plain entry is a slice of its dtype's
    buffer viewed to ``[n, *tail]`` (no copy), an alias entry is the SAME
    object as the column it names.  Narrowed entries widen back to the
    column's device dtype on ``device`` (else the buffers' device):
    ``|n1`` splits its nibbles (low first), ``|u1``/``<u2`` widen (a
    ``<u2`` buffer crosses as the same bits in int16) and drop the bias, a
    dictionary entry gathers its values, a ``const`` entry broadcasts."""
    cols: dict = {}
    aliases: list = []
    for key, sub, wdt, off, tail, w, dt, extra in layout:
        if wdt == "alias":
            aliases.append((key, sub, extra))
            continue
        if wdt == "const":
            if device is None:
                device = next((b.device for b in bufs.values()
                               if isinstance(b, torch.Tensor)), "cpu")
            arr = torch.full((pad_n,) + tuple(tail), extra,
                             dtype=torch_dtype(dt), device=device)
        elif wdt == dt:
            buf = bufs[wdt]
            arr = buf[:, off: off + w].reshape((buf.shape[0],) + tuple(tail))
        else:
            buf = bufs[wdt]
            if isinstance(buf, np.ndarray):
                buf = torch.from_numpy(buf)
            n = buf.shape[0]
            odt = torch_dtype(dt)
            if wdt == "|n1":
                sl = buf[:, off: off + w // 2]
                arr = torch.stack([sl & 0xF, sl >> 4], dim=-1)
                arr = arr.reshape((n,) + tuple(tail)).to(odt)
            else:
                arr = buf[:, off: off + w].reshape((n,) + tuple(tail))
                if isinstance(extra, tuple):
                    arr = _dict_values(extra, odt, arr.device)[arr.long()]
                else:
                    if wdt == "<u2":
                        arr = arr.to(torch.int32) & 0xFFFF
                    arr = arr.to(odt)
            if not isinstance(extra, tuple) and extra:
                arr = arr - extra
        if sub is None:
            cols[key] = arr
        else:
            cols.setdefault(key, {})[sub] = arr
    for key, sub, (rkey, rsub) in aliases:
        src = cols[rkey] if rsub is None else cols[rkey][rsub]
        if sub is None:
            cols[key] = src
        else:
            cols.setdefault(key, {})[sub] = src
    return cols


def torch_dtype(dtype_str: str) -> torch.dtype:
    """The device dtype of a packed buffer of numpy dtype ``dtype_str``."""
    dt = _TORCH_DTYPES.get(dtype_str)
    if dt is None:
        raise TypeError(f"no device dtype for packed columns of numpy "
                        f"dtype {dtype_str!r}")
    return dt


def gather_resident(idx: torch.Tensor, cols_dev: dict, mask_dev,
                    cols_layout: tuple, pad_n: int) -> tuple:
    """(cols, mask) of one chunk gathered on the device from a resident
    group's tall buffers by ``idx`` (int32 ``[pad_n]``, -1 = pad slot).
    Pad slots gather row 0 (always in bounds) under a False mask column,
    so they contribute what a host chunk's fill-padded rows under a False
    mask contribute: nothing.  Gather commutes with the unpack (both are
    row-wise), so the columns equal those of a host-gathered chunk."""
    safe = idx.clamp(min=0)
    gathered = {dt: b.index_select(0, safe) for dt, b in cols_dev.items()}
    cols = unpack_transfer_cols(gathered, cols_layout, pad_n)
    mask = mask_dev.index_select(1, safe) & (idx >= 0)[None, :]
    return cols, mask


class _Part:
    """One shard's device result: ``result`` (a tensor, or the masks
    lane's (packed, bits) pair), and on a CUDA device the page-locked host
    copies the dispatch enqueued (``host``) and the CUDA event recorded
    after them (``event``)."""

    __slots__ = ("shard", "result", "host", "event")

    def __init__(self, shard: int, result):
        self.shard = shard
        self.result = result
        self.host = None
        self.event = None


class _PendingSweep:
    __slots__ = ("parts", "kinds", "offsets", "by_kind", "n",
                 "return_bits", "lane", "pad_n", "hit_cap", "flat",
                 "staging", "dispatch_wall",
                 "attr_weights", "attr_rows", "ref", "host_occ",
                 "budget_np")

    def __init__(self, parts, kinds, offsets, by_kind, n, return_bits,
                 lane="masks", pad_n=0, hit_cap=0, flat=None):
        # this process's shards' results (:class:`_Part`), in shard order
        self.parts = parts
        self.kinds = kinds
        self.offsets = offsets
        self.by_kind = by_kind
        self.n = n
        self.return_bits = return_bits
        self.lane = lane
        self.pad_n = pad_n
        # reduced lane: static hit-buffer size; the retained _FlatChunk
        # backs the masks-lane fallback re-dispatch when a chunk's true
        # hit count overflows it (dropped at collect)
        self.hit_cap = hit_cap
        self.flat = flat
        # page-locked upload staging of the chunk: kept alive until the
        # collect, after the event has fired
        self.staging = None
        # cost attribution: the dispatch's wall (enqueue) and, on the masks
        # lane, the per-template host mask occupancy weights (the reduced
        # lane reads its weights off the device result at collect)
        self.dispatch_wall = 0.0
        self.attr_weights = None
        self.attr_rows = None
        # differential lane: the masks-lane dispatch of the same chunk, the
        # host's per-constraint mask occupancy (int32 [C], grid order) that
        # the device ``occ`` is held against, and the kept budget the
        # reduced selection was clipped to (None = complete)
        self.ref = None
        self.host_occ = None
        self.budget_np = None

    def ready(self) -> bool:
        """True when the device result needs no further wait."""
        return all(p.event is None or p.event.query()
                   for p in self.parts) and (
            self.ref is None or self.ref.ready())


class _FlatChunk:
    """A host-flattened (not yet dispatched) sweep chunk."""

    __slots__ = ("by_kind", "kinds", "cols", "batch", "objects", "any_gen",
                 "n", "pad_n", "return_bits", "source", "budget",
                 "programs")

    def __init__(self, by_kind, kinds, cols, batch, objects, any_gen, n,
                 pad_n, return_bits, source=SOURCE_ORIGINAL, budget=None,
                 programs=None):
        self.by_kind = by_kind
        self.kinds = kinds
        self.cols = cols
        self.batch = batch
        self.objects = objects
        self.any_gen = any_gen
        self.n = n
        self.pad_n = pad_n
        self.return_bits = return_bits
        # review source ("Original"/"Generated") the chunk's match masks
        # evaluate under, as its reviews do: listed objects are Original,
        # the expansion generator stage's resultants Generated, so
        # source-scoped constraints match each correctly
        self.source = source
        # reduced lane, budgeted variant: con -> remaining run-level kept
        # slots, evaluated at dispatch; None = full render cap
        self.budget = budget
        # the programs this chunk was flattened under
        self.programs = programs


class _ResidentChunk:
    """A sweep chunk whose columns and masks already live on the device:
    the resident group (``snapshot/device_residency.ResidentGroup``) and
    the store positions to gather.  No host batch, columns or masks."""

    __slots__ = ("rg", "by_kind", "kinds", "positions", "n", "pad_n",
                 "return_bits", "budget", "programs")

    def __init__(self, rg, positions, n, pad_n, return_bits, budget=None,
                 programs=None):
        self.rg = rg
        self.by_kind = rg.by_kind
        self.kinds = rg.kinds
        self.positions = tuple(positions)
        self.n = n
        self.pad_n = pad_n
        self.return_bits = return_bits
        self.budget = budget
        self.programs = programs


class SweepEvaluator:
    """Runs a TorchDriver's compiled programs over sweep chunks on a
    device mesh (``parallel/mesh.py``; ``mesh=None``: one shard on
    ``device``).  Reuses the driver's vocab so interned ids agree with the
    driver's parameter tables."""

    renders = False  # kept violations render in the audit manager

    def __init__(self, driver, device: str = "cuda",
                 violations_limit: int = 20, flatten_lane: str = "auto",
                 collect: str = "reduced", flatten_workers: int = 0,
                 metrics=None, mesh: Optional[Mesh] = None):
        self.driver = driver
        self.metrics = metrics
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_mod.single(
            self.device)
        if self.mesh.shape["model"] != 1:
            raise ValueError("the sweep shards the object axis only: a "
                             "mesh with model_parallel > 1 is not "
                             "supported")
        self.violations_limit = violations_limit
        # how sweep chunks columnize (ops/flatten.py FLATTEN_LANES)
        self.flatten_lane = flatten_lane
        # raw-lane chunks fan byte spans across this many flatten worker
        # processes (ops/flatten.FlattenWorkerPool), merged into the
        # shared vocab on the flattening thread; 0 = in-process.  The pool
        # forks here, before any pipeline thread exists; its workers run
        # only the C columnizer and never touch torch.
        self.flatten_workers = max(0, int(flatten_workers))
        if self.flatten_workers:
            get_flatten_pool(self.flatten_workers)
        # one dispatch at a time: the pipelined schedule's dispatch thread
        # and the reduced lane's overflow fallback (on the collect thread)
        # both update the device caches and the hit-buffer state
        self._dispatch_lock = threading.RLock()
        if collect not in COLLECT_LANES:
            raise ValueError(f"unknown collect lane {collect!r}")
        self.collect = collect
        # per-generation merged-schema cache: (plan epoch, lowered set)
        self._schema_cache: dict = {}
        # reduced lane adaptive state per (kinds, pad_n): hit-buffer size
        # for complete-hits chunks, masks-lane pinning, low-water streak
        self._hit_state: dict = {}
        # shared lookup tables on the device, keyed by column key and
        # checked by content: they change only when the vocab crosses a
        # bucket or the data version moves
        self._table_dev_cache: dict = {}
        # parameter tables on the device, keyed by the content of one
        # dispatch's tables (insertion order kept: the evaluator reads a
        # table in that order); a warm pass rebuilds identical tables and
        # uploads none of them
        self._param_dev_cache: dict = {}
        # corpus-wide per-column stats and ragged width targets from
        # warm_pass: the wire narrowing of every dispatch after it
        self._col_stats: dict = {}
        self._width_targets: dict = {}
        # sweep_warm's dispatches enqueue no device-to-host copy
        self._no_fetch = False
        # gathers across processes made (the chunk tag's sequence number)
        self._gathers = 0
        self._bucket = 2
        # device dispatches made (each lane of a differential chunk and
        # each overflow re-dispatch counts one), as the JAX evaluator's
        self.dispatch_count = 0
        # per-phase wall-clock totals (seconds) and byte counts
        self.perf: dict = {}
        self._perf_lock = threading.Lock()

    def _perf_add(self, phase: str, dt: float) -> None:
        with self._perf_lock:
            self.perf[phase] = self.perf.get(phase, 0.0) + dt

    def perf_reset(self) -> None:
        self.perf = {}

    def _flattener(self, schema: Schema) -> Flattener:
        return Flattener(schema, self.driver.vocab, bucket=self._bucket,
                         width_targets=self._width_targets or None,
                         lane=self.flatten_lane,
                         workers=self.flatten_workers)

    def _needs_union(self, kinds, alias: Optional[dict] = None,
                     programs=None) -> dict:
        """Union of array fields any lowered program reads (transfer
        slimming).  ``alias`` (orig spec -> exec spec from the Flattener's
        prefix-axis dedup) extends each aliased key's needs onto its exec
        column so slimming keeps every field read through either name."""
        progs = programs if programs is not None \
            else self.driver._programs
        needs: dict = {}
        for kind in sorted(kinds):
            for ck, fields in needed_fields(
                    progs[kind].program).items():
                needs.setdefault(ck, set()).update(fields)
        if alias:
            for orig, new in alias.items():
                ok, nk = col_key(orig), col_key(new)
                if ok in needs or nk in needs:
                    u = needs.get(ok, set()) | needs.get(nk, set())
                    needs[ok] = u
                    needs[nk] = u
        return needs

    def sweep(self, constraints: Sequence, objects: Sequence[dict],
              return_bits: bool = False):
        """One audit sweep chunk: {kind: (cons, idx, valid, counts, bits)}.

        idx/valid [C, k]: first-k violating object indices per constraint;
        counts [C]: violating-object totals; bits: the complete hit set
        (bit-packed rows or :class:`HitRows`) when ``return_bits``, else
        None.  Non-lowered kinds are left to the caller."""
        return self.sweep_collect(
            self.sweep_submit(constraints, objects, return_bits))

    def sweep_submit(self, constraints: Sequence, objects: Sequence[dict],
                     return_bits: bool = False, budget=None):
        """Flatten + dispatch without fetching: the device runs while the
        caller flattens the next chunk."""
        return self.sweep_dispatch(
            self.sweep_flatten(constraints, objects, return_bits,
                               budget=budget))

    def warm_pass(self, constraints: Sequence, objects, chunk_size: int,
                  return_bits: bool = False, route: bool = True) -> None:
        """Scan the whole corpus before a timed run, with no device-to-host
        fetch: every chunk interns its strings (the vocab tables of the run
        after it are final), feeds the corpus column stats (the wire
        narrowing of every dispatch after it: :func:`pack_transfer_cols`
        with ``stats``) and records the corpus ragged-width maxes (every
        later chunk pads to them); then one sweep per (group, pad bucket)
        runs through :meth:`sweep_warm`.  ``objects`` may be any iterable:
        chunks are scanned as they fill, and one chunk per (group, pad
        bucket) is kept.  ``route`` streams objects into per-group chunks
        as the audit's kind router does."""
        from gatekeeper_tpu_torch.utils.rawjson import peek_kind

        state: dict = {}  # group -> (cons, flattener, needs) or None
        buckets: dict = {}  # (group, pad) -> (cons, representative chunk)
        progs = self.driver._programs

        def group_state(g):
            if g in state:
                return state[g]
            cons_g = [c for c in constraints if c.kind in g]
            by_kind: dict = {}
            for con in cons_g:
                by_kind.setdefault(con.kind, []).append(con)
            lowered = [k for k in by_kind
                       if k in progs
                       and self.driver.inventory_exact(k, programs=progs)
                       and self.driver.extdata_ready(k, programs=progs)]
            if not lowered:
                state[g] = None
                return None
            # the group's parameter tables register their needle rows
            # before any sweep, so no later group's tables grow them
            for kind in lowered:
                build_param_table(progs[kind].program, by_kind[kind],
                                  self.driver.vocab)
            schema = Schema()
            for kind in lowered:
                schema.merge(progs[kind].program.schema)
            fl = Flattener(schema, self.driver.vocab, bucket=self._bucket,
                           lane=self.flatten_lane,
                           workers=self.flatten_workers)
            st = (cons_g, fl, self._needs_union(lowered, fl.alias,
                                                programs=progs))
            state[g] = st
            return st

        def scan_chunk(g, ch):
            st = group_state(g)
            if st is None:
                return
            cons_g, fl, needs = st
            batch = fl.flatten(ch, pad_n=self._pad(len(ch)))
            fl.record_widths(batch, self._width_targets)
            col_stats_update(self._col_stats,
                             slim_cols(pack_batch_cols(batch), needs))
            buckets.setdefault((g, self._pad(len(ch))), (cons_g, ch))

        if route:
            router = make_kind_router(constraints)
            bufs: dict = {}
            for obj in objects:
                g = router(peek_kind(obj))
                if not g:
                    continue
                buf = bufs.setdefault(g, [])
                buf.append(obj)
                if len(buf) >= chunk_size:
                    scan_chunk(g, buf)
                    bufs[g] = []
            for g, buf in bufs.items():
                if buf:
                    scan_chunk(g, buf)
        else:
            g_all = frozenset(c.kind for c in constraints)
            buf = []
            for obj in objects:
                buf.append(obj)
                if len(buf) >= chunk_size:
                    scan_chunk(g_all, buf)
                    buf = []
            if buf:
                scan_chunk(g_all, buf)
        # the scan flattened at chunk-local widths; the sweeps after it pad
        # to the corpus targets: fold the pad values in so the layout holds
        merge_pad_stats(self._col_stats)
        for cons_g, ch in buckets.values():
            self.sweep_warm(cons_g, ch, return_bits)

    def sweep_warm(self, constraints: Sequence, objects: Sequence[dict],
                   return_bits: bool = False) -> None:
        """Dispatch a sweep and wait for the device WITHOUT any
        device-to-host copy (each shard's CUDA event, no ``.cpu()``); on
        the reduced lane also the budgeted hit-buffer ladder
        (``_HIT_STEPS``) that a run's chunks walk down as kept budgets
        drain.  Nothing is collected, so no adaptive state moves."""

        def wait(p):
            for part in getattr(p, "parts", ()):
                if part.event is not None:
                    part.event.synchronize()
            if getattr(p, "ref", None) is not None:
                wait(p.ref)

        flat = self.sweep_flatten(constraints, objects, return_bits)
        if not isinstance(flat, _FlatChunk):
            return
        with self._dispatch_lock:
            self._no_fetch = True
            try:
                wait(self.sweep_dispatch(flat))
                if self.collect in ("reduced", "differential") \
                        and not return_bits:
                    def warm_budget(total):
                        left = [total]

                        def b(_con):
                            v = min(self.violations_limit, left[0])
                            left[0] -= v
                            return v

                        return b

                    # the chunk is flattened once; each step dispatches it
                    # under its own budget
                    for total in _HIT_STEPS:
                        flat.budget = warm_budget(total)
                        wait(self.sweep_dispatch(flat))
            finally:
                self._no_fetch = False

    def sweep_schema(self, constraints: Sequence, programs=None) -> tuple:
        """(by_kind, lowered_kinds, merged_schema) — the columnize plan of
        :meth:`sweep_flatten`.  ``lowered_kinds`` is empty when nothing is
        device-eligible.  The merged schema is cached per (plan epoch,
        lowered set)."""
        progs = programs if programs is not None \
            else self.driver._programs
        by_kind: dict[str, list] = {}
        for con in constraints:
            by_kind.setdefault(con.kind, []).append(con)
        lowered = [k for k in by_kind
                   if k in progs
                   and self.driver.inventory_exact(k, programs=progs)
                   and self.driver.extdata_ready(k, programs=progs)]
        key = (getattr(self.driver, "plan_epoch", 0),
               tuple(sorted(lowered)))
        schema = self._schema_cache.get(key)
        if schema is None:
            schema = Schema()
            for kind in lowered:
                schema.merge(progs[kind].program.schema)
            if len(self._schema_cache) > 64:
                self._schema_cache.clear()
            self._schema_cache[key] = schema
        return by_kind, lowered, schema

    def sweep_flatten(self, constraints: Sequence, objects: Sequence[dict],
                      return_bits: bool = False, budget=None,
                      source: str = SOURCE_ORIGINAL):
        """Stage 1 (host): schema union + flatten + column pack/slim.
        Returns a :class:`_FlatChunk`, or {} when no kind is lowered.
        ``source`` is the review source every object of the chunk is
        matched under."""
        programs = self.driver._programs  # capture the programs once
        by_kind, lowered, schema = self.sweep_schema(constraints,
                                                     programs=programs)
        if not lowered:
            return {}
        n = len(objects)
        pad_n = self._pad(n)
        t0 = time.perf_counter()
        fl = self._flattener(schema)
        with tracing.span("ops.flatten.columnize", n=n,
                          lane=self.flatten_lane) as sp:
            batch = fl.flatten(objects, pad_n=pad_n)
            sp.set_attribute("lane_used", fl.lane_used)
        dt = time.perf_counter() - t0
        self._perf_add("flatten", dt)
        self._flatten_accounting(fl, n)
        attr = costattr.active()
        if attr is not None:
            # the flatten splits across the templates whose union schema
            # it served, by constraint count (rows are shared; columns are
            # schema-driven)
            attr.attribute(
                dt, {k: float(len(by_kind[k])) for k in lowered},
                costattr.EP_AUDIT, costattr.PHASE_FLATTEN)
        self._flatten_metrics(fl, n, dt)
        cols = slim_cols(pack_batch_cols(batch),
                         self._needs_union(lowered, fl.alias,
                                           programs=programs))
        if batch.has_generate_name is not None:
            any_gen = bool(batch.has_generate_name[:n].any())
        else:
            any_gen = any(
                "generateName" in (o.get("metadata") or {})
                for o in objects)
        return _FlatChunk(by_kind, tuple(sorted(lowered)), cols, batch,
                          objects, any_gen, n, pad_n, return_bits,
                          source=source, budget=budget, programs=programs)

    def _flatten_accounting(self, fl: Flattener, n: int) -> None:
        """The flatten's sub-phases (``fl_c_columnize``, ...), the lane the
        chunk took (``flatten_chunks/<lane>``) and, with flatten workers,
        ``flatten_fanout_chunks``: the chunks large enough that the
        columnizer's own thread clamp (``flatten_worker_spans``) splits
        them over more than one worker — the chunks that should read
        ``raw+workers``."""
        for k, v in fl.perf.items():
            self._perf_add("fl_" + k, v)
        self._perf_add(f"flatten_chunks/{fl.lane_used or 'unknown'}", 1.0)
        if self.flatten_workers and \
                len(flatten_worker_spans(n, self.flatten_workers)) > 1:
            self._perf_add("flatten_fanout_chunks", 1.0)

    def _flatten_metrics(self, fl: Flattener, n: int, dt: float) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        self.metrics.inc_counter(M.FLATTEN_LANE,
                                 {"lane": fl.lane_used or "unknown"})
        if dt > 0:
            self.metrics.set_gauge(M.FLATTEN_OBJECTS_PER_SECOND, n / dt)
        wu = getattr(fl, "last_workers_used", 0)
        if wu:
            self.metrics.set_gauge(M.FLATTEN_WORKER_COUNT, wu)
            busy = fl.perf.get("worker_busy", 0.0)
            if busy > 0:
                # aggregate objects per worker-second
                self.metrics.set_gauge(
                    M.FLATTEN_WORKER_OBJECTS_PER_SECOND, n / busy)
            self.metrics.set_gauge(M.FLATTEN_WORKER_MERGE_SECONDS,
                                   fl.perf.get("worker_merge", 0.0))
        fb = fl.perf.get("worker_fallbacks", 0.0)
        if fb:
            self.metrics.inc_counter(M.FLATTEN_WORKER_FALLBACKS,
                                     value=float(fb))

    def sweep_flatten_from_batch(self, constraints: Sequence, batch,
                                 objects: Sequence[dict],
                                 return_bits: bool = False,
                                 alias: Optional[dict] = None, budget=None):
        """Stage 1 over a PRE-FLATTENED :class:`ColumnBatch` (the resident
        snapshot's host-column lane): the columns were flattened when the
        watch patched them in, so only pack/slim happens here.  ``alias``
        is the producing Flattener's prefix-axis alias map.  Returns the
        :class:`_FlatChunk` :meth:`sweep_flatten` would."""
        programs = self.driver._programs
        by_kind, lowered, _schema = self.sweep_schema(constraints,
                                                      programs=programs)
        if not lowered:
            return {}
        cols = slim_cols(pack_batch_cols(batch),
                         self._needs_union(lowered, alias or {},
                                           programs=programs))
        n = len(objects)
        if batch.has_generate_name is not None:
            any_gen = bool(batch.has_generate_name[:n].any())
        else:
            any_gen = any(
                "generateName" in (o.get("metadata") or {})
                for o in objects)
        return _FlatChunk(by_kind, tuple(sorted(lowered)), cols, batch,
                          objects, any_gen, n, batch.n, return_bits,
                          budget=budget, programs=programs)

    def sweep_flatten_resident(self, rg, positions,
                               return_bits: bool = False, budget=None):
        """Stage 1 for DEVICE-RESIDENT snapshot rows: no flatten, no host
        gather, no column pack — the chunk is the resident group plus the
        row positions.  Returns a :class:`_ResidentChunk`, {} for no rows,
        or None when the mirror's programs are no longer the driver's
        (the caller then takes the host-column path)."""
        programs = self.driver._programs
        if tuple(programs[k].uid for k in rg.kinds
                 if k in programs) != rg.uids:
            return None
        n = len(positions)
        if n == 0:
            return {}
        return _ResidentChunk(rg, positions, n, self._pad(n), return_bits,
                              budget=budget, programs=programs)

    def sweep_dispatch(self, flat):
        """Stage 2 (host -> device): match masks + parameter tables +
        tensor upload + the device program, or for a resident chunk the
        device gather + the device program.  {} passes through."""
        if not isinstance(flat, (_FlatChunk, _ResidentChunk)):
            return flat if isinstance(flat, dict) else {}
        lane = self.collect
        t0 = time.perf_counter()
        with tracing.span("device.sweep_dispatch", n=flat.n,
                          kinds=len(flat.kinds), collect=lane):
            if lane == "differential":
                pending = self._dispatch_differential(flat)
            else:
                pending = self._sweep_dispatch_impl(flat, lane=lane)
        wall = time.perf_counter() - t0
        pending.dispatch_wall = wall
        attr = costattr.active()
        if attr is not None and pending.attr_weights:
            # the pass's wall apportioned by mask row occupancy: the
            # per-template shares sum back to the span's wall.  The reduced
            # lane's weights are None here; it attributes the same wall at
            # collect, from the fused fold's occupancy counts
            attr.attribute(wall, pending.attr_weights,
                           costattr.EP_AUDIT, costattr.PHASE_DISPATCH,
                           rows=pending.attr_rows)
        return pending

    def _dispatch_differential(self, flat):
        """Both lanes of one chunk in ONE hold of the dispatch lock: the
        reduced lane with the host's mask occupancy, then (unless the
        reduced plan already pinned the chunk to masks) the masks lane as
        ``pending.ref``.  The ``device.dispatch`` fault site is taken
        once per dispatch, as the JAX package takes it, but both times
        before the lock, so a ``hang`` never holds it."""
        site = "sweep_resident" if isinstance(flat, _ResidentChunk) \
            else "sweep"
        pinned = bool(flat.return_bits) and \
            self._hit_state_for(flat.kinds, flat.pad_n)["pinned"]
        for _ in range(1 if pinned else 2):
            fault_point("device.dispatch", lane=site, n=flat.n)
        with self._dispatch_lock:
            pending = self._sweep_dispatch_impl(flat, lane="reduced",
                                                host_occ=True, fault=False)
            if pending.lane == "reduced":
                pending.ref = self._sweep_dispatch_impl(
                    flat, lane="masks", fault=False)
                pending.lane = "differential"
                self._perf_add("differential_chunks", 1.0)
        return pending

    def warm_state(self) -> dict:
        """The persistable warm state (drivers/generation.WarmStateCache):
        the reduced lane's hit-buffer sizing per (kinds, padded N) and,
        after a :meth:`warm_pass`, the corpus column stats and width
        targets that decide the wire layout.  The JAX package's trace
        record has no counterpart here: nothing is traced."""
        with self._dispatch_lock:
            out = {"hit_state": {k: dict(v)
                                 for k, v in self._hit_state.items()}}
            if self._col_stats:
                out["col_stats"] = dict(self._col_stats)
            if self._width_targets:
                out["width_targets"] = dict(self._width_targets)
            return out

    def restore_warm_state(self, state: dict) -> int:
        """Adopt :meth:`warm_state` output; returns the hit-buffer entries
        restored."""
        with self._dispatch_lock:
            self._hit_state = {k: dict(v) for k, v in
                               (state.get("hit_state") or {}).items()}
            self._col_stats = dict(state.get("col_stats") or {})
            self._width_targets = dict(state.get("width_targets") or {})
            return len(self._hit_state)

    def _hit_state_for(self, kinds: tuple, pad_n: int) -> dict:
        key = (kinds, pad_n)
        st = self._hit_state.get(key)
        if st is None:
            st = self._hit_state[key] = {"cap": 256, "low": 0,
                                         "pinned": False, "blast": None}
        return st

    def _table_tensor(self, key: str, val, meter: str = "h2d_bytes",
                      device=None) -> torch.Tensor:
        """A shared lookup table on ``device`` (default: the first local
        shard's), from the per-device content cache."""
        device = device if device is not None else self.mesh.local[0][1]
        ckey = (str(device), key)
        hit = self._table_dev_cache.get(ckey)
        if hit is not None and (
                hit[0] is val
                or (hit[0].shape == val.shape and hit[0].dtype == val.dtype
                    and np.array_equal(hit[0], val))):
            return hit[1]
        dev = to_tensor(val, device)
        self._table_dev_cache[ckey] = (val, dev)
        self._perf_add(meter, float(val.nbytes))
        self._perf_add("h2d_copies", 1.0)
        self._perf_add("h2d_table_misses", 1.0)
        return dev

    def _param_tensors(self, tables: list, meter: str, device=None) -> list:
        """The dispatch's parameter tables on ``device`` (default: the
        first local shard's), from the per-device content cache when one
        dispatch before built the same tables; a miss uploads them (one
        copy per array, counted in ``h2d_param_misses``) and adds their
        bytes to ``perf[meter]``."""
        device = device if device is not None else self.mesh.local[0][1]
        arrs = [{name: np.asarray(v) for name, v in t.items()}
                for t in tables]
        key = (str(device),) + tuple(
            tuple((name, a.dtype.str, a.shape, a.tobytes())
                  for name, a in t.items()) for t in arrs)
        hit = self._param_dev_cache.pop(key, None)
        if hit is None:
            hit = [{name: to_tensor(a, device) for name, a in t.items()}
                   for t in arrs]
            self._perf_add(meter, float(sum(a.nbytes for t in arrs
                                            for a in t.values())))
            copies = float(sum(len(t) for t in arrs))
            self._perf_add("h2d_copies", copies)
            self._perf_add("h2d_param_misses", copies)
        self._param_dev_cache[key] = hit  # re-insert: most recent last
        while len(self._param_dev_cache) > _PARAM_CACHE_CAP * len(
                {str(d) for _s, d in self.mesh.local}):
            self._param_dev_cache.pop(next(iter(self._param_dev_cache)))
        return hit

    def _staging(self, shape: tuple, dtype: torch.dtype,
                 keep: list) -> torch.Tensor:
        """A host tensor to fill for one upload: page-locked on a CUDA
        device (so the copy runs without a blocking bounce) and appended
        to ``keep``, which the pending chunk holds until its collect."""
        t = torch.empty(shape, dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        keep.append(t)
        return t

    def _put(self, staged: torch.Tensor, device=None) -> torch.Tensor:
        """One host-to-device copy of a staged tensor to ``device``
        (default: the evaluator's; a no-op on the CPU), counted in
        ``h2d_copies`` with its bytes in ``h2d_bytes``."""
        self._perf_add("h2d_copies", 1.0)
        self._perf_add("h2d_bytes",
                       float(staged.numel() * staged.element_size()))
        return staged.to(device if device is not None else self.device,
                         non_blocking=True)

    def _spans(self, pad_n: int) -> list:
        """``(shard, lo, hi, device)`` of this process's shards: shard
        ``s`` of ``D`` holds rows ``[s * pad_n / D, (s + 1) * pad_n / D)``
        (a multiple of 8 rows: :meth:`_pad`)."""
        step = pad_n // self.mesh.size
        return [(s, s * step, (s + 1) * step, dev)
                for s, dev in self.mesh.local]

    def _upload_cols(self, cols: dict, pad_n: int, keep: list,
                     spans: Optional[list] = None) -> dict:
        """The chunk's per-object columns on the device: packed into one
        ``[pad_n, W]`` buffer per wire dtype (``pack_transfer_cols``,
        narrowed by the corpus stats of a :meth:`warm_pass`), each shard's
        rows of each buffer sent in one copy to the shard's device, then
        viewed back into columns there (``unpack_transfer_cols``).
        ``wire_pack`` times the packing, ``wire_bytes`` counts the
        buffers, ``h2d_col_buffers`` the copies.  Returns the columns of
        one shard covering every row, or with ``spans`` (from
        :meth:`_spans`) a list of each span's columns."""
        t0 = time.perf_counter()
        staged: dict = {}

        def alloc(dt, shape):
            staged[dt] = self._staging(shape, torch_dtype(dt), keep)
            arr = staged[dt].numpy()
            return arr.view(np.uint16) if dt == "<u2" else arr

        bufs, layout = pack_transfer_cols(cols, pad_n,
                                          stats=self._col_stats or None,
                                          alloc=alloc)
        self._perf_add("wire_pack", time.perf_counter() - t0)
        self._perf_add("wire_bytes",
                       float(sum(b.nbytes for b in bufs.values())))
        out = []
        for _s, lo, hi, dev in spans or [(0, 0, pad_n, self.device)]:
            self._perf_add("h2d_col_buffers", float(len(staged)))
            out.append(unpack_transfer_cols(
                {dt: self._put(t[lo:hi], dev) for dt, t in staged.items()},
                layout, hi - lo, device=dev))
        return out if spans is not None else out[0]

    def _upload_mask(self, bits: np.ndarray, budget_np, n: int,
                     keep: list, device=None) -> tuple:
        """(bool mask [C, n], int32 budget [C] or None) on ``device`` from
        ONE uint8 copy: the budget's bytes, then the bit-packed mask rows
        ``bits`` (``[C, n/8]``, a shard's columns of the chunk's packed
        mask), unpacked on the device."""
        head = 0 if budget_np is None else budget_np.nbytes
        st = self._staging((head + bits.size,), torch.uint8, keep)
        buf = st.numpy()
        if head:
            buf[:head] = budget_np.view(np.uint8)
        buf[head:] = bits.reshape(-1)
        self._perf_add("wire_bytes", float(buf.nbytes))
        self._perf_add("h2d_mask_copies", 1.0)
        dev = self._put(st, device)
        budget = dev[:head].view(torch.int32) if head else None
        mask = unpackbits(dev[head:].view(bits.shape), n)
        return mask, budget

    def _sweep_dispatch_impl(self, flat, lane: str = "masks",
                             host_occ: bool = False, fault: bool = True):
        """One chunk through one collect lane.  ``host_occ`` stores the
        host's per-constraint mask occupancy on the pending chunk (the
        differential lane's reference for the device ``occ``); ``fault``
        False when the caller already took the fault site."""
        if isinstance(flat, _ResidentChunk):
            # the reduced collect's masks-lane overflow fallback re-enters
            # here too
            return self._dispatch_resident_impl(flat, lane=lane,
                                                host_occ=host_occ,
                                                fault=fault)
        if fault:
            # before the lock: a hung dispatch must not hold it
            fault_point("device.dispatch", lane="sweep", n=flat.n)
        with self._dispatch_lock:
            self.dispatch_count += 1
            kinds = flat.kinds
            pad_n = flat.pad_n
            progs = flat.programs if flat.programs is not None \
                else self.driver._programs
            t0 = time.perf_counter()
            tables, offsets, c_off = self._param_tables(flat, progs)
            sources = [flat.source] * len(flat.objects)
            mask_rows = [masks_mod.constraint_masks(
                flat.by_kind[kind], flat.batch, self.driver.vocab,
                flat.objects, sources=sources,
                any_generate_name=flat.any_gen)
                for kind in kinds]
            self._perf_add("masks", time.perf_counter() - t0)
            plan = self._fold_plan(flat, lane, c_off)
            attr_rows = None
            if plan[0] != "reduced" and costattr.active() is not None:
                # live (constraint, object) mask cells per template from
                # the host masks; +1 keeps an all-masked template visible
                attr_rows = {k: int(m.sum())
                             for k, m in zip(kinds, mask_rows)}
            t0 = time.perf_counter()
            keep: list = []
            spans = self._spans(pad_n)
            cols_devs = self._upload_cols(flat.cols, pad_n, keep, spans)
            shared = self._shared_tables(kinds, progs, flat.batch)
            bits = np.packbits(np.concatenate(mask_rows, axis=0), axis=1)
            shards = []
            for (s, lo, hi, dev), cols_dev in zip(spans, cols_devs):
                for key, val in shared.items():
                    cols_dev[key] = self._table_tensor(key, val, device=dev)
                params_dev = self._param_tensors(tables, "h2d_bytes", dev)
                mask, budget = self._upload_mask(
                    bits[:, lo // 8: hi // 8], plan[2], hi - lo, keep, dev)
                shards.append((s, hi - lo, cols_dev, params_dev, mask,
                               budget))
            self._perf_add("upload", time.perf_counter() - t0)
            t0 = time.perf_counter()
            parts = []
            for s, n_s, cols_dev, params_dev, mask, budget in shards:
                # each shard's grid over its own rows, folded by the
                # hand-written kernels on the shard's device
                raw = torch.cat([progs[kind].grid(params_dev[i], cols_dev,
                                                  n_s)
                                 for i, kind in enumerate(kinds)], dim=0)
                parts.append(self._fold(raw, mask, plan, budget, n_s, s))
            pending = self._pending(flat, plan, offsets, parts)
            pending.staging = keep
            if host_occ:
                pending.host_occ = np.concatenate(
                    [m.sum(axis=1, dtype=np.int64) for m in mask_rows]
                ).astype(np.int32)
            if attr_rows is not None:
                pending.attr_rows = attr_rows
                pending.attr_weights = {k: 1.0 + r
                                        for k, r in attr_rows.items()}
            self._perf_add("dispatch", time.perf_counter() - t0)
            return pending

    def _dispatch_resident_impl(self, flat, lane: str = "masks",
                                host_occ: bool = False, fault: bool = True):
        """Resident twin of :meth:`_sweep_dispatch_impl`: no host masks
        (they live in the resident mirror), no column pack, no column
        upload.  What may still cross to the device is the parameter
        tables (content cache), the vocab/inventory tables (content
        cache), the gather index vector (cached per position tuple) and,
        on the budgeted reduced lane, the budget; each byte lands in
        ``perf["resident_h2d_bytes"]``, so a warm pass over unchanged rows
        reads 0.  ``host_occ``: the HOST mirror's occupancy over the
        chunk's rows, which the differential lane holds the device ``occ``
        against (so a resident mask that drifted from its mirror shows)."""
        if fault:
            fault_point("device.dispatch", lane="sweep_resident", n=flat.n)
        with self._dispatch_lock:
            self.dispatch_count += 1
            rg = flat.rg
            kinds = flat.kinds
            pad_n = flat.pad_n
            progs = flat.programs if flat.programs is not None \
                else self.driver._programs
            meter = "resident_h2d_bytes"
            t0 = time.perf_counter()
            tables, offsets, c_off = self._param_tables(flat, progs)
            tables_dev = {key: self._table_tensor(key, val, meter)
                          for key, val in self._shared_tables(
                              kinds, progs).items()}
            params_dev = self._param_tensors(tables, meter)
            idx_dev, idx_bytes = rg.chunk_idx(flat.positions, pad_n)
            self._perf_add(meter, float(idx_bytes))
            plan = self._fold_plan(flat, lane, c_off)
            budget = plan[2]  # crosses in _reduce
            if budget is not None:
                self._perf_add(meter, float(budget.nbytes))
                self._perf_add("h2d_copies", 1.0)
            self._perf_add("upload", time.perf_counter() - t0)
            t0 = time.perf_counter()
            cols, mask = gather_resident(idx_dev, rg.cols_dev, rg.mask_dev,
                                         rg.cols_layout, pad_n)
            cols.update(tables_dev)
            raw = torch.cat([progs[kind].grid(params_dev[i], cols, pad_n)
                             for i, kind in enumerate(kinds)], dim=0)
            pending = self._pending(
                flat, plan, offsets,
                [self._fold(raw, mask, plan, budget, pad_n, 0)])
            if host_occ:
                pos = np.asarray(flat.positions, np.intp)
                pending.host_occ = rg.mask_host[:, pos].sum(
                    axis=1, dtype=np.int64).astype(np.int32)
            self._perf_add("dispatch", time.perf_counter() - t0)
            return pending

    def _param_tables(self, flat, progs) -> tuple:
        """(parameter tables, kind -> (row lo, row hi), C) of one dispatch,
        in grid order.  Built before :meth:`_shared_tables`: they register
        StrPred needle rows that the vocab tables must include."""
        tables = []
        offsets = {}
        c_off = 0
        for kind in flat.kinds:
            cons = flat.by_kind[kind]
            tables.append(build_param_table(progs[kind].program, cons,
                                            self.driver.vocab))
            offsets[kind] = (c_off, c_off + len(cons))
            c_off += len(cons)
        return tables, offsets, c_off

    def _shared_tables(self, kinds, progs, batch=None) -> dict:
        """The lookup tables the kinds' programs read: the external-data
        join tables of ``batch`` (``ext:`` keys; a resident chunk has no
        host batch, and the residency declines groups with such joins),
        then the vocab and inventory tables (``fn:``/``st:``/``inv:``).
        The ``ext:`` tables come FIRST: the lane's bulk fetch lands the
        chunk's deduped keys and the table build interns value strings,
        which the vocab tables built after must cover."""
        out: dict = {}
        if batch is not None:
            t0 = time.perf_counter()
            for kind in kinds:
                out.update(self.driver.extdata_cols(kind, batch,
                                                    programs=progs)[0])
            if out:
                self._perf_add("extdata", time.perf_counter() - t0)
        for kind in kinds:
            out.update(vocab_tables(progs[kind].program, self.driver.vocab))
            out.update(self.driver.inventory_cols(kind, programs=progs)[0])
        return out

    def _fold_plan(self, flat, lane: str, c_off: int) -> tuple:
        """(lane, complete, budget, hit_cap) of one chunk's fold: the
        collect lane it takes, whether it ships every hit, the reduced
        lane's per-constraint kept budget (int32 [C], or None) and its hit
        buffer size."""
        kinds, pad_n, by_kind = flat.kinds, flat.pad_n, flat.by_kind
        complete = bool(flat.return_bits)
        if lane == "reduced" and complete \
                and self._hit_state_for(kinds, pad_n)["pinned"]:
            # dense corpus: complete hit coordinates would outweigh the
            # bit grid — this (kinds, pad) shape ships masks from now on
            lane = "masks"
        if lane != "reduced":
            return lane, complete, None, 0
        k_eff = min(self.violations_limit, pad_n)
        if complete:
            st = self._hit_state_for(kinds, pad_n)
            return lane, complete, None, min(st["cap"], c_off * pad_n)
        if flat.budget is None:
            budget_np = np.full(c_off, k_eff, np.int32)
        else:
            budget_np = np.fromiter(
                (min(k_eff, max(0, int(flat.budget(con))))
                 for kind in kinds for con in by_kind[kind]),
                np.int32, count=c_off)
        # buffer sizing by the PREVIOUS chunk's observed selection (2x
        # margin); a chunk that selects more overflows into the masks-lane
        # fallback once and resizes
        need = int(budget_np.sum())
        blast = self._hit_state_for(kinds, pad_n)["blast"]
        guess = need if blast is None else \
            min(need, max(_HIT_STEPS[1], 2 * blast))
        return lane, complete, budget_np, hit_bucket(guess, c_off * k_eff)

    def _fold(self, raw, mask, plan: tuple, budget, n: int,
              shard: int = 0) -> _Part:
        """One shard's device fold from its raw grid ``[C, n]`` and match
        mask on: the collect lane's fold (``plan`` from
        :meth:`_fold_plan`, ``budget`` its kept budget, see
        :meth:`_reduce`) through one fold kernel launch, as a
        :class:`_Part`.  On a CUDA device the result is copied into
        page-locked host memory and a CUDA event recorded after that copy
        (only the event under :meth:`sweep_warm`)."""
        k = self.violations_limit
        lane, complete, _budget_np, hit_cap = plan
        if lane == "reduced":
            result = self._reduce(raw, mask, budget, complete, hit_cap, k,
                                  n)
        else:
            grid = raw & mask
            idx, valid, counts = fold.epilogue(grid, k)
            packed = torch.cat([idx, valid.to(torch.int32), counts[:, None]],
                               dim=1)
            # bit-packed verdict rows: the exact hit set (exact totals)
            result = (packed, packbits(grid)) if complete else packed
        part = _Part(shard, result)
        if raw.device.type == "cuda":
            with torch.cuda.device(raw.device):
                if not self._no_fetch:
                    outs = result if isinstance(result, tuple) else (result,)
                    part.host = tuple(
                        torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t, non_blocking=True) for t in outs)
                part.event = torch.cuda.Event()
                part.event.record()
        return part

    @staticmethod
    def _pending(flat, plan: tuple, offsets: dict, parts: list):
        """The :class:`_PendingSweep` of one chunk's shard results."""
        lane, _complete, budget_np, hit_cap = plan
        if lane == "reduced":
            pending = _PendingSweep(parts, flat.kinds, offsets, flat.by_kind,
                                    flat.n, flat.return_bits,
                                    lane="reduced", pad_n=flat.pad_n,
                                    hit_cap=hit_cap, flat=flat)
            pending.budget_np = budget_np
            return pending
        return _PendingSweep(parts, flat.kinds, offsets, flat.by_kind,
                             flat.n, flat.return_bits, pad_n=flat.pad_n)

    def _reduce(self, raw, mask, budget, complete: bool, hit_cap: int,
                k: int, pad_n: int) -> torch.Tensor:
        """The device-side verdict REDUCTION: ``[counts|occ | nsel | hits]``
        as one int32 tensor (see the module docstring).  ``budget``: the
        budgeted lane's int32 [C], on the device or in numpy (uploaded
        here: the resident lane's)."""
        dev = raw.device
        c_total = raw.shape[0]
        if complete:
            grid = raw & mask
            counts = grid.sum(dim=1, dtype=torch.int32)
            occ = mask.sum(dim=1, dtype=torch.int32)
        else:
            # the fused fold kernel: mask -> totals -> first-k ->
            # occupancy in one pass over the raw grid
            idx, valid, counts, occ = fold.fused_fold(raw, mask, k)
        if pad_n <= 0xFFFF:
            # counts and occupancy are both <= pad_n: one u16|u16 word per
            # constraint (the int32 bit pattern of the uint32 word)
            word = counts.to(torch.int64) | (occ.to(torch.int64) << 16)
            head = [torch.where(word >= 2 ** 31, word - 2 ** 32,
                                word).to(torch.int32)]
        else:
            head = [counts, occ]
        sentinel = c_total * pad_n
        if complete:
            nsel = counts.sum()
            if hit_cap:
                # every set cell of the grid, row-major == canonical
                # (constraint, ascending index) order; fill coords sort last
                cols = torch.arange(pad_n, dtype=torch.int32,
                                    device=dev).expand(c_total, pad_n)
                hits = select_hits(grid, cols, hit_cap, pad_n, sentinel)
            else:
                hits = torch.zeros((0,), dtype=torch.int32, device=dev)
        else:
            k_eff = idx.shape[1]
            if not isinstance(budget, torch.Tensor):
                budget = to_tensor(budget, dev)
            want = torch.minimum(counts, budget)
            sel = valid & (torch.arange(k_eff, dtype=torch.int32,
                                        device=dev)[None, :] < want[:, None])
            nsel = sel.sum(dtype=torch.int32)
            if hit_cap:
                hits = select_hits(sel, idx, hit_cap, pad_n, sentinel)
            else:
                hits = torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.cat(head + [nsel.reshape(1).to(torch.int32), hits])

    def _fetch(self, pending) -> list:
        """Every mesh shard's result arrays (numpy, in shard order) of one
        chunk: this process's after each shard's CUDA event, from the
        page-locked copies the dispatch enqueued (the wait releases the
        interpreter lock; on the CPU the tensors themselves), counted in
        ``d2h_bytes``; with a mesh over processes, every rank's through
        one gather (``gather`` seconds, ``gather_bytes``)."""
        local = []
        nbytes = 0
        for part in pending.parts:
            if part.host is not None:
                part.event.synchronize()
                arrs = [t.numpy() for t in part.host]
            else:
                res = part.result
                outs = res if isinstance(res, tuple) else (res,)
                arrs = [t.cpu().numpy() for t in outs]
            nbytes += sum(a.nbytes for a in arrs)
            local.append((part.shard, arrs))
        pending.staging = None
        self._perf_add("d2h_bytes", float(nbytes))
        if self.mesh.spans_processes:
            self._gathers += 1
            local, dt = distributed.gather_shards(
                local, (self._gathers, pending.lane, pending.kinds,
                        pending.n, pending.pad_n))
            self._perf_add("gather", dt)
            self._perf_add("gathers", 1.0)
            self._perf_add("gather_bytes", float(nbytes))
        return [arrs for _s, arrs in sorted(local, key=lambda x: x[0])]

    def _merge_masks(self, shards: list, pad_n: int,
                     return_bits: bool) -> tuple:
        """(packed [C, 2k+1], bits [C, pad_n/8] or None) of the whole chunk
        from its shards' masks-lane results: totals summed, each shard's
        first-k offset by its first row and concatenated in shard order,
        the first ``min(k, pad_n)`` valid slots kept (lowest index first),
        the bit rows joined (every shard holds a multiple of 8 rows)."""
        n_s = pad_n // len(shards)
        k_eff = min(self.violations_limit, pad_n)
        idx_parts, valid_parts = [], []
        counts = None
        for s, arrs in enumerate(shards):
            p = arrs[0]
            ks = (p.shape[1] - 1) // 2
            valid = p[:, ks: 2 * ks] != 0
            idx_parts.append(np.where(valid, p[:, :ks] + s * n_s, 0))
            valid_parts.append(valid)
            c = p[:, 2 * ks].astype(np.int64)
            counts = c if counts is None else counts + c
        idx = np.concatenate(idx_parts, axis=1)
        valid = np.concatenate(valid_parts, axis=1)
        # valid slots first, each shard's in its order: the merged first-k
        order = np.argsort(~valid, axis=1, kind="stable")[:, :k_eff]
        idx = np.take_along_axis(idx, order, axis=1)
        valid = np.take_along_axis(valid, order, axis=1)
        packed = np.concatenate(
            [np.where(valid, idx, 0), valid.astype(np.int32),
             counts.astype(np.int32)[:, None]], axis=1).astype(np.int32)
        bits = np.concatenate([a[1] for a in shards], axis=1) \
            if return_bits else None
        return packed, bits

    def sweep_collect(self, pending):
        """Fetch + unpack a submitted sweep (the single device->host
        transfer)."""
        if pending is None:
            return {}
        if isinstance(pending, dict):  # empty submit
            return pending
        with tracing.span("device.sweep_collect", n=pending.n):
            if pending.lane == "differential":
                return self._collect_differential(pending)
            if pending.lane == "reduced":
                return self._collect_reduced(pending)
            return self._collect_masks(pending)

    def _collect_masks(self, pending):
        t0 = time.perf_counter()
        shards = self._fetch(pending)
        if len(shards) == 1:
            packed_np = shards[0][0]
            bits_np = shards[0][1] if pending.return_bits else None
        else:
            packed_np, bits_np = self._merge_masks(
                shards, pending.pad_n, pending.return_bits)
        # k is clipped to the padded batch width; recover the effective k
        # from the packed layout [idx(k') | valid(k') | count]
        k_eff = (packed_np.shape[1] - 1) // 2
        n = pending.n
        out = {}
        for kind in pending.kinds:
            lo, hi = pending.offsets[kind]
            idx_np = packed_np[lo:hi, :k_eff]
            valid_np = (packed_np[lo:hi, k_eff: 2 * k_eff] != 0) \
                & (idx_np < n)
            counts_np = packed_np[lo:hi, 2 * k_eff]
            kb = bits_np[lo:hi] if bits_np is not None else None
            out[kind] = (pending.by_kind[kind], idx_np, valid_np, counts_np,
                         kb)
        self._perf_add("collect", time.perf_counter() - t0)
        return out

    @staticmethod
    def _kept_from_hits(sub: np.ndarray, ck: int, pad_n: int, k_eff: int,
                        n: int) -> tuple:
        """(idx [ck, k_eff], valid) rebuilt from a kind's sorted local
        hit coords — the masks-lane layout, so every fold runs unchanged."""
        idx = np.zeros((ck, k_eff), np.int32)
        valid = np.zeros((ck, k_eff), bool)
        if sub.size:
            ci = (sub // pad_n).astype(np.intp)
            oi = (sub % pad_n).astype(np.int32)
            starts = np.searchsorted(ci, np.arange(ck))
            j = np.arange(sub.size) - starts[ci]
            ok = (j < k_eff) & (oi < n)
            idx[ci[ok], j[ok]] = oi[ok]
            valid[ci[ok], j[ok]] = True
        return idx, valid

    def _collect_reduced(self, pending, _aux: bool = False):
        """Unpack one device-reduced chunk result; occupancy-weighted cost
        attribution from the fused fold's ``occ``; masks-lane fallback when
        the hit buffer overflowed, adaptive buffer sizing for the chunks
        after it.  ``_aux`` (the differential lane) returns ``(out, occ)``
        with the device occupancy per constraint, or ``(out, None)`` after
        an overflow fallback."""
        t0 = time.perf_counter()
        shards = self._fetch(pending)
        c_total = max(hi for _lo, hi in pending.offsets.values())
        pad_n, n = pending.pad_n, pending.n
        complete = pending.return_bits
        n_s = pad_n // len(shards)
        dec = [self._decode_reduced(a[0], c_total, n_s) for a in shards]
        if len(dec) == 1:
            counts_all, occ_all, nsel, hits = dec[0]
        else:
            # every decision below reads the merged values (the largest
            # shard selection for the buffer), so every rank takes it
            counts_all = sum(d[0] for d in dec).astype(np.int32)
            occ_all = sum(d[1] for d in dec).astype(np.int32)
            nsel = max(d[2] for d in dec)
            if nsel <= pending.hit_cap:
                hits = self._merge_hits(dec, pad_n, counts_all,
                                        None if complete
                                        else pending.budget_np)
        st = self._hit_state_for(pending.kinds, pad_n)
        if not complete:
            # budgeted buffer sizing feedback for the NEXT chunk
            st["blast"] = nsel
        if nsel > pending.hit_cap:
            # the chunk's true hit count overflowed the buffer: re-dispatch
            # THIS chunk through the masks lane (always complete), and grow
            # — or, past the point where coordinates outweigh the grid,
            # pin — the shape's buffer
            self._perf_add("collect_fallbacks", 1.0)
            if complete:
                cap = 256
                while cap < 2 * nsel:
                    cap *= 2
                if 4 * cap > (c_total * n_s) // 8:
                    st["pinned"] = True
                else:
                    st["cap"] = cap
                st["low"] = 0
            flat, pending.flat = pending.flat, None
            fb = self._sweep_dispatch_impl(flat, lane="masks")
            attr = costattr.active()
            if attr is not None and fb.attr_weights:
                # the overflowed chunk's dispatch wall, by the host masks
                # of its re-dispatch
                attr.attribute(pending.dispatch_wall, fb.attr_weights,
                               costattr.EP_AUDIT, costattr.PHASE_DISPATCH,
                               rows=fb.attr_rows)
            out = self._collect_masks(fb)
            return (out, None) if _aux else out
        if complete and not st["pinned"]:
            # de-escalate a buffer the corpus stopped filling (16-chunk
            # hysteresis)
            if st["cap"] > 256 and 4 * nsel < st["cap"]:
                st["low"] += 1
                if st["low"] >= 16:
                    st["cap"] //= 2
                    st["low"] = 0
            else:
                st["low"] = 0
        if len(dec) == 1:
            hits = hits[: min(nsel, hits.size)]
        k_eff = min(self.violations_limit, pad_n)
        out = {}
        for kind in pending.kinds:
            lo, hi = pending.offsets[kind]
            ck = hi - lo
            sub = (hits[(hits >= lo * pad_n) & (hits < hi * pad_n)]
                   .astype(np.int64) - lo * pad_n)
            idx_np, valid_np = self._kept_from_hits(sub, ck, pad_n,
                                                    k_eff, n)
            kb = HitRows(sub, pad_n, n, ck) if complete else None
            out[kind] = (pending.by_kind[kind], idx_np, valid_np,
                         counts_all[lo:hi], kb)
        attr = costattr.active()
        if attr is not None and pending.dispatch_wall > 0:
            # the device's occupancy counts apportion the dispatch wall as
            # the masks lane's host sums do
            rows = {kind: int(occ_all[lo:hi].sum())
                    for kind, (lo, hi) in pending.offsets.items()}
            attr.attribute(pending.dispatch_wall,
                           {kind: 1.0 + r for kind, r in rows.items()},
                           costattr.EP_AUDIT, costattr.PHASE_DISPATCH,
                           rows=rows)
        pending.flat = None
        self._perf_add("collect", time.perf_counter() - t0)
        return (out, occ_all) if _aux else out

    def _collect_differential(self, pending):
        """``collect="differential"``: the reduced result must equal the
        masks lane's host fold bit for bit — totals, the hit rows of
        exact-totals chunks, the kept selection (the first min(count,
        budget, k) hits) and the device occupancy against the host mask
        sums.  Raises ``RuntimeError`` on the first difference; returns the
        masks lane's result."""
        ref = self._collect_masks(pending.ref)
        out, occ = self._collect_reduced(pending, _aux=True)
        if occ is None:
            # the reduced side overflowed and re-dispatched through the
            # masks lane: two masks folds are compared (still a check of
            # the dispatch's determinism)
            self._perf_add("collect_differential_fallbacks", 1.0)
        elif pending.host_occ is not None and \
                not np.array_equal(occ, pending.host_occ):
            raise RuntimeError(
                "collect differential: device occupancy != host mask "
                f"occupancy ({occ.tolist()[:8]} vs "
                f"{pending.host_occ.tolist()[:8]})")
        n = pending.n
        for kind, (cons, idx_m, valid_m, counts_m, bits_m) in ref.items():
            _cons_r, idx_r, valid_r, counts_r, kb_r = out[kind]
            if not np.array_equal(np.asarray(counts_m),
                                  np.asarray(counts_r)):
                raise RuntimeError(
                    f"collect differential: totals differ for {kind}")
            for ci in range(len(cons)):
                if bits_m is not None:
                    ref_rows = violation_rows(bits_m, ci, n)
                    if kb_r is not None and not np.array_equal(
                            ref_rows, violation_rows(kb_r, ci, n)):
                        raise RuntimeError(
                            "collect differential: hit rows differ for "
                            f"{kind}[{ci}]")
                else:
                    ref_rows = np.asarray(idx_m[ci])[
                        np.asarray(valid_m[ci])]
                # the reduced lane keeps the FIRST min(count, budget, k)
                # canonical hits; the masks selection clipped alike must
                # agree exactly
                want = int(np.asarray(counts_m)[ci])
                bud = pending.budget_np
                if bud is not None:
                    lo = pending.offsets[kind][0]
                    want = min(want, int(bud[lo + ci]))
                want = min(want, idx_r.shape[1])
                kept_ref = np.sort(ref_rows[:want]) if want else \
                    np.zeros(0, np.int64)
                kept_red = np.sort(idx_r[ci][valid_r[ci]])
                if not np.array_equal(kept_ref,
                                      kept_red.astype(np.int64)):
                    raise RuntimeError(
                        "collect differential: kept selection differs "
                        f"for {kind}[{ci}]")
        self._perf_add("collect_differential_ok", 1.0)
        return ref

    @staticmethod
    def _decode_reduced(arr: np.ndarray, c_total: int, n: int) -> tuple:
        """(counts, occ, nsel, hits) of one shard's reduced result over
        ``n`` rows (``[counts|occ | nsel | hits]``, see :meth:`_reduce`)."""
        if n <= 0xFFFF:
            co = arr[:c_total].view(np.uint32)
            counts = (co & 0xFFFF).astype(np.int32)
            occ = (co >> 16).astype(np.int32)
            base = c_total
        else:
            counts = arr[:c_total]
            occ = arr[c_total: 2 * c_total]
            base = 2 * c_total
        return counts, occ, int(arr[base]), arr[base + 1:]

    @staticmethod
    def _merge_hits(dec: list, pad_n: int, counts: np.ndarray,
                    budget_np) -> np.ndarray:
        """The chunk's hit coordinates (``ci * pad_n + oi``, sorted) from
        its shards' decoded results: each shard's local coordinates moved
        to its rows, in canonical order; with a kept budget, each
        constraint's first ``min(count, budget)`` (every shard selected up
        to the whole budget)."""
        n_s = pad_n // len(dec)
        parts = []
        for s, (_c, _o, nsel, hits) in enumerate(dec):
            h = hits[:nsel].astype(np.int64)
            parts.append((h // n_s) * pad_n + s * n_s + h % n_s)
        flat = np.sort(np.concatenate(parts))
        if budget_np is not None and flat.size:
            ci = flat // pad_n
            starts = np.searchsorted(ci, np.arange(len(counts)))
            j = np.arange(flat.size) - starts[ci]
            want = np.minimum(budget_np.astype(np.int64), counts)
            flat = flat[j < want[ci]]
        return flat.astype(np.int32)

    def _pad(self, n: int) -> int:
        """The padded rows of an ``n``-object chunk: ``8 * D`` doubled
        until it covers ``n`` (``D`` = the mesh's data shards), so each
        shard holds a multiple of 8 rows and the mask's bit rows split on
        byte boundaries."""
        p = self.mesh.shape["data"] * 8
        while p < n:
            p *= 2
        return p
