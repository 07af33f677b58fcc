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

Sweep inputs: a chunk of listed objects (``sweep_flatten``), rows of the
resident snapshot's host columns (``sweep_flatten_from_batch``), or rows
of a device-resident snapshot group (``sweep_flatten_resident``: the
columns and match masks already live on the device as the stats-free
``pack_transfer_cols`` buffers of ``snapshot/device_residency.py``; the
chunk gathers them by an index vector on the device, and both collect
lanes fold the gathered grid exactly as they fold a host chunk's).

Not ported here: multi-device meshes, the stats branch of
``pack_transfer_cols`` (wire narrowing), the differential collect lane,
warm state, flatten workers, tracing/metrics/cost attribution.
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
from gatekeeper_tpu_torch.ops import fold
from gatekeeper_tpu_torch.ops.flatten import Flattener, Schema


COLLECT_LANES = ("reduced", "masks")

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
                 "<f4": torch.float32, "<f8": torch.float32}

_PARAM_CACHE_CAP = 32  # parameter-table sets kept on the device


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
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=bits.device)
    out = (bits[..., None] >> shifts) & 1
    return out.reshape(bits.shape[0], -1)[:, :n].to(torch.bool)


def packbits(grid: torch.Tensor) -> torch.Tensor:
    """``np.packbits(grid, axis=1)`` (uint8, MSB first), on the device."""
    c, n = grid.shape
    pad = (-n) % 8
    g = grid.to(torch.uint8)
    if pad:
        g = torch.nn.functional.pad(g, (0, pad))
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=grid.device)
    return (g.reshape(c, -1, 8) << shifts).sum(dim=-1).to(torch.uint8)


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


def pack_transfer_cols(cols: dict, pad_n: int,
                       stats: Optional[dict] = None) -> tuple:
    """Pack every per-object column into ONE ``[pad_n, W]`` buffer per
    dtype (port of ``gatekeeper_tpu/parallel/sharded.py``, the
    ``stats=None`` layout only).

    The layout is a grouping by dtype: each column occupies ``w`` columns
    of its dtype's buffer at offset ``off`` (a ``[pad_n, *tail]`` column
    flattens to ``w = prod(tail)``), with no narrowing, no constant
    elision and no dictionary remap, so every row set of one schema packs
    to the same layout.  The same numpy array under two keys (prefix-axis
    dedup, ``ops/flatten.dedup_schema``) packs once and becomes an
    ``alias`` entry.  Table columns (``fn:``/``st:``/``inv:``/``ext:``)
    are left out.

    Returns ``({dtype_str: buf}, layout)``, layout a tuple of
    ``(key, sub, dtype_str | "alias", off, tail, w, dtype_str,
    0 | (alias key, alias sub))``.  ``stats`` selects the wire-narrowing
    branch, which is not ported (ROADMAP queue 1 item 6): it raises."""
    if stats is not None:
        raise NotImplementedError(
            "pack_transfer_cols: the stats branch (wire narrowing, constant "
            "elision, dictionary remap) is not ported (ROADMAP queue 1 "
            "item 6)")
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
            w = int(np.prod(tail, dtype=np.int64)) if a.ndim > 1 else 1
            off = widths.get(dt, 0)
            parts.setdefault(dt, []).append(a.reshape(pad_n, w))
            layout.append((key, sub, dt, off, tail, w, dt, 0))
            widths[dt] = off + w
    bufs = {dt: np.concatenate(ps, axis=1) for dt, ps in parts.items()}
    return bufs, tuple(layout)


def unpack_transfer_cols(bufs: dict, layout: tuple, pad_n: int) -> dict:
    """The cols dict back from :func:`pack_transfer_cols` buffers (numpy
    or tensors): every column is a slice of its dtype's buffer viewed to
    ``[n, *tail]`` (no copy), and an alias entry is the SAME object as
    the column it names."""
    cols: dict = {}
    aliases: list = []
    for key, sub, wdt, off, tail, w, _dt, extra in layout:
        if wdt == "alias":
            aliases.append((key, sub, extra))
            continue
        buf = bufs[wdt]
        arr = buf[:, off: off + w].reshape((buf.shape[0],) + tuple(tail))
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


class _PendingSweep:
    __slots__ = ("result", "kinds", "offsets", "by_kind", "n",
                 "return_bits", "lane", "pad_n", "hit_cap", "flat",
                 "event")

    def __init__(self, result, kinds, offsets, by_kind, n, return_bits,
                 lane="masks", pad_n=0, hit_cap=0, flat=None):
        self.result = result
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
        # CUDA event recorded after the dispatch (None on the CPU)
        self.event = None

    def ready(self) -> bool:
        """True when the device result needs no further wait."""
        return self.event is None or self.event.query()


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
    """Runs a TorchDriver's compiled programs over sweep chunks on one
    device.  Reuses the driver's vocab so interned ids agree with the
    driver's parameter tables."""

    renders = False  # kept violations render in the audit manager

    def __init__(self, driver, device: str = "cuda",
                 violations_limit: int = 20, flatten_lane: str = "auto",
                 collect: str = "reduced"):
        self.driver = driver
        self.device = resolve_device(device)
        self.violations_limit = violations_limit
        # how sweep chunks columnize (ops/flatten.py FLATTEN_LANES)
        self.flatten_lane = flatten_lane
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
        self._bucket = 2
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
                         lane=self.flatten_lane)

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
        batch = fl.flatten(objects, pad_n=pad_n)
        self._perf_add("flatten", time.perf_counter() - t0)
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
        return self._sweep_dispatch_impl(flat, lane=self.collect)

    def _hit_state_for(self, kinds: tuple, pad_n: int) -> dict:
        key = (kinds, pad_n)
        st = self._hit_state.get(key)
        if st is None:
            st = self._hit_state[key] = {"cap": 256, "low": 0,
                                         "pinned": False, "blast": None}
        return st

    def _table_tensor(self, key: str, val,
                      meter: str = "h2d_bytes") -> torch.Tensor:
        hit = self._table_dev_cache.get(key)
        if hit is not None and (
                hit[0] is val
                or (hit[0].shape == val.shape and hit[0].dtype == val.dtype
                    and np.array_equal(hit[0], val))):
            return hit[1]
        dev = to_tensor(val, self.device)
        self._table_dev_cache[key] = (val, dev)
        self._perf_add(meter, float(val.nbytes))
        return dev

    def _param_tensors(self, tables: list, meter: str) -> list:
        """The dispatch's parameter tables on the device, from the content
        cache when one dispatch before built the same tables; a miss
        uploads them and adds their bytes to ``perf[meter]``."""
        arrs = [{name: np.asarray(v) for name, v in t.items()}
                for t in tables]
        key = tuple(tuple((name, a.dtype.str, a.shape, a.tobytes())
                          for name, a in t.items()) for t in arrs)
        hit = self._param_dev_cache.pop(key, None)
        if hit is None:
            hit = [{name: to_tensor(a, self.device) for name, a in t.items()}
                   for t in arrs]
            self._perf_add(meter, float(sum(a.nbytes for t in arrs
                                            for a in t.values())))
        self._param_dev_cache[key] = hit  # re-insert: most recent last
        while len(self._param_dev_cache) > _PARAM_CACHE_CAP:
            self._param_dev_cache.pop(next(iter(self._param_dev_cache)))
        return hit

    def _upload_cols(self, cols: dict) -> dict:
        out: dict = {}
        nbytes = 0
        for key, val in cols.items():
            if is_table_key(key):
                out[key] = self._table_tensor(key, val)
            elif isinstance(val, dict):
                out[key] = {k: to_tensor(v, self.device)
                            for k, v in val.items()}
                nbytes += sum(np.asarray(v).nbytes for v in val.values())
            else:
                out[key] = to_tensor(val, self.device)
                nbytes += np.asarray(val).nbytes
        self._perf_add("h2d_bytes", float(nbytes))
        return out

    def _sweep_dispatch_impl(self, flat, lane: str = "masks"):
        if isinstance(flat, _ResidentChunk):
            # the reduced collect's masks-lane overflow fallback re-enters
            # here too
            return self._dispatch_resident_impl(flat, lane=lane)
        kinds = flat.kinds
        pad_n = flat.pad_n
        progs = flat.programs if flat.programs is not None \
            else self.driver._programs
        t0 = time.perf_counter()
        tables, offsets, c_off = self._param_tables(flat, progs)
        sources = [flat.source] * len(flat.objects)
        mask_rows = [masks_mod.constraint_masks(
            flat.by_kind[kind], flat.batch, self.driver.vocab, flat.objects,
            sources=sources, any_generate_name=flat.any_gen)
            for kind in kinds]
        self._perf_add("masks", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cols_dev = self._upload_cols({**flat.cols,
                                      **self._shared_tables(kinds, progs)})
        params_dev = self._param_tensors(tables, "h2d_bytes")
        # the match mask travels bit-packed ([C, pad_n/8] uint8) and
        # unpacks on the device
        mask_bits = np.packbits(np.concatenate(mask_rows, axis=0), axis=1)
        mask = unpackbits(to_tensor(mask_bits, self.device), pad_n)
        self._perf_add("h2d_bytes", float(mask_bits.nbytes))
        self._perf_add("upload", time.perf_counter() - t0)
        t0 = time.perf_counter()
        raw = torch.cat([progs[kind].grid(params_dev[i], cols_dev, pad_n)
                         for i, kind in enumerate(kinds)], dim=0)
        pending = self._fold(flat, raw, mask, lane, offsets, c_off,
                             "h2d_bytes")
        self._perf_add("dispatch", time.perf_counter() - t0)
        return pending

    def _dispatch_resident_impl(self, flat, lane: str = "masks"):
        """Resident twin of :meth:`_sweep_dispatch_impl`: no host masks
        (they live in the resident mirror), no column pack, no column
        upload.  What may still cross to the device is the parameter
        tables (content cache), the vocab/inventory tables (content
        cache), the gather index vector (cached per position tuple) and,
        on the budgeted reduced lane, the budget; each byte lands in
        ``perf["resident_h2d_bytes"]``, so a warm pass over unchanged rows
        reads 0."""
        rg = flat.rg
        kinds = flat.kinds
        pad_n = flat.pad_n
        progs = flat.programs if flat.programs is not None \
            else self.driver._programs
        meter = "resident_h2d_bytes"
        t0 = time.perf_counter()
        tables, offsets, c_off = self._param_tables(flat, progs)
        tables_dev = {key: self._table_tensor(key, val, meter)
                      for key, val in self._shared_tables(kinds,
                                                          progs).items()}
        params_dev = self._param_tensors(tables, meter)
        idx_dev, idx_bytes = rg.chunk_idx(flat.positions, pad_n)
        self._perf_add(meter, float(idx_bytes))
        self._perf_add("upload", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cols, mask = gather_resident(idx_dev, rg.cols_dev, rg.mask_dev,
                                     rg.cols_layout, pad_n)
        cols.update(tables_dev)
        raw = torch.cat([progs[kind].grid(params_dev[i], cols, pad_n)
                         for i, kind in enumerate(kinds)], dim=0)
        pending = self._fold(flat, raw, mask, lane, offsets, c_off, meter)
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

    def _shared_tables(self, kinds, progs) -> dict:
        """The vocab and inventory lookup tables the kinds' programs
        read (``fn:``/``st:``/``inv:`` keys)."""
        out: dict = {}
        for kind in kinds:
            out.update(vocab_tables(progs[kind].program, self.driver.vocab))
            out.update(self.driver.inventory_cols(kind, programs=progs)[0])
        return out

    def _fold(self, flat, raw, mask, lane: str, offsets: dict, c_off: int,
              meter: str):
        """The device side of both chunk kinds from the raw grid and the
        match mask on: the collect lane's fold, as a :class:`_PendingSweep`
        with a CUDA event recorded after it.  ``meter`` names the perf
        key that counts the budget's upload."""
        by_kind, kinds = flat.by_kind, flat.kinds
        n, pad_n, return_bits = flat.n, flat.pad_n, flat.return_bits
        k = self.violations_limit
        complete = bool(return_bits)
        if lane == "reduced" and complete \
                and self._hit_state_for(kinds, pad_n)["pinned"]:
            # dense corpus: complete hit coordinates would outweigh the
            # bit grid — this (kinds, pad) shape ships masks from now on
            lane = "masks"
        if lane == "reduced":
            k_eff = min(k, pad_n)
            if complete:
                budget_np = None
                st = self._hit_state_for(kinds, pad_n)
                hit_cap = min(st["cap"], c_off * pad_n)
            else:
                if flat.budget is None:
                    budget_np = np.full(c_off, k_eff, np.int32)
                else:
                    budget_np = np.fromiter(
                        (min(k_eff, max(0, int(flat.budget(con))))
                         for kind in kinds for con in by_kind[kind]),
                        np.int32, count=c_off)
                # buffer sizing by the PREVIOUS chunk's observed selection
                # (2x margin); a chunk that selects more overflows into the
                # masks-lane fallback once and resizes
                need = int(budget_np.sum())
                blast = self._hit_state_for(kinds, pad_n)["blast"]
                guess = need if blast is None else \
                    min(need, max(_HIT_STEPS[1], 2 * blast))
                hit_cap = hit_bucket(guess, c_off * k_eff)
                self._perf_add(meter, float(budget_np.nbytes))
            result = self._reduce(raw, mask, budget_np, complete, hit_cap,
                                  k, pad_n)
            pending = _PendingSweep(result, kinds, offsets, by_kind, n,
                                    return_bits, lane="reduced",
                                    pad_n=pad_n, hit_cap=hit_cap,
                                    flat=flat)
        else:
            grid = raw & mask
            idx, valid, counts = fold.epilogue(grid, k)
            packed = torch.cat([idx, valid.to(torch.int32), counts[:, None]],
                               dim=1)
            # bit-packed verdict rows: the exact hit set (exact totals)
            result = (packed, packbits(grid)) if return_bits else packed
            pending = _PendingSweep(result, kinds, offsets, by_kind, n,
                                    return_bits, pad_n=pad_n)
        if self.device.type == "cuda":
            pending.event = torch.cuda.Event()
            pending.event.record()
        return pending

    def _reduce(self, raw, mask, budget_np, complete: bool, hit_cap: int,
                k: int, pad_n: int) -> torch.Tensor:
        """The device-side verdict REDUCTION: ``[counts|occ | nsel | hits]``
        as one int32 tensor (see the module docstring)."""
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
            budget = to_tensor(budget_np, dev)
            want = torch.minimum(counts, budget)
            sel = valid & (torch.arange(k_eff, dtype=torch.int32,
                                        device=dev)[None, :] < want[:, None])
            nsel = sel.sum(dtype=torch.int32)
            if hit_cap:
                hits = select_hits(sel, idx, hit_cap, pad_n, sentinel)
            else:
                hits = torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.cat(head + [nsel.reshape(1).to(torch.int32), hits])

    def sweep_collect(self, pending):
        """Fetch + unpack a submitted sweep (the single device->host
        transfer)."""
        if pending is None:
            return {}
        if isinstance(pending, dict):  # empty submit
            return pending
        if pending.lane == "reduced":
            return self._collect_reduced(pending)
        return self._collect_masks(pending)

    def _collect_masks(self, pending):
        t0 = time.perf_counter()
        if pending.return_bits:
            packed_np = pending.result[0].cpu().numpy()
            bits_np = pending.result[1].cpu().numpy()
            self._perf_add("d2h_bytes", packed_np.nbytes + bits_np.nbytes)
        else:
            packed_np = pending.result.cpu().numpy()
            bits_np = None
            self._perf_add("d2h_bytes", packed_np.nbytes)
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

    def _collect_reduced(self, pending):
        """Unpack one device-reduced chunk result; masks-lane fallback when
        the hit buffer overflowed, adaptive buffer sizing for the chunks
        after it."""
        t0 = time.perf_counter()
        arr = pending.result.cpu().numpy()
        self._perf_add("d2h_bytes", arr.nbytes)
        c_total = max(hi for _lo, hi in pending.offsets.values())
        pad_n, n = pending.pad_n, pending.n
        if pad_n <= 0xFFFF:
            co = arr[:c_total].view(np.uint32)
            counts_all = (co & 0xFFFF).astype(np.int32)
            base = c_total
        else:
            counts_all = arr[:c_total]
            base = 2 * c_total
        nsel = int(arr[base])
        hits = arr[base + 1:]
        complete = pending.return_bits
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
                if 4 * cap > (c_total * pad_n) // 8:
                    st["pinned"] = True
                else:
                    st["cap"] = cap
                st["low"] = 0
            flat, pending.flat = pending.flat, None
            fb = self._sweep_dispatch_impl(flat, lane="masks")
            return self._collect_masks(fb)
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
        pending.flat = None
        self._perf_add("collect", time.perf_counter() - t0)
        return out

    def _pad(self, n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p
