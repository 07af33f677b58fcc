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

Not ported here: multi-device meshes, the stats branch of
``pack_transfer_cols`` (wire narrowing), the differential collect lane.
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
from gatekeeper_tpu_torch.resilience.faults import fault_point


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


def pack_transfer_cols(cols: dict, pad_n: int,
                       stats: Optional[dict] = None, alloc=None) -> tuple:
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
    0 | (alias key, alias sub))``.  ``alloc(dtype_str, shape)``, when
    given, returns the array each buffer is written into (the sweep's
    page-locked staging, of the buffer's device dtype: int64/float64
    columns narrow to int32/float32 in the copy, as ``torch_dtype``
    maps them); else each buffer is a new array of the columns' dtype.
    ``stats`` selects the wire-narrowing branch, which is not ported
    (ROADMAP queue 1 item 6): it raises."""
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
    bufs = {}
    for dt, ps in parts.items():
        if alloc is None:
            bufs[dt] = np.concatenate(ps, axis=1)
        else:
            bufs[dt] = np.concatenate(ps, axis=1, casting="same_kind",
                                      out=alloc(dt, (pad_n, widths[dt])))
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
                 "event", "host", "staging", "dispatch_wall",
                 "attr_weights", "attr_rows")

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
        # CUDA event recorded after the dispatch (None on the CPU), and
        # the page-locked host copies of ``result`` it covers
        self.event = None
        self.host = None
        # page-locked upload staging of the chunk: kept alive until the
        # collect, after the event has fired
        self.staging = None
        # cost attribution: the dispatch's wall (enqueue) and, on the masks
        # lane, the per-template host mask occupancy weights (the reduced
        # lane reads its weights off the device result at collect)
        self.dispatch_wall = 0.0
        self.attr_weights = None
        self.attr_rows = None

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
                 collect: str = "reduced", flatten_workers: int = 0,
                 metrics=None):
        self.driver = driver
        self.metrics = metrics
        self.device = resolve_device(device)
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
        t0 = time.perf_counter()
        with tracing.span("device.sweep_dispatch", n=flat.n,
                          kinds=len(flat.kinds), collect=self.collect):
            pending = self._sweep_dispatch_impl(flat, lane=self.collect)
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

    def warm_state(self) -> dict:
        """The persistable warm state (drivers/generation.WarmStateCache):
        the reduced lane's hit-buffer sizing per (kinds, padded N).  The
        JAX package's trace record, column statistics and width targets
        have no counterpart here: nothing is traced, and the wire is not
        narrowed."""
        with self._dispatch_lock:
            return {"hit_state": {k: dict(v)
                                  for k, v in self._hit_state.items()}}

    def restore_warm_state(self, state: dict) -> int:
        """Adopt :meth:`warm_state` output; returns the entries restored."""
        with self._dispatch_lock:
            self._hit_state = {k: dict(v) for k, v in
                               (state.get("hit_state") or {}).items()}
            return len(self._hit_state)

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
        self._perf_add("h2d_copies", 1.0)
        self._perf_add("h2d_table_misses", 1.0)
        return dev

    def _param_tensors(self, tables: list, meter: str) -> list:
        """The dispatch's parameter tables on the device, from the content
        cache when one dispatch before built the same tables; a miss
        uploads them (one copy per array, counted in ``h2d_param_misses``)
        and adds their bytes to ``perf[meter]``."""
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
            copies = float(sum(len(t) for t in arrs))
            self._perf_add("h2d_copies", copies)
            self._perf_add("h2d_param_misses", copies)
        self._param_dev_cache[key] = hit  # re-insert: most recent last
        while len(self._param_dev_cache) > _PARAM_CACHE_CAP:
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

    def _put(self, staged: torch.Tensor) -> torch.Tensor:
        """One host-to-device copy of a staged tensor (a no-op on the
        CPU), counted in ``h2d_copies`` with its bytes in ``h2d_bytes``."""
        self._perf_add("h2d_copies", 1.0)
        self._perf_add("h2d_bytes",
                       float(staged.numel() * staged.element_size()))
        return staged.to(self.device, non_blocking=True)

    def _upload_cols(self, cols: dict, pad_n: int, keep: list) -> dict:
        """The chunk's per-object columns on the device: packed into one
        ``[pad_n, W]`` buffer per dtype (``pack_transfer_cols``), each sent
        in one copy, then viewed back into columns on the device
        (``unpack_transfer_cols``).  ``wire_pack`` times the packing,
        ``wire_bytes`` counts the buffers, ``h2d_col_buffers`` the
        copies."""
        t0 = time.perf_counter()
        staged: dict = {}

        def alloc(dt, shape):
            staged[dt] = self._staging(shape, torch_dtype(dt), keep)
            return staged[dt].numpy()

        bufs, layout = pack_transfer_cols(cols, pad_n, alloc=alloc)
        self._perf_add("wire_pack", time.perf_counter() - t0)
        self._perf_add("wire_bytes",
                       float(sum(b.nbytes for b in bufs.values())))
        self._perf_add("h2d_col_buffers", float(len(staged)))
        return unpack_transfer_cols(
            {dt: self._put(t) for dt, t in staged.items()}, layout, pad_n)

    def _upload_mask(self, mask_rows: list, budget_np, pad_n: int,
                     keep: list) -> tuple:
        """(bool mask [C, pad_n], int32 budget [C] or None) on the device
        from ONE uint8 copy: the budget's bytes, then the bit-packed mask
        (``[C, pad_n/8]``), unpacked on the device."""
        bits = np.packbits(np.concatenate(mask_rows, axis=0), axis=1)
        head = 0 if budget_np is None else budget_np.nbytes
        st = self._staging((head + bits.size,), torch.uint8, keep)
        buf = st.numpy()
        if head:
            buf[:head] = budget_np.view(np.uint8)
        buf[head:] = bits.reshape(-1)
        self._perf_add("wire_bytes", float(buf.nbytes))
        self._perf_add("h2d_mask_copies", 1.0)
        dev = self._put(st)
        budget = dev[:head].view(torch.int32) if head else None
        mask = unpackbits(dev[head:].view(bits.shape), pad_n)
        return mask, budget

    def _sweep_dispatch_impl(self, flat, lane: str = "masks"):
        if isinstance(flat, _ResidentChunk):
            # the reduced collect's masks-lane overflow fallback re-enters
            # here too
            return self._dispatch_resident_impl(flat, lane=lane)
        # before the lock: a hung dispatch must not hold it
        fault_point("device.dispatch", lane="sweep", n=flat.n)
        with self._dispatch_lock:
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
            cols_dev = self._upload_cols(flat.cols, pad_n, keep)
            for key, val in self._shared_tables(kinds, progs,
                                                flat.batch).items():
                cols_dev[key] = self._table_tensor(key, val)
            params_dev = self._param_tensors(tables, "h2d_bytes")
            mask, budget = self._upload_mask(mask_rows, plan[2], pad_n,
                                             keep)
            self._perf_add("upload", time.perf_counter() - t0)
            t0 = time.perf_counter()
            raw = torch.cat([progs[kind].grid(params_dev[i], cols_dev,
                                              pad_n)
                             for i, kind in enumerate(kinds)], dim=0)
            pending = self._fold(flat, raw, mask, plan, budget, offsets)
            pending.staging = keep
            if attr_rows is not None:
                pending.attr_rows = attr_rows
                pending.attr_weights = {k: 1.0 + r
                                        for k, r in attr_rows.items()}
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
        fault_point("device.dispatch", lane="sweep_resident", n=flat.n)
        with self._dispatch_lock:
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
            pending = self._fold(flat, raw, mask, plan, budget, offsets)
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

    def _fold(self, flat, raw, mask, plan: tuple, budget, offsets: dict):
        """The device side of both chunk kinds from the raw grid and the
        match mask on: the collect lane's fold (``plan`` from
        :meth:`_fold_plan`, ``budget`` its kept budget, see
        :meth:`_reduce`), as
        a :class:`_PendingSweep`.  On a CUDA device the result is copied
        into page-locked host memory and a CUDA event recorded after that
        copy."""
        by_kind, kinds = flat.by_kind, flat.kinds
        n, pad_n, return_bits = flat.n, flat.pad_n, flat.return_bits
        k = self.violations_limit
        lane, complete, _budget_np, hit_cap = plan
        if lane == "reduced":
            result = self._reduce(raw, mask, budget, complete, hit_cap, k,
                                  pad_n)
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
            outs = result if isinstance(result, tuple) else (result,)
            pending.host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in outs)
            pending.event = torch.cuda.Event()
            pending.event.record()
        return pending

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

    @staticmethod
    def _fetch(pending) -> list:
        """The chunk's result tensors as numpy on the host: after its CUDA
        event, the page-locked copies the dispatch enqueued (the wait
        releases the interpreter lock); on the CPU the tensors
        themselves."""
        if pending.host is not None:
            pending.event.synchronize()
            out = [t.numpy() for t in pending.host]
        else:
            res = pending.result
            outs = res if isinstance(res, tuple) else (res,)
            out = [t.cpu().numpy() for t in outs]
        pending.staging = None
        return out

    def sweep_collect(self, pending):
        """Fetch + unpack a submitted sweep (the single device->host
        transfer)."""
        if pending is None:
            return {}
        if isinstance(pending, dict):  # empty submit
            return pending
        with tracing.span("device.sweep_collect", n=pending.n):
            if pending.lane == "reduced":
                return self._collect_reduced(pending)
            return self._collect_masks(pending)

    def _collect_masks(self, pending):
        t0 = time.perf_counter()
        host = self._fetch(pending)
        packed_np = host[0]
        bits_np = host[1] if pending.return_bits else None
        self._perf_add("d2h_bytes", float(sum(a.nbytes for a in host)))
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
        """Unpack one device-reduced chunk result; occupancy-weighted cost
        attribution from the fused fold's ``occ``; masks-lane fallback when
        the hit buffer overflowed, adaptive buffer sizing for the chunks
        after it."""
        t0 = time.perf_counter()
        arr = self._fetch(pending)[0]
        self._perf_add("d2h_bytes", arr.nbytes)
        c_total = max(hi for _lo, hi in pending.offsets.values())
        pad_n, n = pending.pad_n, pending.n
        if pad_n <= 0xFFFF:
            co = arr[:c_total].view(np.uint32)
            counts_all = (co & 0xFFFF).astype(np.int32)
            occ_all = (co >> 16).astype(np.int32)
            base = c_total
        else:
            counts_all = arr[:c_total]
            occ_all = arr[c_total: 2 * c_total]
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
            attr = costattr.active()
            if attr is not None and fb.attr_weights:
                # the overflowed chunk's dispatch wall, by the host masks
                # of its re-dispatch
                attr.attribute(pending.dispatch_wall, fb.attr_weights,
                               costattr.EP_AUDIT, costattr.PHASE_DISPATCH,
                               rows=fb.attr_rows)
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
        return out

    def _pad(self, n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p
