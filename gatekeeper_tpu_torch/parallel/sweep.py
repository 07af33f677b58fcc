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

Not ported here: multi-device meshes, the wire byte-packing of columns,
the resident snapshot lane, the differential collect lane, warm state,
flatten workers, tracing/metrics/cost attribution.
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
from gatekeeper_tpu_torch.ops import fold
from gatekeeper_tpu_torch.ops.flatten import Flattener, Schema


COLLECT_LANES = ("reduced", "masks")

# budgeted-lane hit-buffer steps: 0 for drained-budget chunks, three small
# steps for the steady-state trickle, then the full per-chunk capacity
_HIT_STEPS = (0, 16, 64, 256)

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # np.packbits order: MSB first


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


def _nonzero_padded(flat: torch.Tensor, size: int, fill: int):
    """``jnp.nonzero(flat, size=size, fill_value=fill)``: the first
    ``size`` set positions, padded with ``fill`` (int64)."""
    nz = torch.nonzero(flat).reshape(-1)[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=flat.device)
    out[: nz.shape[0]] = nz
    return out


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
                 "n", "pad_n", "return_bits", "budget", "programs")

    def __init__(self, by_kind, kinds, cols, batch, objects, any_gen, n,
                 pad_n, return_bits, budget=None, programs=None):
        self.by_kind = by_kind
        self.kinds = kinds
        self.cols = cols
        self.batch = batch
        self.objects = objects
        self.any_gen = any_gen
        self.n = n
        self.pad_n = pad_n
        self.return_bits = return_bits
        # reduced lane, budgeted variant: con -> remaining run-level kept
        # slots, evaluated at dispatch; None = full render cap
        self.budget = budget
        # the programs this chunk was flattened under
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
                      return_bits: bool = False, budget=None):
        """Stage 1 (host): schema union + flatten + column pack/slim.
        Returns a :class:`_FlatChunk`, or {} when no kind is lowered."""
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
                          budget=budget, programs=programs)

    def sweep_dispatch(self, flat):
        """Stage 2 (host -> device): match masks + parameter tables +
        tensor upload + the device program.  {} passes through."""
        if not isinstance(flat, _FlatChunk):
            return flat if isinstance(flat, dict) else {}
        return self._sweep_dispatch_impl(flat, lane=self.collect)

    def _hit_state_for(self, kinds: tuple, pad_n: int) -> dict:
        key = (kinds, pad_n)
        st = self._hit_state.get(key)
        if st is None:
            st = self._hit_state[key] = {"cap": 256, "low": 0,
                                         "pinned": False, "blast": None}
        return st

    def _table_tensor(self, key: str, val) -> torch.Tensor:
        hit = self._table_dev_cache.get(key)
        if hit is not None and (
                hit[0] is val
                or (hit[0].shape == val.shape and hit[0].dtype == val.dtype
                    and np.array_equal(hit[0], val))):
            return hit[1]
        dev = to_tensor(val, self.device)
        self._table_dev_cache[key] = (val, dev)
        self._perf_add("h2d_bytes", float(val.nbytes))
        return dev

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
        by_kind = flat.by_kind
        kinds = flat.kinds
        batch = flat.batch
        objects = flat.objects
        n, pad_n, return_bits = flat.n, flat.pad_n, flat.return_bits
        progs = flat.programs if flat.programs is not None \
            else self.driver._programs
        k = self.violations_limit
        tables = []
        mask_rows = []
        offsets = {}
        c_off = 0
        t0 = time.perf_counter()
        for kind in kinds:
            prog = progs[kind]
            cons = by_kind[kind]
            # param tables FIRST: they register StrPred needle rows that the
            # vocab tables below must include
            tables.append(build_param_table(prog.program, cons,
                                            self.driver.vocab))
            mask_rows.append(masks_mod.constraint_masks(
                cons, batch, self.driver.vocab, objects,
                any_generate_name=flat.any_gen,
            ))
            offsets[kind] = (c_off, c_off + len(cons))
            c_off += len(cons)
        self._perf_add("masks", time.perf_counter() - t0)
        complete = bool(return_bits)
        if lane == "reduced" and complete \
                and self._hit_state_for(kinds, pad_n)["pinned"]:
            # dense corpus: complete hit coordinates would outweigh the
            # bit grid — this (kinds, pad) shape ships masks from now on
            lane = "masks"
        t0 = time.perf_counter()
        table_cols: dict = {}
        for kind in kinds:
            table_cols.update(vocab_tables(progs[kind].program,
                                           self.driver.vocab))
            table_cols.update(self.driver.inventory_cols(
                kind, programs=progs)[0])
        cols_dev = self._upload_cols({**flat.cols, **table_cols})
        params_dev = [{key: to_tensor(v, self.device)
                       for key, v in t.items()} for t in tables]
        # the match mask travels bit-packed ([C, pad_n/8] uint8) and
        # unpacks on the device
        mask_bits = np.packbits(np.concatenate(mask_rows, axis=0), axis=1)
        mask = unpackbits(to_tensor(mask_bits, self.device), pad_n)
        self._perf_add("h2d_bytes", float(mask_bits.nbytes))
        self._perf_add("upload", time.perf_counter() - t0)
        t0 = time.perf_counter()
        raw = torch.cat([progs[kind].grid(params_dev[i], cols_dev, pad_n)
                         for i, kind in enumerate(kinds)], dim=0)
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
        self._perf_add("dispatch", time.perf_counter() - t0)
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
                # row-major nonzero == canonical (constraint, ascending
                # index) order; fill coords sort last
                hits = _nonzero_padded(grid.reshape(-1), hit_cap,
                                       sentinel).to(torch.int32)
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
                pos = _nonzero_padded(sel.reshape(-1), hit_cap,
                                      c_total * k_eff)
                safe = torch.clamp(pos, max=c_total * k_eff - 1)
                oi = idx.reshape(-1)[safe].to(torch.int64)
                hits = torch.where(pos < c_total * k_eff,
                                   (pos // k_eff) * pad_n + oi,
                                   sentinel).to(torch.int32)
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
