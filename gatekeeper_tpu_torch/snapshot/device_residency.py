"""Device-resident snapshot columns: the card's memory as the cluster cache.

Port of ``gatekeeper_tpu/snapshot/device_residency.py``.  The snapshot
store (snapshot/store.py) keeps per-group tall ColumnBatches resident on
the host and ticks O(churn), but every host-column sweep chunk still
pays a host gather, a column pack and the upload for rows that have not
changed since the last tick.  This module keeps them on the device:

- each routed :class:`GroupStore`'s tall batch lives ON THE DEVICE as the
  stats-free ``pack_transfer_cols`` buffers (``parallel/sweep.py``): one
  ``[cap, W]`` tensor per dtype, uploaded in one copy each, once per
  layout generation.  Device row index == store position;
- the per-(constraint, row) match masks live on the device too (bool
  ``[C, cap]`` in constraint-grid order), with a host mirror
  (``mask_host``) the tests hold the device tensor against;
- watch patches land as a scatter: the dirty rows flatten into a sliver
  (the store's normal patch lane), pack under the SAME layout and land
  with ``index_copy_``; a deleted row only clears its mask column;
- an audit chunk over resident rows ships only a gather index vector
  (cached per position tuple, so a warm full pass over unchanged
  membership uploads nothing) and the sweep gathers columns and masks on
  the device (``parallel/sweep.gather_resident``).

Verdicts equal the host-column lane's by construction: the gathered rows
are the values ``slice_rows`` would gather, pad slots gather row 0 under a
False mask column (what a host chunk's False pad masks contribute), and
the masks come from the same per-object ``constraint_masks`` the dispatch
path runs.  ``tests/test_torch_snapshot.py`` holds them equal.

One stream: patches, uploads and sweeps all run on the current (default)
stream, so a scatter-patch is ordered after any sweep still reading the
buffer it writes.  Not ported: the multi-chip check and the SLO eviction
trigger (``resilience/overload``); ``evict_all`` and ``invalidate`` stay
callable.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from gatekeeper_tpu_torch.ir import masks as masks_mod
from gatekeeper_tpu_torch.ir.program import (extdata_key_cols,
                                             pack_batch_cols, slim_cols)
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.parallel.sweep import (pack_transfer_cols,
                                                 torch_dtype)
from gatekeeper_tpu_torch.utils.logging import log_event

# residency modes (--snapshot-residency): 'auto' promotes only when the
# evaluator runs on a CUDA device (a CPU evaluator keeps host columns,
# logged once); 'on' promotes on any device (the CPU tests' shape); 'off'
# disables the lane
RESIDENCY_MODES = ("auto", "on", "off")

_IDX_CACHE_CAP = 4096  # gather index vectors kept per group


def _to_device(buf: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    """One packed numpy buffer as a device tensor of its mapped dtype, in
    one host-to-device copy."""
    want = torch_dtype(dtype_str)
    t = torch.from_numpy(np.ascontiguousarray(buf))
    if t.dtype != want:
        t = t.to(want)
    return t.to(device)


class ResidentGroup:
    """Device mirror of one GroupStore: packed column buffers + masks.

    ``cols_dev`` maps dtype string -> device tensor ``[cap, W]``;
    ``mask_dev`` is bool ``[C, cap]`` in constraint-grid order (sorted
    lowered kinds, then the group's constraint order per kind — the order
    every dispatch uses); ``mask_host`` is its numpy mirror."""

    __slots__ = ("store", "kinds", "by_kind", "uids", "cols_layout",
                 "cap", "c_total", "cols_dev", "mask_dev", "mask_host",
                 "mutation_mark", "layout_version", "idx_cache",
                 "resident_bytes", "needs", "device")

    def __init__(self, store, kinds, by_kind, uids, needs, device):
        self.store = store
        self.kinds = kinds
        self.by_kind = by_kind
        self.uids = uids
        self.needs = needs
        self.device = device
        self.cols_layout: tuple = ()
        self.cap = 0
        self.c_total = sum(len(by_kind[k]) for k in kinds)
        self.cols_dev: dict = {}
        self.mask_dev: Optional[torch.Tensor] = None
        self.mask_host: Optional[np.ndarray] = None
        self.mutation_mark = -1
        self.layout_version = -1
        # (positions, pad_n) -> device int32 gather vector (pad slots -1);
        # a warm full pass's chunk boundaries are deterministic, so the
        # second pass hits every entry and uploads nothing
        self.idx_cache: dict = {}
        self.resident_bytes = 0

    def chunk_idx(self, positions, pad_n: int) -> tuple:
        """(idx_dev [pad_n] int32, uploaded_bytes), cached per position
        tuple; -1 marks pad slots (their mask column is forced False on
        the device, so what they gather never matters)."""
        key = (tuple(positions), pad_n)
        hit = self.idx_cache.get(key)
        if hit is not None:
            return hit, 0
        idx = np.full(pad_n, -1, np.int32)
        idx[: len(positions)] = positions
        dev = torch.from_numpy(idx).to(self.device)
        if len(self.idx_cache) > _IDX_CACHE_CAP:
            self.idx_cache.clear()
        self.idx_cache[key] = dev
        return dev, idx.nbytes


class DeviceResidency:
    """Owner of the device-resident snapshot groups of ONE evaluator.

    ``prepare(store)`` is the seam the audit's snapshot lane calls per
    group per pass: it syncs the device mirror (full upload on a layout
    change, scatter-patch for dirty rows, nothing when clean) and returns
    the :class:`ResidentGroup`, or None when the lane declines (mode
    ``off``, ``auto`` on a CPU evaluator, external-data joins) — the
    caller then takes the host-column path."""

    def __init__(self, evaluator, mode: str = "auto"):
        if mode not in RESIDENCY_MODES:
            raise ValueError(f"unknown residency mode {mode!r} "
                             f"(want one of {RESIDENCY_MODES})")
        self.evaluator = evaluator
        self.mode = mode
        self._lock = threading.RLock()
        self._groups: dict = {}  # id(store) -> ResidentGroup
        self._logged_reasons: set = set()
        self.h2d_bytes = 0       # bytes this residency uploaded
        self.upload_count = 0    # full group uploads
        self.patch_count = 0     # scatter-patch syncs
        self.patched_rows = 0    # rows those patches wrote or cleared
        self.evictions = 0

    # --- availability ----------------------------------------------------
    def _log_fallback(self, reason: str, **fields) -> None:
        if reason in self._logged_reasons:
            return
        self._logged_reasons.add(reason)
        log_event("info", "snapshot residency falling back to host "
                  f"columns: {reason}",
                  event_type="residency_fallback", reason=reason, **fields)

    def available(self) -> bool:
        """Whether the resident lane may serve at all."""
        if self.mode == "off":
            return False
        ev = self.evaluator
        if ev is None:
            return False
        if self.mode == "auto" and ev.device.type != "cuda":
            self._log_fallback("no CUDA device (mode=auto on a "
                               f"{ev.device.type} evaluator)")
            return False
        return True

    # --- eviction --------------------------------------------------------
    def evict_all(self, reason: str = "") -> int:
        """Drop every device mirror (device memory frees as the tensors
        release); host columns keep serving and re-upload happens lazily
        on the next ``prepare``.  Returns the number of groups evicted."""
        with self._lock:
            n = len(self._groups)
            self._groups.clear()
        if n:
            self.evictions += n
            log_event("info", f"snapshot residency evicted {n} group(s)"
                      + (f": {reason}" if reason else ""),
                      event_type="residency_evicted", groups=n,
                      reason=reason)
        return n

    def invalidate(self) -> None:
        """Generation-change seam: new programs mean new schemas and
        layouts — drop the mirrors now instead of letting each group's uid
        check discover it one pass later."""
        self.evict_all("generation swap")

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(rg.resident_bytes for rg in self._groups.values())

    def is_resident(self, store) -> bool:
        """True when ``store`` has a device mirror."""
        with self._lock:
            rg = self._groups.get(id(store))
            return rg is not None and rg.store is store

    # --- sync ------------------------------------------------------------
    def _mask_rows(self, rg: ResidentGroup, batch, objects) -> np.ndarray:
        """[C, len(objects)] bool in constraint-grid order: the same
        ``constraint_masks`` call per kind the dispatch path makes, so a
        mask computed at patch time equals the one a host chunk computes
        at dispatch time."""
        if batch.has_generate_name is not None:
            any_gen = bool(batch.has_generate_name[: len(objects)].any())
        else:
            any_gen = any("generateName" in (o.get("metadata") or {})
                          for o in objects)
        sources = [SOURCE_ORIGINAL] * len(objects)
        rows = [masks_mod.constraint_masks(
            rg.by_kind[kind], batch, self.evaluator.driver.vocab,
            objects, sources=sources, any_generate_name=any_gen)
            for kind in rg.kinds]
        return np.concatenate(rows, axis=0)[:, : len(objects)]

    def _pack(self, store, positions, pad_n: int, rg: ResidentGroup):
        """(bufs, layout, batch, objects) for a row set under the
        stats-free layout (the layout every sliver of the group
        reproduces)."""
        batch = store.slice_rows(positions, pad_n)
        objects = [store.row_obj(p) for p in positions]
        cols = slim_cols(pack_batch_cols(batch), rg.needs)
        bufs, layout = pack_transfer_cols(cols, pad_n, stats=None)
        return bufs, layout, batch, objects

    def _upload(self, store, rg: ResidentGroup) -> None:
        """Full upload: the tall packed buffers (one copy per dtype) and
        the complete mask mirror.  Paid once per layout generation (first
        pass, capacity growth, ragged widening, compaction, re-chunk)."""
        live = store.live_positions()
        # pack EVERY slot by position (dead slots ship stale bytes under a
        # False mask): device row index == store position, the invariant
        # chunk gathers and scatter-patches rely on
        bufs, layout, _batch, _objs = self._pack(
            store, list(range(store.n_rows)), store.cap, rg)
        rg.cols_dev = {dt: _to_device(b, dt, rg.device)
                       for dt, b in bufs.items()}
        rg.cols_layout = layout
        rg.cap = store.cap
        mask = np.zeros((rg.c_total, store.cap), bool)
        if live:
            lbatch = store.slice_rows(live, len(live))
            lobjs = [store.row_obj(p) for p in live]
            mask[:, live] = self._mask_rows(rg, lbatch, lobjs)
        rg.mask_host = mask
        rg.mask_dev = torch.from_numpy(mask).to(rg.device)
        nbytes = sum(b.nbytes for b in bufs.values()) + mask.nbytes
        rg.resident_bytes = nbytes
        rg.idx_cache.clear()
        rg.mutation_mark = store.mutations
        rg.layout_version = store.layout_version
        store.patched.clear()
        self.h2d_bytes += nbytes
        self.upload_count += 1
        self.evaluator._perf_add("resident_h2d_bytes", float(nbytes))
        self.evaluator._perf_add("resident_uploads", 1.0)

    def _patch(self, store, rg: ResidentGroup) -> None:
        """Scatter-patch the dirty rows: sliver columns land with
        ``index_copy_`` and sliver masks with an indexed write; a dead row
        only clears its mask column.  The upload is O(patched rows)."""
        patched = sorted(p for p in store.patched if p < store.n_rows)
        live = [p for p in patched if store.live[p]]
        dead = [p for p in patched if not store.live[p]]
        nbytes = 0
        if live:
            bufs, layout, batch, objects = self._pack(
                store, live, len(live), rg)
            if layout != rg.cols_layout:
                # a sliver whose layout drifted from the tall layout
                # re-uploads instead of corrupting rows
                self._log_fallback("sliver layout drift (full re-upload)")
                self._upload(store, rg)
                return
            rows_np = np.asarray(live, np.int64)
            rows = torch.from_numpy(rows_np).to(rg.device)
            for dt, b in bufs.items():
                rg.cols_dev[dt].index_copy_(0, rows,
                                            _to_device(b, dt, rg.device))
                nbytes += b.nbytes
            m = self._mask_rows(rg, batch, objects)
            rg.mask_host[:, rows_np] = m
            rg.mask_dev[:, rows] = torch.from_numpy(m).to(rg.device)
            nbytes += m.nbytes + rows_np.nbytes
        if dead:
            rows_np = np.asarray(dead, np.int64)
            rg.mask_host[:, rows_np] = False
            rg.mask_dev[:, torch.from_numpy(rows_np).to(rg.device)] = False
            nbytes += rows_np.nbytes
        rg.mutation_mark = store.mutations
        store.patched.clear()
        self.h2d_bytes += nbytes
        self.patch_count += 1
        self.patched_rows += len(patched)
        self.evaluator._perf_add("resident_h2d_bytes", float(nbytes))
        self.evaluator._perf_add("resident_dirty_rows", float(len(patched)))

    def prepare(self, store) -> Optional[ResidentGroup]:
        """Sync and return the device mirror for one GroupStore, or None
        when the host-column path must serve (reason logged once)."""
        if not self.available():
            return None
        if store.batch is None or not store.lowered:
            return None
        ev = self.evaluator
        progs = ev.driver._programs
        _bk, lowered, _schema = ev.sweep_schema(store.cons, programs=progs)
        kinds = tuple(sorted(lowered))
        if not kinds:
            return None
        for kind in kinds:
            keymap, _ok = extdata_key_cols(progs[kind].program)
            if keymap:
                # external-data joins build per-chunk ext: tables off the
                # host batch, which the resident lane does not have
                self._log_fallback("external-data joins (group keeps "
                                   "host columns)", kind=kind)
                return None
        uids = tuple(progs[kind].uid for kind in kinds)
        with self._lock:
            rg = self._groups.get(id(store))
            if rg is not None and (rg.store is not store
                                   or rg.uids != uids):
                rg = None
            if rg is None:
                by_kind = {k: [c for c in store.cons if c.kind == k]
                           for k in kinds}
                rg = ResidentGroup(
                    store, kinds, by_kind, uids,
                    ev._needs_union(kinds, store.alias, programs=progs),
                    ev.device)
                self._groups[id(store)] = rg
            if (rg.layout_version != store.layout_version
                    or rg.cap != store.cap or not rg.cols_dev):
                self._upload(store, rg)
            elif store.patched or rg.mutation_mark != store.mutations:
                self._patch(store, rg)
            return rg

    def stats(self) -> dict:
        return {"mode": self.mode,
                "groups": len(self._groups),
                "resident_bytes": self.resident_bytes(),
                "h2d_bytes": self.h2d_bytes,
                "uploads": self.upload_count,
                "patches": self.patch_count,
                "patched_rows": self.patched_rows,
                "evictions": self.evictions}
