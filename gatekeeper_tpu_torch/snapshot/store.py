"""Resident columnar cluster snapshot: sweep cost O(churn), not O(cluster).

Port of ``gatekeeper_tpu/snapshot/store.py`` (host numpy, a copy with
the same spans and metrics).  The spill surface
(``GroupStore.export_rows``/``import_rows``, ``VerdictStore.export_state``/
``restore``, ``ClusterSnapshot.export_state``/``adopt_spill``) is what
``snapshot/persist.py`` writes and loads.

Every relist-mode audit pass re-lists and re-flattens the whole cluster;
the host flatten is most of a relist audit's wall.  The
reference never does that — its watch manager / cachemanager keep a
synced cache and the audit reads from it (PAPER.md L1/L2:
``AddData``/``RemoveData`` on the Driver seam).  This module is the
columnar version of that cache:

- the flattened column arrays (plus vocab sids and canon columns) stay
  RESIDENT between sweeps, one tall :class:`ColumnBatch` per kind-group
  (the audit router's grouping, ``parallel/sweep.make_kind_router``);
- watch events apply as row-level patches: a new/changed object
  columnizes through the same flatten lane a fresh sweep would use and
  its row is written in place (or appended), deletes tombstone the row;
- a compaction step folds tombstones out when their fraction crosses a
  threshold — row POSITIONS move, row IDS do not
  (:class:`~gatekeeper_tpu_torch.ops.flatten.RowIdMap`);
- the resident arrays slice straight into device sweep chunks
  (``SweepEvaluator.sweep_flatten_from_batch``; device-resident
  groups gather on the device instead, snapshot/device_residency.py):
  a full snapshot pass pays zero list/flatten cost, an incremental tick
  evaluates only the dirty row set;
- :meth:`ClusterSnapshot.resync_differential` re-lists and re-flattens
  fresh and asserts the resident columns are bit-identical per row —
  the periodic proof that patch-maintained state equals rebuilt state.

The snapshot doubles as a warm inventory/namespace cache: every live
object is addressable by (gvk, namespace, name) without an apiserver
GET (:meth:`ClusterSnapshot.get`).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

from gatekeeper_tpu_torch.ops.flatten import ColumnBatch, KeySetColumn, \
    MapKeyColumn, ParentIdxColumn, RaggedColumn, RaggedKeySetColumn, \
    RowIdMap, RowInternCache, ScalarColumn, flatten_phase2, \
    flatten_resolved
from gatekeeper_tpu_torch.utils.rawjson import RawJSON, peek_kind
from gatekeeper_tpu_torch.utils.unstructured import (gvk_of, name_of,
                                                     namespace_of)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class SnapshotConfig:
    # fold tombstoned rows out of a group's arrays once they exceed this
    # fraction of the group's slots (and the group is non-trivial)
    compact_tombstone_fraction: float = 0.25
    compact_min_rows: int = 64
    # pending watch events applied per flatten call (row patches
    # columnize in micro-batches so the C lane amortizes per-call cost)
    micro_batch: int = 512
    # phase-2 vocab interning keyed by stable global row ids
    # (ops.flatten.flatten_phase2): patch-lane flattens columnize against
    # a batch-local vocab and resolve strings the resident rows already
    # own from the RowInternCache — no per-occurrence probe of the
    # cluster-sized vocab dict, bit-identical ids
    phase2_intern: bool = True
    # a constraint-set / template (generation) change RE-CHUNKS resident
    # rows against the new plan instead of invalidating the whole
    # snapshot (zero relist; row ids survive); False = wholesale reset
    rechunk: bool = True


def obj_key(obj) -> tuple:
    """(gvk, namespace, name) — the snapshot's object identity (mirrors
    FakeCluster's store key; uids are not guaranteed off a real
    apiserver's test doubles)."""
    return (gvk_of(obj), namespace_of(obj), name_of(obj))


def resync_slice(key: tuple, phase: int, k: int) -> bool:
    """Rotor membership of an object key for the rotated resync
    differential: a stable content hash (crc32 of the canonical key
    repr) mod K — independent of gid assignment order and of Python's
    per-process string-hash seed, so the K slices partition the
    keyspace identically across restarts and both directions of the
    membership check agree."""
    return zlib.crc32(repr(key).encode()) % k == phase


# --- tall-batch array plumbing --------------------------------------------
#
# The resident store for one group IS a ColumnBatch whose row axis is a
# capacity (n == cap, rows beyond n_rows hold pad fills).  The helpers
# below enumerate every stored array with its pad fill so writes, growth,
# compaction and slicing share one definition of the layout.

_IDENTITY_FIELDS = ("group_sid", "kind_sid", "ns_sid", "name_sid")


def _iter_arrays(batch: ColumnBatch, skip=()):
    """Yield ``(path, array, fill)`` for every array of a batch.  ``path``
    is (family, spec, field) consumed by :func:`_get_arr`/:func:`_set_arr`;
    specs in ``skip`` (prefix-axis alias originals — they re-attach at
    slice time, sharing the exec arrays) are not yielded."""
    for spec, col in batch.scalars.items():
        yield ("scalars", spec, "kind"), col.kind, 0
        yield ("scalars", spec, "num"), col.num, 0.0
        yield ("scalars", spec, "sid"), col.sid, -1
    for spec, col in batch.raggeds.items():
        if spec in skip:
            continue
        yield ("raggeds", spec, "kind"), col.kind, 0
        yield ("raggeds", spec, "num"), col.num, 0.0
        yield ("raggeds", spec, "sid"), col.sid, -1
    for axis, cnt in batch.axis_counts.items():
        yield ("axis_counts", axis, None), cnt, 0
    for spec, col in batch.keysets.items():
        yield ("keysets", spec, "sid"), col.sid, -1
        yield ("keysets", spec, "count"), col.count, 0
    for spec, col in batch.ragged_keysets.items():
        if spec in skip:
            continue
        yield ("ragged_keysets", spec, "sid"), col.sid, -1
        yield ("ragged_keysets", spec, "count"), col.count, 0
    for spec, col in batch.map_keys.items():
        if spec in skip:
            continue
        yield ("map_keys", spec, "sid"), col.sid, -1
    for spec, col in batch.parent_idx.items():
        if spec in skip:
            continue
        yield ("parent_idx", spec, "idx"), col.idx, -1
    for spec, sids in batch.canons.items():
        yield ("canons", spec, None), sids, -2
    for name in _IDENTITY_FIELDS:
        yield ("ident", name, None), getattr(batch, name), -1
    yield ("ident", "has_generate_name", None), batch.has_generate_name, 0


# pad fill per (family, field): the static twin of the fills
# _iter_arrays yields off a live batch, used when a spilled (trimmed)
# array is re-padded back to capacity on load (snapshot/persist.py)
_FAM_FILLS = {
    ("scalars", "kind"): 0, ("scalars", "num"): 0.0,
    ("scalars", "sid"): -1,
    ("raggeds", "kind"): 0, ("raggeds", "num"): 0.0,
    ("raggeds", "sid"): -1,
    ("axis_counts", None): 0,
    ("keysets", "sid"): -1, ("keysets", "count"): 0,
    ("ragged_keysets", "sid"): -1, ("ragged_keysets", "count"): 0,
    ("map_keys", "sid"): -1,
    ("parent_idx", "idx"): -1,
    ("canons", None): -2,
}


def _fill_for(path):
    fam, spec, field = path
    if fam == "ident":
        return 0 if spec == "has_generate_name" else -1
    return _FAM_FILLS[(fam, field)]


_PLACEHOLDERS = {
    "scalars": lambda: ScalarColumn(None, None, None),
    "raggeds": lambda: RaggedColumn(None, None, None),
    "keysets": lambda: KeySetColumn(None, None),
    "ragged_keysets": lambda: RaggedKeySetColumn(None, None),
    "map_keys": lambda: MapKeyColumn(None),
    "parent_idx": lambda: ParentIdxColumn(None),
}

def _set_arr(batch: ColumnBatch, path, arr) -> None:
    fam, spec, field = path
    if fam == "ident":
        setattr(batch, spec, arr)
        return
    d = getattr(batch, fam)
    if fam in ("axis_counts", "canons"):
        d[spec] = arr
        return
    if spec not in d:
        d[spec] = _PLACEHOLDERS[fam]()
    try:
        setattr(d[spec], field, arr)
    except dataclasses.FrozenInstanceError:  # e.g. ParentIdxColumn
        d[spec] = dataclasses.replace(d[spec], **{field: arr})


def _get_arr(batch: ColumnBatch, path):
    fam, spec, field = path
    if fam == "ident":
        return getattr(batch, spec)
    d = getattr(batch, fam)
    if fam in ("axis_counts", "canons"):
        return d[spec]
    return getattr(d[spec], field)


def signature_plan(batch: ColumnBatch, skip=()) -> tuple:
    """The row-independent half of :func:`row_signature`: every family's
    specs in signature order with their keys, computed once per batch
    (sorting by ``Axis.key()`` per row is most of a resync's cost)."""
    def order(specs, key, drop=()):
        return sorted(((key(s), s) for s in specs if s not in drop),
                      key=lambda ks: ks[0])

    return (
        order(batch.axis_counts, lambda a: a.key()),
        order(batch.scalars, lambda s: s.path),
        order(batch.raggeds, lambda r: (r.axis.key(), r.subpath), skip),
        order(batch.keysets, lambda s: s.path),
        order(batch.ragged_keysets, lambda r: (r.axis.key(), r.subpath),
              skip),
        order(batch.map_keys, lambda m: m.axis.key(), skip),
        order(batch.parent_idx, lambda p: (p.axis.key(), p.parent.key()),
              skip),
        order(batch.canons, lambda c: (c.path, c.ns_scoped)),
    )


def row_signature(batch: ColumnBatch, i: int, skip=(), plan=None) -> tuple:
    """Canonical per-row value tuple: every column family trimmed to the
    row's real extents (padding beyond an axis/keyset count is layout,
    not data).  Two batches flattened from the same object over the same
    vocab produce equal signatures regardless of pad widths — the unit
    of the resync differential's column comparison.  ``plan`` is
    :func:`signature_plan` of ``(batch, skip)``, for callers that sign
    many rows of one batch."""
    if plan is None:
        plan = signature_plan(batch, skip)
    axes, scalars, raggeds, keysets, rkeysets, map_keys, parents, canons \
        = plan
    parts: list = []
    for name in _IDENTITY_FIELDS + ("has_generate_name",):
        arr = getattr(batch, name)
        parts.append(None if arr is None else int(arr[i]))
    counts: dict = {}
    for akey, axis in axes:
        c = int(batch.axis_counts[axis][i])
        counts[axis] = c
        parts.append(("ax", akey, c))
    for path, spec in scalars:
        col = batch.scalars[spec]
        parts.append(("sc", path, int(col.kind[i]),
                      float(col.num[i]), int(col.sid[i])))
    for (akey, sub), spec in raggeds:
        c = counts[spec.axis]
        col = batch.raggeds[spec]
        parts.append(("rg", akey, sub,
                      col.kind[i, :c].tobytes(), col.num[i, :c].tobytes(),
                      col.sid[i, :c].tobytes()))
    for path, spec in keysets:
        col = batch.keysets[spec]
        c = int(col.count[i])
        parts.append(("ks", path, col.sid[i, :c].tobytes()))
    for (akey, sub), spec in rkeysets:
        ac = counts[spec.axis]
        col = batch.ragged_keysets[spec]
        rows = tuple(col.sid[i, j, : int(col.count[i, j])].tobytes()
                     for j in range(ac))
        parts.append(("rks", akey, sub, rows))
    for akey, spec in map_keys:
        c = counts[spec.axis]
        parts.append(("mk", akey, batch.map_keys[spec].sid[i, :c].tobytes()))
    for (akey, pkey), spec in parents:
        c = counts[spec.axis]
        parts.append(("pi", akey, pkey,
                      batch.parent_idx[spec].idx[i, :c].tobytes()))
    for (path, ns_scoped), spec in canons:
        parts.append(("cn", path, ns_scoped, int(batch.canons[spec][i])))
    return tuple(parts)


class GroupStore:
    """Resident columns + raw rows for one kind-group.

    ``group`` is the router's frozenset of template kinds; the empty
    group is the UNROUTED store (objects no template can match): raw rows
    only, counted in ``total_objects`` and servable from the warm cache,
    never flattened or evaluated."""

    def __init__(self, group: frozenset, constraints: Sequence,
                 evaluator, intern_cache=None):
        self.group = group
        self.cons = [c for c in constraints if c.kind in group]
        self.evaluator = evaluator
        # shared RowInternCache (phase-2 interning) or None = direct
        self.intern_cache = intern_cache
        if self.cons and evaluator is not None:
            _bk, lowered, schema = evaluator.sweep_schema(self.cons)
        else:
            lowered, schema = [], None
        self.lowered = tuple(sorted(lowered))
        self.schema = schema if self.lowered else None
        self.flattener = (evaluator._flattener(schema)
                          if self.lowered else None)
        self.alias = dict(self.flattener.alias) if self.flattener else {}
        self.batch: Optional[ColumnBatch] = None  # tall store, n == cap
        self.cap = 0
        self.n_rows = 0  # used slots (live + tombstoned), insertion order
        self.tombstones = 0
        self.objrefs: list = []  # per slot: bytes | dict | None (tomb)
        self.gids: list = []  # per slot: global row id
        self.live: list = []  # per slot: bool
        # device-residency + delta-spill bookkeeping: ``mutations`` is a
        # monotonic mark (any write/tombstone/compact/import bumps it —
        # delta spills skip groups whose mark hasn't moved),
        # ``layout_version`` bumps when array SHAPES change (growth,
        # ragged widening, compaction, import — a device mirror must
        # full-re-upload, scatter offsets no longer line up), and
        # ``patched`` holds positions dirtied since the device mirror
        # last synced (the scatter sliver; residency clears it)
        self.mutations = 0
        self.layout_version = 0
        self.patched: set = set()

    # --- row access ---------------------------------------------------
    @property
    def live_count(self) -> int:
        return self.n_rows - self.tombstones

    def live_positions(self) -> list:
        return [p for p in range(self.n_rows) if self.live[p]]

    def row_obj(self, pos: int):
        """The row's object: a lazy RawJSON over stored bytes, or the
        stored dict (watch events arrive parsed)."""
        ref = self.objrefs[pos]
        if isinstance(ref, (bytes, bytearray, memoryview)):
            return RawJSON(bytes(ref))
        return ref

    def row_signature(self, pos: int, plan=None) -> tuple:
        return row_signature(self.batch, pos, plan=plan)

    def same_object(self, pos: int, obj) -> bool:
        """Cheap no-op-patch detection (watch replay after a 410 re-ADDs
        every object): identity, then resourceVersion, then deep
        equality."""
        ref = self.objrefs[pos]
        if ref is obj:
            return True
        try:
            if isinstance(ref, dict) and isinstance(obj, dict) \
                    and not isinstance(ref, RawJSON) \
                    and not isinstance(obj, RawJSON):
                rv_a = (ref.get("metadata") or {}).get("resourceVersion")
                rv_b = (obj.get("metadata") or {}).get("resourceVersion")
                if rv_a and rv_b:
                    return rv_a == rv_b
            return self.row_obj(pos) == obj
        except Exception:
            return False

    # --- writes -------------------------------------------------------
    def _grow_rows(self, need: int) -> None:
        if self.batch is None or need <= self.cap:
            return
        new_cap = max(64, self.cap)
        while new_cap < need:
            new_cap *= 2
        for path, arr, fill in list(_iter_arrays(self.batch)):
            new = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            new[: self.cap] = arr
            _set_arr(self.batch, path, new)
        self.cap = new_cap
        self.batch.n = new_cap
        self.layout_version += 1

    def _init_base(self, local: ColumnBatch, need: int) -> None:
        cap = 64
        while cap < need:
            cap *= 2
        base = ColumnBatch(n=cap, scalars={}, raggeds={}, axis_counts={},
                           keysets={})
        for path, arr, fill in _iter_arrays(local, skip=self.alias):
            if arr is None:
                continue
            _set_arr(base, path, np.full((cap,) + arr.shape[1:], fill,
                                         arr.dtype))
        self.batch = base
        self.cap = cap
        self.layout_version += 1

    def _write_rows(self, local: ColumnBatch, positions: Sequence[int],
                    k: int) -> None:
        """Write the first ``k`` rows of ``local`` into base rows
        ``positions``, reconciling ragged widths (the base keeps the
        running max; narrower patch rows pad with the family fill)."""
        idx = np.asarray(positions, np.intp)
        for path, arr, fill in _iter_arrays(local, skip=self.alias):
            if arr is None:
                continue
            base_arr = _get_arr(self.batch, path)
            if base_arr.shape[1:] != arr.shape[1:]:
                tail = tuple(max(a, b) for a, b in
                             zip(base_arr.shape[1:], arr.shape[1:]))
                if tail != base_arr.shape[1:]:
                    wider = np.full((self.cap,) + tail, fill,
                                    base_arr.dtype)
                    region = (slice(None),) + tuple(
                        slice(0, s) for s in base_arr.shape[1:])
                    wider[region] = base_arr
                    _set_arr(self.batch, path, wider)
                    base_arr = wider
                    self.layout_version += 1
            base_arr[idx] = fill  # reset the full row (old wide values)
            region = (idx,) + tuple(slice(0, s) for s in arr.shape[1:])
            base_arr[region] = arr[:k]

    def write(self, entries: Sequence[tuple]) -> list:
        """Apply a micro-batch of upserts.  ``entries`` is
        ``[(pos_or_None, gid, obj)]``; returns the base position per
        entry (appends allocate).  Routed groups columnize the batch
        through the SAME flattener a fresh sweep of this group would use
        — the bit-identity precondition."""
        objs = [obj for _pos, _gid, obj in entries]
        positions: list = []
        n_new = sum(1 for pos, _g, _o in entries if pos is None)
        need = self.n_rows + n_new
        if self.flattener is not None:
            if self.intern_cache is not None:
                local = flatten_phase2(
                    self.flattener, objs,
                    [gid for _pos, gid, _obj in entries],
                    self.intern_cache)
            else:
                local = self.flattener.flatten(objs)
            if local.has_generate_name is None:
                local.has_generate_name = np.array(
                    [1 if "generateName" in (o.get("metadata") or {})
                     else 0 for o in objs], np.uint8)
            if self.batch is None:
                self._init_base(local, need)
            elif need > self.cap:
                self._grow_rows(need)
        for pos, gid, obj in entries:
            if pos is None:
                pos = self.n_rows
                self.n_rows += 1
                self.objrefs.append(None)
                self.gids.append(gid)
                self.live.append(True)
            ref = obj.raw if isinstance(obj, RawJSON) and not obj._loaded \
                else obj
            self.objrefs[pos] = ref
            self.gids[pos] = gid
            self.live[pos] = True
            positions.append(pos)
        if self.flattener is not None:
            self._write_rows(local, positions, len(entries))
        self.mutations += 1
        self.patched.update(positions)
        return positions

    def tombstone(self, pos: int) -> None:
        if not self.live[pos]:
            return
        self.live[pos] = False
        self.objrefs[pos] = None
        self.tombstones += 1
        self.mutations += 1
        self.patched.add(pos)

    def needs_compaction(self, cfg: SnapshotConfig) -> bool:
        return (self.n_rows >= cfg.compact_min_rows
                and self.tombstones > 0
                and self.tombstones / self.n_rows
                >= cfg.compact_tombstone_fraction)

    def compact(self) -> dict:
        """Fold tombstones out, preserving row order.  Returns
        {gid: new_pos} for the survivors (row IDS are stable — only
        positions move)."""
        keep = self.live_positions()
        k = len(keep)
        if self.batch is not None and k:
            kidx = np.asarray(keep, np.intp)
            for path, arr, fill in list(_iter_arrays(self.batch)):
                moved = arr[kidx]
                arr[:] = fill
                arr[:k] = moved
        elif self.batch is not None:
            for path, arr, fill in _iter_arrays(self.batch):
                arr[:] = fill
        self.objrefs = [self.objrefs[p] for p in keep]
        self.gids = [self.gids[p] for p in keep]
        self.live = [True] * k
        self.n_rows = k
        self.tombstones = 0
        self.mutations += 1
        self.layout_version += 1  # positions moved: scatter can't patch
        self.patched.clear()
        return {self.gids[i]: i for i in range(k)}

    # --- reads (the sweep lane) ---------------------------------------
    def slice_rows(self, positions: Sequence[int], pad_n: int) -> \
            ColumnBatch:
        """Gather rows into a chunk-shaped ColumnBatch (pad rows carry
        the same fills a fresh flatten's pad region would).  Prefix-axis
        aliases re-attach sharing the gathered arrays, so the wire
        packer's identity dedup still fires."""
        k = len(positions)
        idx = np.asarray(positions, np.intp)
        out = ColumnBatch(n=pad_n, scalars={}, raggeds={}, axis_counts={},
                          keysets={})
        for path, arr, fill in _iter_arrays(self.batch):
            sl = np.full((pad_n,) + arr.shape[1:], fill, arr.dtype)
            if k:
                sl[:k] = arr[idx]
            _set_arr(out, path, sl)
        if self.flattener is not None:
            self.flattener._apply_alias(out)
        return out

    # --- spill (snapshot/persist.py) ----------------------------------
    def schema_digest(self) -> str:
        """Digest of this group's columnize plan: the load-time guard that
        a spilled group's arrays still mean what the CURRENT template
        set's schemas say they mean."""
        from gatekeeper_tpu_torch.drivers.generation import schema_digest

        return schema_digest(self.schema)

    def export_rows(self) -> dict:
        """Spill payload of one group: every stored array trimmed to the
        used slots (capacity padding is layout, not data: it re-pads on
        load), plus the slot bookkeeping and raw object refs.  Array
        copies happen here, under the snapshot lock; pickling happens
        off-thread."""
        n = self.n_rows
        arrays: dict = {}
        if self.batch is not None:
            for path, arr, _fill in _iter_arrays(self.batch):
                arrays[path] = np.ascontiguousarray(arr[:n])
        refs: list = []
        for ref in self.objrefs:
            if ref is None:
                refs.append(None)
            elif isinstance(ref, (bytes, bytearray, memoryview)):
                refs.append(bytes(ref))
            elif isinstance(ref, RawJSON):
                refs.append(bytes(ref.raw))
            else:
                refs.append(ref)
        return {
            "kinds": sorted(self.group),
            "lowered": list(self.lowered),
            "schema": self.schema_digest(),
            "n_rows": n,
            "gids": list(self.gids),
            "live": list(self.live),
            "objrefs": refs,
            "arrays": arrays,
            "mutations": self.mutations,
        }

    def import_rows(self, payload: dict) -> None:
        """Adopt a spilled group's rows into this (freshly constructed)
        store: re-pad the trimmed arrays to a power-of-two capacity with
        the family fills.  The caller validated ``schema``/``lowered``
        against this store's freshly derived plan first.  ``mutations``
        and ``layout_version`` move, so a device mirror re-uploads the
        whole group on its first ``prepare``."""
        n = int(payload["n_rows"])
        arrays = payload["arrays"]
        if arrays:
            cap = 64
            while cap < n:
                cap *= 2
            base = ColumnBatch(n=cap, scalars={}, raggeds={},
                               axis_counts={}, keysets={})
            for path, arr in arrays.items():
                full = np.full((cap,) + arr.shape[1:], _fill_for(path),
                               arr.dtype)
                full[:n] = arr
                _set_arr(base, path, full)
            self.batch = base
            self.cap = cap
        self.n_rows = n
        self.gids = list(payload["gids"])
        self.live = list(payload["live"])
        self.objrefs = list(payload["objrefs"])
        self.tombstones = sum(1 for alive in self.live if not alive)
        # resume the spiller's mutation clock so the first post-boot
        # delta spill still skips groups that have not moved since
        self.mutations = int(payload.get("mutations", 0)) + 1
        self.layout_version += 1
        self.patched.clear()


def concat_group_rows(parts: Sequence[tuple], pad_n: int) -> ColumnBatch:
    """Gather rows of SEVERAL same-plan GroupStores into one packed
    chunk-shaped :class:`ColumnBatch` — the fleet packer's batch
    builder (``fleet/evaluator.py``): K small clusters' same-group rows
    ride one device dispatch instead of K underfilled ones.

    ``parts`` is ``[(store, positions)]``; segments land in order, so
    every cluster's rows keep their canonical row order inside the
    packed batch (the bit-identity precondition the per-cluster fold
    relies on).  Per array path the widest tail wins — ragged pad
    widths are data-dependent per store, and narrower segments pad
    with the family fill, exactly the reconciliation
    :meth:`GroupStore._write_rows` applies.  Pad rows beyond the real
    rows carry the same fills a fresh flatten's pad region would.
    Prefix-axis aliases re-attach off the first store's flattener.
    The caller guarantees the stores share one columnize plan (same
    library runtime, same constraint group — same schema digest)."""
    paths: dict = {}  # path -> [tail, dtype, fill]
    arrs: list = []   # per part: {path: array}
    for store, _positions in parts:
        per: dict = {}
        for path, arr, fill in _iter_arrays(store.batch):
            if arr is None:
                continue
            per[path] = arr
            prev = paths.get(path)
            if prev is None:
                paths[path] = [arr.shape[1:], arr.dtype, fill]
            else:
                prev[0] = tuple(max(a, b) for a, b in
                                zip(prev[0], arr.shape[1:]))
        arrs.append(per)
    out = ColumnBatch(n=pad_n, scalars={}, raggeds={}, axis_counts={},
                      keysets={})
    for path, (tail, dtype, fill) in paths.items():
        full = np.full((pad_n,) + tuple(tail), fill, dtype)
        off = 0
        for (store, positions), per in zip(parts, arrs):
            k = len(positions)
            arr = per.get(path)
            if k and arr is not None:
                idx = np.asarray(positions, np.intp)
                region = (slice(off, off + k),) + tuple(
                    slice(0, s) for s in arr.shape[1:])
                full[region] = arr[idx]
            off += k
        _set_arr(out, path, full)
    fl = parts[0][0].flattener
    if fl is not None:
        fl._apply_alias(out)
    return out


class VerdictStore:
    """Per-(constraint, row) audit results, keyed by stable row id.

    ``count`` is the row's contribution to the constraint's
    totalViolations (result count in exact-totals mode, 1 otherwise);
    ``msgs`` is the rendered ``(message, details)`` tuple — None until a
    kept-list derivation renders it (lazy in non-exact mode)."""

    def __init__(self):
        self._rows: dict = {}  # con_key -> {gid: [count, msgs|None]}
        self._by_gid: dict = {}  # gid -> set(con_key)

    def set(self, con_key, gid: int, count: int, msgs) -> None:
        self._rows.setdefault(con_key, {})[gid] = [count, msgs]
        self._by_gid.setdefault(gid, set()).add(con_key)

    def set_msgs(self, con_key, gid: int, msgs) -> None:
        self._rows[con_key][gid][1] = msgs

    def clear_gid(self, gid: int) -> None:
        for con_key in self._by_gid.pop(gid, ()):
            rows = self._rows.get(con_key)
            if rows is not None:
                rows.pop(gid, None)

    def rows(self, con_key) -> list:
        """[(gid, count, msgs)] in stable row-id (= insertion) order."""
        rows = self._rows.get(con_key, {})
        return [(gid, v[0], v[1]) for gid, v in sorted(rows.items())]

    def total(self, con_key) -> int:
        return sum(v[0] for v in self._rows.get(con_key, {}).values())

    def clear(self) -> None:
        self._rows.clear()
        self._by_gid.clear()

    def export_state(self) -> list:
        """[(con_key, [(gid, count, msgs)])]: the spill's verdict section
        (rendered msgs ride along, so a warm boot's first kept derivation
        renders nothing already rendered)."""
        return [(ck, [(gid, v[0], v[1]) for gid, v in rows.items()])
                for ck, rows in self._rows.items()]

    def restore(self, state: list) -> None:
        """Bulk-build both maps from :meth:`export_state` output."""
        self._rows = {ck: {gid: [count, msgs]
                           for gid, count, msgs in rows}
                      for ck, rows in state}
        by_gid: dict = {}
        for ck, rows in self._rows.items():
            for gid in rows:
                hit = by_gid.get(gid)
                if hit is None:
                    by_gid[gid] = {ck}
                else:
                    hit.add(ck)
        self._by_gid = by_gid


class ClusterSnapshot:
    """The process-wide resident snapshot: groups + identity + dirty set.

    Thread model: watch callbacks only ENQUEUE (lock-free deque append);
    all state mutation happens in :meth:`pump`/:meth:`rebuild` on the
    audit thread under ``self.lock``.  Reads used by the webhook warm
    cache (:meth:`get`) take the same lock briefly."""

    def __init__(self, evaluator, config: Optional[SnapshotConfig] = None,
                 metrics=None):
        self.evaluator = evaluator
        self.config = config or SnapshotConfig()
        self.metrics = metrics
        self.lock = threading.RLock()
        self.ids = RowIdMap()
        self.verdicts = VerdictStore()
        # phase-2 interning (ops.flatten.flatten_phase2), keyed by the
        # RowIdMap's stable gids; None disables (direct global interning)
        self.intern_cache = RowInternCache() \
            if self.config.phase2_intern else None
        self._groups: dict = {}  # frozenset -> GroupStore
        self._router = None
        self._constraints: list = []
        self._digest = None
        self._pos: dict = {}  # gid -> (GroupStore, pos)
        self._dirty: set = set()  # gids pending (re)evaluation
        self._pending: deque = deque()  # (etype, obj) from watch callbacks
        self.stale = True  # needs a rebuild before serving sweeps
        self.generation = 0
        self.patch_count = 0
        self.rechunk_count = 0  # plan changes absorbed without a relist
        # True after adopt_spill: the resident state came off a disk spill
        # (snapshot/persist.py), so the audit loop's first pass can be an
        # incremental tick (rows clean, verdicts persisted)
        self.warm_loaded = False

    # --- constraint set currency ---------------------------------------
    def _cons_digest(self, constraints) -> tuple:
        """The plan the resident rows were evaluated under: the constraint
        specs, the lowered kinds and the content digest of each constrained
        kind's template (so a template edit re-chunks, where the JAX
        package's digest leaves clean rows on the old template's
        verdicts)."""
        spec = tuple(sorted(
            (c.kind, c.name,
             json.dumps(c.raw.get("spec", {}), sort_keys=True, default=str)
             if isinstance(c.raw, dict) else "")
            for c in constraints))
        lowered: tuple = ()
        templates: tuple = ()
        if self.evaluator is not None:
            _bk, low, _schema = self.evaluator.sweep_schema(constraints)
            lowered = tuple(sorted(low))
            digests = getattr(self.evaluator.driver, "template_digests", {})
            templates = tuple(sorted((k, digests.get(k, ""))
                                     for k in {c.kind for c in constraints}))
        return (spec, lowered, templates)

    def set_constraints(self, constraints: Sequence) -> bool:
        """Adopt the active constraint set; a changed set (or a lowering/
        inventory-exactness flip) invalidates the derived state — groups,
        schemas and verdicts.  Returns True when a full rebuild (relist)
        is now required.

        When the snapshot already holds resident rows, a plan change
        (template edit / generation swap / constraint churn) RE-CHUNKS
        instead: the resident raw objects re-columnize against the new
        plan's schemas with their row ids intact and every row marked
        dirty — O(cluster) flatten+eval once, but zero relist traffic
        and no identity loss.  ``SnapshotConfig.rechunk=False`` keeps
        the wholesale reset."""
        from gatekeeper_tpu_torch.parallel.sweep import make_kind_router

        digest = self._cons_digest(constraints)
        with self.lock:
            if digest == self._digest and not self.stale:
                return False
            if digest != self._digest:
                can_rechunk = (getattr(self.config, "rechunk", True)
                               and not self.stale and self._pos)
                self._digest = digest
                self._constraints = list(constraints)
                self._router = make_kind_router(constraints)
                if can_rechunk and self._rechunk():
                    return False
                self._reset_rows()
            return self.stale

    def _rechunk(self) -> bool:
        """Re-columnize every resident row against the NEW plan (new
        router, new group schemas from the freshly-swapped generation).
        Row ids survive (``_apply_upserts`` re-appends a known id whose
        position was cleared); verdicts reset and every routed row lands
        dirty, so the next tick re-evaluates the cluster against the new
        template set without a relist.  Returns False (fall back to the
        wholesale reset) when any resident object is unavailable."""
        objs: list = []
        for store in self._groups.values():
            for pos in store.live_positions():
                obj = store.row_obj(pos)
                if obj is None:
                    return False
                objs.append((store.gids[pos], obj))
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("snapshot.rechunk", rows=len(objs)):
            # gid order: deterministic write order regardless of the old
            # grouping (ids are monotone arrival order)
            objs.sort(key=lambda t: t[0])
            self._groups = {}
            self._pos = {}
            self._dirty = set()
            self.verdicts.clear()
            if self.intern_cache is not None:
                self.intern_cache.clear()
            mb = max(1, self.config.micro_batch)
            pending = [(obj_key(o), o) for _gid, o in objs]
            for i in range(0, len(pending), mb):
                self._apply_upserts(pending[i: i + mb])
            self.rechunk_count += 1
            self.generation += 1
            if self.metrics is not None:
                from gatekeeper_tpu_torch.metrics import registry as M

                self.metrics.inc_counter(M.SNAPSHOT_PATCHES,
                                         {"type": "rechunk"},
                                         value=float(len(pending)))
        return True

    def invalidate(self) -> None:
        """Force a rebuild before the next sweep (resync divergence)."""
        with self.lock:
            self.stale = True

    def _reset_rows(self) -> None:
        self._groups = {}
        self._pos = {}
        self._dirty = set()
        self.verdicts.clear()
        if self.intern_cache is not None:
            self.intern_cache.clear()
        self.stale = True

    def _store_for(self, kind: str) -> GroupStore:
        g = self._router(kind) if self._router is not None else frozenset()
        store = self._groups.get(g)
        if store is None:
            store = GroupStore(g, self._constraints, self.evaluator,
                               intern_cache=self.intern_cache)
            self._groups[g] = store
        return store

    # --- ingest ---------------------------------------------------------
    def enqueue(self, etype: str, obj) -> None:
        """Watch-callback side: queue only (applied by :meth:`pump`)."""
        self._pending.append((etype, obj))

    def pending_count(self) -> int:
        return len(self._pending)

    def pump(self, max_events: Optional[int] = None) -> int:
        """Apply queued watch events as row patches.  Events coalesce to
        the LAST event per object key (an upsert is a full-row write and
        a delete removes the row, so intermediate states are dead);
        upserts columnize per group in micro-batches through the raw
        patch lane."""
        drained: list = []
        while self._pending and (max_events is None
                                 or len(drained) < max_events):
            drained.append(self._pending.popleft())
        if not drained:
            return 0
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("snapshot.pump", events=len(drained)):
            final: dict = {}  # key -> (etype, obj), insertion-ordered
            for etype, obj in drained:
                key = obj_key(obj)
                final.pop(key, None)
                final[key] = (etype, obj)
            with self.lock:
                upserts: list = []
                for key, (etype, obj) in final.items():
                    if etype == DELETED:
                        self._delete(key)
                    else:
                        upserts.append((key, obj))
                self._apply_upserts(upserts)
                self._maybe_compact()
        return len(drained)

    def _delete(self, key) -> None:
        gid = self.ids.get(key)
        if gid is None:
            return
        self.ids.forget(key)
        store, pos = self._pos.pop(gid)
        store.tombstone(pos)
        if self.intern_cache is not None:
            self.intern_cache.forget(gid)
        self.verdicts.clear_gid(gid)
        self._dirty.discard(gid)
        self.patch_count += 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.SNAPSHOT_PATCHES, {"type": "delete"})

    def _apply_upserts(self, upserts: Sequence[tuple]) -> None:
        """Route + columnize + write a list of (key, obj) upserts, in
        micro-batches per group.  Unchanged objects (watch replay churn
        after a 410) are detected and skipped — no dirty marking, no
        flatten."""
        by_store: dict = {}
        for key, obj in upserts:
            kind = peek_kind(obj)
            store = self._store_for(kind)
            gid = self.ids.get(key)
            pos = None
            if gid is not None:
                entry = self._pos.get(gid)
                if entry is None:
                    # identity survives a rebuild's row reset
                    # (RowIdMap persistence): the row re-appends under
                    # its existing id
                    pass
                else:
                    cur_store, pos = entry
                    if cur_store is store and store.same_object(pos, obj):
                        continue  # no-op patch
                    if cur_store is not store:
                        # kind collision across groups cannot happen for
                        # one key (kind is part of the key); defensive
                        # reset
                        self._delete(key)
                        gid, pos = None, None
            created = False
            if gid is None:
                gid, created = self.ids.assign(key)
            by_store.setdefault(id(store), (store, []))[1].append(
                (pos, gid, obj, created))
        mb = max(1, self.config.micro_batch)
        n_add = n_mod = 0
        for store, entries in by_store.values():
            for i in range(0, len(entries), mb):
                batch = entries[i: i + mb]
                positions = store.write(
                    [(pos, gid, obj) for pos, gid, obj, _c in batch])
                for (_pos0, gid, _obj, created), pos in zip(batch,
                                                            positions):
                    self._pos[gid] = (store, pos)
                    if store.cons:
                        self._dirty.add(gid)
                    self.patch_count += 1
                    if created:
                        n_add += 1
                    else:
                        n_mod += 1
        if self.metrics is not None and (n_add or n_mod):
            from gatekeeper_tpu_torch.metrics import registry as M

            if n_add:
                self.metrics.inc_counter(M.SNAPSHOT_PATCHES,
                                         {"type": "add"}, value=n_add)
            if n_mod:
                self.metrics.inc_counter(M.SNAPSHOT_PATCHES,
                                         {"type": "modify"}, value=n_mod)

    def _maybe_compact(self) -> None:
        for store in self._groups.values():
            if store.needs_compaction(self.config):
                remap = store.compact()
                for gid, pos in remap.items():
                    self._pos[gid] = (store, pos)

    # --- rebuild ---------------------------------------------------------
    def rebuild(self, lister) -> int:
        """Full relist into fresh stores (initial build, and the recovery
        path after a resync divergence).  Row ids of surviving keys are
        stable across rebuilds (RowIdMap persistence).  Returns the row
        count."""
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("snapshot.rebuild"), self.lock:
            self._reset_rows()
            seen: set = set()
            batch: list = []
            mb = max(1, self.config.micro_batch)
            for obj in lister():
                batch.append((obj_key(obj), obj))
                if len(batch) >= mb:
                    seen.update(k for k, _o in batch)
                    self._apply_upserts(batch)
                    batch = []
            if batch:
                seen.update(k for k, _o in batch)
                self._apply_upserts(batch)
            # keys known from a previous generation but absent now: the
            # reset already dropped their rows, only the identity lingers
            for key in [k for k in self.ids.uids() if k not in seen]:
                self.ids.forget(key)
            self.stale = False
            self.generation += 1
            return self.live_count()

    # --- spill export / adopt (snapshot/persist.py) ----------------------
    def export_state(self, known_marks: Optional[dict] = None) -> dict:
        """Capture the complete resident state for a disk spill, under the
        lock: group arrays (trimmed copies), identity map, verdicts, dirty
        set, constraint digest.  The capture copies every array, so the
        caller can pickle and write off the audit thread.

        ``known_marks`` (delta spills) maps a group's kinds-key
        (``"|".join(sorted(kinds))``) to the mutation mark the spiller last
        wrote; groups whose mark has not moved export a skipped stub (no
        array copies) and the spiller reuses the section on disk."""
        with self.lock:
            groups = []
            for store in self._groups.values():
                key = "|".join(sorted(store.group))
                if known_marks is not None \
                        and known_marks.get(key) == store.mutations:
                    groups.append({"kinds": sorted(store.group),
                                   "mutations": store.mutations,
                                   "skipped": True})
                else:
                    groups.append(store.export_rows())
            return {
                "digest": self._digest,
                "ids": self.ids.export_state(),
                "dirty": sorted(self._dirty),
                "verdicts": self.verdicts.export_state(),
                "groups": groups,
                "rows": self.live_count(),
            }

    def adopt_spill(self, constraints: Sequence, state: dict) -> int:
        """Install a validated spill: fresh GroupStores re-derive their
        schemas from the LIVE constraint set and adopt the spilled arrays,
        and every loaded row is clean with its persisted verdicts.  Raises
        ``ValueError`` (nothing committed) when a group's freshly derived
        plan disagrees with the plan its arrays were written under; the
        caller counts that as a spill miss."""
        from gatekeeper_tpu_torch.parallel.sweep import make_kind_router

        router = make_kind_router(constraints)
        cons = list(constraints)
        stores: dict = {}
        pos: dict = {}
        for payload in state["groups"]:
            g = frozenset(payload["kinds"])
            store = GroupStore(g, cons, self.evaluator,
                               intern_cache=self.intern_cache)
            if list(store.lowered) != list(payload["lowered"]):
                raise ValueError(
                    f"group {sorted(g)!r}: lowered set drifted")
            if store.lowered and \
                    store.schema_digest() != payload["schema"]:
                raise ValueError(
                    f"group {sorted(g)!r}: schema digest drifted")
            store.import_rows(payload)
            stores[g] = store
            for p, (gid, alive) in enumerate(zip(store.gids, store.live)):
                if alive:
                    pos[gid] = (store, p)
        with self.lock:
            self._digest = state["digest"]
            self._constraints = cons
            self._router = router
            self._groups = stores
            self._pos = pos
            self.ids.restore(state["ids"])
            self.verdicts.restore(state["verdicts"])
            if self.intern_cache is not None:
                self.intern_cache.clear()
            self._dirty = set(state["dirty"])
            self.stale = False
            self.warm_loaded = True
            self.generation += 1
            return self.live_count()

    def keys_for_gvk(self, gvk: tuple) -> list:
        """(namespace, name) keys of every known object of one GVK — the
        seed for a warm watch resubscription's vanished-object diff (a
        410 relist must synthesize DELETED for spilled rows the fresh
        list no longer carries)."""
        with self.lock:
            return [(ns, name) for (g, ns, name) in self.ids.uids()
                    if g == gvk]

    # --- sweep-facing reads ----------------------------------------------
    def routed_stores(self) -> list:
        return [s for s in self._groups.values() if s.cons]

    def all_rows(self) -> dict:
        """{GroupStore: [(gid, pos)] in row order} over every live routed
        row (the full snapshot pass)."""
        out: dict = {}
        with self.lock:
            for store in self.routed_stores():
                out[store] = [(store.gids[p], p)
                              for p in store.live_positions()]
        return out

    def dirty_rows(self) -> dict:
        """{GroupStore: [(gid, pos)]} for the dirty set only (the
        incremental tick)."""
        out: dict = {}
        with self.lock:
            for gid in sorted(self._dirty):
                store, pos = self._pos[gid]
                if store.live[pos]:
                    out.setdefault(store, []).append((gid, pos))
        return out

    def mark_clean(self, gids: Iterable[int]) -> None:
        with self.lock:
            self._dirty.difference_update(gids)

    def dirty_count(self) -> int:
        return len(self._dirty)

    def live_count(self) -> int:
        with self.lock:
            return sum(s.live_count for s in self._groups.values())

    def obj_of(self, gid: int):
        """Live object of a global row id, or None when the row was
        deleted (tombstoned or compacted away) — callers use the None
        to retire per-gid state (e.g. generated-resultant verdicts)."""
        with self.lock:
            hit = self._pos.get(gid)
            if hit is None:
                return None
            store, pos = hit
            return store.row_obj(pos)

    # --- warm cache (webhook referential/namespace lookups) -------------
    def get(self, gvk: tuple, namespace: str, name: str):
        """Resident object lookup — the webhook's warm inventory cache
        (no apiserver GET).  Returns None when absent OR when the
        snapshot is stale (callers fall back to their own source)."""
        with self.lock:
            if self.stale:
                return None
            gid = self.ids.get((gvk, namespace, name))
            if gid is None:
                return None
            store, pos = self._pos[gid]
            return store.row_obj(pos)

    def namespace(self, name: str):
        return self.get(("", "v1", "Namespace"), "", name)

    # --- resync differential ---------------------------------------------
    def resync_differential(self, lister,
                            rotor: Optional[tuple] = None
                            ) -> Optional[str]:
        """Re-list + re-flatten fresh and compare against the resident
        columns row by row: membership, routing, and the full per-row
        column signature (identity, counts, every family trimmed to real
        extents, canon sids).  The fresh flatten resolves its strings
        against the SAME vocab without interning (``flatten_resolved``) —
        by resync time every string is interned, so a string the vocab
        lacks is itself a divergence.  Returns None when bit-identical,
        else a first-difference description.  O(cluster) by design (the
        periodic proof).

        ``rotor=(phase, K)`` restricts the proof to the 1/K slice of the
        keyspace whose deterministic key hash lands on ``phase``
        (:func:`resync_slice`): only slice objects re-flatten and only
        slice identities must be present/absent, so K consecutive
        rotated calls cover every row at ~1/K the re-flatten cost each
        (``--snapshot-resync-rotate``).  The hash keys on the object
        key, not the gid, so membership-in-slice is stable for rows the
        snapshot has never seen (a missed add diverges within K
        intervals)."""
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("snapshot.resync"), self.lock:
            flatteners: dict = {}
            bufs: dict = {}
            seen: set = set()
            diff: list = []
            missing = [0]  # fresh strings the vocab does not hold

            def check_chunk(store, objs, keys):
                fl = flatteners.get(id(store))
                if fl is None:
                    fl = self.evaluator._flattener(store.schema)
                    flatteners[id(store)] = fl
                fb, n_missing = flatten_resolved(fl, objs)
                missing[0] += n_missing
                if fb.has_generate_name is None:
                    # dict-lane flatten derives no presence column; the
                    # store normalizes it at write time — mirror that
                    fb.has_generate_name = np.array(
                        [1 if "generateName" in (o.get("metadata") or {})
                         else 0 for o in objs], np.uint8)
                skip = set(fl.alias)
                fresh_plan = signature_plan(fb, skip)
                store_plan = signature_plan(store.batch)
                for i, key in enumerate(keys):
                    gid = self.ids.get(key)
                    if gid is None:
                        diff.append(f"row {key!r} missing from snapshot")
                        return
                    cur, pos = self._pos[gid]
                    if cur is not store:
                        diff.append(f"row {key!r} routed to a different "
                                    f"group")
                        return
                    if row_signature(fb, i, plan=fresh_plan) != \
                            cur.row_signature(pos, plan=store_plan):
                        diff.append(f"columns differ for row {key!r}")
                        return

            for obj in lister():
                key = obj_key(obj)
                if rotor is not None and \
                        not resync_slice(key, rotor[0], rotor[1]):
                    continue  # out of rotation this interval
                seen.add(key)
                if diff:
                    break
                kind = peek_kind(obj)
                store = self._store_for(kind)
                if not store.cons:
                    if self.ids.get(key) is None:
                        diff.append(
                            f"unrouted row {key!r} missing from snapshot")
                        break
                    continue
                buf = bufs.setdefault(id(store), (store, [], []))
                buf[1].append(obj)
                buf[2].append(key)
                if len(buf[1]) >= max(1, self.config.micro_batch):
                    check_chunk(store, buf[1], buf[2])
                    bufs[id(store)] = (store, [], [])
            if not diff:
                for store, objs, keys in bufs.values():
                    if objs and not diff:
                        check_chunk(store, objs, keys)
            if not diff:
                extra = [k for k in self.ids.uids() if k not in seen
                         and (rotor is None
                              or resync_slice(k, rotor[0], rotor[1]))]
                if extra:
                    diff.append(f"snapshot row {extra[0]!r} not in the "
                                f"fresh relist")
            if not diff and missing[0]:
                diff.append(f"fresh relist holds {missing[0]} strings the "
                            f"vocab never interned")
            return diff[0] if diff else None

    # --- observability ----------------------------------------------------
    def stats(self) -> dict:
        with self.lock:
            slots = sum(s.n_rows for s in self._groups.values())
            tombs = sum(s.tombstones for s in self._groups.values())
            return {
                "rows": self.live_count(),
                "dirty_rows": len(self._dirty),
                "tombstone_fraction": (tombs / slots) if slots else 0.0,
                "patch_count": self.patch_count,
                "groups": len(self._groups),
                "generation": self.generation,
                "pending_events": len(self._pending),
            }

    def publish_metrics(self) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        st = self.stats()
        self.metrics.set_gauge(M.SNAPSHOT_ROWS, st["rows"])
        self.metrics.set_gauge(M.SNAPSHOT_DIRTY, st["dirty_rows"])
        self.metrics.set_gauge(M.SNAPSHOT_TOMBSTONE_FRACTION,
                               st["tombstone_fraction"])
        if self.intern_cache is not None:
            self.metrics.set_gauge(M.SNAPSHOT_INTERN_HITS,
                                   self.intern_cache.hits)
            self.metrics.set_gauge(M.SNAPSHOT_INTERN_PROBES,
                                   self.intern_cache.probes)
