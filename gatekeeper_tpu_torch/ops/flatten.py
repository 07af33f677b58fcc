"""Columnar flattening of Kubernetes objects — the host→device boundary.

The TPU eval plane never sees JSON.  At template-compile time the lowering pass
requests *columns* (scalar paths, ragged axes, map-key sets); this module
extracts those columns from a batch of objects into dense numpy arrays with
interned strings, pad+count ragged encoding, and per-value kind tags.  This is
the TPU-native replacement for the reference's per-object ``unstructured``
walking inside the Rego VM (SURVEY.md §7: "objects flatten to a columnar
encoding with segment IDs for ragged lists").

Design notes
- Strings are interned into a growing ``Vocab`` (host side).  Device programs
  only ever compare int32 ids; message text never reaches the device.
- Every scalar column carries (kind, num, sid) triples so one column encoding
  serves truthiness, numeric and string predicates:
      kind: 0=absent 1=false 2=true 3=number 4=string 5=other(list/dict/null)
- Ragged axes pad to the batch max (bucketed by the caller to limit
  recompiles); counts gate reductions so padding never changes verdicts.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence

import numpy as np

# value-kind tags (K_NULL split from K_OTHER so device term-order ranks can
# distinguish them; K_MAP split from K_OTHER for CEL semantics — CEL macros
# iterate map KEYS and error on list selects, so the device must tell
# lists and maps apart; Rego consumers treat K_OTHER|K_MAP alike)
# distinguish null(<numbers) from composites(>strings))
K_ABSENT, K_FALSE, K_TRUE, K_NUM, K_STR, K_OTHER, K_NULL = 0, 1, 2, 3, 4, 5, 6
K_MAP = 7

# Version of the object->column derivation (schema shapes, kind tags, pad
# rules).  Part of the on-disk compile-cache key (drivers/generation.py):
# bump it whenever flattening changes in a way that alters what a lowered
# program reads, so stale cached lowerings can never be served against
# incompatible columns.
FLATTEN_SCHEMA_VERSION = 1


class Vocab:
    """Host-side string interner.  id 0 is reserved for ""; -1 means absent."""

    def __init__(self):
        self._to_id: dict[str, int] = {"": 0}
        self._to_str: list[str] = [""]
        # optional mutual exclusion for the Python intern path: the
        # generation coordinator (drivers/generation.py) compiles on a
        # background thread against the live vocab, so its interns must
        # not interleave with a serving thread's.  None (the default)
        # keeps the hot flatten loops branch-cheap and bit-identical.
        self._lock = None

    def intern(self, s: str) -> int:
        lk = self._lock
        if lk is not None:
            with lk:
                return self._intern(s)
        return self._intern(s)

    def _intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Intern-free lookup: -2 if unseen (never equal to any feature id)."""
        return self._to_id.get(s, -2)

    def string(self, i: int) -> str:
        return self._to_str[i]

    def __len__(self):
        return len(self._to_str)


class RowIdMap:
    """Stable (uid -> global row id) assignment for the resident snapshot.

    Ids are monotone, never reused, and survive both row-level patches
    (a MODIFY keeps its id) and store compaction (positions move, ids do
    not) — the identity substrate the snapshot's verdict store keys on,
    and the prerequisite for phase-2 vocab interning keyed by row id.
    Position bookkeeping (id -> array row) lives with the store; this map
    owns only identity."""

    def __init__(self):
        self._next = 0
        self._ids: dict = {}  # uid -> id

    def assign(self, uid) -> tuple:
        """(id, created): the existing id for a known uid, else a fresh
        monotone id."""
        i = self._ids.get(uid)
        if i is not None:
            return i, False
        i = self._next
        self._next = i + 1
        self._ids[uid] = i
        return i, True

    def get(self, uid):
        return self._ids.get(uid)

    def forget(self, uid):
        """Drop a uid (DELETE); its id is retired, never reissued — a
        re-created object gets a NEW id (it is a new row)."""
        return self._ids.pop(uid, None)

    def __contains__(self, uid) -> bool:
        return uid in self._ids

    def uids(self) -> list:
        """Known uids (insertion order)."""
        return list(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def high_water(self) -> int:
        """Total ids ever issued (monotone, ≥ len(self))."""
        return self._next

    def export_state(self) -> tuple:
        """(next_id, [(uid, id)]) — the snapshot spill's identity
        section.  The high-water mark travels too: a restored map must
        keep issuing ids ABOVE every id ever issued (including retired
        ones), or a post-restart create could reuse a retired id and
        collide with a spilled verdict entry."""
        return (self._next, list(self._ids.items()))

    def restore(self, state: tuple) -> None:
        """Adopt an exported state (spill load).  Replaces the current
        assignment wholesale — only valid on a map that has issued
        nothing this process, or whose rows are being replaced with the
        spill's."""
        nxt, items = state
        self._ids = dict(items)
        self._next = max(int(nxt), self._next)


class RowInternCache:
    """Phase-2 intern state for the snapshot patch lane, keyed by the
    stable global row ids a :class:`RowIdMap` issues.

    Each entry maps a row id to the ``{string: global sid}`` facts its
    last flatten established; a repatch of a known row resolves every
    string the resident rows already own WITHOUT touching the global
    vocab dict (``hits``), and only genuinely new strings pay the
    global intern probe (``probes``).  Entries for a patch micro-batch
    share one dict object, so memory is O(distinct strings per batch),
    not O(rows x strings)."""

    def __init__(self):
        self._owned: dict = {}  # gid -> {str: global sid}
        self.hits = 0  # strings resolved from owned rows (no global probe)
        self.probes = 0  # strings that went to the global vocab

    def owned_union(self, gids) -> dict:
        dicts = []
        seen: set = set()
        for gid in gids:
            d = self._owned.get(gid)
            if d is not None and id(d) not in seen:
                seen.add(id(d))
                dicts.append(d)
        if not dicts:
            return {}
        if len(dicts) == 1:
            return dicts[0]
        out: dict = {}
        for d in dicts:
            out.update(d)
        return out

    def adopt(self, gid, owned: dict) -> None:
        self._owned[gid] = owned

    def forget(self, gid) -> None:
        self._owned.pop(gid, None)

    def clear(self) -> None:
        self._owned.clear()

    def __len__(self) -> int:
        return len(self._owned)


def _remap_sid_arrays(batch, remap: "np.ndarray") -> None:
    """Rewrite every string-id array of ``batch`` through ``remap``
    (index shifted by 2 so the -1 absent / -2 error sentinels map to
    themselves).  Prefix-axis aliases share array objects — the identity
    set keeps a shared array from remapping twice."""
    seen: set = set()

    def rm(arr):
        if arr is None or id(arr) in seen:
            return
        seen.add(id(arr))
        arr[...] = remap[arr + 2]

    rm(batch.group_sid)
    rm(batch.kind_sid)
    rm(batch.ns_sid)
    rm(batch.name_sid)
    for col in batch.scalars.values():
        rm(col.sid)
    for col in batch.raggeds.values():
        rm(col.sid)
    for col in batch.keysets.values():
        rm(col.sid)
    for col in getattr(batch, "ragged_keysets", {}).values():
        rm(col.sid)
    for col in getattr(batch, "map_keys", {}).values():
        rm(col.sid)
    for arr in getattr(batch, "canons", {}).values():
        rm(arr)


def flatten_phase2(flattener: "Flattener", objects, gids,
                   cache: RowInternCache):
    """Two-phase patch-lane flatten (incremental-audit NEXT 1): phase 1
    columnizes against a FRESH batch-local vocab, so per-string intern
    probes hit a dict sized by the patch batch instead of the cluster
    vocabulary; phase 2 resolves each DISTINCT string once — from the
    patched rows' owned-string cache when the resident rows already own
    it (zero global-vocab traffic), else one global intern — and remaps
    the sid arrays in place.  New strings intern in first-occurrence
    order, exactly the order a direct flatten would have used, so vocab
    and columns are bit-identical (the resync differential's
    precondition).

    Batches that would take the raw-bytes lane skip phase 2: the C
    columnizer already resolves interning through its persistent global
    vocab mirror (native/flattenjsonmod.c), and a per-call local vocab
    would thrash that cache."""
    from gatekeeper_tpu_torch.utils.rawjson import RawJSON

    if flattener.lane not in ("auto", "dict", "py") or not objects:
        return flattener.flatten(objects)
    if flattener.lane == "auto" and flattener.use_native and all(
            isinstance(o, RawJSON) for o in objects):
        from gatekeeper_tpu_torch.ops import native

        if native.load_json() is not None:
            return flattener.flatten(objects)
    local = Vocab()
    saved = flattener.vocab
    flattener.vocab = local
    try:
        batch = flattener.flatten(objects)
    finally:
        flattener.vocab = saved
    owned = cache.owned_union(gids)
    remap = np.empty(len(local._to_str) + 2, np.int32)
    remap[0] = -2
    remap[1] = -1
    new_owned: dict = {}
    for i, s in enumerate(local._to_str):
        g = owned.get(s)
        if g is None:
            g = saved.intern(s)
            cache.probes += 1
        else:
            cache.hits += 1
        remap[i + 2] = g
        new_owned[s] = g
    for gid in gids:
        cache.adopt(gid, new_owned)
    _remap_sid_arrays(batch, remap)
    return batch


# --- column specs (requested by the lowering pass) ------------------------


@dataclass(frozen=True)
class Axis:
    """A ragged iteration axis: one or more nested list paths, unioned.

    Each segment is a tuple of path-parts; the first part locates the outer
    list under the object root, each subsequent part locates a nested list
    under an item.  E.g.
        (("spec", "containers"),)                  -> containers
        (("spec", "containers"), ("ports",))       -> all ports of all containers
    Multiple segments concatenate (reference pattern: input_containers unions
    containers + initContainers, psp templates).
    """

    segments: tuple

    def key(self) -> str:
        return "|".join(
            "/".join(".".join(p) for p in seg) for seg in self.segments
        )


@dataclass(frozen=True)
class ScalarCol:
    path: tuple  # keys under the review-object root


@dataclass(frozen=True)
class RaggedCol:
    axis: Axis
    subpath: tuple  # keys under an axis item ( () = the item itself )


@dataclass(frozen=True)
class KeySetCol:
    """The set of keys of the map at ``path`` (e.g. metadata.labels)."""

    path: tuple


@dataclass(frozen=True)
class MapKeyCol:
    """The map KEY each axis item came from (items of dict-backed axes);
    list-backed items get sid -1.  Aligned with the axis's value items so
    ``labels[key]`` iterations can bind both key and value columns."""

    axis: Axis


@dataclass(frozen=True)
class ParentIdxCol:
    """For a nested pair axis (containers[_].caps.drop[_]): the ordinal of
    each pair's PARENT item in the parent axis's enumeration (-1 padding).
    Backs per-parent reductions (NestedAny) — segment-aligned by
    construction: child segments are parent segments each extended by one
    subpath part."""

    axis: Axis  # the child (pair) axis
    parent: Axis


@dataclass(frozen=True)
class ParentIdxColumn:
    idx: "np.ndarray"  # [N, M] int32, -1 padding


@dataclass(frozen=True)
class CanonCol:
    """sid of the canonical selector encoding of the map at ``path``:
    the ','-joined sort of 'key:value' pairs of a str->str map — the
    flatten_selector idiom of referential selector-join policies
    (gatekeeper-library uniqueserviceselector), optionally
    namespace-qualified (ns + NUL + canon) for same-namespace joins.
    sid -2 = the idiom errors on this object (non-string pair values /
    array) or, when ns-qualified, the namespace is absent."""

    path: tuple
    ns_scoped: bool = False


def selector_canon(value) -> str:
    """The flatten_selector encoding.  OPA's default (non-strict)
    builtin-error semantics make ``concat(":", [key, v])`` UNDEFINED for
    non-string pairs — the comprehension skips that binding — so the
    encoding is best-effort over the string pairs and total ("" for
    scalars, arrays, absent).  Shared by the review-side column fill and
    the inventory-side table builder — they must agree exactly."""
    parts = []
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(k, str) and isinstance(v, str):
                parts.append(f"{k}:{v}")
    # arrays iterate with integer keys: every concat is undefined
    return ",".join(sorted(parts))


@dataclass(frozen=True)
class RaggedKeySetCol:
    """Per-axis-item key sets: the keys of the map at ``subpath`` under
    each item (e.g. the field names of every container — backs dynamic
    field-presence checks like ``container[probe]``)."""

    axis: Axis
    subpath: tuple


@dataclass
class Schema:
    scalars: list = field(default_factory=list)
    raggeds: list = field(default_factory=list)
    keysets: list = field(default_factory=list)
    ragged_keysets: list = field(default_factory=list)
    map_keys: list = field(default_factory=list)
    parent_idx: list = field(default_factory=list)
    canons: list = field(default_factory=list)
    # axes whose COUNTS must materialize even when no column rides them —
    # prefix-deduped axes (dedup_schema) still gate reductions by their
    # own count
    extra_axes: list = field(default_factory=list)

    def merge(self, other: "Schema") -> None:
        for s in other.scalars:
            if s not in self.scalars:
                self.scalars.append(s)
        for r in other.raggeds:
            if r not in self.raggeds:
                self.raggeds.append(r)
        for k in other.keysets:
            if k not in self.keysets:
                self.keysets.append(k)
        for rk in getattr(other, "ragged_keysets", []):
            if rk not in self.ragged_keysets:
                self.ragged_keysets.append(rk)
        for mk in getattr(other, "map_keys", []):
            if mk not in self.map_keys:
                self.map_keys.append(mk)
        for pi in getattr(other, "parent_idx", []):
            if pi not in self.parent_idx:
                self.parent_idx.append(pi)
        for cc in getattr(other, "canons", []):
            if cc not in self.canons:
                self.canons.append(cc)
        for ax in getattr(other, "extra_axes", []):
            if ax not in self.extra_axes:
                self.extra_axes.append(ax)

    def axes(self) -> list:
        out = []
        for r in self.raggeds:
            if r.axis not in out:
                out.append(r.axis)
        for rk in self.ragged_keysets:
            if rk.axis not in out:
                out.append(rk.axis)
        for mk in self.map_keys:
            if mk.axis not in out:
                out.append(mk.axis)
        for pi in self.parent_idx:
            for a in (pi.axis, pi.parent):
                if a not in out:
                    out.append(a)
        for a in getattr(self, "extra_axes", []):
            if a not in out:
                out.append(a)
        return out


def _is_seg_prefix(a: Axis, b: Axis) -> bool:
    return (len(a.segments) < len(b.segments)
            and b.segments[: len(a.segments)] == a.segments)


def _pi_aligned(child: Axis, parent: Axis) -> bool:
    """The parent-ordinal walk (_axis_items_with_parent) pairs child and
    parent segments one-for-one, each child segment extending its parent
    segment by exactly one subpath part."""
    if len(child.segments) != len(parent.segments):
        return False
    for cseg, pseg in zip(child.segments, parent.segments):
        if len(cseg) != len(pseg) + 1 or cseg[: len(pseg)] != pseg:
            return False
    return True


def dedup_schema(schema: Schema) -> tuple:
    """(exec_schema, alias) — axis-union prefix dedup.

    Union axes enumerate items segment-by-segment (``_axis_items``), so an
    axis that is a strict segment-prefix of another axis yields exactly the
    FIRST count-of-prefix items of the wider axis's enumeration.  Every
    ragged-family column on a prefix axis can therefore read the wider
    axis's arrays under its own count gate — e.g. ``containers``,
    ``containers|initContainers`` and the all-three union each requested
    separate image/name/... columns (3x extraction + transfer of the same
    values); after dedup only the widest union extracts/ships, and narrow
    specs alias to it (``alias``: orig spec -> exec spec).  Deduped axes
    keep materializing their own counts via ``Schema.extra_axes``.

    ParentIdx carve-out: a child axis whose widest extension does not pair
    segment-for-segment with its parent's widest extension is excluded
    from remapping (its pair-ordinal values would not transfer)."""
    col_axes: list = []
    for r in schema.raggeds:
        if r.axis not in col_axes:
            col_axes.append(r.axis)
    for rk in schema.ragged_keysets:
        if rk.axis not in col_axes:
            col_axes.append(rk.axis)
    for mk in schema.map_keys:
        if mk.axis not in col_axes:
            col_axes.append(mk.axis)
    for pi in schema.parent_idx:
        if pi.axis not in col_axes:
            col_axes.append(pi.axis)
    all_axes = schema.axes()
    widest: dict = {}
    for a in col_axes:
        cands = [b for b in all_axes if _is_seg_prefix(a, b)]
        if cands:
            widest[a] = max(cands,
                            key=lambda b: (len(b.segments), b.key()))
    # ParentIdx alignment: drop child axes whose remap breaks pairing.
    # Iterated to a fixed point — popping one axis can invalidate a pair
    # validated earlier against its widened form (chained parent_idx
    # specs [(A,P),(P,Q)]: popping P must re-check A's pair against the
    # UNwidened P).
    changed = True
    while changed:
        changed = False
        for pi in schema.parent_idx:
            nc = widest.get(pi.axis, pi.axis)
            np_ = widest.get(pi.parent, pi.parent)
            if pi.axis in widest and not _pi_aligned(nc, np_):
                widest.pop(pi.axis, None)
                changed = True
    if not widest:
        return schema, {}
    exec_s = Schema()
    exec_s.scalars = list(schema.scalars)
    exec_s.keysets = list(schema.keysets)
    exec_s.canons = list(getattr(schema, "canons", []))
    exec_s.extra_axes = list(getattr(schema, "extra_axes", []))
    alias: dict = {}

    def put(lst, orig, new):
        if new not in lst:
            lst.append(new)
        if new != orig:
            alias[orig] = new
            if orig.axis not in exec_s.extra_axes:
                exec_s.extra_axes.append(orig.axis)

    for r in schema.raggeds:
        put(exec_s.raggeds, r,
            RaggedCol(widest.get(r.axis, r.axis), r.subpath)
            if r.axis in widest else r)
    for rk in schema.ragged_keysets:
        put(exec_s.ragged_keysets, rk,
            RaggedKeySetCol(widest.get(rk.axis, rk.axis), rk.subpath)
            if rk.axis in widest else rk)
    for mk in schema.map_keys:
        put(exec_s.map_keys, mk,
            MapKeyCol(widest[mk.axis]) if mk.axis in widest else mk)
    for pi in schema.parent_idx:
        if pi.axis in widest or pi.parent in widest:
            put(exec_s.parent_idx, pi,
                ParentIdxCol(widest.get(pi.axis, pi.axis),
                             widest.get(pi.parent, pi.parent)))
            # put() retains only the CHILD axis; a parent axis referenced
            # solely through this ParentIdxCol (no ragged column of its
            # own) would otherwise lose its count column from
            # Schema.axes(), a trace-time KeyError in the enclosing
            # AnyAxis consumer
            if pi.parent in widest and pi.parent not in exec_s.extra_axes:
                exec_s.extra_axes.append(pi.parent)
        else:
            put(exec_s.parent_idx, pi, pi)
    return exec_s, alias


# --- flattened batch ------------------------------------------------------


@dataclass
class ScalarColumn:
    kind: np.ndarray  # [N] int8
    num: np.ndarray  # [N] float32
    sid: np.ndarray  # [N] int32


@dataclass
class RaggedColumn:
    kind: np.ndarray  # [N, M] int8
    num: np.ndarray  # [N, M] float32
    sid: np.ndarray  # [N, M] int32


@dataclass
class KeySetColumn:
    sid: np.ndarray  # [N, L] int32, -1 padded
    count: np.ndarray  # [N] int32


@dataclass
class RaggedKeySetColumn:
    sid: np.ndarray  # [N, M, L] int32, -1 padded
    count: np.ndarray  # [N, M] int32


@dataclass
class MapKeyColumn:
    sid: np.ndarray  # [N, M] int32, -1 for list-backed items


@dataclass
class ColumnBatch:
    n: int
    scalars: dict  # ScalarCol -> ScalarColumn
    raggeds: dict  # RaggedCol -> RaggedColumn
    axis_counts: dict  # Axis -> np.ndarray [N] int32
    keysets: dict  # KeySetCol -> KeySetColumn
    ragged_keysets: dict = field(default_factory=dict)
    map_keys: dict = field(default_factory=dict)
    parent_idx: dict = field(default_factory=dict)
    canons: dict = field(default_factory=dict)  # CanonCol -> sid [N] int32
    # identity columns for match masks
    group_sid: np.ndarray = None
    kind_sid: np.ndarray = None
    ns_sid: np.ndarray = None
    name_sid: np.ndarray = None
    # uint8 [N] metadata.generateName presence (native JSON path only;
    # lets mask building skip materializing RawJSON objects)
    has_generate_name: np.ndarray = None

    def arrays(self) -> dict[str, np.ndarray]:
        """Stable name -> array mapping (the device-transfer payload)."""
        out = {}
        for i, (spec, col) in enumerate(sorted(
                self.scalars.items(), key=lambda kv: kv[0].path)):
            out[f"s{i}_kind"], out[f"s{i}_num"], out[f"s{i}_sid"] = (
                col.kind, col.num, col.sid)
        for i, (spec, col) in enumerate(sorted(
                self.raggeds.items(), key=lambda kv: (kv[0].axis.key(), kv[0].subpath))):
            out[f"r{i}_kind"], out[f"r{i}_num"], out[f"r{i}_sid"] = (
                col.kind, col.num, col.sid)
        for i, (axis, cnt) in enumerate(sorted(
                self.axis_counts.items(), key=lambda kv: kv[0].key())):
            out[f"a{i}_count"] = cnt
        for i, (spec, col) in enumerate(sorted(
                self.keysets.items(), key=lambda kv: kv[0].path)):
            out[f"k{i}_sid"], out[f"k{i}_count"] = col.sid, col.count
        return out


# float32 saturation bound: numbers beyond the device dtype's range store
# as ±inf EXPLICITLY (the same value the silent float64->float32 cast
# produces, minus the RuntimeWarning).  Policy: order against in-range
# numbers is preserved (inf > any finite threshold, matching the
# interpreter's exact comparison for out-of-range magnitudes); EQUALITY of
# two distinct out-of-range numbers is already beyond float32 — templates
# needing exact wide-number equality take the interpreter lane.
_F32_MAX = float(np.finfo(np.float32).max)


def f32_sat(v) -> float:
    """THE number→float32 cast policy, shared by every lane that puts a
    Python number into a device column or parameter table: saturate to
    ±inf beyond the float32 range (ordering against in-range numbers
    preserved) instead of numpy's silent-with-RuntimeWarning cast.  The
    native C lanes produce the same value ((float) of an out-of-range
    double is ±inf on IEEE targets) — asserted by the int64/float32
    boundary differential tests."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    try:
        f = float(v)
    except OverflowError:  # int beyond double range: saturate with sign
        return float("inf") if v > 0 else float("-inf")
    if f > _F32_MAX:
        return float("inf")
    if f < -_F32_MAX:
        return float("-inf")
    return f


def _classify(v: Any, vocab: Vocab):
    if isinstance(v, bool):
        return (K_TRUE if v else K_FALSE), 0.0, -1
    if isinstance(v, (int, float)):
        return K_NUM, f32_sat(v), -1
    if isinstance(v, str):
        return K_STR, 0.0, vocab.intern(v)
    if v is None:
        return K_NULL, 0.0, -1
    if isinstance(v, dict):
        return K_MAP, 0.0, -1
    return K_OTHER, 0.0, -1  # list


def _walk(obj: Any, path: Sequence[str]):
    _MISSING = object()
    cur = obj
    for p in path:
        if not isinstance(cur, dict):
            return _MISSING, False
        if p not in cur:
            return _MISSING, False
        cur = cur[p]
    return cur, True


def _axis_items_keyed(obj: dict, axis: Axis) -> list:
    """[(key_or_None, item)] — key set for items produced by map-value
    iteration at the FINAL part of a segment."""
    items: list = []
    for seg in axis.segments:
        level = [(None, obj)]
        for part in seg:
            nxt = []
            for _k, node in level:
                val, ok = _walk(node, part)
                if ok and isinstance(val, list):
                    nxt.extend((None, v) for v in val)
                elif ok and isinstance(val, dict):
                    nxt.extend(val.items())
            level = nxt
        items.extend(level)
    return items


def _axis_items_with_parent(obj: dict, child: Axis, parent: Axis) -> list:
    """[(parent_ordinal, item)] for a child axis whose segments extend the
    parent's one-for-one; the parent ordinal is the item's index in
    _axis_items(obj, parent)."""
    out = []
    base = 0
    for pseg, cseg in zip(parent.segments, child.segments):
        sub = cseg[-1]
        parents = _axis_items(obj, Axis((pseg,)))
        for k, pit in enumerate(parents):
            val, ok = _walk(pit, sub)
            if ok and isinstance(val, list):
                out.extend((base + k, v) for v in val)
            elif ok and isinstance(val, dict):
                out.extend((base + k, v) for v in val.values())
        base += len(parents)
    return out


def _axis_items(obj: dict, axis: Axis) -> list:
    # Rego xs[_] iterates map VALUES too; derived from the keyed walk so
    # MapKeyColumn sids stay aligned with ragged value columns by
    # construction
    return [v for _k, v in _axis_items_keyed(obj, axis)]


def _synth_review(obj: dict) -> dict:
    """Review doc fields derivable from a bare object (audit sweeps review
    cluster objects; gvk/name/namespace mirror AugmentedUnstructured
    coercion, target.go:159-179)."""
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of

    group, version, kind = gvk_of(obj)
    meta = obj.get("metadata") or {}
    nm = meta.get("name", "")
    ns = meta.get("namespace", "")
    return {
        "kind": {"group": group, "version": version, "kind": kind},
        "operation": "",
        "name": nm if isinstance(nm, str) else "",
        "namespace": ns if isinstance(ns, str) else "",
    }


def diff_batches(schema: Schema, a: ColumnBatch, b: ColumnBatch):
    """First difference between two flattened batches (None when
    bit-identical): identity columns, axis counts, and every column of
    every family.  Shapes count — the lanes share one bucket grid, so a
    width mismatch is a real divergence."""

    def ne(x, y):
        if x is None or y is None:
            return (x is None) != (y is None)
        x, y = np.asarray(x), np.asarray(y)
        return x.shape != y.shape or not np.array_equal(x, y)

    for name in ("group_sid", "kind_sid", "ns_sid", "name_sid"):
        if ne(getattr(a, name), getattr(b, name)):
            return f"identity column {name}"
    if set(a.axis_counts) != set(b.axis_counts):
        return "axis sets differ"
    for axis, cnt in a.axis_counts.items():
        if ne(cnt, b.axis_counts[axis]):
            return f"axis counts {axis.key()}"
    families = (
        ("scalars", a.scalars, b.scalars, ("kind", "num", "sid")),
        ("raggeds", a.raggeds, b.raggeds, ("kind", "num", "sid")),
        ("keysets", a.keysets, b.keysets, ("sid", "count")),
        ("ragged_keysets", a.ragged_keysets, b.ragged_keysets,
         ("sid", "count")),
        ("map_keys", a.map_keys, b.map_keys, ("sid",)),
        ("parent_idx", a.parent_idx, b.parent_idx, ("idx",)),
    )
    for label, fa, fb, fields in families:
        if set(fa) != set(fb):
            return f"{label} spec sets differ"
        for spec, ca in fa.items():
            cb = fb[spec]
            for f in fields:
                if ne(getattr(ca, f), getattr(cb, f)):
                    return f"{label}[{spec}].{f}"
    if set(a.canons) != set(b.canons):
        return "canon spec sets differ"
    for spec, sa in a.canons.items():
        if ne(sa, b.canons[spec]):
            return f"canons[{spec}]"
    return None


def round_up(n: int, bucket: int = 8) -> int:
    """Pad ragged widths to buckets so jit shapes stay stable."""
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket


# --- multiprocess flatten worker pool (--flatten-workers) ------------------
#
# The sweep's host ceiling is the columnize loop (SWEEP1M: flatten 13.9s
# of a 42.9s 1M-object pass), and a single process cannot scale it past
# one core's worth of GIL-held assembly no matter how many pthreads the
# C columnizer runs.  The pool fans contiguous SPANS of a chunk's raw
# JSON byte items (bytes pickle cheaply; no DOM ever crosses the process
# boundary) across N worker processes, each running the C columnizer
# against a batch-local vocab; the parent then interns each worker's
# local string table into the shared vocab in span order and remaps +
# concatenates the column arrays (merge_worker_columns).
#
# Bit-identity contract: spans use the C module's OWN partition scheme
# (ceil-block contiguous ranges, thread count clamped to n/128+1), and
# the merge replays its deterministic "(thread, first-seen)" vocab
# order — so the worker lane is bit-identical (columns AND vocab string
# table, order included) to the in-process lane run at nthreads=N, and
# verdict-identical to ANY in-process thread count (intern order never
# changes verdicts; ids stay self-consistent — the long-standing
# pipeline_flatten_workers contract).  The workers differential lane
# asserts both halves per batch.


class FlattenPoolError(RuntimeError):
    """The worker pool is unusable (worker died, pipe broke); callers
    fall back to the in-process columnizer."""


def _flatten_worker_main(conn):
    """Worker process main loop: receives ``(items, specs, pad_n,
    bucket)`` jobs, columnizes against a fresh batch-local vocab with
    the C json columnizer (nthreads=1 — the pool IS the parallelism),
    replies ``("ok", out, local_to_str, seconds)`` or
    ``("err", exc_type_name, message)``."""
    import time as _time

    try:
        from gatekeeper_tpu_torch.ops import native

        mod = native.load_json()
    except Exception:
        mod = None
    while True:
        try:
            job = conn.recv()
        except (EOFError, OSError):
            return
        if job is None:
            return
        items, specs, pad_n, bucket = job
        try:
            if mod is None:
                raise RuntimeError("native json module unavailable in "
                                   "flatten worker")
            to_id: dict = {"": 0}
            to_str: list = [""]
            t0 = _time.perf_counter()
            out = mod.flatten_json_batch(items, *specs, to_id, to_str,
                                         int(pad_n), int(bucket), 1)
            reply = ("ok", out, to_str, _time.perf_counter() - t0)
        except Exception as e:
            reply = ("err", type(e).__name__, str(e))
        try:
            conn.send(reply)
        except (OSError, BrokenPipeError):
            return


class FlattenWorkerPool:
    """N long-lived flatten worker processes behind pipes.

    Forked (cheap; workers inherit the already-built native module and
    never touch jax), created lazily on first use and reused across
    chunks/sweeps.  ``run`` is serialized by a lock — concurrent
    pipeline flatten-stage threads take turns rather than interleaving
    pipe messages."""

    def __init__(self, workers: int):
        import multiprocessing as mp

        # build + load the native module in the PARENT first so forked
        # children inherit it loaded (two children racing the on-disk
        # build would collide)
        from gatekeeper_tpu_torch.ops import native

        native.load_json()
        try:
            ctx = mp.get_context("fork")
        except ValueError:  # platforms without fork
            ctx = mp.get_context("spawn")
        self.workers = workers
        self.dead = False
        self._lock = threading.Lock()
        self._procs: list = []
        self._conns: list = []
        import warnings

        for _ in range(workers):
            parent_c, child_c = ctx.Pipe()
            p = ctx.Process(target=_flatten_worker_main, args=(child_c,),
                            daemon=True, name="flatten-worker")
            with warnings.catch_warnings():
                # jax registers an at-fork RuntimeWarning (XLA threads +
                # fork CAN deadlock in general); these children run only
                # Python + the C columnizer and never touch jax, and the
                # repo promotes RuntimeWarning to error
                warnings.simplefilter("ignore", RuntimeWarning)
                p.start()
            child_c.close()
            self._procs.append(p)
            self._conns.append(parent_c)

    # per-span reply deadline: a columnize is seconds at worst, so a
    # worker silent this long is wedged (e.g. a bad fork interaction) —
    # the pool dies and the batch falls back in-process rather than
    # hanging the sweep
    REPLY_TIMEOUT_S = 120.0

    def run(self, jobs: list) -> list:
        """Submit one job per worker (len(jobs) <= workers) and collect
        replies in job order.  A broken or wedged worker marks the whole
        pool dead (the registry builds a fresh one on next use)."""
        with self._lock:
            if self.dead:
                raise FlattenPoolError("flatten worker pool is dead")
            try:
                for conn, job in zip(self._conns, jobs):
                    conn.send(job)
                out = []
                for i in range(len(jobs)):
                    if not self._conns[i].poll(self.REPLY_TIMEOUT_S):
                        self.dead = True
                        raise FlattenPoolError(
                            f"flatten worker {i} timed out")
                    out.append(self._conns[i].recv())
                return out
            except (OSError, EOFError, BrokenPipeError) as e:
                self.dead = True
                raise FlattenPoolError(str(e)) from e

    def close(self) -> None:
        with self._lock:
            self.dead = True
            for c in self._conns:
                try:
                    c.send(None)
                except Exception:
                    pass
                try:
                    c.close()
                except Exception:
                    pass
            for p in self._procs:
                p.join(timeout=2.0)
                if p.is_alive():
                    p.terminate()
            self._procs = []
            self._conns = []


_FLATTEN_POOLS: dict = {}
_FLATTEN_POOLS_LOCK = threading.Lock()


def get_flatten_pool(workers: int) -> FlattenWorkerPool:
    """The process-wide pool for a worker count (lazily created; a dead
    pool is replaced)."""
    with _FLATTEN_POOLS_LOCK:
        pool = _FLATTEN_POOLS.get(workers)
        if pool is None or pool.dead:
            pool = FlattenWorkerPool(workers)
            _FLATTEN_POOLS[workers] = pool
        return pool


def shutdown_flatten_pools() -> None:
    """Tear down every pool (tests, drain)."""
    with _FLATTEN_POOLS_LOCK:
        for pool in _FLATTEN_POOLS.values():
            try:
                pool.close()
            except Exception:
                pass
        _FLATTEN_POOLS.clear()


def _merge_rows(arrs: list, ns: list, pad_n: int, fill, remaps=None):
    """Concatenate per-span arrays row-wise into one [pad_n, ...] array.

    Ragged tails harmonize to the max span width (each span's width is
    ``bucket_up`` of its local max, so the max across spans equals the
    width a whole-batch columnize would have picked); rows/cells beyond
    a span's extent keep ``fill`` — exactly the C columnizer's own
    defaults for pad rows.  ``remaps`` (per-span local-sid -> global-sid
    tables, index shifted by 2 for the -2/-1 sentinels) rewrites sid
    arrays during the copy."""
    tail = tuple(max(a.shape[d] for a in arrs)
                 for d in range(1, arrs[0].ndim))
    dst = np.full((pad_n,) + tail, fill, arrs[0].dtype)
    off = 0
    for i, a in enumerate(arrs):
        sub = a[: ns[i]]
        if remaps is not None:
            sub = remaps[i][sub + 2]
        dst[(slice(off, off + ns[i]),)
            + tuple(slice(0, s) for s in sub.shape[1:])] = sub
        off += ns[i]
    return dst


def flatten_worker_spans(n: int, workers: int) -> list:
    """The C columnizer's own thread partition, applied to worker spans:
    thread count clamped to ``n/128 + 1`` (tiny batches stay
    single-context), then ceil-block contiguous ranges.  Matching the
    native scheme exactly is what makes the worker merge reproduce the
    in-process ``nthreads=N`` vocab order bit-for-bit.  Returns
    ``[(lo, hi)]`` with empty tails dropped."""
    if n <= 0 or workers <= 1:
        return [(0, n)] if n > 0 else []
    nw = min(workers, n // 128 + 1, n)
    block = (n + nw - 1) // nw
    spans = []
    for t in range(nw):
        lo = min(t * block, n)
        hi = min(lo + block, n)
        if hi > lo:
            spans.append((lo, hi))
    return spans


def merge_worker_columns(vocab: Vocab, parts: list, pad_n: int) -> dict:
    """Merge per-span worker outputs into one whole-batch columnizer
    output dict (the exact shape ``flatten_json_batch`` returns).

    ``parts``: ``[(out, local_to_str, n_items)]`` in span (document)
    order.  Interning into ``vocab`` happens span by span; each span's
    local table is the C columnizer's per-context first-seen order over
    a contiguous ascending item range, so the merged assignment order
    replays the native module's own "(thread, first-seen)" merge — the
    vocab string table and every column are bit-identical to an
    in-process columnize at ``nthreads=len(parts)`` over the same spans
    (the workers differential lane asserts this, order included)."""
    remaps = []
    for _out, to_str, _n in parts:
        rm = np.empty(len(to_str) + 2, np.int32)
        rm[0] = -2
        rm[1] = -1
        for i, s in enumerate(to_str):
            rm[i + 2] = vocab.intern(s)
        remaps.append(rm)
    outs = [p[0] for p in parts]
    ns = [p[2] for p in parts]

    def rows(pick, fill, remap=False):
        return _merge_rows([pick(o) for o in outs], ns, pad_n, fill,
                           remaps if remap else None)

    merged: dict = {}
    merged["identity"] = tuple(
        rows(lambda o, j=j: o["identity"][j], fill, remap=(j < 4))
        for j, fill in enumerate((-1, -1, -1, -1, 0)))
    merged["scalars"] = [
        (rows(lambda o: o["scalars"][c][0], 0),
         rows(lambda o: o["scalars"][c][1], 0.0),
         rows(lambda o: o["scalars"][c][2], -1, remap=True))
        for c in range(len(outs[0]["scalars"]))]
    merged["axes"] = [rows(lambda o: o["axes"][c], 0)
                      for c in range(len(outs[0]["axes"]))]
    merged["raggeds"] = [
        (rows(lambda o: o["raggeds"][c][0], 0),
         rows(lambda o: o["raggeds"][c][1], 0.0),
         rows(lambda o: o["raggeds"][c][2], -1, remap=True))
        for c in range(len(outs[0]["raggeds"]))]
    merged["keysets"] = [
        (rows(lambda o: o["keysets"][c][0], -1, remap=True),
         rows(lambda o: o["keysets"][c][1], 0))
        for c in range(len(outs[0]["keysets"]))]
    merged["map_keys"] = [
        rows(lambda o: o["map_keys"][c], -1, remap=True)
        for c in range(len(outs[0]["map_keys"]))]
    # parent ordinals are per-object indices into the parent axis
    # enumeration — positional, not vocab ids: no remap
    merged["parent_idx"] = [
        rows(lambda o: o["parent_idx"][c], -1)
        for c in range(len(outs[0]["parent_idx"]))]
    merged["ragged_keysets"] = [
        (rows(lambda o: o["ragged_keysets"][c][0], -1, remap=True),
         rows(lambda o: o["ragged_keysets"][c][1], 0))
        for c in range(len(outs[0]["ragged_keysets"]))]
    if "canons" in outs[0]:
        merged["canons"] = [
            rows(lambda o: o["canons"][c], -2, remap=True)
            for c in range(len(outs[0]["canons"]))]
    return merged


FLATTEN_LANES = ("auto", "dict", "raw", "py", "differential")


class Flattener:
    def __init__(self, schema: Schema, vocab: Optional[Vocab] = None,
                 use_native: bool = True, bucket: int = 8,
                 width_targets: Optional[dict] = None,
                 lane: str = "auto", workers: int = 0):
        # prefix-axis dedup: extraction runs over the exec schema; the
        # requested (orig) specs are aliased onto the exec columns after
        # flatten (same numpy arrays — identity the wire packer dedups on)
        self.orig_schema = schema
        self.schema, self.alias = dedup_schema(schema)
        self.vocab = vocab or Vocab()
        self.use_native = use_native
        # ragged pad bucket: 8 for ad-hoc batches (webhook lanes); sweep
        # callers pass 2 + corpus-stable width_targets so padding tracks
        # the corpus max instead of 8-wide minimums (wire + flatten cut)
        self.bucket = bucket
        # width_targets: {("ax", axis_key): M, ("rks_l", key): L,
        #  ("ks_l", key): L} corpus maxes from the warm pass; arrays pad UP
        # to round_up(target, bucket) so every chunk shares one jit layout
        # (a chunk exceeding a target keeps its wider shape: one retrace,
        # never wrong results)
        self.width_targets = width_targets
        # flatten sub-phase wall-clock (c_columnize / py_assemble /
        # canon_fill / stabilize) — folded into the evaluator's perf dict
        self.perf: dict = {}
        # lane selection (--flatten-lane): 'auto' takes the raw-bytes
        # threaded columnizer when every object carries bytes and the
        # native module built, else the C dict walker, else Python;
        # 'raw'/'dict'/'py' force a lane (raw serializes dict inputs
        # once); 'differential' runs raw THEN dict over one vocab and
        # asserts bit-identical columns (⇒ bit-identical verdicts)
        if lane not in FLATTEN_LANES:
            raise ValueError(f"unknown flatten lane {lane!r}")
        self.lane = lane
        # --flatten-workers: raw-lane batches with >= 2 items fan
        # contiguous byte spans across this many worker processes
        # (FlattenWorkerPool), merged bit-identically on the calling
        # thread; 0 keeps the exact in-process path.  With
        # lane='differential' the worker lane is additionally asserted
        # column- AND vocab-order-identical to the in-process path.
        self.workers = max(0, int(workers))
        # effective worker processes of the last flatten (0 = the batch
        # took the in-process path), for metrics/bench attribution
        self.last_workers_used = 0
        # in-process columnizer thread override (0 = env/cpu_count):
        # the workers differential pins the reference at nthreads=N so
        # the vocab-order comparison is exact
        self.nthreads = 0
        # the lane the last flatten() actually took ('raw'/'dict'/'py'),
        # for metrics/span attribution; 'raw' batches that fell back to
        # the dict lane on a parse reject report the lane they landed on
        self.lane_used: str = ""

    def _apply_alias(self, batch: ColumnBatch) -> ColumnBatch:
        for orig, new in self.alias.items():
            if isinstance(orig, RaggedCol) and new in batch.raggeds:
                batch.raggeds[orig] = batch.raggeds[new]
            elif isinstance(orig, RaggedKeySetCol) \
                    and new in batch.ragged_keysets:
                batch.ragged_keysets[orig] = batch.ragged_keysets[new]
            elif isinstance(orig, MapKeyCol) and new in batch.map_keys:
                batch.map_keys[orig] = batch.map_keys[new]
            elif isinstance(orig, ParentIdxCol) and new in batch.parent_idx:
                batch.parent_idx[orig] = batch.parent_idx[new]
        return batch

    def _axis_target(self, axis: Axis) -> Optional[int]:
        if self.width_targets is None:
            return None
        t = self.width_targets.get(("ax", axis.key()))
        return None if t is None else round_up(t, self.bucket)

    def _stabilize(self, batch: ColumnBatch) -> ColumnBatch:
        """Pad ragged-family widths up to the corpus-stable targets."""
        if self.width_targets is None:
            return batch

        def pad2(a, m, fill):
            if a.shape[1] >= m:
                return a
            out = np.full((a.shape[0], m) + a.shape[2:], fill, a.dtype)
            out[:, : a.shape[1]] = a
            return out

        for spec, col in batch.raggeds.items():
            m = self._axis_target(spec.axis)
            if m is not None and col.kind.shape[1] < m:
                batch.raggeds[spec] = RaggedColumn(
                    pad2(col.kind, m, 0), pad2(col.num, m, 0.0),
                    pad2(col.sid, m, -1))
        for spec, col in batch.map_keys.items():
            m = self._axis_target(spec.axis)
            if m is not None and col.sid.shape[1] < m:
                batch.map_keys[spec] = MapKeyColumn(pad2(col.sid, m, -1))
        for spec, col in batch.parent_idx.items():
            m = self._axis_target(spec.axis)
            if m is not None and col.idx.shape[1] < m:
                batch.parent_idx[spec] = ParentIdxColumn(
                    pad2(col.idx, m, -1))
        for spec, col in batch.ragged_keysets.items():
            m = self._axis_target(spec.axis)
            lt = self.width_targets.get(("rks_l", spec))
            l = None if lt is None else round_up(lt, self.bucket)
            sid, cnt = col.sid, col.count
            if l is not None and sid.shape[2] < l:
                new = np.full(sid.shape[:2] + (l,), -1, sid.dtype)
                new[:, :, : sid.shape[2]] = sid
                sid = new
            if m is not None and sid.shape[1] < m:
                sid = pad2(sid, m, -1)
                cnt = pad2(cnt[:, :, None], m, 0)[:, :, 0] \
                    if cnt.ndim == 2 and cnt.shape[1] < m else cnt
            if sid is not col.sid or cnt is not col.count:
                if cnt.shape[1] < sid.shape[1]:
                    nc = np.zeros(sid.shape[:2], cnt.dtype)
                    nc[:, : cnt.shape[1]] = cnt
                    cnt = nc
                batch.ragged_keysets[spec] = RaggedKeySetColumn(sid, cnt)
        for spec, col in batch.keysets.items():
            lt = self.width_targets.get(("ks_l", spec))
            l = None if lt is None else round_up(lt, self.bucket)
            if l is not None and col.sid.shape[1] < l:
                batch.keysets[spec] = KeySetColumn(
                    pad2(col.sid, l, -1), col.count)
        return batch

    def record_widths(self, batch: ColumnBatch, targets: dict) -> None:
        """Accumulate corpus width maxes from one (warm-pass) chunk into
        ``targets`` — the dict later handed back as ``width_targets``."""
        for axis, cnt in batch.axis_counts.items():
            k = ("ax", axis.key())
            targets[k] = max(targets.get(k, 1), int(cnt.max(initial=0)))
        for spec, col in batch.ragged_keysets.items():
            k = ("rks_l", spec)
            targets[k] = max(targets.get(k, 1),
                             int(col.count.max(initial=0)))
        for spec, col in batch.keysets.items():
            k = ("ks_l", spec)
            targets[k] = max(targets.get(k, 1),
                             int(col.count.max(initial=0)))

    def flatten(self, objects: Sequence[dict],
                pad_n: Optional[int] = None,
                reviews: Optional[Sequence[dict]] = None) -> ColumnBatch:
        """``reviews``: per-object review documents (kind/operation/...)
        backing __review__-rooted scalar columns; synthesized from the
        objects when not supplied (the audit path).  Lane dispatch per
        ``self.lane`` (see __init__)."""
        lane = self.lane
        if lane == "differential" and objects:
            if self.workers:
                return self._flatten_differential_workers(objects, pad_n,
                                                          reviews)
            return self._flatten_differential(objects, pad_n, reviews)
        use_native = self.use_native and lane != "py"
        if objects:
            from gatekeeper_tpu_torch.utils.rawjson import RawJSON

            if use_native and lane in ("auto", "raw") and (
                    lane == "raw" or all(isinstance(o, RawJSON)
                                         for o in objects)):
                from gatekeeper_tpu_torch.ops import native

                if native.load_json() is not None:
                    # materialized (possibly mutated) RawJSONs are
                    # re-serialized inside flatten_raw, so the lane stays
                    # correct for mixed batches; a forced 'raw' lane
                    # serializes dict inputs once
                    return self.flatten_raw(objects, pad_n=pad_n,
                                            reviews=reviews)
            # the C dict columnizer reads dict storage directly
            # (PyDict_GetItem), bypassing RawJSON's lazy __getitem__ —
            # materialize before the dict path so laziness can't read as
            # an empty object
            for o in objects:
                if isinstance(o, RawJSON):
                    o._load()
        review_cols = [c for c in self.schema.scalars
                       if c.path[:1] == ("__review__",)]
        ragged_keysets = list(getattr(self.schema, "ragged_keysets", []))
        map_key_cols = list(getattr(self.schema, "map_keys", []))
        parent_idx_cols = list(getattr(self.schema, "parent_idx", []))
        schema = self.schema
        if review_cols or ragged_keysets or map_key_cols or parent_idx_cols:
            schema = Schema()
            schema.scalars = [c for c in self.schema.scalars
                              if c.path[:1] != ("__review__",)]
            schema.raggeds = list(self.schema.raggeds)
            schema.keysets = list(self.schema.keysets)
            # ragged_keysets/map_keys stay on the inner schema so axes()
            # materializes their axis counts; the extraction itself happens
            # below — natively via extract_extras when the built module
            # provides it, else through the Python loops
            schema.ragged_keysets = list(ragged_keysets)
            schema.map_keys = list(map_key_cols)
            schema.parent_idx = list(parent_idx_cols)
            schema.extra_axes = list(getattr(self.schema, "extra_axes", []))
        inner = Flattener(schema, self.vocab, use_native,
                          bucket=self.bucket)
        mod = None
        if inner.use_native:
            from gatekeeper_tpu_torch.ops import native

            mod = native.load()
            batch = (inner._flatten_native(mod, objects, pad_n)
                     if mod is not None
                     else inner._flatten_py(objects, pad_n))
            self.lane_used = "dict" if mod is not None else "py"
        else:
            batch = inner._flatten_py(objects, pad_n)
            self.lane_used = "py"
        if review_cols:
            if reviews is None:
                reviews = [_synth_review(o) for o in objects]
            self._fill_review_cols(batch, review_cols, reviews)
        self._fill_canons(batch, objects)
        for mk in getattr(self.schema, "map_keys", []):
            if mk in batch.map_keys:
                continue  # the native flattener already extracted it
            n = batch.n
            m = round_up(int(batch.axis_counts[mk.axis].max(initial=0)),
                         self.bucket)
            sid = np.full((n, m), -1, np.int32)
            for i, obj in enumerate(objects):
                for j, (key, _item) in enumerate(
                    _axis_items_keyed(obj, mk.axis)[:m]
                ):
                    if isinstance(key, str):
                        sid[i, j] = self.vocab.intern(key)
            batch.map_keys[mk] = MapKeyColumn(sid)
        if mod is not None and hasattr(mod, "extract_extras") and \
                (parent_idx_cols or ragged_keysets):
            p_specs = [
                (pic.axis.segments, pic.parent.segments,
                 round_up(int(batch.axis_counts[pic.axis].max(initial=0)),
                          self.bucket))
                for pic in parent_idx_cols
            ]
            rk_specs = [
                (rk.axis.segments, tuple(rk.subpath),
                 round_up(int(batch.axis_counts[rk.axis].max(initial=0)),
                          self.bucket))
                for rk in ragged_keysets
            ]
            extras = mod.extract_extras(
                list(objects), p_specs, rk_specs,
                self.vocab._to_id, self.vocab._to_str,
                batch.n, self.bucket,
            )
            for pic, idx in zip(parent_idx_cols, extras["parent_idx"]):
                batch.parent_idx[pic] = ParentIdxColumn(idx)
            for rk, (sid, count) in zip(ragged_keysets,
                                        extras["ragged_keysets"]):
                batch.ragged_keysets[rk] = RaggedKeySetColumn(sid, count)
            return self._apply_alias(self._stabilize(batch))
        for pic in parent_idx_cols:
            n = batch.n
            m = round_up(int(batch.axis_counts[pic.axis].max(initial=0)),
                         self.bucket)
            idx = np.full((n, m), -1, np.int32)
            for i, obj in enumerate(objects):
                pairs = _axis_items_with_parent(obj, pic.axis, pic.parent)
                for j, (pk, _item) in enumerate(pairs[:m]):
                    idx[i, j] = pk
            batch.parent_idx[pic] = ParentIdxColumn(idx)
        for rk in ragged_keysets:
            n = batch.n
            m = round_up(int(batch.axis_counts[rk.axis].max(initial=0)),
                         self.bucket)
            per_obj = [_axis_items(o, rk.axis) for o in objects]
            key_lists = []
            maxl = 0
            for items in per_obj:
                row = []
                for item in items[:m]:
                    val, ok = (_walk(item, rk.subpath) if rk.subpath
                               else (item, True))
                    # truthy-key semantics (see flat keysets above)
                    keys = (sorted(k for k, v in val.items()
                                   if v is not False)
                            if ok and isinstance(val, dict) else [])
                    row.append(keys)
                    maxl = max(maxl, len(keys))
                key_lists.append(row)
            l = round_up(maxl, self.bucket)
            sid = np.full((n, m, l), -1, np.int32)
            count = np.zeros((n, m), np.int32)
            for i, row in enumerate(key_lists):
                for j, keys in enumerate(row):
                    count[i, j] = len(keys)
                    for q, k in enumerate(keys):
                        sid[i, j, q] = self.vocab.intern(k)
            batch.ragged_keysets[rk] = RaggedKeySetColumn(sid, count)
        return self._apply_alias(self._stabilize(batch))

    def flatten_raw(self, raws: Sequence,
                    pad_n: Optional[int] = None,
                    reviews: Optional[Sequence[dict]] = None) -> ColumnBatch:
        """Columnarize raw JSON documents (bytes or RawJSON) without ever
        materializing Python dicts: the threaded native module
        (native/flattenjsonmod.c) parses and columnizes with the GIL
        released.  Semantics match ``flatten`` exactly (differential-tested
        in tests/test_native_flatten.py); falls back to parse+flatten when
        the native module is unavailable."""
        from gatekeeper_tpu_torch.utils.rawjson import RawJSON

        from gatekeeper_tpu_torch.ops import native

        mod = native.load_json() if self.use_native else None
        if mod is None:
            objects = [o if isinstance(o, dict) else RawJSON(bytes(o))
                       for o in raws]
            return self.flatten(objects, pad_n=pad_n, reviews=reviews)
        schema = self.schema
        axes = schema.axes()
        axis_index = {a: i for i, a in enumerate(axes)}
        items = []
        for o in raws:
            if isinstance(o, RawJSON) and not o._loaded:
                items.append(o.raw)
            elif isinstance(o, (bytes, bytearray, memoryview)):
                items.append(bytes(o))
            else:
                # plain dict, or a materialized RawJSON whose dict state
                # may have diverged from .raw — serialize current state
                items.append(json.dumps(o, separators=(",", ":")).encode())
        nthreads = self.nthreads \
            or int(os.environ.get("GTPU_FLATTEN_THREADS", "0") or 0) \
            or (os.cpu_count() or 1)
        import time as _time
        _t0 = _time.perf_counter()
        self.last_workers_used = 0
        try:
            out = None
            if self.workers and len(items) > 1:
                out = self._columnize_workers(items, schema, axes,
                                              axis_index, pad_n)
            if out is None:
                out = self._call_columnizer(
                    mod, items, schema, axes, axis_index, pad_n, nthreads)
        except ValueError:
            # the C parser rejected an item: malformed/truncated bytes,
            # or input past its stricter limits (e.g. >256 nesting).
            # The dict lane is the oracle — re-parse in Python and take
            # it for this batch; an item json.loads also rejects raises
            # THERE, into the chunk retry/drop machinery.  The vocab is
            # untouched by the failed call (parse errors surface before
            # the intern merge), so the fallback interns identically.
            objects = [o if isinstance(o, dict) else RawJSON(bytes(o))
                       for o in raws]
            prev_lane, self.lane = self.lane, "dict"
            try:
                return self.flatten(objects, pad_n=pad_n, reviews=reviews)
            finally:
                self.lane = prev_lane
        self.lane_used = "raw+workers" if self.last_workers_used else "raw"
        self.perf["c_columnize"] = (self.perf.get("c_columnize", 0.0)
                                    + _time.perf_counter() - _t0)
        _t0 = _time.perf_counter()
        n = max(pad_n or 0, len(items))
        batch = ColumnBatch(n=n, scalars={}, raggeds={}, axis_counts={},
                            keysets={})
        (batch.group_sid, batch.kind_sid, batch.ns_sid, batch.name_sid,
         batch.has_generate_name) = out["identity"]
        for spec, (kind, num, sid) in zip(schema.scalars, out["scalars"]):
            batch.scalars[spec] = ScalarColumn(kind, num, sid)
        for axis, cnt in zip(axes, out["axes"]):
            batch.axis_counts[axis] = cnt
        for spec, (kind, num, sid) in zip(schema.raggeds, out["raggeds"]):
            batch.raggeds[spec] = RaggedColumn(kind, num, sid)
        for spec, (sid, cnt) in zip(schema.keysets, out["keysets"]):
            batch.keysets[spec] = KeySetColumn(sid, cnt)
        for spec, sid in zip(schema.map_keys, out["map_keys"]):
            batch.map_keys[spec] = MapKeyColumn(sid)
        for spec, idx in zip(schema.parent_idx, out["parent_idx"]):
            batch.parent_idx[spec] = ParentIdxColumn(idx)
        for spec, (sid, cnt) in zip(schema.ragged_keysets,
                                    out["ragged_keysets"]):
            batch.ragged_keysets[spec] = RaggedKeySetColumn(sid, cnt)
        # canon columns computed inside the kernel pass (the Python
        # _fill_canons below skips specs already present — it remains
        # the oracle for the dict lane and older native builds)
        for spec, sid in zip(getattr(schema, "canons", []),
                             out.get("canons", [])):
            batch.canons[spec] = sid
        if reviews is not None:
            # provided review docs override the synthesized columns
            self._fill_review_cols(
                batch,
                [c for c in schema.scalars
                 if c.path[:1] == ("__review__",)],
                reviews)
        self.perf["py_assemble"] = (self.perf.get("py_assemble", 0.0)
                                    + _time.perf_counter() - _t0)
        _t0 = _time.perf_counter()
        self._fill_canons(batch, raws)
        self.perf["canon_fill"] = (self.perf.get("canon_fill", 0.0)
                                   + _time.perf_counter() - _t0)
        _t0 = _time.perf_counter()
        batch = self._apply_alias(self._stabilize(batch))
        self.perf["stabilize"] = (self.perf.get("stabilize", 0.0)
                                  + _time.perf_counter() - _t0)
        return batch

    @staticmethod
    def _columnizer_specs(schema, axes, axis_index) -> tuple:
        """The plain-tuple spec bundle ``flatten_json_batch`` consumes —
        shared by the in-process call and the worker-pool jobs (the
        tuples pickle cheaply; workers never see Schema objects)."""
        return (
            [tuple(s.path) for s in schema.scalars],
            [a.segments for a in axes],
            [(axis_index[r.axis], tuple(r.subpath))
             for r in schema.raggeds],
            [tuple(k.path) for k in schema.keysets],
            [axis_index[mk.axis] for mk in schema.map_keys],
            [(axis_index[p.axis], axis_index[p.parent])
             for p in schema.parent_idx],
            [(axis_index[rk.axis], tuple(rk.subpath))
             for rk in schema.ragged_keysets],
            [(tuple(cc.path), 1 if cc.ns_scoped else 0)
             for cc in getattr(schema, "canons", [])],
        )

    def _call_columnizer(self, mod, items, schema, axes, axis_index,
                         pad_n, nthreads):
        """The raw native call, specs marshalled from the exec schema."""
        return mod.flatten_json_batch(
            items,
            *self._columnizer_specs(schema, axes, axis_index),
            self.vocab._to_id,
            self.vocab._to_str,
            int(pad_n or len(items)),
            self.bucket,  # ragged bucket, matches round_up()
            nthreads,
        )

    def _columnize_workers(self, items, schema, axes, axis_index, pad_n):
        """Fan contiguous item spans across the worker pool and merge.

        Returns the merged columnizer output dict, or None when the
        pool is unavailable / a worker failed non-parse (the caller
        then takes the in-process columnizer — never a lost batch).  A
        worker-side parse reject raises ValueError exactly like the
        in-process call, so the existing dict-lane fallback applies;
        the shared vocab is untouched on every failure path (merging
        is the only thing that interns, and it runs only on full
        success)."""
        import time as _time

        bounds = flatten_worker_spans(len(items), self.workers)
        if len(bounds) <= 1:
            # the native clamp (n/128+1) says this batch is too small to
            # fan out — the in-process call is both faster and the
            # bit-identity reference
            return None
        nw = len(bounds)
        t0 = _time.perf_counter()
        try:
            pool = get_flatten_pool(self.workers)
        except Exception:
            self.perf["worker_fallbacks"] = (
                self.perf.get("worker_fallbacks", 0.0) + 1.0)
            return None
        specs = self._columnizer_specs(schema, axes, axis_index)
        spans = [items[lo:hi] for lo, hi in bounds]
        try:
            replies = pool.run([(sp, specs, len(sp), self.bucket)
                                for sp in spans])
        except FlattenPoolError:
            self.perf["worker_fallbacks"] = (
                self.perf.get("worker_fallbacks", 0.0) + 1.0)
            return None
        parts = []
        busy = 0.0
        for sp, reply in zip(spans, replies):
            if reply[0] != "ok":
                _tag, ename, msg = reply
                if ename == "ValueError":
                    # malformed item: same contract as the in-process
                    # call — the dict lane re-parses and is the oracle
                    raise ValueError(msg)
                self.perf["worker_fallbacks"] = (
                    self.perf.get("worker_fallbacks", 0.0) + 1.0)
                return None
            _tag, out_w, to_str, dt = reply
            busy += dt
            parts.append((out_w, to_str, len(sp)))
        self.perf["worker_columnize"] = (
            self.perf.get("worker_columnize", 0.0)
            + _time.perf_counter() - t0)
        self.perf["worker_busy"] = (
            self.perf.get("worker_busy", 0.0) + busy)
        t1 = _time.perf_counter()
        merged = merge_worker_columns(self.vocab, parts,
                                      max(pad_n or 0, len(items)))
        self.perf["worker_merge"] = (
            self.perf.get("worker_merge", 0.0)
            + _time.perf_counter() - t1)
        self.last_workers_used = nw
        return merged

    def _flatten_differential_workers(self, objects, pad_n, reviews):
        """``workers`` + ``lane='differential'``: prove the worker pool
        bit-identical to the in-process path — columns AND the vocab
        intern ORDER.  The in-process reference (itself the raw-vs-dict
        differential) runs against a COPY of the vocab so both lanes
        intern from the same starting state, pinned at
        ``nthreads=len(spans)`` so its "(thread, first-seen)" merge is
        the exact order the worker merge claims to replay; the worker
        lane then runs against the real vocab and the two string tables
        must match exactly, order included.  Identical columns +
        identical vocab imply identical verdicts for any program
        reading them.

        Only raw-eligible batches (all RawJSON + native json built —
        the gate ``flatten`` itself uses) take the worker comparison:
        a dict-input batch never engages the pool, and its dict-lane
        intern order legitimately differs from the raw reference's, so
        it takes the plain raw-vs-dict differential instead."""
        from gatekeeper_tpu_torch.utils.rawjson import RawJSON

        raw_ok = False
        if self.use_native and objects and all(
                isinstance(o, RawJSON) for o in objects):
            from gatekeeper_tpu_torch.ops import native

            raw_ok = native.load_json() is not None
        if not raw_ok:
            return self._flatten_differential(objects, pad_n, reviews)
        ref_vocab = Vocab()
        ref_vocab._to_id = dict(self.vocab._to_id)
        ref_vocab._to_str = list(self.vocab._to_str)
        ref = Flattener(self.orig_schema, ref_vocab,
                        use_native=self.use_native, bucket=self.bucket,
                        width_targets=self.width_targets,
                        lane="differential")
        ref.nthreads = max(1, len(flatten_worker_spans(len(objects),
                                                       self.workers)))
        bref = ref.flatten(objects, pad_n=pad_n, reviews=reviews)
        prev = self.lane
        try:
            self.lane = "auto"
            bw = self.flatten(objects, pad_n=pad_n, reviews=reviews)
            w_lane = self.lane_used
        finally:
            self.lane = prev
        diff = diff_batches(self.orig_schema, bw, bref)
        if diff:
            raise RuntimeError(
                f"flatten workers differential mismatch ({w_lane} vs "
                f"{ref.lane_used}): {diff}")
        if ref_vocab._to_str != self.vocab._to_str:
            raise RuntimeError(
                "flatten workers differential: vocab intern order "
                "diverged from the in-process lane")
        self.lane_used = f"differential:{w_lane}"
        return bw

    def _flatten_differential(self, objects, pad_n, reviews) -> ColumnBatch:
        """``lane='differential'``: run the raw lane THEN the dict lane
        over the same objects and the same vocab, and assert every
        column array is bit-identical.  Raw runs first so every dict-
        lane intern is a lookup hit — identical columns therefore prove
        identical verdicts for any program reading them.  Returns the
        raw batch."""
        from gatekeeper_tpu_torch.utils.rawjson import as_raw

        raws = [as_raw(o) for o in objects]
        prev = self.lane
        try:
            self.lane = "raw"
            braw = self.flatten(raws, pad_n=pad_n, reviews=reviews)
            raw_lane = self.lane_used
            self.lane = "dict"
            bdict = self.flatten(raws, pad_n=pad_n, reviews=reviews)
        finally:
            self.lane = prev
        diff = diff_batches(self.orig_schema, braw, bdict)
        if diff:
            raise RuntimeError(
                f"flatten lane differential mismatch ({raw_lane} vs "
                f"{self.lane_used}): {diff}")
        self.lane_used = f"differential:{raw_lane}"
        return braw

    def _fill_canons(self, batch: ColumnBatch, objects) -> None:
        """Canonical-selector sid columns (CanonCol) — computed host-side
        in Python for both lanes (the encoding is a per-object string
        build over a small map; in the raw-JSON lane this materializes
        each object's dict, a cost paid only when a selector-join
        template is loaded)."""
        from gatekeeper_tpu_torch.utils.rawjson import RawJSON

        for cc in getattr(self.schema, "canons", []):
            if cc in batch.canons:
                continue
            sids = np.full(batch.n, -2, np.int32)
            # raw-bytes prescan: an object whose JSON never mentions the
            # path's last key cannot have the map — its canon is exactly
            # selector_canon(absent) = "" and its namespace comes from the
            # already-extracted identity column, so the (expensive) Python
            # parse is reserved for the ~10% of objects that probe-hit
            # (measured: this fill was 1.06s of a 1.41s 32k-object chunk
            # flatten when every object parsed).  Probe-MISS objects
            # resolve in bulk: their canon depends only on ns_sid, so one
            # intern per DISTINCT namespace sid (dozens per cluster)
            # replaces a per-object Python body (measured 0.24s/100k).
            probe = f'"{cc.path[-1]}"'.encode() if cc.path else b""
            to_str = self.vocab._to_str
            ns_sid = batch.ns_sid
            parse_idx: list = []  # objects that need the exact parse
            miss_idx: list = []   # provable probe-misses (ns path only)
            for i, obj in enumerate(objects):
                raw = None
                if isinstance(obj, (bytes, bytearray, memoryview)):
                    raw = bytes(obj)
                elif isinstance(obj, RawJSON) and not obj._loaded:
                    raw = obj.raw
                if raw is not None and probe and probe not in raw \
                        and b"\\u" not in raw:
                    # (\u-escaped docs parse: the probe can't see escaped
                    # key bytes)
                    if cc.ns_scoped:
                        s = int(ns_sid[i]) if ns_sid is not None else -1
                        if 0 <= s < len(to_str) and to_str[s]:
                            miss_idx.append(i)
                            continue
                        # the identity column interns absent AND explicit
                        # "" namespaces to the same sid — only the parse
                        # can tell them apart (absent -> -2, "" -> a
                        # "\x00"-prefixed canon, matching the dict lane)
                        if b'"namespace"' not in raw:
                            continue  # provably absent: -2
                        parse_idx.append((i, raw))
                    else:
                        sids[i] = self.vocab.intern("")
                    continue
                parse_idx.append((i, raw))
            if miss_idx:
                mi = np.asarray(miss_idx, np.intp)
                msids = ns_sid[mi]
                # one intern per distinct namespace sid, then a vectorized
                # gather maps every miss object through it
                uniq, inv = np.unique(msids, return_inverse=True)
                lut = np.array(
                    [self.vocab.intern(to_str[int(s)] + "\x00")
                     for s in uniq], np.int32)
                sids[mi] = lut[inv]
            for i, raw in parse_idx:
                obj = objects[i]
                if raw is not None:
                    try:
                        obj = json.loads(raw)
                    except ValueError:
                        continue
                    if not isinstance(obj, dict):
                        continue
                val = obj
                for part in cc.path:
                    val = val.get(part) if isinstance(val, dict) else None
                canon = selector_canon(val)
                if cc.ns_scoped:
                    meta = obj.get("metadata")
                    ns = meta.get("namespace") if isinstance(meta, dict) \
                        else None
                    if not isinstance(ns, str):
                        continue  # ns assignment fails: rule yields nothing
                    canon = ns + "\x00" + canon
                sids[i] = self.vocab.intern(canon)
            batch.canons[cc] = sids

    def _fill_review_cols(self, batch: ColumnBatch, specs, reviews) -> None:
        """(Re)fill __review__-rooted scalar columns from review docs —
        the single definition shared by the dict and JSON lanes."""
        n = batch.n
        for spec in specs:
            kind = np.zeros(n, np.int8)
            num = np.zeros(n, np.float32)
            sid = np.full(n, -1, np.int32)
            for i, rdoc in enumerate(reviews):
                val, ok = _walk(rdoc, spec.path[1:])
                if ok:
                    kind[i], num[i], sid[i] = _classify(val, self.vocab)
            batch.scalars[spec] = ScalarColumn(kind, num, sid)

    def _flatten_native(self, mod, objects: Sequence[dict],
                        pad_n: Optional[int]) -> ColumnBatch:
        """Columnarize via the C extension (native/flattenmod.c); layout and
        interning are bit-identical to the Python path (differential-tested
        in tests/test_native_flatten.py)."""
        schema = self.schema
        axes = schema.axes()
        axis_index = {a: i for i, a in enumerate(axes)}
        map_key_specs = list(getattr(schema, "map_keys", []))
        out = mod.flatten_batch(
            list(objects),
            [tuple(s.path) for s in schema.scalars],
            [a.segments for a in axes],
            [(axis_index[r.axis], tuple(r.subpath)) for r in schema.raggeds],
            [tuple(k.path) for k in schema.keysets],
            [axis_index[mk.axis] for mk in map_key_specs],
            self.vocab._to_id,
            self.vocab._to_str,
            int(pad_n or len(objects)),
            self.bucket,  # ragged bucket, matches round_up()
        )
        n = max(pad_n or 0, len(objects))
        batch = ColumnBatch(n=n, scalars={}, raggeds={}, axis_counts={},
                            keysets={})
        batch.group_sid, batch.kind_sid, batch.ns_sid, batch.name_sid = (
            out["identity"]
        )
        for spec, (kind, num, sid) in zip(schema.scalars, out["scalars"]):
            batch.scalars[spec] = ScalarColumn(kind, num, sid)
        for axis, cnt in zip(axes, out["axes"]):
            batch.axis_counts[axis] = cnt
        for spec, (kind, num, sid) in zip(schema.raggeds, out["raggeds"]):
            batch.raggeds[spec] = RaggedColumn(kind, num, sid)
        for spec, (sid, cnt) in zip(schema.keysets, out["keysets"]):
            batch.keysets[spec] = KeySetColumn(sid, cnt)
        for spec, sid in zip(map_key_specs, out.get("map_keys", [])):
            batch.map_keys[spec] = MapKeyColumn(sid)
        return batch

    def _flatten_py(self, objects: Sequence[dict],
                    pad_n: Optional[int] = None) -> ColumnBatch:
        n_real = len(objects)
        n = pad_n or n_real
        vocab = self.vocab
        batch = ColumnBatch(n=n, scalars={}, raggeds={}, axis_counts={},
                            keysets={})

        # identity columns
        batch.group_sid = np.full(n, -1, np.int32)
        batch.kind_sid = np.full(n, -1, np.int32)
        batch.ns_sid = np.full(n, -1, np.int32)
        batch.name_sid = np.full(n, -1, np.int32)
        from gatekeeper_tpu_torch.utils.unstructured import gvk_of

        for i, obj in enumerate(objects):
            group, _, kind = gvk_of(obj)
            meta = obj.get("metadata") or {}
            ns = meta.get("namespace", "")
            nm = meta.get("name", "")
            batch.group_sid[i] = vocab.intern(group)
            batch.kind_sid[i] = vocab.intern(kind)
            batch.ns_sid[i] = vocab.intern(ns if isinstance(ns, str) else "")
            batch.name_sid[i] = vocab.intern(
                nm if isinstance(nm, str) else "")

        for spec in self.schema.scalars:
            kind = np.zeros(n, np.int8)
            num = np.zeros(n, np.float32)
            sid = np.full(n, -1, np.int32)
            for i, obj in enumerate(objects):
                val, ok = _walk(obj, spec.path)
                if ok:
                    kind[i], num[i], sid[i] = _classify(val, vocab)
            batch.scalars[spec] = ScalarColumn(kind, num, sid)

        # axes first (items shared by all ragged columns on the axis)
        axis_items: dict[Axis, list[list]] = {}
        for axis in self.schema.axes():
            per_obj = [_axis_items(obj, axis) for obj in objects]
            per_obj += [[] for _ in range(n - n_real)]
            axis_items[axis] = per_obj
            batch.axis_counts[axis] = np.array(
                [len(x) for x in per_obj], np.int32
            )

        for spec in self.schema.raggeds:
            per_obj = axis_items[spec.axis]
            m = round_up(max((len(x) for x in per_obj), default=0),
                         self.bucket)
            kind = np.zeros((n, m), np.int8)
            num = np.zeros((n, m), np.float32)
            sid = np.full((n, m), -1, np.int32)
            for i, items in enumerate(per_obj):
                for j, item in enumerate(items):
                    val, ok = (
                        _walk(item, spec.subpath) if spec.subpath else (item, True)
                    )
                    if ok:
                        kind[i, j], num[i, j], sid[i, j] = _classify(val, vocab)
            batch.raggeds[spec] = RaggedColumn(kind, num, sid)

        for spec in self.schema.keysets:
            per_obj_keys = []
            for obj in objects:
                val, ok = _walk(obj, spec.path)
                # truthy-key semantics: {k | m[k]} in Rego excludes keys whose
                # value is false (statement truthiness)
                keys = (sorted(k for k, v in val.items() if v is not False)
                        if ok and isinstance(val, dict) else [])
                per_obj_keys.append(keys)
            per_obj_keys += [[] for _ in range(n - n_real)]
            l = round_up(max((len(k) for k in per_obj_keys), default=0),
                         self.bucket)
            sid = np.full((n, l), -1, np.int32)
            count = np.zeros(n, np.int32)
            for i, keys in enumerate(per_obj_keys):
                count[i] = len(keys)
                for j, k in enumerate(keys):
                    sid[i, j] = vocab.intern(k)
            batch.keysets[spec] = KeySetColumn(sid, count)

        return batch
