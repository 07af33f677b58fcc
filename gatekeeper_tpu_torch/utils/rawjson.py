"""RawJSON: a lazy dict proxy over raw JSON bytes.

The audit sweep's host bottleneck is JSON-dict materialization + dict
walking (~15µs/object on one core, ROADMAP.md "Performance levers").  The
threaded native flattener (native/flattenjsonmod.c) columnizes raw bytes
directly with the GIL released — but the surrounding planes (match slow
paths, message rendering for hits, expansion) still expect dict objects.

``RawJSON`` bridges the two: it subclasses ``dict`` (so every
``isinstance(o, dict)`` check in the target/match/mutation planes holds)
but stays *empty* until first access, at which point it parses ``raw``
once and self-populates.  The flatten fast path recognizes the class and
reads ``.raw`` without ever triggering the parse; only slow-path matchers
and violation rendering — a tiny fraction of a sweep — pay for
materialization.
"""

from __future__ import annotations

import json


class RawJSON(dict):
    """Lazy dict view of one JSON document (bytes)."""

    __slots__ = ("raw", "_loaded")

    def __init__(self, raw: bytes):
        super().__init__()
        self.raw = raw
        self._loaded = False

    def _load(self):
        if not self._loaded:
            self._loaded = True
            obj = json.loads(self.raw)
            if isinstance(obj, dict):
                dict.update(self, obj)

    # -- read AND write accessors trigger the parse -----------------------
    # (a write before the parse would otherwise be silently overwritten
    # when a later read triggers _load's dict.update; and the mutation
    # plane's clear()/update() restore pattern must see loaded state)
    def __getitem__(self, k):
        self._load()
        return dict.__getitem__(self, k)

    def __setitem__(self, k, v):
        self._load()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._load()
        dict.__delitem__(self, k)

    def update(self, *args, **kwargs):
        self._load()
        dict.update(self, *args, **kwargs)

    def setdefault(self, k, default=None):
        self._load()
        return dict.setdefault(self, k, default)

    def pop(self, *args):
        self._load()
        return dict.pop(self, *args)

    def popitem(self):
        self._load()
        return dict.popitem(self)

    def clear(self):
        self._load()  # mark loaded so raw can't resurrect cleared keys
        dict.clear(self)

    def get(self, k, default=None):
        self._load()
        return dict.get(self, k, default)

    def __contains__(self, k):
        self._load()
        return dict.__contains__(self, k)

    def __iter__(self):
        self._load()
        return dict.__iter__(self)

    def __len__(self):
        self._load()
        return dict.__len__(self)

    def __bool__(self):
        self._load()
        return dict.__len__(self) > 0

    def keys(self):
        self._load()
        return dict.keys(self)

    def values(self):
        self._load()
        return dict.values(self)

    def items(self):
        self._load()
        return dict.items(self)

    def __eq__(self, other):
        self._load()
        if isinstance(other, RawJSON):
            other._load()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):  # dicts are unhashable; keep that behavior
        raise TypeError("unhashable type: 'RawJSON'")

    def copy(self):
        self._load()
        return dict(self)

    def __reduce__(self):
        # a materialized (possibly mutated) instance must round-trip its
        # CURRENT dict state — reconstructing from .raw would silently
        # revert mutations under copy/deepcopy/pickle
        if not self._loaded:
            return (RawJSON, (self.raw,))
        return (_restore_loaded, (self.raw, dict(self)))

    def __repr__(self):
        if not self._loaded:
            return f"RawJSON(<{len(self.raw)} bytes, unparsed>)"
        return f"RawJSON({dict.__repr__(self)})"


def _restore_loaded(raw: bytes, state: dict) -> "RawJSON":
    r = RawJSON(raw)
    r._loaded = True
    dict.update(r, state)
    return r


import re as _re

# head fast path: K8s serializations open with apiVersion/kind (in either
# order) — one anchored match on the first bytes resolves the top-level
# kind with no depth scan at all
_HEAD_KIND = _re.compile(
    rb'^\{"(?:apiVersion":"[^"\\]*",")?kind":"([^"\\]*)"')
_KIND_VAL = _re.compile(rb'\s*:\s*"([^"\\]*)"')


def peek_kind(obj) -> str:
    """Top-level ``kind`` of a K8s object WITHOUT materializing a RawJSON.

    The audit kind router classifies every listed object; going through
    ``obj.get("kind")`` would parse all N objects and push every chunk of
    the sweep onto the re-serialization path (a full json.dumps per
    object per chunk).  For an unloaded RawJSON this scans the raw bytes:
    find a ``"kind"`` key occurrence, verify by prefix scan that it sits
    at object depth 1 outside any string, then read its string value —
    K8s serializations carry kind in the first bytes, so the verify scan
    is ~a dozen bytes.  Falls back to the parse when the scan is
    inconclusive (escaped value, non-string kind)."""
    if not isinstance(obj, RawJSON) or obj._loaded:
        v = obj.get("kind")
        return v if isinstance(v, str) else ""
    raw = obj.raw
    m = _HEAD_KIND.match(raw)
    if m:
        try:
            return m.group(1).decode("utf-8")
        except UnicodeDecodeError:
            pass
    pos = 0
    # depth/in-string/escape state carried incrementally across candidate
    # positions: each '"kind"' occurrence only scans the bytes since the
    # previous one (a prefix rescan from 0 per candidate is O(occurrences
    # x object_size) on objects whose top-level kind serializes after
    # nested kind keys — ownerReferences, roleRef)
    depth = 0
    instr = False
    esc = False
    scanned = 0
    mv = memoryview(raw)
    while True:
        pos = raw.find(b'"kind"', pos)
        if pos < 0:
            return ""  # no "kind" bytes at all: the key cannot exist
        for b in mv[scanned:pos]:
            if esc:
                esc = False
            elif b == 0x5C:  # backslash
                esc = True
            elif b == 0x22:  # quote
                instr = not instr
            elif not instr:
                if b == 0x7B or b == 0x5B:  # { [
                    depth += 1
                elif b == 0x7D or b == 0x5D:  # } ]
                    depth -= 1
        scanned = pos
        if depth == 1 and not instr:
            m = _KIND_VAL.match(raw, pos + 6)
            if m:
                try:
                    return m.group(1).decode("utf-8")
                except UnicodeDecodeError:
                    break  # fall through to the exact parse
            break  # escaped or non-string value: exact parse
        pos += 6
    v = obj.get("kind")  # exact fallback (materializes this one object)
    return v if isinstance(v, str) else ""


def as_raw(obj) -> "RawJSON":
    """Wrap a dict (serializing once) or bytes into a RawJSON."""
    if isinstance(obj, RawJSON):
        return obj
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return RawJSON(bytes(obj))
    return RawJSON(json.dumps(obj, separators=(",", ":")).encode())


# one regex pass yields only strings and structural brackets; strings
# are consumed wholesale so brackets inside them never count
_STRUCT_TOKEN = _re.compile(rb'"(?:[^"\\]|\\.)*"|[{}\[\]]')


def split_list_items(page: bytes) -> tuple:
    """Split a K8s ``*List`` response into per-item raw byte spans.

    Returns ``(item_spans, envelope)``: the raw bytes of each element of
    the top-level ``items`` array, plus the envelope dict (the page with
    ``items`` replaced by ``[]`` — apiVersion/kind/metadata.continue
    parse from a few hundred bytes instead of the whole page).  This is
    the zero-copy half of the raw-bytes flatten path: list pages never
    materialize their items as Python dicts.

    Raises ``ValueError`` when the page has no top-level ``items`` array
    or carries non-object elements — callers fall back to the parsed
    page.
    """
    items: list = []
    depth = 0
    in_items = False
    pend_key = None  # (token bytes, token end) of the last depth-1 string
    items_lb = items_rb = -1
    elem_start = -1
    for m in _STRUCT_TOKEN.finditer(page):
        t = page[m.start()]
        if t == 0x22:  # string
            if depth == 1 and not in_items:
                pend_key = (m.group(), m.end())
            elif in_items and depth == 2:
                raise ValueError("non-object element in items")
            continue
        if t == 0x7B:  # {
            if in_items and depth == 2:
                elem_start = m.start()
            depth += 1
        elif t == 0x5B:  # [
            # an '[' at depth 1 in valid JSON can only be a key's value:
            # it opens the items array iff that key is "items"
            if (depth == 1 and not in_items and pend_key is not None
                    and pend_key[0] == b'"items"'
                    and page[pend_key[1]:m.start()].strip() == b":"):
                in_items = True
                items_lb = m.start()
            depth += 1
        elif t == 0x7D:  # }
            depth -= 1
            if in_items and depth == 2 and elem_start >= 0:
                items.append(page[elem_start:m.end()])
                elem_start = -1
        else:  # ]
            depth -= 1
            if in_items and depth == 1:
                in_items = False
                items_rb = m.end()
    if items_lb < 0 or items_rb < 0 or depth != 0:
        raise ValueError("no top-level items array")
    envelope = json.loads(page[:items_lb] + b"[]" + page[items_rb:])
    return items, envelope


def backfill_gvk(raw: bytes, api_version: str, kind: str) -> bytes:
    """Prepend apiVersion/kind defaults to one split List item (List
    responses omit them on elements).  JSON duplicate keys are last-wins
    (both ``json.loads`` and the native parser), so an item carrying
    either key keeps its own value — the byte-splice equivalent of
    ``dict.setdefault``, and it lands the keys where ``peek_kind``'s
    head fast path reads them."""
    if not raw.startswith(b"{"):
        return raw
    head = b'{"apiVersion":%s,"kind":%s' % (
        json.dumps(api_version).encode(), json.dumps(kind).encode())
    rest = raw[1:]
    if rest.lstrip().startswith(b"}"):
        return head + rest
    return head + b"," + rest
