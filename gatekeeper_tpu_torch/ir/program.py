"""PyTorch evaluation of predicate programs: the grid evaluator.

Port of ``gatekeeper_tpu/ir/program.py``.  The numpy helpers that build
parameter tables, vocab tables and batch columns are copied unchanged; the
expression evaluator is rewritten in torch ops.  Where the JAX package
``vmap``s a single-constraint evaluation over the parameter table, this
module carries the constraint axis explicitly: every value is a tensor
whose dim 0 is the constraint axis, of size C (it depends on a parameter
row) or 1 (it depends on the object columns only).  Values are aligned
like numpy broadcasts a single row's shapes (singleton dims inserted right
after dim 0), so the [C, N] grid equals the JAX ``vmap`` result bit for bit.

Dtypes follow the reference: int32 ids, float32 numbers, bool verdicts.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

import numpy as np
import torch

from gatekeeper_tpu_torch.ir import nodes as N
from gatekeeper_tpu_torch.ir.convert import to_tensor
from gatekeeper_tpu_torch.ops.flatten import (
    ColumnBatch,
    K_MAP,
    K_NUM,
    K_OTHER,
    K_STR,
    K_TRUE,
    KeySetCol,
    MapKeyCol,
    ParentIdxCol,
    RaggedCol,
    RaggedKeySetCol,
    ScalarCol,
    Vocab,
    f32_sat,
    round_up,
)

# Rego term-order rank per kind tag (value.py _TYPE_ORDER): null < bool <
# number < string < composites.  Indexed by kind tag (absent -> -1
# sentinel); numpy so importing this module never initializes a backend.
_RANK_BY_KIND = np.asarray([-1, 1, 1, 2, 3, 6, 0, 6], np.int8)


def _py_rank(v) -> int:
    if v is None:
        return 0
    if isinstance(v, bool):
        return 1
    if isinstance(v, (int, float)):
        return 2
    if isinstance(v, str):
        return 3
    return 6


def col_key(spec) -> str:
    """Stable string key for a column spec (jit pytrees need sortable dict
    keys)."""
    if isinstance(spec, ScalarCol):
        return "sc:" + ".".join(spec.path)
    if isinstance(spec, RaggedCol):
        return "rg:" + spec.axis.key() + ":" + ".".join(spec.subpath)
    if isinstance(spec, KeySetCol):
        return "ks:" + ".".join(spec.path)
    if isinstance(spec, RaggedKeySetCol):
        return "rks:" + spec.axis.key() + ":" + ".".join(spec.subpath)
    if isinstance(spec, MapKeyCol):
        return "mk:" + spec.axis.key()
    if isinstance(spec, ParentIdxCol):
        return "pi:" + spec.axis.key() + "|" + spec.parent.key()
    raise LowerError(f"unknown column spec {spec}")


def axis_key(axis) -> str:
    return "ax:" + axis.key()


class LowerError(Exception):
    """Raised when a template/expression is outside the vectorizable subset."""


# --------------------------------------------------------------------------
# parameter tables
# --------------------------------------------------------------------------


def _walk_expr(e, out: list):
    out.append(e)
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, N.Expr):
            _walk_expr(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, N.Expr):
                    _walk_expr(item, out)


def expr_nodes(program: N.Program) -> list:
    out: list = []
    _walk_expr(program.expr, out)
    return out


# --- vocab-derived tables (cached on the Vocab instance, extended lazily) --

_STR_FNS = {
    "units.parse_bytes": None,
    "units.parse": None,
}


def _apply_str_fn(fn: str, s: str):
    if fn == "cel.quantity":
        # k8s resource.Quantity semantics (CEL quantity()/isQuantity())
        from gatekeeper_tpu_torch.lang.cel.cel import _parse_quantity

        q = _parse_quantity(s)
        return None if q is None else float(q.value)
    from gatekeeper_tpu_torch.lang.rego import builtins as rb
    from gatekeeper_tpu_torch.lang.rego.value import UNDEFINED

    v = rb.REGISTRY[fn](s)
    return None if v is UNDEFINED else float(v)


_VOCAB_BUCKET = 1024


def _vpad(v: int) -> int:
    # vocab-axis bucketing: tables grow GEOMETRICALLY so jit shapes stay
    # stable across big interning bursts — audit sweeps intern every object
    # NAME, so linear buckets would cross a boundary (= XLA recompile of
    # every verdict program) on nearly every chunk
    p = _VOCAB_BUCKET
    while p < v:
        p *= 2
    return p


def fn_table(vocab: Vocab, fn: str):
    """[Vpad] (num f32, valid bool) for a string->number builtin, lazily
    extended as the vocab grows."""
    with vocab.held():
        cache = vocab.__dict__.setdefault("_fn_tables", {})
        num, valid, upto = cache.get(fn, (None, None, 0))
        v = len(vocab)
        if upto < v or num is None:
            import numpy as _np

            vp = _vpad(v)
            new_num = _np.zeros(vp, _np.float32)
            new_valid = _np.zeros(vp, bool)
            if num is not None:
                new_num[:upto] = num[:upto]
                new_valid[:upto] = valid[:upto]
            for i in range(upto, v):
                r = _apply_str_fn(fn, vocab.string(i))
                if r is not None:
                    new_num[i] = f32_sat(r)
                    new_valid[i] = True
            num, valid = new_num, new_valid
            cache[fn] = (num, valid, v)
        return num, valid


_PRED_IMPL = {
    "startswith": lambda s, n: s.startswith(n),
    "endswith": lambda s, n: s.endswith(n),
    "contains": lambda s, n: n in s,
}


def _re_pred(s: str, pattern: str) -> bool:
    import re as _re

    try:
        return _re.search(pattern, s) is not None
    except _re.error:
        return False


_PRED_IMPL["re_match"] = _re_pred


def pred_table_row(vocab: Vocab, op: str, needle: str) -> int:
    """Register (op, needle); returns the row index in the op's [T, V]
    matrix (see pred_matrix)."""
    with vocab.held():
        cache = vocab.__dict__.setdefault("_pred_tables", {})
        rows, _ = cache.setdefault(op, ({}, []))
        if needle not in rows:
            rows[needle] = len(rows)
        return rows[needle]


def _pred_row_fill(mat, ri: int, op: str, needle: str, strings: list,
                   start: int):
    """Fill mat[ri, start:start+len(strings)] with op(s, needle) —
    vectorized via numpy char ops where possible (the vocab grows O(N)
    with object names at audit scale; per-sid Python loops here would
    dominate the sweep)."""
    import numpy as _np

    if not strings:
        return
    if op in ("startswith", "endswith"):
        arr = _np.asarray(strings, dtype=object)
        fn = _np.char.startswith if op == "startswith" \
            else _np.char.endswith
        mat[ri, start: start + len(strings)] = fn(
            arr.astype(str), needle)
        return
    if op == "contains":
        arr = _np.asarray(strings, dtype=object).astype(str)
        mat[ri, start: start + len(strings)] = (
            _np.char.find(arr, needle) >= 0)
        return
    if op == "re_match":
        import re as _re

        try:
            rx = _re.compile(needle)
        except _re.error:
            mat[ri, start: start + len(strings)] = False
            return
        mat[ri, start: start + len(strings)] = [
            rx.search(s) is not None for s in strings
        ]
        return
    impl = _PRED_IMPL[op]
    mat[ri, start: start + len(strings)] = [
        impl(s, needle) for s in strings
    ]


def pred_matrix(vocab: Vocab, op: str):
    """[T, Vpad] bool matrix for op, rows in registration order, extended
    incrementally as needles/vocab grow (bucketed V keeps jit shapes
    stable)."""
    import numpy as _np

    with vocab.held():
        cache = vocab.__dict__.setdefault("_pred_tables", {})
        rows, memo = cache.setdefault(op, ({}, []))
        v = len(vocab)
        if memo:
            (prev_t, prev_v), mat = memo
            if prev_t == len(rows) and prev_v >= v and mat.shape[1] >= v:
                return mat
            vp = max(_vpad(v), mat.shape[1])
            new = _np.zeros((max(len(rows), 1), vp), bool)
            new[: mat.shape[0], : mat.shape[1]] = mat
            # new needles: full scan; existing needles: only new vocab
            # entries
            tail = [vocab.string(s) for s in range(prev_v, v)]
            full = None
            for needle, ri in rows.items():
                if ri >= prev_t:
                    if full is None:
                        full = [vocab.string(s) for s in range(v)]
                    _pred_row_fill(new, ri, op, needle, full, 0)
                else:
                    _pred_row_fill(new, ri, op, needle, tail, prev_v)
            mat = new
        else:
            vp = _vpad(v)
            mat = _np.zeros((max(len(rows), 1), vp), bool)
            strings = [vocab.string(s) for s in range(v)]
            for needle, ri in rows.items():
                _pred_row_fill(mat, ri, op, needle, strings, 0)
        memo.clear()
        memo.extend(((len(rows), v), mat))
        return mat


def _needle_xform(needle, s: str) -> str:
    """Static needle transform: strips first (trim_prefix/trim_suffix
    no-op when the affix is absent), then concatenation."""
    sp = getattr(needle, "strip_prefix", "")
    ss = getattr(needle, "strip_suffix", "")
    if sp and s.startswith(sp):
        s = s[len(sp):]
    if ss and s.endswith(ss):
        s = s[: len(s) - len(ss)]
    return needle.prefix + s + needle.suffix


def _xf_tag(needle) -> str:
    parts = (needle.prefix, needle.suffix,
             getattr(needle, "strip_prefix", ""),
             getattr(needle, "strip_suffix", ""))
    return "|" + "|".join(parts) if any(parts) else ""


def strtab_key(op: str, needle) -> str:
    if isinstance(needle, N.ParamElemFieldSid):
        base = f"{needle.param}.{'.'.join(needle.field)}"
        return f"{base}__strtab_{op}{_xf_tag(needle)}"
    base = needle.param
    return f"{base}__strtab_{op}{_xf_tag(needle)}"


_MISSING = object()


def p_has(params: dict, name: str) -> bool:
    """Presence of a parameter: literal key first (parameters may
    legally contain dots, e.g. annotation keys), then as a dotted path
    (nested object params like runAsUser.rule lower to dotted ParamSpec
    names)."""
    return p_get(params, name, _MISSING) is not _MISSING


def p_get(params: dict, name: str, default=None):
    """Fetch a parameter by literal key, falling back to a dotted-path
    walk (utils.unstructured.deep_get)."""
    if isinstance(params, dict) and name in params:
        return params[name]
    from gatekeeper_tpu_torch.utils.unstructured import deep_get

    return deep_get(params, name.split("."), default)


def build_param_table(program: N.Program, constraints, vocab: Vocab) -> dict:
    """Pack constraint parameters into arrays [C, ...] for vmap.

    Unseen strings are interned (parameters are part of the program, so their
    vocabulary must be in the table before eval).
    """
    c = len(constraints)
    # always one leaf so vmap has a mapped axis even for param-less templates
    table: dict[str, Any] = {"__row__": np.zeros(c, np.int8)}
    params_by_con = [
        (con.parameters or {}) if isinstance(con.parameters, dict) else {}
        for con in constraints
    ]
    for spec in program.params:
        vals = [p_get(p, spec.name) for p in params_by_con]
        # every param row carries a kind tag: 0 absent, 1 false, 2 true,
        # 3 present-non-bool — so ParamTruthy (>=2), ParamPresent (>0) and
        # the exact ParamBoolIs (==2 / ==1) all read the same encoding
        table[f"{spec.name}__kind"] = np.asarray(
            [0 if v is None else (2 if v is True else (1 if v is False else 3))
             for v in vals], np.int8)
        if spec.kind == "num":
            # f32_sat: the explicit number->float32 saturation policy
            # (ops/flatten.py) — parameters beyond the float32 range
            # become ±inf like every data column, never a silent
            # RuntimeWarning-carrying cast
            table[f"{spec.name}__num"] = np.asarray(
                [f32_sat(v) if isinstance(v, (int, float))
                 and not isinstance(v, bool)
                 else 0.0 for v in vals], np.float32)
            table[f"{spec.name}__isnum"] = np.asarray(
                [isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in vals], np.bool_)
            # parameters keep full term-order info: a string-valued "numeric"
            # parameter still participates in Rego's total ordering
            table[f"{spec.name}__present"] = np.asarray(
                [p_has(params_by_con[i], spec.name) for i in range(c)],
                np.bool_)
            table[f"{spec.name}__rank"] = np.asarray(
                [_py_rank(v) for v in vals], np.int8)
        elif spec.kind == "str":
            table[f"{spec.name}__sid"] = np.asarray(
                [vocab.intern(v) if isinstance(v, str) else -2 for v in vals],
                np.int32)
            table[f"{spec.name}__present"] = np.asarray(
                [isinstance(v, str) for v in vals], np.bool_)
        elif spec.kind == "bool":
            pass  # the __kind tag above is the entire encoding
        elif spec.kind == "strlist":
            lists = [
                [vocab.intern(x) for x in v if isinstance(x, str)]
                if isinstance(v, list) else [] for v in vals
            ]
            k = round_up(max((len(x) for x in lists), default=0))
            arr = np.full((c, k), -1, np.int32)
            cnt = np.zeros(c, np.int32)
            for i, xs in enumerate(lists):
                cnt[i] = len(xs)
                arr[i, : len(xs)] = xs
            table[f"{spec.name}__sids"] = np.asarray(arr)
            table[f"{spec.name}__count"] = np.asarray(cnt)
        elif spec.kind == "numlist":
            lists = [
                [f32_sat(x) for x in v
                 if isinstance(x, (int, float)) and not isinstance(x, bool)]
                if isinstance(v, list) else [] for v in vals
            ]
            k = round_up(max((len(x) for x in lists), default=0))
            arr = np.zeros((c, k), np.float32)
            cnt = np.zeros(c, np.int32)
            for i, xs in enumerate(lists):
                cnt[i] = len(xs)
                arr[i, : len(xs)] = xs
            table[f"{spec.name}__nums"] = np.asarray(arr)
            table[f"{spec.name}__count"] = np.asarray(cnt)
        elif spec.kind == "objlist":
            lists = [v if isinstance(v, list) else [] for v in vals]
            k = round_up(max((len(x) for x in lists), default=0))
            cnt = np.zeros(c, np.int32)
            for i, xs in enumerate(lists):
                cnt[i] = len(xs)
            table[f"{spec.name}__count"] = np.asarray(cnt)
            for field, ftype in spec.fields:
                dotted = ".".join(field)
                if ftype == "num":
                    arr = np.zeros((c, k), np.float32)
                else:
                    arr = np.full((c, k), -2, np.int32)
                ok = np.zeros((c, k), bool)
                rank = np.full((c, k), -1, np.int8)
                fpresent = np.zeros((c, k), bool)
                for i, xs in enumerate(lists):
                    for j, item in enumerate(xs):
                        cur = item
                        found = isinstance(item, dict)
                        for part in field:
                            if isinstance(cur, dict) and part in cur:
                                cur = cur[part]
                            else:
                                cur, found = None, False
                                break
                        if found:
                            fpresent[i, j] = True
                            rank[i, j] = _py_rank(cur)
                        if ftype == "num" and found and isinstance(
                                cur, (int, float)) and not isinstance(
                                cur, bool):
                            arr[i, j] = f32_sat(cur)
                            ok[i, j] = True
                        elif ftype == "str" and found and isinstance(cur,
                                                                     str):
                            arr[i, j] = vocab.intern(cur)
                            ok[i, j] = True
                suffix = "__nums" if ftype == "num" else "__sids"
                table[f"{spec.name}.{dotted}{suffix}"] = np.asarray(arr)
                table[f"{spec.name}.{dotted}__ok"] = np.asarray(ok)
                table[f"{spec.name}.{dotted}__rank"] = np.asarray(rank)
                table[f"{spec.name}.{dotted}__fpresent"] = np.asarray(
                    fpresent)
        else:
            raise LowerError(f"unknown param kind {spec.kind}")

    # --- derived entries: string-fn params and string-pred needle rows ----
    for node in expr_nodes(program):
        if isinstance(node, N.ParamFnNum):
            vals = [p_get(p, node.name) for p in params_by_con]
            nums = np.zeros(c, np.float32)
            ok = np.zeros(c, bool)
            for i, v in enumerate(vals):
                if isinstance(v, str):
                    r = _apply_str_fn(node.fn, v)
                    if r is not None:
                        nums[i] = f32_sat(r)
                        ok[i] = True
            table[f"{node.name}__fn_{node.fn}__num"] = np.asarray(nums)
            table[f"{node.name}__fn_{node.fn}__ok"] = np.asarray(ok)
        elif isinstance(node, N.StrPred):
            needle = node.needle
            if isinstance(needle, N.ParamElemSid):
                raise LowerError(
                    "StrPred over bare string-list elements needs the "
                    "param name; use ParamElemFieldSid or the lowering's "
                    "strlist path"
                )
            if isinstance(needle, N.ParamElemFieldSid):
                # rows per (constraint, element): [C, K]
                key = strtab_key(node.op, needle)
                if key in table:
                    continue
                lists = [
                    (p_get(p, needle.param) if isinstance(
                        p_get(p, needle.param), list) else [])
                    for p in params_by_con
                ]
                k = round_up(max((len(x) for x in lists), default=0))
                rowidx = np.zeros((c, k), np.int32)
                ok = np.zeros((c, k), bool)
                for i, xs in enumerate(lists):
                    for j, item in enumerate(xs):
                        cur = item
                        for part in needle.field:
                            cur = cur.get(part) if isinstance(cur, dict) \
                                else None
                        if isinstance(cur, str):
                            rowidx[i, j] = pred_table_row(
                                vocab, node.op, _needle_xform(needle, cur))
                            ok[i, j] = True
                table[key] = np.asarray(rowidx)
                table[key + "__ok"] = np.asarray(ok)
            elif isinstance(needle, _ELEM_OF):
                # string-list elements: rows [C, K] from the list itself
                pname = needle.param
                key = strtab_key(node.op, needle)
                if key in table:
                    continue
                lists = [
                    [x for x in (p_get(p, pname) or [])
                     if isinstance(x, str)]
                    if isinstance(p_get(p, pname), list) else []
                    for p in params_by_con
                ]
                k = round_up(max((len(x) for x in lists), default=0))
                rowidx = np.zeros((c, k), np.int32)
                ok = np.zeros((c, k), bool)
                for i, xs in enumerate(lists):
                    for j, x in enumerate(xs):
                        rowidx[i, j] = pred_table_row(
                            vocab, node.op, _needle_xform(needle, x))
                        ok[i, j] = True
                table[key] = np.asarray(rowidx)
                table[key + "__ok"] = np.asarray(ok)
            elif isinstance(needle, N.ParamSid):
                key = f"{needle.name}__strtab_{node.op}"
                if key in table:
                    continue
                vals2 = [p_get(p, needle.name) for p in params_by_con]
                rowidx = np.zeros(c, np.int32)
                ok = np.zeros(c, bool)
                for i, v in enumerate(vals2):
                    if isinstance(v, str):
                        rowidx[i] = pred_table_row(vocab, node.op, v)
                        ok[i] = True
                table[key] = np.asarray(rowidx)
                table[key + "__ok"] = np.asarray(ok)
            elif isinstance(needle, N.ConstSid):
                key = f"__const{needle.sid}__strtab_{node.op}"
                if key in table:
                    continue
                rowidx = np.full(
                    c, pred_table_row(vocab, node.op,
                                      vocab.string(needle.sid)), np.int32)
                table[key] = np.asarray(rowidx)
                table[key + "__ok"] = np.asarray(np.ones(c, bool))
    return table


class _ElemListSid(N.Expr):
    """Marker: StrPred needle iterating a plain string-list param, with an
    optional static transform: strip_prefix/strip_suffix (trim_prefix /
    trim_suffix — no-op when absent, Rego semantics) applied first, then
    prefix/suffix concatenation (concat idiom)."""

    __slots__ = ("param", "prefix", "suffix", "strip_prefix",
                 "strip_suffix")

    def __init__(self, param: str, prefix: str = "", suffix: str = "",
                 strip_prefix: str = "", strip_suffix: str = ""):
        self.param = param
        self.prefix = prefix
        self.suffix = suffix
        self.strip_prefix = strip_prefix
        self.strip_suffix = strip_suffix

    def _key(self):
        return (self.param, self.prefix, self.suffix, self.strip_prefix,
                self.strip_suffix)

    def __hash__(self):
        return hash(("_ElemListSid",) + self._key())

    def __eq__(self, other):
        return (isinstance(other, _ElemListSid)
                and other._key() == self._key())


_ELEM_OF = _ElemListSid


def needed_fields(program: N.Program) -> dict:
    """col_key -> set of array fields the program's evaluator actually
    reads.  Drives transfer slimming: the flattener materializes kind/num/
    sid for every column, but e.g. a Truthy-only column never needs its num
    or sid array on device."""
    need: dict = {}

    def add(spec, *fields):
        need.setdefault(col_key(spec), set()).update(fields)

    for node in expr_nodes(program):
        if isinstance(node, (N.Truthy, N.Present, N.KindIs)):
            add(node.col, "kind")
        elif isinstance(node, N.FeatNum):
            add(node.col, "kind", "num")
        elif isinstance(node, N.FeatSid):
            add(node.col, "kind", "sid")
        elif isinstance(node, N.FeatEqFeat):
            add(node.lhs, "kind", "num", "sid")
            add(node.rhs, "kind", "num", "sid")
        elif isinstance(node, N.CountNum):
            add(node.col, "kind", "sid")
        elif isinstance(node, (N.KeySetContains, N.RaggedKeySetContains)):
            add(node.keyset, "sid", "count")
        elif isinstance(node, N.MapKeySid):
            add(node.col, "sid")
        elif isinstance(node, N.NestedAny):
            add(node.col, "idx")
            add(node.parent_col, "kind")
        elif isinstance(node, N.InventoryUniqueJoin):
            add(node.ns_col, "sid")
            add(node.name_col, "sid")
    return need


def slim_cols(cols: dict, needs: dict) -> dict:
    """Drop per-column arrays no program reads (axis counts and vocab
    tables always ship — they are tiny or shared)."""
    out = {}
    for key, val in cols.items():
        if not isinstance(val, dict):
            out[key] = val  # axis counts / vocab tables
            continue
        want = needs.get(key)
        if want is None:
            out[key] = val  # unknown consumer: keep everything
        else:
            out[key] = {k: v for k, v in val.items() if k in want}
    return out


def pack_batch_cols(batch: ColumnBatch) -> dict:
    """cols dict (numpy) from a ColumnBatch — the single packing shared by
    CompiledProgram.run, the sharded sweep, and the driver entry points."""
    cols: dict = {}
    for spec, col in batch.scalars.items():
        cols[col_key(spec)] = {"kind": col.kind, "num": col.num,
                               "sid": col.sid}
    for spec, col in batch.raggeds.items():
        cols[col_key(spec)] = {"kind": col.kind, "num": col.num,
                               "sid": col.sid}
    for axis, cnt in batch.axis_counts.items():
        cols[axis_key(axis)] = cnt
    for spec, col in batch.keysets.items():
        cols[col_key(spec)] = {"sid": col.sid, "count": col.count}
    for spec, col in batch.ragged_keysets.items():
        cols[col_key(spec)] = {"sid": col.sid, "count": col.count}
    for spec, col in batch.map_keys.items():
        cols[col_key(spec)] = {"sid": col.sid}
    for spec, col in batch.parent_idx.items():
        cols[col_key(spec)] = {"idx": col.idx}
    for spec, sids in batch.canons.items():
        cols[canon_key(spec)] = {"sid": sids}
    return cols


def canon_key(col) -> str:
    return f"canon:{'.'.join(col.path)}|{int(col.ns_scoped)}"


def walk_join_values(obj, join_path) -> list:
    """Values at ``join_path`` under ``obj``, fanning out at '*' (lists and
    map values) — the single definition of the inventory-join walk, shared
    by the device table builder and the TPU driver's render-time
    candidate index (they must agree exactly)."""
    vals: list = [obj]
    for part in join_path:
        nxt: list = []
        for v in vals:
            if part == "*":
                if isinstance(v, list):
                    nxt.extend(v)
                elif isinstance(v, dict):
                    nxt.extend(v.values())
            elif isinstance(v, dict) and part in v:
                nxt.append(v[part])
        vals = nxt
    return vals


def build_inventory_tables(program: N.Program, data_tree: dict,
                           vocab: Vocab) -> tuple:
    """(cols dict, exact: bool) for the program's InvTableSpecs from the
    interpreter's data tree.  exact=False when the inventory contains
    non-string join values (the sid join can't represent them: the caller
    must fall back to the interpreter for this template)."""
    import re as _re

    out: dict = {}
    exact = True
    inv = (data_tree or {}).get("inventory", {})
    for node in expr_nodes(program):
        if not isinstance(node, N.InventoryUniqueJoin):
            continue
        spec = node.spec
        key = spec.key()
        if f"inv:{key}:cnt" in out:
            continue
        owners_by_sid: dict = {}
        rx = _re.compile(spec.apiver_regex) if spec.apiver_regex else None
        if spec.scope == "cluster":
            # data.inventory.cluster[apiver][Kind][name]: one pseudo
            # namespace level so the loop below serves both scopes
            scoped = {"": inv.get("cluster", {}) or {}}
        else:
            scoped = inv.get("namespace", {}) or {}
        for ns, by_apiver in scoped.items():
            if not isinstance(by_apiver, dict):
                continue
            for apiver, by_kind in by_apiver.items():
                if rx is not None and not rx.search(str(apiver)):
                    continue
                if not isinstance(by_kind, dict):
                    continue
                objs = by_kind.get(spec.kind)
                if not isinstance(objs, dict):
                    continue
                for _name, obj in objs.items():
                    meta = obj.get("metadata", {}) if isinstance(
                        obj, dict) else {}
                    ons = meta.get("namespace") if isinstance(
                        meta, dict) else None
                    onm = meta.get("name") if isinstance(meta, dict) \
                        else None
                    # ABSENT owner fields make identical() undefined (the
                    # entry always counts): sentinel -2 never matches an
                    # object sid.  A PRESENT non-string field — including
                    # null, since null == null is defined-true in Rego —
                    # could still satisfy the equality -> inexact.
                    for f in ("namespace", "name"):
                        if isinstance(meta, dict) and f in meta \
                                and not isinstance(meta[f], str):
                            exact = False
                    owner = (
                        vocab.intern(ons) if isinstance(ons, str) else -2,
                        vocab.intern(onm) if isinstance(onm, str) else -2,
                    )
                    if spec.transform == "selector_canon":
                        from gatekeeper_tpu_torch.ops.flatten import \
                            selector_canon

                        node_val = obj
                        for part in spec.join_path:
                            node_val = node_val.get(part) \
                                if isinstance(node_val, dict) else None
                        canon = selector_canon(node_val)
                        if spec.ns_scoped:
                            if not isinstance(ns, str) or not ns:
                                continue
                            canon = ns + "\x00" + canon
                        owners_by_sid.setdefault(
                            vocab.intern(canon), set()).add(owner)
                        continue
                    for v in walk_join_values(obj, spec.join_path):
                        if isinstance(v, str):
                            owners_by_sid.setdefault(
                                vocab.intern(v), set()).add(owner)
                        else:
                            # a non-string join value can satisfy the Rego
                            # equality against an equal non-string subject
                            exact = False
        vp = _vpad(len(vocab))
        cnt = np.zeros(vp, np.int32)
        ons_arr = np.full(vp, -3, np.int32)
        onm_arr = np.full(vp, -3, np.int32)
        for sid, owners in owners_by_sid.items():
            cnt[sid] = len(owners)
            if len(owners) == 1:
                ons_arr[sid], onm_arr[sid] = next(iter(owners))
        out[f"inv:{key}:cnt"] = cnt
        out[f"inv:{key}:ons"] = ons_arr
        out[f"inv:{key}:onm"] = onm_arr
    return out, exact


def extdata_key_cols(program: N.Program) -> tuple:
    """(provider -> set of subject column specs, extractable) for the
    program's external-data joins.  The driver dedupes each batch's key
    strings from these columns' sid arrays before asking the lane for
    join tables.  ``extractable`` is False when any subject is not a
    plain column read (the lane could not guarantee table coverage, so
    the kind must take the interpreter) — the lowering only emits
    FeatSid subjects, this is the defensive check."""
    out: dict = {}
    extractable = True
    for node in expr_nodes(program):
        if isinstance(node, (N.ExtDataOk, N.ExtDataValueSid)):
            if isinstance(node.subject, N.FeatSid):
                out.setdefault(node.provider, set()).add(node.subject.col)
            else:
                extractable = False
    return out, extractable


def vocab_tables(program: N.Program, vocab: Vocab) -> dict:
    """Shared (non-vmapped) vocab-derived arrays for the cols dict."""
    out = {}
    for node in expr_nodes(program):
        if isinstance(node, N.StrFnNum):
            num, valid = fn_table(vocab, node.fn)
            out[f"fn:{node.fn}:num"] = num
            out[f"fn:{node.fn}:ok"] = valid
        elif isinstance(node, N.StrFnValid):
            _num, valid = fn_table(vocab, node.fn)
            out[f"fn:{node.fn}:ok"] = valid
        elif isinstance(node, N.StrPred):
            out[f"st:{node.op}"] = pred_matrix(vocab, node.op)
        elif isinstance(node, N.CountNum):
            num, valid = fn_table(vocab, "count")
            out["fn:count:num"] = num
            out["fn:count:ok"] = valid
    return out


# --------------------------------------------------------------------------
# expression evaluation (explicit constraint axis at dim 0)
# --------------------------------------------------------------------------

# per-object column arrays gain the constraint axis (size 1) when a
# program evaluates; shared lookup tables (gathered by value) do not
_TABLE_PREFIXES = ("fn:", "st:", "inv:", "ext:")


def is_table_key(key: str) -> bool:
    return key.startswith(_TABLE_PREFIXES)


class _Ctx:
    __slots__ = ("cols", "row", "axis", "elem_k", "device", "rank_tab",
                 "consts")

    def __init__(self, cols: dict, row: dict, device, consts: dict):
        self.cols = cols  # column key -> arrays dict / table, see _batched
        self.row = row  # parameter table: name -> [C, ...]
        self.axis = None  # active Axis inside AnyAxis
        self.elem_k = None  # active K inside AnyParamList
        self.device = device
        # the program's device constants (see CompiledProgram.grid)
        self.consts = consts
        key = (device, "rank_tab")
        tab = consts.get(key)
        if tab is None:
            tab = consts[key] = torch.from_numpy(_RANK_BY_KIND).to(device)
        self.rank_tab = tab


def _al(*ts):
    """Align values for a broadcast op: per-row shapes broadcast like
    numpy (leading singleton dims), so a lower-rank value gains size-1
    dims right after the constraint axis."""
    nd = max(t.dim() for t in ts)
    out = []
    for t in ts:
        while t.dim() < nd:
            t = t.unsqueeze(1)
        out.append(t)
    return out


def _and(*ts):
    ts = _al(*ts)
    out = ts[0]
    for t in ts[1:]:
        out = out & t
    return out


def _where(c, x, y):
    c, x, y = _al(c, x, y)
    return torch.where(c, x, y)


def _const(ctx: _Ctx, value, dtype):
    key = (ctx.device, dtype, type(value), value)
    t = ctx.consts.get(key)
    if t is None:
        t = ctx.consts[key] = torch.tensor([value], dtype=dtype,
                                           device=ctx.device)
    return t


def _gather(table, idx):
    """table[clip(idx, 0, len - 1)]: a clamped lookup in a shared table."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def _feat_arrays(ctx: _Ctx, col) -> dict:
    try:
        return ctx.cols[col_key(col)]
    except KeyError:
        raise LowerError(f"column {col} not in batch") from None


def _expand_for_ctx(ctx: _Ctx, arr, is_ragged: bool):
    """Bring a feature array [1, N, M?] to the active [1, N, M?, K?]
    shape."""
    if ctx.axis is not None and not is_ragged:
        arr = arr[:, :, None]
    if ctx.elem_k is not None:
        arr = arr[..., None]
    return arr


def _eval_cmp_operand(ctx: _Ctx, e: N.Expr):
    """(num, term_rank, is_num, present) for a comparison operand — Rego's
    ordered comparisons are total across types (term order, value.py
    compare()), see the JAX package's twin."""
    if isinstance(e, N.FeatNum):
        a = _feat_arrays(ctx, e.col)
        ragged = isinstance(e.col, RaggedCol)
        kind = _expand_for_ctx(ctx, a["kind"], ragged)
        return (
            _expand_for_ctx(ctx, a["num"], ragged),
            ctx.rank_tab[kind.long()],
            kind == K_NUM,
            kind > 0,
        )
    if isinstance(e, N.ParamNum):
        return (ctx.row[f"{e.name}__num"],
                ctx.row[f"{e.name}__rank"],
                ctx.row[f"{e.name}__isnum"],
                ctx.row[f"{e.name}__present"])
    if isinstance(e, N.ConstNum):
        return (_const(ctx, float(e.value), torch.float32),
                _const(ctx, 2, torch.int8), _const(ctx, True, torch.bool),
                _const(ctx, True, torch.bool))
    if isinstance(e, N.ParamElemFieldNum):
        if ctx.elem_k is None:
            raise LowerError("ParamElemFieldNum outside AnyParamList")
        dotted = ".".join(e.field)
        return (ctx.row[f"{e.param}.{dotted}__nums"],
                ctx.row[f"{e.param}.{dotted}__rank"],
                ctx.row[f"{e.param}.{dotted}__ok"],
                ctx.row[f"{e.param}.{dotted}__fpresent"])
    if isinstance(e, N.ParamFnNum):
        ok = ctx.row[f"{e.name}__fn_{e.fn}__ok"]
        return (ctx.row[f"{e.name}__fn_{e.fn}__num"],
                _const(ctx, 2, torch.int8), ok, ok)
    if isinstance(e, N.StrFnNum):
        sid, sok, _spresent = _eval_sidlike(ctx, e.operand)
        num = ctx.cols[f"fn:{e.fn}:num"]
        ok = ctx.cols[f"fn:{e.fn}:ok"]
        # units.parse of a non-string / unparseable string is UNDEFINED in
        # Rego (builtin error), so validity gates the whole comparison
        valid = _and(sok, sid >= 0, _gather(ok, sid))
        return _gather(num, sid), _const(ctx, 2, torch.int8), valid, valid
    if isinstance(e, N.NumBin):
        # float32 arithmetic, as in the reference's eval plane
        lv, _lr, ln, lp = _eval_cmp_operand(ctx, e.lhs)
        rv, _rr, rn, rp = _eval_cmp_operand(ctx, e.rhs)
        valid = _and(ln, rn, lp, rp)
        lv, rv = _al(lv, rv)
        if e.op == "add":
            num = lv + rv
        elif e.op == "sub":
            num = lv - rv
        elif e.op == "mul":
            num = lv * rv
        else:  # div: Rego errors (undefined) on division by zero
            valid = _and(valid, rv != 0)
            num = lv / torch.where(rv == 0, torch.ones_like(rv), rv)
        return num, _const(ctx, 2, torch.int8), valid, valid
    if isinstance(e, N.CountNum):
        a = _feat_arrays(ctx, e.col)
        kind = _expand_for_ctx(ctx, a["kind"], False)
        sid = _expand_for_ctx(ctx, a["sid"], False)
        cnt = _expand_for_ctx(ctx, ctx.cols[axis_key(e.axis)], False)
        strlen = ctx.cols["fn:count:num"]
        num = _where(kind == K_STR, _gather(strlen, sid),
                     cnt.to(torch.float32))
        # count() is defined for strings and composites only
        valid = (kind == K_STR) | (kind == K_OTHER) | (kind == K_MAP)
        return num, _const(ctx, 2, torch.int8), valid, valid
    raise LowerError(f"not a numeric operand: {e}")


def _eval_sidlike(ctx: _Ctx, e: N.Expr):
    """(sid, is_string, present)."""
    if isinstance(e, N.FeatSid):
        a = _feat_arrays(ctx, e.col)
        ragged = isinstance(e.col, RaggedCol)
        kind = _expand_for_ctx(ctx, a["kind"], ragged)
        return (
            _expand_for_ctx(ctx, a["sid"], ragged),
            kind == K_STR,
            kind > 0,
        )
    if isinstance(e, N.CanonFeatSid):
        a = ctx.cols.get(canon_key(e.col))
        if a is None:
            raise LowerError(f"canon column {e.col} not in batch")
        sid = _expand_for_ctx(ctx, a["sid"], False)
        ok = sid >= 0  # -2 = the canon idiom errors on this object
        return sid, ok, ok
    if isinstance(e, N.ParamSid):
        ok = ctx.row[f"{e.name}__present"]
        return ctx.row[f"{e.name}__sid"], ok, ok
    if isinstance(e, N.ConstSid):
        t = _const(ctx, True, torch.bool)
        return _const(ctx, e.sid, torch.int32), t, t
    if isinstance(e, N.ParamElemSid):
        if ctx.elem_k is None:
            raise LowerError("ParamElemSid outside AnyParamList")
        t = _const(ctx, True, torch.bool)
        return ctx.elem_k, t, t
    if isinstance(e, N.ParamElemFieldSid):
        if ctx.elem_k is None:
            raise LowerError("ParamElemFieldSid outside AnyParamList")
        dotted = ".".join(e.field)
        ok = ctx.row[f"{e.param}.{dotted}__ok"]
        return ctx.row[f"{e.param}.{dotted}__sids"], ok, ok
    if isinstance(e, N.MapKeySid):
        a = ctx.cols.get(col_key(e.col))
        if a is None:
            raise LowerError(f"map-key column {e.col} not in batch")
        sid = _expand_for_ctx(ctx, a["sid"], True)  # ragged-shaped
        # list-backed items carry sid -1: their Rego key is an int index —
        # PRESENT (neq against it is defined-true) but not a string
        is_str = sid >= 0
        return sid, is_str, torch.ones_like(is_str)
    if isinstance(e, N.ExtDataValueSid):
        resolved = _eval_extdata_ok(ctx, e.provider, e.subject)
        sid, _sok, _sp = _eval_sidlike(ctx, e.subject)
        v = _gather(ctx.cols[f"ext:{e.provider}:val"], sid)
        v = _where(resolved, v, torch.full_like(v, -3))
        return v, _and(resolved, v >= 0), resolved
    raise LowerError(f"not a string operand: {e}")


def _eval_extdata_ok(ctx: _Ctx, provider: str, subject: N.Expr):
    """Subject is a string whose key sid is inside the provider table and
    landed without a per-key error."""
    sid, sok, _sp = _eval_sidlike(ctx, subject)
    ok = ctx.cols.get(f"ext:{provider}:ok")
    if ok is None:
        raise LowerError(f"extdata table for provider {provider!r} "
                         "not in batch")
    return _and(sok, sid >= 0, sid < ok.shape[0], _gather(ok, sid))


_CMP = {
    "lt": torch.lt,
    "lte": torch.le,
    "gt": torch.gt,
    "gte": torch.ge,
    "eq": torch.eq,
    "neq": torch.ne,
}


def _valid_upto(width: int, cnt, device):
    """arange(width) < cnt[..., None]: the live slots of a padded axis."""
    return torch.arange(width, dtype=torch.int32, device=device) \
        < cnt[..., None]


def _contains(keys, valid, nv, nok, elem: bool):
    """Membership of needle sids in a padded key list (last axis)."""
    if elem:
        # needle [.., K]; keys [.., L] -> compare [.., K, L]
        k4, n4, v4 = _al(keys[..., None, :], nv[..., :, None],
                         valid[..., None, :])
        hit = torch.any((k4 == n4) & v4, dim=-1)
    else:
        k3, n3, v3 = _al(keys, nv[..., None], valid)
        hit = torch.any((k3 == n3) & v3, dim=-1)
    return _and(hit, nok)


def eval_expr(ctx: _Ctx, e: N.Expr):
    if isinstance(e, N.ConstBool):
        return _const(ctx, bool(e.value), torch.bool)
    if isinstance(e, N.Truthy):
        a = _feat_arrays(ctx, e.col)
        ragged = isinstance(e.col, RaggedCol)
        return _expand_for_ctx(ctx, a["kind"] >= K_TRUE, ragged)
    if isinstance(e, N.Present):
        a = _feat_arrays(ctx, e.col)
        ragged = isinstance(e.col, RaggedCol)
        return _expand_for_ctx(ctx, a["kind"] > 0, ragged)
    if isinstance(e, N.ParamTruthy):
        return ctx.row[f"{e.name}__kind"] >= 2
    if isinstance(e, N.ParamPresent):
        return ctx.row[f"{e.name}__kind"] > 0
    if isinstance(e, N.ParamBoolIs):
        return ctx.row[f"{e.name}__kind"] == (2 if e.want else 1)
    if isinstance(e, N.KindIs):
        a = _feat_arrays(ctx, e.col)
        ragged = isinstance(e.col, RaggedCol)
        return _expand_for_ctx(ctx, a["kind"] == e.kind, ragged)
    if isinstance(e, N.StrFnValid):
        sid, sok, _sp = _eval_sidlike(ctx, e.operand)
        ok = ctx.cols[f"fn:{e.fn}:ok"]
        return _and(sok, sid >= 0, _gather(ok, sid))
    if isinstance(e, N.ExtDataOk):
        return _eval_extdata_ok(ctx, e.provider, e.subject)
    if isinstance(e, N.CmpNum):
        lv, lrank, lnum, lpres = _eval_cmp_operand(ctx, e.lhs)
        rv, rrank, rnum, rpres = _eval_cmp_operand(ctx, e.rhs)
        both_num = _and(lnum, rnum)
        num_res = _CMP[e.op](*_al(lv, rv))
        if e.op == "eq":
            cross = _const(ctx, False, torch.bool)  # types never equal
        elif e.op == "neq":
            cross = _const(ctx, True, torch.bool)
        else:
            # total term order across types (value.py compare())
            cross = _CMP[e.op](*_al(lrank.to(torch.int8),
                                    rrank.to(torch.int8)))
        return _and(lpres, rpres, _where(both_num, num_res, cross))
    if isinstance(e, N.EqStr):
        lv, lok, lpres = _eval_sidlike(ctx, e.lhs)
        rv, rok, rpres = _eval_sidlike(ctx, e.rhs)
        eq_true = _and(lok, rok, torch.eq(*_al(lv, rv)))
        if e.negate:
            # Rego: 5 != "x" is TRUE (defined inequality across types)
            return _and(lpres, rpres, torch.logical_not(eq_true))
        return eq_true
    if isinstance(e, N.FeatEqFeat):
        la = _feat_arrays(ctx, e.lhs)
        ra = _feat_arrays(ctx, e.rhs)
        lrag = isinstance(e.lhs, RaggedCol)
        rrag = isinstance(e.rhs, RaggedCol)
        lk = _expand_for_ctx(ctx, la["kind"], lrag)
        rk = _expand_for_ctx(ctx, ra["kind"], rrag)
        num_eq = torch.eq(*_al(_expand_for_ctx(ctx, la["num"], lrag),
                               _expand_for_ctx(ctx, ra["num"], rrag)))
        sid_eq = torch.eq(*_al(_expand_for_ctx(ctx, la["sid"], lrag),
                               _expand_for_ctx(ctx, ra["sid"], rrag)))
        val_eq = _where(lk == K_NUM, num_eq,
                        _where(lk == K_STR, sid_eq,
                               (lk != K_MAP) & (lk != K_OTHER)))
        defined = _and(lk > 0, rk > 0)
        eq_true = _and(defined, torch.eq(*_al(lk, rk)), val_eq)
        if e.negate:
            return _and(defined, torch.logical_not(eq_true))
        return eq_true
    if isinstance(e, N.InStrList):
        nv, nok, _npres = _eval_sidlike(ctx, e.needle)
        sids = ctx.row[f"{e.param}__sids"]  # [C, K]
        cnt = ctx.row[f"{e.param}__count"]  # [C]
        valid = _valid_upto(sids.shape[-1], cnt, ctx.device)  # [C, K]
        n3, s3, v3 = _al(nv[..., None], sids, valid)
        return _and(nok, torch.any((n3 == s3) & v3, dim=-1))
    if isinstance(e, N.KeySetContains):
        col = ctx.cols.get(col_key(e.keyset))
        if col is None:
            raise LowerError(f"keyset column {e.keyset} not in batch")
        nv, nok, _npres = _eval_sidlike(ctx, e.needle)
        keys = col["sid"]  # [1, N, L]
        valid = _valid_upto(keys.shape[-1], col["count"], ctx.device)
        if ctx.axis is not None:
            keys, valid = keys[:, :, None, :], valid[:, :, None, :]
        return _contains(keys, valid, nv, nok, ctx.elem_k is not None)
    if isinstance(e, N.StrPred):
        matrix = ctx.cols[f"st:{e.op}"]  # [T, V]
        needle = e.needle
        if isinstance(needle, (N.ParamElemFieldSid, _ElemListSid)):
            if ctx.elem_k is None:
                raise LowerError("elem-needle StrPred outside AnyParamList")
            key = strtab_key(e.op, needle)
            rowidx = ctx.row[key]  # [C, K]
            rok = ctx.row[key + "__ok"]  # [C, K]
            # evaluate the subject WITHOUT elem expansion; add the K axis
            # explicitly via the table rows
            saved_elem = ctx.elem_k
            ctx.elem_k = None
            try:
                sid, sok, _sp = _eval_sidlike(ctx, e.subject)  # [B, N(, M)]
            finally:
                ctx.elem_k = saved_elem
            safe = torch.clamp(sid, 0, matrix.shape[1] - 1).long()
            ri = rowidx.long().reshape(
                (rowidx.shape[0],) + (1,) * (safe.dim() - 1)
                + (rowidx.shape[1],))
            hit = matrix[ri, safe[..., None]]  # [C, N(, M), K]
            return _and(hit, rok, _and(sid >= 0, sok)[..., None])
        if isinstance(needle, (N.ParamSid, N.ConstSid)):
            sid, sok, _sp = _eval_sidlike(ctx, e.subject)
            if isinstance(needle, N.ParamSid):
                key = f"{needle.name}__strtab_{e.op}"
            else:
                key = f"__const{needle.sid}__strtab_{e.op}"
            rowidx = ctx.row[key]  # [C]
            rok = ctx.row[key + "__ok"]
            safe = torch.clamp(sid, 0, matrix.shape[1] - 1).long()
            ri, safe = _al(rowidx.long(), safe)
            return _and(matrix[ri, safe], rok, sid >= 0, sok)
        raise LowerError(f"StrPred needle {needle}")
    if isinstance(e, N.RaggedKeySetContains):
        col = ctx.cols.get(col_key(e.keyset))
        if col is None:
            raise LowerError(f"ragged keyset {e.keyset} not in batch")
        if ctx.axis is None:
            raise LowerError("RaggedKeySetContains outside AnyAxis")
        keys = col["sid"]  # [1, N, M, L]
        valid = _valid_upto(keys.shape[-1], col["count"], ctx.device)
        nv, nok, _np_ = _eval_sidlike(ctx, e.needle)
        return _contains(keys, valid, nv, nok, ctx.elem_k is not None)
    if isinstance(e, N.Not):
        return torch.logical_not(eval_expr(ctx, e.inner))
    if isinstance(e, N.And):
        out = None
        for t in e.terms:
            v = eval_expr(ctx, t)
            out = v if out is None else _and(out, v)
        return out if out is not None else _const(ctx, True, torch.bool)
    if isinstance(e, N.Or):
        out = None
        for t in e.terms:
            v = eval_expr(ctx, t)
            out = v if out is None else torch.logical_or(*_al(out, v))
        return out if out is not None else _const(ctx, False, torch.bool)
    if isinstance(e, N.AnyAxis):
        if ctx.axis is not None:
            raise LowerError("nested AnyAxis unsupported (flatten the axis)")
        counts = ctx.cols[axis_key(e.axis)]  # [1, N]
        ctx.axis = e.axis
        try:
            inner = eval_expr(ctx, e.inner)  # [B, N, M] (+K)
        finally:
            ctx.axis = None
        if inner.dim() - 1 < 2:
            # item-independent inner: ∃item ⇔ inner ∧ count>0 (under an
            # elem (K) context counts carry the trailing size-1 axis)
            base = counts > 0
            if ctx.elem_k is not None:
                base = base[..., None]
            return _and(inner, base)
        valid = _valid_upto(inner.shape[2], counts, ctx.device)  # [1,N,M]
        if inner.dim() == 4:
            valid = valid[..., None]
        return torch.any(inner & valid, dim=2)
    if isinstance(e, N.CountAxisIs):
        if ctx.axis is not None:
            raise LowerError("nested CountAxisIs unsupported")
        counts = ctx.cols[axis_key(e.axis)]  # [1, N]
        ctx.axis = e.axis
        try:
            inner = eval_expr(ctx, e.inner)  # [B, N, M] (+K)
        finally:
            ctx.axis = None
        if inner.dim() - 1 < 2:
            # item-independent inner: satisfying-count = inner ? count : 0
            base_eq = counts == e.k
            zero_eq = _const(ctx, e.k == 0, torch.bool)
            if ctx.elem_k is not None:
                base_eq = base_eq[..., None]
            return _where(inner, base_eq, zero_eq)
        valid = _valid_upto(inner.shape[2], counts, ctx.device)
        if inner.dim() == 4:
            valid = valid[..., None]
        return torch.sum(inner & valid, dim=2) == e.k
    if isinstance(e, N.NestedAny):
        if ctx.axis is None:
            raise LowerError("NestedAny outside a parent AnyAxis")
        a = ctx.cols.get(col_key(e.col))
        if a is None:
            raise LowerError(f"parent-idx column {e.col} not in batch")
        pi = a["idx"]  # [1, N, Mc]
        child_counts = ctx.cols[axis_key(e.col.axis)]  # [1, N]
        pshape = _feat_arrays(ctx, e.parent_col)["kind"].shape[2]  # P
        prev = ctx.axis
        ctx.axis = e.col.axis
        try:
            inner = eval_expr(ctx, e.inner)  # [B, N, Mc] (+K)
        finally:
            ctx.axis = prev
        cvalid = _valid_upto(pi.shape[2], child_counts, ctx.device)
        parents = torch.arange(pshape, dtype=pi.dtype, device=ctx.device)
        mask = (pi[:, :, None, :] == parents[None, None, :, None]) \
            & cvalid[:, :, None, :]  # [1, N, P, Mc]
        if inner.dim() == 4:  # elem ctx: [B, N, Mc, K]
            return torch.any(mask[..., None] & inner[:, :, None, :, :],
                             dim=3)
        return torch.any(mask & inner[:, :, None, :], dim=3)  # [B, N, P]
    if isinstance(e, N.InventoryUniqueJoin):
        sid, sok, _spres = _eval_sidlike(ctx, e.subject)
        key = e.spec.key()
        cnt = ctx.cols.get(f"inv:{key}:cnt")
        if cnt is None:
            raise LowerError(f"inventory table {key} not in batch")
        c = _gather(cnt, sid)
        # sids interned AFTER the table build cannot be in the inventory:
        # out-of-range is a definite miss
        hit = _and(sok, sid >= 0, sid < cnt.shape[0], c >= 1)
        if not e.exclude_self:
            return hit
        obj_ns = _expand_for_ctx(
            ctx, _feat_arrays(ctx, e.ns_col)["sid"], False)
        obj_nm = _expand_for_ctx(
            ctx, _feat_arrays(ctx, e.name_col)["sid"], False)
        sole_is_self = _and(
            torch.eq(*_al(_gather(ctx.cols[f"inv:{key}:ons"], sid), obj_ns)),
            torch.eq(*_al(_gather(ctx.cols[f"inv:{key}:onm"], sid), obj_nm)))
        return _and(hit, torch.logical_or(*_al(c >= 2,
                                               torch.logical_not(
                                                   sole_is_self))))
    if isinstance(e, N.AnyParamList):
        if ctx.elem_k is not None:
            raise LowerError("nested AnyParamList unsupported")
        cnt = ctx.row[f"{e.param}__count"]  # [C]
        sids = ctx.row.get(f"{e.param}__sids")
        if sids is None:
            # object-list param: elem axis width from any field array
            k = None
            for key, vv in ctx.row.items():
                if key.startswith(f"{e.param}.") and vv.dim() >= 2:
                    k = vv.shape[-1]
                    break
            if k is None:
                raise LowerError(f"param {e.param} has no element arrays")
            ctx.elem_k = torch.zeros((1, k), dtype=torch.int32,
                                     device=ctx.device)  # placeholder axis
        else:
            k = sids.shape[-1]
            ctx.elem_k = sids
        try:
            inner = eval_expr(ctx, e.inner)  # [..., K]
        finally:
            ctx.elem_k = None
        valid = _valid_upto(k, cnt, ctx.device)  # [C, K]
        return torch.any(_and(inner, valid), dim=-1)
    if isinstance(e, N.NumDefined):
        _num, _rank, _isnum, present = _eval_cmp_operand(ctx, e.inner)
        return present
    raise LowerError(f"cannot evaluate IR node {e}")


# --------------------------------------------------------------------------
# compiled program
# --------------------------------------------------------------------------


_PROG_UID = itertools.count(1)


def _batched(cols: dict) -> dict:
    """Per-object arrays gain the size-1 constraint axis; tables don't."""
    out: dict = {}
    for key, val in cols.items():
        if is_table_key(key):
            out[key] = val
        elif isinstance(val, dict):
            out[key] = {k: v.unsqueeze(0) for k, v in val.items()}
        else:
            out[key] = val.unsqueeze(0)
    return out


class CompiledProgram:
    """One template's verdict program: (param table, batch columns) ->
    [C, N] bool grid."""

    def __init__(self, program: N.Program):
        self.program = program
        # process-monotone identity (the sweep keys per-program state on
        # uids, never id() or kind names)
        self.uid = next(_PROG_UID)
        # (device, dtype, type, value) -> the [1] tensor of a literal, and
        # the rank table per device: made on the first grid and read (never
        # written) by every later one, so a dispatch makes no host-to-device
        # copy for its program's constants.  The program's literals bound
        # its size; two threads racing a miss build equal tensors.
        self._consts: dict = {}

    def grid(self, params: dict, cols: dict, n: int) -> torch.Tensor:
        """The [C, N] verdict grid from tensors: ``params`` = the
        parameter table ({name: [C, ...]}), ``cols`` = the batch columns
        and shared tables as :func:`ir.convert.tensors_from_numpy`
        returns them (per-object arrays [N, ...], tables unbatched)."""
        c = int(params["__row__"].shape[0])
        device = params["__row__"].device
        ctx = _Ctx(_batched(cols), params, device, self._consts)
        out = eval_expr(ctx, self.program.expr)
        if out.dim() == 1:  # row-only verdict: every object alike
            out = out[:, None]
        return torch.broadcast_to(out, (c, n))

    def run(self, batch: ColumnBatch, param_table: dict,
            vocab: Optional[Vocab] = None,
            extra_cols: Optional[dict] = None,
            device: str = "cuda",
            dev_cache: Optional[dict] = None,
            batch_cache: Optional[dict] = None) -> np.ndarray:
        """Verdicts [C, N] (numpy bool) for a flattened batch.
        ``extra_cols``: shared non-batch arrays (inventory join tables).

        Two memo scopes of host array -> tensor on ``device``:
        - ``dev_cache``: persistent LRU for arrays that recur ACROSS
          batches — vocab pred/fn tables, inventory join tables.
        - ``batch_cache``: per-query memo for THIS batch's columns, shared
          across the per-kind programs evaluating the same batch (a
          many-template query_batch would otherwise upload every shared
          column once per template); it dies with the query, so batch
          columns never pin device memory."""
        from gatekeeper_tpu_torch import resolve_device

        dev = resolve_device(device)

        def conv(cache, a):
            if cache is None:
                return to_tensor(a, dev)
            return _dev_cached(cache, a, dev)

        cols: dict = {}
        for key, val in slim_cols(pack_batch_cols(batch),
                                  needed_fields(self.program)).items():
            if isinstance(val, dict):
                cols[key] = {k: conv(batch_cache, v) for k, v in val.items()}
            else:
                cols[key] = conv(batch_cache, val)
        if vocab is not None:
            for k, v in vocab_tables(self.program, vocab).items():
                cols[k] = conv(dev_cache, v)
        for k, v in (extra_cols or {}).items():
            cols[k] = conv(dev_cache, v)
        params = {k: to_tensor(v, dev) for k, v in param_table.items()}
        return self.grid(params, cols, batch.n).cpu().numpy()


_DEV_CACHE_CAP = 4096
_DEV_CACHE_LOCK = threading.Lock()


def _dev_cached(cache: dict, a, device) -> torch.Tensor:
    """Bounded id-keyed host->device LRU memo; holds a ref to the host
    array so ids can't be reused while an entry lives.  Lock-guarded: the
    webhook batcher thread and the audit thread share one driver.  An entry
    uploaded to another device type is a miss (and is replaced)."""
    key = id(a)
    with _DEV_CACHE_LOCK:
        hit = cache.pop(key, None)
        if hit is not None and hit[0] is a \
                and hit[1].device.type == device.type:
            cache[key] = hit  # re-insert = move to the recent end
            return hit[1]
    dev = to_tensor(a, device)
    with _DEV_CACHE_LOCK:
        cache[key] = (a, dev)
        while len(cache) > _DEV_CACHE_CAP:
            cache.pop(next(iter(cache)), None)
    return dev
