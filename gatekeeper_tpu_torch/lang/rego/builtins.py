"""Rego builtin functions (the subset gatekeeper-library policies use).

Each builtin takes plain Rego values and returns a value or UNDEFINED.
Semantics follow OPA's topdown builtins; errors in strict builtins make the
expression undefined (OPA default: errors are raised but gatekeeper templates
rely on undefined-propagation, which OPA applies for type errors when
``strict-builtin-errors`` is off — the default for the constraint framework).
"""

from __future__ import annotations

import contextvars
import fnmatch
import json
import math
import re
from typing import Any, Callable, Optional

from gatekeeper_tpu_torch.lang.rego.value import (
    UNDEFINED,
    RegoSet,
    SortKey,
    compare,
    freeze,
    sorted_values,
    to_json,
    to_opa_string,
    type_name,
)

REGISTRY: dict[str, Callable] = {}


def builtin(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# --- comparisons ----------------------------------------------------------

@builtin("equal")
def _equal(a, b):
    return freeze(a) == freeze(b)


@builtin("neq")
def _neq(a, b):
    return freeze(a) != freeze(b)


@builtin("lt")
def _lt(a, b):
    return compare(a, b) < 0


@builtin("lte")
def _lte(a, b):
    return compare(a, b) <= 0


@builtin("gt")
def _gt(a, b):
    return compare(a, b) > 0


@builtin("gte")
def _gte(a, b):
    return compare(a, b) >= 0


# --- arithmetic / set algebra --------------------------------------------

@builtin("plus")
def _plus(a, b):
    if _is_num(a) and _is_num(b):
        return _norm_num(a + b)
    return UNDEFINED


@builtin("minus")
def _minus(a, b):
    if _is_num(a) and _is_num(b):
        return _norm_num(a - b)
    if isinstance(a, RegoSet) and isinstance(b, RegoSet):
        return a.difference(b)
    return UNDEFINED


@builtin("mul")
def _mul(a, b):
    if _is_num(a) and _is_num(b):
        return _norm_num(a * b)
    return UNDEFINED


@builtin("div")
def _div(a, b):
    if _is_num(a) and _is_num(b) and b != 0:
        return _norm_num(a / b)
    return UNDEFINED


@builtin("rem")
def _rem(a, b):
    if isinstance(a, int) and isinstance(b, int) and b != 0:
        return math.fmod(a, b).__trunc__()
    return UNDEFINED


@builtin("or")
def _or(a, b):
    if isinstance(a, RegoSet) and isinstance(b, RegoSet):
        return a.union(b)
    return UNDEFINED


@builtin("and")
def _and(a, b):
    if isinstance(a, RegoSet) and isinstance(b, RegoSet):
        return a.intersection(b)
    return UNDEFINED


def _norm_num(v):
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return int(v)
    return v


@builtin("abs")
def _abs(a):
    return abs(a) if _is_num(a) else UNDEFINED


@builtin("ceil")
def _ceil(a):
    return math.ceil(a) if _is_num(a) else UNDEFINED


@builtin("floor")
def _floor(a):
    return math.floor(a) if _is_num(a) else UNDEFINED


@builtin("round")
def _round(a):
    # Go rounds half away from zero
    if not _is_num(a):
        return UNDEFINED
    return int(math.floor(a + 0.5)) if a >= 0 else int(math.ceil(a - 0.5))


# --- aggregates -----------------------------------------------------------

@builtin("count")
def _count(v):
    if isinstance(v, (list, tuple, dict, str, RegoSet)):
        return len(v)
    return UNDEFINED


@builtin("sum")
def _sum(v):
    if isinstance(v, (list, tuple, RegoSet)):
        items = list(v)
        if all(_is_num(x) for x in items):
            return _norm_num(sum(items))
    return UNDEFINED


@builtin("product")
def _product(v):
    if isinstance(v, (list, tuple, RegoSet)):
        out = 1
        for x in v:
            if not _is_num(x):
                return UNDEFINED
            out *= x
        return _norm_num(out)
    return UNDEFINED


@builtin("max")
def _max(v):
    items = list(v) if isinstance(v, (list, tuple, RegoSet)) else None
    if not items:
        return UNDEFINED
    return sorted_values(items)[-1]


@builtin("min")
def _min(v):
    items = list(v) if isinstance(v, (list, tuple, RegoSet)) else None
    if not items:
        return UNDEFINED
    return sorted_values(items)[0]


@builtin("sort")
def _sort(v):
    if isinstance(v, (list, tuple, RegoSet)):
        return sorted_values(list(v))
    return UNDEFINED


# --- strings --------------------------------------------------------------

@builtin("concat")
def _concat(sep, items):
    if isinstance(sep, str) and isinstance(items, (list, tuple, RegoSet)):
        vals = list(items) if not isinstance(items, RegoSet) else sorted_values(items)
        if all(isinstance(x, str) for x in vals):
            return sep.join(vals)
    return UNDEFINED


@builtin("contains")
def _contains(s, sub):
    if isinstance(s, str) and isinstance(sub, str):
        return sub in s
    return UNDEFINED


@builtin("startswith")
def _startswith(s, p):
    if isinstance(s, str) and isinstance(p, str):
        return s.startswith(p)
    return UNDEFINED


@builtin("endswith")
def _endswith(s, p):
    if isinstance(s, str) and isinstance(p, str):
        return s.endswith(p)
    return UNDEFINED


@builtin("lower")
def _lower(s):
    return s.lower() if isinstance(s, str) else UNDEFINED


@builtin("upper")
def _upper(s):
    return s.upper() if isinstance(s, str) else UNDEFINED


@builtin("split")
def _split(s, d):
    if isinstance(s, str) and isinstance(d, str):
        return s.split(d)
    return UNDEFINED


@builtin("replace")
def _replace(s, old, new):
    if all(isinstance(x, str) for x in (s, old, new)):
        return s.replace(old, new)
    return UNDEFINED


@builtin("trim")
def _trim(s, cutset):
    if isinstance(s, str) and isinstance(cutset, str):
        return s.strip(cutset)
    return UNDEFINED


@builtin("trim_left")
def _trim_left(s, cutset):
    return s.lstrip(cutset) if isinstance(s, str) else UNDEFINED


@builtin("trim_right")
def _trim_right(s, cutset):
    return s.rstrip(cutset) if isinstance(s, str) else UNDEFINED


@builtin("trim_prefix")
def _trim_prefix(s, p):
    if isinstance(s, str) and isinstance(p, str):
        return s[len(p):] if s.startswith(p) else s
    return UNDEFINED


@builtin("trim_suffix")
def _trim_suffix(s, p):
    if isinstance(s, str) and isinstance(p, str):
        return s[: len(s) - len(p)] if p and s.endswith(p) else s
    return UNDEFINED


@builtin("trim_space")
def _trim_space(s):
    return s.strip() if isinstance(s, str) else UNDEFINED


@builtin("indexof")
def _indexof(s, sub):
    if isinstance(s, str) and isinstance(sub, str):
        return s.find(sub)
    return UNDEFINED


@builtin("substring")
def _substring(s, start, length):
    if not (isinstance(s, str) and isinstance(start, int)
            and isinstance(length, int)):
        return UNDEFINED
    if start < 0:
        return UNDEFINED
    if length < 0:
        return s[start:]
    return s[start : start + length]


@builtin("format_int")
def _format_int(n, base):
    if not _is_num(n) or base not in (2, 8, 10, 16):
        return UNDEFINED
    n = int(n)
    neg, n2 = n < 0, abs(n)
    digits = {2: "{:b}", 8: "{:o}", 10: "{:d}", 16: "{:x}"}[base].format(n2)
    return ("-" if neg else "") + digits


_VERB_RE = re.compile(r"%[-+ #0]*\d*(?:\.\d+)?[vVsdqfgteExXob%]")


@builtin("sprintf")
def _sprintf(fmt, args):
    if not isinstance(fmt, str) or not isinstance(args, (list, tuple)):
        return UNDEFINED
    out = []
    ai = 0
    pos = 0
    for m in _VERB_RE.finditer(fmt):
        out.append(fmt[pos : m.start()])
        pos = m.end()
        verb = m.group(0)
        kind = verb[-1]
        if kind == "%":
            out.append("%")
            continue
        if ai >= len(args):
            out.append("%!" + kind + "(MISSING)")
            continue
        arg = args[ai]
        ai += 1
        if kind in ("v", "V"):
            out.append(to_opa_string(arg, top=True))
        elif kind == "s":
            out.append(arg if isinstance(arg, str) else to_opa_string(arg, top=True))
        elif kind == "q":
            out.append(json.dumps(arg if isinstance(arg, str) else to_opa_string(arg, top=True)))
        elif kind == "d":
            out.append(verb % int(arg) if _is_num(arg) else "%!d")
        elif kind in "feEgtxXob":
            try:
                out.append(verb % arg)
            except (TypeError, ValueError):
                out.append("%!" + kind)
        else:
            out.append(verb)
    out.append(fmt[pos:])
    return "".join(out)


# --- regex / glob ---------------------------------------------------------

@builtin("re_match")
@builtin("regex.match")
def _re_match(pattern, s):
    if isinstance(pattern, str) and isinstance(s, str):
        try:
            return re.search(pattern, s) is not None
        except re.error:
            return UNDEFINED
    return UNDEFINED


@builtin("regex.is_valid")
def _re_is_valid(pattern):
    if not isinstance(pattern, str):
        return False
    try:
        re.compile(pattern)
        return True
    except re.error:
        return False


@builtin("regex.split")
def _re_split(pattern, s):
    if isinstance(pattern, str) and isinstance(s, str):
        try:
            return re.split(pattern, s)
        except re.error:
            return UNDEFINED
    return UNDEFINED


@builtin("regex.find_n")
def _re_find_n(pattern, s, n):
    if isinstance(pattern, str) and isinstance(s, str) and isinstance(n, int):
        try:
            found = re.findall(pattern, s)
        except re.error:
            return UNDEFINED
        if n >= 0:
            found = found[:n]
        return found
    return UNDEFINED


def glob_translate(pattern: str, delimiters=None) -> str:
    """Translate an OPA glob (gobwas/glob style) to a Python regex.

    Supports ``*`` (any run not crossing a delimiter), ``**`` (any run),
    ``?``, ``[...]`` character classes, ``{a,b}`` alternates.
    """
    if delimiters is None:
        delimiters = ["."]
    delim = "".join(re.escape(d) for d in delimiters)
    i, n = 0, len(pattern)
    out = []
    while i < n:
        c = pattern[i]
        if c == "*":
            if i + 1 < n and pattern[i + 1] == "*":
                out.append(".*")
                i += 2
            else:
                out.append(f"[^{delim}]*" if delim else ".*")
                i += 1
        elif c == "?":
            out.append(f"[^{delim}]" if delim else ".")
            i += 1
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j < 0:
                out.append(re.escape(c))
                i += 1
            else:
                body = pattern[i + 1 : j]
                if body.startswith("!"):
                    body = "^" + body[1:]
                out.append("[" + body + "]")
                i = j + 1
        elif c == "{":
            j = pattern.find("}", i + 1)
            if j < 0:
                out.append(re.escape(c))
                i += 1
            else:
                alts = pattern[i + 1 : j].split(",")
                # glob_translate wraps in '^(?:' ... ')$'; strip to embed
                out.append(
                    "(?:"
                    + "|".join(glob_translate(a, delimiters)[4:-2] for a in alts)
                    + ")"
                )
                i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return "^(?:" + "".join(out) + ")$"


@builtin("glob.match")
def _glob_match(pattern, delimiters, s):
    if not (isinstance(pattern, str) and isinstance(s, str)):
        return UNDEFINED
    if delimiters is None:
        delims = ["."]
    elif isinstance(delimiters, (list, tuple)):
        delims = [d for d in delimiters if isinstance(d, str)]
    else:
        return UNDEFINED
    try:
        return re.match(glob_translate(pattern, delims), s) is not None
    except re.error:
        return UNDEFINED


# --- types ----------------------------------------------------------------

@builtin("type_name")
def _type_name(v):
    return type_name(v)


for _t in ("null", "boolean", "number", "string", "array", "object", "set"):
    def _mk(t):
        def f(v):
            return type_name(v) == t
        return f
    REGISTRY[f"is_{_t}"] = _mk(_t)


@builtin("to_number")
def _to_number(v):
    if v is None:
        return 0
    if isinstance(v, bool):
        return 1 if v else 0
    if _is_num(v):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
        except ValueError:
            return UNDEFINED
        return _norm_num(f) if ("." in v or "e" in v or "E" in v) else int(f)
    return UNDEFINED


@builtin("cast_array")
def _cast_array(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    if isinstance(v, RegoSet):
        return sorted_values(v)
    return UNDEFINED


# --- arrays / objects / sets ---------------------------------------------

@builtin("array.concat")
def _array_concat(a, b):
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return list(a) + list(b)
    return UNDEFINED


@builtin("array.slice")
def _array_slice(a, lo, hi):
    if isinstance(a, (list, tuple)) and isinstance(lo, int) and isinstance(hi, int):
        lo = max(lo, 0)
        hi = min(max(hi, lo), len(a))
        return list(a)[lo:hi]
    return UNDEFINED


@builtin("array.reverse")
def _array_reverse(a):
    if isinstance(a, (list, tuple)):
        return list(reversed(a))
    return UNDEFINED


@builtin("object.get")
def _object_get(obj, key, default):
    if isinstance(key, (list, tuple)):
        cur = obj
        for k in key:
            if isinstance(cur, dict):
                hit = _dict_lookup(cur, k)
                if hit is UNDEFINED:
                    return default
                cur = hit
            elif isinstance(cur, (list, tuple)) and isinstance(k, int) and 0 <= k < len(cur):
                cur = cur[k]
            else:
                return default
        return cur
    if isinstance(obj, dict):
        hit = _dict_lookup(obj, key)
        return default if hit is UNDEFINED else hit
    return default


def _dict_lookup(d: dict, key):
    if isinstance(key, (str, int, float, bool)) or key is None:
        if key in d:
            return d[key]
        return UNDEFINED
    fk = freeze(key)
    for k, v in d.items():
        if freeze(k) == fk:
            return v
    return UNDEFINED


@builtin("object.keys")
def _object_keys(obj):
    if isinstance(obj, dict):
        return RegoSet(obj.keys())
    return UNDEFINED


@builtin("object.remove")
def _object_remove(obj, keys):
    if isinstance(obj, dict) and isinstance(keys, (list, tuple, RegoSet)):
        drop = {freeze(k) for k in keys}
        return {k: v for k, v in obj.items() if freeze(k) not in drop}
    return UNDEFINED


@builtin("object.filter")
def _object_filter(obj, keys):
    if isinstance(obj, dict) and isinstance(keys, (list, tuple, RegoSet)):
        keep = {freeze(k) for k in keys}
        return {k: v for k, v in obj.items() if freeze(k) in keep}
    return UNDEFINED


@builtin("object.union")
def _object_union(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                out[k] = _object_union(out[k], v)
            else:
                out[k] = v
        return out
    return UNDEFINED


@builtin("union")
def _union(sets):
    if isinstance(sets, (RegoSet, list, tuple)):
        out = RegoSet()
        for s in sets:
            if not isinstance(s, RegoSet):
                return UNDEFINED
            out = out.union(s)
        return out
    return UNDEFINED


@builtin("intersection")
def _intersection(sets):
    if isinstance(sets, RegoSet) and len(sets):
        items = list(sets)
        out = items[0]
        for s in items[1:]:
            if not isinstance(s, RegoSet):
                return UNDEFINED
            out = out.intersection(s)
        return out
    return UNDEFINED


@builtin("internal.member_2")
def _member2(x, coll):
    if isinstance(coll, (list, tuple)):
        fx = freeze(x)
        return any(freeze(e) == fx for e in coll)
    if isinstance(coll, RegoSet):
        return x in coll
    if isinstance(coll, dict):
        fx = freeze(x)
        return any(freeze(v) == fx for v in coll.values())
    return UNDEFINED


# --- json / base64 / units -----------------------------------------------

@builtin("json.marshal")
def _json_marshal(v):
    return json.dumps(to_json(v), separators=(",", ":"), sort_keys=True)


@builtin("json.unmarshal")
def _json_unmarshal(s):
    if isinstance(s, str):
        try:
            return json.loads(s)
        except json.JSONDecodeError:
            return UNDEFINED
    return UNDEFINED


@builtin("json.is_valid")
def _json_is_valid(s):
    if not isinstance(s, str):
        return False
    try:
        json.loads(s)
        return True
    except json.JSONDecodeError:
        return False


@builtin("base64.encode")
def _b64_encode(s):
    import base64

    if isinstance(s, str):
        return base64.b64encode(s.encode()).decode()
    return UNDEFINED


@builtin("base64.decode")
def _b64_decode(s):
    import base64

    if isinstance(s, str):
        try:
            return base64.b64decode(s).decode()
        except Exception:
            return UNDEFINED
    return UNDEFINED


_UNIT_RE = re.compile(r"^([0-9.e+-]+)\s*([a-zA-Z]*)$")

_BYTE_UNITS = {
    "": 1,
    "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12, "p": 10**15, "e": 10**18,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12, "pb": 10**15, "eb": 10**18,
    "ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40, "pi": 2**50, "ei": 2**60,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40, "pib": 2**50, "eib": 2**60,
}

@builtin("units.parse_bytes")
def _units_parse_bytes(s):
    if not isinstance(s, str):
        return UNDEFINED
    m = _UNIT_RE.match(s.strip().strip('"'))
    if not m:
        return UNDEFINED
    num, unit = m.groups()
    mult = _BYTE_UNITS.get(unit.lower())
    if mult is None:
        return UNDEFINED
    try:
        return _norm_num(float(num) * mult)
    except ValueError:
        return UNDEFINED


@builtin("units.parse")
def _units_parse(s):
    if not isinstance(s, str):
        return UNDEFINED
    m = _UNIT_RE.match(s.strip().strip('"'))
    if not m:
        return UNDEFINED
    num, unit = m.groups()
    if unit == "m":
        mult = 1e-3
    elif unit == "":
        mult = 1
    else:
        mult = _BYTE_UNITS.get(unit.lower())
        if mult is None:
            return UNDEFINED
    try:
        return _norm_num(float(num) * mult)
    except ValueError:
        return UNDEFINED


@builtin("set")
def _empty_set():
    return RegoSet()


@builtin("object.subset")
def _object_subset(sup, sub):
    def subset(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            return all(k in a and subset(a[k], v) for k, v in b.items())
        if isinstance(a, RegoSet) and isinstance(b, RegoSet):
            return all(e in a for e in b)
        return freeze(a) == freeze(b)

    return subset(sup, sub)


def _str_coll(v):
    if isinstance(v, str):
        return [v]
    if isinstance(v, (list, tuple, RegoSet)):
        items = list(v)
        if all(isinstance(x, str) for x in items):
            return items
    return None


@builtin("strings.any_prefix_match")
def _any_prefix_match(search, base):
    searches, bases = _str_coll(search), _str_coll(base)
    if searches is None or bases is None:
        return UNDEFINED
    return any(s.startswith(b) for s in searches for b in bases)


@builtin("strings.any_suffix_match")
def _any_suffix_match(search, base):
    searches, bases = _str_coll(search), _str_coll(base)
    if searches is None or bases is None:
        return UNDEFINED
    return any(s.endswith(b) for s in searches for b in bases)


@builtin("strings.replace_n")
def _replace_n(patterns, s):
    # single pass like Go's strings.NewReplacer (OPA semantics): earlier
    # replacements are never re-replaced by later patterns
    if not isinstance(patterns, dict) or not isinstance(s, str):
        return UNDEFINED
    pairs = list(patterns.items())
    if not all(isinstance(o, str) and isinstance(n, str) for o, n in pairs):
        return UNDEFINED
    out = []
    i = 0
    while i < len(s):
        for old, new in pairs:
            if old and s.startswith(old, i):
                out.append(new)
                i += len(old)
                break
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


@builtin("any")
def _any(coll):
    # deprecated in OPA but widely used by library policies
    if isinstance(coll, (list, tuple, RegoSet)):
        return any(v is True for v in coll)
    return UNDEFINED


@builtin("all")
def _all(coll):
    if isinstance(coll, (list, tuple, RegoSet)):
        return all(v is True for v in coll)
    return UNDEFINED


# --- print (reference: topdown print.Hook, wired by gator verify) ---------
#
# OPA's print() is a debugging statement: it NEVER affects evaluation (the
# compiler rewrites it so undefined args print as `<undefined>` and the
# expression always succeeds).  The interpreter special-cases the call
# (interp._eval_call) for the undefined-arg tolerance; this module owns the
# sink.  A contextvar (not a global) scopes the hook to the evaluating
# thread/context, so a gator verify run capturing prints cannot leak
# another thread's webhook evaluation output into its suite report.

_PRINT_HOOK: contextvars.ContextVar = contextvars.ContextVar(
    "rego_print_hook", default=None)


def set_print_hook(hook: Optional[Callable[[str], None]]):
    """Install a print sink for the current context; returns a token for
    :func:`reset_print_hook`.  ``None`` disables (the gatekeeper default:
    print output is dropped unless a harness asks for it — reference
    PrintEnabled is only set by gator verify)."""
    return _PRINT_HOOK.set(hook)


def reset_print_hook(token) -> None:
    _PRINT_HOOK.reset(token)


def print_message(args) -> None:
    """Format + deliver one print() call's arguments to the active hook
    (no-op without one).  Strings print raw, everything else as JSON —
    OPA's print formatting."""
    hook = _PRINT_HOOK.get()
    if hook is None:
        return
    parts = []
    for a in args:
        if a is UNDEFINED:
            parts.append("<undefined>")
        elif isinstance(a, str):
            parts.append(a)
        else:
            try:
                parts.append(json.dumps(to_json(a), sort_keys=True,
                                        separators=(",", ":")))
            except (TypeError, ValueError):
                parts.append(str(a))
    hook(" ".join(parts))


@builtin("print")
def _print(*args):
    # function-position fallback (the interpreter's statement special-case
    # normally intercepts first): deliver and succeed
    print_message(args)
    return True


@builtin("external_data")
def _external_data(req):
    # reference: the frameworks' external_data builtin (validation-side
    # external data).  The JAX package resolves it through its extdata
    # lane; the port has no such lane yet, so the builtin raises.
    from gatekeeper_tpu_torch.lang.rego.interp import RegoError

    raise RegoError("external_data: the external-data lane is not ported "
                    "to PyTorch yet")
