"""Rego value model.

Rego values are JSON values plus *sets*.  Python sets cannot hold dicts/lists,
so ``RegoSet`` stores elements keyed by a structural ``freeze`` of the value.
Term ordering and string rendering mirror OPA's (ast term sort order and
``fmt.Sprintf("%v", term)`` behavior) so messages built with ``sprintf`` match
the reference engine's output byte-for-byte (reference contract:
demo/basic/templates/k8srequiredlabels_template.yaml:20-29 renders a set into
the violation message).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator


class Undefined:
    """Singleton marking an undefined Rego expression."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"

    def __bool__(self):
        return False


UNDEFINED = Undefined()


def freeze(v: Any) -> Any:
    """Structural, hashable form of a Rego value (for set/obj keys, memo keys)."""
    if isinstance(v, RegoSet):
        return ("set",) + tuple(sorted((freeze(e) for e in v), key=repr))
    if isinstance(v, dict):
        return ("obj",) + tuple(
            sorted(((freeze(k), freeze(val)) for k, val in v.items()), key=repr)
        )
    if isinstance(v, (list, tuple)):
        return ("arr",) + tuple(freeze(e) for e in v)
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, (int, float)):
        # Rego numbers: 1 == 1.0
        return ("num", float(v))
    return v


class RegoSet:
    __slots__ = ("_items",)

    def __init__(self, items: Iterable[Any] = ()):  # noqa: D401
        self._items: dict = {}
        for it in items:
            self.add(it)

    def add(self, v: Any) -> None:
        self._items[freeze(v)] = v

    def __contains__(self, v: Any) -> bool:
        return freeze(v) in self._items

    def __iter__(self) -> Iterator[Any]:
        return iter(self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, RegoSet) and set(self._items) == set(other._items)

    def __hash__(self):
        return hash(frozenset(self._items))

    def __repr__(self):
        return "RegoSet(%r)" % (list(self._items.values()),)

    # set algebra (rego operators - | &)
    def union(self, other: "RegoSet") -> "RegoSet":
        s = RegoSet(self)
        for v in other:
            s.add(v)
        return s

    def intersection(self, other: "RegoSet") -> "RegoSet":
        return RegoSet(v for v in self if v in other)

    def difference(self, other: "RegoSet") -> "RegoSet":
        return RegoSet(v for v in self if v not in other)


# --- term ordering (OPA ast.Compare) -------------------------------------

_TYPE_ORDER = {
    "null": 0,
    "boolean": 1,
    "number": 2,
    "string": 3,
    "array": 6,
    "object": 7,
    "set": 8,
}


def type_name(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "array"
    if isinstance(v, RegoSet):
        return "set"
    if isinstance(v, dict):
        return "object"
    raise TypeError(f"not a rego value: {v!r}")


def compare(a: Any, b: Any) -> int:
    ta, tb = _TYPE_ORDER[type_name(a)], _TYPE_ORDER[type_name(b)]
    if ta != tb:
        return -1 if ta < tb else 1
    t = type_name(a)
    if t == "null":
        return 0
    if t == "boolean":
        return (a > b) - (a < b)
    if t == "number":
        return (a > b) - (a < b)
    if t == "string":
        return (a > b) - (a < b)
    if t == "array":
        for x, y in zip(a, b):
            c = compare(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    if t == "set":
        return compare(sorted_values(a), sorted_values(b))
    if t == "object":
        ka = sorted(a.keys(), key=SortKey)
        kb = sorted(b.keys(), key=SortKey)
        for x, y in zip(ka, kb):
            c = compare(x, y)
            if c:
                return c
            c = compare(a[x], b[y])
            if c:
                return c
        return (len(ka) > len(kb)) - (len(ka) < len(kb))
    raise AssertionError


class SortKey:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return compare(self.v, other.v) < 0


def sorted_values(vals: Iterable[Any]) -> list:
    return sorted(vals, key=SortKey)


# --- rendering (OPA fmt %v of ast terms) ---------------------------------


def _num_str(n) -> str:
    if isinstance(n, bool):
        return "true" if n else "false"
    if isinstance(n, float) and n.is_integer():
        return str(int(n))
    return repr(n) if isinstance(n, float) else str(n)


def to_opa_string(v: Any, top: bool = False) -> str:
    """Render like OPA's sprintf does: term String() form; top-level strings
    print unquoted (Go passes the raw string for %v on a string operand)."""
    t = type_name(v)
    if t == "null":
        return "null"
    if t == "boolean":
        return "true" if v else "false"
    if t == "number":
        return _num_str(v)
    if t == "string":
        return v if top else '"%s"' % v
    if t == "array":
        return "[%s]" % ", ".join(to_opa_string(e) for e in v)
    if t == "set":
        if not len(v):
            return "set()"
        return "{%s}" % ", ".join(to_opa_string(e) for e in sorted_values(v))
    if t == "object":
        keys = sorted(v.keys(), key=SortKey)
        return "{%s}" % ", ".join(
            "%s: %s" % (to_opa_string(k), to_opa_string(v[k])) for k in keys
        )
    raise AssertionError


def to_json(v: Any) -> Any:
    """Convert a Rego value to plain JSON (sets become sorted arrays)."""
    if isinstance(v, RegoSet):
        return [to_json(e) for e in sorted_values(v)]
    if isinstance(v, dict):
        return {k: to_json(e) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_json(e) for e in v]
    return v


def truthy(v: Any) -> bool:
    """Statement success: everything but ``false`` and undefined succeeds."""
    return not (v is UNDEFINED or v is False)
