"""CEL static checker: compile-time validation of expressions.

Reference: the upstream compiles CEL with the cel-go type checker at
AddTemplate (k8scel driver), so unknown functions, bad arities, and
undeclared identifiers error at template admission instead of evaluation.
This checker walks the parsed AST with the same function surface the
interpreter implements (cel.py dispatch tables) and a declared-identifier
environment; it is deliberately arity/name-level (dynamic typing at eval
matches the engine's dyn semantics).
"""

from __future__ import annotations

from gatekeeper_tpu_torch.lang.cel.cel import (
    Binary,
    Call,
    CelParseError,
    Ident,
    Index,
    ListLit,
    Lit,
    Macro,
    MapLit,
    Select,
    Ternary,
    Unary,
    parse,
)

# global functions: name -> allowed arg counts
GLOBAL_FNS = {
    "has": (1,),
    "size": (1,),
    "string": (1,),
    "int": (1,),
    "double": (1,),
    "bool": (1,),
    "dyn": (1,),
    "type": (1,),
    # k8s extension libraries
    "quantity": (1,), "isQuantity": (1,),
    "ip": (1,), "isIP": (1,),
    "cidr": (1,), "isCIDR": (1,),
    "url": (1,), "isURL": (1,),
}

# method calls: name -> allowed arg counts
METHOD_FNS = {
    "contains": (1,),
    "startsWith": (1,),
    "endsWith": (1,),
    "matches": (1,),
    "size": (0,),
    "split": (1, 2),
    "lowerAscii": (0,),
    "upperAscii": (0,),
    "trim": (0,),
    "replace": (2, 3),
    "indexOf": (1, 2),
    "substring": (1, 2),
    "join": (0, 1),
    "isSorted": (0,),
    # quantity / ip / cidr / url methods
    "isGreaterThan": (1,), "isLessThan": (1,), "compareTo": (1,),
    "add": (1,), "sub": (1,), "asApproximateFloat": (0,),
    "asInteger": (0,), "isInteger": (0,), "sign": (0,),
    "family": (0,), "isLoopback": (0,), "isGlobalUnicast": (0,),
    "isUnspecified": (0,),
    "containsIP": (1,), "containsCIDR": (1,), "prefixLength": (0,),
    "getScheme": (0,), "getHost": (0,), "getHostname": (0,),
    "getPort": (0,), "getEscapedPath": (0,), "getQuery": (0,),
}

MACROS = {"all", "exists", "exists_one", "filter", "map"}

# identifiers every VAP-shaped expression may reference
# (reference: cel-go env declarations in the k8scel driver)
DEFAULT_IDENTS = frozenset({
    "object", "oldObject", "request", "params", "variables",
    "authorizer", "namespaceObject", "true", "false", "null",
})


class CelCheckError(CelParseError):
    pass


def check(expr_src: str, extra_idents=()) -> None:
    """Raises CelCheckError for unknown functions/macros, bad arities, or
    undeclared top-level identifiers."""
    ast = parse(expr_src)
    idents = set(DEFAULT_IDENTS) | set(extra_idents)
    _walk(ast, idents)


def _walk(e, idents: set) -> None:
    if isinstance(e, Lit):
        return
    if isinstance(e, Ident):
        if e.name not in idents:
            raise CelCheckError(f"undeclared identifier {e.name!r}")
        return
    if isinstance(e, Select):
        _walk(e.base, idents)
        return
    if isinstance(e, Index):
        _walk(e.base, idents)
        _walk(e.index, idents)
        return
    if isinstance(e, Unary):
        _walk(e.operand, idents)
        return
    if isinstance(e, Binary):
        _walk(e.lhs, idents)
        _walk(e.rhs, idents)
        return
    if isinstance(e, Ternary):
        for part in (e.cond, e.then, e.other):
            _walk(part, idents)
        return
    if isinstance(e, ListLit):
        for item in e.items:
            _walk(item, idents)
        return
    if isinstance(e, MapLit):
        for k, v in e.pairs:
            _walk(k, idents)
            _walk(v, idents)
        return
    if isinstance(e, Macro):
        _walk(e.target, idents)
        if e.name not in MACROS:
            raise CelCheckError(f"unknown macro {e.name!r}")
        inner = set(idents) | {e.var}
        if e.var2:
            inner.add(e.var2)
        _walk(e.body, inner)
        if e.body2 is not None:
            _walk(e.body2, inner)
        return
    if isinstance(e, Call):
        if e.target is None:
            allowed = GLOBAL_FNS.get(e.name)
            if allowed is None:
                raise CelCheckError(f"unknown function {e.name!r}")
            if len(e.args) not in allowed:
                raise CelCheckError(
                    f"{e.name}() takes {allowed} args, got {len(e.args)}")
            if e.name == "has":
                if not isinstance(e.args[0], Select):
                    raise CelCheckError(
                        "has() requires a field selection argument")
        else:
            _walk(e.target, idents)
            allowed = METHOD_FNS.get(e.name)
            if allowed is None:
                raise CelCheckError(f"unknown method {e.name!r}")
            if len(e.args) not in allowed:
                raise CelCheckError(
                    f".{e.name}() takes {allowed} args, got {len(e.args)}")
        for a in e.args:
            _walk(a, idents)
        return
    raise CelCheckError(f"unsupported expression node {type(e).__name__}")
