"""CEL expression engine (the K8s ValidatingAdmissionPolicy subset).

Reference context: the k8scel driver embeds the apiserver's CEL validator
(pkg/drivers/k8scel/driver.go); templates carry expressions over ``object``,
``oldObject``, ``request``, ``params``/``variables.*`` and
``namespaceObject`` (transform/cel_snippets.go binds the prelude).

Implemented subset: ternary/boolean operators with CEL's commutative
error-absorbing || and &&, relations (== != < <= > >= in), arithmetic,
unary !/-, member select, indexing, list/map literals, ``has()`` macro,
collection macros (all/exists/exists_one/filter/map), size/type
conversions, string methods (contains/startsWith/endsWith/matches/split/
join/lowerAscii/upperAscii/trim), dyn.  Errors follow CEL semantics:
strict propagation except through ||/&&/ternary short-circuits.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Optional


class CelError(Exception):
    pass


class CelParseError(CelError):
    pass


# --------------------------------------------------------------------------
# lexer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<float>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>0x[0-9a-fA-F]+u?|\d+u?)
  | (?P<string>r?"(?:\\.|[^"\\])*"|r?'(?:\\.|[^'\\])*')
  | (?P<ident>[_a-zA-Z][_a-zA-Z0-9]*)
  | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%!<>?:.,\[\]{}()])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"true", "false", "null", "in"}


def tokenize(src: str):
    toks = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise CelParseError(f"unexpected character {src[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "ident" and text in _KEYWORDS:
            toks.append(("kw", text))
        else:
            toks.append((kind, text))
    toks.append(("eof", ""))
    return toks


def _unquote(text: str) -> str:
    raw = text.startswith("r")
    if raw:
        text = text[1:]
    body = text[1:-1]
    if raw:
        return body
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            esc = body[i + 1]
            mapping = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                       '"': '"', "'": "'", "a": "\a", "b": "\b",
                       "f": "\f", "v": "\v", "0": "\0"}
            if esc == "u":
                out.append(chr(int(body[i + 2: i + 6], 16)))
                i += 6
                continue
            out.append(mapping.get(esc, esc))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# --------------------------------------------------------------------------
# AST + parser
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Lit:
    value: Any


@dataclass(frozen=True)
class Ident:
    name: str


@dataclass(frozen=True)
class Select:
    base: Any
    field: str


@dataclass(frozen=True)
class Index:
    base: Any
    index: Any


@dataclass(frozen=True)
class Call:
    target: Any  # None for global fns
    name: str
    args: tuple


@dataclass(frozen=True)
class Unary:
    op: str
    operand: Any


@dataclass(frozen=True)
class Binary:
    op: str
    lhs: Any
    rhs: Any


@dataclass(frozen=True)
class Ternary:
    cond: Any
    then: Any
    other: Any


@dataclass(frozen=True)
class ListLit:
    items: tuple


@dataclass(frozen=True)
class MapLit:
    pairs: tuple


@dataclass(frozen=True)
class Macro:
    target: Any
    name: str  # all | exists | exists_one | filter | map
    var: str
    var2: Optional[str]
    body: Any
    body2: Any = None  # two-arg map transform


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        if t[0] != "eof":
            self.i += 1
        return t

    def eat(self, kind, text=None) -> bool:
        t = self.peek()
        if t[0] == kind and (text is None or t[1] == text):
            self.next()
            return True
        return False

    def expect(self, kind, text=None):
        t = self.next()
        if t[0] != kind or (text is not None and t[1] != text):
            raise CelParseError(f"expected {text or kind}, got {t[1]!r}")
        return t

    def parse(self):
        e = self.ternary()
        if self.peek()[0] != "eof":
            raise CelParseError(f"trailing input at {self.peek()[1]!r}")
        return e

    def ternary(self):
        cond = self.logic_or()
        if self.eat("op", "?"):
            then = self.ternary()
            self.expect("op", ":")
            other = self.ternary()
            return Ternary(cond, then, other)
        return cond

    def logic_or(self):
        e = self.logic_and()
        while self.eat("op", "||"):
            e = Binary("||", e, self.logic_and())
        return e

    def logic_and(self):
        e = self.relation()
        while self.eat("op", "&&"):
            e = Binary("&&", e, self.relation())
        return e

    def relation(self):
        e = self.additive()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                e = Binary(t[1], e, self.additive())
            elif t == ("kw", "in"):
                self.next()
                e = Binary("in", e, self.additive())
            else:
                return e

    def additive(self):
        e = self.multiplicative()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("+", "-"):
                self.next()
                e = Binary(t[1], e, self.multiplicative())
            else:
                return e

    def multiplicative(self):
        e = self.unary()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("*", "/", "%"):
                self.next()
                e = Binary(t[1], e, self.unary())
            else:
                return e

    def unary(self):
        t = self.peek()
        if t == ("op", "!"):
            self.next()
            return Unary("!", self.unary())
        if t == ("op", "-"):
            self.next()
            return Unary("-", self.unary())
        return self.postfix()

    _MACROS = {"all", "exists", "exists_one", "filter", "map"}

    def postfix(self):
        e = self.primary()
        while True:
            if self.eat("op", "."):
                name = self.expect("ident")[1]
                if self.eat("op", "("):
                    if name in self._MACROS:
                        e = self._parse_macro(e, name)
                    else:
                        args = self._args()
                        e = Call(e, name, tuple(args))
                else:
                    e = Select(e, name)
            elif self.eat("op", "["):
                idx = self.ternary()
                self.expect("op", "]")
                e = Index(e, idx)
            else:
                return e

    def _parse_macro(self, target, name):
        var = self.expect("ident")[1]
        var2 = None
        self.expect("op", ",")
        # two-variable form: m.all(k, v, pred)
        save = self.i
        t = self.peek()
        if t[0] == "ident":
            self.next()
            if self.eat("op", ","):
                var2 = t[1]
            else:
                self.i = save
        body = self.ternary()
        body2 = None
        if name == "map" and self.eat("op", ","):
            # three-arg transform: list.map(x, filter, transform)
            body2 = self.ternary()
        self.expect("op", ")")
        return Macro(target, name, var, var2, body, body2)

    def _args(self):
        args = []
        if self.eat("op", ")"):
            return args
        args.append(self.ternary())
        while self.eat("op", ","):
            args.append(self.ternary())
        self.expect("op", ")")
        return args

    def primary(self):
        t = self.peek()
        if t[0] == "float":
            self.next()
            return Lit(float(t[1]))
        if t[0] == "int":
            self.next()
            text = t[1].rstrip("u")
            return Lit(int(text, 16) if text.startswith("0x") else int(text))
        if t[0] == "string":
            self.next()
            return Lit(_unquote(t[1]))
        if t == ("kw", "true"):
            self.next()
            return Lit(True)
        if t == ("kw", "false"):
            self.next()
            return Lit(False)
        if t == ("kw", "null"):
            self.next()
            return Lit(None)
        if t[0] == "ident":
            self.next()
            name = t[1]
            if self.eat("op", "("):
                if name == "has":
                    arg = self.ternary()
                    self.expect("op", ")")
                    if not isinstance(arg, Select):
                        raise CelParseError("has() requires a field selection")
                    return Call(None, "has", (arg,))
                args = self._args()
                return Call(None, name, tuple(args))
            return Ident(name)
        if self.eat("op", "("):
            e = self.ternary()
            self.expect("op", ")")
            return e
        if self.eat("op", "["):
            items = []
            if not self.eat("op", "]"):
                items.append(self.ternary())
                while self.eat("op", ","):
                    if self.peek() == ("op", "]"):
                        break
                    items.append(self.ternary())
                self.expect("op", "]")
            return ListLit(tuple(items))
        if self.eat("op", "{"):
            pairs = []
            if not self.eat("op", "}"):
                while True:
                    k = self.ternary()
                    self.expect("op", ":")
                    v = self.ternary()
                    pairs.append((k, v))
                    if not self.eat("op", ","):
                        break
                    if self.peek() == ("op", "}"):
                        break
                self.expect("op", "}")
            return MapLit(tuple(pairs))
        raise CelParseError(f"unexpected token {t[1]!r}")


def parse(src: str):
    return Parser(src).parse()


# --------------------------------------------------------------------------
# evaluator
# --------------------------------------------------------------------------


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _type_name(v) -> str:
    if v is None:
        return "null_type"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "double"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "list"
    if isinstance(v, dict):
        return "map"
    return type(v).__name__


class Env:
    """Variable bindings; ``variables.<name>`` resolves lazily + memoized."""

    def __init__(self, bindings: dict, lazy: Optional[dict] = None):
        self.bindings = bindings
        self.lazy = lazy or {}  # name -> AST (for variables.*)
        self._memo: dict = {}

    def child(self, name: str, value: Any) -> "Env":
        e = Env({**self.bindings, name: value}, self.lazy)
        e._memo = self._memo
        return e

    def variable(self, name: str) -> Any:
        if name in self._memo:
            return self._memo[name]
        if name not in self.lazy:
            raise CelError(f"undeclared variable variables.{name}")
        val = evaluate(self.lazy[name], self)
        self._memo[name] = val
        return val


def evaluate(ast, env: Env) -> Any:
    try:
        return _evaluate(ast, env)
    except CelError:
        raise
    except (TypeError, KeyError, ValueError, AttributeError,
            IndexError) as e:
        # untyped host errors (unhashable keys, bad method arg types...)
        # become CEL evaluation errors so failurePolicy handling applies
        raise CelError(str(e) or type(e).__name__) from e


def _evaluate(ast, env: Env) -> Any:
    if isinstance(ast, Lit):
        return ast.value
    if isinstance(ast, Ident):
        if ast.name in env.bindings:
            return env.bindings[ast.name]
        raise CelError(f"undeclared reference {ast.name!r}")
    if isinstance(ast, Select):
        if isinstance(ast.base, Ident) and ast.base.name == "variables" and (
            "variables" not in env.bindings
        ):
            return env.variable(ast.field)
        base = evaluate(ast.base, env)
        if isinstance(base, dict):
            if ast.field in base:
                return base[ast.field]
            raise CelError(f"no such key: {ast.field}")
        raise CelError(
            f"type {_type_name(base)} does not support field selection"
        )
    if isinstance(ast, Index):
        base = evaluate(ast.base, env)
        idx = evaluate(ast.index, env)
        if isinstance(base, list):
            if not _is_num(idx):
                raise CelError("list index must be int")
            i = int(idx)
            if 0 <= i < len(base):
                return base[i]
            raise CelError(f"index out of bounds: {i}")
        if isinstance(base, dict):
            if idx in base:
                return base[idx]
            raise CelError(f"no such key: {idx!r}")
        raise CelError(f"type {_type_name(base)} does not support indexing")
    if isinstance(ast, Unary):
        v = evaluate(ast.operand, env)
        if ast.op == "!":
            if isinstance(v, bool):
                return not v
            raise CelError("! requires bool")
        if ast.op == "-":
            if _is_num(v):
                return -v
            raise CelError("- requires number")
    if isinstance(ast, Binary):
        return _binary(ast, env)
    if isinstance(ast, Ternary):
        cond = evaluate(ast.cond, env)
        if not isinstance(cond, bool):
            raise CelError("ternary condition must be bool")
        return evaluate(ast.then if cond else ast.other, env)
    if isinstance(ast, ListLit):
        return [evaluate(e, env) for e in ast.items]
    if isinstance(ast, MapLit):
        out = {}
        for k, v in ast.pairs:
            key = evaluate(k, env)
            if not isinstance(key, (str, int, bool)):
                raise CelError("unsupported map key type")
            out[key] = evaluate(v, env)
        return out
    if isinstance(ast, Call):
        return _call(ast, env)
    if isinstance(ast, Macro):
        return _macro(ast, env)
    raise CelError(f"cannot evaluate {ast!r}")


def _binary(ast: Binary, env: Env) -> Any:
    op = ast.op
    if op in ("||", "&&"):
        # CEL: short-circuit, commutative error absorption — the rhs only
        # runs when the lhs doesn't decide; an lhs error is absorbed if the
        # rhs decides (cel-go logical operator semantics)
        short = op == "||"
        try:
            lhs = evaluate(ast.lhs, env)
            if isinstance(lhs, bool) and lhs is short:
                return short
        except CelError as e:
            lhs = e
        rhs = evaluate(ast.rhs, env)
        if isinstance(rhs, bool) and rhs is short:
            return short
        if isinstance(lhs, CelError):
            raise lhs
        if isinstance(lhs, bool) and isinstance(rhs, bool):
            return (lhs or rhs) if short else (lhs and rhs)
        raise CelError(f"{op} requires bools")
    lhs = evaluate(ast.lhs, env)
    rhs = evaluate(ast.rhs, env)
    if op == "==":
        return _equals(lhs, rhs)
    if op == "!=":
        return not _equals(lhs, rhs)
    if op == "in":
        if isinstance(rhs, list):
            return any(_equals(lhs, e) for e in rhs)
        if isinstance(rhs, dict):
            return lhs in rhs
        raise CelError("in requires list or map")
    if op in ("<", "<=", ">", ">="):
        if _is_num(lhs) and _is_num(rhs):
            pass
        elif isinstance(lhs, str) and isinstance(rhs, str):
            pass
        elif isinstance(lhs, bool) and isinstance(rhs, bool):
            pass
        else:
            raise CelError(
                f"cannot compare {_type_name(lhs)} with {_type_name(rhs)}"
            )
        return {"<": lhs < rhs, "<=": lhs <= rhs,
                ">": lhs > rhs, ">=": lhs >= rhs}[op]
    if op == "+":
        if _is_num(lhs) and _is_num(rhs):
            return lhs + rhs
        if isinstance(lhs, str) and isinstance(rhs, str):
            return lhs + rhs
        if isinstance(lhs, list) and isinstance(rhs, list):
            return lhs + rhs
        raise CelError(
            f"cannot add {_type_name(lhs)} and {_type_name(rhs)}"
        )
    if op == "-":
        if _is_num(lhs) and _is_num(rhs):
            return lhs - rhs
        raise CelError("- requires numbers")
    if op == "*":
        if _is_num(lhs) and _is_num(rhs):
            return lhs * rhs
        raise CelError("* requires numbers")
    if op == "/":
        if _is_num(lhs) and _is_num(rhs):
            if rhs == 0:
                raise CelError("division by zero")
            if isinstance(lhs, int) and isinstance(rhs, int):
                q = abs(lhs) // abs(rhs)
                return q if (lhs >= 0) == (rhs >= 0) else -q
            return lhs / rhs
        raise CelError("/ requires numbers")
    if op == "%":
        if isinstance(lhs, int) and isinstance(rhs, int) and not (
            isinstance(lhs, bool) or isinstance(rhs, bool)
        ):
            if rhs == 0:
                raise CelError("modulus by zero")
            r = abs(lhs) % abs(rhs)
            return r if lhs >= 0 else -r
        raise CelError("% requires ints")
    raise CelError(f"unknown operator {op}")


def _equals(a, b) -> bool:
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if _is_num(a) and _is_num(b):
        return float(a) == float(b)
    if type(a) is not type(b):
        if a is None or b is None:
            return a is b
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(_equals(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equals(v, b[k])
                                            for k, v in a.items())
    return a == b


def _call(ast: Call, env: Env) -> Any:
    name = ast.name
    if ast.target is None:
        if name == "has":
            # cel-go: has(a.b.c) tests presence of c on a.b; errors reaching
            # a.b (missing intermediate key) PROPAGATE — guard chains with
            # has(a.b) && has(a.b.c) as VAP templates do
            sel: Select = ast.args[0]
            base = evaluate(sel.base, env)
            if isinstance(base, dict):
                return sel.field in base
            raise CelError(
                f"has() on {_type_name(base)}"
            )
        args = [evaluate(a, env) for a in ast.args]
        return _global_fn(name, args)
    target = evaluate(ast.target, env)
    args = [evaluate(a, env) for a in ast.args]
    return _method(target, name, args)


def _as_quantity(v):
    q = _parse_quantity(v)
    if q is None:
        raise CelError(f"invalid quantity {v!r}")
    return q


def _global_fn(name: str, args: list) -> Any:
    if name == "size" and len(args) == 1:
        v = args[0]
        if isinstance(v, (str, list, dict)):
            return len(v)
        raise CelError(f"size() unsupported for {_type_name(v)}")
    if name == "string" and len(args) == 1:
        v = args[0]
        if isinstance(v, str):
            return v
        if isinstance(v, bool):
            return "true" if v else "false"
        if _is_num(v):
            return repr(v) if isinstance(v, float) else str(v)
        raise CelError(f"string() unsupported for {_type_name(v)}")
    if name == "int" and len(args) == 1:
        v = args[0]
        if isinstance(v, bool):
            raise CelError("int() unsupported for bool")
        if isinstance(v, (int, float)):
            return int(v)
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                raise CelError(f"cannot convert {v!r} to int") from None
        raise CelError(f"int() unsupported for {_type_name(v)}")
    if name == "double" and len(args) == 1:
        v = args[0]
        if _is_num(v):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                raise CelError(f"cannot convert {v!r} to double") from None
        raise CelError(f"double() unsupported for {_type_name(v)}")
    if name == "bool" and len(args) == 1:
        v = args[0]
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            if v in ("true", "True", "1", "t", "TRUE"):
                return True
            if v in ("false", "False", "0", "f", "FALSE"):
                return False
            raise CelError(f"cannot convert {v!r} to bool")
        raise CelError(f"bool() unsupported for {_type_name(v)}")
    if name == "dyn" and len(args) == 1:
        return args[0]
    if name == "type" and len(args) == 1:
        return _type_name(args[0])
    # Kubernetes CEL extension libraries (reference: the k8scel driver's
    # cel-go env includes the k8s quantity / ip / cidr / url libs)
    if name == "quantity" and len(args) == 1:
        q = _parse_quantity(args[0])
        if q is None:
            raise CelError(f"invalid quantity {args[0]!r}")
        return q
    if name == "isQuantity" and len(args) == 1:
        return _parse_quantity(args[0]) is not None
    if name == "ip" and len(args) == 1:
        a = _parse_ip(args[0])
        if a is None:
            raise CelError(f"invalid IP {args[0]!r}")
        return a
    if name == "isIP" and len(args) == 1:
        return _parse_ip(args[0]) is not None
    if name == "cidr" and len(args) == 1:
        c = _parse_cidr(args[0])
        if c is None:
            raise CelError(f"invalid CIDR {args[0]!r}")
        return c
    if name == "isCIDR" and len(args) == 1:
        return _parse_cidr(args[0]) is not None
    if name == "url" and len(args) == 1:
        u = _parse_url(args[0])
        if u is None:
            raise CelError(f"invalid URL {args[0]!r}")
        return u
    if name == "isURL" and len(args) == 1:
        return _parse_url(args[0]) is not None
    raise CelError(f"unknown function {name}")


# --- k8s extension value types --------------------------------------------

_QUANTITY_SUFFIX = {
    "": 1, "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "Ei": 2**60,
}

_QUANTITY_RE = re.compile(
    r"^([+-]?[0-9]+(?:\.[0-9]*)?(?:[eE][+-]?[0-9]+)?)"
    r"(n|u|m|k|M|G|T|P|E|Ki|Mi|Gi|Ti|Pi|Ei)?$")


class _Quantity:
    __slots__ = ("value", "text")

    def __init__(self, value: float, text: str):
        self.value = value
        self.text = text

    def __repr__(self):
        return f"quantity({self.text!r})"

    def __eq__(self, other):
        return isinstance(other, _Quantity) and other.value == self.value

    def __hash__(self):
        return hash(("quantity", self.value))


def _parse_quantity(s):
    if isinstance(s, _Quantity):
        return s
    if not isinstance(s, str):
        return None
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        return None
    num, suffix = m.groups()
    try:
        return _Quantity(float(num) * _QUANTITY_SUFFIX[suffix or ""], s)
    except (ValueError, KeyError):
        return None


def _parse_ip(s):
    import ipaddress

    if not isinstance(s, str):
        return None
    try:
        return ipaddress.ip_address(s)
    except ValueError:
        return None


def _parse_cidr(s):
    import ipaddress

    if not isinstance(s, str):
        return None
    try:
        return ipaddress.ip_network(s, strict=False)
    except ValueError:
        return None


def _parse_url(s):
    from urllib.parse import urlparse

    if not isinstance(s, str):
        return None
    try:
        u = urlparse(s)
    except ValueError:
        return None
    if not u.scheme:
        return None
    return u


def _method(target: Any, name: str, args: list) -> Any:
    if isinstance(target, _Quantity):
        v = target.value
        if name == "isGreaterThan" and len(args) == 1:
            return v > _as_quantity(args[0]).value
        if name == "isLessThan" and len(args) == 1:
            return v < _as_quantity(args[0]).value
        if name == "compareTo" and len(args) == 1:
            o = _as_quantity(args[0]).value
            return -1 if v < o else (1 if v > o else 0)
        if name == "add" and len(args) == 1:
            o = _as_quantity(args[0]).value
            return _Quantity(v + o, f"{v + o}")
        if name == "sub" and len(args) == 1:
            o = _as_quantity(args[0]).value
            return _Quantity(v - o, f"{v - o}")
        if name == "asApproximateFloat" and not args:
            return float(v)
        if name == "asInteger" and not args:
            if v != int(v):
                raise CelError(f"quantity {target.text!r} is not an integer")
            return int(v)
        if name == "isInteger" and not args:
            return v == int(v)
        if name == "sign" and not args:
            return -1 if v < 0 else (1 if v > 0 else 0)
        raise CelError(f"unknown quantity method {name}")
    import ipaddress as _ipa

    if isinstance(target, (_ipa.IPv4Address, _ipa.IPv6Address)):
        if name == "family" and not args:
            return target.version
        if name == "isLoopback" and not args:
            return target.is_loopback
        if name == "isGlobalUnicast" and not args:
            return target.is_global and not target.is_multicast
        if name == "isUnspecified" and not args:
            return target.is_unspecified
        raise CelError(f"unknown ip method {name}")
    if isinstance(target, (_ipa.IPv4Network, _ipa.IPv6Network)):
        if name == "containsIP" and len(args) == 1:
            a = _parse_ip(args[0]) if not isinstance(
                args[0], (_ipa.IPv4Address, _ipa.IPv6Address)) else args[0]
            if a is None:
                raise CelError(f"invalid IP {args[0]!r}")
            return a in target
        if name == "containsCIDR" and len(args) == 1:
            c = _parse_cidr(args[0]) if isinstance(args[0], str) else args[0]
            if c is None:
                raise CelError(f"invalid CIDR {args[0]!r}")
            return c.subnet_of(target)
        if name == "prefixLength" and not args:
            return target.prefixlen
        raise CelError(f"unknown cidr method {name}")
    from urllib.parse import ParseResult

    if isinstance(target, ParseResult):
        if name == "getScheme" and not args:
            return target.scheme
        if name == "getHost" and not args:
            return target.netloc
        if name == "getHostname" and not args:
            return target.hostname or ""
        if name == "getPort" and not args:
            return str(target.port) if target.port else ""
        if name == "getEscapedPath" and not args:
            return target.path
        if name == "getQuery" and not args:
            from urllib.parse import parse_qs

            return parse_qs(target.query)
        raise CelError(f"unknown url method {name}")
    if isinstance(target, str):
        if name == "contains":
            return args[0] in target
        if name == "startsWith":
            return target.startswith(args[0])
        if name == "endsWith":
            return target.endswith(args[0])
        if name == "matches":
            try:
                return re.search(args[0], target) is not None
            except re.error as e:
                raise CelError(f"invalid regex: {e}") from None
        if name == "size":
            return len(target)
        if name == "split":
            if len(args) == 2:
                limit = args[1]
                if limit == 0:
                    return []
                if limit < 0:
                    return target.split(args[0])
                return target.split(args[0], limit - 1)
            return target.split(args[0])
        if name == "lowerAscii":
            return target.lower()
        if name == "upperAscii":
            return target.upper()
        if name == "trim":
            return target.strip()
        if name == "replace":
            if len(args) == 2:
                return target.replace(args[0], args[1])
            return target.replace(args[0], args[1], args[2])
        if name == "indexOf":
            return target.find(args[0])
        if name == "substring":
            if len(args) == 1:
                return target[args[0]:]
            return target[args[0]:args[1]]
    if isinstance(target, list):
        if name == "size":
            return len(target)
        if name == "join":
            sep = args[0] if args else ""
            if all(isinstance(x, str) for x in target):
                return sep.join(target)
            raise CelError("join requires list of strings")
        if name == "isSorted":
            try:
                return all(target[i] <= target[i + 1]
                           for i in range(len(target) - 1))
            except TypeError:
                raise CelError("isSorted: incomparable elements") from None
    if isinstance(target, dict):
        if name == "size":
            return len(target)
    raise CelError(
        f"unknown method {name} on {_type_name(target)}"
    )


def _macro(ast: Macro, env: Env) -> Any:
    target = evaluate(ast.target, env)
    if isinstance(target, dict):
        items = list(target.keys()) if ast.var2 is None else list(
            target.items())
    elif isinstance(target, list):
        # two-variable form over a list binds (index, value)
        items = (target if ast.var2 is None
                 else list(enumerate(target)))
    else:
        raise CelError(f"macro on {_type_name(target)}")

    def bind(item):
        if ast.var2 is not None:
            k, v = item
            return env.child(ast.var, k).child(ast.var2, v)
        return env.child(ast.var, item)

    name = ast.name
    if name in ("all", "exists"):
        # CEL: errors absorbed if the result is decided by other elements
        want = name == "exists"
        err: Optional[CelError] = None
        for item in items:
            try:
                v = evaluate(ast.body, bind(item))
            except CelError as e:
                err = err or e
                continue
            if not isinstance(v, bool):
                err = err or CelError("macro predicate must be bool")
                continue
            if v is want:
                return want
        if err is not None:
            raise err
        return not want
    if name == "exists_one":
        count = 0
        for item in items:
            v = evaluate(ast.body, bind(item))
            if not isinstance(v, bool):
                raise CelError("exists_one predicate must be bool")
            if v:
                count += 1
        return count == 1
    if name == "filter":
        out = []
        for item in items:
            v = evaluate(ast.body, bind(item))
            if not isinstance(v, bool):
                raise CelError("filter predicate must be bool")
            if v:
                out.append(item if ast.var2 is None else item[0])
        return out
    if name == "map":
        if ast.body2 is not None:
            out = []
            for item in items:
                b = bind(item)
                keep = evaluate(ast.body, b)
                if not isinstance(keep, bool):
                    raise CelError("map filter must be bool")
                if keep:
                    out.append(evaluate(ast.body2, b))
            return out
        return [evaluate(ast.body, bind(item)) for item in items]
    raise CelError(f"unknown macro {name}")


class Program:
    """A compiled expression."""

    def __init__(self, src: str):
        self.src = src
        self.ast = parse(src)

    def eval(self, bindings: dict, lazy: Optional[dict] = None) -> Any:
        return evaluate(self.ast, Env(bindings, lazy))
