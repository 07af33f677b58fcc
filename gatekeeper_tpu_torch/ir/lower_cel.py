"""CEL (K8sNativeValidation) → predicate-IR lowering.

The reference evaluates CEL templates with a per-(constraint, review)
cel-go program loop (pkg/drivers/k8scel/driver.go:162-251).  Here the same
vectorizable fragment that ir/lower_rego.py covers for Rego lowers CEL
validations onto the SAME device IR (ir/nodes.py), so CEL constraints join
the fused [C, N] verdict sweep instead of running a per-object Python
evaluator.

Exact semantics being lowered (drivers/cel_driver.py query loop):
a validation VIOLATES iff its expression does NOT evaluate to exactly
``true`` — evaluating to false, to a non-bool, or erroring (under
``failurePolicy: Fail``) all violate.  The lowerer therefore tracks DUAL
polarity for every boolean subexpression:

    t(E): device expr that is true  iff E evaluates to exactly true
    f(E): device expr that is true  iff E evaluates to exactly false

and the violation expression is ``Not(t(E))`` — which correctly includes
CEL's error outcomes because every primitive's t/f forms are definedness-
gated (absent fields, non-string operands to string predicates, and
unparseable quantities make both polarities false).

CEL's error-absorbing && / || map exactly onto this dual form:
    t(a && b) = t(a) ∧ t(b)        f(a && b) = f(a) ∨ f(b)
    t(a || b) = t(a) ∨ t(b)        f(a || b) = f(a) ∧ f(b)
    t(!a) = f(a)                   f(!a) = t(a)
macros:
    t(L.all(x, P))    = ¬∃item ¬t(P)      f = ∃item f(P)
    t(L.exists(x, P)) = ∃item t(P)        f = ¬∃item ¬f(P)
    t(size(L.filter(x, P)) == 0) = ¬∃item ¬f(P)   (all items exactly false)

Fragment boundaries (anything else raises LowerError → interpreter
fallback behind the same Driver seam):
- failurePolicy must be Fail (Ignore absorbs errors differently);
- no matchConditions;
- comparisons on quantities (isQuantity/quantity().isGreaterThan/...),
  booleans, strings, and literal numbers;
- list sources: object paths, ``a + b`` concatenation, the
  ``!has(p) ? [] : p`` guard idiom, string-list params;
- no oldObject / request / namespaceObject access.

Messages are NOT lowered: hits render through the CEL evaluator
(messageExpression semantics preserved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from gatekeeper_tpu_torch.ir import nodes as N
from gatekeeper_tpu_torch.ir.program import LowerError, _ElemListSid
from gatekeeper_tpu_torch.lang.cel import cel as C
from gatekeeper_tpu_torch.ops.flatten import (Axis, K_FALSE, K_MAP, K_NUM, K_OTHER,
                                        K_STR, K_TRUE, RaggedCol, ScalarCol,
                                        Schema)

QUANTITY_FN = "cel.quantity"

_STR_METHODS = {"startsWith": "startswith", "endsWith": "endswith",
                "contains": "contains", "matches": "re_match"}
_QTY_CMP = {"isGreaterThan": ("gt", "lte"), "isLessThan": ("lt", "gte")}


# --- symbolic values ------------------------------------------------------


class SVal:
    __slots__ = ()


@dataclass(frozen=True)
class SObj(SVal):
    """Value at a path under the review object root."""

    path: tuple


@dataclass(frozen=True)
class SItem(SVal):
    """Field of the current macro item on a ragged axis."""

    axis: Axis
    subpath: tuple


@dataclass(frozen=True)
class ListPart(SVal):
    """One source of a (possibly concatenated) list value.

    ``empty_guards``: exprs under which the source evaluates to a DEFINED
    empty list via the ``!has(p) ? [] : p`` idiom (each is the exactly-
    false form of the corresponding has()).  ``path`` locates the value
    for list/map kind gating (object-rooted)."""

    path: tuple
    empty_guards: tuple = ()


@dataclass(frozen=True)
class SList(SVal):
    """A list value backed by a ragged axis over one or more parts.

    CEL outcome model per part: ERROR (base chain broken / unguarded
    absent / non-list value), EMPTY (a guard fired), LIST (items).  Maps
    are NOT lists: a macro over a non-empty map iterates KEYS (which this
    axis cannot represent) and a concat over a map errors — both gate to
    the error outcome, which is exact as long as the macro body derefs
    the loop variable (enforced by the bare-variable check)."""

    axis: Axis
    parts: tuple  # tuple[ListPart]


@dataclass(frozen=True)
class SFiltered(SVal):
    """``L.filter(var, body)`` — lowered lazily at the size() comparison."""

    source: "SList"
    var: str
    body: Any
    env: tuple  # frozen env items


@dataclass(frozen=True)
class SParam(SVal):
    path: tuple  # under params root


@dataclass(frozen=True)
class SParamList(SVal):
    name: str


@dataclass(frozen=True)
class SParamElem(SVal):
    name: str


@dataclass(frozen=True)
class SMapKey(SVal):
    """The current macro item's MAP KEY: CEL macros over maps iterate
    keys, and the flattener's ragged axes carry an aligned MapKeyColumn
    (sid per value item, -1 for list-backed items) — so a key-predicate
    body lowers to string ops over that column."""

    axis: Axis


@dataclass(frozen=True)
class SLit(SVal):
    value: Any


@dataclass(frozen=True)
class SQuantity(SVal):
    arg: SVal


class _VariablesMarker(SVal):
    __slots__ = ()


def _check_no_bare_var(ast, var: str) -> None:
    """CEL macros iterate map KEYS; the ragged axis holds VALUES.  The
    _list_ok gates emit the ERROR outcome for macros over non-empty maps,
    which is exact only if the body genuinely errors on every string key.
    Three conditions enforce that statically:

    - the variable is never used BARE (a value use like ``k == "x"`` is
      key-sensitive and evaluates fine on strings);
    - BOTH outcomes of the body require a successful dereference of the
      variable (CEL's absorbing && / || can otherwise decide the body
      without touching the var: ``has(c.x) || true`` is TRUE over keys,
      ``has(c.x) && false`` is FALSE over keys — either would diverge)."""
    t_req, f_req = _deref_req(ast, var)
    if not (t_req and f_req):
        raise LowerError(
            f"macro body can decide without dereferencing {var}")


def _deref_req(ast, var: str) -> tuple:
    """(t_req, f_req): whether the body's exactly-true / exactly-false
    outcome entails a successful deref of ``var`` (vacuous outcomes count
    as requiring).  Raises on bare uses."""
    if isinstance(ast, C.Lit):
        if ast.value is True:
            return False, True
        if ast.value is False:
            return True, False
        return True, True  # non-bool literal can't decide a bool body
    if isinstance(ast, C.Unary) and ast.op == "!":
        t, f = _deref_req(ast.operand, var)
        return f, t
    if isinstance(ast, C.Binary) and ast.op in ("&&", "||"):
        lt, lf = _deref_req(ast.lhs, var)
        rt, rf = _deref_req(ast.rhs, var)
        if ast.op == "&&":
            return (lt or rt), (lf and rf)
        return (lt and rt), (lf or rf)
    if isinstance(ast, C.Ternary):
        ct, cf = _deref_req(ast.cond, var)
        at, af = _deref_req(ast.then, var)
        bt, bf = _deref_req(ast.other, var)
        return ((ct or at) and (cf or bt)), ((ct or af) and (cf or bf))
    if isinstance(ast, C.Macro):
        # nested macro (e.g. over a param list): true needs a true element
        # (body true), false is reachable with an empty source (no deref)
        bt, bf = _deref_req(ast.body, var)
        tgt = _count_var_derefs(ast.target, var, False) > 0
        if ast.name == "exists":
            return (tgt or bt), tgt
        if ast.name == "all":
            return tgt, (tgt or bf)
        return False, False  # filter/map: analyzed at their comparison
    # leaf predicate (comparison, method, has, in): both outcomes imply its
    # operands evaluated — derefs under nested macro BODIES don't count
    # (an empty source decides without evaluating the body)
    d = _count_var_derefs(ast, var, False, skip_macro_bodies=True) > 0
    return d, d


def _str_method_req(ast, var: str) -> tuple:
    """(t_req, f_req): whether deciding the body's exactly-true /
    exactly-false outcome entails evaluating a STRING METHOD whose
    target is the bare ``var`` (k.startsWith(p) etc.) — on an int (a
    list index in a two-variable macro) that method call errors, so
    requiring it in both outcomes makes a non-empty list reduce to the
    error outcome.  Same combinator algebra as :func:`_deref_req`
    (vacuous outcomes count as requiring)."""
    if isinstance(ast, C.Lit):
        if ast.value is True:
            return False, True
        if ast.value is False:
            return True, False
        return True, True
    if isinstance(ast, C.Unary) and ast.op == "!":
        t, f = _str_method_req(ast.operand, var)
        return f, t
    if isinstance(ast, C.Binary) and ast.op in ("&&", "||"):
        lt, lf = _str_method_req(ast.lhs, var)
        rt, rf = _str_method_req(ast.rhs, var)
        if ast.op == "&&":
            return (lt or rt), (lf and rf)
        return (lt and rt), (lf or rf)
    if isinstance(ast, C.Ternary):
        ct, cf = _str_method_req(ast.cond, var)
        at, af = _str_method_req(ast.then, var)
        bt, bf = _str_method_req(ast.other, var)
        return ((ct or at) and (cf or bt)), ((ct or af) and (cf or bf))
    d = _has_str_method_on(ast, var)
    return d, d


def _has_str_method_on(ast, var: str) -> bool:
    """A string method with bare ``var`` as target occurs anywhere in
    this (leaf) expression's operands."""
    if isinstance(ast, C.Call):
        if ast.name in _STR_METHODS and isinstance(ast.target, C.Ident) \
                and ast.target.name == var:
            return True
        ops = ([ast.target] if ast.target is not None else []) + \
            list(ast.args)
        return any(_has_str_method_on(a, var) for a in ops)
    if isinstance(ast, C.Binary):
        return _has_str_method_on(ast.lhs, var) or \
            _has_str_method_on(ast.rhs, var)
    if isinstance(ast, C.Unary):
        return _has_str_method_on(ast.operand, var)
    if isinstance(ast, (C.Select, C.Index)):
        return False  # a deref of var is not a string method
    return False


def _count_var_derefs(ast, var: str, safe: bool,
                      skip_macro_bodies: bool = False) -> int:
    count = 0
    if isinstance(ast, C.Ident):
        if ast.name == var:
            if not safe:
                raise LowerError(f"macro variable {var} used bare")
            return 1
        return 0
    if isinstance(ast, C.Select):
        return _count_var_derefs(ast.base, var, True, skip_macro_bodies)
    if isinstance(ast, C.Index):
        return (_count_var_derefs(ast.base, var, True, skip_macro_bodies)
                + _count_var_derefs(ast.index, var, False,
                                    skip_macro_bodies))
    if isinstance(ast, C.Call):
        # only Select/Index BASE positions deref; a method target or call
        # argument uses the value itself (string ops on a map key work)
        if ast.target is not None:
            count += _count_var_derefs(ast.target, var, False,
                                       skip_macro_bodies)
        for a in ast.args:
            count += _count_var_derefs(a, var, False, skip_macro_bodies)
        return count
    if isinstance(ast, C.Macro) and skip_macro_bodies:
        return _count_var_derefs(ast.target, var, False, skip_macro_bodies)
    for f in getattr(ast, "__dataclass_fields__", {}):
        v = getattr(ast, f)
        if isinstance(v, (C.Lit, C.Ident, C.Select, C.Index, C.Call,
                          C.Unary, C.Binary, C.Ternary, C.ListLit,
                          C.MapLit, C.Macro)):
            count += _count_var_derefs(v, var, False, skip_macro_bodies)
        elif isinstance(v, tuple):
            count += sum(_count_var_derefs(item, var, False,
                                           skip_macro_bodies)
                         for item in v)
    return count


_VARIABLES = _VariablesMarker()
_TRUE = N.ConstBool(True)
_FALSE = N.ConstBool(False)


def _and(*terms):
    flat = [t for t in terms if t is not _TRUE]
    if any(t is _FALSE for t in flat):
        return _FALSE
    if not flat:
        return _TRUE
    return flat[0] if len(flat) == 1 else N.And(tuple(flat))


def _or(*terms):
    flat = [t for t in terms if t is not _FALSE]
    if any(t is _TRUE for t in flat):
        return _TRUE
    if not flat:
        return _FALSE
    return flat[0] if len(flat) == 1 else N.Or(tuple(flat))


class _CelLowerer:
    def __init__(self, variables: dict, vocab, schema_hint: Optional[dict]):
        self.variables = variables  # name -> CEL AST
        self.vocab = vocab
        self.schema = Schema()
        self.schema_hint = (schema_hint or {}).get("properties", {})
        self.param_kinds: dict[str, str] = {}
        self.weak_params: set = set()  # has()-only params (type unclaimed)
        self._var_stack: list[str] = []

    # --- schema/column helpers ---------------------------------------
    def _scalar_col(self, path: tuple) -> ScalarCol:
        col = ScalarCol(path=path)
        if col not in self.schema.scalars:
            self.schema.scalars.append(col)
        return col

    def _ragged_col(self, axis: Axis, subpath: tuple) -> RaggedCol:
        col = RaggedCol(axis=axis, subpath=subpath)
        if col not in self.schema.raggeds:
            self.schema.raggeds.append(col)
        return col

    def _feat_col(self, sv: SVal):
        if isinstance(sv, SObj):
            return self._scalar_col(sv.path)
        if isinstance(sv, SItem):
            return self._ragged_col(sv.axis, sv.subpath)
        raise LowerError(f"no column for {sv}")

    def _note_param(self, name: str, kind: str):
        prev = self.param_kinds.get(name)
        if prev is not None and prev != kind:
            raise LowerError(f"param {name} used as {prev} and {kind}")
        self.param_kinds[name] = kind

    # --- operand builders --------------------------------------------
    def _sid(self, sv: SVal) -> N.Expr:
        """sid-valued operand (string reads)."""
        if isinstance(sv, (SObj, SItem)):
            return N.FeatSid(self._feat_col(sv))
        if isinstance(sv, SParam):
            if len(sv.path) != 1:
                raise LowerError(f"nested param path {sv.path}")
            self._note_param(sv.path[0], "str")
            return N.ParamSid(sv.path[0])
        if isinstance(sv, SParamElem):
            return N.ParamElemSid()
        if isinstance(sv, SMapKey):
            return N.MapKeySid(self._map_key_col(sv.axis))
        if isinstance(sv, SLit) and isinstance(sv.value, str):
            return N.ConstSid(self.vocab.intern(sv.value))
        raise LowerError(f"not a string operand: {sv}")

    def _map_key_col(self, axis: Axis):
        from gatekeeper_tpu_torch.ops.flatten import MapKeyCol

        col = MapKeyCol(axis=axis)
        if col not in self.schema.map_keys:
            self.schema.map_keys.append(col)
        return col

    def _is_str(self, sv: SVal) -> N.Expr:
        """Defined-string test for the false-polarity gates."""
        if isinstance(sv, (SObj, SItem)):
            return N.KindIs(self._feat_col(sv), K_STR)
        if isinstance(sv, SParam):
            self._note_param(sv.path[0], "str")
            return N.ParamPresent(sv.path[0])
        if isinstance(sv, (SParamElem, SLit, SMapKey)):
            return _TRUE  # map keys are always defined strings
        raise LowerError(f"not a string operand: {sv}")

    def _defined(self, sv: SVal) -> N.Expr:
        """The operand evaluates without error, any type (CEL equality is
        heterogeneous: mixed-type == is a defined false, not an error)."""
        if isinstance(sv, (SObj, SItem)):
            return N.Present(self._feat_col(sv))
        if isinstance(sv, SParam):
            if len(sv.path) != 1:
                raise LowerError(f"nested param path {sv.path}")
            self.weak_params.add(sv.path[0])
            return N.ParamPresent(sv.path[0])
        if isinstance(sv, (SParamElem, SLit, SMapKey)):
            return _TRUE
        raise LowerError(f"no definedness test for {sv}")

    def _has_pair(self, sv: SVal) -> tuple:
        """CEL has(a.b.c): true iff the leaf exists (walk implies the base
        chain was maps); exactly-FALSE requires every proper prefix to be a
        present map (a broken base chain ERRORS — has() is not total)."""
        if isinstance(sv, SObj):
            if not sv.path:
                raise LowerError("has() of the object root")
            t = N.Present(self._scalar_col(sv.path))
            gates = [
                N.KindIs(self._scalar_col(sv.path[:i]), K_MAP)
                for i in range(1, len(sv.path))
            ]
            return t, _and(*gates, N.Not(t))
        if isinstance(sv, SItem):
            if not sv.subpath:
                raise LowerError("has() of a bare loop variable")
            t = N.Present(self._ragged_col(sv.axis, sv.subpath))
            gates = [
                N.KindIs(self._ragged_col(sv.axis, sv.subpath[:i]), K_MAP)
                for i in range(1, len(sv.subpath))
            ]
            return t, _and(*gates, N.Not(t))
        if isinstance(sv, SParam):
            if len(sv.path) != 1:
                raise LowerError(f"nested param path {sv.path}")
            # kind noted at the USE site; has() alone doesn't fix a type —
            # weak 'str' default applied at build unless a use claims it
            self.weak_params.add(sv.path[0])
            pres = N.ParamPresent(sv.path[0])
            return pres, N.Not(pres)  # params root is always a map
        raise LowerError(f"has() of {sv}")

    def _num(self, sv: SVal) -> N.Expr:
        if isinstance(sv, SLit) and isinstance(sv.value, (int, float)) \
                and not isinstance(sv.value, bool):
            return N.ConstNum(float(sv.value))
        if isinstance(sv, SQuantity):
            arg = sv.arg
            if isinstance(arg, SParam):
                if len(arg.path) != 1:
                    raise LowerError(f"nested param path {arg.path}")
                self._note_param(arg.path[0], "str")
                return N.ParamFnNum(QUANTITY_FN, arg.path[0])
            return N.StrFnNum(QUANTITY_FN, self._sid(arg))
        if isinstance(sv, (SObj, SItem)):
            return N.FeatNum(self._feat_col(sv))
        raise LowerError(f"not numeric: {sv}")

    def _num_gate(self, sv: SVal) -> N.Expr:
        """CEL errors on cross-type comparison (no Rego total order): gate
        feature reads on the numeric kind tag."""
        if isinstance(sv, (SObj, SItem)):
            return N.KindIs(self._feat_col(sv), K_NUM)
        return _TRUE  # literals always; quantities gate via validity

    # --- value lowering ----------------------------------------------
    def value(self, ast, env: dict) -> SVal:
        if isinstance(ast, C.Lit):
            return SLit(ast.value)
        if isinstance(ast, C.Ident):
            name = ast.name
            if name in env:
                return env[name]
            if name == "variables":
                return _VARIABLES
            if name in ("object", "anyObject"):
                return SObj(())
            if name == "params":
                return SParam(())
            if name in ("oldObject", "request", "namespaceObject"):
                raise LowerError(f"unsupported root {name}")
            raise LowerError(f"unknown ident {name}")
        if isinstance(ast, C.Select):
            base = self.value(ast.base, env)
            if isinstance(base, _VariablesMarker):
                return self._resolve_variable(ast.field, env)
            if isinstance(base, SObj):
                return SObj(base.path + (ast.field,))
            if isinstance(base, SItem):
                return SItem(base.axis, base.subpath + (ast.field,))
            if isinstance(base, SParam):
                return SParam(base.path + (ast.field,))
            raise LowerError(f"select .{ast.field} on {base}")
        if isinstance(ast, C.Index):
            base = self.value(ast.base, env)
            if isinstance(ast.index, C.Lit) and isinstance(
                    ast.index.value, str):
                if isinstance(base, SObj):
                    return SObj(base.path + (ast.index.value,))
                if isinstance(base, SItem):
                    return SItem(base.axis,
                                 base.subpath + (ast.index.value,))
                if isinstance(base, SParam):
                    return SParam(base.path + (ast.index.value,))
            raise LowerError("dynamic index")
        if isinstance(ast, C.Call):
            if ast.target is None and ast.name == "quantity" \
                    and len(ast.args) == 1:
                return SQuantity(self.value(ast.args[0], env))
            raise LowerError(f"call {ast.name} in value position")
        if isinstance(ast, C.Binary) and ast.op == "+":
            lhs = self._as_list(self.value(ast.lhs, env))
            rhs = self._as_list(self.value(ast.rhs, env))
            if isinstance(lhs, SList) and isinstance(rhs, SList):
                return SList(Axis(lhs.axis.segments + rhs.axis.segments),
                             lhs.parts + rhs.parts)
            raise LowerError("+ on non-lists")
        if isinstance(ast, C.Ternary):
            return self._guarded_list(ast, env)
        if isinstance(ast, C.ListLit):
            if not ast.items:
                return SList(Axis(()), ())  # empty list literal
            items = [self.value(i, env) for i in ast.items]
            if all(isinstance(i, SLit) and isinstance(i.value, str)
                   for i in items):
                return SLit([i.value for i in items])
            raise LowerError("non-string list literal")
        if isinstance(ast, C.Macro):
            if ast.name == "filter" and ast.var2 is None:
                target = self._as_list(self.value(ast.target, env))
                if isinstance(target, SList):
                    return SFiltered(target, ast.var, ast.body,
                                     tuple(env.items()))
            raise LowerError(f"macro {ast.name} in value position")
        raise LowerError(f"value {type(ast).__name__}")

    def _resolve_variable(self, name: str, env: dict) -> SVal:
        if name == "anyObject":
            return SObj(())
        if name == "params":
            return SParam(())
        if name not in self.variables:
            raise LowerError(f"unknown variable {name}")
        if name in self._var_stack:
            raise LowerError(f"variable cycle at {name}")
        self._var_stack.append(name)
        try:
            return self.value(self.variables[name], {})
        finally:
            self._var_stack.pop()

    def _as_list(self, sv: SVal) -> SVal:
        if isinstance(sv, (SList, SFiltered, SParamList)):
            return sv
        if isinstance(sv, SObj):
            return SList(Axis(((sv.path,),)), (ListPart(sv.path),))
        if isinstance(sv, SItem):
            raise LowerError("nested item list (needs NestedAny)")
        if isinstance(sv, SParam):
            if len(sv.path) != 1:
                raise LowerError(f"nested param list {sv.path}")
            self._note_param(sv.path[0], "strlist")
            return SParamList(sv.path[0])
        raise LowerError(f"not a list: {sv}")

    def _guarded_list(self, ast: C.Ternary, env: dict) -> SVal:
        """``!has(p) ? [] : x`` / ``has(p) ? x : []``: the guard's exactly-
        false form becomes an empty_guard on the resulting list parts (the
        value is a DEFINED [] when the guard fires; a broken base chain
        still errors through the has itself)."""
        def is_empty_list(a):
            return isinstance(a, C.ListLit) and not a.items

        cond, then, other = ast.cond, ast.then, ast.other
        neg = isinstance(cond, C.Unary) and cond.op == "!"
        inner = cond.operand if neg else cond
        if not (isinstance(inner, C.Call) and inner.target is None
                and inner.name == "has" and len(inner.args) == 1):
            raise LowerError("ternary outside the has()-guard idiom")
        guarded_sv = self.value(inner.args[0], env)
        t_has, f_has = self._has_pair(guarded_sv)
        if neg and is_empty_list(then):
            taken = self.value(other, env)
        elif not neg and is_empty_list(other):
            taken = self.value(then, env)
        else:
            raise LowerError("ternary outside the has()-guard idiom")
        if isinstance(taken, SParam):
            taken = self._as_list(taken)
        if isinstance(taken, SParamList):
            return taken  # param-table counts already encode absence
        taken = self._as_list(taken)
        if not isinstance(taken, SList):
            raise LowerError(f"guarded non-list {taken}")
        parts = tuple(
            ListPart(p.path, p.empty_guards + (f_has,))
            for p in taken.parts
        )
        return SList(taken.axis, parts)

    def _list_ok(self, target: SList, allow_empty_map: bool) -> N.Expr:
        """The target expression evaluates to a DEFINED list (or, when
        allowed, an empty map — CEL macros over empty maps are vacuous).
        Anything else (error, non-list value, NON-empty map whose keys the
        axis cannot represent) fails both polarities → error → violation."""
        oks = []
        for part in target.parts:
            col = self._scalar_col(part.path)
            alts = list(part.empty_guards)
            alts.append(N.KindIs(col, K_OTHER))
            if allow_empty_map:
                axis = Axis(((part.path,),))
                self._touch_axis(axis)
                alts.append(_and(
                    N.KindIs(col, K_MAP),
                    N.Not(N.AnyAxis(axis, _TRUE)),
                ))
            oks.append(_or(*alts))
        return _and(*oks)

    def _touch_axis(self, axis: Axis):
        """Ensure the axis's counts are materialized in the schema."""
        col = RaggedCol(axis=axis, subpath=())
        if col not in self.schema.raggeds:
            self.schema.raggeds.append(col)

    # --- boolean lowering (dual polarity) ----------------------------
    def bool_pair(self, ast, env: dict) -> tuple:
        if isinstance(ast, C.Lit):
            if ast.value is True:
                return _TRUE, _FALSE
            if ast.value is False:
                return _FALSE, _TRUE
            raise LowerError("non-bool literal in bool position")
        if isinstance(ast, C.Unary):
            if ast.op == "!":
                t, f = self.bool_pair(ast.operand, env)
                return f, t
            raise LowerError(f"unary {ast.op}")
        if isinstance(ast, C.Ternary):
            tc, fc = self.bool_pair(ast.cond, env)
            ta, fa = self.bool_pair(ast.then, env)
            tb, fb = self.bool_pair(ast.other, env)
            return (_or(_and(tc, ta), _and(fc, tb)),
                    _or(_and(tc, fa), _and(fc, fb)))
        if isinstance(ast, C.Binary):
            return self._binary_pair(ast, env)
        if isinstance(ast, C.Macro):
            return self._macro_pair(ast, env)
        if isinstance(ast, C.Call):
            return self._call_pair(ast, env)
        if isinstance(ast, (C.Ident, C.Select, C.Index)):
            # a bare boolean field read
            sv = self.value(ast, env)
            if isinstance(sv, (SObj, SItem)):
                col = self._feat_col(sv)
                return N.KindIs(col, K_TRUE), N.KindIs(col, K_FALSE)
            if isinstance(sv, SParam):
                if len(sv.path) != 1:
                    raise LowerError(f"nested param path {sv.path}")
                self._note_param(sv.path[0], "bool")
                return (N.ParamBoolIs(sv.path[0], True),
                        N.ParamBoolIs(sv.path[0], False))
            raise LowerError(f"bool read of {sv}")
        raise LowerError(f"bool {type(ast).__name__}")

    def _binary_pair(self, ast: C.Binary, env: dict) -> tuple:
        op = ast.op
        if op == "&&":
            ta, fa = self.bool_pair(ast.lhs, env)
            tb, fb = self.bool_pair(ast.rhs, env)
            return _and(ta, tb), _or(fa, fb)
        if op == "||":
            ta, fa = self.bool_pair(ast.lhs, env)
            tb, fb = self.bool_pair(ast.rhs, env)
            return _or(ta, tb), _and(fa, fb)
        if op in ("==", "!="):
            t, f = self._eq_pair(ast.lhs, ast.rhs, env)
            return (f, t) if op == "!=" else (t, f)
        if op in ("<", "<=", ">", ">="):
            ir_op = {"<": "lt", "<=": "lte", ">": "gt", ">=": "gte"}[op]
            inv = {"lt": "gte", "lte": "gt", "gt": "lte", "gte": "lt"}[ir_op]
            return self._cmp_pair(ast.lhs, ast.rhs, ir_op, inv, env)
        if op == "in":
            needle = self.value(ast.lhs, env)
            hay = self._as_list(self.value(ast.rhs, env))
            if isinstance(hay, SParamList):
                hit = N.InStrList(self._sid(needle), hay.name)
                # heterogeneous membership: a defined non-string needle is
                # simply not in a string list (false, not error)
                return hit, _and(self._defined(needle), N.Not(hit))
            raise LowerError("in over non-param list")
        raise LowerError(f"binary {op}")

    def _size_of(self, ast, env: dict) -> Optional[SVal]:
        if isinstance(ast, C.Call) and ast.name == "size" \
                and len(ast.args) == 1 and ast.target is None:
            return self._as_list(self.value(ast.args[0], env))
        return None

    def _cmp_pair(self, lhs_ast, rhs_ast, ir_op, inv_op, env) -> tuple:
        sized = self._size_of(lhs_ast, env)
        if sized is not None:
            k = self.value(rhs_ast, env)
            if isinstance(k, SLit) and k.value == 0:
                return self._size_cmp_zero(sized, ir_op)
            raise LowerError("size() compared to non-zero")
        sized = self._size_of(rhs_ast, env)
        if sized is not None:
            flip = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}
            return self._cmp_pair(rhs_ast, lhs_ast, flip[ir_op],
                                  flip[inv_op], env)
        lv = self.value(lhs_ast, env)
        rv = self.value(rhs_ast, env)
        gates = _and(self._num_gate(lv), self._num_gate(rv))
        ln, rn = self._num(lv), self._num(rv)
        return (_and(gates, N.CmpNum(ln, ir_op, rn)),
                _and(gates, N.CmpNum(ln, inv_op, rn)))

    def _size_cmp_zero(self, target: SVal, ir_op: str) -> tuple:
        """size(L) <op> 0 for list targets (axis count semantics)."""
        if isinstance(target, SFiltered):
            src = target.source
            _check_no_bare_var(target.body, target.var)
            sub_env = dict(target.env)
            sub_env[target.var] = SItem(src.axis, ())
            tp, fp = self.bool_pair(target.body, sub_env)
            ok = self._list_ok(src, allow_empty_map=len(src.parts) == 1)
            if not src.axis.segments:
                eq0_t, eq0_f = _TRUE, _FALSE  # filter of [] is []
            else:
                all_false = N.Not(N.AnyAxis(src.axis, N.Not(fp)))
                some_true = N.AnyAxis(src.axis, tp)
                defined = N.Not(N.AnyAxis(src.axis,
                                          _and(N.Not(tp), N.Not(fp))))
                eq0_t = _and(ok, all_false)
                eq0_f = _and(ok, some_true, defined)
        elif isinstance(target, SList):
            if not target.axis.segments:
                eq0_t, eq0_f = _TRUE, _FALSE  # empty list literal
            else:
                ok = self._list_ok(target,
                                   allow_empty_map=len(target.parts) == 1)
                nonempty = N.AnyAxis(target.axis, _TRUE)
                eq0_t = _and(ok, N.Not(nonempty))
                eq0_f = _and(ok, nonempty)
        else:
            raise LowerError(f"size() of {target}")
        if ir_op == "eq":
            return eq0_t, eq0_f
        if ir_op == "neq":
            return eq0_f, eq0_t
        if ir_op == "gt":  # size > 0 ⇔ not (size == 0)
            return eq0_f, eq0_t
        if ir_op == "lte":  # size <= 0 ⇔ size == 0
            return eq0_t, eq0_f
        raise LowerError(f"size() {ir_op} 0")

    def _eq_pair(self, lhs_ast, rhs_ast, env) -> tuple:
        sized = self._size_of(lhs_ast, env) or self._size_of(rhs_ast, env)
        if sized is not None:
            other = rhs_ast if self._size_of(lhs_ast, env) is not None \
                else lhs_ast
            k = self.value(other, env)
            if isinstance(k, SLit) and k.value == 0:
                return self._size_cmp_zero(sized, "eq")
            raise LowerError("size() compared to non-zero")
        lv = self.value(lhs_ast, env)
        rv = self.value(rhs_ast, env)
        # boolean equality: x == true / x == false.  CEL equality is
        # heterogeneous: ANY defined non-matching value (other bool, string,
        # number, null) compares false — only absence errors
        for a, b in ((lv, rv), (rv, lv)):
            if isinstance(b, SLit) and isinstance(b.value, bool):
                if not isinstance(a, (SObj, SItem)):
                    raise LowerError("bool == on non-column")
                col = self._feat_col(a)
                want = K_TRUE if b.value else K_FALSE
                t = N.KindIs(col, want)
                return t, _and(N.Present(col), N.Not(t))
        # numeric equality (literal number or quantity on either side):
        # CmpNum(eq) is false on mixed types and CmpNum(neq) true — exactly
        # CEL's heterogeneous semantics — with presence/validity built into
        # the operand flags, so no extra kind gates
        if any(isinstance(x, SLit) and isinstance(x.value, (int, float))
               and not isinstance(x.value, bool) for x in (lv, rv)) or \
                any(isinstance(x, SQuantity) for x in (lv, rv)):
            ln, rn = self._num(lv), self._num(rv)
            return N.CmpNum(ln, "eq", rn), N.CmpNum(ln, "neq", rn)
        # string equality: one side must be a known-string (literal, param
        # element) so EqStr covers the true polarity; the false polarity is
        # CEL's heterogeneous equality — DEFINED operands of any type that
        # are not string-equal compare false, not error
        if not any(isinstance(x, SLit) or isinstance(x, SParamElem)
                   or isinstance(x, SParam) for x in (lv, rv)):
            raise LowerError("== between two object fields")
        ls, rs = self._sid(lv), self._sid(rv)
        eq = N.EqStr(ls, rs)
        return eq, _and(self._defined(lv), self._defined(rv), N.Not(eq))

    def _macro_pair(self, ast: C.Macro, env: dict) -> tuple:
        target = self._as_list(self.value(ast.target, env))
        if isinstance(target, SList):
            return self._list_macro_pair(ast, target, env)
        if isinstance(target, SParamList):
            if ast.var2 is not None:
                raise LowerError("two-variable macro over a param list")
            sub_env = dict(env)
            sub_env[ast.var] = SParamElem(target.name)
            tp, fp = self.bool_pair(ast.body, sub_env)
            tp = self._bind_elem_needles(tp, target.name)
            fp = self._bind_elem_needles(fp, target.name)
            self._assert_no_bare_elem(tp)
            self._assert_no_bare_elem(fp)
            if ast.name == "all":
                return (N.Not(N.AnyParamList(target.name, N.Not(tp))),
                        N.AnyParamList(target.name, fp))
            if ast.name == "exists":
                return (N.AnyParamList(target.name, tp),
                        N.Not(N.AnyParamList(target.name, N.Not(fp))))
            raise LowerError(f"macro {ast.name}")
        raise LowerError(f"macro over {target}")

    def _axis_macro_reduce(self, name: str, axis, tp, fp, gate) -> tuple:
        """(t, f) of a macro over one runtime-kind branch of an axis,
        from the body's dual-polarity pair.  exists_one never
        short-circuits, so BOTH its outcomes require every item defined."""
        if name == "all":
            return (_and(gate, N.Not(N.AnyAxis(axis, N.Not(tp)))),
                    _and(gate, N.AnyAxis(axis, fp)))
        if name == "exists":
            return (_and(gate, N.AnyAxis(axis, tp)),
                    _and(gate, N.Not(N.AnyAxis(axis, N.Not(fp)))))
        if name == "exists_one":
            defined = N.Not(N.AnyAxis(axis, _and(N.Not(tp), N.Not(fp))))
            one = N.CountAxisIs(axis, tp, 1)
            return (_and(gate, defined, one),
                    _and(gate, defined, N.Not(one)))
        raise LowerError(f"macro {name}")

    def _list_macro_pair(self, ast: C.Macro, target: SList,
                         env: dict) -> tuple:
        """Macros over object-backed lists AND maps, kind-branched at
        runtime: CEL iterates a LIST's values but a MAP's keys, and the
        flattener's ragged axes carry both (value items + an aligned
        MapKeyColumn), so one axis serves both semantics.

        - list branch: var (or var2 of a two-variable macro) binds the
          item value — the pre-existing lowering.
        - map branch (single-part targets): var binds the KEY (SMapKey →
          string ops over the MapKeyColumn); var2, when present, binds
          the value item.  Only taken when the body lowers under the key
          binding; otherwise non-empty maps gate to the error outcome,
          exact only when the body must deref the variable
          (_check_no_bare_var, as before).
        """
        if ast.name not in ("all", "exists", "exists_one"):
            raise LowerError(f"macro {ast.name}")
        axis = target.axis
        if not axis.segments:  # empty-list literal
            if ast.name == "all":
                return _TRUE, _FALSE
            return _FALSE, _TRUE  # exists / exists_one over []
        # the reductions below read the axis count column even when the
        # body never touches an item field (var-free / key-only bodies)
        self._touch_axis(axis)
        # map branch: body over keys (+ value items for two-variable)
        map_t = map_f = None
        if len(target.parts) == 1:
            try:
                menv = dict(env)
                menv[ast.var] = SMapKey(axis)
                if ast.var2 is not None:
                    menv[ast.var2] = SItem(axis, ())
                ktp, kfp = self.bool_pair(ast.body, menv)
                is_map = N.KindIs(
                    self._scalar_col(target.parts[0].path), K_MAP)
                map_t, map_f = self._axis_macro_reduce(
                    ast.name, axis, ktp, kfp, is_map)
            except LowerError:
                map_t = map_f = None
        # list branch
        if ast.var2 is None:
            sub_env = dict(env)
            sub_env[ast.var] = SItem(axis, ())
            tp, fp = self.bool_pair(ast.body, sub_env)
            if map_t is None:
                # maps gate to error: exact only if the body errors on
                # every string key (it must deref the variable)
                _check_no_bare_var(ast.body, ast.var)
                ok = self._list_ok(target,
                                   allow_empty_map=len(target.parts) == 1)
                return self._axis_macro_reduce(ast.name, axis, tp, fp, ok)
            ok = self._list_ok(target, allow_empty_map=False)
            lt, lf = self._axis_macro_reduce(ast.name, axis, tp, fp, ok)
            return _or(lt, map_t), _or(lf, map_f)
        # two-variable macro: over a map, (key, value); over a LIST, CEL
        # binds (index, value) — the int index makes every string-method
        # use of var error per item, so the list branch reduces to
        # vacuous-if-empty / error-if-non-empty, sound only when both
        # body outcomes require a string-method evaluation of var
        if map_t is None:
            raise LowerError("two-variable macro body does not lower "
                             "under the key binding")
        t_req, f_req = _str_method_req(ast.body, ast.var)
        if not (t_req and f_req):
            raise LowerError("two-variable macro body can decide without "
                             "a string method on the key variable")
        ok = self._list_ok(target, allow_empty_map=False)
        empty = _and(ok, N.Not(N.AnyAxis(axis, _TRUE)))
        if ast.name == "all":  # vacuous true on an empty list
            return _or(empty, map_t), map_f
        return map_t, _or(empty, map_f)  # exists/exists_one: vacuous false

    def _bind_elem_needles(self, expr: N.Expr, param: str) -> N.Expr:
        """Rewrite bare ParamElemSid StrPred needles to the table-backed
        _ElemListSid marker (build_param_table's strlist path).

        Recurses through every composite the macro body can produce —
        including AnyAxis/NestedAny, so an object-list macro nested inside
        a param-list macro (e.g. ``params.prefixes.exists(p,
        object.spec.containers.all(c, c.image.startsWith(p)))``) binds its
        needle; the kernel evaluates the [N, M, K] grid (eval_expr's
        elem-needle StrPred path handles the extra axis).  Any needle left
        bare after this pass would raise in build_param_table on EVERY
        query, so _assert_no_bare_elem turns that into a lowering-time
        fallback instead (ADVICE r2 high)."""
        if isinstance(expr, N.StrPred) and \
                isinstance(expr.needle, N.ParamElemSid):
            return N.StrPred(expr.op, expr.subject, _ElemListSid(param))
        if isinstance(expr, N.Not):
            return N.Not(self._bind_elem_needles(expr.inner, param))
        if isinstance(expr, N.And):
            return N.And(tuple(self._bind_elem_needles(t, param)
                               for t in expr.terms))
        if isinstance(expr, N.Or):
            return N.Or(tuple(self._bind_elem_needles(t, param)
                              for t in expr.terms))
        if isinstance(expr, N.AnyAxis):
            return N.AnyAxis(expr.axis,
                             self._bind_elem_needles(expr.inner, param))
        if isinstance(expr, N.NestedAny):
            return N.NestedAny(expr.col, expr.parent_col,
                               self._bind_elem_needles(expr.inner, param))
        return expr

    def _assert_no_bare_elem(self, expr: N.Expr) -> None:
        """LowerError if a bare ParamElemSid StrPred needle survived
        binding (a composite _bind_elem_needles doesn't know) — the
        template then falls back to the CEL evaluator instead of
        compiling a program that errors at query time."""
        if isinstance(expr, N.StrPred) and \
                isinstance(expr.needle, N.ParamElemSid):
            raise LowerError("unbound param-list element needle")
        for f in getattr(expr, "__dataclass_fields__", {}):
            v = getattr(expr, f)
            if isinstance(v, N.Expr):
                self._assert_no_bare_elem(v)
            elif isinstance(v, tuple):
                for t in v:
                    if isinstance(t, N.Expr):
                        self._assert_no_bare_elem(t)

    def _call_pair(self, ast: C.Call, env: dict) -> tuple:
        if ast.target is None:
            if ast.name == "has" and len(ast.args) == 1:
                sv = self.value(ast.args[0], env)
                return self._has_pair(sv)
            if ast.name == "isQuantity" and len(ast.args) == 1:
                sv = self.value(ast.args[0], env)
                valid = N.StrFnValid(QUANTITY_FN, self._sid(sv))
                return valid, _and(self._is_str(sv), N.Not(valid))
            raise LowerError(f"call {ast.name}")
        # method calls
        if ast.name in _STR_METHODS and len(ast.args) == 1:
            subject = self.value(ast.target, env)
            needle = self.value(ast.args[0], env)
            pred = N.StrPred(_STR_METHODS[ast.name], self._sid(subject),
                             self._sid(needle))
            return pred, _and(self._is_str(subject), self._is_str(needle),
                              N.Not(pred))
        if ast.name in _QTY_CMP and len(ast.args) == 1:
            lhs = self.value(ast.target, env)
            rhs = self.value(ast.args[0], env)
            if not isinstance(lhs, SQuantity) or not isinstance(
                    rhs, SQuantity):
                raise LowerError(f"{ast.name} on non-quantity")
            op, inv = _QTY_CMP[ast.name]
            ln, rn = self._num(lhs), self._num(rhs)
            return N.CmpNum(ln, op, rn), N.CmpNum(ln, inv, rn)
        raise LowerError(f"method {ast.name}")


def lower_cel_template(compiled, template_kind: str, vocab,
                       schema_hint: Optional[dict] = None) -> N.Program:
    """Lower a _CompiledCELTemplate (drivers/cel_driver.py) to a Program,
    or raise LowerError (→ interpreter fallback)."""
    if compiled.match_conditions:
        raise LowerError("matchConditions")
    if compiled.failure_policy != "Fail":
        raise LowerError(f"failurePolicy {compiled.failure_policy}")
    low = _CelLowerer(compiled.variables, vocab, schema_hint)
    violations = []
    for v in compiled.validations:
        t, _f = low.bool_pair(v.expression.ast, {})
        violations.append(N.Not(t))
    expr = violations[0] if len(violations) == 1 \
        else N.Or(tuple(violations))
    kinds = dict(low.param_kinds)
    for name in low.weak_params:
        kinds.setdefault(name, "str")
    params = tuple(
        N.ParamSpec(name=k, kind=v) for k, v in sorted(kinds.items())
    )
    return N.Program(
        template_kind=template_kind,
        expr=expr,
        params=params,
        schema=low.schema,
    )
