"""Partial evaluation: Rego AST → predicate IR (the vectorizable fragment).

This is the AddTemplate-time compile step of the TPU driver (the reference's
analog is template compilation at constrainttemplate_controller.go:479; here
compilation *lowers* instead of building an interpreter closure).

Supported fragment (everything else raises LowerError → interpreter fallback,
per SURVEY.md §7 "compile-or-fallback split"):
- violation clauses whose body is a conjunction of path predicates
- paths on input.review.object / input.review.* with trailing/nested ``[_]``
  iteration (each wildcard nesting flattens into one ragged Axis)
- user function/bool-rule inlining, multi-clause = OR (e.g. the PSP suite's
  input_share_hostnetwork / input_containers set-rule axes)
- comparisons and (in)equality against input.parameters.* and constants
- negation of lowerable predicates
- the required-labels set pattern:
      provided := {l | <labels-path>[l]}
      required := {l | l := input.parameters.X[_]}
      missing  := required - provided
      count(missing) > 0
  → AnyParamStrList(X, ¬KeySetContains(labels))
- assignments to variables only used for messages/details are skipped
  (messages render host-side from hits)

The lowered Program is *detection-only*: it must agree with the interpreter on
violated / not-violated for every (object, constraint) pair — enforced by the
differential tests in tests/test_lowering_differential.py.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Union

from gatekeeper_tpu_torch.ir import nodes as N
from gatekeeper_tpu_torch.ir.program import LowerError
from gatekeeper_tpu_torch.lang.rego import ast
from gatekeeper_tpu_torch.lang.rego.builtins import REGISTRY as _BUILTINS
from gatekeeper_tpu_torch.lang.rego.parser import WithWrapped
from gatekeeper_tpu_torch.ops.flatten import (
    Axis,
    KeySetCol,
    MapKeyCol,
    ParentIdxCol,
    RaggedCol,
    RaggedKeySetCol,
    ScalarCol,
    Schema,
)

OBJECT_ROOT = ("review", "object")  # input.review.object

# k8s-API scalar-typed leaf fields: feature-to-feature equality lowers only
# when BOTH sides end in one of these (N.FeatEqFeat is exact for scalars
# but treats composites as shallow-unequal, so arbitrary paths — e.g.
# metadata.labels vs oldObject's — keep the exact interpreter fallback)
_SCALAR_TYPED_LEAVES = frozenset({
    "serviceAccountName", "serviceAccount", "nodeName", "schedulerName",
    "priorityClassName", "runtimeClassName", "restartPolicy", "dnsPolicy",
    "storageClassName", "hostNetwork", "hostPID", "hostIPC", "image",
    "name", "namespace", "operation", "username", "uid", "apiVersion",
    "type", "path", "host",
})


def _scalar_typed_path(v) -> bool:
    if isinstance(v, PathVal):
        return bool(v.path) and v.path[-1] in _SCALAR_TYPED_LEAVES
    if isinstance(v, ItemVal):
        return bool(v.subpath) and v.subpath[-1] in _SCALAR_TYPED_LEAVES
    return False


# --- abstract values ------------------------------------------------------


@dataclass(frozen=True)
class PathVal:
    """A concrete path under input (no wildcards)."""

    path: tuple  # under input, e.g. ("review","object","spec","hostNetwork")


@dataclass(frozen=True)
class ItemVal:
    """An item of a ragged axis + a subpath under the item.

    ``instance`` identifies the existential: two separate ``[_]`` iterations
    over the same list are independent ∃-variables (Rego semantics), so their
    predicates must reduce under separate AnyAxis nodes; predicates sharing a
    bound variable share an instance and stay under one AnyAxis."""

    axis: Axis
    subpath: tuple
    instance: int = 0


@dataclass(frozen=True)
class ParamVal:
    name: str  # input.parameters.<name>


@dataclass(frozen=True)
class ParamElemVal:
    """Element of a list parameter; ``instance`` is the existential id."""

    name: str
    instance: int = 0


@dataclass(frozen=True)
class ParamElemFieldVal:
    """Field of an object-list parameter element: params.xs[_].key."""

    name: str
    field: tuple
    instance: int = 0


@dataclass(frozen=True)
class DefinedOpaqueVal:
    """Opaque value whose definedness has already been charged to the
    clause (e.g. msg := sprintf(...) — a total builtin over args whose
    Present-predicates were emitted at the assignment)."""

    why: str


# builtins total over defined arguments: defined for ANY defined args,
# regardless of type (lower/trim/count etc. are NOT — they are undefined on
# mistyped args, so marking them defined would fabricate violations)
_TOTAL_FNS = {"sprintf", "json.marshal"}


@dataclass(frozen=True)
class MapKeyVal:
    """The iteration key of a map-value axis (labels[key]): usable in string
    (in)equality and string predicates.  List-backed items carry an integer
    index as their key — present but non-string, so == against a string is
    defined-false and != defined-true, matching the interpreter."""

    axis: Any
    instance: int


@dataclass(frozen=True)
class DynFieldVal:
    """Dynamic field access: item[param_elem] (container[probe]).  Only
    presence/truthiness is expressible on device (via ragged key sets)."""

    item: "ItemVal"
    elem: Any  # ParamElemVal | ParamElemFieldVal


@dataclass(frozen=True)
class XformElemVal:
    """Static string transform of a param element: strips applied first
    (trim_prefix/trim_suffix, no-op when absent), then prefix + s + suffix
    (the concat(":", ["", tag]) idiom)."""

    inner: Any  # ParamElemVal | ParamElemFieldVal
    prefix: str = ""
    suffix: str = ""
    strip_prefix: str = ""
    strip_suffix: str = ""


@dataclass(frozen=True)
class StrFnVal:
    """units.parse / units.parse_bytes applied to an abstract value."""

    fn: str
    inner: Any


@dataclass(frozen=True)
class FeatListVal:
    """``[x | x = <feature>[_]...]`` — a feature-list comprehension (the
    key-batching idiom of external-data templates).  ``inner`` is the
    per-element feature (ItemVal for axis iterations, PathVal when the
    comprehension is degenerate)."""

    inner: Any  # PathVal | ItemVal


@dataclass(frozen=True)
class ExtDataRespVal:
    """``external_data({"provider": <const>, "keys": <keys>})`` — the
    response document.  ``key`` is the per-key subject feature (PathVal |
    ItemVal); ``from_list`` marks comprehension-batched keys (each use
    re-instances the axis existential) vs a literal one-key array whose
    bound instance the response inherits (per-binding semantics)."""

    provider: str
    key: Any
    from_list: bool = False


@dataclass(frozen=True)
class ExtDataListVal:
    """``resp.responses`` / ``resp.errors`` — only emptiness tests and
    iteration (responses) lower; exact counts diverge under the lane's
    key dedupe and stay on the interpreter."""

    resp: ExtDataRespVal
    field: str  # "responses" | "errors"


@dataclass(frozen=True)
class ExtDataItemVal:
    """One ``[key, value]`` pair iterated from ``resp.responses[_]``;
    ``key`` carries the (possibly re-instanced) subject feature whose
    existential group the pair's predicates share."""

    provider: str
    key: Any  # PathVal | ItemVal


@dataclass(frozen=True)
class ExtDataValueVal:
    """``item[1]`` of a responses pair: the provider's resolved value,
    sid-valued on device (ir/nodes.ExtDataValueSid) — definedness is the
    key's resolution, so predicates self-gate on the join."""

    provider: str
    key: Any  # PathVal | ItemVal


@dataclass(frozen=True)
class BoolComprVal:
    """[b | e := params.X[_]; b = pred(..., e)] — a per-param-element
    boolean vector; any()/all() reduce it."""

    param: str
    pred: Any  # N.Expr using _ElemListSid(param)
    axis_inst: Any  # (axis, instance) | None from the subject feature


@dataclass(frozen=True)
class ArithVal:
    """Arithmetic over numeric abstract values (plus/minus/mul/div).
    Rego arithmetic is partial: N.NumBin's validity gates every use."""

    op: str  # "add" | "sub" | "mul" | "div"
    a: "object"
    b: "object"


@dataclass(frozen=True)
class ConstVal:
    value: Any


@dataclass(frozen=True)
class KeySetVal:
    path: tuple  # under input; set of keys of map at path


@dataclass(frozen=True)
class ParamListSetVal:
    name: str
    field: tuple = ()  # nonempty: set of elem fields (params.xs[_].key)


@dataclass(frozen=True)
class SetDiffVal:
    required: "ParamListSetVal"
    provided: "KeySetVal"


@dataclass(frozen=True)
class InventoryObjVal:
    """An entry iterated from data.inventory.namespace[_][apiver][Kind][_]
    (referential policies).  Joins against it lower to host-built
    owner-count tables (N.InventoryUniqueJoin)."""

    kind: str
    instance: int
    apiver_var: str = ""  # named apiVersion var (regex-filterable)
    scope: str = "namespace"  # "namespace" | "cluster"
    # the ns slot was pinned to the review object's namespace
    # (data.inventory.namespace[namespace][...] with namespace :=
    # input.review.object.metadata.namespace): the join is same-ns
    ns_scoped: bool = False


@dataclass(frozen=True)
class InventoryFeatVal:
    """A (possibly wildcard-iterated) path under an inventory entry:
    other.spec.rules[_].host -> ("spec", "rules", "*", "host")."""

    inv: InventoryObjVal
    path: tuple


@dataclass(frozen=True)
class InventoryMetaVal:
    """A named variable bound by the inventory ref itself (ns / apiver /
    name slots) — only filterable (re_match) or message-renderable."""

    inv: InventoryObjVal
    slot: str  # "ns" | "apiver" | "name"


@dataclass(frozen=True)
class SelectorPairsVal:
    """``[s | v := M[key]; s := concat(":", [key, v])]`` over the map at
    ``base`` — the inner list of the flatten_selector idiom
    (gatekeeper-library uniqueserviceselector)."""

    base: object  # PathVal | InventoryFeatVal
    is_sorted: bool = False


@dataclass(frozen=True)
class SelectorCanonVal:
    """``concat(",", sort(pairs))`` — the canonical selector string.  An
    equality between a review-side and an inventory-side canon fuses to
    a selector-map join (N.InventoryUniqueJoin with transform
    "selector_canon")."""

    base: object  # PathVal | InventoryFeatVal


@dataclass(frozen=True)
class OpaqueVal:
    """Value we can't lower; poisonous only if used in a predicate."""

    why: str


class _InvFilterSignal(Exception):
    """re_match(const, <inventory apiVersion var>): an apiVersion filter
    applied at table build time."""

    def __init__(self, inv, regex):
        self.inv = inv
        self.regex = regex


class _InvJoinSignal(Exception):
    """Raised by _lower_cmp when one side is an inventory feature; the
    clause body loop catches it and records the join for fused emission at
    assembly."""

    def __init__(self, inv, feat_path, subject_val):
        self.inv = inv
        self.feat_path = feat_path
        self.subject_val = subject_val


@dataclass(frozen=True)
class IterBinding:
    """env marker: a named iteration variable (containers[i]) — reuses of
    the same variable over the same axis share one existential instance."""

    axis: Any
    instance: int


class _Lowerer:
    def __init__(self, modules, entry_pkg: tuple, schema_hint: Optional[dict],
                 vocab):
        self.modules = modules
        self.entry_mod = modules.by_pkg[entry_pkg]
        self.schema = Schema()
        self.param_kinds: dict[str, str] = {}
        self.schema_hint = (schema_hint or {}).get("properties", {})
        self.vocab = vocab
        self.depth = 0
        self._instances = 0
        self.param_fields: dict[str, dict] = {}
        # (child_axis, child_instance) -> (parent_axis, parent_instance):
        # recorded when iterating a bound item's sublist (c.ports[_]) so the
        # clause assembly can detect correlated parent/child existentials
        self._axis_parent: dict = {}
        self._value_fn_stack: set = set()  # value-fn inlining recursion guard

    def _fresh_instance(self) -> int:
        self._instances += 1
        return self._instances

    # --- public -----------------------------------------------------------
    def lower_violation(self) -> N.Expr:
        rule = self.entry_mod.rules.get("violation")
        if rule is None or rule.kind != "set":
            raise LowerError("no violation set rule")
        clause_exprs = []
        for clause in rule.clauses:
            if clause.els is not None:
                raise LowerError("else on violation clause")
            clause_exprs.append(self._lower_body(clause.body, {}))
        if not clause_exprs:
            raise LowerError("violation rule has no clauses")
        return N.Or(tuple(clause_exprs)) if len(clause_exprs) > 1 else clause_exprs[0]

    # --- body lowering ----------------------------------------------------
    def _lower_body(self, body, env: dict) -> N.Expr:
        terms, open_groups = self._lower_body_parts(body, env, None)
        assert not open_groups  # open_upto=None closes everything
        if not terms:
            raise LowerError("clause lowered to no predicates")
        return N.And(tuple(terms)) if len(terms) > 1 else terms[0]

    def _lower_body_parts(self, body, env: dict, open_upto):
        """Lower a conjunction.  Groups whose every existential instance was
        created at or before ``open_upto`` (caller bindings of an inlined
        function) are returned OPEN for the caller's assembly to merge;
        everything else closes here.  Returns (closed_terms, open_groups)."""
        env = dict(env)
        obj_preds: list[N.Expr] = []
        # group key: ("axis", Axis, inst) | ("param", name, inst)
        axis_preds: dict[tuple, list] = {}
        # inventory instance -> {"join": (path, subject), "exclude": bool}
        inv_records: dict[int, dict] = {}

        def add_pred(p: N.Expr, group):
            if group is None:
                obj_preds.append(p)
            else:
                axis_preds.setdefault(group, []).append(p)

        for stmt in body:
            if isinstance(stmt, WithWrapped):
                raise LowerError("with modifier")
            if isinstance(stmt, ast.SomeDecl):
                for n in stmt.names:
                    env.pop(n, None)
                continue
            if isinstance(stmt, ast.AssignStmt) or isinstance(stmt, ast.UnifyStmt):
                target = stmt.target if isinstance(stmt, ast.AssignStmt) else stmt.lhs
                term = stmt.term if isinstance(stmt, ast.AssignStmt) else stmt.rhs
                if not isinstance(target, ast.Var):
                    raise LowerError("destructuring assignment")
                bound = self._abstract(term, env)
                # an assignment in Rego fails when its RHS is undefined; even
                # message-only assignments gate the clause, so emit their
                # definedness predicates (e.g. msg := sprintf(..., [c.name])
                # requires c.name defined)
                for pred, axis_inst in self._definedness_preds(term, env):
                    add_pred(pred, axis_inst)
                if isinstance(bound, OpaqueVal) and isinstance(term, ast.Call):
                    if term.op in _TOTAL_FNS:
                        # total builtin: defined now that its args are charged
                        bound = DefinedOpaqueVal(bound.why)
                    elif term.op in _BUILTINS:
                        # a partial builtin (undefined on mistyped args)
                        # gates the clause in a way we can't express — even
                        # if the result is only used in the message head
                        raise LowerError(
                            f"assignment through partial builtin {term.op}")
                    # else: user-defined function — definedness charged via
                    # its args (library functions like get_message are total)
                env[target.name] = bound
                continue
            if isinstance(stmt, ast.ExprStmt):
                inv = self._inventory_exclusion(stmt, env)
                if inv is not None:
                    inv_records.setdefault(inv.instance,
                                           {})["exclude"] = True
                    continue
                try:
                    parts = self._lower_pred(stmt.term, env, stmt.negated)
                except _InvJoinSignal as sig:
                    if stmt.negated:
                        raise LowerError("negated inventory join")
                    rec = inv_records.setdefault(sig.inv.instance, {})
                    if "join" in rec:
                        raise LowerError("multiple inventory joins")
                    rec["join"] = (sig.inv, sig.feat_path, sig.subject_val)
                    continue
                except _InvFilterSignal as sig:
                    if stmt.negated:
                        raise LowerError("negated inventory filter")
                    rec = inv_records.setdefault(sig.inv.instance, {})
                    if "apiver_regex" in rec:
                        raise LowerError("multiple apiVersion filters")
                    rec["apiver_regex"] = sig.regex
                    continue
                for pred, axis in parts:
                    add_pred(pred, axis)
                continue
            if isinstance(stmt, ast.SomeIn):
                raise LowerError("some..in")
            raise LowerError(f"statement {type(stmt).__name__}")

        # fused referential joins: each inventory entry iterated by this
        # clause must have produced exactly one join equality (plus an
        # optional identical() self-exclusion) — emit the table-lookup node
        # under the join subject's group
        for rec in inv_records.values():
            if "join" not in rec:
                raise LowerError("inventory entry without a join predicate")
            inv, feat_path, subject = rec["join"]
            transform = ""
            group = None
            if isinstance(subject, SelectorCanonVal):
                # selector-map join: subject is the review object's
                # canonical selector column; the table side canonicalizes
                # the same way (ns-qualified when the ref pinned the ns
                # slot to the review namespace)
                from gatekeeper_tpu_torch.ops.flatten import CanonCol

                base = subject.base
                if base.path[:2] != OBJECT_ROOT:
                    raise LowerError("selector canon outside review object")
                cc = CanonCol(path=base.path[2:], ns_scoped=inv.ns_scoped)
                if cc not in self.schema.canons:
                    self.schema.canons.append(cc)
                subj = N.CanonFeatSid(cc)
                transform = "selector_canon"
            else:
                subj = self._sid_operand(subject)
                if isinstance(subject, (ItemVal, MapKeyVal)):
                    group = ("axis", subject.axis, subject.instance)
            ns_col = self._scalar_col(
                PathVal(OBJECT_ROOT + ("metadata", "namespace")))
            name_col = self._scalar_col(
                PathVal(OBJECT_ROOT + ("metadata", "name")))
            spec = N.InvTableSpec(inv.kind, feat_path,
                                  rec.get("apiver_regex", ""),
                                  scope=inv.scope, transform=transform,
                                  ns_scoped=inv.ns_scoped)
            add_pred(
                N.InventoryUniqueJoin(spec, subj, ns_col, name_col,
                                      exclude_self=rec.get("exclude",
                                                           False)),
                group)

        open_groups: dict = {}

        # (A) callee pre-pass: a dual on a FRESH child axis with a CALLER
        # param element closes the child per-parent (absorbing plain preds
        # on the same child instance), re-keying as (parent, param) — which
        # the partition below returns open for the caller to merge
        if open_upto is not None:
            for group in [g for g in list(axis_preds) if g[0] == "dual"]:
                agroup, pgroup = group[1], group[2]
                if agroup[2] > open_upto and pgroup[2] <= open_upto:
                    parent = self._axis_parent.get((agroup[1], agroup[2]))
                    if parent is None or parent[1] > open_upto:
                        raise LowerError(
                            "existential spans inlined call boundary")
                    preds = axis_preds.pop(group)
                    plain = axis_preds.pop(
                        ("axis", agroup[1], agroup[2]), None)
                    if plain:
                        preds = list(preds) + list(plain)
                    node = self._nested_any(agroup[1], parent[0], preds)
                    axis_preds.setdefault(
                        ("dual", ("axis",) + parent, pgroup),
                        []).append(node)

        # (B) partition duals: both components caller-created → open whole
        if open_upto is not None:
            for group in [g for g in list(axis_preds) if g[0] == "dual"]:
                agroup, pgroup = group[1], group[2]
                a_out = agroup[2] <= open_upto
                p_out = pgroup[2] <= open_upto
                if a_out and p_out:
                    open_groups[group] = axis_preds.pop(group)
                elif p_out and not a_out:
                    raise LowerError(
                        "existential spans inlined call boundary")

        # (C) dual-group predicates reduce their param axis first, then
        # join the axis-level predicates of their shared axis instance.  A
        # param instance is ONE existential: plain predicates on the same
        # instance (probe == "x") must reduce inside the SAME AnyParamList
        # as the dual predicates (c[probe]) — and an instance shared by two
        # dual groups cannot be split at all.
        dual_groups = [g for g in axis_preds if g[0] == "dual"]
        pgroup_uses: dict = {}
        for group in dual_groups:
            pgroup_uses.setdefault(group[2], []).append(group)
        for pgroup, users in pgroup_uses.items():
            if len(users) > 1:
                raise LowerError(
                    "param element shared across multiple axis existentials"
                )
        for group in dual_groups:
            _d, agroup, pgroup = group
            preds = axis_preds.pop(group)
            # absorb plain predicates bound to the same param instance
            plain = axis_preds.pop(pgroup, None)
            if plain:
                preds = list(preds) + list(plain)
            inner = N.And(tuple(preds)) if len(preds) > 1 else preds[0]
            axis_preds.setdefault(agroup, []).append(
                N.AnyParamList(pgroup[1], inner))

        # (D) close child axes into per-parent NestedAny reductions WHERE
        # correlation demands it: the parent instance carries its own
        # predicates, two child groups share one parent binding, or the
        # parent is caller-bound (its predicates live across the call
        # boundary).  Otherwise the flat pair axis is equivalent (∃pair ≡
        # ∃parent ∃child) and cheaper.  Caller-bound child instances are
        # never closed here — they return open below.
        changed = True
        while changed:
            changed = False
            by_parent: dict = {}
            for g in axis_preds:
                if g[0] != "axis":
                    continue
                pa = self._axis_parent.get((g[1], g[2]))
                if pa is not None:
                    by_parent.setdefault(pa, []).append(g)
            for group in list(axis_preds):
                if group[0] != "axis":
                    continue
                if open_upto is not None and group[2] <= open_upto:
                    continue  # caller's binding: returned open
                parent = self._axis_parent.get((group[1], group[2]))
                if parent is None:
                    continue
                pkey = ("axis",) + parent
                need = (pkey in axis_preds
                        or len(by_parent.get(parent, [])) > 1
                        or (open_upto is not None
                            and parent[1] <= open_upto))
                if not need:
                    continue
                preds = axis_preds.pop(group)
                node = self._nested_any(group[1], parent[0], preds)
                axis_preds.setdefault(pkey, []).append(node)
                changed = True
                break

        # (E) plain groups on caller-created instances return open
        if open_upto is not None:
            for group in list(axis_preds):
                if group[2] <= open_upto:
                    open_groups[group] = axis_preds.pop(group)
        terms = list(obj_preds)
        for group, preds in axis_preds.items():
            inner = N.And(tuple(preds)) if len(preds) > 1 else preds[0]
            if group[0] == "axis":
                terms.append(N.AnyAxis(group[1], inner))
            else:  # param-element existential
                terms.append(N.AnyParamList(group[1], inner))
        if not terms and not open_groups:
            raise LowerError("clause lowered to no predicates")
        return terms, open_groups

    def _definedness_preds(self, term, env: dict) -> list:
        """Present-predicates implied by evaluating ``term`` (undefined refs
        make a Rego statement fail).  Raises LowerError for terms whose
        definedness we can't express."""
        if isinstance(term, ast.Scalar):
            return []
        if isinstance(term, (ast.SetCompr, ast.ArrayCompr, ast.ObjectCompr)):
            return []  # comprehensions are total (empty on no solutions)
        if isinstance(term, (ast.Var, ast.Ref)):
            if (isinstance(term, ast.Ref)
                    and isinstance(term.head, ast.Var)
                    and term.head.name == "data"
                    and term.head.name not in env):
                # inventory refs carry their definedness inside the fused
                # join (∃ entry); re-abstracting here would double-bind the
                # ref's named slot vars
                return []
            val = self._abstract(term, env)
            return self._definedness_of_val(val)
        if isinstance(term, ast.ArrayTerm):
            out = []
            for it in term.items:
                out.extend(self._definedness_preds(it, env))
            return out
        if isinstance(term, ast.ObjectTerm):
            out = []
            for k, v in term.pairs:
                out.extend(self._definedness_preds(k, env))
                out.extend(self._definedness_preds(v, env))
            return out
        if isinstance(term, ast.Call):
            if term.op in ("minus", "plus", "mul", "div") and \
                    len(term.args) == 2:
                val = self._abstract(term, env)
                if isinstance(val, ArithVal):
                    return self._definedness_of_val(val)
            out = []
            for a in term.args:
                out.extend(self._definedness_preds(a, env))
            return out
        raise LowerError(f"definedness of {type(term).__name__}")

    def _definedness_of_val(self, val) -> list:
        if isinstance(val, PathVal):
            if val.path[:2] != OBJECT_ROOT:
                return []  # input/review roots always defined
            return [(N.Present(self._scalar_col(val)), None)]
        if isinstance(val, ItemVal):
            return [(N.Present(self._ragged_col(val)),
                     ("axis", val.axis, val.instance))]
        if isinstance(val, ParamVal):
            self._note_param(val.name, "bool")
            return [(N.ParamPresent(val.name), None)]
        if isinstance(val, (ConstVal, KeySetVal, ParamListSetVal, SetDiffVal)):
            return []
        if isinstance(val, ArithVal):
            group = self._arith_group(val)
            return [(N.NumDefined(self._num_operand(val)), group)]
        if isinstance(val, DynFieldVal):
            # a false-valued key is DEFINED but outside the truthy keyset, so
            # keyset-contains cannot express definedness — fall back
            raise LowerError("definedness of dynamic field access")
        if isinstance(val, DefinedOpaqueVal):
            return []  # charged at its assignment
        if isinstance(val, (ExtDataRespVal, ExtDataListVal, FeatListVal)):
            return []  # total: the builtin answers (errors included) and
            # comprehensions are empty-on-no-solutions
        if isinstance(val, ExtDataItemVal):
            # a responses pair exists iff its key resolved ok
            _key, group = (val.key, None) if isinstance(val.key, PathVal) \
                else (val.key, ("axis", val.key.axis, val.key.instance))
            return [(N.ExtDataOk(val.provider,
                                 self._extdata_subject(val.key)), group)]
        if isinstance(val, ExtDataValueVal):
            group = None if isinstance(val.key, PathVal) else (
                "axis", val.key.axis, val.key.instance)
            return [(N.ExtDataOk(val.provider,
                                 self._extdata_subject(val.key)), group)]
        if isinstance(val, OpaqueVal):
            raise LowerError(f"definedness of opaque value: {val.why}")
        return []

    # --- abstract evaluation of terms --------------------------------------
    def _abstract(self, term, env: dict):
        if isinstance(term, ast.Scalar):
            return ConstVal(term.value)
        if isinstance(term, ast.Var):
            if term.name in env:
                v = env[term.name]
                if isinstance(v, IterBinding):
                    if isinstance(v.axis, Axis):
                        # the iteration KEY of a (possibly-map) axis
                        return MapKeyVal(v.axis, v.instance)
                    return OpaqueVal(f"iteration key {term.name} as value")
                return v
            if term.name == "input":
                return PathVal(())
            rule = self.entry_mod.rules.get(term.name)
            if rule is not None and rule.kind == "complete" and (
                len(rule.clauses) == 1
                and not rule.clauses[0].body
                and rule.clauses[0].value is not None
            ):
                # zero-arg value rule: object_name = input.review...name
                return self._abstract(rule.clauses[0].value, {})
            return OpaqueVal(f"unbound var {term.name}")
        if isinstance(term, ast.Ref):
            return self._abstract_ref(term, env)
        if isinstance(term, ast.SetCompr):
            return self._abstract_set_compr(term, env)
        if isinstance(term, ast.Call):
            if term.op in ("minus", "plus", "mul", "div") and \
                    len(term.args) == 2:
                a = self._abstract(term.args[0], env)
                b = self._abstract(term.args[1], env)
                if isinstance(a, ParamListSetVal) and \
                        isinstance(b, KeySetVal):
                    # set difference is minus-only; +/*// on sets is a
                    # Rego type error (undefined) we can't express
                    if term.op == "minus":
                        return SetDiffVal(a, b)
                    return OpaqueVal(f"{term.op} on sets")
                numeric = (PathVal, ItemVal, ParamVal, ConstVal, StrFnVal,
                           ArithVal, ParamElemFieldVal)
                if isinstance(a, numeric) and isinstance(b, numeric):
                    op = {"minus": "sub", "plus": "add", "mul": "mul",
                          "div": "div"}[term.op]
                    return ArithVal(op, a, b)
                return OpaqueVal(f"{term.op} of non-numeric pattern")
            if term.op in ("units.parse", "units.parse_bytes") and (
                len(term.args) == 1
            ):
                return StrFnVal(term.op, self._abstract(term.args[0], env))
            if term.op == "concat" and len(term.args) == 2 and isinstance(
                term.args[1], ast.ArrayTerm
            ):
                return self._abstract_concat(term, env)
            if term.op == "concat" and len(term.args) == 2:
                sep = self._abstract(term.args[0], env)
                inner = self._abstract(term.args[1], env)
                if isinstance(inner, SelectorPairsVal) \
                        and inner.is_sorted \
                        and isinstance(sep, ConstVal) \
                        and sep.value == ",":
                    # the outer join of the flatten_selector idiom; the
                    # ','/':' separators are the canonical encoding
                    # ops.flatten.selector_canon reproduces
                    return SelectorCanonVal(inner.base)
                return OpaqueVal("concat over non-array")
            if term.op == "sort" and len(term.args) == 1:
                inner = self._abstract(term.args[0], env)
                if isinstance(inner, SelectorPairsVal):
                    return SelectorPairsVal(inner.base, is_sorted=True)
                return OpaqueVal("sort")
            if term.op in ("trim_prefix", "trim_suffix") and (
                len(term.args) == 2
            ):
                inner = self._abstract(term.args[0], env)
                affix = self._abstract(term.args[1], env)
                if isinstance(inner, (ParamElemVal, ParamElemFieldVal)) \
                        and isinstance(affix, ConstVal) \
                        and isinstance(affix.value, str):
                    if term.op == "trim_prefix":
                        return XformElemVal(inner,
                                            strip_prefix=affix.value)
                    return XformElemVal(inner, strip_suffix=affix.value)
                return OpaqueVal(f"call {term.op}")
            if term.op == "external_data" and len(term.args) == 1:
                return self._abstract_external_data(term.args[0], env)
            fn_rule = self.entry_mod.rules.get(term.op)
            if fn_rule is not None:
                out = self._abstract_value_fn(fn_rule, term, env)
                if out is not None:
                    return out
            return OpaqueVal(f"call {term.op}")
        if isinstance(term, ast.ArrayCompr):
            sel = self._abstract_selector_compr(term, env)
            if sel is not None:
                return sel
            feat = self._abstract_feat_compr(term, env)
            if feat is not None:
                return feat
            return self._abstract_bool_compr(term, env)
        return OpaqueVal(type(term).__name__)

    def _abstract_feat_compr(self, term: ast.ArrayCompr, env: dict):
        """``[x | x = <feature>]`` — the key-batching comprehension of
        external-data templates (one stmt, head var == target, value a
        lowerable feature).  Returns FeatListVal or None."""
        if not (isinstance(term.term, ast.Var) and len(term.body) == 1):
            return None
        stmt = term.body[0]
        if isinstance(stmt, ast.AssignStmt) and isinstance(
                stmt.target, ast.Var):
            tgt, val_t = stmt.target.name, stmt.term
        elif isinstance(stmt, ast.UnifyStmt) and isinstance(
                stmt.lhs, ast.Var):
            tgt, val_t = stmt.lhs.name, stmt.rhs
        else:
            return None
        if tgt != term.term.name:
            return None
        inner = self._abstract(val_t, dict(env))
        if isinstance(inner, (PathVal, ItemVal)):
            return FeatListVal(inner)
        return None

    def _abstract_external_data(self, arg, env: dict):
        """``external_data({"provider": <const str>, "keys": ...})`` —
        keys: a feature-list comprehension (or a var bound to one) or a
        literal one-element array of a feature.  Anything else is
        opaque: the template keeps the interpreter (which resolves
        through the same lane, per-key)."""
        if not isinstance(arg, ast.ObjectTerm):
            return OpaqueVal("external_data arg not an object literal")
        provider = keys_t = None
        for k, v in arg.pairs:
            if isinstance(k, ast.Scalar) and k.value == "provider":
                provider = self._abstract(v, env)
            elif isinstance(k, ast.Scalar) and k.value == "keys":
                keys_t = v
            else:
                return OpaqueVal("external_data arg shape")
        if not (isinstance(provider, ConstVal)
                and isinstance(provider.value, str)) or keys_t is None:
            return OpaqueVal("external_data provider/keys shape")
        keys = self._abstract(keys_t, env)
        if isinstance(keys, FeatListVal):
            return ExtDataRespVal(provider.value, keys.inner,
                                  from_list=True)
        if isinstance(keys_t, ast.ArrayTerm) and len(keys_t.items) == 1:
            inner = self._abstract(keys_t.items[0], env)
            if isinstance(inner, (PathVal, ItemVal)):
                return ExtDataRespVal(provider.value, inner,
                                      from_list=False)
        return OpaqueVal("external_data keys shape")

    # --- external-data join pieces (used by steps/counts below) ----------
    def _extdata_subject(self, key) -> "N.Expr":
        """The sid-valued subject feature of a join key (registers the
        column in the program schema)."""
        if isinstance(key, PathVal):
            return N.FeatSid(self._scalar_col(key))
        return N.FeatSid(self._ragged_col(key))

    def _extdata_reinstance(self, resp: ExtDataRespVal):
        """(key, group) for one USE of the response: comprehension-
        batched keys re-instance the axis existential per use (each
        ``responses[_]``/count is its own ∃ over the key axis); a
        literal one-key array inherits the key's bound instance
        (per-binding response semantics); scalar keys have no group."""
        key = resp.key
        if isinstance(key, PathVal):
            return key, None
        if not resp.from_list:
            return key, ("axis", key.axis, key.instance)
        inst = self._fresh_instance()
        pa = self._axis_parent.get((key.axis, key.instance))
        if pa is not None:
            self._axis_parent[(key.axis, inst)] = pa
        newk = ItemVal(key.axis, key.subpath, inst)
        return newk, ("axis", key.axis, inst)

    def _extdata_item_pred(self, provider: str, key, want_ok: bool):
        """Per-key membership predicate: ``responses`` = the key resolved
        (ok implies present-and-string), ``errors`` = the key is present
        but did NOT resolve ok (non-string present keys are per-key
        errors host-side too)."""
        subj = self._extdata_subject(key)
        ok = N.ExtDataOk(provider, subj)
        if want_ok:
            return ok
        col = (self._scalar_col(key) if isinstance(key, PathVal)
               else self._ragged_col(key))
        return N.And((N.Present(col), N.Not(ok)))

    def _abstract_selector_compr(self, term: ast.ArrayCompr, env: dict):
        """Recognize ``[s | v := M[key]; s := concat(":", [key, v])]`` —
        the per-pair list of the flatten_selector idiom — where ``M``
        steps from a bound map location (review object or inventory
        entry).  Returns SelectorPairsVal or None."""
        if not (isinstance(term.term, ast.Var) and len(term.body) == 2):
            return None
        s_name = term.term.name
        st1, st2 = term.body

        def assign_parts(st):
            if isinstance(st, ast.AssignStmt) and isinstance(
                    st.target, ast.Var):
                return st.target.name, st.term
            if isinstance(st, ast.UnifyStmt) and isinstance(
                    st.lhs, ast.Var):
                return st.lhs.name, st.rhs
            return None, None

        v_name, ref = assign_parts(st1)
        s2_name, cat = assign_parts(st2)
        if v_name is None or s2_name != s_name:
            return None
        if not (isinstance(ref, ast.Ref) and isinstance(ref.head, ast.Var)
                and ref.args):
            return None
        *subpath, last = ref.args
        if not (isinstance(last, ast.Var) and last.name not in env):
            return None
        key_name = last.name
        if not all(isinstance(p, ast.Scalar) and isinstance(p.value, str)
                   for p in subpath):
            return None
        base = env.get(ref.head.name)
        if isinstance(base, PathVal):
            base = PathVal(base.path + tuple(p.value for p in subpath))
        elif isinstance(base, InventoryFeatVal):
            base = InventoryFeatVal(
                base.inv, base.path + tuple(p.value for p in subpath))
        elif isinstance(base, InventoryObjVal):
            base = InventoryFeatVal(
                base, tuple(p.value for p in subpath))
        else:
            return None
        # s := concat(":", [key, v])
        if not (isinstance(cat, ast.Call) and cat.op == "concat"
                and len(cat.args) == 2
                and isinstance(cat.args[0], ast.Scalar)
                and cat.args[0].value == ":"
                and isinstance(cat.args[1], ast.ArrayTerm)
                and len(cat.args[1].items) == 2):
            return None
        i1, i2 = cat.args[1].items
        if not (isinstance(i1, ast.Var) and i1.name == key_name
                and isinstance(i2, ast.Var) and i2.name == v_name):
            return None
        return SelectorPairsVal(base)

    def _abstract_value_fn(self, rule, term: ast.Call, env: dict):
        """Targeted inlining of a VALUE-returning helper function (the
        flatten_selector shape): one clause, all-Var params, a body of
        pure assignments, a head value term.  Returns the abstract value
        of the head under the inlined bindings, or None when the shape
        doesn't fit (the caller falls through to Opaque)."""
        if len(rule.clauses) != 1:
            return None
        clause = rule.clauses[0]
        params = clause.args or ()
        if clause.value is None or len(params) != len(term.args) \
                or not all(isinstance(p, ast.Var) for p in params):
            return None
        if any(not isinstance(st, (ast.AssignStmt, ast.UnifyStmt))
               for st in clause.body):
            return None
        if term.op in self._value_fn_stack:
            return None  # recursion guard
        self._value_fn_stack.add(term.op)
        try:
            fenv = {p.name: self._abstract(a, env)
                    for p, a in zip(params, term.args)}
            for st in clause.body:
                if isinstance(st, ast.AssignStmt):
                    tgt, val_t = st.target, st.term
                else:
                    tgt, val_t = st.lhs, st.rhs
                if not isinstance(tgt, ast.Var):
                    return None
                fenv[tgt.name] = self._abstract(val_t, fenv)
            out = self._abstract(clause.value, fenv)
        finally:
            self._value_fn_stack.discard(term.op)
        if isinstance(out, OpaqueVal):
            return None
        return out

    def _abstract_concat(self, term: ast.Call, env: dict):
        sep = self._abstract(term.args[0], env)
        if not (isinstance(sep, ConstVal) and isinstance(sep.value, str)):
            return OpaqueVal("concat with non-constant separator")
        parts = [self._abstract(it, env) for it in term.args[1].items]
        elem_idx = None
        for i, pv in enumerate(parts):
            if isinstance(pv, (ParamElemVal, ParamElemFieldVal)):
                if elem_idx is not None:
                    return OpaqueVal("concat with multiple elements")
                elem_idx = i
            elif not (isinstance(pv, ConstVal)
                      and isinstance(pv.value, str)):
                return OpaqueVal("concat with non-constant part")
        if elem_idx is None:
            return ConstVal(sep.value.join(p.value for p in parts))
        prefix = sep.value.join(
            [p.value for p in parts[:elem_idx]] + [""]
        ) if elem_idx > 0 else ""
        suffix = (sep.value + sep.value.join(
            p.value for p in parts[elem_idx + 1:]
        )) if elem_idx < len(parts) - 1 else ""
        # join semantics: elements are glued with sep on both sides
        if elem_idx > 0 and not prefix.endswith(sep.value):
            prefix += sep.value
        return XformElemVal(parts[elem_idx], prefix, suffix)

    def _abstract_bool_compr(self, term: ast.ArrayCompr, env: dict):
        """[b | e = params.X[_]; b = pred(feat, e)] — the allowed-repos
        idiom; reduces with any()/all()."""
        if not isinstance(term.term, ast.Var):
            return OpaqueVal("array comprehension head")
        head = term.term.name
        if len(term.body) != 2:
            return OpaqueVal("array comprehension body")
        s1, s2 = term.body
        def _assign_parts(stmt):
            if isinstance(stmt, ast.AssignStmt):
                return stmt.target, stmt.term
            if isinstance(stmt, ast.UnifyStmt) and isinstance(stmt.lhs,
                                                             ast.Var):
                return stmt.lhs, stmt.rhs
            return None, None
        t1, e1 = _assign_parts(s1)
        t2, e2 = _assign_parts(s2)
        if (t1 is None or t2 is None or not isinstance(t1, ast.Var)
                or not isinstance(t2, ast.Var) or t2.name != head):
            return OpaqueVal("array comprehension shape")
        cenv = dict(env)
        elem = self._abstract(e1, cenv)
        if not isinstance(elem, ParamElemVal):
            return OpaqueVal("comprehension source not a param list")
        cenv[t1.name] = elem
        if not isinstance(e2, ast.Call):
            return OpaqueVal("comprehension predicate not a call")
        if e2.op in ("equal", "neq") and len(e2.args) == 2:
            # equality comprehension: ok = (feat == elem) — reuse the full
            # rank-aware comparison lowering; its group tells us which
            # existentials the predicate spans
            try:
                pred, group = self._lower_cmp(e2.op, e2.args, cenv)
            except LowerError as err:
                return OpaqueVal(str(err))
            return self._compr_from_group(elem, pred, group)
        if e2.op not in self._STR_PREDS or len(e2.args) != 2:
            return OpaqueVal("comprehension predicate not a string pred")
        table_op, si, ni = self._STR_PREDS[e2.op]
        subject = self._abstract(e2.args[si], cenv)
        needle = self._abstract(e2.args[ni], cenv)
        try:
            pred, sgroup, pgroup = self._lower_str_pred_raw(
                table_op, subject, needle)
        except LowerError as err:
            return OpaqueVal(str(err))
        if pgroup is not None and pgroup[1] != elem.name:
            return OpaqueVal("comprehension over foreign existential")
        if not isinstance(needle, ParamElemFieldVal) and not (
            isinstance(needle, XformElemVal)
            and isinstance(needle.inner, ParamElemFieldVal)
        ):
            # objlist elems (allowed.pathPrefix) register via the field
            # access; a bare strlist note would conflict
            self._note_param(elem.name, "strlist")
        return BoolComprVal(elem.name, pred, sgroup)

    def _compr_from_group(self, elem, pred, group):
        """Map a lowered predicate's group onto BoolComprVal's
        (param, axis_inst) shape; reject foreign existentials."""
        if group is None:
            return BoolComprVal(elem.name, pred, None)
        if group[0] == "param":
            if group[1] != elem.name or group[2] != elem.instance:
                return OpaqueVal("comprehension over foreign existential")
            return BoolComprVal(elem.name, pred, None)
        if group[0] == "dual":
            _d, agroup, pgroup = group
            if pgroup[1] != elem.name or pgroup[2] != elem.instance:
                return OpaqueVal("comprehension over foreign existential")
            return BoolComprVal(elem.name, pred, agroup)
        # a plain axis group means the elem never constrained the predicate
        return OpaqueVal("comprehension predicate ignores the element")

    def _abstract_ref(self, term: ast.Ref, env: dict):
        if (isinstance(term.head, ast.Var) and term.head.name == "data"
                and term.head.name not in env):
            return self._abstract_inventory_ref(term, env)
        base = self._abstract(term.head, env)
        for arg in term.args:
            if isinstance(arg, ast.Scalar) and isinstance(arg.value, str):
                base = self._step(base, arg.value)
            elif (isinstance(arg, ast.Scalar)
                  and isinstance(arg.value, int)
                  and not isinstance(arg.value, bool)
                  and isinstance(base, ExtDataItemVal)):
                # a responses pair: [0] = the key (only message-renderable
                # — predicates on it would need an ok-gated key sid),
                # [1] = the resolved value (sid-valued, self-gating)
                if arg.value == 1:
                    base = ExtDataValueVal(base.provider, base.key)
                else:
                    base = OpaqueVal("external_data response key slot")
            elif isinstance(arg, ast.Var) and arg.name.startswith("$w"):
                base = self._iterate(base)  # wildcard: fresh existential
            elif isinstance(arg, ast.Var) and isinstance(
                env.get(arg.name), IterBinding
            ):
                # reuse of a named iteration variable: same instance, same
                # collection (containers[i].a; containers[i].b share one ∃i)
                binding = env[arg.name]
                base = self._iterate(base)
                if isinstance(base, ItemVal):
                    if binding.axis != base.axis:
                        return OpaqueVal(
                            f"var {arg.name} indexes two collections"
                        )
                    base = ItemVal(base.axis, base.subpath, binding.instance)
                elif isinstance(base, ParamElemVal):
                    if binding.axis != ("param", base.name):
                        return OpaqueVal(
                            f"var {arg.name} indexes two collections"
                        )
                    base = ParamElemVal(base.name, binding.instance)
                else:
                    return OpaqueVal(f"correlated index var {arg.name}")
            elif isinstance(arg, ast.Var) and arg.name not in env:
                # first use of a named var: iterate and bind the instance
                base = self._iterate(base)
                if isinstance(base, ItemVal):
                    env[arg.name] = IterBinding(base.axis, base.instance)
                elif isinstance(base, ParamElemVal):
                    env[arg.name] = IterBinding(("param", base.name),
                                                base.instance)
                else:
                    return OpaqueVal(f"correlated index var {arg.name}")
            elif isinstance(arg, ast.Var) and isinstance(
                env.get(arg.name), (ParamElemVal, ParamElemFieldVal)
            ) and isinstance(base, ItemVal):
                # dynamic field access by a parameter element:
                # container[probe] — presence-only on device
                base = DynFieldVal(base, env[arg.name])
            else:
                return OpaqueVal("computed ref index")
            if isinstance(base, OpaqueVal):
                return base
        return base

    def _abstract_inventory_ref(self, term: ast.Ref, env: dict):
        args = term.args
        if (len(args) < 5 or not isinstance(args[0], ast.Scalar)
                or args[0].value != "inventory"
                or not isinstance(args[1], ast.Scalar)
                or args[1].value not in ("namespace", "cluster")):
            return OpaqueVal("unbound var data")
        scope = args[1].value
        if scope == "namespace":
            # data.inventory.namespace[ns][apiver][Kind][name]
            if len(args) < 6:
                return OpaqueVal("short inventory ref")
            ns_a, av_a, kind_a, name_a = args[2:6]
            tail = args[6:]
        else:
            # data.inventory.cluster[apiver][Kind][name]
            ns_a = None
            av_a, kind_a, name_a = args[2:5]
            tail = args[5:]
        if not (isinstance(kind_a, ast.Scalar)
                and isinstance(kind_a.value, str)):
            return OpaqueVal("inventory ref without a literal kind")

        def slot_var(a):
            if isinstance(a, ast.Var):
                return a.name
            return None

        slots = [a for a in (ns_a, av_a, name_a) if a is not None]
        for a in slots:
            if slot_var(a) is None:
                return OpaqueVal("inventory ref with non-var slot")
        # a PRE-BOUND ns slot pinned to the review object's namespace is
        # the same-namespace join idiom (uniqueserviceselector):
        # namespace := input.review.object.metadata.namespace;
        # other := data.inventory.namespace[namespace][...]
        ns_scoped = False
        if ns_a is not None and ns_a.name in env:
            bound = env[ns_a.name]
            if isinstance(bound, PathVal) and bound.path == OBJECT_ROOT + (
                    "metadata", "namespace"):
                ns_scoped = True
            else:
                return OpaqueVal("inventory slot var already bound")
        inv = InventoryObjVal(kind_a.value, self._fresh_instance(),
                              apiver_var=(""
                                          if av_a.name.startswith("$w")
                                          else av_a.name),
                              scope=scope, ns_scoped=ns_scoped)
        for a, slot in ((ns_a, "ns"), (av_a, "apiver"), (name_a, "name")):
            if a is not None and not a.name.startswith("$w"):
                if a.name in env:
                    if slot == "ns" and ns_scoped:
                        continue  # stays bound to the review-object path
                    return OpaqueVal("inventory slot var already bound")
                env[a.name] = InventoryMetaVal(inv, slot)
        base = InventoryFeatVal(inv, ())
        for arg in tail:
            if isinstance(arg, ast.Scalar) and isinstance(arg.value, str):
                base = InventoryFeatVal(inv, base.path + (arg.value,))
            elif isinstance(arg, ast.Var) and arg.name.startswith("$w"):
                base = InventoryFeatVal(inv, base.path + ("*",))
            else:
                return OpaqueVal("inventory ref index")
        return base if base.path else inv

    def _step(self, base, key: str):
        if isinstance(base, PathVal):
            if base.path == ("parameters",):
                return ParamVal(key)
            return PathVal(base.path + (key,))
        if isinstance(base, ItemVal):
            return ItemVal(base.axis, base.subpath + (key,), base.instance)
        if isinstance(base, ParamElemVal):
            return ParamElemFieldVal(base.name, (key,), base.instance)
        if isinstance(base, InventoryObjVal):
            return InventoryFeatVal(base, (key,))
        if isinstance(base, InventoryFeatVal):
            return InventoryFeatVal(base.inv, base.path + (key,))
        if isinstance(base, ParamElemFieldVal):
            return ParamElemFieldVal(base.name, base.field + (key,),
                                     base.instance)
        if isinstance(base, ParamVal):
            # nested object params (input.parameters.runAsUser.rule)
            # lower to dotted ParamSpec names; p_get/p_has resolve the
            # path at table-build time (PSP users/fsgroup shapes)
            return ParamVal(f"{base.name}.{key}")
        if isinstance(base, ExtDataRespVal):
            if key in ("responses", "errors"):
                return ExtDataListVal(base, key)
            if key == "system_error":
                # transport failures fold into PER-KEY errors (the
                # ProviderCache stale/error semantics the host builtin
                # mirrors), so system_error is the constant ""
                return ConstVal("")
            if key == "status_code":
                return ConstVal(200)
            return OpaqueVal(f"external_data response field {key}")
        if isinstance(base, OpaqueVal):
            return base
        return OpaqueVal(f"step on {type(base).__name__}")

    def _iterate(self, base):
        """A `[_]` step: iterate a list → ragged axis."""
        if isinstance(base, PathVal):
            if len(base.path) < 2 or base.path[:2] != OBJECT_ROOT:
                return OpaqueVal("iteration outside review object")
            rel = base.path[2:]
            return ItemVal(Axis(((rel,),)), (), self._fresh_instance())
        if isinstance(base, ItemVal):
            # nested list: extend every segment with the subpath as a part
            segs = tuple(seg + (base.subpath,) for seg in base.axis.segments)
            child = ItemVal(Axis(segs), (), self._fresh_instance())
            self._axis_parent[(child.axis, child.instance)] = (
                base.axis, base.instance)
            return child
        if isinstance(base, ParamVal):
            return ParamElemVal(base.name, self._fresh_instance())
        if isinstance(base, InventoryFeatVal):
            # iteration within an inventory entry: the host-side table
            # build flattens it ('*' path step)
            return InventoryFeatVal(base.inv, base.path + ("*",))
        if isinstance(base, ExtDataListVal):
            if base.field != "responses":
                # per-error pairs carry host-rendered error strings; only
                # emptiness (count) lowers for the errors list
                return OpaqueVal("iterate external_data errors")
            key, _group = self._extdata_reinstance(base.resp)
            return ExtDataItemVal(base.resp.provider, key)
        if isinstance(base, OpaqueVal):
            return base
        return OpaqueVal(f"iterate {type(base).__name__}")

    def _abstract_set_compr(self, term: ast.SetCompr, env: dict):
        # {l | <labels-path>[l]}  → KeySetVal
        # {l | l := input.parameters.X[_]} → ParamListSetVal
        if not isinstance(term.term, ast.Var):
            return OpaqueVal("set comprehension head")
        v = term.term.name
        if len(term.body) != 1:
            return OpaqueVal("multi-stmt set comprehension")
        stmt = term.body[0]
        if isinstance(stmt, ast.ExprStmt) and isinstance(stmt.term, ast.Ref):
            ref = stmt.term
            if (ref.args and isinstance(ref.args[-1], ast.Var)
                    and ref.args[-1].name == v):
                base = self._abstract(
                    ast.Ref(ref.head, ref.args[:-1]), env
                )
                if isinstance(base, PathVal):
                    return KeySetVal(base.path)
            return OpaqueVal("set comprehension ref form")
        if isinstance(stmt, ast.AssignStmt) and isinstance(stmt.target, ast.Var) \
                and stmt.target.name == v:
            inner = self._abstract(stmt.term, env)
            if isinstance(inner, ParamElemVal):
                return ParamListSetVal(inner.name)
            if isinstance(inner, ParamElemFieldVal):
                return ParamListSetVal(inner.name, inner.field)
            return OpaqueVal("set comprehension assign form")
        return OpaqueVal("set comprehension body")

    # --- predicates ---------------------------------------------------------
    def _lower_pred(self, term, env: dict, negated: bool):
        """Returns a list of (expr, group) parts ([] = skip; inlined calls
        may contribute several groups).

        Negation closes over the wildcard existential:  ``not p(x[_])`` is
        ¬∃i.p(x[i]), an object-level predicate — never ∃i.¬p(x[i])."""
        before = self._instances
        result = self._lower_pred_inner(term, env)
        parts = result if isinstance(result, list) else [result]
        parts = [(p, g) for p, g in parts if p is not None]
        if not parts:
            return []
        if not negated:
            return parts
        if len(parts) > 1:
            # ¬(A(g1) ∧ B(g2)) does not distribute over groups
            raise LowerError("negated call spans multiple groups")
        pred, group = parts[0]
        if group is None:
            return [(N.Not(pred), None)]

        def _close_fresh_axis(axis, inst, inner):
            """Close ∃ over a fresh axis inside a negation.  A child axis
            whose DIRECT parent item was bound before the negation closes
            per-parent (NestedAny) and stays grouped under the parent;
            otherwise closes object-level (AnyAxis)."""
            pa = self._axis_parent.get((axis, inst))
            if pa is not None and pa[1] <= before:
                return (self._nested_any(axis, pa[0], [inner]),
                        ("axis",) + pa)
            pa2 = pa
            while pa2 is not None:
                if pa2[1] <= before:
                    raise LowerError(
                        "negation over deeply nested bound axes")
                pa2 = self._axis_parent.get(pa2)
            return N.AnyAxis(axis, inner), None

        if group[0] == "dual":
            _d, agroup, pgroup = group
            # close over any existential introduced inside the negation
            if pgroup[2] > before:
                pred = N.AnyParamList(pgroup[1], pred)
                group = agroup
                if agroup[2] > before:
                    closed, g = _close_fresh_axis(agroup[1], agroup[2],
                                                  pred)
                    return [(N.Not(closed), g)]
                return [(N.Not(pred), agroup)]
            if agroup[2] > before:
                # axis fresh but param pre-bound: per-parent closure keeps
                # the (parent, param) dual; without a bound parent the
                # shape ∃p ¬∃c is not expressible in this grid
                pa = self._axis_parent.get((agroup[1], agroup[2]))
                if pa is not None and pa[1] <= before:
                    nested = self._nested_any(agroup[1], pa[0], [pred])
                    return [(N.Not(nested),
                             ("dual", ("axis",) + pa, pgroup))]
                raise LowerError(
                    "negation over fresh axis with bound param element"
                )
            return [(N.Not(pred), group)]
        if group[2] > before:
            # the existential was introduced INSIDE the negated term
            # (e.g. `not containers[_].privileged`): negation closes over
            # it — ¬∃
            if group[0] == "axis":
                closed, g = _close_fresh_axis(group[1], group[2], pred)
                return [(N.Not(closed), g)]
            return [(N.Not(N.AnyParamList(group[1], pred)), None)]
        # the variable was bound before the negation
        # (`c := containers[_]; not c.privileged`): per-item negation
        # under the clause's shared existential — ∃c.¬
        return [(N.Not(pred), group)]

    def _lower_pred_inner(self, term, env: dict):
        if isinstance(term, ast.Var) and term.name not in env:
            rule = self.entry_mod.rules.get(term.name)
            if rule is not None and rule.kind in ("complete", "function"):
                # zero-arg boolean rule used as a guard (bad_port { ... })
                return self._inline_rule(rule, (), env)
        if isinstance(term, (ast.Ref, ast.Var)):
            val = self._abstract(term, env)
            return self._truthy(val)
        if isinstance(term, ast.Call):
            return self._lower_call_pred(term, env)
        if isinstance(term, ast.Scalar):
            return N.ConstBool(term.value is not False), None
        raise LowerError(f"predicate {type(term).__name__}")

    def _truthy(self, val):
        if isinstance(val, PathVal):
            col = self._scalar_col(val)
            return N.Truthy(col), None
        if isinstance(val, ItemVal):
            col = self._ragged_col(val)
            return N.Truthy(col), ("axis", val.axis, val.instance)
        if isinstance(val, DynFieldVal):
            # keyset columns hold truthy keys only, so contains == statement
            # truthiness of item[elem]
            rks = RaggedKeySetCol(axis=val.item.axis,
                                  subpath=val.item.subpath)
            if rks not in self.schema.ragged_keysets:
                self.schema.ragged_keysets.append(rks)
            elem = val.elem
            if isinstance(elem, ParamElemVal):
                self._note_param(elem.name, "strlist")
                needle = N.ParamElemSid()
                pgroup = ("param", elem.name, elem.instance)
            else:
                self._note_param_field(elem.name, elem.field, "str")
                needle = N.ParamElemFieldSid(elem.name, elem.field)
                pgroup = ("param", elem.name, elem.instance)
            agroup = ("axis", val.item.axis, val.item.instance)
            return N.RaggedKeySetContains(rks, needle), (
                "dual", agroup, pgroup)
        if isinstance(val, ParamVal):
            self._note_param(val.name, "bool")
            return N.ParamTruthy(val.name), None
        if isinstance(val, ConstVal):
            return N.ConstBool(val.value is not False and val.value is not None), None
        if isinstance(val, OpaqueVal):
            raise LowerError(f"opaque predicate: {val.why}")
        raise LowerError(f"truthiness of {type(val).__name__}")

    _STR_PREDS = {
        "startswith": ("startswith", 0, 1),  # (table op, subject, needle)
        "endswith": ("endswith", 0, 1),
        "contains": ("contains", 0, 1),
        "re_match": ("re_match", 1, 0),
        "regex.match": ("re_match", 1, 0),
    }

    def _lower_call_pred(self, term: ast.Call, env: dict):
        op = term.op
        if op in ("lt", "lte", "gt", "gte", "equal", "neq"):
            return self._lower_cmp(op, term.args, env)
        if op == "count":
            raise LowerError("bare count call as predicate")
        if op in self._STR_PREDS and len(term.args) == 2:
            table_op, si, ni = self._STR_PREDS[op]
            subject = self._abstract(term.args[si], env)
            needle = self._abstract(term.args[ni], env)
            if op == "re_match" and isinstance(subject, InventoryMetaVal):
                # NB: re_match(pattern, value) — 'subject' is the VALUE arg
                if (subject.slot == "apiver"
                        and isinstance(needle, ConstVal)
                        and isinstance(needle.value, str)):
                    raise _InvFilterSignal(subject.inv, needle.value)
                raise LowerError("unsupported inventory filter")
            return self._lower_str_pred(table_op, subject, needle)
        if op in ("any", "all") and len(term.args) == 1:
            val = self._abstract(term.args[0], env)
            if isinstance(val, BoolComprVal):
                reduced = N.AnyParamList(val.param, val.pred)
                if op == "all":
                    # all([]) is true; all = ¬∃¬
                    reduced = N.Not(N.AnyParamList(val.param,
                                                   N.Not(val.pred)))
                return reduced, val.axis_inst
            raise LowerError(f"{op}() of non-comprehension")
        # user function / bool rule inlining:
        fn_rule = self.entry_mod.rules.get(op)
        if fn_rule is not None:
            return self._inline_rule(fn_rule, term.args, env)
        raise LowerError(f"call {op}")

    def _lower_str_pred_raw(self, table_op: str, subject, needle):
        """Returns (StrPred, subject_group|None, param_group|None)."""
        from gatekeeper_tpu_torch.ir.program import _ElemListSid

        if isinstance(subject, PathVal):
            subj = N.FeatSid(self._scalar_col(subject))
            group = None
        elif isinstance(subject, ItemVal):
            subj = N.FeatSid(self._ragged_col(subject))
            group = ("axis", subject.axis, subject.instance)
        elif isinstance(subject, MapKeyVal):
            subj = self._sid_operand(subject)
            group = ("axis", subject.axis, subject.instance)
        elif isinstance(subject, (ParamElemVal, ParamElemFieldVal)):
            # the subject itself iterates a param list
            # (endswith(forbidden, "*")): elem sids index the pred matrix
            subj = self._sid_operand(subject)
            group = ("param", subject.name, subject.instance)
        elif isinstance(subject, ExtDataValueVal):
            # startswith(item[1], "sha256:") — the resolved value as a
            # pred-matrix subject, self-gated on resolution
            subj = self._sid_operand(subject)
            group = None if isinstance(subject.key, PathVal) else (
                "axis", subject.key.axis, subject.key.instance)
        else:
            raise LowerError(
                f"string-pred subject {type(subject).__name__}"
            )
        prefix = suffix = strip_p = strip_s = ""
        if isinstance(needle, XformElemVal):
            prefix, suffix = needle.prefix, needle.suffix
            strip_p = needle.strip_prefix
            strip_s = needle.strip_suffix
            needle = needle.inner
        if isinstance(needle, ConstVal) and isinstance(needle.value, str):
            ndl = N.ConstSid(self._intern_const(
                prefix + needle.value + suffix))
            return N.StrPred(table_op, subj, ndl), group, None
        if isinstance(needle, ParamVal):
            if prefix or suffix:
                raise LowerError("transformed scalar-param needle")
            self._note_param(needle.name, "str")
            return N.StrPred(table_op, subj, N.ParamSid(needle.name)), \
                group, None
        if isinstance(needle, ParamElemVal):
            self._note_param(needle.name, "strlist")
            ndl = _ElemListSid(needle.name, prefix, suffix,
                               strip_p, strip_s)
            return N.StrPred(table_op, subj, ndl), group, (
                "param", needle.name, needle.instance)
        if isinstance(needle, ParamElemFieldVal):
            self._note_param_field(needle.name, needle.field, "str")
            ndl = N.ParamElemFieldSid(needle.name, needle.field, prefix,
                                      suffix, strip_p, strip_s)
            return N.StrPred(table_op, subj, ndl), group, (
                "param", needle.name, needle.instance)
        raise LowerError(f"string-pred needle {type(needle).__name__}")

    def _lower_str_pred(self, table_op: str, subject, needle):
        pred, sgroup, pgroup = self._lower_str_pred_raw(table_op, subject,
                                                        needle)
        if pgroup is None:
            return pred, sgroup
        if sgroup is None:
            return pred, pgroup
        # both existentials: a dual group — the clause assembly nests the
        # param reduction under the axis reduction, merging predicates that
        # share either instance
        return pred, ("dual", sgroup, pgroup)

    def _lower_cmp(self, op: str, args, env: dict):
        lhs_t, rhs_t = args
        # count(X) OP n
        if (isinstance(lhs_t, ast.Call) and lhs_t.op == "count"
                and isinstance(rhs_t, ast.Scalar)):
            return self._lower_count_cmp(op, lhs_t.args[0], rhs_t.value, env)
        lhs = self._abstract(lhs_t, env)
        rhs = self._abstract(rhs_t, env)
        for a, b in ((lhs, rhs), (rhs, lhs)):
            if isinstance(a, SelectorCanonVal) and isinstance(
                    a.base, InventoryFeatVal):
                # canonical-selector equality against an inventory map:
                # the selector-map join (uniqueserviceselector)
                if op != "equal":
                    raise LowerError("non-equality selector comparison")
                if not (isinstance(b, SelectorCanonVal)
                        and isinstance(b.base, PathVal)):
                    raise LowerError(
                        "selector join needs a review-side canon")
                raise _InvJoinSignal(a.base.inv, a.base.path, b)
        for a, b in ((lhs, rhs), (rhs, lhs)):
            if isinstance(a, InventoryFeatVal):
                if op != "equal":
                    raise LowerError("non-equality inventory comparison")
                if isinstance(b, (InventoryFeatVal, InventoryObjVal,
                                  InventoryMetaVal)):
                    raise LowerError("inventory-to-inventory comparison")
                raise _InvJoinSignal(a.inv, a.path, b)
        axis = None
        leaves = []
        for v0 in (lhs, rhs):
            leaves.extend(self._arith_leaves(v0))  # unwraps StrFn/Arith
        for v in leaves:
            g = None
            if isinstance(v, (ItemVal, MapKeyVal)):
                g = ("axis", v.axis, v.instance)
            elif isinstance(v, ExtDataValueVal):
                if isinstance(v.key, ItemVal):
                    g = ("axis", v.key.axis, v.key.instance)
            elif isinstance(v, (ParamElemVal, ParamElemFieldVal)):
                g = ("param", v.name, v.instance)
            if g is not None:
                if axis is not None and g != axis:
                    if {axis[0], g[0]} == {"axis", "param"}:
                        # feature × param-element: one predicate under BOTH
                        # existentials — a dual group the clause assembly
                        # nests as AnyAxis(... AnyParamList(...))
                        agroup = axis if axis[0] == "axis" else g
                        pgroup = g if g[0] == "param" else axis
                        axis = ("dual", agroup, pgroup)
                    else:
                        # two independent existentials can't fuse elementwise
                        raise LowerError("cross-instance comparison")
                axis = g if axis is None else axis
        # equality against a boolean constant: x == true / x == false
        if op in ("equal", "neq"):
            for a, b in ((lhs, rhs), (rhs, lhs)):
                if isinstance(b, ConstVal) and isinstance(b.value, bool):
                    pred, paxis = self._bool_eq(a, b.value)
                    if op == "neq":
                        pred = N.Not(pred)
                    return pred, paxis
        def _is_feature(v):
            return isinstance(v, (PathVal, ItemVal)) or (
                isinstance(v, StrFnVal)
                and isinstance(v.inner, (PathVal, ItemVal))
            )

        if _is_feature(lhs) and _is_feature(rhs):
            if (op in ("equal", "neq")
                    and not isinstance(lhs, StrFnVal)
                    and not isinstance(rhs, StrFnVal)
                    and _scalar_typed_path(lhs)
                    and _scalar_typed_path(rhs)):
                # feature-to-feature (in)equality: full scalar semantics
                # on device (object vs oldObject fields — upstream
                # noupdateserviceaccount).  Gated on BOTH paths ending in
                # a known schema-scalar field name: FeatEqFeat treats
                # composite operands as shallow-unequal, so arbitrary
                # paths (metadata.labels vs oldObject labels) must keep
                # the exact interpreter fallback
                def _fcol(v):
                    return (self._scalar_col(v) if isinstance(v, PathVal)
                            else self._ragged_col(v))

                return N.FeatEqFeat(_fcol(lhs), _fcol(rhs),
                                    negate=(op == "neq")), axis
            # ordered comparison / string-function operands / paths not
            # provably scalar: exact semantics would need lexical string
            # order, parsed quantities, or deep composite comparison on
            # device — interpreter fallback
            raise LowerError("feature-to-feature comparison")
        str_side = self._is_stringy(lhs) or self._is_stringy(rhs)
        if str_side:
            if op not in ("equal", "neq"):
                raise LowerError("ordered comparison on strings")
            lo = self._sid_operand(lhs)
            ro = self._sid_operand(rhs)
            return N.EqStr(lo, ro, negate=(op == "neq")), axis
        lo = self._num_operand(lhs)
        ro = self._num_operand(rhs)
        op_map = {"equal": "eq", "neq": "neq"}
        return N.CmpNum(lo, op_map.get(op, op), ro), axis

    def _arith_leaves(self, val):
        if isinstance(val, ArithVal):
            return self._arith_leaves(val.a) + self._arith_leaves(val.b)
        if isinstance(val, StrFnVal):
            return self._arith_leaves(val.inner)
        return [val]

    def _arith_group(self, val):
        group = None
        for leaf in self._arith_leaves(val):
            g = self._group_of(leaf)
            if g is not None:
                if group is not None and g != group:
                    raise LowerError("arithmetic across existential groups")
                group = g
        return group

    def _group_of(self, val):
        if isinstance(val, (ItemVal, MapKeyVal)):
            return ("axis", val.axis, val.instance)
        if isinstance(val, (ParamElemVal, ParamElemFieldVal)):
            return ("param", val.name, val.instance)
        return None

    def _bool_eq(self, val, want: bool):
        """x == true  ⇔ kind==K_TRUE; x == false ⇔ kind==K_FALSE.  Truthy
        covers ==true only for bools; use explicit kind tests via Truthy and
        Present: (x==true) = Truthy∧IsBool… we approximate with Truthy-based
        forms that are exact for boolean-valued fields."""
        if isinstance(val, PathVal):
            col = self._scalar_col(val)
            axis = None
        elif isinstance(val, ItemVal):
            col = self._ragged_col(val)
            axis = ("axis", val.axis, val.instance)
        elif isinstance(val, ParamVal):
            self._note_param(val.name, "bool")
            return N.ParamBoolIs(val.name, want), None
        else:
            raise LowerError("bool equality operand")
        # exact: only actual booleans equal true/false (a string "yes" is
        # truthy but != true), so test the kind tag, not truthiness
        return N.KindIs(col, 2 if want else 1), axis

    _CMPNUM_OP = {"lt": "lt", "lte": "lte", "gt": "gt", "gte": "gte",
                  "equal": "eq", "neq": "neq"}

    def _eq_const_pred(self, lit: str, val):
        """(pred, group): abstract value == string literal."""
        subj = self._sid_operand(val)
        pred = N.EqStr(subj, N.ConstSid(self._intern_const(lit)))
        group = None
        if isinstance(val, (ItemVal, MapKeyVal)):
            group = ("axis", val.axis, val.instance)
        elif isinstance(val, (ParamElemVal, ParamElemFieldVal)):
            group = ("param", val.name, val.instance)
        return pred, group

    def _nested_any(self, child_axis, parent_axis, preds) -> "N.Expr":
        picol = ParentIdxCol(axis=child_axis, parent=parent_axis)
        if picol not in self.schema.parent_idx:
            self.schema.parent_idx.append(picol)
        parent_col = self._ragged_col(ItemVal(parent_axis, (), 0))
        inner = N.And(tuple(preds)) if len(preds) > 1 else preds[0]
        return N.NestedAny(picol, parent_col, inner)

    def _lower_count_cmp(self, op: str, set_term, n, env: dict):
        val = self._abstract(set_term, env)
        if isinstance(val, ConstVal):
            # count of a compile-time constant (the canonical external-
            # data template's count(response.system_error) > 0 clause):
            # fold statically — strings count length, composites size
            v = val.value
            if isinstance(v, str):
                cnt = len(v)
            elif isinstance(v, (list, tuple, dict)):
                cnt = len(v)
            else:
                raise LowerError("count() of non-countable constant")
            import operator as _op

            fn = {"lt": _op.lt, "lte": _op.le, "gt": _op.gt,
                  "gte": _op.ge, "equal": _op.eq, "neq": _op.ne}[op]
            return N.ConstBool(bool(fn(cnt, n))), None
        if isinstance(val, ExtDataListVal):
            # emptiness tests only: the lane dedupes keys, so EXACT pair
            # counts can diverge from the per-object key list — ∃/∄ is
            # dedupe-insensitive
            key, group = self._extdata_reinstance(val.resp)
            pred = self._extdata_item_pred(val.resp.provider, key,
                                           want_ok=(val.field
                                                    == "responses"))
            nonzero = (op == "gt" and n == 0) or (op == "gte" and n == 1) \
                or (op == "neq" and n == 0)
            zero = (op in ("equal", "lte") and n == 0) or (
                op == "lt" and n == 1)
            if nonzero:
                return pred, group
            if zero:
                if group is None:
                    return N.Not(pred), None
                _ax, axis, inst = group
                if not val.resp.from_list:
                    # bound single-key response: per-binding negation
                    # under the already-open existential
                    return N.Not(pred), group
                pa = self._axis_parent.get((axis, inst))
                if pa is not None:
                    return N.Not(self._nested_any(axis, pa[0], [pred])), \
                        ("axis",) + pa
                return N.Not(N.AnyAxis(axis, pred)), None
            raise LowerError(f"external_data count comparison {op} {n}")
        if isinstance(val, PathVal):
            # count(obj.spec.tls) OP n: composite item count / string length
            if val.path[:2] != OBJECT_ROOT:
                raise LowerError("count() outside review object")
            col = self._scalar_col(val)
            axis = Axis(((val.path[2:],),))
            # a ragged col on the axis materializes its item counts
            self._ragged_col(ItemVal(axis, (), 0))
            cmp = N.CmpNum(N.CountNum(col, axis), self._CMPNUM_OP[op],
                           N.ConstNum(float(n)))
            return cmp, None
        if not isinstance(val, SetDiffVal):
            raise LowerError("count() of non set-diff pattern")
        if val.required.field:
            self._note_param_field(val.required.name, val.required.field,
                                   "str")
            elem_needle = N.ParamElemFieldSid(val.required.name,
                                              val.required.field)
        else:
            self._note_param(val.required.name, "strlist")
            elem_needle = N.ParamElemSid()
        keyset = KeySetCol(path=val.provided.path[2:]) if (
            val.provided.path[:2] == OBJECT_ROOT
        ) else None
        if keyset is None:
            raise LowerError("keyset outside review object")
        if keyset not in self.schema.keysets:
            self.schema.keysets.append(keyset)
        missing_any = N.AnyParamList(
            val.required.name,
            N.Not(N.KeySetContains(keyset, elem_needle)),
        )
        if op == "gt" and n == 0:
            return missing_any, None
        if op in ("equal", "lte") and n == 0:
            return N.Not(missing_any), None
        raise LowerError(f"count comparison {op} {n}")

    def _inventory_exclusion(self, stmt, env: dict):
        """Recognize `not identical(other, input.review)` where ``other``
        is an inventory entry and ``identical`` tests metadata namespace +
        name equality — the self-exclusion of referential uniqueness
        policies.  Returns the InventoryObjVal or None."""
        if not stmt.negated or not isinstance(stmt.term, ast.Call):
            return None
        call = stmt.term
        rule = self.entry_mod.rules.get(call.op)
        if rule is None or len(call.args) != 2:
            return None
        inv = env.get(getattr(call.args[0], "name", None))
        if not isinstance(inv, InventoryObjVal):
            return None
        second = self._abstract(call.args[1], dict(env))
        if not (isinstance(second, PathVal) and second.path == ("review",)):
            raise LowerError(
                "inventory exclusion must compare against input.review")
        if len(rule.clauses) != 1 or rule.clauses[0].value is not None:
            raise LowerError("unrecognized inventory exclusion function")
        clause = rule.clauses[0]
        params = clause.args or ()
        if len(params) != 2 or not all(isinstance(pr, ast.Var)
                                       for pr in params):
            raise LowerError("unrecognized inventory exclusion function")
        fenv = {params[0].name: inv,
                params[1].name: PathVal(("review",))}
        needed = {("metadata", "namespace"), ("metadata", "name")}
        seen = set()
        for st in clause.body:
            if not (isinstance(st, ast.ExprStmt) and not st.negated
                    and isinstance(st.term, ast.Call)
                    and st.term.op == "equal"
                    and len(st.term.args) == 2):
                raise LowerError("unrecognized inventory exclusion function")
        for st in clause.body:
            a = self._abstract(st.term.args[0], dict(fenv))
            b = self._abstract(st.term.args[1], dict(fenv))
            if isinstance(b, InventoryFeatVal):
                a, b = b, a
            if not (isinstance(a, InventoryFeatVal) and a.inv == inv
                    and isinstance(b, PathVal)
                    and b.path == OBJECT_ROOT + a.path
                    and a.path in needed):
                raise LowerError("unrecognized inventory exclusion function")
            seen.add(a.path)
        if seen != needed:
            raise LowerError("unrecognized inventory exclusion function")
        return inv

    def _inline_rule(self, rule: ast.Rule, args, env: dict):
        """Inline a call.  Predicates on CALLER-bound existentials (an item
        argument like read_only(c)) return open, grouped under the caller's
        instance, so the clause assembly merges them into the shared
        AnyAxis; body-internal existentials close here.  Returns a list of
        (pred, group) parts."""
        self.depth += 1
        if self.depth > 16:
            raise LowerError("function inlining too deep")
        try:
            if rule.kind not in ("function", "complete"):
                raise LowerError(f"call of {rule.kind} rule")
            arg_vals = [self._abstract(a, env) for a in args]
            snapshot = self._instances
            clause_parts = []
            for clause in rule.clauses:
                if clause.els is not None:
                    raise LowerError("else in inlined function")
                if clause.value is not None and not (
                    isinstance(clause.value, ast.Scalar)
                    and clause.value.value is True
                ):
                    raise LowerError("non-boolean function result")
                fenv: dict = {}
                pattern_parts = []
                params = clause.args or ()
                if len(params) != len(arg_vals):
                    raise LowerError("arity mismatch in inlined call")
                for p, v in zip(params, arg_vals):
                    if isinstance(p, ast.Var):
                        fenv[p.name] = v
                    elif isinstance(p, ast.Scalar) and isinstance(
                            p.value, str):
                        # literal pattern parameter: the clause applies only
                        # when the argument equals it (forbidden("x") { .. })
                        pattern_parts.append(self._eq_const_pred(p.value, v))
                    else:
                        raise LowerError("pattern parameter")
                terms, open_groups = self._lower_body_parts(
                    clause.body, fenv, snapshot)
                for pred, group in pattern_parts:
                    if group is None:
                        terms = list(terms) + [pred]
                    else:
                        open_groups.setdefault(group, []).append(pred)
                # drop vacuous truths (forbidden("x") { true } bodies):
                # true ∧ X = X, and a lone grouped part OR-merges cleanly
                terms = [t for t in terms
                         if not (isinstance(t, N.ConstBool) and t.value)]
                parts = []
                if terms:
                    parts.append((N.And(tuple(terms)) if len(terms) > 1
                                  else terms[0], None))
                for g, preds in open_groups.items():
                    parts.append((N.And(tuple(preds)) if len(preds) > 1
                                  else preds[0], g))
                if not parts:
                    raise LowerError("empty inlined clause")
                clause_parts.append(parts)
            if not clause_parts:
                raise LowerError("empty function")
            if len(clause_parts) == 1:
                return clause_parts[0]
            # multi-clause OR: mergeable when every clause is a single part
            # and the groups share one axis component; a plain axis part
            # broadcasts over the param element dim of a sibling dual
            if any(len(parts) != 1 for parts in clause_parts):
                raise LowerError(
                    "OR of inlined clauses across existential groups")
            groups = [parts[0][1] for parts in clause_parts]
            uniq = set(groups)
            if len(uniq) == 1:
                return [(N.Or(tuple(p[0][0] for p in clause_parts)),
                         groups[0])]
            axis_of = {g[1] if g is not None and g[0] == "dual" else g
                       for g in groups}
            duals = {g for g in uniq if g is not None and g[0] == "dual"}
            if len(axis_of) == 1 and len(duals) == 1:
                # same axis everywhere, one dual: merge under it
                return [(N.Or(tuple(p[0][0] for p in clause_parts)),
                         duals.pop())]
            raise LowerError(
                "OR of inlined clauses across existential groups")
        finally:
            self.depth -= 1

    # --- operand helpers ----------------------------------------------------
    def _hint_type(self, name: str, field: tuple = ()):
        """openAPIV3Schema-declared type of a (possibly dotted) parameter
        path, descending through array items for object-list fields."""
        node: dict = {"properties": self.schema_hint}
        for part in name.split("."):
            nxt = (node.get("properties") or {}).get(part)
            if not isinstance(nxt, dict):
                return None
            node = nxt
        for f in field:
            if node.get("type") == "array":
                node = node.get("items") or {}
            nxt = (node.get("properties") or {}).get(f)
            if not isinstance(nxt, dict):
                return None
            node = nxt
        return node.get("type")

    def _is_stringy(self, val) -> bool:
        if isinstance(val, (MapKeyVal, ExtDataValueVal)):
            return True
        if isinstance(val, ConstVal):
            return isinstance(val.value, str)
        if isinstance(val, ParamVal):
            return self._hint_type(val.name) == "string"
        if isinstance(val, ParamElemVal):
            return True
        if isinstance(val, ParamElemFieldVal):
            # schema-declared string fields of object-list params compare
            # as sids (K8sVerifyDeprecatedAPI kvs.kind, flexVolume driver,
            # seLinuxOptions fields); undeclared fields stay numeric with
            # cross-type term-rank semantics
            return self._hint_type(val.name, val.field) == "string"
        return False

    def _num_operand(self, val):
        if isinstance(val, ConstVal):
            if isinstance(val.value, bool) or not isinstance(val.value, (int, float)):
                raise LowerError(f"non-numeric constant {val.value!r}")
            return N.ConstNum(float(val.value))
        if isinstance(val, ParamVal):
            self._note_param(val.name, "num")
            return N.ParamNum(val.name)
        if isinstance(val, PathVal):
            return N.FeatNum(self._scalar_col(val))
        if isinstance(val, ItemVal):
            return N.FeatNum(self._ragged_col(val))
        if isinstance(val, ParamElemFieldVal):
            self._note_param_field(val.name, val.field, "num")
            return N.ParamElemFieldNum(val.name, val.field)
        if isinstance(val, MapKeyVal):
            raise LowerError("map iteration key used numerically")
        if isinstance(val, ArithVal):
            return N.NumBin(val.op, self._num_operand(val.a),
                            self._num_operand(val.b))
        if isinstance(val, StrFnVal):
            inner = val.inner
            if isinstance(inner, PathVal):
                return N.StrFnNum(val.fn, N.FeatSid(self._scalar_col(inner)))
            if isinstance(inner, ItemVal):
                return N.StrFnNum(val.fn, N.FeatSid(self._ragged_col(inner)))
            if isinstance(inner, ParamVal):
                self._note_param(inner.name, "str")
                return N.ParamFnNum(val.fn, inner.name)
            raise LowerError(f"string-fn of {type(inner).__name__}")
        raise LowerError(f"numeric operand {type(val).__name__}")

    def _sid_operand(self, val):
        if isinstance(val, ConstVal):
            if not isinstance(val.value, str):
                raise LowerError("non-string constant in string compare")
            return N.ConstSid(self._intern_const(val.value))
        if isinstance(val, ParamVal):
            self._note_param(val.name, "str")
            return N.ParamSid(val.name)
        if isinstance(val, ParamElemVal):
            self._note_param(val.name, "strlist")
            return N.ParamElemSid()
        if isinstance(val, ParamElemFieldVal):
            self._note_param_field(val.name, val.field, "str")
            return N.ParamElemFieldSid(val.name, val.field)
        if isinstance(val, PathVal):
            return N.FeatSid(self._scalar_col(val))
        if isinstance(val, ItemVal):
            return N.FeatSid(self._ragged_col(val))
        if isinstance(val, MapKeyVal):
            col = MapKeyCol(axis=val.axis)
            if col not in self.schema.map_keys:
                self.schema.map_keys.append(col)
            return N.MapKeySid(col)
        if isinstance(val, ExtDataValueVal):
            return N.ExtDataValueSid(val.provider,
                                     self._extdata_subject(val.key))
        if isinstance(val, (InventoryFeatVal, InventoryObjVal,
                            InventoryMetaVal)):
            raise LowerError("inventory value outside a join")
        raise LowerError(f"string operand {type(val).__name__}")

    def _intern_const(self, s: str) -> int:
        # Vocab ids are stable once assigned, so interning at compile time is
        # safe across later batches.
        return self.vocab.intern(s)

    def _scalar_col(self, val: PathVal) -> ScalarCol:
        if val.path[:2] == OBJECT_ROOT:
            col = ScalarCol(path=val.path[2:])
        elif val.path[:1] == ("review",) and val.path[1:2] and (
            val.path[1] in ("kind", "operation", "name", "namespace",
                            "userInfo", "oldObject")
        ):
            # review-level scalars columnized from the review document (only
            # the fields the batch paths populate — anything else must fall
            # back so lowered verdicts can't silently read absent data)
            col = ScalarCol(path=("__review__",) + val.path[1:])
        else:
            raise LowerError(f"path outside review: {val.path}")
        if col not in self.schema.scalars:
            self.schema.scalars.append(col)
        return col

    def _ragged_col(self, val: ItemVal) -> RaggedCol:
        col = RaggedCol(axis=val.axis, subpath=val.subpath)
        if col not in self.schema.raggeds:
            self.schema.raggeds.append(col)
        return col

    def _note_param_field(self, name: str, field: tuple, ftype: str):
        self._note_param(name, "objlist")
        fields = self.param_fields.setdefault(name, {})
        prev = fields.get(field)
        if prev is not None and prev != ftype:
            raise LowerError(
                f"param {name}.{'.'.join(field)} used as {prev} and {ftype}"
            )
        fields[field] = ftype

    def _note_param(self, name: str, kind: str):
        prev = self.param_kinds.get(name)
        if prev is not None and prev != kind:
            # bool usage is compatible with any (truthiness of any param)
            if "bool" in (prev, kind):
                self.param_kinds[name] = prev if prev != "bool" else kind
                return
            raise LowerError(f"param {name} used as {prev} and {kind}")
        self.param_kinds[name] = kind


def lower_template(modules, entry_pkg: tuple, template_kind: str,
                   vocab, schema_hint: Optional[dict] = None) -> N.Program:
    """Lower a compiled template to a Program, or raise LowerError."""
    low = _Lowerer(modules, entry_pkg, schema_hint, vocab)
    # set rules referenced with [_] (e.g. input_containers) are handled when
    # the reference is abstract-evaluated; pre-bind them as union axes.
    low.entry_axis_rules = _collect_axis_rules(low)
    expr = _with_axis_rules(low)
    params = tuple(
        N.ParamSpec(
            name=k, kind=v,
            fields=tuple(sorted(low.param_fields.get(k, {}).items())),
        )
        for k, v in sorted(low.param_kinds.items())
    )
    return N.Program(
        template_kind=template_kind,
        expr=expr,
        params=params,
        schema=low.schema,
    )


def _collect_axis_rules(low: _Lowerer) -> dict:
    """Set rules of the form  name[c] { c := <list-path>[_] }  become union
    axes usable via  name[_]  (PSP pattern input_containers)."""
    out: dict[str, Axis] = {}
    for name, rule in low.entry_mod.rules.items():
        if rule.kind != "set":
            continue
        if name == "violation":
            continue
        segments = []
        ok = True
        for clause in rule.clauses:
            seg = _clause_as_list_path(low, clause)
            if seg is None:
                ok = False
                break
            segments.extend(seg)
        if ok and segments:
            out[name] = Axis(tuple(segments))
    return out


def _clause_as_list_path(low: _Lowerer, clause) -> Optional[list]:
    if clause.els is not None or clause.args is not None:
        return None
    if not isinstance(clause.key, ast.Var) or len(clause.body) != 1:
        return None
    stmt = clause.body[0]
    if not isinstance(stmt, ast.AssignStmt):
        return None
    if not isinstance(stmt.target, ast.Var) or stmt.target.name != clause.key.name:
        return None
    val = low._abstract(stmt.term, {})
    if isinstance(val, ItemVal) and not val.subpath:
        return list(val.axis.segments)
    return None


def _with_axis_rules(low: _Lowerer) -> N.Expr:
    """Patch the lowerer so refs to axis set-rules resolve, then lower."""
    axis_rules = low.entry_axis_rules

    orig_abstract = low._abstract

    def patched(term, env):
        if isinstance(term, ast.Ref) and isinstance(term.head, ast.Var):
            name = term.head.name
            if name in axis_rules and name not in env:
                consumed = False
                cur = None
                for arg in term.args:
                    if not consumed:
                        # first arg is the iteration variable / wildcard
                        if isinstance(arg, ast.Var) and arg.name.startswith("$w"):
                            cur = ItemVal(axis_rules[name], (),
                                          low._fresh_instance())
                            consumed = True
                            continue
                        if isinstance(arg, ast.Var) and isinstance(
                            env.get(arg.name), IterBinding
                        ):
                            b = env[arg.name]
                            if b.axis != axis_rules[name]:
                                return OpaqueVal(
                                    f"var {arg.name} indexes two collections"
                                )
                            cur = ItemVal(b.axis, (), b.instance)
                            consumed = True
                            continue
                        if isinstance(arg, ast.Var) and arg.name not in env:
                            cur = ItemVal(axis_rules[name], (),
                                          low._fresh_instance())
                            env[arg.name] = IterBinding(cur.axis, cur.instance)
                            consumed = True
                            continue
                        return OpaqueVal("axis rule indexed oddly")
                    if isinstance(arg, ast.Scalar) and isinstance(arg.value, str):
                        cur = low._step(cur, arg.value)
                    elif isinstance(arg, ast.Var) and arg.name.startswith("$w"):
                        cur = low._iterate(cur)
                    else:
                        return OpaqueVal("axis rule computed index")
                if cur is None:
                    return OpaqueVal("axis rule referenced without iteration")
                return cur
        return orig_abstract(term, env)

    low._abstract = patched
    return low.lower_violation()
