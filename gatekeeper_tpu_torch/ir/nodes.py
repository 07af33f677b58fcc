"""Predicate IR: the lowered form of a template's violation conditions.

A template lowers to one boolean expression per violation clause (OR'd); the
expression reads flattened columns (gatekeeper_tpu_torch.ops.flatten) and one
constraint's parameter row.  The JAX evaluator (gatekeeper_tpu_torch.ir.program)
vmaps the expression over the constraint axis and jits over the object batch —
the "constraint-program × object batch" grid of SURVEY.md §5.7.

Messages and details are NOT lowered: the device detects violations, the host
renders messages by re-running the exact interpreter only on hits (sparse).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from gatekeeper_tpu_torch.ops.flatten import Axis, KeySetCol, RaggedCol, ScalarCol  # noqa: F401

FeatCol = Union[ScalarCol, RaggedCol]


class Expr:
    __slots__ = ()


# --- leaf references ------------------------------------------------------


@dataclass(frozen=True)
class Truthy(Expr):
    """Rego statement-truthiness of the value at a column: defined and not
    false (null/0/"" are truthy in Rego)."""

    col: FeatCol


@dataclass(frozen=True)
class Present(Expr):
    col: FeatCol


@dataclass(frozen=True)
class FeatNum(Expr):
    col: FeatCol


@dataclass(frozen=True)
class FeatSid(Expr):
    col: FeatCol


@dataclass(frozen=True)
class ParamNum(Expr):
    name: str


@dataclass(frozen=True)
class ParamSid(Expr):
    name: str


@dataclass(frozen=True)
class ParamTruthy(Expr):
    name: str


@dataclass(frozen=True)
class ParamPresent(Expr):
    name: str


@dataclass(frozen=True)
class ConstNum(Expr):
    value: float


@dataclass(frozen=True)
class ConstSid(Expr):
    sid: int


@dataclass(frozen=True)
class ParamElemSid(Expr):
    """Current element inside AnyParamList (string lists)."""


@dataclass(frozen=True)
class ParamElemFieldSid(Expr):
    """String field of the current object-list element: params.xs[_].key.
    ``prefix``/``suffix`` apply a static string transform when used as a
    StrPred needle (concat idiom)."""

    param: str
    field: tuple
    prefix: str = ""
    suffix: str = ""
    strip_prefix: str = ""
    strip_suffix: str = ""


@dataclass(frozen=True)
class ParamElemFieldNum(Expr):
    """Numeric field of the current object-list element."""

    param: str
    field: tuple


@dataclass(frozen=True)
class StrFnNum(Expr):
    """Vocab-table numeric function of a string feature (units.parse /
    units.parse_bytes): table[sid] with validity mask."""

    fn: str
    operand: Expr  # sid-valued


@dataclass(frozen=True)
class ParamFnNum(Expr):
    """Numeric function applied to a scalar string parameter (computed at
    table-build time)."""

    fn: str
    name: str


@dataclass(frozen=True)
class StrFnValid(Expr):
    """True iff the operand is a string the vocab function parses
    (CEL isQuantity; the validity half of the StrFnNum table)."""

    fn: str
    operand: Expr  # sid-valued


@dataclass(frozen=True)
class InvTableSpec:
    """Host-built inventory join table: for every object of ``kind`` in
    data.inventory.namespace[*][apiver][kind][*], the values at
    ``join_path`` ('*' = iterate), deduped per owner.  Device arrays
    (vocab-padded [V]): cnt (distinct owners per value sid), ons/onm (the
    sole owner's metadata ns/name sids when cnt==1, sentinel -2 when that
    owner lacks the field)."""

    kind: str
    join_path: tuple  # e.g. ("spec", "rules", "*", "host")
    apiver_regex: str = ""  # "" = any apiVersion
    scope: str = "namespace"  # "namespace" | "cluster" (inventory root)
    # "selector_canon": join on the canonical 'k:v,...' encoding of the
    # map at join_path (ops.flatten.selector_canon) instead of its raw
    # string values — the flatten_selector idiom
    transform: str = ""
    # prefix join values with the entry's namespace (same-namespace
    # joins: data.inventory.namespace[<review ns>][...])
    ns_scoped: bool = False

    def key(self) -> str:
        return (f"{self.kind}|{'.'.join(self.join_path)}|"
                f"{self.apiver_regex}|{self.scope}|{self.transform}|"
                f"{int(self.ns_scoped)}")


@dataclass(frozen=True)
class InventoryUniqueJoin(Expr):
    """∃ inventory entry (of spec.kind) whose join value equals
    ``subject`` and whose owner differs from the review object's
    metadata ns/name (identical() exclusion).  With exclude_self False,
    any owner counts."""

    spec: InvTableSpec
    subject: Expr  # sid-valued
    ns_col: "object"  # ScalarCol at metadata.namespace
    name_col: "object"  # ScalarCol at metadata.name
    exclude_self: bool = True


@dataclass(frozen=True)
class ExtDataOk(Expr):
    """subject's key resolved by the external-data provider without a
    per-key error — the ``responses`` membership half of the batched
    join (extdata/lane.py tables ``ext:<provider>:ok``).  False for
    non-string subjects (the host builtin marks them per-key errors)
    and for keys outside the table (never fetched = not resolved)."""

    provider: str
    subject: Expr  # sid-valued


@dataclass(frozen=True)
class ExtDataValueSid(Expr):
    """sid of the provider's resolved value for subject's key
    (``ext:<provider>:val``): sid-valued where the value is a string,
    present-non-string for resolved non-string values, absent when the
    key did not resolve — so (in)equality against it follows the same
    defined/undefined rules the host interpreter applies to
    ``response.responses[_][1]``."""

    provider: str
    subject: Expr  # sid-valued


@dataclass(frozen=True)
class NumBin(Expr):
    """Arithmetic over two numeric operands.  Rego arithmetic is PARTIAL:
    defined only when both operands are numbers (and the divisor nonzero)
    — validity gates every comparison using the result."""

    op: str  # "add" | "sub" | "mul" | "div"
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class NumDefined(Expr):
    """True iff a numeric operand tree is defined (used to charge the
    definedness of an arithmetic assignment whose result may only appear
    in the message head)."""

    inner: Expr


@dataclass(frozen=True)
class CountNum(Expr):
    """Rego count() of the value at a scalar path: item count of the
    derived axis for composites, string length (vocab 'count' table) for
    strings; undefined for other kinds (validity gates the comparison)."""

    col: FeatCol  # ScalarCol at the path (kind/sid)
    axis: Axis  # materializes the composite item count


@dataclass(frozen=True)
class StrPred(Expr):
    """String predicate via vocab table: op(subject, needle) where needle is
    a constraint-parameter value (startswith/endswith/contains/re_match)."""

    op: str
    subject: Expr  # sid-valued feature
    needle: Expr  # ParamElemSid / ParamElemFieldSid / ParamSid / ConstSid


# --- predicates -----------------------------------------------------------


@dataclass(frozen=True)
class CmpNum(Expr):
    """Numeric comparison; false unless both sides are defined numbers."""

    lhs: Expr
    op: str  # lt | lte | gt | gte | eq | neq
    rhs: Expr


@dataclass(frozen=True)
class EqStr(Expr):
    lhs: Expr  # FeatSid / ParamSid / ConstSid / ParamElemSid
    rhs: Expr
    negate: bool = False


@dataclass(frozen=True)
class FeatEqFeat(Expr):
    """Equality of two feature VALUES (object.spec.x == oldObject.spec.x)
    with full scalar semantics: both defined, kinds match, numbers
    compare numerically, strings by sid, true/false/null by kind alone.
    Composite operands (maps/lists) compare shallowly UNEQUAL — the
    shipped templates compare schema-typed scalar fields (e.g.
    serviceAccountName, upstream noupdateserviceaccount), where the
    apiserver guarantees scalars; a deep-equal composite pair would
    diverge from the interpreter.  ``negate`` follows Rego !=: defined
    operands of different kinds are defined-unequal (true)."""

    lhs: FeatCol
    rhs: FeatCol
    negate: bool = False


@dataclass(frozen=True)
class InStrList(Expr):
    """value ∈ string-list parameter."""

    needle: Expr  # sid-valued
    param: str


@dataclass(frozen=True)
class KeySetContains(Expr):
    """needle ∈ keys of map column (e.g. a label key in metadata.labels)."""

    keyset: KeySetCol
    needle: Expr  # sid-valued


@dataclass(frozen=True)
class CanonFeatSid(Expr):
    """sid of the review object's canonical selector encoding (the
    CanonCol column) — the subject side of a selector-map join."""

    col: "object"  # ops.flatten.CanonCol


@dataclass(frozen=True)
class MapKeySid(Expr):
    """The map key of the current axis item (labels[key] iteration);
    sid -1 for list-backed items (whose Rego key is an int index — string
    equality against it is false on both engines)."""

    col: "object"  # ops.flatten.MapKeyCol


@dataclass(frozen=True)
class RaggedKeySetContains(Expr):
    """needle ∈ keys of the current axis item's map (dynamic field
    presence: container[probe]).  Evaluates inside AnyAxis (+ AnyParamList
    when the needle is a param element)."""

    keyset: "object"  # ops.flatten.RaggedKeySetCol
    needle: Expr  # sid-valued


# --- combinators ----------------------------------------------------------


@dataclass(frozen=True)
class Not(Expr):
    inner: Expr


@dataclass(frozen=True)
class And(Expr):
    terms: tuple


@dataclass(frozen=True)
class Or(Expr):
    terms: tuple


@dataclass(frozen=True)
class AnyAxis(Expr):
    """∃ item on ragged axis satisfying inner (inner may use the axis's
    RaggedCols)."""

    axis: Axis
    inner: Expr


@dataclass(frozen=True)
class CountAxisIs(Expr):
    """Exactly ``k`` items on the ragged axis satisfy inner (CEL
    exists_one: count == 1 with no short-circuit)."""

    axis: Axis
    inner: Expr
    k: int


@dataclass(frozen=True)
class NestedAny(Expr):
    """Per-parent-item ∃ over a nested pair axis: inside the parent's
    AnyAxis, true for parent slot p iff some pair j with parent_idx[j]==p
    satisfies inner (evaluated in the CHILD's ragged context).  Expresses
    correlated iteration like `c := containers[_]; c.caps.drop[_] == x`
    without losing which container each pair belongs to."""

    col: "object"  # ops.flatten.ParentIdxCol
    parent_col: "object"  # RaggedCol on the parent axis (shape source)
    inner: Expr


@dataclass(frozen=True)
class AnyParamList(Expr):
    """∃ element of a list parameter satisfying inner (inner uses
    ParamElemSid / ParamElemField*) — e.g. required-labels: any required
    label missing."""

    param: str
    inner: Expr


AnyParamStrList = AnyParamList  # historical alias


@dataclass(frozen=True)
class ConstBool(Expr):
    value: bool


@dataclass(frozen=True)
class KindIs(Expr):
    """Exact value-kind test: kind tag equals (1=false, 2=true, ...)."""

    col: FeatCol
    kind: int


@dataclass(frozen=True)
class ParamBoolIs(Expr):
    """Exact boolean equality for a parameter (kind tag test)."""

    name: str
    want: bool


# --- parameter specs ------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    name: str
    kind: str  # num | str | bool | strlist | numlist | objlist
    fields: tuple = ()  # objlist: ((path_tuple, "num"|"str"), ...)


@dataclass
class Program:
    """A lowered template: violation ⇔ expr true for (object, constraint)."""

    template_kind: str
    expr: Expr
    params: tuple  # tuple[ParamSpec]
    schema: "object"  # ops.flatten.Schema with the columns this expr reads
