"""Rego AST node types (subset sufficient for gatekeeper-style policies)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class Node:
    __slots__ = ()


@dataclass(frozen=True)
class Scalar(Node):
    value: Any  # None | bool | int | float | str


@dataclass(frozen=True)
class Var(Node):
    name: str


@dataclass(frozen=True)
class Ref(Node):
    """A reference: head var + operand terms (string constants become Scalar).

    ``input.review.object`` == Ref(Var("input"), (Scalar("review"), Scalar("object")))
    """

    head: Node
    args: tuple = ()


@dataclass(frozen=True)
class ArrayTerm(Node):
    items: tuple


@dataclass(frozen=True)
class ObjectTerm(Node):
    pairs: tuple  # tuple[(key_term, value_term)]


@dataclass(frozen=True)
class SetTerm(Node):
    items: tuple


@dataclass(frozen=True)
class Call(Node):
    op: str  # builtin or function ref rendered as dotted name
    args: tuple


@dataclass(frozen=True)
class ArrayCompr(Node):
    term: Node
    body: tuple


@dataclass(frozen=True)
class SetCompr(Node):
    term: Node
    body: tuple


@dataclass(frozen=True)
class ObjectCompr(Node):
    key: Node
    value: Node
    body: tuple


# --- statements (body literals) ------------------------------------------


@dataclass(frozen=True)
class ExprStmt(Node):
    term: Node
    negated: bool = False


@dataclass(frozen=True)
class AssignStmt(Node):
    target: Node  # Var or Array/Object destructuring pattern
    term: Node


@dataclass(frozen=True)
class UnifyStmt(Node):
    lhs: Node
    rhs: Node


@dataclass(frozen=True)
class SomeDecl(Node):
    names: tuple  # tuple[str]


@dataclass(frozen=True)
class SomeIn(Node):
    """``some x in coll`` / ``some k, v in coll`` / bare ``x in coll``."""

    key: Optional[Node]
    value: Node
    collection: Node


@dataclass(frozen=True)
class EveryStmt(Node):
    key: Optional[str]
    value: str
    domain: Node
    body: tuple


# --- rules ----------------------------------------------------------------


@dataclass
class Clause:
    body: tuple  # statements; empty tuple = unconditionally true
    key: Optional[Node] = None  # partial set/object key
    value: Optional[Node] = None  # head value term
    args: Optional[tuple] = None  # function parameters (terms; support Var/Scalar)
    els: Optional["Clause"] = None  # else clause chain


@dataclass
class Rule:
    name: str
    kind: str  # "complete" | "set" | "object" | "function"
    clauses: list = field(default_factory=list)
    default: Optional[Node] = None


@dataclass
class Module:
    package: tuple  # e.g. ("k8srequiredlabels",) or ("lib", "helpers")
    imports: dict = field(default_factory=dict)  # alias -> ref path tuple
    rules: dict = field(default_factory=dict)  # name -> Rule
