"""Constraint-scope match predicate.

Host-side exact implementation of the reference's 8 ANDed top-level matchers
(pkg/mutation/match/match.go:41-50): kinds, scope, namespaces,
excludedNamespaces, labelSelector, namespaceSelector, name, source.  The TPU
eval plane compiles the same semantics to boolean masks (see
gkref.ir.masks); this module is the oracle those masks are
differential-tested against, and the fallback for odd inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from gkref.match import wildcard
from gkref.utils.unstructured import deep_get, gvk_of

WILDCARD = "*"

# Source types (reference: pkg/mutation/types/mutator.go SourceType).
SOURCE_ALL = "All"
SOURCE_ORIGINAL = "Original"
SOURCE_GENERATED = "Generated"
VALID_SOURCES = (SOURCE_ALL, SOURCE_ORIGINAL, SOURCE_GENERATED)


class MatchError(Exception):
    """Reference: ErrMatch (match.go:16)."""


@dataclass
class Matchable:
    """Object to match + its namespace metadata (match.go:24-28)."""

    obj: dict
    namespace: Optional[dict] = None  # the Namespace *object*
    source: str = ""


def is_namespace(obj: dict) -> bool:
    group, _, kind = gvk_of(obj)
    return kind == "Namespace" and group == ""


def label_selector_matches(selector: dict, labels: dict) -> bool:
    """k8s LabelSelector semantics: matchLabels AND matchExpressions."""
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "")
        values = expr.get("values") or []
        if op == "In":
            if key not in labels or labels[key] not in values:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            raise MatchError(f"invalid labelSelector operator {op!r}")
    return True


def _obj_labels(obj: dict) -> dict:
    return deep_get(obj, ("metadata", "labels"), {}) or {}


def _obj_name(obj: dict) -> str:
    return deep_get(obj, ("metadata", "name"), "") or ""


def _obj_generate_name(obj: dict) -> str:
    return deep_get(obj, ("metadata", "generateName"), "") or ""


def _obj_namespace(obj: dict) -> str:
    return deep_get(obj, ("metadata", "namespace"), "") or ""


def matches(match: dict, target: Matchable) -> bool:
    """All 8 matchers must succeed (reference: match.go:32-65)."""
    if target.obj is None:
        raise MatchError("obj must be non-nil")
    return (
        _kinds_match(match, target)
        and _scope_match(match, target)
        and _namespaces_match(match, target)
        and _excluded_namespaces_match(match, target)
        and _label_selector_match(match, target)
        and _namespace_selector_match(match, target)
        and _names_match(match, target)
        and _source_match(match, target)
    )


def _kinds_match(match: dict, target: Matchable) -> bool:
    kinds = match.get("kinds") or []
    if not kinds:
        return True
    group, _, kind = gvk_of(target.obj)
    for kk in kinds:
        klist = kk.get("kinds") or []
        if klist and WILDCARD not in klist and kind not in klist:
            continue
        glist = kk.get("apiGroups") or []
        if not glist or WILDCARD in glist or group in glist:
            return True
    return False


def _scope_match(match: dict, target: Matchable) -> bool:
    scope = match.get("scope", "")
    has_namespace = _obj_namespace(target.obj) != "" or target.namespace is not None
    is_ns = is_namespace(target.obj)
    if scope == "Cluster":
        return is_ns or not has_namespace
    if scope == "Namespaced":
        return not is_ns and has_namespace
    # invalid scopes (typos) match everything, mirroring match.go:223-226
    return True


def _effective_namespace(target: Matchable) -> Optional[str]:
    """Namespace string used by namespaces/excludedNamespaces matchers
    (match.go:125-139): Namespace objects use their own name; otherwise the
    provided Namespace object's name, falling back to metadata.namespace."""
    if is_namespace(target.obj):
        return _obj_name(target.obj)
    if target.namespace is not None:
        return deep_get(target.namespace, ("metadata", "name"), "") or ""
    ns = _obj_namespace(target.obj)
    return ns if ns else None


def _namespaces_match(match: dict, target: Matchable) -> bool:
    patterns = match.get("namespaces") or []
    if not patterns:
        return True
    ns = _effective_namespace(target)
    if ns is None:
        return True  # cluster-scoped non-Namespace: can't disqualify
    return any(wildcard.matches(p, ns) for p in patterns)


def _excluded_namespaces_match(match: dict, target: Matchable) -> bool:
    patterns = match.get("excludedNamespaces") or []
    if not patterns:
        return True
    ns = _effective_namespace(target)
    if ns is None:
        return True
    return not any(wildcard.matches(p, ns) for p in patterns)


def _label_selector_match(match: dict, target: Matchable) -> bool:
    selector = match.get("labelSelector")
    if selector is None:
        return True
    return label_selector_matches(selector, _obj_labels(target.obj))


def _namespace_selector_match(match: dict, target: Matchable) -> bool:
    selector = match.get("namespaceSelector")
    if selector is None:
        return True
    is_ns = is_namespace(target.obj)
    if not is_ns and target.namespace is None and _obj_namespace(target.obj) == "":
        # Match all non-Namespace cluster-scoped objects (match.go:82-85).
        return True
    if is_ns:
        return label_selector_matches(selector, _obj_labels(target.obj))
    if target.namespace is None:
        raise MatchError(
            "namespace selector for namespace-scoped object but missing Namespace"
        )
    return label_selector_matches(
        selector, deep_get(target.namespace, ("metadata", "labels"), {}) or {}
    )


def _names_match(match: dict, target: Matchable) -> bool:
    name = match.get("name", "") or ""
    if name == "":
        return True
    return wildcard.matches(name, _obj_name(target.obj)) or (
        wildcard.matches_generate_name(name, _obj_generate_name(target.obj))
    )


def _source_match(match: dict, target: Matchable) -> bool:
    msrc = match.get("source", "") or ""
    tsrc = target.source
    if msrc == "":
        msrc = SOURCE_ALL
    elif msrc not in VALID_SOURCES:
        raise MatchError(f"invalid source field {msrc!r}")
    if tsrc == "" and msrc != SOURCE_ALL:
        raise MatchError("source field not specified for resource")
    if msrc == SOURCE_ALL:
        return True
    if tsrc not in VALID_SOURCES:
        raise MatchError(f"invalid source field {tsrc!r}")
    return msrc == tsrc
