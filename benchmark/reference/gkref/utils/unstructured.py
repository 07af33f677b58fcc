"""Helpers over "unstructured" Kubernetes objects (plain dict/list/scalar trees).

The reference manipulates ``unstructured.Unstructured`` everywhere; our analog is
the raw JSON tree.  These helpers are the host-side utilities shared by the
target handler, mutation system and flattener.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Sequence

import yaml


def deep_get(obj: Any, path: Sequence[str], default: Any = None) -> Any:
    """Walk ``path`` through nested dicts; returns ``default`` on any miss."""
    cur = obj
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def deep_set(obj: dict, path: Sequence[str], value: Any) -> None:
    """Set ``value`` at ``path``, creating intermediate dicts."""
    cur = obj
    for p in path[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[path[-1]] = value


def deep_copy(obj: Any) -> Any:
    return copy.deepcopy(obj)


def load_yaml_objects(text: str) -> list[dict]:
    """Parse a (possibly multi-document) YAML string into object dicts."""
    return [doc for doc in yaml.safe_load_all(text) if doc]


def load_yaml_file(path: str) -> list[dict]:
    with open(path) as f:
        return load_yaml_objects(f.read())


def gvk_of(obj: dict) -> tuple[str, str, str]:
    """(group, version, kind) of an unstructured object.

    ``apiVersion`` is ``group/version`` or bare ``version`` for the core group
    (reference: apimachinery GroupVersionKind semantics).
    """
    api_version = obj.get("apiVersion", "") or ""
    kind = obj.get("kind", "") or ""
    if not isinstance(api_version, str):  # tolerate malformed docs
        api_version = ""
    if not isinstance(kind, str):
        kind = ""
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        group, version = "", api_version
    return group, version, kind


def api_version_of(group: str, version: str) -> str:
    return f"{group}/{version}" if group else version


def name_of(obj: dict) -> str:
    return deep_get(obj, ("metadata", "name"), "") or ""


def namespace_of(obj: dict) -> str:
    return deep_get(obj, ("metadata", "namespace"), "") or ""


def labels_of(obj: dict) -> dict:
    return deep_get(obj, ("metadata", "labels"), {}) or {}


def iter_leaves(obj: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Yield (path-tuple, scalar) pairs over the whole tree.

    List indices appear as ints in the path.  Used by the flattener and by
    differential tests.
    """
    if isinstance(obj, dict):
        if not obj:
            yield prefix, obj
        for k, v in obj.items():
            yield from iter_leaves(v, prefix + (k,))
    elif isinstance(obj, list):
        if not obj:
            yield prefix, obj
        for i, v in enumerate(obj):
            yield from iter_leaves(v, prefix + (i,))
    else:
        yield prefix, obj
