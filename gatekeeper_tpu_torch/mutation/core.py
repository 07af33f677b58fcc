"""Core mutate walk: apply a setter along a parsed location path.

Reference: pkg/mutation/mutators/core/mutation_function.go:26-239 — recursive
walk/update of the unstructured tree, creating missing nodes, keyed-list
match/merge with key-invariance, glob fan-out, and path-test gating
(path/tester: MustExist / MustNotExist at path prefixes).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from gatekeeper_tpu_torch.mutation.path_parser import ListNode, ObjectNode

MUST_EXIST = "MustExist"
MUST_NOT_EXIST = "MustNotExist"


class MutateError(Exception):
    pass


class PathTester:
    """Path-prefix conditions (reference: path/tester/tester.go)."""

    def __init__(self, tests: Sequence[tuple] = ()):  # [(depth, condition)]
        self._by_depth = {}
        for depth, cond in tests:
            self._by_depth[depth] = cond

    def exists_ok(self, depth: int) -> bool:
        """May the walk proceed given the node at ``depth`` exists?"""
        return self._by_depth.get(depth) != MUST_NOT_EXIST

    def missing_ok(self, depth: int) -> bool:
        """May the walk create/continue given the node is missing?"""
        return self._by_depth.get(depth) != MUST_EXIST


class Setter:
    """Terminal-node behavior of a mutator (reference: core/setter.go)."""

    def set_value(self, parent: Any, key: Any, current: Any, exists: bool):
        """Returns (new_value, do_set)."""
        raise NotImplementedError


def mutate(obj: dict, path, setter: Setter,
           tester: Optional[PathTester] = None) -> bool:
    """Apply ``setter`` at ``path`` on ``obj`` in place; returns changed?"""
    tester = tester or PathTester()
    return _mutate(obj, path, 0, setter, tester)


def _mutate(node: Any, path, depth: int, setter: Setter,
            tester: PathTester) -> bool:
    part = path[depth]
    last = depth == len(path) - 1

    if isinstance(part, ObjectNode):
        if not isinstance(node, dict):
            raise MutateError(
                f"expected object at {part.name!r}, got {type(node).__name__}"
            )
        exists = part.name in node
        if exists and not tester.exists_ok(depth):
            return False
        if not exists and not tester.missing_ok(depth):
            return False
        if last:
            current = node.get(part.name)
            new, do_set = setter.set_value(node, part.name, current, exists)
            if do_set:
                if exists and _deep_equal(current, new):
                    return False
                node[part.name] = new
                return True
            return False
        if not exists:
            # create the missing intermediate (object or list, depending on
            # what the next path part needs — mutation_function.go:100-120)
            nxt = path[depth + 1]
            node[part.name] = [] if isinstance(nxt, ListNode) else {}
            changed = _mutate(node[part.name], path, depth + 1, setter, tester)
            if not changed:
                del node[part.name]  # undo speculative creation
            return changed
        return _mutate(node[part.name], path, depth + 1, setter, tester)

    # ListNode
    if not isinstance(node, list):
        raise MutateError(
            f"expected list at [{part.key_field}: ...], got "
            f"{type(node).__name__}"
        )
    changed = False
    matched = False
    for item in node:
        if not isinstance(item, dict):
            continue
        if part.glob or _key_match(item.get(part.key_field), part.key_value):
            matched = True
            if not tester.exists_ok(depth):
                continue
            if last:
                changed |= _set_list_item(node, item, part, setter)
            else:
                changed |= _mutate(item, path, depth + 1, setter, tester)
    if not matched and not part.glob:
        if not tester.missing_ok(depth):
            return False
        # create the keyed item (mutation_function.go keyed-list add)
        item = {part.key_field: _key_value(part)}
        if last:
            new, do_set = setter.set_value(None, None, None, False)
            if do_set:
                if isinstance(new, dict):
                    merged = dict(new)
                    if part.key_field in merged and not _key_match(
                        merged[part.key_field], part.key_value
                    ):
                        raise MutateError(
                            "key conflict: value changes the list key "
                            f"{part.key_field!r}"
                        )
                    merged.setdefault(part.key_field, _key_value(part))
                    node.append(merged)
                    return True
                raise MutateError(
                    "cannot assign non-object to keyed list item"
                )
            return False
        node.append(item)
        sub_changed = _mutate(item, path, depth + 1, setter, tester)
        if not sub_changed:
            node.remove(item)
        return sub_changed
    return changed


def _set_list_item(parent_list, item, part, setter) -> bool:
    new, do_set = setter.set_value(parent_list, item, item, True)
    if not do_set:
        return False
    if not isinstance(new, dict):
        raise MutateError("cannot assign non-object to keyed list item")
    if part.key_field in new and not part.glob and not _key_match(
        new[part.key_field], part.key_value
    ):
        raise MutateError(
            f"key conflict: value changes the list key {part.key_field!r}"
        )
    if _deep_equal(item, new):
        return False
    item.clear()
    item.update(new)
    return True


def _key_value(part: ListNode):
    v = part.key_value
    # numeric keys appear as strings in the DSL; keep string form (the
    # reference compares against the unstructured value with DeepEqual after
    # JSON round-trip, where keys are strings unless the field is numeric)
    return v


def _key_match(actual, expected) -> bool:
    if actual == expected:
        return True
    # numeric key fields: "8080" in the path matches 8080 in the object
    if isinstance(actual, (int, float)) and isinstance(expected, str):
        try:
            return float(expected) == float(actual)
        except ValueError:
            return False
    return False


def _deep_equal(a, b) -> bool:
    """Structural equality distinguishing bool from number (Python's
    True == 1 would otherwise mask real changes)."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _deep_equal(v, b[k]) for k, v in a.items()
        )
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _deep_equal(x, y) for x, y in zip(a, b)
        )
    return a == b
