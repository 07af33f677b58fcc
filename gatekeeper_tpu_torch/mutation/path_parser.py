"""Location-path DSL parser.

Reference grammar (pkg/mutation/path/token + path/parser):
    spec.containers[name: foo].securityContext
    spec.containers[name: *].image
    metadata.labels."dotted.key"
Object nodes are field names (quotable with single/double quotes, escapes
allowed); list nodes are ``[keyField: keyValue]`` where keyValue ``*`` globs
every item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


class PathParseError(ValueError):
    pass


@dataclass(frozen=True)
class ObjectNode:
    name: str


@dataclass(frozen=True)
class ListNode:
    key_field: str
    key_value: Union[str, int, None]  # None = glob (*)

    @property
    def glob(self) -> bool:
        return self.key_value is None


def parse(path: str):
    """Parse a location string into a list of nodes."""
    nodes = []
    i, n = 0, len(path)

    def read_ident(i):
        if i < n and path[i] in "\"'":
            quote = path[i]
            i += 1
            buf = []
            while i < n and path[i] != quote:
                if path[i] == "\\" and i + 1 < n:
                    buf.append(path[i + 1])
                    i += 2
                else:
                    buf.append(path[i])
                    i += 1
            if i >= n:
                raise PathParseError(f"unterminated quote in {path!r}")
            return "".join(buf), i + 1
        buf = []
        while i < n and path[i] not in ".[]:":
            if path[i] == "\\" and i + 1 < n:
                buf.append(path[i + 1])
                i += 2
            else:
                buf.append(path[i])
                i += 1
        if not buf:
            raise PathParseError(f"empty path segment in {path!r} at {i}")
        return "".join(buf), i

    while i < n:
        name, i = read_ident(i)
        nodes.append(ObjectNode(name.strip()))
        # optional list spec(s)
        while i < n and path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                raise PathParseError(f"unterminated [ in {path!r}")
            inner = path[i + 1 : j]
            if ":" not in inner:
                raise PathParseError(
                    f"list spec must be [key: value] in {path!r}"
                )
            key, _, val = inner.partition(":")
            key = key.strip().strip("\"'")
            val = val.strip()
            if val == "*":
                nodes.append(ListNode(key_field=key, key_value=None))
            else:
                val = val.strip("\"'")
                nodes.append(ListNode(key_field=key, key_value=val))
            i = j + 1
        if i < n:
            if path[i] != ".":
                raise PathParseError(
                    f"expected '.' at offset {i} in {path!r}"
                )
            i += 1
            if i >= n:
                raise PathParseError(f"trailing '.' in {path!r}")
    if not nodes:
        raise PathParseError("empty path")
    return nodes


def to_string(nodes) -> str:
    out = []
    for node in nodes:
        if isinstance(node, ObjectNode):
            if out:
                out.append(".")
            name = node.name
            if any(c in name for c in ".[]:\"'"):
                name = '"%s"' % name.replace('"', '\\"')
            out.append(name)
        else:
            v = "*" if node.glob else node.key_value
            out.append(f"[{node.key_field}: {v}]")
    return "".join(out)
