"""The four mutator kinds.

Reference (pkg/mutation/mutators):
- **Assign** (assign/assign_mutator.go): arbitrary value at location (outside
  metadata), ``assignIf`` in/notIn gating, pathTests, value sources
  value / fromMetadata / externalData.
- **AssignMetadata** (assignmeta/assignmeta_mutator.go): only
  metadata.labels.* / metadata.annotations.*, string value, never overwrites.
- **ModifySet** (modifyset/modify_set_mutator.go): treat a list as a set;
  merge (append missing) or prune (remove present).
- **AssignImage** (assignimage/assignimage_mutator.go + imageparser.go):
  split an image ref into [domain/]path[:tag|@digest] and override components.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

from gatekeeper_tpu_torch.match.match import Matchable, matches
from gatekeeper_tpu_torch.mutation import path_parser
from gatekeeper_tpu_torch.mutation.core import (
    MutateError,
    PathTester,
    Setter,
    _deep_equal,
    mutate,
)
from gatekeeper_tpu_torch.mutation.path_parser import ListNode, ObjectNode
from gatekeeper_tpu_torch.utils.unstructured import deep_get, gvk_of, name_of

MUTATIONS_GROUP = "mutations.gatekeeper.sh"


class MutatorError(Exception):
    pass


@dataclass(frozen=True)
class MutatorID:
    kind: str
    name: str

    def __str__(self):
        return f"{self.kind}/{self.name}"


class BaseMutator:
    kind = ""

    def __init__(self, obj: dict):
        group, _, kind = gvk_of(obj)
        if group != MUTATIONS_GROUP:
            raise MutatorError(f"mutator group must be {MUTATIONS_GROUP}")
        if kind != self.kind:
            raise MutatorError(f"expected kind {self.kind}, got {kind}")
        name = name_of(obj)
        if not name:
            raise MutatorError("mutator has no metadata.name")
        self.id = MutatorID(kind=kind, name=name)
        self.spec = obj.get("spec") or {}
        self.match_spec = self.spec.get("match") or {}
        self.apply_to = self.spec.get("applyTo") or []
        self.raw = obj
        location = self.spec.get("location", "")
        if not location:
            raise MutatorError(f"{self.id}: missing spec.location")
        self.location = location
        self.path = path_parser.parse(location)
        self.tester = self._build_tester()

    def _build_tester(self) -> PathTester:
        tests = []
        for t in (self.spec.get("parameters") or {}).get("pathTests") or []:
            sub = t.get("subPath", "")
            cond = t.get("condition", "")
            sub_nodes = path_parser.parse(sub)
            if sub_nodes != self.path[: len(sub_nodes)]:
                raise MutatorError(
                    f"{self.id}: pathTest subPath {sub!r} is not a prefix of "
                    f"location"
                )
            tests.append((len(sub_nodes) - 1, cond))
        return PathTester(tests)

    # --- applicability ---------------------------------------------------
    def applies_to(self, obj: dict) -> bool:
        """ApplyTo GVK allowlist — required on mutators
        (reference: match/apply_to.go)."""
        group, version, kind = gvk_of(obj)
        for entry in self.apply_to:
            if (
                group in (entry.get("groups") or [])
                and version in (entry.get("versions") or [])
                and kind in (entry.get("kinds") or [])
            ):
                return True
        return False

    def matches(self, obj: dict, namespace: Optional[dict] = None,
                source: str = "") -> bool:
        if not self.applies_to(obj):
            return False
        return matches(self.match_spec, Matchable(obj=obj, namespace=namespace,
                                                  source=source))

    def mutate_obj(self, obj: dict) -> bool:
        raise NotImplementedError

    def path_schema(self):
        """(depth-keyed node kinds) for conflict detection."""
        return [
            ("list", node.key_field) if isinstance(node, ListNode)
            else ("object", node.name)
            for node in self.path
        ]


# --- Assign ----------------------------------------------------------------


class _AssignSetter(Setter):
    def __init__(self, value: Any, assign_if: dict,
                 placeholder_factory=None):
        self.value = value
        self.assign_if = assign_if or {}
        self.placeholder_factory = placeholder_factory

    def _gate(self, current: Any, exists: bool) -> bool:
        in_list = self.assign_if.get("in")
        not_in = self.assign_if.get("notIn")
        if in_list is not None:
            if not exists or not any(_deep_equal(current, v) for v in in_list):
                return False
        if not_in is not None:
            if exists and any(_deep_equal(current, v) for v in not_in):
                return False
        return True

    def set_value(self, parent, key, current, exists):
        if not self._gate(current, exists):
            return None, False
        if self.placeholder_factory is not None:
            from gatekeeper_tpu_torch.externaldata.placeholders import (
                ExternalDataPlaceholder,
            )

            if isinstance(current, ExternalDataPlaceholder):
                # already placed this iteration round: fixed point
                return None, False
            # external data: the placeholder carries the CURRENT value — for
            # dataSource ValueAtLocation it becomes the provider key
            # (system_external_data.go)
            return self.placeholder_factory(current), True
        return copy.deepcopy(self.value), True


class AssignMutator(BaseMutator):
    kind = "Assign"

    def __init__(self, obj: dict):
        super().__init__(obj)
        if isinstance(self.path[0], ObjectNode) and (
            self.path[0].name == "metadata"
        ):
            # reference: Assign cannot mutate metadata (assign_mutator.go
            # validation) — AssignMetadata owns that subtree
            raise MutatorError(
                f"{self.id}: cannot mutate metadata with Assign"
            )
        params = self.spec.get("parameters") or {}
        assign = params.get("assign") or {}
        if "value" in assign:
            self.value = assign["value"]
            self.from_metadata = None
            self.external = None
        elif "fromMetadata" in assign:
            self.value = None
            self.from_metadata = assign["fromMetadata"].get("field", "")
            self.external = None
        elif "externalData" in assign:
            self.value = None
            self.from_metadata = None
            self.external = assign["externalData"]
        else:
            raise MutatorError(f"{self.id}: assign needs value/fromMetadata/"
                               "externalData")
        self.assign_if = params.get("assignIf") or {}

    def mutate_obj(self, obj: dict) -> bool:
        value = self.value
        if self.from_metadata is not None:
            meta = obj.get("metadata") or {}
            if self.from_metadata == "namespace":
                value = meta.get("namespace", "")
            elif self.from_metadata == "name":
                value = meta.get("name", "")
            else:
                raise MutateError(
                    f"unknown fromMetadata field {self.from_metadata!r}"
                )
        placeholder_factory = None
        if self.external is not None:
            from gatekeeper_tpu_torch.externaldata.placeholders import (
                ExternalDataPlaceholder,
            )

            ext = self.external

            def placeholder_factory(current):
                return ExternalDataPlaceholder(
                    provider=ext.get("provider", ""),
                    data_source=ext.get("dataSource", "ValueAtLocation"),
                    default=ext.get("default"),
                    failure_policy=ext.get("failurePolicy", "Fail"),
                    location=self.location,
                    original_value=current,
                )

        setter = _AssignSetter(value, self.assign_if, placeholder_factory)
        return mutate(obj, self.path, setter, self.tester)


# --- AssignMetadata --------------------------------------------------------


class _AssignMetaSetter(Setter):
    def __init__(self, value: str):
        self.value = value

    def set_value(self, parent, key, current, exists):
        if exists:
            return None, False  # never overwrite (assignmeta_mutator.go)
        return self.value, True


class AssignMetadataMutator(BaseMutator):
    kind = "AssignMetadata"

    def applies_to(self, obj: dict) -> bool:
        # AssignMetadata has no applyTo field — it applies to every GVK
        # (reference: assignmeta has no ApplyTo; see the basic-expansion
        # fixture where demo-annotation-owner carries only match)
        return True

    def __init__(self, obj: dict):
        super().__init__(obj)
        ok = (
            len(self.path) == 3
            and all(isinstance(p, ObjectNode) for p in self.path)
            and self.path[0].name == "metadata"
            and self.path[1].name in ("labels", "annotations")
        )
        if not ok:
            raise MutatorError(
                f"{self.id}: AssignMetadata location must be "
                "metadata.labels.<k> or metadata.annotations.<k>"
            )
        assign = (self.spec.get("parameters") or {}).get("assign") or {}
        value = assign.get("value")
        if not isinstance(value, str):
            raise MutatorError(
                f"{self.id}: AssignMetadata value must be a string"
            )
        self.value = value

    def mutate_obj(self, obj: dict) -> bool:
        return mutate(obj, self.path, _AssignMetaSetter(self.value),
                      self.tester)


# --- ModifySet -------------------------------------------------------------


class _ModifySetSetter(Setter):
    def __init__(self, values: list, operation: str):
        self.values = values
        self.operation = operation

    def set_value(self, parent, key, current, exists):
        if self.operation == "merge":
            base = list(current) if isinstance(current, list) else []
            out = list(base)
            for v in self.values:
                if not any(_deep_equal(v, e) for e in out):
                    out.append(copy.deepcopy(v))
            return out, True
        if self.operation == "prune":
            if not exists or not isinstance(current, list):
                return None, False
            out = [e for e in current
                   if not any(_deep_equal(v, e) for v in self.values)]
            return out, True
        raise MutateError(f"unknown ModifySet operation {self.operation!r}")


class ModifySetMutator(BaseMutator):
    kind = "ModifySet"

    def __init__(self, obj: dict):
        super().__init__(obj)
        params = self.spec.get("parameters") or {}
        values = (params.get("values") or {}).get("fromList")
        if not isinstance(values, list):
            raise MutatorError(f"{self.id}: parameters.values.fromList "
                               "required")
        self.values = values
        self.operation = params.get("operation", "merge") or "merge"
        if self.operation not in ("merge", "prune"):
            raise MutatorError(
                f"{self.id}: operation must be merge or prune"
            )

    def mutate_obj(self, obj: dict) -> bool:
        return mutate(obj, self.path,
                      _ModifySetSetter(self.values, self.operation),
                      self.tester)


# --- AssignImage -----------------------------------------------------------


def split_image(image: str) -> tuple[str, str, str]:
    """(domain, path, tag) of an image ref
    (reference: assignimage/imageparser.go — domain is the first component
    when it contains '.' or ':' or equals 'localhost'; tag keeps its ':' /
    '@' prefix)."""
    rest = image
    domain = ""
    slash = rest.find("/")
    if slash >= 0:
        first = rest[:slash]
        if "." in first or ":" in first or first == "localhost":
            domain = first
            rest = rest[slash + 1:]
    tag = ""
    at = rest.find("@")
    if at >= 0:
        tag = rest[at:]
        rest = rest[:at]
    else:
        colon = rest.rfind(":")
        if colon >= 0:
            tag = rest[colon:]
            rest = rest[:colon]
    return domain, rest, tag


class _AssignImageSetter(Setter):
    def __init__(self, domain: str, path: str, tag: str):
        self.domain = domain
        self.path = path
        self.tag = tag

    def set_value(self, parent, key, current, exists):
        cur = current if isinstance(current, str) else ""
        domain, pth, tag = split_image(cur)
        domain = self.domain or domain
        pth = self.path or pth
        tag = self.tag or tag
        out = (f"{domain}/" if domain else "") + pth + tag
        return out, True


class AssignImageMutator(BaseMutator):
    kind = "AssignImage"

    def __init__(self, obj: dict):
        super().__init__(obj)
        params = self.spec.get("parameters") or {}
        self.assign_domain = params.get("assignDomain", "") or ""
        self.assign_path = params.get("assignPath", "") or ""
        self.assign_tag = params.get("assignTag", "") or ""
        if not (self.assign_domain or self.assign_path or self.assign_tag):
            raise MutatorError(
                f"{self.id}: at least one of assignDomain/assignPath/"
                "assignTag required"
            )
        if self.assign_tag and self.assign_tag[0] not in ":@":
            raise MutatorError(
                f"{self.id}: assignTag must start with ':' or '@'"
            )

    def mutate_obj(self, obj: dict) -> bool:
        setter = _AssignImageSetter(self.assign_domain, self.assign_path,
                                    self.assign_tag)
        return mutate(obj, self.path, setter, self.tester)


MUTATOR_KINDS = {
    "Assign": AssignMutator,
    "AssignMetadata": AssignMetadataMutator,
    "ModifySet": ModifySetMutator,
    "AssignImage": AssignImageMutator,
}


def from_unstructured(obj: dict) -> BaseMutator:
    _, _, kind = gvk_of(obj)
    cls = MUTATOR_KINDS.get(kind)
    if cls is None:
        raise MutatorError(f"unknown mutator kind {kind!r}")
    return cls(obj)
