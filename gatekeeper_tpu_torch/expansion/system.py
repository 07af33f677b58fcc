"""Expansion system: generator resources imply their children.

Reference: pkg/expansion/system.go — ExpansionTemplates map a generator GVK
(e.g. apps/v1 Deployment) to a source subtree (``spec.template``) and a
generated GVK (v1 Pod); Expand extracts the subtree, stamps GVK/namespace/
mock name/owner-ref, recursively expands resultants (depth cap 30) and runs
the mutation system over each with Source=Generated.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

from gatekeeper_tpu_torch.utils.unstructured import deep_get, gvk_of, name_of

MAX_RECURSION_DEPTH = 30  # reference: system.go:27-30

EXPANSION_GROUP = "expansion.gatekeeper.sh"


class ExpansionError(Exception):
    pass


@dataclass
class ExpansionTemplate:
    name: str
    apply_to: list
    template_source: str
    generated_gvk: dict  # {group, version, kind}
    enforcement_action: str = ""
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_unstructured(obj: dict) -> "ExpansionTemplate":
        group, _, kind = gvk_of(obj)
        if kind != "ExpansionTemplate" or group != EXPANSION_GROUP:
            raise ExpansionError(f"not an ExpansionTemplate: {group}/{kind}")
        name = name_of(obj)
        if not name:
            raise ExpansionError("ExpansionTemplate has no metadata.name")
        spec = obj.get("spec") or {}
        source = spec.get("templateSource", "") or ""
        if not source:
            raise ExpansionError(f"template {name}: no templateSource")
        gvk = spec.get("generatedGVK") or {}
        if not gvk.get("kind") or not gvk.get("version"):
            raise ExpansionError(f"template {name}: empty generatedGVK")
        return ExpansionTemplate(
            name=name,
            apply_to=spec.get("applyTo") or [],
            template_source=source,
            generated_gvk=gvk,
            enforcement_action=spec.get("enforcementAction", "") or "",
            raw=obj,
        )

    def applies_to(self, obj: dict) -> bool:
        group, version, kind = gvk_of(obj)
        for entry in self.apply_to:
            if (
                group in (entry.get("groups") or [])
                and version in (entry.get("versions") or [])
                and kind in (entry.get("kinds") or [])
            ):
                return True
        return False


@dataclass
class Resultant:
    obj: dict
    template_name: str
    enforcement_action: str = ""


class ExpansionSystem:
    def __init__(self, mutation_system=None):
        self._templates: dict[str, ExpansionTemplate] = {}
        self.mutation_system = mutation_system

    def upsert_template(self, obj_or_template) -> ExpansionTemplate:
        t = (obj_or_template if isinstance(obj_or_template, ExpansionTemplate)
             else ExpansionTemplate.from_unstructured(obj_or_template))
        self._templates[t.name] = t
        return t

    def remove_template(self, name: str) -> None:
        self._templates.pop(name, None)

    def templates(self) -> list:
        return [self._templates[k] for k in sorted(self._templates)]

    def get_conflicts(self) -> list:
        """Templates whose generated GVK is also a generator for another
        template of the same GVK chain are legal (recursive expansion);
        conflicting = two templates for the same generator with the same
        generated GVK (reference: GetConflicts system.go:81)."""
        seen: dict = {}
        conflicts = []
        for t in self.templates():
            for entry in t.apply_to:
                for g in entry.get("groups") or []:
                    for v in entry.get("versions") or []:
                        for k in entry.get("kinds") or []:
                            key = (g, v, k, t.generated_gvk.get("group", ""),
                                   t.generated_gvk.get("version", ""),
                                   t.generated_gvk.get("kind", ""))
                            if key in seen and seen[key] != t.name:
                                conflicts.append((seen[key], t.name))
                            seen[key] = t.name
        return conflicts

    # --- Expand (reference: system.go:137-210) ---------------------------
    def expand(self, base: dict, namespace: Optional[dict] = None,
               username: str = "", source: str = "") -> list:
        resultants: list[Resultant] = []
        self._expand_recursive(base, namespace, username, source,
                               resultants, 0)
        return resultants

    def _expand_recursive(self, base, namespace, username, source, out,
                          depth):
        if depth >= MAX_RECURSION_DEPTH:
            raise ExpansionError(
                f"maximum recursion depth of {MAX_RECURSION_DEPTH} reached"
            )
        res = self._expand_one(base, namespace, username)
        for r in res:
            self._expand_recursive(r.obj, namespace, username, source, out,
                                   depth + 1)
        out.extend(res)

    def _expand_one(self, base: dict, namespace, username) -> list:
        group, version, kind = gvk_of(base)
        if not kind or not version:
            raise ExpansionError(
                f"cannot expand resource {name_of(base)} with empty GVK"
            )
        out = []
        for t in self.templates():
            if not t.applies_to(base):
                continue
            out.append(Resultant(
                obj=self._expand_resource(base, namespace, t),
                template_name=t.name,
                enforcement_action=t.enforcement_action,
            ))
        if self.mutation_system is not None:
            from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED

            for r in out:
                self.mutation_system.mutate(
                    r.obj, namespace=namespace, source=SOURCE_GENERATED
                )
        return out

    @staticmethod
    def _expand_resource(obj: dict, namespace, template) -> dict:
        """Reference: expandResource (system.go:215-254)."""
        src_path = tuple(template.template_source.split("."))
        src = deep_get(obj, src_path)
        if not isinstance(src, dict):
            raise ExpansionError(
                f"could not find source field {template.template_source!r} "
                f"in resource {name_of(obj)}"
            )
        resource = copy.deepcopy(src)
        gvk = template.generated_gvk
        group, version, kind = (gvk.get("group", ""), gvk.get("version", ""),
                                gvk.get("kind", ""))
        resource["apiVersion"] = f"{group}/{version}" if group else version
        resource["kind"] = kind
        meta = resource.setdefault("metadata", {})
        if namespace is not None:
            ns_name = deep_get(namespace, ("metadata", "name"), "") or ""
            if ns_name:
                meta["namespace"] = ns_name
            else:
                meta.pop("namespace", None)
        else:
            parent_ns = deep_get(obj, ("metadata", "namespace"))
            if parent_ns:
                meta["namespace"] = parent_ns
        # mock name: "<generator name>-<kind>", lowercased (system.go:289-299)
        mock = name_of(obj)
        if kind:
            mock += "-"
        mock += kind
        meta["name"] = mock.lower()
        _ensure_owner_reference(resource, obj)
        return resource


def _ensure_owner_reference(resultant: dict, parent: dict) -> None:
    """Reference: ensureOwnerReference (system.go:257-286)."""
    api_version = parent.get("apiVersion", "")
    kind = parent.get("kind", "")
    name = name_of(parent)
    if not api_version or not kind or not name:
        return
    meta = resultant.setdefault("metadata", {})
    refs = meta.setdefault("ownerReferences", [])
    for ref in refs:
        if (ref.get("apiVersion") == api_version and ref.get("kind") == kind
                and ref.get("name") == name):
            return
    refs.append({"apiVersion": api_version, "kind": kind, "name": name,
                 "uid": ""})
