"""ConstraintTemplate API types.

Reference shape: /root/reference/apis/templates/v1beta1 (ConstraintTemplate CRD):
``spec.crd.spec.names.kind`` names the generated constraint kind,
``spec.crd.spec.validation.openAPIV3Schema`` schemas the ``parameters`` field,
``spec.targets[]`` carries per-target policy source — legacy ``rego`` (+``libs``)
or the multi-engine ``code: [{engine, source}]`` list (v1beta1 types; consumed at
/root/reference/pkg/webhook/policy.go:419-427).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from gkref.utils.unstructured import deep_get

# Engine names (reference: "Rego" legacy field; k8scel engine name
# "K8sNativeValidation" in pkg/drivers/k8scel/schema/schema.go).
ENGINE_REGO = "Rego"
ENGINE_CEL = "K8sNativeValidation"


@dataclass
class CodeEntry:
    engine: str
    source: Any  # engine-specific blob


@dataclass
class TemplateTarget:
    target: str
    rego: str = ""
    libs: list[str] = field(default_factory=list)
    code: list[CodeEntry] = field(default_factory=list)

    def source_for(self, engine: str) -> Optional[Any]:
        for entry in self.code:
            if entry.engine == engine:
                return entry.source
        if engine == ENGINE_REGO and self.rego:
            return {"rego": self.rego, "libs": self.libs}
        return None


class TemplateError(Exception):
    """Invalid ConstraintTemplate (reference: webhook template validation,
    pkg/webhook/policy.go:359-401)."""


@dataclass
class ConstraintTemplate:
    name: str
    kind: str  # generated constraint kind, e.g. K8sRequiredLabels
    targets: list[TemplateTarget]
    parameters_schema: Optional[dict] = None
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_unstructured(obj: dict) -> "ConstraintTemplate":
        if obj.get("kind") != "ConstraintTemplate":
            raise TemplateError(f"not a ConstraintTemplate: kind={obj.get('kind')!r}")
        api_version = obj.get("apiVersion", "") or ""
        if not api_version.startswith("templates.gatekeeper.sh/"):
            raise TemplateError(
                f"template group must be templates.gatekeeper.sh, got {api_version!r}"
            )
        name = deep_get(obj, ("metadata", "name"), "")
        if not name:
            raise TemplateError("template has no metadata.name")
        kind = deep_get(obj, ("spec", "crd", "spec", "names", "kind"), "")
        if not kind:
            raise TemplateError(f"template {name}: missing spec.crd.spec.names.kind")
        # Reference requires the template name to equal the lowercased kind
        # (framework CreateCRD validation).
        if name != kind.lower():
            raise TemplateError(
                f"template name {name!r} must be the lowercase of kind {kind!r}"
            )
        schema = deep_get(
            obj, ("spec", "crd", "spec", "validation", "openAPIV3Schema"), None
        )
        targets = []
        for t in deep_get(obj, ("spec", "targets"), []) or []:
            code = [
                CodeEntry(engine=c.get("engine", ""), source=c.get("source"))
                for c in t.get("code", []) or []
            ]
            targets.append(
                TemplateTarget(
                    target=t.get("target", ""),
                    rego=t.get("rego", "") or "",
                    libs=list(t.get("libs", []) or []),
                    code=code,
                )
            )
        if not targets:
            raise TemplateError(f"template {name}: no targets")
        if len(targets) > 1:
            raise TemplateError(f"template {name}: multiple targets unsupported")
        return ConstraintTemplate(
            name=name,
            kind=kind,
            targets=targets,
            parameters_schema=schema,
            labels=deep_get(obj, ("metadata", "labels"), {}) or {},
            annotations=deep_get(obj, ("metadata", "annotations"), {}) or {},
            raw=obj,
        )

    def constraint_crd(self) -> dict:
        """Synthesize the constraint CRD for this template.

        Reference: framework ``Client.CreateCRD`` builds a CRD under group
        ``constraints.gatekeeper.sh`` with the template's kind and the
        parameters schema nested under ``spec.parameters`` plus the shared
        ``spec.match`` schema (pkg/target/matchcrd_constant.go).
        """
        params = self.parameters_schema or {"type": "object"}
        return {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": f"{self.name}.constraints.gatekeeper.sh"},
            "spec": {
                "group": "constraints.gatekeeper.sh",
                "names": {"kind": self.kind, "listKind": self.kind + "List",
                          "plural": self.name, "singular": self.name},
                "scope": "Cluster",
                "versions": [
                    {
                        "name": "v1beta1",
                        "served": True,
                        "storage": True,
                        "schema": {
                            "openAPIV3Schema": {
                                "type": "object",
                                "properties": {
                                    "spec": {
                                        "type": "object",
                                        "properties": {
                                            "match": {"type": "object"},
                                            "parameters": params,
                                            "enforcementAction": {"type": "string"},
                                            "scopedEnforcementActions": {
                                                "type": "array"
                                            },
                                        },
                                    },
                                    "status": {"type": "object"},
                                },
                            }
                        },
                    }
                ],
            },
        }
