"""Namespace-label webhook (reference: pkg/webhook/namespacelabel.go).

Blocks namespaces from self-exempting with the
``admission.gatekeeper.sh/ignore`` label; namespaces whose NAME is on the
exemption lists (--exempt-namespace / -prefix / -suffix) may
(namespacelabel.go:28-30,63-66).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

IGNORE_LABEL = "admission.gatekeeper.sh/ignore"


@dataclass
class LabelResponse:
    allowed: bool
    message: str = ""
    code: int = 200
    uid: str = ""


class NamespaceLabelHandler:
    def __init__(self, exempt_namespaces: Iterable[str] = (),
                 exempt_prefixes: Iterable[str] = (),
                 exempt_suffixes: Iterable[str] = ()):
        self.exempt_namespaces = set(exempt_namespaces)
        self.exempt_prefixes = tuple(exempt_prefixes)
        self.exempt_suffixes = tuple(exempt_suffixes)

    def handle(self, review_body: dict) -> LabelResponse:
        req = parse_admission_review(review_body)
        if req.operation == "DELETE":
            return LabelResponse(allowed=True, uid=req.uid)
        kind = req.kind or {}
        if kind.get("group", "") or kind.get("kind", "") != "Namespace":
            return LabelResponse(allowed=True, uid=req.uid)
        obj = req.object or {}
        name = (obj.get("metadata") or {}).get("name", "")
        if (
            name in self.exempt_namespaces
            or any(name.startswith(p) for p in self.exempt_prefixes)
            or any(name.endswith(s) for s in self.exempt_suffixes)
        ):
            return LabelResponse(allowed=True, uid=req.uid)
        labels = (obj.get("metadata") or {}).get("labels") or {}
        if IGNORE_LABEL in labels:
            return LabelResponse(
                allowed=False,
                code=403,
                message=(
                    f"Only exempt namespace can have the {IGNORE_LABEL} label"
                ),
                uid=req.uid,
            )
        return LabelResponse(allowed=True, uid=req.uid)
