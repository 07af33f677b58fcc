"""Mutating admission handler (reference: pkg/webhook/mutation.go).

Only CREATE/UPDATE are mutated (mutation.go:113); the namespace comes from
a cache with API fallback (mutation.go:162-174); the response carries a
JSONPatch computed from the before/after objects (PatchResponseFromRaw,
mutation.go:214).
"""

from __future__ import annotations

import base64
import copy
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
from gatekeeper_tpu_torch.webhook.policy import parse_admission_review


@dataclass
class MutationResponse:
    allowed: bool = True
    patch: Optional[list] = None  # JSON-patch ops
    message: str = ""
    uid: str = ""
    code: int = 200
    warnings: list = field(default_factory=list)
    # shed under failurePolicy=Fail (batched lane): the server emits an
    # HTTP Retry-After header with this hint (0 = no header)
    retry_after_s: float = 0.0


def json_escape_pointer(seg: str) -> str:
    return seg.replace("~", "~0").replace("/", "~1")


def json_patch(before: Any, after: Any, path: str = "") -> list:
    """Minimal RFC-6902 diff between two JSON trees."""
    if type(before) is not type(after) or not isinstance(
        before, (dict, list)
    ):
        if before is after or (before == after and
                               isinstance(before, bool) ==
                               isinstance(after, bool)):
            return []
        return [{"op": "replace", "path": path or "/", "value": after}]
    if isinstance(before, dict):
        ops = []
        for k in before:
            p = f"{path}/{json_escape_pointer(str(k))}"
            if k not in after:
                ops.append({"op": "remove", "path": p})
            else:
                ops.extend(json_patch(before[k], after[k], p))
        for k in after:
            if k not in before:
                p = f"{path}/{json_escape_pointer(str(k))}"
                ops.append({"op": "add", "path": p, "value": after[k]})
        return ops
    # lists: replace wholesale on any difference (simple + correct; the
    # reference's jsondiff emits finer ops but apply-equivalence is what
    # matters)
    if before != after:
        return [{"op": "replace", "path": path or "/", "value": after}]
    return []


class MutationHandler:
    def __init__(self, mutation_system, namespace_lookup=None,
                 process_excluder=None):
        self.system = mutation_system
        self.namespace_lookup = namespace_lookup or (lambda name: None)
        self.process_excluder = process_excluder

    def handle(self, review_body: dict) -> MutationResponse:
        req = parse_admission_review(review_body)
        if req.operation not in ("CREATE", "UPDATE"):
            return MutationResponse(allowed=True, uid=req.uid)
        if req.object is None:
            return MutationResponse(allowed=True, uid=req.uid)
        if self.process_excluder is not None and req.namespace:
            if self.process_excluder.is_excluded("mutation-webhook",
                                                 req.namespace):
                return MutationResponse(allowed=True, uid=req.uid)
        ns_obj = self.namespace_lookup(req.namespace) if req.namespace else None
        before = req.object
        after = copy.deepcopy(before)
        try:
            self.system.mutate(after, namespace=ns_obj,
                               source=SOURCE_ORIGINAL)
        except Exception as e:
            return MutationResponse(allowed=True, message=str(e), uid=req.uid)
        patch = json_patch(before, after)
        return MutationResponse(allowed=True, patch=patch or None,
                                uid=req.uid)
