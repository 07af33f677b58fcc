"""K8sValidationTarget: the single target handler ``admission.k8s.gatekeeper.sh``.

Reference: pkg/target/target.go.  Responsibilities:
- ``process_data``: compute inventory cache paths for referential data
  (["cluster", GV, Kind, name] / ["namespace", ns, GV, Kind, name],
  target.go:60-66)
- ``handle_review``: coerce the 6 accepted input shapes into a ``GkReview``,
  enforcing the DELETE contract (oldObject required, copied onto Object —
  target.go:269-287)
- ``to_matcher``: build a constraint Matcher from ``spec.match``
- a namespace cache for ``namespaceSelector`` matching (target/ns_cache.go)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.match.match import Matchable, matches
from gatekeeper_tpu_torch.target.review import (
    DELETE,
    AdmissionRequest,
    AugmentedReview,
    AugmentedUnstructured,
    GkReview,
    RequestObjectError,
    unstructured_to_admission_request,
)
from gatekeeper_tpu_torch.utils.unstructured import api_version_of, gvk_of

TARGET_NAME = "admission.k8s.gatekeeper.sh"


class WipeData:
    """Sentinel: delete all cached data (reference: target/data.go wipeData)."""


class NamespaceCache:
    """Caches Namespace objects for namespaceSelector matching
    (reference: target/ns_cache.go)."""

    def __init__(self):
        self._namespaces: dict[str, dict] = {}

    def add(self, obj: dict) -> None:
        group, _, kind = gvk_of(obj)
        if kind == "Namespace" and group == "":
            name = (obj.get("metadata") or {}).get("name", "")
            if name:
                self._namespaces[name] = obj

    def remove(self, obj: dict) -> None:
        group, _, kind = gvk_of(obj)
        if kind == "Namespace" and group == "":
            self._namespaces.pop((obj.get("metadata") or {}).get("name", ""), None)

    def get(self, name: str) -> Optional[dict]:
        return self._namespaces.get(name)

    def wipe(self) -> None:
        self._namespaces.clear()


class K8sValidationTarget:
    name = TARGET_NAME

    def __init__(self):
        self.cache = NamespaceCache()

    # --- data plane (reference: target.go:40-80) -----------------------
    def process_data(self, obj: Any):
        """Returns (handled, path, data)."""
        if isinstance(obj, WipeData) or obj is WipeData:
            return True, None, None
        if isinstance(obj, dict):
            group, version, kind = gvk_of(obj)
            meta = obj.get("metadata") or {}
            name = meta.get("name", "") or ""
            if not version:
                raise RequestObjectError(f"resource {name} has no version")
            if not kind:
                raise RequestObjectError(f"resource {name} has no kind")
            gv = api_version_of(group, version)
            ns = meta.get("namespace", "") or ""
            if ns == "":
                path = ["cluster", gv, kind, name]
            else:
                path = ["namespace", ns, gv, kind, name]
            return True, path, obj
        return False, None, None

    # --- review plane (reference: target.go:82-138) --------------------
    def handle_review(self, obj: Any) -> Optional[GkReview]:
        review: Optional[GkReview] = None
        if isinstance(obj, AdmissionRequest):
            review = GkReview(request=obj)
        elif isinstance(obj, GkReview):
            review = obj
        elif isinstance(obj, AugmentedReview):
            review = GkReview(
                request=obj.admission_request,
                namespace=obj.namespace,
                source=obj.source,
                is_admission=obj.is_admission,
            )
        elif isinstance(obj, AugmentedUnstructured):
            req = unstructured_to_admission_request(obj.object)
            review = GkReview(request=req, namespace=obj.namespace,
                              source=obj.source)
            if obj.operation:
                req.operation = obj.operation
            if obj.operation == DELETE:
                req.old_object = req.object
                req.object = None
        elif isinstance(obj, dict):
            review = GkReview(request=unstructured_to_admission_request(obj))
        else:
            return None
        self._set_object_on_delete(review)
        return review

    @staticmethod
    def _set_object_on_delete(review: GkReview) -> None:
        """DELETE contract (reference: target.go:269-287)."""
        if review.request.operation == DELETE:
            if review.request.old_object is None:
                raise RequestObjectError(
                    "oldObject cannot be nil for DELETE operations"
                )
            review.request.object = review.request.old_object

    # --- matcher (reference: target/matcher.go) ------------------------
    def to_matcher(self, match_spec: Optional[dict]) -> "Matcher":
        return Matcher(match_spec, self.cache)


class Matcher:
    """Constraint matcher over GkReviews (reference: target/matcher.go:21-70)."""

    def __init__(self, match_spec: Optional[dict], cache: NamespaceCache):
        self.match_spec = match_spec
        self.cache = cache

    def match(self, review: GkReview) -> bool:
        if not self.match_spec:
            return True
        req = review.request
        ns = review.namespace
        if ns is None and req.namespace:
            ns = self.cache.get(req.namespace)
        objs = [o for o in (req.object, req.old_object) if o is not None]
        if not objs:
            raise RequestObjectError("neither object nor old object are defined")
        for obj in objs:
            if matches(self.match_spec, Matchable(obj=obj, namespace=ns,
                                                  source=review.source)):
                return True
        return False
