"""Review types: AdmissionRequest-shaped review + augmented wrappers.

Reference: pkg/target/review.go (gkReview embeds AdmissionRequest + private
namespace/source/isAdmission) and k8s admission/v1 AdmissionRequest fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from gkref.utils.unstructured import gvk_of

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"
CONNECT = "CONNECT"


@dataclass
class AdmissionRequest:
    """Subset of k8s.io/api/admission/v1 AdmissionRequest as a plain record."""

    uid: str = ""
    kind: dict = field(default_factory=dict)  # {group, version, kind}
    resource: dict = field(default_factory=dict)
    sub_resource: str = ""
    name: str = ""
    namespace: str = ""
    operation: str = ""
    user_info: dict = field(default_factory=dict)
    object: Optional[dict] = None
    old_object: Optional[dict] = None
    dry_run: bool = False
    options: Optional[dict] = None

    def to_review_doc(self, namespace_object: Optional[dict]) -> dict:
        """The ``input.review`` document templates see.

        Mirrors JSON marshaling of gkReview (AdmissionRequest JSON tags) plus
        the framework-injected ``namespaceObject``
        (reference contract: test/bats/tests/templates/
        k8snamespacelabelcheck_template_rego.yaml:28-37).
        """
        doc: dict[str, Any] = {
            "uid": self.uid,
            "kind": self.kind,
            "resource": self.resource,
            "name": self.name,
            "namespace": self.namespace,
            "operation": self.operation,
            "userInfo": self.user_info,
            "object": self.object,
            "oldObject": self.old_object,
            "dryRun": self.dry_run,
        }
        if self.sub_resource:
            doc["subResource"] = self.sub_resource
        if self.options is not None:
            doc["options"] = self.options
        if namespace_object is not None:
            doc["namespaceObject"] = namespace_object
        return doc


@dataclass
class GkReview:
    """The normalized review every driver sees (reference: target/review.go)."""

    request: AdmissionRequest
    namespace: Optional[dict] = None  # the Namespace *object*
    source: str = ""
    is_admission: bool = False

    def get_admission_request(self) -> AdmissionRequest:
        return self.request


@dataclass
class AugmentedReview:
    """An AdmissionRequest plus its resolved namespace object
    (reference: target/review.go AugmentedReview)."""

    admission_request: AdmissionRequest
    namespace: Optional[dict] = None
    source: str = ""
    is_admission: bool = False


@dataclass
class AugmentedUnstructured:
    """A bare object plus namespace — audit/gator input shape
    (reference: target/review.go AugmentedUnstructured)."""

    object: dict
    namespace: Optional[dict] = None
    source: str = ""
    operation: str = ""


class RequestObjectError(Exception):
    """Reference: ErrRequestObject / ErrOldObjectIsNil."""


def unstructured_to_admission_request(obj: dict) -> AdmissionRequest:
    """Reference: target.go:159-179 (unstructuredToAdmissionRequest)."""
    group, version, kind = gvk_of(obj)
    return AdmissionRequest(
        kind={"group": group, "version": version, "kind": kind},
        object=obj,
        name=(obj.get("metadata") or {}).get("name", "") or "",
        namespace=(obj.get("metadata") or {}).get("namespace", "") or "",
    )
