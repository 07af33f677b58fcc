"""The Driver interface — the L1→L0 seam.

Reference: the ``drivers.Driver`` interface mirrored exactly by
pkg/drivers/k8scel/driver.go:70-263 (Name / AddTemplate / RemoveTemplate /
AddConstraint / RemoveConstraint / AddData / RemoveData / Query / Dump /
GetDescriptionForStat).  Everything above this seam treats policy evaluation
as opaque; the TPU engine registers here beside the interpreter engine just as
k8scel registers beside rego in the reference (main.go:465-485).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Protocol, Sequence

from gkref.apis.constraints import Constraint
from gkref.apis.templates import ConstraintTemplate
from gkref.client.types import QueryResponse
from gkref.target.review import GkReview


@dataclass
class ReviewCfg:
    """Per-review options (reference: reviews.ReviewCfg, k8scel/driver.go:163)."""

    enforcement_point: str = ""
    tracing: bool = False
    stats: bool = False


class Driver(Protocol):
    def name(self) -> str: ...

    def add_template(self, template: ConstraintTemplate) -> None: ...

    def remove_template(self, template_kind: str) -> None: ...

    def add_constraint(self, constraint: Constraint) -> None: ...

    def remove_constraint(self, constraint: Constraint) -> None: ...

    def add_data(self, target: str, path: Sequence[str], data: Any) -> None: ...

    def remove_data(self, target: str, path: Sequence[str]) -> None: ...

    def query(
        self,
        target: str,
        constraints: Sequence[Constraint],
        review: GkReview,
        cfg: Optional[ReviewCfg] = None,
    ) -> QueryResponse: ...

    def dump(self) -> dict: ...

    def get_description_for_stat(self, stat_name: str) -> str: ...
