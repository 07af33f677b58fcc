"""Response types of the constraint-framework client.

Reference surface (SURVEY.md §2.8): ``types.Responses{ByTarget, StatsEntries}``,
``types.Result{Target, Msg, Constraint, Metadata, EnforcementAction,
ScopedEnforcementActions}``, ``instrumentation.StatsEntry``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Result:
    target: str
    msg: str
    constraint: dict  # raw constraint object
    metadata: dict = field(default_factory=dict)  # {"details": ...}
    enforcement_action: str = "deny"
    scoped_enforcement_actions: list = field(default_factory=list)

    @property
    def details(self) -> Any:
        return self.metadata.get("details")


@dataclass
class Stat:
    name: str
    value: Any
    source: dict = field(default_factory=dict)  # {type, value}


@dataclass
class StatsEntry:
    scope: str
    stats_for: str
    stats: list = field(default_factory=list)
    labels: list = field(default_factory=list)


@dataclass
class Response:
    target: str
    results: list = field(default_factory=list)  # list[Result]
    trace: Optional[str] = None


@dataclass
class Responses:
    by_target: dict = field(default_factory=dict)  # target -> Response
    stats_entries: list = field(default_factory=list)

    def results(self) -> list:
        out = []
        for target in sorted(self.by_target):
            out.extend(self.by_target[target].results)
        return out

    def trace_dump(self) -> str:
        chunks = []
        for target in sorted(self.by_target):
            resp = self.by_target[target]
            if resp.trace:
                chunks.append(f"target: {target}\n{resp.trace}")
        return "\n\n".join(chunks)


@dataclass
class QueryResponse:
    """What a Driver.query returns (reference: drivers.QueryResponse,
    mirrored at pkg/drivers/k8scel/driver.go:250)."""

    results: list = field(default_factory=list)
    stats_entries: list = field(default_factory=list)
    trace: Optional[str] = None
