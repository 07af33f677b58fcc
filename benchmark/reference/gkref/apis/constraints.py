"""Constraint wrapper + enforcement-action semantics.

Constraints are *dynamic* objects (instances of the CRD a template generates,
group ``constraints.gatekeeper.sh``).  This module wraps the unstructured form
and implements the enforcement-action model of
/root/reference/pkg/util/enforcement_action.go:16-170:

- actions: ``deny`` (default), ``dryrun``, ``warn``, ``scoped``
- ``scoped`` defers to ``spec.scopedEnforcementActions[]``, each entry naming an
  action plus the enforcement points (webhook / audit / gator / vap / ``*``)
  it applies to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from gkref.utils.unstructured import deep_get, gvk_of, labels_of, name_of

CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"

# Enforcement actions (reference: util/enforcement_action.go:16-24).
DENY = "deny"
DRYRUN = "dryrun"
WARN = "warn"
SCOPED = "scoped"
KNOWN_ACTIONS = (DENY, DRYRUN, WARN, SCOPED)

# Enforcement points (reference: util/enforcement_action.go:26-41).
WEBHOOK_EP = "validation.gatekeeper.sh"
AUDIT_EP = "audit.gatekeeper.sh"
GATOR_EP = "gator.gatekeeper.sh"
VAP_EP = "vap.k8s.io"
ALL_EP = "*"
KNOWN_EPS = (WEBHOOK_EP, AUDIT_EP, GATOR_EP, VAP_EP)


class ConstraintError(Exception):
    pass


@dataclass
class Constraint:
    kind: str
    name: str
    match: dict
    parameters: Any
    enforcement_action: str
    scoped_actions: list[dict] = field(default_factory=list)
    labels: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_unstructured(obj: dict) -> "Constraint":
        group, _, kind = gvk_of(obj)
        if group != CONSTRAINTS_GROUP:
            raise ConstraintError(
                f"constraint group must be {CONSTRAINTS_GROUP}, got {group!r}"
            )
        action = deep_get(obj, ("spec", "enforcementAction"), DENY) or DENY
        scoped = deep_get(obj, ("spec", "scopedEnforcementActions"), None)
        if action == SCOPED and not scoped:
            raise ConstraintError(
                "scoped enforcementAction requires spec.scopedEnforcementActions"
            )
        if action != SCOPED and scoped:
            # Reference: scopedEnforcementActions only honored with action scoped
            # (webhook validation, policy.go:443-452).
            raise ConstraintError(
                "spec.scopedEnforcementActions requires enforcementAction: scoped"
            )
        name = name_of(obj)
        if not name:
            raise ConstraintError("constraint has no metadata.name")
        c = Constraint(
            kind=kind,
            name=name,
            match=deep_get(obj, ("spec", "match"), {}) or {},
            parameters=deep_get(obj, ("spec", "parameters"), None),
            enforcement_action=action,
            scoped_actions=list(scoped or []),
            labels=labels_of(obj),
            raw=obj,
        )
        c.validate_actions()
        return c

    def validate_actions(self) -> None:
        # Reference: GetEnforcementAction maps unknown actions to Unrecognized
        # and ValidateScopedEnforcementAction rejects empty/unknown enforcement
        # points (util/enforcement_action.go:43-107).
        if self.enforcement_action not in KNOWN_ACTIONS:
            raise ConstraintError(
                f"unrecognized enforcementAction {self.enforcement_action!r}"
            )
        for entry in self.scoped_actions:
            if entry.get("action") not in (DENY, DRYRUN, WARN):
                raise ConstraintError(
                    f"unrecognized scoped action {entry.get('action')!r}"
                )
            eps = entry.get("enforcementPoints")
            if not eps:
                raise ConstraintError(
                    "scopedEnforcementActions entry has no enforcementPoints"
                )
            for ep in eps:
                ep_name = ep.get("name", "") if isinstance(ep, dict) else str(ep)
                if ep_name != ALL_EP and ep_name not in KNOWN_EPS:
                    raise ConstraintError(
                        f"unrecognized enforcement point {ep_name!r}"
                    )

    def actions_for(self, enforcement_point: str) -> list[str]:
        """Resolve the action list applicable at an enforcement point.

        Reference: util/enforcement_action.go:109-170 (scoped resolution).
        A non-scoped constraint yields its single action at every point; a
        scoped constraint yields the actions whose enforcementPoints include
        the point (or ``*``).
        """
        if self.enforcement_action != SCOPED:
            return [self.enforcement_action]
        out: list[str] = []
        for entry in self.scoped_actions:
            action = entry.get("action", DENY)
            # Missing/empty enforcementPoints = never enabled (reference:
            # enforcementPointEnabled returns false for an empty list).
            eps = entry.get("enforcementPoints") or []
            for ep in eps:
                ep_name = ep.get("name", "") if isinstance(ep, dict) else str(ep)
                if ep_name in (ALL_EP, enforcement_point) and action not in out:
                    out.append(action)
        return out

    def key(self) -> tuple[str, str]:
        return (self.kind, self.name)
