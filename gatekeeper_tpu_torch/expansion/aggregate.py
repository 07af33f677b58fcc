"""Expansion result aggregation (reference: pkg/expansion/aggregate.go).

Resultant violations fold into the parent object's responses with an
``[Implied by <template>]`` message prefix; the expansion template may override
the enforcement action of resultant violations.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.client.types import Responses

CHILD_MSG_PREFIX = "[Implied by %s]"


def override_enforcement_action(action: str, responses: Responses) -> None:
    """Reference: aggregate.go:46 — apply template's enforcementAction
    override to every resultant result."""
    if not action:
        return
    for resp in responses.by_target.values():
        for result in resp.results:
            result.enforcement_action = action


def aggregate_responses(
    template_name: str, parent: Responses, child: Responses
) -> None:
    """Reference: aggregate.go:19-43 — merge child responses into parent with
    prefixed messages."""
    prefix = CHILD_MSG_PREFIX % template_name
    for target_name, child_resp in child.by_target.items():
        parent_resp = parent.by_target.get(target_name)
        if parent_resp is None:
            parent.by_target[target_name] = child_resp
            parent_resp = child_resp
            for result in child_resp.results:
                result.msg = f"{prefix} {result.msg}"
            continue
        for result in child_resp.results:
            result.msg = f"{prefix} {result.msg}"
            parent_resp.results.append(result)
        if child_resp.trace:
            parent_resp.trace = (
                (parent_resp.trace + "\n" + child_resp.trace)
                if parent_resp.trace
                else child_resp.trace
            )
    parent.stats_entries.extend(child.stats_entries)
