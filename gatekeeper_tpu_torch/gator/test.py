"""gator test: in-memory full pipeline without a cluster.

Reference: pkg/gator/test/test.go:33-176 — build a client, add all templates,
then all constraints, then all objects as data; review every object (plus its
expansion resultants) at the gator enforcement point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.apis.constraints import GATOR_EP
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.types import Responses, Result
from gatekeeper_tpu_torch.gator import reader
from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED, SOURCE_ORIGINAL
from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
from gatekeeper_tpu_torch.target.target import K8sValidationTarget
from gatekeeper_tpu_torch.utils.unstructured import gvk_of


@dataclass
class GatorResult(Result):
    violating_object: Optional[dict] = None


@dataclass
class GatorResponse:
    target: str = ""
    results: list = field(default_factory=list)
    trace: Optional[str] = None


@dataclass
class GatorResponses:
    by_target: dict = field(default_factory=dict)
    stats_entries: list = field(default_factory=list)

    def results(self) -> list:
        out = []
        for target in sorted(self.by_target):
            resp = self.by_target[target]
            for r in resp.results:
                r.target = target
            out.extend(resp.results)
        return out


def _default_client(include_cel: bool = True, tracing: bool = False) -> Client:
    from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver

    drivers: list[Any] = [RegoDriver(trace_enabled=tracing)]
    if include_cel:
        try:
            from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver

            drivers.append(CELDriver())
        except ImportError:
            pass
    return Client(
        target=K8sValidationTarget(),
        drivers=drivers,
        enforcement_points=[GATOR_EP],
    )


def test(
    objs: Sequence[dict],
    include_cel: bool = True,
    tracing: bool = False,
    stats: bool = False,
    client: Optional[Client] = None,
) -> GatorResponses:
    """Run the full offline pipeline (reference: gator/test.Test)."""
    client = client or _default_client(include_cel=include_cel, tracing=tracing)

    for obj in objs:
        if reader.is_template(obj):
            client.add_template(obj)
    for obj in objs:
        if reader.is_constraint(obj):
            client.add_constraint(obj)
    for obj in objs:
        if not reader.is_admission_review(obj):
            client.add_data(obj)

    from gatekeeper_tpu_torch.expansion.expander import Expander

    expander = Expander(objs)

    responses = GatorResponses()

    def fold_review(review, obj):
        """Fold one client review into the aggregate response set — the
        single copy shared by the bare-object and AdmissionReview
        paths (results, traces, stats)."""
        for target_name, resp in review.by_target.items():
            t_resp = responses.by_target.setdefault(
                target_name, GatorResponse(target=target_name)
            )
            for r in resp.results:
                t_resp.results.append(
                    GatorResult(
                        target=r.target,
                        msg=r.msg,
                        constraint=r.constraint,
                        metadata=r.metadata,
                        enforcement_action=r.enforcement_action,
                        scoped_enforcement_actions=r.scoped_enforcement_actions,
                        violating_object=obj,
                    )
                )
            if resp.trace:
                t_resp.trace = (
                    (t_resp.trace + "\n\n" + resp.trace) if t_resp.trace
                    else resp.trace
                )
        responses.stats_entries.extend(review.stats_entries)

    from gatekeeper_tpu_torch.expansion import aggregate

    def review_resultants(source_obj, ns, review):
        """Expand a (bare or request-embedded) object and aggregate its
        resultants' reviews — the reference expands EVERY reviewed object
        (test.go:125), including ones arriving inside AdmissionReview
        fixtures."""
        for resultant in expander.expand(source_obj):
            r_au = AugmentedUnstructured(
                object=resultant.obj, namespace=ns, source=SOURCE_GENERATED
            )
            r_review = client.review(
                r_au, enforcement_point=GATOR_EP, tracing=tracing,
                stats=stats
            )
            aggregate.override_enforcement_action(
                resultant.enforcement_action, r_review
            )
            aggregate.aggregate_responses(
                resultant.template_name, review, r_review
            )

    for obj in objs:
        if reader.is_admission_review(obj):
            # review the embedded AdmissionRequest (operation, oldObject,
            # userInfo — the webhook's view), with the namespace resolved
            # from the fixture set exactly like the bare-object path;
            # the embedded object then expands like any other (implied
            # workload resultants reviewed as Source=Generated)
            from gatekeeper_tpu_torch.target.review import AugmentedReview
            from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

            req = parse_admission_review(obj)
            ns = expander.namespace_for(req.object or req.old_object or {})
            # snapshot BEFORE the review: the DELETE contract copies
            # oldObject into request.object in place (target.go:269-287
            # analog) and deleted objects must not expand; the deepcopy
            # also keeps the expander's in-place base mutation off the
            # fixture's request body
            import copy

            to_expand = copy.deepcopy(req.object) if req.object else None
            review = client.review(
                AugmentedReview(admission_request=req, namespace=ns,
                                is_admission=True),
                enforcement_point=GATOR_EP, tracing=tracing, stats=stats)
            if to_expand is not None:
                review_resultants(to_expand, ns, review)
            fold_review(review, obj)
            continue
        ns = expander.namespace_for(obj)
        au = AugmentedUnstructured(object=obj, namespace=ns,
                                   source=SOURCE_ORIGINAL)
        review = client.review(
            au, enforcement_point=GATOR_EP, tracing=tracing, stats=stats
        )
        review_resultants(obj, ns, review)
        fold_review(review, obj)
    return responses
