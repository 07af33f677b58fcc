"""Constraint-framework client: the L1 multiplexer.

Rebuild of the external module ``frameworks/constraint`` client surface the
reference consumes (SURVEY.md §2.8): templates/constraints are held per
target, each template is compiled by the highest-priority driver that
understands its source (driver priority = registration order, main.go:460-498),
``review`` routes through the target handler, prefilters constraints with the
match predicate, fans out per-engine ``query`` calls and merges responses.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

from gkref.apis.constraints import Constraint, ConstraintError
from gkref.apis.templates import ConstraintTemplate, TemplateError
from gkref.client.types import QueryResponse, Response, Responses
from gkref.drivers.base import ReviewCfg
from gkref.match.match import label_selector_matches
from gkref.target.target import K8sValidationTarget, WipeData


class ClientError(Exception):
    pass


class Client:
    def __init__(
        self,
        target: Optional[K8sValidationTarget] = None,
        drivers: Sequence[Any] = (),
        enforcement_points: Sequence[str] = (),
    ):
        if not drivers:
            raise ClientError("at least one driver is required")
        self.target = target or K8sValidationTarget()
        self.drivers = list(drivers)
        self.enforcement_points = list(enforcement_points)
        self._templates: dict[str, ConstraintTemplate] = {}  # by kind
        self._template_driver: dict[str, Any] = {}  # kind -> driver
        self._constraints: dict[str, dict[str, Constraint]] = {}  # kind -> name -> c

    # --- templates ----------------------------------------------------
    def create_crd(self, template_obj: dict) -> dict:
        """Validate a template and synthesize its constraint CRD without
        installing (reference: Client.CreateCRD, used for webhook dry-run
        validation at policy.go:430)."""
        template = self._parse_template(template_obj)
        return template.constraint_crd()

    def add_template(self, template_obj: dict) -> dict:
        """Compile + install a template; returns the generated constraint CRD.

        Reference: Client.AddTemplate (controller call site
        constrainttemplate_controller.go:479).
        """
        template = self._parse_template(template_obj)
        driver = self._driver_for(template)
        driver.add_template(template)
        old = self._template_driver.get(template.kind)
        if old is not None and old is not driver:
            old.remove_template(template.kind)
        self._templates[template.kind] = template
        self._template_driver[template.kind] = driver
        self._constraints.setdefault(template.kind, {})
        return template.constraint_crd()

    def remove_template(self, template_obj_or_kind: Any) -> None:
        kind = (
            template_obj_or_kind
            if isinstance(template_obj_or_kind, str)
            else self._parse_template(template_obj_or_kind).kind
        )
        driver = self._template_driver.pop(kind, None)
        if driver is not None:
            driver.remove_template(kind)
        self._templates.pop(kind, None)
        self._constraints.pop(kind, None)

    def get_template(self, kind: str) -> Optional[ConstraintTemplate]:
        return self._templates.get(kind)

    def templates(self) -> list[ConstraintTemplate]:
        return list(self._templates.values())

    def _parse_template(self, obj: Any) -> ConstraintTemplate:
        if isinstance(obj, ConstraintTemplate):
            return obj
        return ConstraintTemplate.from_unstructured(obj)

    def _driver_for(self, template: ConstraintTemplate) -> Any:
        for driver in self.drivers:
            if driver.has_source_for(template):
                return driver
        raise TemplateError(
            f"template {template.name}: no driver understands its source"
        )

    # --- constraints --------------------------------------------------
    def add_constraint(self, constraint_obj: dict) -> Constraint:
        constraint = Constraint.from_unstructured(constraint_obj)
        if constraint.kind not in self._templates:
            raise ClientError(
                f"no template registered for constraint kind {constraint.kind}"
            )
        self.validate_constraint(constraint_obj)
        self._template_driver[constraint.kind].add_constraint(constraint)
        self._constraints[constraint.kind][constraint.name] = constraint
        return constraint

    def remove_constraint(self, constraint_obj: dict) -> None:
        try:
            constraint = Constraint.from_unstructured(constraint_obj)
        except ConstraintError:
            return
        by_name = self._constraints.get(constraint.kind)
        if by_name and constraint.name in by_name:
            self._template_driver[constraint.kind].remove_constraint(constraint)
            del by_name[constraint.name]

    def get_constraint(self, kind: str, name: str) -> Optional[Constraint]:
        return self._constraints.get(kind, {}).get(name)

    def constraints(self) -> list[Constraint]:
        out = []
        for by_name in self._constraints.values():
            out.extend(by_name.values())
        return out

    def validate_constraint(self, constraint_obj: dict) -> None:
        """Reference: Client.ValidateConstraint + target.ValidateConstraint
        (target.go:185-221) — label selector sanity."""
        constraint = Constraint.from_unstructured(constraint_obj)
        constraint.validate_actions()
        for sel_key in ("labelSelector", "namespaceSelector"):
            sel = constraint.match.get(sel_key)
            if sel is not None:
                # surface bad operators early
                label_selector_matches(sel, {})

    # --- data plane ---------------------------------------------------
    def add_data(self, obj: Any) -> None:
        handled, path, data = self.target.process_data(obj)
        if not handled or path is None:
            if isinstance(obj, WipeData) or obj is WipeData:
                for driver in self.drivers:
                    if hasattr(driver, "wipe_data"):
                        driver.wipe_data()
                self.target.cache.wipe()
            return
        if isinstance(obj, dict):
            self.target.cache.add(obj)
        for driver in self.drivers:
            driver.add_data(self.target.name, path, data)

    def remove_data(self, obj: Any) -> None:
        handled, path, _ = self.target.process_data(obj)
        if not handled or path is None:
            return
        if isinstance(obj, dict):
            self.target.cache.remove(obj)
        for driver in self.drivers:
            driver.remove_data(self.target.name, path)

    # --- review (the hot path) ----------------------------------------
    def review(
        self,
        review_obj: Any,
        enforcement_point: str = "",
        tracing: bool = False,
        stats: bool = False,
    ) -> Responses:
        """Reference: Client.Review (webhook policy.go:664, audit
        manager.go:720, gator test.go:118)."""
        review = self.target.handle_review(review_obj)
        if review is None:
            raise ClientError(f"unrecognized review type {type(review_obj)}")
        cfg = ReviewCfg(
            enforcement_point=enforcement_point, tracing=tracing, stats=stats
        )
        responses = Responses()
        response = Response(target=self.target.name)

        # group matching constraints per driver, preserving constraint order
        by_driver: dict[int, tuple[Any, list[Constraint]]] = {}
        for kind in sorted(self._constraints):
            by_name = self._constraints[kind]
            driver = self._template_driver[kind]
            for name in sorted(by_name):
                constraint = by_name[name]
                actions = constraint.actions_for(enforcement_point) if (
                    enforcement_point
                ) else [constraint.enforcement_action]
                if not actions:
                    continue  # scoped constraint inactive at this EP
                if not self.target.to_matcher(constraint.match).match(review):
                    continue
                entry = by_driver.setdefault(id(driver), (driver, []))
                entry[1].append(constraint)

        for driver, constraints in by_driver.values():
            qr: QueryResponse = driver.query(
                self.target.name, constraints, review, cfg
            )
            for result in qr.results:
                constraint = self._constraint_for_result(result)
                if constraint is not None:
                    self._resolve_actions(result, constraint, enforcement_point)
                response.results.append(result)
            responses.stats_entries.extend(qr.stats_entries)
            if qr.trace:
                response.trace = (
                    (response.trace + "\n" + qr.trace) if response.trace else qr.trace
                )
        responses.by_target[self.target.name] = response
        return responses

    def review_batch(
        self,
        review_objs: Sequence[Any],
        enforcement_point: str = "",
        tracing: bool = False,
        stats: bool = False,
    ) -> list:
        """Batched reviews (the webhook microbatch lane / audit-from-cache).

        Returns one entry per input: a ``Responses`` on success or an
        ``Exception`` for that input alone (a bad request must not poison the
        rest of a coalesced webhook batch).  Constraint kinds owned by a
        batch-capable driver evaluate in one ``query_batch`` pass; kinds
        owned by other drivers fan out per-review exactly like ``review``.
        """
        batch_driver = next(
            (d for d in self.drivers if hasattr(d, "query_batch")), None
        )
        if batch_driver is None:
            out = []
            for obj in review_objs:
                try:
                    out.append(self.review(obj, enforcement_point, tracing,
                                           stats))
                except Exception as e:
                    out.append(e)
            return out

        entries: list = []  # per input: GkReview or Exception
        for obj in review_objs:
            try:
                r = self.target.handle_review(obj)
                if r is None:
                    raise ClientError(
                        f"unrecognized review type {type(obj)}"
                    )
                entries.append(r)
            except Exception as e:
                entries.append(e)

        active = [
            c for c in sorted(self.constraints(), key=Constraint.key)
            if (c.actions_for(enforcement_point) if enforcement_point
                else [c.enforcement_action])
        ]
        batch_cons = [
            c for c in active
            if self._template_driver.get(c.kind) is batch_driver
        ]
        other_cons = [
            c for c in active
            if self._template_driver.get(c.kind) is not batch_driver
        ]
        cfg = ReviewCfg(enforcement_point=enforcement_point, tracing=tracing,
                        stats=stats)

        valid_idx = [i for i, e in enumerate(entries)
                     if not isinstance(e, Exception)]
        reviews = [entries[i] for i in valid_idx]
        q_responses = batch_driver.query_batch(
            self.target.name, batch_cons, reviews, cfg
        ) if batch_cons else [QueryResponse() for _ in reviews]

        out: list = [None] * len(entries)
        for slot, (i, qr) in enumerate(zip(valid_idx, q_responses)):
            responses = Responses()
            response = Response(target=self.target.name)
            for result in qr.results:
                constraint = self._constraint_for_result(result)
                if constraint is not None:
                    self._resolve_actions(result, constraint,
                                          enforcement_point)
                response.results.append(result)
            responses.stats_entries.extend(qr.stats_entries)
            if qr.trace:
                response.trace = qr.trace
            # kinds owned by non-batch drivers: per-review query, matching
            # review()'s per-driver fan-out
            review = reviews[slot]
            try:
                for con in other_cons:
                    if not self.target.to_matcher(con.match).match(review):
                        continue
                    driver = self._template_driver[con.kind]
                    oqr = driver.query(self.target.name, [con], review, cfg)
                    for result in oqr.results:
                        self._resolve_actions(result, con, enforcement_point)
                        response.results.append(result)
                    responses.stats_entries.extend(oqr.stats_entries)
                    if oqr.trace:
                        response.trace = (
                            (response.trace + "\n" + oqr.trace)
                            if response.trace else oqr.trace
                        )
            except Exception as e:
                out[i] = e
                continue
            responses.by_target[self.target.name] = response
            out[i] = responses
        for i, e in enumerate(entries):
            if isinstance(e, Exception):
                out[i] = e
        return out

    def _constraint_for_result(self, result) -> Optional[Constraint]:
        c = result.constraint or {}
        kind = c.get("kind", "")
        name = (c.get("metadata") or {}).get("name", "")
        return self.get_constraint(kind, name)

    @staticmethod
    def _resolve_actions(result, constraint: Constraint, ep: str) -> None:
        result.enforcement_action = constraint.enforcement_action
        if constraint.enforcement_action == "scoped":
            result.scoped_enforcement_actions = (
                constraint.actions_for(ep) if ep else
                [e.get("action", "deny") for e in constraint.scoped_actions]
            )

    # --- introspection -------------------------------------------------
    def dump(self) -> dict:
        return {d.name(): d.dump() for d in self.drivers}

    def get_description_for_stat(self, source: dict, stat_name: str) -> str:
        for d in self.drivers:
            if source.get("value") == d.name():
                return d.get_description_for_stat(stat_name)
        return "unknown stat"
