"""Interpreter-backed Rego driver — the exact engine.

Plays the role of the reference's OPA rego driver (external module, usage
surface documented in SURVEY.md §2.8): template sources compile at
``add_template`` time, referential data lives under ``data.inventory.<path>``
(externs gate, main.go:474-478), and ``query`` evaluates the template's
``violation`` partial-set rule once per constraint with
``input = {review, parameters}``.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

from gkref.apis.constraints import Constraint
from gkref.apis.templates import ENGINE_REGO, ConstraintTemplate
from gkref.client.types import QueryResponse, Result, Stat, StatsEntry
from gkref.drivers.base import ReviewCfg
from gkref.lang.rego.interp import Interpreter, ModuleSet, compile_modules
from gkref.lang.rego.value import to_json
from gkref.target.review import GkReview

DRIVER_NAME = "Rego"


class TemplateCompileError(Exception):
    pass


class _CompiledTemplate:
    __slots__ = ("kind", "modules", "package")

    def __init__(self, kind: str, modules: ModuleSet, package: tuple):
        self.kind = kind
        self.modules = modules
        self.package = package


class RegoDriver:
    def __init__(self, trace_enabled: bool = False):
        self._templates: dict[str, _CompiledTemplate] = {}
        self._data: dict = {}  # inventory tree
        self._trace_enabled = trace_enabled

    def name(self) -> str:
        return DRIVER_NAME

    # --- template lifecycle -------------------------------------------
    def has_source_for(self, template: ConstraintTemplate) -> bool:
        return template.targets[0].source_for(ENGINE_REGO) is not None

    def compile_template(self, template: ConstraintTemplate) \
            -> _CompiledTemplate:
        """Pure compile (no install): the artifact ``add_template`` would
        store.  The generation coordinator uses this to validate a staged
        template synchronously while deferring the install to the swap."""
        src = template.targets[0].source_for(ENGINE_REGO)
        if src is None:
            raise TemplateCompileError(
                f"template {template.name}: no Rego source"
            )
        try:
            modules = compile_modules([src["rego"], *src.get("libs", [])])
        except SyntaxError as e:
            raise TemplateCompileError(
                f"template {template.name}: {e}"
            ) from e
        # entry module: the one holding the `violation` rule; by convention the
        # first source (the framework requires the entry rule in the template
        # body, not libs)
        from gkref.lang.rego.parser import parse_module

        entry_pkg = parse_module(src["rego"]).package
        entry_mod = modules.by_pkg.get(entry_pkg)
        if entry_mod is None or "violation" not in entry_mod.rules:
            raise TemplateCompileError(
                f"template {template.name}: no violation rule in package "
                f"{'.'.join(entry_pkg)}"
            )
        return _CompiledTemplate(template.kind, modules, entry_pkg)

    def add_template(self, template: ConstraintTemplate) -> None:
        self._templates[template.kind] = self.compile_template(template)

    def remove_template(self, template_kind: str) -> None:
        self._templates.pop(template_kind, None)

    def add_constraint(self, constraint: Constraint) -> None:
        # Interpreter reads parameters straight off the constraint at query
        # time; nothing to precompute.
        if constraint.kind not in self._templates:
            raise TemplateCompileError(
                f"no template for constraint kind {constraint.kind}"
            )

    def remove_constraint(self, constraint: Constraint) -> None:
        pass

    # --- data plane ---------------------------------------------------
    def add_data(self, target: str, path: Sequence[str], data: Any) -> None:
        import copy

        node = self._data.setdefault("inventory", {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        # independent copy: OPA's store snapshots data on write; callers may
        # mutate the object afterwards (gator expand mutates bases in place)
        node[path[-1]] = copy.deepcopy(data)

    def remove_data(self, target: str, path: Sequence[str]) -> None:
        node = self._data.get("inventory")
        if node is None:
            return
        for p in path[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                return
        node.pop(path[-1], None)

    def wipe_data(self) -> None:
        self._data.pop("inventory", None)

    # --- query --------------------------------------------------------
    def query(
        self,
        target: str,
        constraints: Sequence[Constraint],
        review: GkReview,
        cfg: Optional[ReviewCfg] = None,
        data_override: Optional[dict] = None,
    ) -> QueryResponse:
        """``data_override`` substitutes the data document for this query
        (the TPU driver's restricted-inventory render path)."""
        cfg = cfg or ReviewCfg()
        resp = QueryResponse()
        trace_lines: list[str] = [] if (cfg.tracing or self._trace_enabled) else None
        review_doc = review.request.to_review_doc(review.namespace)
        for constraint in constraints:
            compiled = self._templates.get(constraint.kind)
            if compiled is None:
                continue
            input_doc = {
                "review": review_doc,
                "parameters": constraint.parameters
                if constraint.parameters is not None
                else {},
            }
            interp = Interpreter(
                compiled.modules,
                data=self._data if data_override is None else data_override,
            )
            t0 = time.perf_counter_ns()
            violations = interp.query_set_rule(
                compiled.package, "violation", input_doc
            )
            elapsed = time.perf_counter_ns() - t0
            for v in violations:
                if isinstance(v, dict):
                    msg = v.get("msg", "")
                    details = to_json(v.get("details")) if "details" in v else None
                else:
                    msg, details = str(v), None
                metadata = {"details": details} if details is not None else {}
                resp.results.append(
                    Result(
                        target=target,
                        msg=msg if isinstance(msg, str) else str(msg),
                        constraint=constraint.raw,
                        metadata=metadata,
                    )
                )
            if cfg.stats:
                resp.stats_entries.append(
                    StatsEntry(
                        scope="constraint",
                        stats_for=f"{constraint.kind}/{constraint.name}",
                        stats=[
                            Stat(
                                name="templateRunTimeNS",
                                value=elapsed,
                                source={"type": "engine", "value": DRIVER_NAME},
                            ),
                            Stat(
                                name="constraintCount",
                                value=len(constraints),
                                source={"type": "engine", "value": DRIVER_NAME},
                            ),
                        ],
                    )
                )
            if trace_lines is not None:
                trace_lines.append(
                    f"constraint {constraint.kind}/{constraint.name}: "
                    f"{len(violations)} violation(s) in {elapsed}ns"
                )
        if trace_lines is not None:
            resp.trace = "\n".join(trace_lines)
        return resp

    def dump(self) -> dict:
        return {
            "templates": sorted(self._templates),
            "data": self._data,
        }

    def get_description_for_stat(self, stat_name: str) -> str:
        return {
            "templateRunTimeNS": "the number of nanoseconds it took to evaluate"
            " all constraints for a template",
            "constraintCount": "the number of constraints that were evaluated "
            "for the given constraint kind",
        }.get(stat_name, "unknown stat")
