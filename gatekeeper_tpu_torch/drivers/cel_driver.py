"""CEL driver — the k8scel equivalent.

Reference: pkg/drivers/k8scel/driver.go (engine name K8sNativeValidation).
``add_template`` compiles the template source (validations with
message/messageExpression, variables, matchConditions, failurePolicy —
schema/schema.go:28-61, reserved prefix ``gatekeeper_internal_``);
``query`` evaluates matchConditions then each validation per constraint with
the VAP binding environment: object / oldObject / request / params /
namespaceObject / variables.* (transform/cel_snippets.go binds
``variables.params`` and ``anyObject``).

DELETE normalization mirrors driver.go:184-186: on DELETE the bound
``object`` is null and ``oldObject`` carries the object.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.apis.constraints import Constraint
from gatekeeper_tpu_torch.apis.templates import ENGINE_CEL, ConstraintTemplate
from gatekeeper_tpu_torch.client.types import QueryResponse, Result, Stat, StatsEntry
from gatekeeper_tpu_torch.drivers.base import ReviewCfg
from gatekeeper_tpu_torch.lang.cel.cel import (
    CelError,
    CelParseError,
    Env,
    Program,
    evaluate,
)
from gatekeeper_tpu_torch.target.review import DELETE, GkReview

DRIVER_NAME = "K8sNativeValidation"
RESERVED_PREFIX = "gatekeeper_internal_"  # schema.go:21

# constant prelude ASTs (transform/cel_snippets.go), parsed once
_PARAMS_AST = Program("params").ast
_ANY_OBJECT_AST = Program("object != null ? object : oldObject").ast


class CELCompileError(Exception):
    pass


class _CompiledValidation:
    __slots__ = ("expression", "message", "message_expression")

    def __init__(self, expression: Program, message: str,
                 message_expression: Optional[Program]):
        self.expression = expression
        self.message = message
        self.message_expression = message_expression


class _CompiledCELTemplate:
    __slots__ = ("kind", "validations", "variables", "match_conditions",
                 "failure_policy", "generate_vap", "source")

    def __init__(self, kind, validations, variables, match_conditions,
                 failure_policy, generate_vap, source):
        self.kind = kind
        self.validations = validations
        self.variables = variables  # name -> AST
        self.match_conditions = match_conditions  # [(name, Program)]
        self.failure_policy = failure_policy
        self.generate_vap = generate_vap
        self.source = source


def parse_source(template: ConstraintTemplate) -> Optional[dict]:
    return template.targets[0].source_for(ENGINE_CEL)


def _vap_match_constraints(webhook_scope: Optional[dict]) -> dict:
    """matchConstraints for a generated VAP: the webhook's cached rules /
    selectors when known, else match-everything."""
    rules = (webhook_scope or {}).get("rules") or []
    resource_rules = [
        {"apiGroups": r.get("apiGroups", ["*"]),
         "apiVersions": r.get("apiVersions", ["*"]),
         "operations": r.get("operations", ["CREATE", "UPDATE"]),
         "resources": r.get("resources", ["*"])}
        for r in rules
    ] or [{
        "apiGroups": ["*"], "apiVersions": ["*"],
        "operations": ["CREATE", "UPDATE"], "resources": ["*"],
    }]
    out: dict = {"resourceRules": resource_rules}
    for sel in ("namespaceSelector", "objectSelector"):
        if (webhook_scope or {}).get(sel):
            out[sel] = webhook_scope[sel]
    return out


class CELDriver:
    def __init__(self, gather_stats: bool = False):
        self._templates: dict[str, _CompiledCELTemplate] = {}
        self.gather_stats = gather_stats

    def name(self) -> str:
        return DRIVER_NAME

    def has_source_for(self, template: ConstraintTemplate) -> bool:
        return parse_source(template) is not None

    # --- template lifecycle -------------------------------------------
    def compile_template(self, template: ConstraintTemplate) \
            -> "_CompiledCELTemplate":
        """Pure compile (no install); ``add_template`` = compile +
        install."""
        source = parse_source(template)
        if source is None:
            raise CELCompileError(
                f"template {template.name}: no K8sNativeValidation source"
            )
        from gatekeeper_tpu_torch.lang.cel.checker import check as cel_check

        try:
            validations = []
            for v in source.get("validations") or []:
                expr = v.get("expression", "")
                if not expr:
                    raise CELCompileError("validation with no expression")
                msg_expr = v.get("messageExpression")
                # static check (reference: cel-go type checker at
                # AddTemplate): unknown functions/idents fail admission
                cel_check(expr)
                if msg_expr:
                    cel_check(msg_expr)
                validations.append(_CompiledValidation(
                    Program(expr),
                    v.get("message", "") or "",
                    Program(msg_expr) if msg_expr else None,
                ))
            if not validations:
                raise CELCompileError("no validations")
            variables = {}
            for var in source.get("variables") or []:
                vname = var.get("name", "")
                if vname.startswith(RESERVED_PREFIX):
                    raise CELCompileError(
                        f"variable {vname!r} uses the reserved prefix "
                        f"{RESERVED_PREFIX!r}"
                    )
                cel_check(var.get("expression", ""))
                variables[vname] = Program(var.get("expression", "")).ast
            match_conditions = []
            for mc in (source.get("matchCondition")
                       or source.get("matchConditions") or []):
                cel_check(mc.get("expression", ""))
                match_conditions.append(
                    (mc.get("name", ""), Program(mc.get("expression", ""))))
            failure_policy = source.get("failurePolicy") or "Fail"
        except CelParseError as e:
            raise CELCompileError(
                f"template {template.name}: {e}"
            ) from e
        return _CompiledCELTemplate(
            template.kind, validations, variables, match_conditions,
            failure_policy, bool(source.get("generateVAP", False)), source,
        )

    def add_template(self, template: ConstraintTemplate) -> None:
        self._templates[template.kind] = self.compile_template(template)

    def remove_template(self, template_kind: str) -> None:
        self._templates.pop(template_kind, None)

    def add_constraint(self, constraint: Constraint) -> None:
        if constraint.kind not in self._templates:
            raise CELCompileError(
                f"no template for constraint kind {constraint.kind}"
            )

    def remove_constraint(self, constraint: Constraint) -> None:
        pass

    # --- data plane: CEL has no referential data (driver.go has no-op
    # AddData; inventory is a Rego-engine feature) ----------------------
    def add_data(self, target, path, data) -> None:
        pass

    def remove_data(self, target, path) -> None:
        pass

    # --- query ---------------------------------------------------------
    def query(
        self,
        target: str,
        constraints: Sequence[Constraint],
        review: GkReview,
        cfg: Optional[ReviewCfg] = None,
    ) -> QueryResponse:
        cfg = cfg or ReviewCfg()
        resp = QueryResponse()
        req = review.request
        obj = req.object
        old_obj = req.old_object
        if req.operation == DELETE:
            # driver.go:184-186: on DELETE, object is unset for CEL
            obj, old_obj = None, old_obj if old_obj is not None else req.object
        request_doc = req.to_review_doc(review.namespace)
        base_bindings = {
            "object": obj,
            "oldObject": old_obj,
            "request": request_doc,
            "namespaceObject": review.namespace,
            "anyObject": obj if obj is not None else old_obj,
        }
        for constraint in constraints:
            compiled = self._templates.get(constraint.kind)
            if compiled is None:
                continue
            t0 = time.perf_counter_ns()
            params = constraint.parameters if constraint.parameters is not None else {}
            bindings = dict(base_bindings)
            bindings["params"] = params
            lazy = dict(compiled.variables)
            lazy["params"] = _PARAMS_AST
            lazy["anyObject"] = _ANY_OBJECT_AST
            # one Env per (constraint, review): variables.* memoize across
            # matchConditions and validations, like the apiserver's
            # per-request variable bindings
            env = Env(bindings, lazy)

            try:
                if not self._match_conditions_pass(compiled, env):
                    continue
            except CelError as e:
                if compiled.failure_policy == "Fail":
                    resp.results.append(self._violation(
                        target, constraint,
                        f"matchCondition error: {e}"))
                continue

            for v in compiled.validations:
                try:
                    ok = evaluate(v.expression.ast, env)
                except CelError as e:
                    if compiled.failure_policy == "Fail":
                        resp.results.append(self._violation(
                            target, constraint,
                            f"validation error: {e}"))
                    continue
                if ok is True:
                    continue
                # messageExpression wins over static message when it yields a
                # non-empty string (VAP semantics)
                msg = ""
                if v.message_expression is not None:
                    try:
                        rendered = evaluate(v.message_expression.ast, env)
                        if isinstance(rendered, str):
                            msg = rendered
                    except CelError:
                        msg = ""
                if not msg:
                    msg = v.message
                if not msg:
                    msg = f"failed expression: {v.expression.src.strip()}"
                resp.results.append(self._violation(target, constraint, msg))
            if self.gather_stats or cfg.stats:
                resp.stats_entries.append(StatsEntry(
                    scope="constraint",
                    stats_for=f"{constraint.kind}/{constraint.name}",
                    stats=[Stat("templateRunTimeNS",
                                time.perf_counter_ns() - t0,
                                {"type": "engine", "value": DRIVER_NAME})],
                ))
        return resp

    @staticmethod
    def _match_conditions_pass(compiled, env) -> bool:
        for _name, prog in compiled.match_conditions:
            v = evaluate(prog.ast, env)
            if v is not True:
                return False
        return True

    @staticmethod
    def _violation(target, constraint, msg) -> Result:
        return Result(target=target, msg=msg, constraint=constraint.raw)

    def dump(self) -> dict:
        return {"templates": sorted(self._templates)}

    def get_description_for_stat(self, stat_name: str) -> str:
        return {
            "templateRunTimeNS": "the number of nanoseconds it took to "
            "evaluate all constraints for a template",
        }.get(stat_name, "unknown stat")

    # --- VAP codegen (reference: k8scel/transform/make_vap_objects.go) --
    def template_to_vap(self, template: ConstraintTemplate,
                        webhook_scope: Optional[dict] = None) -> dict:
        """Lower a CEL template to a native ValidatingAdmissionPolicy.
        ``webhook_scope`` (from the webhookconfig cache) mirrors the
        validating webhook's match scope into matchConstraints so the VAP
        enforces exactly where the webhook would (reference:
        webhookconfig_controller.go:293 scope sync)."""
        compiled = self._templates.get(template.kind)
        source = compiled.source if compiled else parse_source(template)
        if source is None:
            raise CELCompileError(
                f"template {template.name} has no K8sNativeValidation source"
            )
        variables = [
            {"name": "params",
             "expression": (
                 "!has(params.spec) ? null : !has(params.spec.parameters) ? "
                 "null : params.spec.parameters"
             )},
            {"name": "anyObject",
             "expression": "object != null ? object : oldObject"},
        ] + [
            {"name": v.get("name", ""), "expression": v.get("expression", "")}
            for v in (source.get("variables") or [])
        ]
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingAdmissionPolicy",
            "metadata": {"name": f"gatekeeper-{template.name}"},
            "spec": {
                "failurePolicy": source.get("failurePolicy") or "Fail",
                "paramKind": {
                    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
                    "kind": template.kind,
                },
                "matchConstraints": _vap_match_constraints(webhook_scope),
                "matchConditions": [
                    {"name": mc.get("name", ""),
                     "expression": mc.get("expression", "")}
                    for mc in (source.get("matchCondition")
                               or source.get("matchConditions") or [])
                ],
                "validations": [
                    {k: v for k, v in (
                        ("expression", val.get("expression", "")),
                        ("message", val.get("message", "")),
                        ("messageExpression",
                         val.get("messageExpression", "")),
                    ) if v}
                    for val in (source.get("validations") or [])
                ],
                "variables": variables,
            },
        }

    def constraint_to_vap_binding(self, constraint: Constraint,
                                  template: ConstraintTemplate) -> dict:
        """Reference: transform.GetVAPBindingName + constraint_controller.go:375."""
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingAdmissionPolicyBinding",
            "metadata": {
                "name": f"gatekeeper-{constraint.name}"
            },
            "spec": {
                "policyName": f"gatekeeper-{template.name}",
                "paramRef": {
                    "name": constraint.name,
                    "parameterNotFoundAction": "Allow",
                },
                "validationActions": ["Deny"],
            },
        }
