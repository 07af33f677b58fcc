"""The port's CEL engine (gatekeeper_tpu_torch/lang/cel/, drivers/cel_driver.py,
ir/lower_cel.py and the CEL routes of drivers/torch_driver.py, on the CPU)
against the JAX package's, object beside object:

(a) the evaluator, parser and static checker on a table of expressions
    (values, error texts, ASTs);
(b) ``CELDriver`` end to end: variables and messageExpression,
    matchConditions, failurePolicy, DELETE normalization, the reserved
    prefix, and the VAP codegen of both library CEL templates;
(c) ``lower_cel``: each mini template of the JAX package's lowering tests
    plus one ``x in params.list`` template and the two library templates
    under sample, alternate and unparseable parameters: the same
    lowered-or-fallback outcome, the same program, the same quantity
    table, and the same ``query_batch`` results (in order) over seeded
    adversarial Pods with DELETE reviews among them;
(d) ``TorchDriver.query`` with CEL and Rego constraints of the whole
    library, in the JAX package's result order, and ``query_batch`` over
    the whole library with DELETE reviews;
(e) the port's webhook handler on a CEL ConstraintTemplate and on a Pod it
    denies.

Every comparison is exact: values, strings, booleans, float32 tables."""

import copy
import os
import random
import re

import numpy as np
import pytest
import yaml

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.apis.constraints import \
    Constraint as JConstraint  # noqa: E402
from gatekeeper_tpu.apis.templates import \
    ConstraintTemplate as JTemplate  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers import cel_driver as jceld  # noqa: E402
from gatekeeper_tpu.drivers.base import ReviewCfg as JCfg  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.ir import program as jprog  # noqa: E402
from gatekeeper_tpu.lang.cel import cel as jcel  # noqa: E402
from gatekeeper_tpu.lang.cel import checker as jchecker  # noqa: E402
from gatekeeper_tpu.ops.flatten import Vocab as JVocab  # noqa: E402
from gatekeeper_tpu.target.review import \
    AugmentedReview as JAugReview  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu.webhook import policy as jpolicy  # noqa: E402
from gatekeeper_tpu_torch.apis.constraints import \
    Constraint as TConstraint  # noqa: E402
from gatekeeper_tpu_torch.apis.templates import \
    ConstraintTemplate as TTemplate  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers import cel_driver as tceld  # noqa: E402
from gatekeeper_tpu_torch.drivers.base import ReviewCfg as TCfg  # noqa
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir import program as tprog  # noqa: E402
from gatekeeper_tpu_torch.lang.cel import cel as tcel  # noqa: E402
from gatekeeper_tpu_torch.lang.cel import checker as tchecker  # noqa: E402
from gatekeeper_tpu_torch.ops.flatten import Vocab as TVocab  # noqa: E402
from gatekeeper_tpu_torch.target.review import \
    AugmentedReview as TAugReview  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook import policy as tpolicy  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library")
TARGET = "admission.k8s.gatekeeper.sh"
CEL_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")

# --------------------------------------------------------------------------
# (a) evaluator, parser and checker
# --------------------------------------------------------------------------

_OBJ = {"spec": {"x": 1}}
EXPRESSIONS = [
    # basics
    ("1 + 2 * 3", {}), ("(1 + 2) * 3", {}), ('"a" + "b"', {}),
    ("[1, 2] + [3]", {}), ("7 / 2", {}), ("-7 / 2", {}), ("-7 % 2", {}),
    ("7.0 / 2", {}), ("true ? 1 : 2", {}), ('size("abc")', {}),
    ('"abc".contains("b")', {}), ('"v1.2".matches("^v[0-9]+")', {}),
    ('"a,b,c".split(",", 2)', {}), ('"a,b,c".split(",", 0)', {}),
    ("string(42)", {}), ('int("42")', {}), ("type(1)", {}),
    ('"AbC".lowerAscii() + "x".upperAscii()', {}),
    ('"  t ".trim()', {}), ('["a", "b"].join("-")', {}),
    ('"abc".startsWith("ab") && "abc".endsWith("bc")', {}),
    ("1 / 0", {}), ('"a" + 1', {}), ('"x".matches("(")', {}),
    # collections
    ("[1,2,3].all(x, x > 0)", {}), ("[1,-2,3].all(x, x > 0)", {}),
    ("[1,2,3].exists(x, x == 2)", {}), ("[1,2,3].exists_one(x, x > 2)", {}),
    ("[1,2,3].filter(x, x > 1)", {}), ("[1,2,3].map(x, x * 2)", {}),
    ('{"a": 1, "b": 2}.all(k, k != "c")', {}),
    ('"b" in {"a": 1, "b": 2}', {}), ("2 in [1, 2]", {}),
    ('{"a": 1}["a"]', {}), ('{"a": 1}["b"]', {}), ("[1][3]", {}),
    ('{"a": 1, "b": 2}.all(k, v, v > 0)', {}),
    ("[1, 2, 2].exists_one(x, x == 2)", {}),
    # has() and errors
    ("has(object.spec)", {"object": _OBJ}),
    ("has(object.status)", {"object": _OBJ}),
    ("has(object.status.phase)", {"object": _OBJ}),
    ("has(object.status) && has(object.status.phase)", {"object": _OBJ}),
    ("object.status.phase", {"object": _OBJ}),
    ("true || object.a.b", {"object": {}}),
    ("object.a.b || true", {"object": {}}),
    ("false || object.a.b", {"object": {}}),
    ("false && object.a.b", {"object": {}}),
    ("[{}, {'privileged': true}].exists(c, c.privileged)", {}),
    ("[{}, {'privileged': false}].exists(c, c.privileged)", {}),
    ("unbound + 1", {}),
    # equality semantics
    ("1 == 1.0", {}), ("1 == true", {}), ('1 == "1"', {}),
    ("null == null", {}), ("[1, [2]] == [1, [2]]", {}),
    ('{"a": [1]} == {"a": [1.0]}', {}), ("1 != null", {}),
    # k8s extension libraries
    ('quantity("1Gi").isGreaterThan(quantity("900Mi"))', {}),
    ('quantity("100m").asApproximateFloat()', {}),
    ('quantity("2Ki").asInteger()', {}), ('quantity("1.5").isInteger()', {}),
    ('quantity("-3").sign()', {}),
    ('quantity("1Gi").compareTo(quantity("1024Mi"))', {}),
    ('quantity("1Gi").add(quantity("1Gi")).asInteger()', {}),
    ('isQuantity("10Wi")', {}), ('isQuantity("150Mi")', {}),
    ('quantity("10Wi")', {}), ('quantity("100m").asInteger() == 1', {}),
    ('quantity("1e3").asApproximateFloat()', {}),
    ('quantity(" 5").asInteger()', {}),
    ('ip("127.0.0.1").isLoopback()', {}), ('ip("::1").family()', {}),
    ('isIP("999.1.1.1")', {}),
    ('cidr("10.0.0.0/8").containsIP("10.1.2.3")', {}),
    ('cidr("10.0.0.0/8").containsIP(ip("11.1.2.3"))', {}),
    ('cidr("10.0.0.0/8").containsCIDR("10.2.0.0/16")', {}),
    ('cidr("10.0.0.0/8").prefixLength()', {}), ('isCIDR("10.0.0.0/33")', {}),
    ('url("https://example.com:8443/x").getScheme()', {}),
    ('url("https://example.com:8443/x").getPort()', {}),
    ('url("https://example.com:8443/x").getHostname()', {}),
    ('isURL("not a url")', {}),
    # variables and params, as the driver binds them
    ("variables.a + params.b", {"params": {"b": 2}}),
]

CHECKED = [
    "frobnicate(object)", "object.metadata.name.fliptwist()",
    "unknownvar.spec.x == 1", "size(object, params) > 0",
    "object.metadata.name == params.name",
    "variables.containers.all(c, has(c.image))",
    'quantity(object.spec.m).isGreaterThan(quantity("1Gi"))',
    "request.kind.kind == 'Pod' && has(oldObject.spec)",
    "namespaceObject.metadata.labels.exists(k, k == 'team')",
    "1 +", "(", "'unterminated",
]


def _plain(v):
    """A value as a comparable tree: containers recursed, scalars tagged
    with their type name (1 == 1.0 == True in Python), extension objects
    by type name and text."""
    if isinstance(v, list):
        return ["list", [_plain(x) for x in v]]
    if isinstance(v, dict):
        return ["map", sorted((repr(_plain(k)), _plain(x))
                              for k, x in v.items())]
    if v is None or isinstance(v, (bool, int, float, str)):
        return [type(v).__name__, v]
    return [type(v).__name__, str(getattr(v, "__dict__", v))]


def _outcome(mod, src, bindings):
    lazy = {"a": mod.Program("40").ast} if "variables." in src else None
    try:
        return ("value", _plain(mod.Program(src).eval(
            copy.deepcopy(bindings), lazy)))
    except mod.CelError as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("src,bindings", EXPRESSIONS,
                         ids=[e[0][:40] for e in EXPRESSIONS])
def test_evaluator_matches_jax(src, bindings):
    got = _outcome(tcel, src, bindings)
    assert got == _outcome(jcel, src, bindings)
    try:
        want_ast = repr(jcel.parse(src))
    except jcel.CelError as e:
        want_ast = str(e)
    try:
        got_ast = repr(tcel.parse(src))
    except tcel.CelError as e:
        got_ast = str(e)
    assert got_ast == want_ast


def test_evaluator_table_reaches_values_and_errors():
    outcomes = [_outcome(tcel, s, b)[0] for s, b in EXPRESSIONS]
    assert outcomes.count("error") >= 10 and outcomes.count("value") >= 60


def _check(mod, src):
    try:
        mod.check(src)
        return None
    except Exception as e:  # checker and parser errors alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("src", CHECKED)
def test_checker_matches_jax(src):
    assert _check(tchecker, src) == _check(jchecker, src)


def test_checker_rejects_and_admits():
    verdicts = [_check(tchecker, s) is None for s in CHECKED]
    assert verdicts.count(True) == 5 and verdicts.count(False) == 7


# --------------------------------------------------------------------------
# (b) CELDriver end to end
# --------------------------------------------------------------------------


def _template_doc(kind, source, schema=None):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind},
                             "validation": {"openAPIV3Schema":
                                            schema or {"type": "object"}}}},
            "targets": [{"target": TARGET,
                         "code": [{"engine": "K8sNativeValidation",
                                   "source": source}]}],
        },
    }


def _constraint_doc(kind, name, params=None):
    doc = {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
           "metadata": {"name": name}, "spec": {}}
    if params is not None:
        doc["spec"]["parameters"] = params
    return doc


DRIVER_TEMPLATES = {
    "variables": (_template_doc("K8sCelRequiredLabels", {
        "variables": [{"name": "missing", "expression": (
            "variables.params.labels.filter(l, "
            "!has(object.metadata.labels) || "
            "!(l in object.metadata.labels))")}],
        "validations": [{
            "expression": "size(variables.missing) == 0",
            "messageExpression": ('"missing required labels: " + '
                                  'variables.missing.join(", ")')}]}),
        {"labels": ["owner", "team"]}),
    "matchConditions": (_template_doc("K8sCelMc", {
        "matchCondition": [{"name": "only-pods",
                            "expression": 'request.kind.kind == "Pod"'}],
        "validations": [{"expression": "false",
                         "message": "always denied"}]}), None),
    "matchCondition error, Fail": (_template_doc("K8sCelMcErr", {
        "matchConditions": [{"name": "bad",
                             "expression": "object.spec.nope.deeper"}],
        "validations": [{"expression": "true"}]}), None),
    "validation error, Fail": (_template_doc("K8sCelErrFail", {
        "validations": [{"expression": "object.spec.replicas > 2",
                         "message": "too many"}]}), None),
    "validation error, Ignore": (_template_doc("K8sCelErrIgnore", {
        "failurePolicy": "Ignore",
        "validations": [{"expression": "object.spec.replicas > 2",
                         "message": "too many"}]}), None),
    "DELETE": (_template_doc("K8sCelDel", {
        "validations": [{"expression": "object != null",
                         "message": "object is null on delete"},
                        {"expression": "oldObject == null || "
                                       "has(oldObject.metadata.name)"}]}),
        None),
    "messageExpression fallbacks": (_template_doc("K8sCelMsg", {
        "validations": [
            {"expression": "has(object.spec)",
             "messageExpression": "object.spec.missing",
             "message": "static message"},
            {"expression": "has(object.metadata.labels)",
             "messageExpression": "42"},
            {"expression": "size(object.metadata.name) < 3"}]}), None),
}


def _driver_reviews(target_cls, aug_cls, parse):
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "default",
                        "labels": {"owner": "x"}},
           "spec": {"replicas": 3, "containers": [{"name": "c"}]}}
    bare = {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "svc"}}
    labelled = {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "ok", "labels": {"owner": "a",
                                                      "team": "b"}},
                "spec": {"replicas": 1}}
    target = target_cls()
    reviews = []
    for op, obj in (("CREATE", pod), ("CREATE", bare), ("CREATE", labelled),
                    ("DELETE", pod), ("UPDATE", labelled)):
        group, _, version = obj["apiVersion"].rpartition("/")
        body = {"request": {
            "uid": "u", "operation": op,
            "kind": {"group": group, "version": version,
                     "kind": obj["kind"]},
            "name": obj["metadata"]["name"], "namespace": "default",
            "object": None if op == "DELETE" else copy.deepcopy(obj),
            "oldObject": copy.deepcopy(obj) if op != "CREATE" else None}}
        reviews.append(target.handle_review(aug_cls(
            admission_request=parse(body))))
    return reviews


def _keyed_in_order(results):
    return [((r.constraint.get("metadata") or {}).get("name"), r.msg)
            for r in results]


@pytest.mark.parametrize("case", sorted(DRIVER_TEMPLATES))
def test_cel_driver_matches_jax(case):
    doc, params = DRIVER_TEMPLATES[case]
    kind = doc["spec"]["crd"]["spec"]["names"]["kind"]
    got = {}
    for side, celd, tmpl, con, target, aug, parse, cfg in (
            ("jax", jceld, JTemplate, JConstraint, JTarget, JAugReview,
             jpolicy.parse_admission_review, JCfg(stats=True)),
            ("port", tceld, TTemplate, TConstraint, TTarget, TAugReview,
             tpolicy.parse_admission_review, TCfg(stats=True))):
        d = celd.CELDriver()
        d.add_template(tmpl.from_unstructured(copy.deepcopy(doc)))
        c = con.from_unstructured(_constraint_doc(kind, "c", params))
        d.add_constraint(c)
        out = []
        for review in _driver_reviews(target, aug, parse):
            qr = d.query(TARGET, [c], review, cfg)
            out.append((_keyed_in_order(qr.results),
                        [(e.scope, e.stats_for, [s.name for s in e.stats])
                         for e in qr.stats_entries]))
        got[side] = out
    assert got["port"] == got["jax"]
    assert any(res for res, _stats in got["port"])


def test_cel_driver_rejects_like_jax():
    """The reserved variable prefix and a checker failure raise
    ``CELCompileError`` with the JAX package's text; a constraint of an
    unknown kind too."""
    reserved = _template_doc("K8sCelBad", {
        "variables": [{"name": "gatekeeper_internal_x", "expression": "1"}],
        "validations": [{"expression": "true"}]})
    unchecked = _template_doc("K8sCelBad", {
        "validations": [{"expression": "frobnicate(object)"}]})
    empty = _template_doc("K8sCelBad", {"validations": []})
    for doc in (reserved, unchecked, empty):
        errs = []
        for celd, tmpl in ((jceld, JTemplate), (tceld, TTemplate)):
            with pytest.raises(celd.CELCompileError) as e:
                celd.CELDriver().add_template(tmpl.from_unstructured(doc))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    errs = []
    for celd, con in ((jceld, JConstraint), (tceld, TConstraint)):
        with pytest.raises(celd.CELCompileError) as e:
            celd.CELDriver().add_constraint(con.from_unstructured(
                _constraint_doc("K8sNobody", "c")))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _library_cel_docs():
    out = []
    for name in ("containerlimitscel", "noprivileged"):
        base = os.path.join(LIB, "general", name)
        out.append((load_yaml_file(os.path.join(base, "template.yaml"))[0],
                    load_yaml_file(os.path.join(base, "samples",
                                                "constraint.yaml"))[0]))
    return out


@pytest.mark.parametrize("scope", [None, {
    "rules": [{"apiGroups": [""], "apiVersions": ["v1"],
               "operations": ["CREATE"], "resources": ["pods"]}],
    "namespaceSelector": {"matchLabels": {"env": "prod"}}}],
    ids=["match-everything", "webhook-scope"])
def test_vap_codegen_matches_jax(scope):
    docs = _library_cel_docs() + [
        (DRIVER_TEMPLATES["matchConditions"][0],
         _constraint_doc("K8sCelMc", "mc"))]
    for tdoc, cdoc in docs:
        out = []
        for celd, tmpl, con in ((jceld, JTemplate, JConstraint),
                                (tceld, TTemplate, TConstraint)):
            d = celd.CELDriver()
            t = tmpl.from_unstructured(copy.deepcopy(tdoc))
            d.add_template(t)
            c = con.from_unstructured(copy.deepcopy(cdoc))
            out.append((d.template_to_vap(t, webhook_scope=scope),
                        d.constraint_to_vap_binding(c, t)))
        assert out[0] == out[1]
        vap, binding = out[1]
        assert vap["kind"] == "ValidatingAdmissionPolicy"
        assert binding["spec"]["policyName"] == vap["metadata"]["name"]


# --------------------------------------------------------------------------
# (c) lower_cel and the grid
# --------------------------------------------------------------------------

MINI = {
    "heterogeneous !=": ("""
validations:
  - expression: 'object.spec.tier != "forbidden"'
    message: tier forbidden
""", None, None),
    "heterogeneous ==": ("""
validations:
  - expression: 'object.spec.flag == true || object.spec.count == 3.0'
    message: bad
""", None, None),
    "var-free macro body over map keys": ("""
validations:
  - expression: >-
      !has(object.metadata.annotations) ? true :
      object.metadata.annotations.all(a, has(object.spec.ok))
    message: bad
""", None, None),
    "absorbed deref (fallback)": ("""
variables:
  - name: containers
    expression: >-
      !has(object.spec.containers) ? [] : object.spec.containers
validations:
  - expression: 'variables.containers.all(c, has(c.image) || true)'
    message: bad
""", None, None),
    "object macro inside param macro": ("""
validations:
  - expression: >-
      params.prefixes.exists(p,
      object.spec.containers.all(c, c.image.startsWith(p)))
    message: no common registry prefix
""", {"type": "object", "properties": {"prefixes": {
        "type": "array", "items": {"type": "string"}}}},
        {"prefixes": ["good/", "ok-"]}),
    "map-key predicate": ("""
validations:
  - expression: '!object.metadata.annotations.exists(k, k.startsWith("seccomp."))'
    message: no seccomp annotations allowed
""", None, None),
    "exists_one": ("""
validations:
  - expression: 'object.spec.containers.exists_one(c, c.name == "main")'
    message: need exactly one main container
""", None, None),
    "two-variable map macro": ("""
validations:
  - expression: 'object.metadata.labels.all(k, v, !k.startsWith("forbidden."))'
    message: forbidden label prefix
""", None, None),
    "two-variable value body (fallback)": ("""
validations:
  - expression: 'object.metadata.labels.all(k, v, v != "")'
    message: empty label value
""", None, None),
    "in over a param string list": ("""
validations:
  - expression: 'object.spec.tier in params.tiers'
    messageExpression: '"tier not allowed: " + string(object.spec.tier)'
""", {"type": "object", "properties": {"tiers": {
        "type": "array", "items": {"type": "string"}}}},
        {"tiers": ["gold", "silver"]}),
}


def _mini_objects(rng, n):
    """Pods whose fields take every shape the mini templates read:
    strings, numbers, booleans, null, lists and maps, or nothing."""
    def anything():
        return rng.choice(["gold", "forbidden", "seccomp.a", "main", "",
                           3, 3.0, True, False, None, ["x"], {"k": "v"}])

    def mapping():
        r = rng.random()
        if r < 0.15:
            return rng.choice(["notamap", ["seccomp.alpha"], 5])
        return {rng.choice(["seccomp.alpha", "forbidden.x", "app", "k",
                            "team"]) + str(i): rng.choice(["", "v", 1])
                for i in range(rng.randint(0, 3))}

    out = []
    for i in range(n):
        meta = {"name": f"m{i}"}
        for field in ("annotations", "labels"):
            if rng.random() < 0.8:
                meta[field] = mapping()
        spec = {}
        for field in ("tier", "flag", "count", "ok"):
            if rng.random() < 0.7:
                spec[field] = anything()
        if rng.random() < 0.85:
            spec["containers"] = [
                {k: v for k, v in (
                    ("name", rng.choice(["main", "side", 7, None])),
                    ("image", rng.choice(["good/x", "ok-1", "bad/y", 7])))
                 if rng.random() < 0.9}
                for _ in range(rng.randint(0, 3))]
        obj = {"apiVersion": "v1", "kind": "Pod", "metadata": meta}
        if rng.random() < 0.95:
            obj["spec"] = spec
        out.append(obj)
    return out


def _adversarial_pods(rng, n):
    """Pods probing the library templates' error semantics: mixed-type
    fields, absent guards' targets, unparseable quantities, non-bool
    privileged."""
    out = []
    for i in range(n):
        containers = []
        for j in range(rng.randint(0, 3)):
            c = {"name": rng.choice([f"c{j}", 9])}
            if rng.random() < 0.85:
                c["image"] = rng.choice(["openpolicyagent/opa",
                                         "exempt/me:v1", "nginx",
                                         "exempt/other", 7, True])
            if rng.random() < 0.7:
                r = rng.random()
                if r < 0.5:
                    c["resources"] = {"limits": {"memory": rng.choice([
                        "512Mi", "2Gi", "1Gi", "1e3", "banana", 512, None,
                        "100m", " 1Gi", "1.5Gi", "-1", "1E9", "1024Mi"])}}
                elif r < 0.7:
                    c["resources"] = {"limits": {}}
                elif r < 0.85:
                    c["resources"] = {}
                else:
                    c["resources"] = rng.choice(["notadict", 5])
            if rng.random() < 0.5:
                c["securityContext"] = {"privileged": rng.choice(
                    [True, False, "yes", 1, None])}
            elif rng.random() < 0.2:
                c["securityContext"] = rng.choice([{}, "bad"])
            containers.append(c)
        spec = {}
        if rng.random() < 0.9:
            spec["containers"] = containers
        if rng.random() < 0.25:
            spec["initContainers"] = [
                {"name": "init", "image": "init/image",
                 "securityContext": {"privileged": rng.random() < 0.5}}]
        obj = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": f"p{i}", "namespace": "default"}}
        if rng.random() < 0.95:
            obj["spec"] = spec
        out.append(obj)
    return out


def _bodies(objects, delete_every):
    """AdmissionReview requests for ``objects``; every ``delete_every``-th
    one a DELETE (object null, oldObject the object)."""
    bodies = []
    for i, obj in enumerate(objects):
        delete = delete_every and i % delete_every == delete_every - 1
        group, _, version = obj.get("apiVersion", "").rpartition("/")
        meta = obj.get("metadata") or {}
        bodies.append({"request": {
            "uid": f"u{i}", "operation": "DELETE" if delete else "CREATE",
            "kind": {"group": group, "version": version,
                     "kind": obj.get("kind", "")},
            "name": meta.get("name", ""),
            "namespace": meta.get("namespace", ""),
            "userInfo": {"username": "alice"},
            "object": None if delete else obj,
            "oldObject": obj if delete else None}})
    return bodies


def _reviews(target, aug_cls, parse, bodies):
    return [target.handle_review(aug_cls(
        admission_request=parse(copy.deepcopy(b)))) for b in bodies]


def _program_text(side):
    """The lowered program as text: node reprs with each list-element
    needle written as its key (its own repr names the package)."""
    nodes = [n for n in side.expr_nodes_fn(side.program)
             if type(n).__name__ == "_ElemListSid"]
    text = re.sub(r"<gatekeeper_tpu(_torch)?\.ir\.program\._ElemListSid "
                  r"object at 0x[0-9a-f]+>", "_ElemListSid",
                  repr(side.program))
    return text, [repr(n._key()) for n in nodes]


class _Side:
    """One package's driver pair (device driver + CELDriver) with the
    objects to drive it."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        if jax_side:
            self.cel = jceld.CELDriver()
            self.driver = TpuDriver(batch_bucket=16, cel_driver=self.cel)
            self.tmpl, self.con, self.target = JTemplate, JConstraint, \
                JTarget()
            self.aug, self.parse = JAugReview, jpolicy.parse_admission_review
            self.expr_nodes_fn = jprog.expr_nodes
        else:
            self.cel = tceld.CELDriver()
            self.driver = TorchDriver(batch_bucket=16, device="cpu",
                                      cel_driver=self.cel)
            self.tmpl, self.con, self.target = TTemplate, TConstraint, \
                TTarget()
            self.aug, self.parse = TAugReview, tpolicy.parse_admission_review
            self.expr_nodes_fn = tprog.expr_nodes

    def install(self, tdoc, cdocs):
        self.driver.add_template(self.tmpl.from_unstructured(
            copy.deepcopy(tdoc)))
        cons = [self.con.from_unstructured(copy.deepcopy(c)) for c in cdocs]
        for c in cons:
            self.driver.add_constraint(c)
        return cons

    def query_batch(self, cons, bodies):
        reviews = _reviews(self.target, self.aug, self.parse, bodies)
        return reviews, self.driver.query_batch(TARGET, cons, reviews)

    def status(self, kind):
        if kind in self.driver.lowered_kinds():
            self.program = self.driver._programs[kind].program
            return "lowered", _program_text(self)
        return "fallback", self.driver.fallback_kinds()[kind]


def _oracle(side, cons, reviews):
    """Per review, the CEL evaluator's results for every matching
    constraint (the exact engine the grid must reproduce)."""
    out = []
    for review in reviews:
        res = []
        for con in cons:
            if side.target.to_matcher(con.match).match(review):
                res.extend(side.cel.query(TARGET, [con], review).results)
        out.append(sorted(_keyed_in_order(res)))
    return out


def _hold(tdoc, cdocs, bodies):
    """Install on both sides, then hold the port against the JAX package
    (outcome, program, results in order) and against its own CEL
    evaluator.  Returns (status, results) of the port."""
    kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
    sides = [_Side(True), _Side(False)]
    out = []
    for side in sides:
        cons = side.install(tdoc, cdocs)
        reviews, got = side.query_batch(cons, bodies)
        out.append((side.status(kind),
                    [_keyed_in_order(qr.results) for qr in got],
                    _oracle(side, cons, reviews)))
    (jstatus, jres, _), (tstatus, tres, toracle) = out
    assert tstatus == jstatus
    assert tres == jres
    assert [sorted(r) for r in tres] == toracle
    assert sides[1].driver.vocab._to_str == sides[0].driver.vocab._to_str
    return tstatus[0], tres


@pytest.mark.parametrize("case", sorted(MINI))
def test_mini_template_matches_jax(case):
    source, schema, params = MINI[case]
    kind = "K8sCelMini" + re.sub(r"[^A-Za-z]", "", case.title())
    tdoc = _template_doc(kind, yaml.safe_load(source), schema)
    objects = _mini_objects(random.Random(case), 120)
    status, res = _hold(tdoc, [_constraint_doc(kind, "mini", params)],
                        _bodies(objects, delete_every=10))
    assert status == ("fallback" if "(fallback)" in case else "lowered")
    assert 0 < sum(map(len, res)) < len(objects)


LIBRARY_PARAMS = [
    ("noprivileged", None), ("noprivileged", {"exemptImages": ["exempt/"]}),
    ("noprivileged", {"exemptImages": []}), ("noprivileged", {}),
    ("containerlimitscel", None), ("containerlimitscel", {}),
    ("containerlimitscel", {"memory": "banana"}),
    ("containerlimitscel", {"memory": "2Gi"}),
    ("containerlimitscel", {"memory": 512}),
]


@pytest.mark.parametrize("name,params", LIBRARY_PARAMS,
                         ids=[f"{n}-{p}" for n, p in LIBRARY_PARAMS])
def test_library_cel_template_matches_jax(name, params):
    """~250 adversarial Pods, every tenth a DELETE review, under the
    template's sample constraint and a variant with ``params``."""
    base = os.path.join(LIB, "general", name)
    tdoc = load_yaml_file(os.path.join(base, "template.yaml"))[0]
    sample = load_yaml_file(os.path.join(base, "samples",
                                         "constraint.yaml"))[0]
    cdocs = [sample]
    if params is not None:
        alt = copy.deepcopy(sample)
        alt["metadata"]["name"] += "-alt"
        alt["spec"]["parameters"] = params
        cdocs.append(alt)
    objects = _adversarial_pods(random.Random(name + str(params)), 250)
    status, res = _hold(tdoc, cdocs, _bodies(objects, delete_every=10))
    assert status == "lowered"
    deletes = [r for i, r in enumerate(res) if i % 10 == 9]
    assert any(deletes) and sum(map(len, res)) > 25


def test_quantity_table_matches_jax():
    """The ``cel.quantity`` table that ``isQuantity``/``quantity()``
    lower to: the same float32 values and validity, bit for bit, over
    strings that parse, overflow float32 or do not parse."""
    strings = ["1Gi", "512Mi", "100m", "1e3", "1E9", " 1Gi", "1Gi ", "-1",
               "+2Ki", "1.5Gi", "0.1", "banana", "", "Gi", "1e400", "5Ei",
               "1.", ".5", "1e-3m", "7Wi", "0x10", "2k", "3K", "1024Mi",
               "9" * 40, "-0", "1_000"]
    got = []
    for vocab_cls, prog in ((JVocab, jprog), (TVocab, tprog)):
        vocab = vocab_cls()
        for s in strings:
            vocab.intern(s)
        num, valid = prog.fn_table(vocab, "cel.quantity")
        got.append((np.asarray(num), np.asarray(valid)))
    (jnum, jvalid), (tnum, tvalid) = got
    assert tnum.dtype == np.float32 and tvalid.dtype == np.bool_
    assert np.array_equal(tvalid, jvalid)
    assert tnum.tobytes() == jnum.tobytes()
    assert 8 < int(tvalid.sum()) < len(strings)


# --------------------------------------------------------------------------
# (d) the whole library: query order, query_batch with DELETE reviews
# (e) the webhook on a CEL template
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def library():
    jcel_d, tcel_d = jceld.CELDriver(), tceld.CELDriver()
    jd = TpuDriver(batch_bucket=16, cel_driver=jcel_d)
    td = TorchDriver(batch_bucket=16, device="cpu", cel_driver=tcel_d)
    jc = JClient(target=JTarget(), drivers=[jd, jcel_d],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    tc = TClient(target=TTarget(), drivers=[td, tcel_d],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert jload(jc) == tload(tc) == (46, 46)
    assert td.vocab._to_str == jd.vocab._to_str
    assert set(CEL_KINDS) <= set(td.lowered_kinds())
    assert not td.fallback_kinds()
    objects = _adversarial_pods(random.Random(3), 40) + \
        make_cluster_objects(160, seed=21)
    for o in objects:
        if o.get("kind") == "Ingress":
            jc.add_data(o)
            tc.add_data(o)
    return jd, jc, td, tc, objects


def _sorted_cons(client):
    return sorted(client.constraints(), key=lambda c: c.key())


def _kind_keyed(results):
    return [(r.constraint["kind"],) + key
            for r, key in zip(results, _keyed_in_order(results))]


def test_query_result_order_matches_jax(library):
    """``query`` runs the CEL constraints first, then the Rego ones, in
    both packages; ``render_query`` of a CEL kind is the CEL evaluator's
    answer."""
    jd, jc, td, tc, objects = library
    bodies = _bodies(objects, delete_every=7)
    jrev = _reviews(jc.target, JAugReview, jpolicy.parse_admission_review,
                    bodies)
    trev = _reviews(tc.target, TAugReview, tpolicy.parse_admission_review,
                    bodies)
    jcons, tcons = _sorted_cons(jc), _sorted_cons(tc)
    mixed = 0
    for jr, tr in zip(jrev, trev):
        jm = [c for c in jcons if jc.target.to_matcher(c.match).match(jr)]
        tm = [c for c in tcons if tc.target.to_matcher(c.match).match(tr)]
        got = _kind_keyed(td.query(TARGET, tm, tr).results)
        assert got == _kind_keyed(jd.query(TARGET, jm, jr).results)
        kinds = [k for k, _n, _m in got]
        if set(kinds) & set(CEL_KINDS) and set(kinds) - set(CEL_KINDS):
            mixed += 1
            first_rego = next(i for i, k in enumerate(kinds)
                              if k not in CEL_KINDS)
            assert not set(kinds[first_rego:]) & set(CEL_KINDS)
        for con in tm:
            if con.kind in CEL_KINDS:
                assert _keyed_in_order(td.render_query(
                    TARGET, con, tr).results) == _keyed_in_order(
                        td._cel.query(TARGET, [con], tr).results)
    assert mixed >= 3


def test_library_query_batch_with_deletes_matches_jax(library):
    """One ``query_batch`` of the whole library (CEL and Rego kinds
    mixed) over the population, every seventh review a DELETE: the same
    results in the same order per review as the JAX package."""
    jd, jc, td, tc, objects = library
    bodies = _bodies(objects, delete_every=7)
    want = jd.query_batch(TARGET, _sorted_cons(jc), _reviews(
        jc.target, JAugReview, jpolicy.parse_admission_review, bodies))
    got = td.query_batch(TARGET, _sorted_cons(tc), _reviews(
        tc.target, TAugReview, tpolicy.parse_admission_review, bodies))
    got_k = [_keyed_in_order(qr.results) for qr in got]
    assert got_k == [_keyed_in_order(qr.results) for qr in want]
    cel_names = {c.name for c in tc.constraints() if c.kind in CEL_KINDS}
    cel_deletes = [i for i, r in enumerate(got_k) if i % 7 == 6
                   and {n for n, _m in r} & cel_names]
    assert cel_deletes and sum(map(len, got_k)) > 100


def _admission(obj, uid, operation="CREATE"):
    group, _, version = obj.get("apiVersion", "").rpartition("/")
    meta = obj.get("metadata") or {}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": operation,
                        "kind": {"group": group, "version": version,
                                 "kind": obj.get("kind", "")},
                        "name": meta.get("name", ""),
                        "namespace": meta.get("namespace", ""),
                        "userInfo": {"username": "alice"},
                        "object": None if operation == "DELETE" else obj,
                        "oldObject": obj if operation == "DELETE" else None}}


def test_webhook_admits_cel_template_and_denies_like_jax(library):
    """The ``containerlimitscel`` ConstraintTemplate is admitted (the
    port's handler used to answer 422 without a CEL driver), and a Pod
    without a memory limit is denied with the JAX handler's message, on
    CREATE and on DELETE."""
    _jd, jc, _td, tc, _objects = library
    (tdoc, cdoc), _ = _library_cel_docs()
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "nolimit", "namespace": "default"},
           "spec": {"containers": [
               {"name": "c", "image": "openpolicyagent/opa",
                "securityContext": {"privileged": True}}]}}
    verdicts = {}
    for side, pol, client in (("jax", jpolicy, jc), ("port", tpolicy, tc)):
        h = pol.ValidationHandler(client)
        verdicts[side] = [
            (v.allowed, v.code, v.message, sorted(v.warnings))
            for v in (h.handle(_admission(copy.deepcopy(doc), uid, op))
                      for doc, uid, op in ((tdoc, "t", "CREATE"),
                                           (cdoc, "c", "CREATE"),
                                           (pod, "p", "CREATE"),
                                           (pod, "d", "DELETE")))]
    assert verdicts["port"] == verdicts["jax"]
    template, constraint, create, delete = verdicts["port"]
    assert template == constraint == (True, 200, "", [])
    assert create[:2] == delete[:2] == (False, 403)
    assert "container memory limit missing" in create[2]
    assert "Privileged container is not allowed: c" in create[2]
    without_cel = tpolicy.ValidationHandler(TClient(
        target=TTarget(), drivers=[TorchDriver(device="cpu")],
        enforcement_points=[WEBHOOK_EP, AUDIT_EP]))
    v = without_cel.handle(_admission(copy.deepcopy(tdoc), "t"))
    assert (v.allowed, v.code) == (False, 422)
