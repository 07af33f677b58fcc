"""gator verify: declarative policy test suites.

Reference: pkg/gator/verify — Suite{tests[{name, template, constraint,
expansion?, cases[{name, object, inventory[], assertions[]}]}]} with
go-test-style output.  Assertion semantics (assertion.go): ``violations`` is
"yes" (≥1), "no" (0) or an exact int, counted over violations whose message
matches the optional ``message`` regex; default "yes".
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from gatekeeper_tpu_torch.apis.constraints import GATOR_EP
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver
from gatekeeper_tpu_torch.expansion.expander import Expander
from gatekeeper_tpu_torch.gator import reader
from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED, SOURCE_ORIGINAL
from gatekeeper_tpu_torch.target.review import AugmentedUnstructured
from gatekeeper_tpu_torch.target.target import K8sValidationTarget
from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file


class SuiteError(Exception):
    pass


@dataclass
class CaseResult:
    name: str
    error: str = ""
    skipped: bool = False
    duration_s: float = 0.0
    # rego print() output captured during this case (reference: the
    # PrintHook the verify runner wires into the driver, SURVEY §2.8)
    prints: list = field(default_factory=list)


@dataclass
class TestResult:
    name: str
    cases: list = field(default_factory=list)
    error: str = ""
    skipped: bool = False


@dataclass
class SuiteResult:
    path: str
    tests: list = field(default_factory=list)
    error: str = ""
    skipped: bool = False

    def failed(self) -> bool:
        if self.error:
            return True
        for t in self.tests:
            if t.error:
                return True
            for c in t.cases:
                if c.error:
                    return True
        return False


def is_suite(obj: dict) -> bool:
    return (obj.get("kind") == "Suite"
            and str(obj.get("apiVersion", "")).startswith(
                "test.gatekeeper.sh/"))


def find_suites(paths) -> list[str]:
    """Reference: read_suites.go:50 — walk dirs for Suite yaml files."""
    out = []
    for path in paths:
        if os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for f in sorted(files):
                    if not f.endswith((".yaml", ".yml")):
                        continue
                    full = os.path.join(root, f)
                    try:
                        docs = load_yaml_file(full)
                    except Exception:
                        continue
                    if any(isinstance(d, dict) and is_suite(d)
                           for d in docs):
                        out.append(full)
        else:
            out.append(path)
    return out


def _assert_case(assertions, results) -> Optional[str]:
    """Returns error string or None (reference: assertion.go:38-130)."""
    if not assertions:
        assertions = [{}]
    for a in assertions:
        msg_re = a.get("message")
        try:
            pattern = re.compile(msg_re) if msg_re else None
        except re.error as e:
            return f"invalid message regex {msg_re!r}: {e}"
        matching = [r for r in results
                    if pattern is None or pattern.search(r.msg)]
        want = a.get("violations", "yes")
        got = len(matching)
        msgs = [r.msg for r in results]
        if isinstance(want, bool):  # YAML yes/no parse to bool
            want = "yes" if want else "no"
        if isinstance(want, int):
            if got != want:
                return (f"got {got} violations but want exactly {want}: "
                        f"messages {msgs}")
        elif want == "yes":
            if got == 0:
                return f"got 0 violations but want at least 1: messages {msgs}"
        elif want == "no":
            if got > 0:
                return f"got {got} violations but want none: messages {msgs}"
        else:
            return ('assertion.violations must be a nonnegative integer, '
                    '"yes", or "no"')
    return None


def run_suite(path: str, filter_re: Optional[str] = None) -> SuiteResult:
    sr = SuiteResult(path=path)
    docs = [d for d in load_yaml_file(path) if is_suite(d)]
    if not docs:
        sr.error = "no Suite found"
        return sr
    suite = docs[0]
    if suite.get("skip"):
        sr.skipped = True
        return sr
    base = os.path.dirname(os.path.abspath(path))
    pattern = re.compile(filter_re) if filter_re else None
    for test in suite.get("tests") or []:
        tr = TestResult(name=test.get("name", ""))
        sr.tests.append(tr)
        if test.get("skip"):
            tr.skipped = True
            continue
        if pattern and not pattern.search(tr.name):
            tr.skipped = True
            continue
        try:
            client, expander_objs = _build_test_client(test, base)
        except Exception as e:
            tr.error = str(e)
            continue
        for case in test.get("cases") or []:
            cr = CaseResult(name=case.get("name", ""))
            tr.cases.append(cr)
            if case.get("skip"):
                cr.skipped = True
                continue
            t0 = time.perf_counter()
            # capture rego print() output for this case only (the hook is
            # a contextvar: concurrent evaluation elsewhere is unaffected)
            from gatekeeper_tpu_torch.lang.rego import builtins as _builtins

            tok = _builtins.set_print_hook(cr.prints.append)
            try:
                results = _run_case(client, case, base, expander_objs)
                err = _assert_case(case.get("assertions"), results)
                if err:
                    cr.error = err
            except Exception as e:
                cr.error = str(e)
            finally:
                _builtins.reset_print_hook(tok)
            cr.duration_s = time.perf_counter() - t0
    return sr


def _build_test_client(test: dict, base: str):
    template_path = test.get("template", "")
    if not template_path:
        raise SuiteError("test has no template")
    client = Client(
        target=K8sValidationTarget(),
        drivers=[RegoDriver(), CELDriver()],
        enforcement_points=[GATOR_EP],
    )
    template = load_yaml_file(os.path.join(base, template_path))[0]
    client.add_template(template)
    expander_objs = []
    constraint_path = test.get("constraint", "")
    if constraint_path:
        constraint = load_yaml_file(os.path.join(base, constraint_path))[0]
        client.add_constraint(constraint)
    expansion_path = test.get("expansion", "")
    if expansion_path:
        expander_objs.extend(load_yaml_file(os.path.join(base,
                                                         expansion_path)))
    return client, expander_objs


def _run_case(client: Client, case: dict, base: str, expander_objs):
    object_path = case.get("object", "")
    if not object_path:
        raise SuiteError("case has no object")
    objs = load_yaml_file(os.path.join(base, object_path))
    if not objs:
        raise SuiteError(f"no objects in {object_path}")
    under_test = objs[0]
    inventory = []
    for inv_path in case.get("inventory") or []:
        inventory.extend(load_yaml_file(os.path.join(base, inv_path)))
    for obj in inventory:
        client.add_data(obj)
    try:
        from gatekeeper_tpu_torch.gator import reader

        if reader.is_admission_review(under_test):
            # AdmissionReview fixture: review the embedded request
            # (operation/oldObject/userInfo — the webhook's view) with
            # the namespace resolved from the fixture set; no expansion,
            # which operates on bare objects
            from gatekeeper_tpu_torch.target.review import AugmentedReview
            from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

            req = parse_admission_review(under_test)
            expander = Expander([*inventory, *expander_objs])
            ns = expander.namespace_for(req.object or req.old_object or {})
            return client.review(
                AugmentedReview(admission_request=req, namespace=ns,
                                is_admission=True),
                enforcement_point=GATOR_EP,
            ).results()
        # namespaces resolved gator-style from object+inventory+expansion set
        expander = Expander([under_test, *inventory, *expander_objs])
        ns = expander.namespace_for(under_test)
        responses = client.review(
            AugmentedUnstructured(object=under_test, namespace=ns,
                                  source=SOURCE_ORIGINAL),
            enforcement_point=GATOR_EP,
        )
        for resultant in expander.expand(under_test):
            r_resp = client.review(
                AugmentedUnstructured(object=resultant.obj, namespace=ns,
                                      source=SOURCE_GENERATED),
                enforcement_point=GATOR_EP,
            )
            from gatekeeper_tpu_torch.expansion import aggregate

            aggregate.override_enforcement_action(
                resultant.enforcement_action, r_resp)
            aggregate.aggregate_responses(resultant.template_name, responses,
                                          r_resp)
        return responses.results()
    finally:
        # per-case data must not leak to the next case, even on errors
        for obj in inventory:
            client.remove_data(obj)


def print_result(sr: SuiteResult, out=None) -> None:
    """go-test-style output (reference: verify/printer.go) to ``out``
    (default: the ``sys.stdout`` of the call, so an in-process caller
    that redirects it captures the report)."""
    out = out if out is not None else sys.stdout
    if sr.skipped:
        out.write(f"ok\t{sr.path}\t(skipped)\n")
        return
    if sr.error:
        out.write(f"FAIL\t{sr.path}\t{sr.error}\n")
        return
    for t in sr.tests:
        status = "SKIP" if t.skipped else ("FAIL" if t.error or any(
            c.error for c in t.cases) else "ok")
        out.write(f"=== RUN   {t.name}\n")
        if t.error:
            out.write(f"    error: {t.error}\n")
        for c in t.cases:
            if c.skipped:
                out.write(f"    --- SKIP: {t.name}/{c.name}\n")
                continue
            for line in getattr(c, "prints", []):
                # go-test idiom: print output interleaves above the verdict
                out.write(f"        print: {line}\n")
            if c.error:
                out.write(f"    --- FAIL: {t.name}/{c.name} "
                          f"({c.duration_s:.3f}s)\n        {c.error}\n")
            else:
                out.write(f"    --- PASS: {t.name}/{c.name} "
                          f"({c.duration_s:.3f}s)\n")
        out.write(f"--- {status}: {t.name}\n")
    out.write(("FAIL" if sr.failed() else "ok") + f"\t{sr.path}\n")


def run_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator verify")
    p.add_argument("paths", nargs="*", default=["."])
    p.add_argument("--run", default=None,
                   help="regex filtering test names (like go test -run)")
    args = p.parse_args(argv)

    suites = find_suites(args.paths or ["."])
    if not suites:
        print("no test suites found", file=sys.stderr)
        return 1
    failed = False
    for s in suites:
        sr = run_suite(s, filter_re=args.run)
        print_result(sr)
        failed |= sr.failed()
    return 1 if failed else 0
