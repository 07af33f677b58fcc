"""gator generate-vap: emit ValidatingAdmissionPolicy manifests.

Reference: the VAP codegen path (k8scel/transform/make_vap_objects.go +
manageVAP at constrainttemplate_controller.go:503) — the fourth
enforcement point: policies shift INTO the apiserver.  The CEL driver and
``template_to_vap``/``constraint_to_vap_binding`` landed with the seed;
this is the offline CLI surface over them.

Reads ConstraintTemplates (K8sNativeValidation source) and their
constraints from ``-f`` files/dirs, prints one VAP per CEL template and
one VAPB per constraint as YAML documents (or ``--format json``).
Templates without a CEL source are skipped with a note (Rego-only
templates have no in-apiserver form); ``--require-generate-vap``
restricts emission to templates whose source opts in via
``generateVAP: true`` (the controller's gating).
"""

from __future__ import annotations

import argparse
import sys

import yaml

from gatekeeper_tpu_torch.gator import reader


def run_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator generate-vap")
    p.add_argument("--filename", "-f", action="append", default=[])
    p.add_argument("--output", "-o", default="",
                   help="write to file instead of stdout")
    p.add_argument("--format", default="yaml", choices=["yaml", "json"])
    p.add_argument("--require-generate-vap", action="store_true",
                   help="emit only templates whose CEL source sets "
                        "generateVAP: true (the in-cluster controller's "
                        "gating); default emits every CEL template")
    args = p.parse_args(argv)

    try:
        objs = reader.read_sources(args.filename, use_stdin=not args.filename)
    except OSError as e:
        print(f"error: reading: {e}", file=sys.stderr)
        return 1
    if not objs:
        print("no input data identified", file=sys.stderr)
        return 1

    try:
        docs, skipped = generate(objs, args.require_generate_vap)
    except Exception as e:
        print(f"error: generating VAP manifests: {e}", file=sys.stderr)
        return 1
    for kind, why in skipped:
        print(f"skipped {kind}: {why}", file=sys.stderr)
    if not docs:
        print("no CEL templates to generate from", file=sys.stderr)
        return 1
    if args.format == "json":
        import json

        out = json.dumps(docs, indent=4)
    else:
        out = "---\n".join(
            yaml.safe_dump(d, sort_keys=True, default_flow_style=False)
            for d in docs
        )
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def generate(objs, require_generate_vap: bool = False) -> tuple:
    """(manifests, skipped): VAPs for CEL templates + VAPBs for their
    constraints, in input order.  ``skipped`` lists (template kind,
    reason) for non-CEL or opted-out templates."""
    from gatekeeper_tpu_torch.apis.constraints import (CONSTRAINTS_GROUP,
                                                 Constraint)
    from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver

    driver = CELDriver()
    templates: dict = {}  # kind -> ConstraintTemplate
    constraints: list = []
    for obj in objs:
        kind = obj.get("kind", "")
        group = (obj.get("apiVersion", "") or "").split("/")[0]
        if kind == "ConstraintTemplate":
            t = ConstraintTemplate.from_unstructured(obj)
            templates[t.kind] = t
        elif group == CONSTRAINTS_GROUP:
            constraints.append(Constraint.from_unstructured(obj))
    docs: list = []
    skipped: list = []
    emitted: set = set()
    for kind, t in templates.items():
        if not driver.has_source_for(t):
            skipped.append((kind, "no K8sNativeValidation (CEL) source"))
            continue
        driver.add_template(t)
        compiled = driver._templates.get(kind)
        if require_generate_vap and not getattr(compiled, "generate_vap",
                                                False):
            skipped.append((kind, "generateVAP not set"))
            continue
        docs.append(driver.template_to_vap(t))
        emitted.add(kind)
    for con in constraints:
        if con.kind in emitted:
            docs.append(driver.constraint_to_vap_binding(
                con, templates[con.kind]))
    return docs, skipped
