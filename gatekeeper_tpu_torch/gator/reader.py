"""Input readers for the gator CLI (reference: pkg/gator/reader)."""

from __future__ import annotations

import os
import sys
from typing import Iterable

from gatekeeper_tpu_torch.apis.constraints import CONSTRAINTS_GROUP
from gatekeeper_tpu_torch.utils.unstructured import gvk_of, load_yaml_objects

YAML_EXTS = (".yaml", ".yml")
JSON_EXTS = (".json",)


def is_template(obj: dict) -> bool:
    group, _, kind = gvk_of(obj)
    return kind == "ConstraintTemplate" and group == "templates.gatekeeper.sh"


def is_constraint(obj: dict) -> bool:
    group, _, _ = gvk_of(obj)
    return group == CONSTRAINTS_GROUP


def is_expansion_template(obj: dict) -> bool:
    group, _, kind = gvk_of(obj)
    return kind == "ExpansionTemplate" and group == "expansion.gatekeeper.sh"


def is_admission_review(obj: dict) -> bool:
    """AdmissionReview fixture objects review the embedded request
    (operation/oldObject/userInfo intact) instead of a bare object —
    how upstream gator exercises UPDATE/DELETE-delta policies
    (reference: pkg/gator/reader read paths)."""
    group, _, kind = gvk_of(obj)
    return kind == "AdmissionReview" and group == "admission.k8s.io"


def read_sources(
    filenames: Iterable[str] = (), images: Iterable[str] = (), use_stdin: bool = False
) -> list[dict]:
    """Gather unstructured objects from files/dirs/stdin
    (reference: cmd/gator/test reader.ReadSources)."""
    objs: list[dict] = []
    for fname in filenames:
        if os.path.isdir(fname):
            for root, _dirs, files in os.walk(fname):
                for f in sorted(files):
                    if f.endswith(YAML_EXTS) or f.endswith(JSON_EXTS):
                        objs.extend(_read_file(os.path.join(root, f)))
        else:
            objs.extend(_read_file(fname))
    if use_stdin:
        objs.extend(load_yaml_objects(sys.stdin.read()))
    return objs


def _read_file(path: str) -> list[dict]:
    with open(path) as f:
        text = f.read()
    if path.endswith(JSON_EXTS):
        import json

        doc = json.loads(text)
        return doc if isinstance(doc, list) else [doc]
    return load_yaml_objects(text)
