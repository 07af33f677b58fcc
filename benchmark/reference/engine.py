"""The plain reference: Gatekeeper's semantics on the interpreters.

Every verdict here comes from ``gkref``, a frozen copy of the JAX package's
Rego and CEL interpreters behind its constraint-framework client, evaluating
one object against one constraint at a time: no grid, no columns, no kernels
and no batching.  One template is evaluated by a plain join instead of the
interpreter: ``K8sUniqueIngressHost`` walks the whole Ingress inventory for
every review (linear in the inventory: ~0.4 s a review at 17,000 Ingresses),
so ``IngressJoinDriver`` answers it from a host index.  Its answers are held
against the interpreter's, and every verdict against the library's own
samples, in ``tests/test_benchmark_reference.py``.

Nothing here imports JAX, the JAX package or the PyTorch port.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

from gkref.apis.constraints import AUDIT_EP  # noqa: E402
from gkref.client.client import Client  # noqa: E402
from gkref.client.types import QueryResponse, Result  # noqa: E402
from gkref.drivers.cel_driver import CELDriver  # noqa: E402
from gkref.drivers.rego_driver import RegoDriver  # noqa: E402
from gkref.match.match import SOURCE_ORIGINAL  # noqa: E402
from gkref.target.review import AugmentedUnstructured  # noqa: E402
from gkref.target.target import K8sValidationTarget  # noqa: E402
from gkref.utils.unstructured import load_yaml_file  # noqa: E402

JOIN_KIND = "K8sUniqueIngressHost"
JOIN_MSG = "ingress host conflicts with an existing ingress <%s>"


class IngressJoinDriver:
    """``K8sUniqueIngressHost`` as a host index over the Ingress inventory.

    The template's rule: an Ingress under review violates once for each of
    its rule hosts that another inventory Ingress (any namespace, any
    apiVersion) also names, where "another" means not the same namespace
    and name as the reviewed object; the message is the host in
    ``JOIN_MSG``.  As in Rego, a comparison with a missing field is
    undefined, so an object without a namespace or name is never identical
    to an inventory entry."""

    def __init__(self):
        self._hosts: dict = {}  # host -> {(ns, name): (has_ns, has_name)}
        self._entries: dict = {}  # inventory path -> hosts

    def name(self) -> str:
        return "ingress-join"

    def has_source_for(self, template) -> bool:
        return template.kind == JOIN_KIND

    def add_template(self, template) -> None:
        pass

    def remove_template(self, template_kind: str) -> None:
        pass

    def add_constraint(self, constraint) -> None:
        pass

    def remove_constraint(self, constraint) -> None:
        pass

    def add_data(self, target, path, data) -> None:
        if len(path) != 5 or path[0] != "namespace" or path[3] != "Ingress":
            return
        self.remove_data(target, path)
        meta = data.get("metadata") if isinstance(data, dict) else None
        meta = meta if isinstance(meta, dict) else {}
        ident = (meta.get("namespace"), meta.get("name"))
        hosts = set(_hosts_of(data))
        for h in hosts:
            self._hosts.setdefault(h, {})[tuple(path)] = ident
        self._entries[tuple(path)] = hosts

    def remove_data(self, target, path) -> None:
        for h in self._entries.pop(tuple(path), ()):
            self._hosts.get(h, {}).pop(tuple(path), None)

    def wipe_data(self) -> None:
        self._hosts.clear()
        self._entries.clear()

    def query(self, target, constraints, review, cfg=None) -> QueryResponse:
        resp = QueryResponse()
        req = review.request
        if (req.kind or {}).get("kind") != "Ingress":
            return resp
        obj = req.object
        meta = obj.get("metadata") if isinstance(obj, dict) else None
        meta = meta if isinstance(meta, dict) else {}
        ns, name = meta.get("namespace"), meta.get("name")
        msgs = set()
        for host in _hosts_of(obj):
            for other_ns, other_name in self._hosts.get(host, {}).values():
                identical = (ns is not None and name is not None
                             and other_ns == ns and other_name == name)
                if not identical:
                    msgs.add(JOIN_MSG % host)
                    break
        for constraint in constraints:
            for msg in sorted(msgs):
                resp.results.append(Result(target=target, msg=msg,
                                           constraint=constraint.raw))
        return resp

    def dump(self) -> dict:
        return {}

    def get_description_for_stat(self, stat_name: str) -> str:
        return "unknown stat"


def _hosts_of(obj) -> list:
    spec = obj.get("spec") if isinstance(obj, dict) else None
    rules = spec.get("rules") if isinstance(spec, dict) else None
    if not isinstance(rules, list):
        return []
    return [r["host"] for r in rules
            if isinstance(r, dict) and isinstance(r.get("host"), str)]


def library_docs(library_root: str) -> list:
    """(template doc, [constraint docs]) for every template of the
    library's ``general`` and ``pod-security-policy`` trees, in the order
    the port's ``load_library`` adds them."""
    import glob

    paths = sorted(
        glob.glob(os.path.join(library_root, "general", "*",
                               "template.yaml"))
        + glob.glob(os.path.join(library_root, "pod-security-policy", "*",
                                 "template.yaml")))
    out = []
    for tpath in paths:
        doc = load_yaml_file(tpath)[0]
        cpath = os.path.join(os.path.dirname(tpath), "samples",
                             "constraint.yaml")
        cons = load_yaml_file(cpath) if os.path.exists(cpath) else []
        out.append((doc, cons))
    return out


def constraint_key(doc: dict) -> tuple:
    return doc.get("kind", ""), (doc.get("metadata") or {}).get("name", "")


def new_client(library_root: str, keys=None, join: bool = True) -> Client:
    """A client with the library's templates and sample constraints (only
    the constraints whose (kind, name) is in ``keys``, when given).  With
    ``join`` False the interpreter evaluates ``K8sUniqueIngressHost``
    too."""
    drivers = ([IngressJoinDriver()] if join else []) + [RegoDriver(),
                                                         CELDriver()]
    client = Client(target=K8sValidationTarget(), drivers=drivers)
    for tdoc, cdocs in library_docs(library_root):
        cdocs = [c for c in cdocs if keys is None or constraint_key(c) in keys]
        if keys is not None and not cdocs:
            continue
        client.add_template(tdoc)
        for c in cdocs:
            client.add_constraint(c)
    return client


def add_inventory(client: Client, objects) -> None:
    """The referential inventory the program is given: every Ingress."""
    for o in objects:
        if o.get("kind") == "Ingress":
            client.add_data(o)


def audit_results(client: Client, obj: dict) -> dict:
    """{(kind, name): [msg, ...]} of one object as the audit reviews it."""
    resp = client.review(AugmentedUnstructured(object=obj,
                                               source=SOURCE_ORIGINAL),
                         enforcement_point=AUDIT_EP)
    out: dict = {}
    for r in resp.results():
        out.setdefault(constraint_key(r.constraint), []).append(r.msg)
    return out
