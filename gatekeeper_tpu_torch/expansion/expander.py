"""Offline expander used by gator test/expand (reference: pkg/gator/expand).

Resolves namespaces from the supplied object set (with the reference's
quirks: a resource with no namespace gets an EMPTY Namespace object, an
unknown namespace named "default" gets a synthetic default —
expand.go:109-121) and expands generator resources through the expansion
system with mutators applied.
"""

from __future__ import annotations

from typing import Optional, Sequence

import copy

from gatekeeper_tpu_torch.expansion.system import EXPANSION_GROUP, ExpansionSystem
from gatekeeper_tpu_torch.expansion.system import Resultant  # noqa: F401 (re-export)
from gatekeeper_tpu_torch.mutation.mutators import MUTATIONS_GROUP, MUTATOR_KINDS
from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of, namespace_of


class Expander:
    def __init__(self, objs: Sequence[dict]):
        self._namespaces: dict[str, dict] = {}
        mutators = []
        expansion_templates = []
        for obj in objs:
            group, _, kind = gvk_of(obj)
            if kind == "Namespace" and group == "":
                # deep copy: the reference's typed conversion detaches the
                # namespace map from caller objects (expand.go:201-208), so
                # base mutation must not leak into namespaceSelector matching
                self._namespaces[name_of(obj)] = copy.deepcopy(obj)
            elif kind == "ExpansionTemplate" and group == EXPANSION_GROUP:
                expansion_templates.append(obj)
            elif group == MUTATIONS_GROUP and kind in MUTATOR_KINDS:
                # unknown kinds in the mutations group are plain objects
                # (reference: isMutator filters the four kinds, expand.go)
                mutators.append(obj)
        self._system = None
        if expansion_templates:
            from gatekeeper_tpu_torch.mutation.system import MutationSystem

            mut_system = MutationSystem()
            for m in mutators:
                mut_system.upsert_unstructured(m)
            self._system = ExpansionSystem(mutation_system=mut_system)
            for et in expansion_templates:
                self._system.upsert_template(et)

    def namespace_for(self, obj: dict) -> Optional[dict]:
        """Reference: NamespaceForResource (expand.go:109-121)."""
        ns = namespace_of(obj)
        if ns == "":
            return {}  # empty Namespace object, non-nil
        hit = self._namespaces.get(ns)
        if hit is not None:
            return hit
        if ns == "default":
            return {"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": "default"}}
        return None

    def expand(self, obj: dict) -> list:
        if self._system is None:
            return []
        ns = self.namespace_for(obj)
        # the base resource is mutated (in place, Source=Original) before
        # expansion — reference: Expander.Expand (expand.go:87-98)
        if self._system.mutation_system is not None:
            from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL

            self._system.mutation_system.mutate(
                obj, namespace=ns, source=SOURCE_ORIGINAL
            )
        return self._system.expand(obj, namespace=ns)
