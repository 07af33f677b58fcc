"""Level-synchronous batched expansion: the audit sweep's generator stage.

``expansion.System.Expand`` walks one base at a time: expand → mutate
each resultant (Source=Generated) → recurse.  At sweep scale that is a
per-object host loop in front of every generator object.  This stage
runs the SAME semantics level-synchronously across a whole chunk of
bases: each generation level expands structurally, then every resultant
of that level across all bases batch-mutates through ONE
:class:`mutlane.lane.MutationLane` pass before the next level expands
(mutation must precede deeper expansion — the reference recurses on the
MUTATED resultant, and a mutator can rewrite the subtree a nested
generator extracts).

Per-base output order, the depth cap (30), owner-ref/mock-name stamping
and ``enforcementAction`` overrides reproduce the recursive reference
exactly — pinned by tests/test_mutlane_expansion.py, which asserts this
stage bit-identical to ``expansion/system.py`` over the edge cases the
recursive path never had tests for.

Port of ``gatekeeper_tpu/mutlane/expand_stage.py``: the stage's lane runs
its prefilter on ``device`` (default ``"cuda"``); metrics and tracing are
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from gatekeeper_tpu_torch.expansion.system import (MAX_RECURSION_DEPTH,
                                             ExpansionError,
                                             ExpansionSystem, Resultant)
from gatekeeper_tpu_torch.match.match import SOURCE_GENERATED, SOURCE_ORIGINAL
from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of


@dataclass
class ExpandResult:
    """One base's expansion outcome: resultants in the reference's
    depth-first output order, or an error that (like the reference's
    raised exception) voids the base's resultants entirely."""

    resultants: list
    error: Optional[str] = None


class _Node:
    __slots__ = ("obj", "depth", "children", "template_name",
                 "enforcement_action")

    def __init__(self, obj, depth, template_name="",
                 enforcement_action=""):
        self.obj = obj
        self.depth = depth
        self.children: list = []
        self.template_name = template_name
        self.enforcement_action = enforcement_action


class ExpansionStage:
    """Batched front of an :class:`ExpansionSystem` (which stays the
    recursive reference)."""

    def __init__(self, expansion_system: ExpansionSystem, lane=None,
                 device: str = "cuda"):
        self.expansion_system = expansion_system
        self.lane = lane
        if lane is None and expansion_system.mutation_system is not None:
            from gatekeeper_tpu_torch.mutlane.lane import MutationLane

            self.lane = MutationLane(expansion_system.mutation_system,
                                     device=device)

    def expand_batch(self, bases: Sequence[dict], namespaces=None,
                     source: str = "") -> list:
        """Expand a chunk of bases; returns one :class:`ExpandResult`
        per base.  ``namespaces`` is a parallel list of Namespace
        objects (or None) — each base's resultants mutate under its own
        namespace, like the reference."""
        templates = self.expansion_system.templates()
        errors: dict = {}  # base index -> first error message
        roots = [_Node(obj, 0) for obj in bases]

        def ns_of(bi):
            return namespaces[bi] if namespaces else None

        # frontier: (base index, node) pairs of the generation being
        # expanded; level-synchronous so every level's resultants across
        # ALL bases mutate in one batched lane pass
        frontier = [(bi, node) for bi, node in enumerate(roots)]
        while frontier:
            produced: list = []  # (base index, child node)
            for bi, node in frontier:
                if bi in errors:
                    continue
                if node.depth >= MAX_RECURSION_DEPTH:
                    # reference: _expand_recursive raises on ENTRY past
                    # the cap, voiding the whole base
                    errors[bi] = (f"maximum recursion depth of "
                                  f"{MAX_RECURSION_DEPTH} reached")
                    continue
                try:
                    children = self._expand_structural(node, templates,
                                                       ns_of(bi))
                except ExpansionError as e:
                    errors[bi] = str(e)
                    continue
                node.children = children
                produced.extend((bi, c) for c in children)
            produced = [(bi, c) for bi, c in produced if bi not in errors]
            if produced and self.lane is not None:
                outcomes = self.lane.mutate_objects(
                    [c.obj for _bi, c in produced],
                    namespaces=[ns_of(bi) for bi, _c in produced],
                    source=SOURCE_GENERATED, want_objects=True)
                for (bi, c), out in zip(produced, outcomes):
                    if out.error is not None:
                        # the reference's system.mutate raise aborts the
                        # whole base's expand
                        errors.setdefault(bi, out.error)
                        continue
                    c.obj = out.obj
            frontier = [(bi, c) for bi, c in produced if bi not in errors]

        results = []
        for bi, root in enumerate(roots):
            if bi in errors:
                results.append(ExpandResult([], error=errors[bi]))
            else:
                results.append(ExpandResult(self._ordered(root)))
        return results

    def _expand_structural(self, node: _Node, templates,
                           namespace) -> list:
        """One node's children, NOT yet mutated (reference:
        _expand_one minus the mutation system application)."""
        obj = node.obj
        _group, version, kind = gvk_of(obj)
        if not kind or not version:
            raise ExpansionError(
                f"cannot expand resource {name_of(obj)} with empty GVK"
            )
        out = []
        for t in templates:
            if not t.applies_to(obj):
                continue
            child_obj = ExpansionSystem._expand_resource(obj, namespace, t)
            out.append(_Node(child_obj, node.depth + 1,
                             template_name=t.name,
                             enforcement_action=t.enforcement_action))
        return out

    def _ordered(self, root: _Node) -> list:
        """The recursive reference's output order: for each child, its
        subtree's output first; then the children themselves."""
        out: list = []
        for c in root.children:
            out.extend(self._ordered(c))
        out.extend(Resultant(obj=c.obj, template_name=c.template_name,
                             enforcement_action=c.enforcement_action)
                   for c in root.children)
        return out


class BatchedExpander:
    """Batched equivalent of :class:`expansion.expander.Expander` (offline
    gator expand): same namespace-resolution quirks, base mutation
    through the lane, then the level-synchronous stage.  ``expand_all``
    reproduces the reference CLI's semantics including abort-on-first-
    error ordering."""

    def __init__(self, objs: Sequence[dict], differential: bool = False,
                 device: str = "cuda"):
        from gatekeeper_tpu_torch.expansion.expander import Expander

        # reuse the reference Expander's object partitioning + namespace
        # resolution (deep-copied namespace map, synthetic default)
        self._ref = Expander(objs)
        self._stage = None
        self._lane = None
        if self._ref._system is not None:
            from gatekeeper_tpu_torch.mutlane.lane import MutationLane

            self._lane = MutationLane(
                self._ref._system.mutation_system,
                differential=differential, device=device)
            self._stage = ExpansionStage(self._ref._system,
                                         lane=self._lane)

    def namespace_for(self, obj: dict):
        return self._ref.namespace_for(obj)

    def expand_all(self, objs: Sequence[dict]) -> list:
        """Flattened resultants of every base, in the per-object CLI
        order; raises the FIRST base's error like the sequential
        reference loop would."""
        if self._stage is None:
            return []
        namespaces = [self.namespace_for(o) for o in objs]
        # base mutation precedes expansion (Expander.expand does this in
        # place per object; batched: one lane pass over every base)
        bases = list(objs)
        if self._lane is not None:
            outcomes = self._lane.mutate_objects(
                bases, namespaces=namespaces, source=SOURCE_ORIGINAL,
                want_objects=True)
            for i, out in enumerate(outcomes):
                if out.error is not None:
                    raise ExpansionError(out.error)
                bases[i] = out.obj
        results = self._stage.expand_batch(bases, namespaces)
        flat: list = []
        for r in results:
            if r.error is not None:
                raise ExpansionError(r.error)
            flat.extend(r.resultants)
        return flat
