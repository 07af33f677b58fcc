"""Mutation system: ordered registry + fixed-point apply loop.

Reference: pkg/mutation/system.go —
- mutators sorted by ID, applied in order (system.go:146-246)
- iterate until no mutator changes the object; max ``len(mutators)+1``
  iterations, else ErrNotConverging (system.go:174-246)
- mutators whose path schemas conflict (same node treated as object by one
  and list by another) are ALL disabled (pkg/mutation/schema, ErrConflicting-
  Schema)
- external-data placeholders resolve at convergence
  (system_external_data.go)

Port of ``gatekeeper_tpu/mutation/system.py``.  ``mutate_batch`` runs the
prefilter's ``[M, N]`` grids on ``device`` (default ``"cuda"``).  The
batched external-data lane is not ported: placeholders resolve through a
``provider_cache`` when one is given, else by the no-provider semantics of
their failurePolicy (UseDefault gives the default, Ignore the original
value, Fail raises).
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.mutation.core import _deep_equal
from gatekeeper_tpu_torch.mutation.mutators import BaseMutator, MutatorID, from_unstructured
from gatekeeper_tpu_torch.mutation.path_parser import ListNode, ObjectNode


class NotConvergingError(Exception):
    """Reference: ErrNotConverging (system.go:34)."""


class MutationSystem:
    def __init__(self, reporter=None, provider_cache=None):
        self._mutators: dict[MutatorID, BaseMutator] = {}
        self._conflicts: set[MutatorID] = set()
        self.reporter = reporter
        self.provider_cache = provider_cache
        # monotone registry revision: every upsert/remove bumps it, and
        # compiled artifacts (the batched-lane program, the device
        # prefilter) key their caches on it so mutator churn invalidates
        # them.  Initialized here — the old lazy __dict__.get conjuring
        # meant a never-mutated system had NO _revision attribute at all
        # and cache keys silently defaulted
        self._revision = 0
        # iterations the last ``mutate`` ran until convergence (1 = the
        # object was already at fixed point); the batched lane observes
        # this into gatekeeper_mutation_convergence_iterations
        self.last_iterations = 0

    def revision(self) -> int:
        """Registry revision, the compiled-lane cache key."""
        return self._revision

    # --- registry (reference: Upsert system.go:80, Remove :121) ----------
    def upsert(self, mutator: BaseMutator) -> None:
        self._mutators[mutator.id] = mutator
        self._revision += 1
        self._recompute_conflicts()

    def upsert_unstructured(self, obj: dict) -> BaseMutator:
        m = from_unstructured(obj)
        self.upsert(m)
        return m

    def remove(self, mutator_id: MutatorID) -> None:
        self._mutators.pop(mutator_id, None)
        self._revision += 1
        self._recompute_conflicts()

    def get(self, mutator_id: MutatorID) -> Optional[BaseMutator]:
        return self._mutators.get(mutator_id)

    def mutators(self) -> list[BaseMutator]:
        return [self._mutators[k] for k in sorted(self._mutators,
                                                  key=str)]

    def active(self) -> list[BaseMutator]:
        """Mutators that may run: registry order minus schema conflicts
        (the set both the fixed-point loop and the batched lane apply)."""
        return [m for m in self.mutators() if m.id not in self._conflicts]

    def conflicts(self) -> set:
        return set(self._conflicts)

    def _recompute_conflicts(self) -> None:
        """Schema conflict detection (reference: pkg/mutation/schema) —
        if two mutators disagree on whether a path node is an object or a
        keyed list, none of the conflicting mutators may run."""
        by_prefix: dict[tuple, dict] = {}
        conflicts: set[MutatorID] = set()
        for m in self._mutators.values():
            prefix: tuple = ()
            for node in m.path:
                if isinstance(node, ObjectNode):
                    kind, detail = "object", node.name
                    key = ("o", node.name)
                else:
                    kind, detail = "list", node.key_field
                    key = ("l",)
                slot = by_prefix.setdefault(prefix, {})
                entry = slot.setdefault("kinds", {})
                entry.setdefault(kind, set()).add(m.id)
                if kind == "list":
                    keyfields = slot.setdefault("keyfields", {})
                    keyfields.setdefault(node.key_field, set()).add(m.id)
                prefix = prefix + (key,)
        for slot in by_prefix.values():
            kinds = slot.get("kinds", {})
            if "object" in kinds and "list" in kinds:
                for ids in kinds.values():
                    conflicts.update(ids)
            keyfields = slot.get("keyfields", {})
            if len(keyfields) > 1:
                for ids in keyfields.values():
                    conflicts.update(ids)
        self._conflicts = conflicts

    # --- the apply loop (reference: Mutate system.go:146-246) ------------
    def mutate(self, obj: dict, namespace: Optional[dict] = None,
               source: str = "") -> bool:
        """Fixed-point application; mutates ``obj`` in place, returns
        changed?"""
        active = self.active()
        self.last_iterations = 0
        if not active:
            return False
        original = copy.deepcopy(obj)
        max_iterations = len(active) + 1
        any_change = False
        for it in range(max_iterations):
            iteration_changed = False
            for m in active:
                if not m.matches(obj, namespace=namespace, source=source):
                    continue
                old = copy.deepcopy(obj)
                if m.mutate_obj(obj) and not _deep_equal(old, obj):
                    iteration_changed = True
                    any_change = True
            if not iteration_changed:
                self.last_iterations = it + 1
                self._resolve_placeholders(obj)
                return any_change
        # restore: a non-converging system must not half-mutate (the
        # reference returns the error without applying)
        obj.clear()
        obj.update(original)
        raise NotConvergingError(
            f"mutation system failed to converge after {max_iterations} "
            "iterations"
        )

    def mutate_batch(self, objects: list, namespace=None,
                     source: str = "", device: str = "cuda") -> list:
        """Batch mutation with the device path-match prefilter (BASELINE
        config #4): the [M, N] would-change grid runs once on device; the
        host fixed-point walk runs ONLY on objects some mutator would
        actually touch (plus every object when non-lowerable mutators
        exist — they stay host-authoritative).  Returns changed flags.
        The grids run on ``device``."""
        active = self.active()
        if not active or not objects:
            return [False] * len(objects)
        from gatekeeper_tpu_torch import resolve_device
        from gatekeeper_tpu_torch.mutation.device import MutationPrefilter

        # cache keyed on the system REVISION (not just ids: an in-place
        # upsert changing a mutator's value/location must recompile)
        rev = self._revision
        pre = self.__dict__.get("_prefilter")
        if pre is None or self.__dict__.get("_prefilter_rev") != rev \
                or pre.device != resolve_device(device):
            pre = MutationPrefilter(device=device)
            for m in active:
                pre.add_mutator(m)
            self.__dict__["_prefilter"] = pre
            self.__dict__["_prefilter_rev"] = rev
        all_lowered = len(pre.lowered_ids()) == len(active)
        changed = [False] * len(objects)
        if all_lowered:
            # the walk must also run where it would ERROR, so callers see
            # the same MutateError the per-object path raises
            needs = (pre.would_change(active, objects)
                     | pre.would_error(active, objects)).any(axis=0)
        else:
            needs = [True] * len(objects)
        for oi, obj in enumerate(objects):
            if needs[oi]:
                changed[oi] = self.mutate(obj, namespace=namespace,
                                          source=source)
        return changed

    def _resolve_placeholders(self, obj: Any) -> None:
        """Resolve external-data placeholders at convergence
        (reference: system.go:214 → system_external_data.go)."""
        from gatekeeper_tpu_torch.externaldata.placeholders import (
            ExternalDataPlaceholder,
        )

        # pass 1: collect every placeholder, then warm the cache with ONE
        # concurrent multi-provider prefetch (async batch join) so pass 2's
        # per-placeholder resolve() hits cache instead of serial RTTs
        pending = []

        def collect(node):
            if isinstance(node, dict):
                for v in node.values():
                    if isinstance(v, ExternalDataPlaceholder):
                        pending.append(v)
                    else:
                        collect(v)
            elif isinstance(node, list):
                for v in node:
                    if isinstance(v, ExternalDataPlaceholder):
                        pending.append(v)
                    else:
                        collect(v)

        collect(obj)
        if self.provider_cache is not None and len(pending) > 1:
            self.provider_cache.prefetch(
                (ph.provider, ph.original_value) for ph in pending)

        def walk(node):
            if isinstance(node, dict):
                for k, v in list(node.items()):
                    if isinstance(v, ExternalDataPlaceholder):
                        node[k] = self._resolve_one(v)
                    else:
                        walk(v)
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    if isinstance(v, ExternalDataPlaceholder):
                        node[i] = self._resolve_one(v)
                    else:
                        walk(v)

        walk(obj)

    def _resolve_one(self, ph) -> Any:
        if self.provider_cache is None:
            # no providers configured: keep the original value semantics of
            # failurePolicy
            if ph.failure_policy == "UseDefault":
                return ph.default
            if ph.failure_policy == "Ignore":
                return ph.original_value
            raise RuntimeError(
                f"external data provider {ph.provider!r} unavailable"
            )
        return self.provider_cache.resolve(ph)
