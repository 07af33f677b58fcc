"""The batched mutation lane: one columnar pass classifies a burst.

A burst of N objects against an M-mutator registry costs the reference
``N x (fixed-point loop over M)`` host walks with per-application
deepcopies.  Here the registry compiles ONCE (cached on the system
revision) into the change/error predicate programs of
``mutation/device.py``; a burst columnizes once, the [M, N] grids run in
one pass, and every object lands in one of four outcome lanes:

``noop``
    No active mutator matches-and-would-touch the object: the fixed
    point would terminate after iteration 1 with no change, so the empty
    patch is emitted directly — no deepcopy, no walk.  This is the
    steady-state majority of admission traffic.
``device``
    Exactly one *solo-safe* (see below) lowered mutator would change the
    object and its location is a pure object-node path: the RFC-6902
    ops are emitted straight from the flattened presence/kind columns
    (add-at-first-absent-prefix / add-or-replace-at-leaf), bit-identical
    to ``json_patch(before, converged)``.
``solo``
    Exactly one solo-safe lowered mutator would change the object but
    its location crosses a list node: one targeted ``mutate_obj``
    application (a single-application fixed point by solo-safety)
    replaces the full M-mutator convergence loop.
``host``
    Everything else — matching host-only mutators, multiple interacting
    mutators, error outcomes — runs the authoritative
    per-object reference path (``MutationSystem.mutate`` + diff), so
    mixed batches stay bit-identical by construction.

*Solo-safety* is a compile-time independence proof: mutator ``m`` is
solo-safe when no other active mutator's location path may alias m's
(write/read overlap could flip a second mutator's change predicate and
demand the full convergence loop) and, when m writes labels, no other
active mutator matches on label/namespace selectors (an added label
could flip a match).  Non-solo-safe mutators still run — through the
host lane.

The differential harness (tests/test_mutlane.py) pins the load-bearing
claim: batched mutate-then-validate equals the per-object reference path
bit-identically — patches, converged objects, and downstream verdicts —
over the library corpus, including mixed batches with host fallback.

Port of ``gatekeeper_tpu/mutlane/lane.py``: the prefilter's programs run
on ``device`` (default ``"cuda"``) wherever the host numpy fast path does
not decide a row.  The columnize lane is the dict walker; the raw-bytes
ingest, the generation coordinator, metrics, tracing, cost attribution
and the ``mutation.batch`` chaos point are not ported.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

from gatekeeper_tpu_torch.mutation.path_parser import ListNode, ObjectNode
from gatekeeper_tpu_torch.webhook.mutation import json_escape_pointer, json_patch


class MutationDifferentialError(AssertionError):
    """Raised in differential mode when the batched lane diverges from
    the per-object reference path."""


@dataclass
class MutationOutcome:
    """Per-object result of a batched mutation pass — the same facts the
    reference handler derives per object (``changed``/``patch``/``error``
    drive the AdmissionReview response; ``obj`` is the converged tree
    when the caller asked for it)."""

    changed: bool
    obj: dict  # converged tree (the INPUT object when unchanged/error)
    patch: Optional[list]  # RFC-6902 ops, None when no change
    error: Optional[str]  # reference: mutation errors answer allowed+msg
    lane: str  # noop | device | solo | host
    iterations: int  # convergence iterations (1 = already fixed point)


def _paths_may_alias(pa, pb) -> bool:
    """Conservative: may the two location paths address overlapping
    nodes?  Position-wise walk; a full match through the shorter path
    (prefix or equality) aliases — one mutator writes where the other
    reads.  Any diverging segment proves disjointness.  Object-vs-list
    disagreement at a position is a schema conflict the system already
    disables, but counts as aliasing here for safety."""
    for na, nb in zip(pa, pb):
        if isinstance(na, ObjectNode) and isinstance(nb, ObjectNode):
            if na.name != nb.name:
                return False
        elif isinstance(na, ListNode) and isinstance(nb, ListNode):
            if na.key_field != nb.key_field:
                return False
            if (na.key_value is not None and nb.key_value is not None
                    and na.key_value != nb.key_value):
                return False
        else:
            return True  # conflicting schema: treat as aliasing
    return True


def _pointer(parts: Sequence[str]) -> str:
    return "/" + "/".join(json_escape_pointer(p) for p in parts)


class _Compiled:
    """Frozen compile artifact for one registry revision."""

    def __init__(self, system, device: str = "cuda"):
        from gatekeeper_tpu_torch.mutation.device import MutationPrefilter

        self.revision = system.revision()
        self.active = system.active()
        self.prefilter = MutationPrefilter(device=device)
        self.lowered = []
        self.host_only = []
        for m in self.active:
            if self.prefilter.add_mutator(m):
                self.lowered.append(m)
            else:
                self.host_only.append(m)
        self.solo_safe = {
            m.id: self._solo_safe(m) for m in self.lowered
        }
        # pure object-node paths qualify for columnar patch emission;
        # list-crossing paths take the targeted single-application lane
        self.scalar_path = {
            m.id: all(isinstance(p, ObjectNode) for p in m.path)
            for m in self.lowered
        }

    def _solo_safe(self, m) -> bool:
        writes_labels = (m.kind == "AssignMetadata"
                         and len(m.path) > 1
                         and getattr(m.path[1], "name", "") == "labels")
        for b in self.active:
            if b is m:
                continue
            if _paths_may_alias(m.path, b.path):
                return False
            if writes_labels:
                spec = b.match_spec or {}
                if "labelSelector" in spec or "namespaceSelector" in spec:
                    return False
        return True


class MutationLane:
    """Batched front of a :class:`MutationSystem` (which stays the
    authoritative reference).  Thread-safe for concurrent
    ``mutate_objects`` calls; the compile cache re-keys on the system
    revision so mutator churn invalidates the batched program.  The
    prefilter's grids run on ``device``.  ``differential`` asserts every
    burst equal to the per-object reference path."""

    def __init__(self, system, differential: bool = False,
                 device: str = "cuda"):
        from gatekeeper_tpu_torch import resolve_device

        self.system = system
        self.differential = differential
        self.device = resolve_device(device)
        self._compiled: Optional[_Compiled] = None
        self._lock = threading.Lock()

    # --- compile cache ----------------------------------------------------
    def compiled(self) -> _Compiled:
        rev = self.system.revision()
        with self._lock:
            c = self._compiled
            if c is not None and c.revision == rev:
                return c
        c = _Compiled(self.system, device=self.device)
        with self._lock:
            self._compiled = c
        return c

    # --- the batched pass -------------------------------------------------
    def mutate_objects(self, objects: Sequence[dict], namespaces=None,
                       source: str = "",
                       want_objects: bool = False) -> list:
        """Classify + apply one burst; returns a
        :class:`MutationOutcome` per object.  ``namespaces`` is a
        parallel list of Namespace objects (or None)."""
        outcomes = self._mutate_impl(objects, namespaces, source,
                                     want_objects)
        if self.differential:
            self._assert_differential(objects, namespaces, source,
                                      outcomes)
        return outcomes

    def _mutate_impl(self, objects, namespaces, source,
                     want_objects) -> list:
        import numpy as np

        n = len(objects)
        if n == 0:
            return []
        c = self.compiled()
        if not c.active:
            return [MutationOutcome(False, obj, None, None, "noop", 1)
                    for obj in objects]

        def ns_of(oi):
            return namespaces[oi] if namespaces else None

        rel_grid, batch = c.prefilter.relevance_and_batch(
            c.lowered, objects)

        # host-side exact match matrices (M is small; the grid above is
        # the expensive part).  A matcher that RAISES (e.g. a
        # namespaceSelector without its Namespace) routes the object to
        # the host path, which reproduces the error message.
        raised = np.zeros(n, bool)
        lmatch = np.zeros((len(c.lowered), n), bool)
        for mi, m in enumerate(c.lowered):
            for oi in range(n):
                try:
                    lmatch[mi, oi] = m.matches(objects[oi], ns_of(oi),
                                               source)
                except Exception:
                    raised[oi] = True
        hmatch = np.zeros((len(c.host_only), n), bool)
        for hi, b in enumerate(c.host_only):
            for oi in range(n):
                try:
                    hmatch[hi, oi] = b.matches(objects[oi], ns_of(oi),
                                               source)
                except Exception:
                    raised[oi] = True
        rel = lmatch & rel_grid
        # lazy error split: the err program only runs for mutators that
        # actually have relevant objects in this burst
        err_rows: dict = {}
        for mi, m in enumerate(c.lowered):
            if rel[mi].any():
                err_rows[mi] = c.prefilter.error_row(m, batch, n)

        out = []
        for oi in range(n):
            obj = objects[oi]
            ns = ns_of(oi)
            if raised[oi]:
                out.append(self._host(obj, ns, source))
                continue
            hits = np.nonzero(rel[:, oi])[0]
            ms = [c.lowered[int(mi)] for mi in hits]
            # the relevant lowered set is independently appliable when
            # every member is solo-safe (proven against ALL active
            # mutators, themselves included) and none errors
            ms_ok = all(c.solo_safe[m.id] for m in ms) and not any(
                err_rows[int(mi)][oi] for mi in hits)
            if hmatch[:, oi].any():
                if ms and not ms_ok:
                    # interacting lowered changes + matching host-only
                    # mutators: the full convergence loop owns it
                    out.append(self._host(obj, ns, source))
                    continue
                # iteration-1 probe of the matching host-only mutators:
                # solo-safety makes them independent of the lowered set,
                # so a clean probe means the lowered outcome stands alone
                probed = self._probe_host_only(
                    obj, [b for hi, b in enumerate(c.host_only)
                          if hmatch[hi, oi]], ns, source)
                if probed is not None:
                    out.append(probed)  # host walk owned the outcome
                    continue
                if not ms:
                    out.append(MutationOutcome(False, obj, None, None,
                                               "noop", 1))
                    continue
            elif not ms:
                out.append(MutationOutcome(False, obj, None, None,
                                           "noop", 1))
                continue
            elif not ms_ok:
                # several non-solo-safe mutators, an interacting one, or
                # an error outcome
                out.append(self._host(obj, ns, source))
                continue
            m = ms[0]
            if len(ms) == 1 and c.scalar_path[m.id]:
                out.append(self._emit_scalar(m, batch, oi, obj,
                                             want_objects))
            elif len(ms) == 1:
                out.append(self._solo_apply(m, obj, ns, source))
            else:
                out.append(self._multi_apply(ms, obj, ns, source))
        return out

    def _probe_host_only(self, obj, matching, ns, source):
        """Iteration-1 probe of the matching host-only mutators: apply
        them once (registry order) to a working copy.  No change ⇒ they
        contribute nothing to the fixed point (the assignIf-gated steady
        state) and the caller's lowered outcome stands — returns None.
        Any change or error ⇒ the authoritative host path owns the
        whole outcome (returned)."""
        work = copy.deepcopy(obj)
        for b in matching:
            try:
                if b.mutate_obj(work):
                    return self._host(obj, ns, source)
            except Exception:
                return self._host(obj, ns, source)
        return None

    # --- outcome lanes ----------------------------------------------------
    def _host(self, obj, ns, source) -> MutationOutcome:
        """The authoritative per-object reference path: full fixed-point
        convergence + RFC-6902 diff (exactly what the per-object webhook
        handler does)."""
        after = copy.deepcopy(obj)
        try:
            changed = self.system.mutate(after, namespace=ns,
                                         source=source)
        except Exception as e:
            # reference handler semantics: a mutation error answers
            # allowed with the message and NO patch
            return MutationOutcome(False, obj, None, str(e), "host", 0)
        patch = json_patch(obj, after) or None
        return MutationOutcome(bool(changed), after, patch, None, "host",
                               self.system.last_iterations)

    def _emit_scalar(self, m, batch, oi, obj,
                     want_objects) -> MutationOutcome:
        """Columnar patch emission for a pure object-node path: the
        flattened presence columns locate the first absent prefix, which
        fully determines the single RFC-6902 op ``json_patch`` would
        compute from the converged tree."""
        from gatekeeper_tpu_torch.ops.flatten import K_ABSENT, ScalarCol

        parts = tuple(p.name for p in m.path)
        value = m.value
        first_absent = None
        for d in range(1, len(parts) + 1):
            col = batch.scalars.get(ScalarCol(parts[:d]))
            if col is None or col.kind[oi] == K_ABSENT:
                first_absent = d
                break
        if first_absent is None:
            ops = [{"op": "replace", "path": _pointer(parts),
                    "value": value}]
        elif first_absent == len(parts):
            ops = [{"op": "add", "path": _pointer(parts), "value": value}]
        else:
            sub = value
            for p in reversed(parts[first_absent:]):
                sub = {p: sub}
            ops = [{"op": "add", "path": _pointer(parts[:first_absent]),
                    "value": sub}]
        after = obj
        if want_objects:
            after = copy.deepcopy(obj)
            node = after
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return MutationOutcome(True, after, ops, None, "device", 2)

    def _multi_apply(self, ms, obj, ns, source) -> MutationOutcome:
        """Several mutually-independent (all solo-safe) mutators on one
        object: one application each, registry order, one diff — the
        cold-burst replacement for the full convergence loop (which
        deep-copies per application per iteration)."""
        work = copy.deepcopy(obj)
        for m in ms:
            try:
                m.mutate_obj(work)
            except Exception:
                # the walk disagreed with the grid: the host reference
                # path owns the outcome (and the exact message)
                return self._host(obj, ns, source)
        patch = json_patch(obj, work) or None
        if patch is None:
            return MutationOutcome(False, obj, None, None, "multi", 1)
        return MutationOutcome(True, work, patch, None, "multi", 2)

    def _solo_apply(self, m, obj, ns, source) -> MutationOutcome:
        """Targeted single application for a solo-safe list-crossing
        mutator: by solo-safety one application IS the fixed point, so
        the M-mutator convergence loop collapses to one walk."""
        after = copy.deepcopy(obj)
        try:
            changed = m.mutate_obj(after)
        except Exception:
            # the grid said no error but the walk disagreed: the host
            # reference path owns the outcome (and the exact message)
            return self._host(obj, ns, source)
        if not changed:
            return MutationOutcome(False, obj, None, None, "solo", 1)
        patch = json_patch(obj, after) or None
        return MutationOutcome(True, after, patch, None, "solo", 2)

    # --- differential -----------------------------------------------------
    def reference_outcome(self, obj, ns=None,
                          source: str = "") -> MutationOutcome:
        """The per-object reference path, exposed for differential
        harnesses."""
        after = copy.deepcopy(obj)
        try:
            changed = self.system.mutate(after, namespace=ns,
                                         source=source)
        except Exception as e:
            return MutationOutcome(False, obj, None, str(e), "reference",
                                   0)
        patch = json_patch(obj, after) or None
        return MutationOutcome(bool(changed), after, patch, None,
                               "reference", self.system.last_iterations)

    def _assert_differential(self, objects, namespaces, source,
                             outcomes) -> None:
        for oi, got in enumerate(outcomes):
            ns = namespaces[oi] if namespaces else None
            want = self.reference_outcome(objects[oi], ns, source)
            if got.error is not None or want.error is not None:
                if (got.error is None) != (want.error is None):
                    raise MutationDifferentialError(
                        f"object {oi}: error mismatch ({got.lane}): "
                        f"{got.error!r} vs {want.error!r}")
                continue
            if got.patch != want.patch:
                raise MutationDifferentialError(
                    f"object {oi}: patch mismatch ({got.lane}): "
                    f"{got.patch} vs {want.patch}")
            if got.changed != want.changed:
                raise MutationDifferentialError(
                    f"object {oi}: changed mismatch ({got.lane})")
