"""Constraint match → boolean masks over the flattened batch.

The reference evaluates ``match.Matches`` per (object, constraint) in Go
(pkg/mutation/match/match.go); here the 8 matchers become vectorized mask
computations over the batch identity columns (numpy host-side — these are
trivial integer compares; the heavy predicate work happens on device).
Matchers that need per-object structural context (labelSelector,
namespaceSelector, source, scope, generateName) fall back to the exact host
predicate for the constraints that use them, preserving bit-exact semantics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gatekeeper_tpu_torch.match import wildcard
from gatekeeper_tpu_torch.match.match import Matchable, matches
from gatekeeper_tpu_torch.ops.flatten import ColumnBatch, Vocab

_FAST_KEYS = {"kinds", "namespaces", "excludedNamespaces"}


def constraint_masks(
    constraints: Sequence,
    batch: ColumnBatch,
    vocab: Vocab,
    objects: Sequence[dict],
    namespaces: Optional[Sequence[Optional[dict]]] = None,
    sources: Optional[Sequence[str]] = None,
    any_generate_name: Optional[bool] = None,
) -> np.ndarray:
    """[C, N] bool: does constraint c match object n."""
    c, n = len(constraints), batch.n
    out = np.ones((c, n), bool)
    n_real = len(objects)
    if n_real < n:
        out[:, n_real:] = False

    ns_ids = batch.ns_sid[:n_real]
    kind_ids = batch.kind_sid[:n_real]
    group_ids = batch.group_sid[:n_real]
    is_namespace_obj = (kind_ids == vocab.lookup("Namespace")) & (
        group_ids == vocab.lookup("")
    )
    name_ids = batch.name_sid[:n_real]
    if any_generate_name is None:  # callers sweeping per kind hoist this
        any_generate_name = any(
            "generateName" in (o.get("metadata") or {}) for o in objects
        )
    # constraint-independent namespace context, hoisted out of the loop
    eff_ns = np.where(is_namespace_obj, name_ids, ns_ids)
    has_ns = eff_ns != vocab.lookup("")
    uniq_eff_ns = np.unique(eff_ns).tolist()
    uniq_names = None

    for ci, con in enumerate(constraints):
        m = con.match or {}
        # constraints using matchers outside the vectorized fast path run the
        # exact host predicate for every object — never AND partial fast masks
        # with a slow path that skips already-False rows (a name-fast-mask
        # False must not suppress a generateName match)
        slow = bool(set(m) - _FAST_KEYS - {"name"}) or (
            (m.get("name") or "") and any_generate_name
        ) or (
            # provided Namespace objects can override metadata.namespace in
            # the effective-namespace rule (match.go:162-163)
            (m.get("namespaces") or m.get("excludedNamespaces"))
            and namespaces is not None and any(ns is not None for ns in namespaces)
        )
        if slow:
            for oi in range(n_real):
                ns_obj = namespaces[oi] if namespaces else None
                src = sources[oi] if sources else ""
                out[ci, oi] = matches(
                    m, Matchable(obj=objects[oi], namespace=ns_obj, source=src)
                )
            continue
        # --- kinds (match.go:181-201) ---
        kinds = m.get("kinds") or []
        if kinds:
            km = np.zeros(n_real, bool)
            for kk in kinds:
                klist = kk.get("kinds") or []
                glist = kk.get("apiGroups") or []
                km_k = np.ones(n_real, bool)
                if klist and "*" not in klist:
                    km_k = np.isin(
                        kind_ids, [vocab.lookup(k) for k in klist]
                    )
                gm_k = np.ones(n_real, bool)
                if glist and "*" not in glist:
                    gm_k = np.isin(
                        group_ids, [vocab.lookup(g) for g in glist]
                    )
                km |= km_k & gm_k
            out[ci, :n_real] &= km

        # --- namespaces / excludedNamespaces (match.go:118-179) ---
        # effective ns: Namespace objects use their own name
        for key, include in (("namespaces", True), ("excludedNamespaces", False)):
            patterns = m.get(key) or []
            if not patterns:
                continue
            # map each unique eff-ns id -> matched?
            table = {}
            for sid in uniq_eff_ns:
                s = vocab.string(sid) if sid >= 0 else ""
                table[sid] = any(wildcard.matches(p, s) for p in patterns)
            hit = np.array([table[s] for s in eff_ns.tolist()], bool)
            # objects with no namespace can't be disqualified
            if include:
                out[ci, :n_real] &= np.where(has_ns, hit, True)
            else:
                out[ci, :n_real] &= np.where(has_ns, ~hit, True)

        # --- name (match.go:203-212); generateName objects took the slow
        # path above ---
        pattern = m.get("name", "") or ""
        if pattern:
            if uniq_names is None:
                uniq_names = np.unique(name_ids).tolist()
            table = {
                sid: wildcard.matches(
                    pattern, vocab.string(sid) if sid >= 0 else ""
                )
                for sid in uniq_names
            }
            hit = np.array([table[s] for s in name_ids.tolist()], bool)
            out[ci, :n_real] &= hit
    return out
