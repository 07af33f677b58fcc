"""Per-template / per-constraint cost attribution.

"Which policy makes admission slow" should be a query, not a guess.  The
batched lanes deliberately evaluate MANY templates in one fused device
pass (`device.query_batch`, `device.sweep_dispatch`), so no single
template ever owns a span — this module apportions each shared pass's
wall time across the constraint grid:

- **dispatch/query time** splits by *row occupancy*: the number of
  (constraint, object) cells of each template's match mask that were
  actually live in the pass (a template matching every Pod in a 10k-row
  chunk carries more of the pass than one matching three ConfigMaps).
- **flatten/columnize time** splits across the templates whose schemas
  the union flatten served, weighted by constraint count (columns are
  schema-driven; rows are shared).
- **render time** (the exact-interpreter message rendering of device
  hits) is attributed *exactly* — each render call is timed and charged
  to its constraint's template.

Every apportionment distributes the measured wall time completely, so
per-template `gatekeeper_constraint_eval_seconds` sums reproduce the
parent span's wall time (the closure property the tests assert) and the
top entry of ``/debug/cost`` is the template to go look at.

Activation mirrors ``resilience/faults.py``: :func:`install` is the
process-global switch, :func:`activate` the scoped test variant,
:func:`active` the hot-path read (one global list read when off).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

# enforcement points (metric label values)
EP_WEBHOOK = "webhook"
EP_AUDIT = "audit"
EP_MUTATION = "mutation"

# phases (metric label values)
PHASE_DISPATCH = "dispatch"
PHASE_FLATTEN = "flatten"
PHASE_RENDER = "render"
PHASE_APPLY = "apply"


class CostAttribution:
    """Accumulates apportioned wall seconds per (template,
    enforcement_point, phase); optionally mirrors into the metrics
    registry as `gatekeeper_constraint_eval_seconds`."""

    def __init__(self, metrics=None, max_templates: int = 512,
                 max_tenants: int = 512, max_clusters: int = 512):
        self.metrics = metrics
        self.max_templates = max_templates
        self.max_tenants = max_tenants
        self.max_clusters = max_clusters
        self._lock = threading.Lock()
        # (template, ep, phase) -> [seconds, passes, rows]
        self._cells: dict = {}
        # the {tenant} axis (observability NEXT #1): (tenant, ep) ->
        # [seconds, requests, admission cost].  Kept SEPARATE from the
        # template cells so the per-template closure property (shares
        # sum to the parent pass's wall) is untouched — tenant seconds
        # are request wall, a different population.
        self._tenant_cells: dict = {}
        # the {cluster} axis (fleet mode): (cluster, ep) -> [seconds,
        # passes, rows].  Same additive-cardinality contract as tenants
        # (templates + tenants + clusters, never their product): fleet
        # packed dispatches apportion their wall across the clusters
        # whose rows rode the batch, so "which cluster is expensive" is
        # a query even when every dispatch is shared.
        self._cluster_cells: dict = {}

    # --- recording -----------------------------------------------------
    def record(self, template: str, enforcement_point: str, phase: str,
               seconds: float, rows: int = 0) -> None:
        key = (template, enforcement_point, phase)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                if len(self._cells) >= self.max_templates * 4:
                    key = ("other", enforcement_point, phase)
                    cell = self._cells.get(key)
                if cell is None:
                    cell = self._cells[key] = [0.0, 0, 0]
            cell[0] += seconds
            cell[1] += 1
            cell[2] += rows
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.CONSTRAINT_EVAL,
                {"template": key[0], "enforcement_point": enforcement_point,
                 "phase": phase},
                value=seconds)

    def record_tenant(self, tenant: str, enforcement_point: str,
                      seconds: float, cost: float = 0.0) -> None:
        """One admission's wall seconds + admission cost charged to its
        tenant — the ``{tenant}`` axis on
        ``gatekeeper_constraint_eval_seconds``.  The metric rides
        separate series ``{tenant, enforcement_point, phase="admission"}``
        (no template label) so cardinality stays ADDITIVE (templates +
        tenants, not their product); past ``max_tenants`` new tenants
        fold into ``other`` here, and the registry's label-cardinality
        guard bounds the exposed series regardless."""
        key = (tenant, enforcement_point)
        with self._lock:
            cell = self._tenant_cells.get(key)
            if cell is None:
                if len(self._tenant_cells) >= self.max_tenants:
                    key = ("other", enforcement_point)
                    cell = self._tenant_cells.get(key)
                if cell is None:
                    cell = self._tenant_cells[key] = [0.0, 0, 0.0]
            cell[0] += seconds
            cell[1] += 1
            cell[2] += cost
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.CONSTRAINT_EVAL,
                {"tenant": key[0], "enforcement_point": enforcement_point,
                 "phase": "admission"},
                value=seconds)

    def record_cluster(self, cluster: str, enforcement_point: str,
                       seconds: float, rows: int = 0) -> None:
        """One cluster's share of a (possibly fleet-packed) pass —
        the ``{cluster}`` axis on ``gatekeeper_constraint_eval_seconds``
        (series ``{cluster, enforcement_point, phase="sweep"}``, no
        template label, additive cardinality).  Past ``max_clusters``
        new clusters fold into ``other`` here, and the registry's
        label-cardinality guard bounds the exposed series regardless."""
        key = (cluster, enforcement_point)
        with self._lock:
            cell = self._cluster_cells.get(key)
            if cell is None:
                if len(self._cluster_cells) >= self.max_clusters:
                    key = ("other", enforcement_point)
                    cell = self._cluster_cells.get(key)
                if cell is None:
                    cell = self._cluster_cells[key] = [0.0, 0, 0]
            cell[0] += seconds
            cell[1] += 1
            cell[2] += rows
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(
                M.CONSTRAINT_EVAL,
                {"cluster": key[0], "enforcement_point": enforcement_point,
                 "phase": "sweep"},
                value=seconds)

    def attribute_clusters(self, wall_s: float, rows: dict,
                           enforcement_point: str) -> None:
        """Apportion one packed pass's wall across ``rows``
        ({cluster: row count}) — shares sum to ``wall_s`` exactly, the
        same closure contract :meth:`attribute` keeps for templates."""
        if wall_s <= 0 or not rows:
            return
        total = float(sum(max(0, r) for r in rows.values()))
        n = len(rows)
        for cluster, r in rows.items():
            share = (wall_s * max(0, int(r)) / total) if total > 0 \
                else wall_s / n
            self.record_cluster(cluster, enforcement_point, share,
                                rows=int(r))

    def cluster_totals(self, enforcement_point: Optional[str] = None
                       ) -> dict:
        """{cluster: attributed seconds} — per-cluster cost roll-up."""
        out: dict = {}
        with self._lock:
            for (cluster, ep), (s, _n, _r) in self._cluster_cells.items():
                if enforcement_point is None or ep == enforcement_point:
                    out[cluster] = out.get(cluster, 0.0) + s
        return out

    def tenant_totals(self, enforcement_point: Optional[str] = None
                      ) -> dict:
        """{tenant: attributed seconds} — the "who is heaviest" input
        the QoS displacement ladder consumes
        (``OverloadController.set_tenant_cost_input``)."""
        out: dict = {}
        with self._lock:
            for (tenant, ep), (s, _n, _c) in self._tenant_cells.items():
                if enforcement_point is None or ep == enforcement_point:
                    out[tenant] = out.get(tenant, 0.0) + s
        return out

    def attribute(self, wall_s: float, weights: dict,
                  enforcement_point: str, phase: str,
                  rows: Optional[dict] = None) -> None:
        """Apportion ``wall_s`` across ``weights`` ({template: weight});
        the shares always sum to ``wall_s`` exactly (closure).  Zero or
        empty weights fall back to an even split."""
        if wall_s <= 0 or not weights:
            return
        total = float(sum(max(0.0, w) for w in weights.values()))
        n = len(weights)
        for template, w in weights.items():
            share = (wall_s * max(0.0, float(w)) / total) if total > 0 \
                else wall_s / n
            self.record(template, enforcement_point, phase, share,
                        rows=int((rows or {}).get(template, 0)))

    # --- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/debug/cost`` payload: raw cells plus a per-template
        roll-up sorted most-expensive-first."""
        with self._lock:
            cells = [
                {"template": t, "enforcement_point": ep, "phase": ph,
                 "seconds": round(s, 6), "passes": c, "rows": r}
                for (t, ep, ph), (s, c, r) in self._cells.items()
            ]
        by_template: dict = {}
        for cell in cells:
            agg = by_template.setdefault(
                cell["template"],
                {"template": cell["template"], "seconds": 0.0,
                 "passes": 0, "rows": 0, "phases": {}})
            agg["seconds"] = round(agg["seconds"] + cell["seconds"], 6)
            agg["passes"] += cell["passes"]
            agg["rows"] += cell["rows"]
            ph = agg["phases"]
            ph[cell["phase"]] = round(
                ph.get(cell["phase"], 0.0) + cell["seconds"], 6)
        top = sorted(by_template.values(),
                     key=lambda a: -a["seconds"])
        with self._lock:
            tenants = sorted(
                ({"tenant": t, "enforcement_point": ep,
                  "seconds": round(s, 6), "requests": n,
                  "admission_cost": round(c, 1)}
                 for (t, ep), (s, n, c) in self._tenant_cells.items()),
                key=lambda a: -a["seconds"])
            clusters = sorted(
                ({"cluster": cl, "enforcement_point": ep,
                  "seconds": round(s, 6), "passes": n, "rows": r}
                 for (cl, ep), (s, n, r) in self._cluster_cells.items()),
                key=lambda a: -a["seconds"])
        return {"top": top, "tenants": tenants, "clusters": clusters,
                "cells": sorted(cells, key=lambda c: -c["seconds"])}

    def total_seconds(self, enforcement_point: Optional[str] = None,
                      phase: Optional[str] = None) -> float:
        """Summed attributed seconds, optionally filtered — the closure
        check's left-hand side."""
        with self._lock:
            return sum(
                s for (t, ep, ph), (s, c, r) in self._cells.items()
                if (enforcement_point is None or ep == enforcement_point)
                and (phase is None or ph == phase))

    def table(self, limit: int = 15) -> str:
        """Human table for ``gator bench --attribution``."""
        snap = self.snapshot()
        rows = snap["top"][:limit]
        if not rows:
            return "cost attribution: (no passes recorded)"
        w = max([len("template")] + [len(r["template"]) for r in rows])
        lines = [f"{'template':<{w}}  {'seconds':>9}  {'passes':>6}  "
                 f"{'rows':>9}  phases"]
        for r in rows:
            phases = " ".join(
                f"{k}={v:.3f}" for k, v in sorted(r["phases"].items()))
            lines.append(f"{r['template']:<{w}}  {r['seconds']:>9.3f}  "
                         f"{r['passes']:>6}  {r['rows']:>9}  {phases}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._tenant_cells.clear()
            self._cluster_cells.clear()


# --- activation (the faults.py pattern) -----------------------------------

_global: list = [None]


def install(attr: Optional[CostAttribution]) -> None:
    """Process-global activation (the CLI / serving entrypoint)."""
    _global[0] = attr


def uninstall() -> None:
    _global[0] = None


def active() -> Optional[CostAttribution]:
    """The hot-path read: one global list access; None = attribution off
    (call sites skip weight computation entirely)."""
    return _global[0]


@contextmanager
def activate(attr: CostAttribution):
    """Scoped activation for tests; restores the previous instance."""
    prev = _global[0]
    _global[0] = attr
    try:
        yield attr
    finally:
        _global[0] = prev
