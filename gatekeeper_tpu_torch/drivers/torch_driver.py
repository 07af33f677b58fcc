"""The port's driver: vectorized detection + exact host rendering.

Port of ``gatekeeper_tpu/drivers/tpu_driver.py`` (``TpuDriver``) for the
audit sweep.  Split of labor:

- ``add_template`` compiles the Rego source twice: (a) interpreter modules
  (exact oracle + message rendering), (b) a lowered predicate Program where
  the template is in the vectorizable fragment (ir/lower_rego), evaluated
  by ``ir/program.CompiledProgram`` inside the sweep
  (``parallel/sweep.SweepEvaluator``).
- ``query`` (single review) delegates to the interpreter.
- ``render_query`` renders a device-detected hit through the interpreter,
  with the inventory restricted to join candidates where provably safe.

Not ported yet: the batched admission path (``query_batch``), the CEL
engine, generation swaps, the compile cache, the external-data lane and
metrics.  Kinds with external-data joins therefore never ride the device
grid (``extdata_ready`` is False for them) and render through the
interpreter.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from gatekeeper_tpu_torch.apis.constraints import Constraint
from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate
from gatekeeper_tpu_torch.client.types import QueryResponse
from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver
from gatekeeper_tpu_torch.ir import nodes as _N
from gatekeeper_tpu_torch.ir.lower_rego import lower_template
from gatekeeper_tpu_torch.ir.program import (CompiledProgram, LowerError,
                                             build_inventory_tables,
                                             build_param_table, expr_nodes,
                                             extdata_key_cols,
                                             walk_join_values)
from gatekeeper_tpu_torch.ops.flatten import (RaggedCol, ScalarCol, Vocab,
                                              _axis_items, _walk)

DRIVER_NAME = "Torch"


def _col_restrictable(col) -> bool:
    """True when ``_col_values`` can reproduce the column read on the raw
    object — object-rooted ScalarCol/RaggedCol only (review-level
    ``__review__`` columns have no object path to walk)."""
    if isinstance(col, ScalarCol):
        return col.path[:1] != ("__review__",)
    return isinstance(col, RaggedCol)


def _col_values(obj, col):
    """String values of a ScalarCol/RaggedCol read on the raw object —
    built on the flattener's own walk helpers so the restriction sees
    exactly the values the device columns held."""
    if isinstance(col, ScalarCol):
        val, ok = _walk(obj, col.path)
        return [val] if ok and isinstance(val, str) else []
    if isinstance(col, RaggedCol):
        out = []
        for item in _axis_items(obj, col.axis):
            val, ok = _walk(item, col.subpath)
            if ok and isinstance(val, str):
                out.append(val)
        return out
    return []


class TorchDriver:
    """Implements the Driver protocol for the audit sweep's device path."""

    def __init__(self):
        self._interp = RegoDriver()
        self.vocab = Vocab()
        self._programs: dict[str, CompiledProgram] = {}  # kind -> compiled
        self._lower_errors: dict[str, str] = {}  # kind -> why fallback
        # monotone epoch of the compiled plane, bumped on every template
        # install: the sweep's schema cache keys on it
        self.plan_epoch = 0
        self._data_version = 0
        self._data_kind_versions: dict = {}  # inventory kind -> version
        self._inv_cache: dict = {}  # kind -> (versions, cols, exact)
        self._render_specs: dict = {}  # kind -> Optional[list[(spec, col)]]
        self._render_idx: dict = {}  # spec.key() -> (version, index)

    def lowering_stats(self) -> dict:
        """Device-coverage summary: how much of the loaded template set
        rides the device verdict path."""
        lowered = len(self._programs)
        fallback = len(self._lower_errors)
        total = lowered + fallback
        return {
            "templates": total,
            "lowered": lowered,
            "fallback": fallback,
            "fallback_fraction": round(fallback / total, 4) if total else 0.0,
            "fallback_kinds": dict(self._lower_errors),
        }

    # --- Driver protocol (delegating lifecycle to the exact engine) ------
    def name(self) -> str:
        return DRIVER_NAME

    def has_source_for(self, template: ConstraintTemplate) -> bool:
        return self._interp.has_source_for(template)

    def add_template(self, template: ConstraintTemplate) -> None:
        self._interp.add_template(template)
        compiled = self._interp._templates[template.kind]
        try:
            program = lower_template(
                compiled.modules,
                compiled.package,
                template.kind,
                self.vocab,
                schema_hint=template.parameters_schema,
            )
            self._trial_param_table(program, template.kind)
        except LowerError as e:
            self._install(template.kind, None, str(e))
            return
        self._install(template.kind, CompiledProgram(program), None)

    def _trial_param_table(self, program, kind: str) -> None:
        """Compile-time dry run of build_param_table with a synthetic
        empty constraint: structural table errors surface HERE as a
        LowerError (falling back to the exact engine) instead of erroring
        every sweep."""
        trial = Constraint(kind=kind, name="__lower_trial__", match={},
                           parameters={}, enforcement_action="deny")
        build_param_table(program, [trial], self.vocab)

    def _install(self, kind: str, program, err) -> None:
        """Install one compile result copy-on-write: the serving dicts are
        REPLACED, not mutated, so a sweep that captured them mid-flight
        never sees a half-applied template change."""
        programs = dict(self._programs)
        errors = dict(self._lower_errors)
        if program is not None:
            programs[kind] = program
            errors.pop(kind, None)
        else:
            programs.pop(kind, None)
            errors[kind] = err
        self._programs = programs
        self._lower_errors = errors
        self.plan_epoch += 1
        self._inv_cache.pop(kind, None)
        self._render_specs.pop(kind, None)

    def remove_template(self, template_kind: str) -> None:
        self._interp.remove_template(template_kind)
        programs = dict(self._programs)
        programs.pop(template_kind, None)
        errors = dict(self._lower_errors)
        errors.pop(template_kind, None)
        self._programs = programs  # copy-on-write (see _install)
        self._lower_errors = errors
        self.plan_epoch += 1
        self._inv_cache.pop(template_kind, None)
        self._render_specs.pop(template_kind, None)

    def add_constraint(self, constraint: Constraint) -> None:
        self._interp.add_constraint(constraint)

    def remove_constraint(self, constraint: Constraint) -> None:
        self._interp.remove_constraint(constraint)

    def _bump_data(self, path) -> None:
        self._data_version += 1
        # namespace-scope paths name the object kind at [3]: scope writes
        # only dirty that kind's referential tables
        if (len(path) >= 4 and path[0] == "namespace"):
            self._data_kind_versions[path[3]] = self._data_version
        else:
            self._data_kind_versions.clear()  # unknown shape: dirty all

    def add_data(self, target: str, path: Sequence[str], data: Any) -> None:
        self._interp.add_data(target, path, data)
        self._bump_data(path)

    def remove_data(self, target: str, path: Sequence[str]) -> None:
        self._interp.remove_data(target, path)
        self._bump_data(path)

    def wipe_data(self) -> None:
        self._interp.wipe_data()
        self._data_version += 1
        self._data_kind_versions.clear()

    # --- referential (data.inventory) join tables ----------------------
    def inventory_cols(self, kind: str, programs=None):
        """(cols, exact) for a lowered referential template; ({}, True)
        when the program has no inventory joins.  Cached per data version;
        out-of-vocab sids are definite misses so vocab growth alone never
        invalidates.  ``programs`` pins the programs a sweep captured."""
        prog = (programs if programs is not None
                else self._programs).get(kind)
        if prog is None:
            return {}, True
        inv_kinds = tuple(sorted({
            n.spec.kind for n in expr_nodes(prog.program)
            if isinstance(n, _N.InventoryUniqueJoin)}))
        if not inv_kinds:
            return {}, True
        # per-inventory-kind versions: unrelated data writes don't force a
        # rebuild; a cleared map (wipe / odd path) falls back to the global
        versions = tuple(
            self._data_kind_versions.get(k, self._data_version)
            if self._data_kind_versions else self._data_version
            for k in inv_kinds)
        cached = self._inv_cache.get(kind)
        if cached is not None and cached[0] == versions:
            return cached[1], cached[2]
        cols, exact = build_inventory_tables(
            prog.program, self._interp._data, self.vocab)
        self._inv_cache[kind] = (versions, cols, exact)
        return cols, exact

    def inventory_exact(self, kind: str, programs=None) -> bool:
        """False when the kind's referential tables can't represent the
        current inventory exactly (non-string join values): callers must
        route the kind through the interpreter for this data version."""
        return self.inventory_cols(kind, programs=programs)[1]

    def extdata_ready(self, kind: str, programs=None) -> bool:
        """True when the kind has no external-data joins: the port has no
        external-data lane yet, so such kinds stay on the interpreter."""
        prog = (programs if programs is not None
                else self._programs).get(kind)
        if prog is None:
            return True
        keymap, extractable = extdata_key_cols(prog.program)
        return not keymap and extractable

    def query(self, target, constraints, review, cfg=None) -> QueryResponse:
        return self._interp.query(target, constraints, review, cfg)

    # --- restricted-inventory hit rendering ------------------------------
    # Rendering a device-detected hit re-runs the interpreter; for
    # referential templates that naively rescans the WHOLE inventory per hit.
    # A lowered program only reaches inventory through its
    # InventoryUniqueJoin equality, so entries whose join value differs from
    # the review object's subject values cannot satisfy any clause — the
    # interpreter may run against just the join-key-matching candidates.
    def render_query(self, target, constraint, review,
                     cfg=None) -> QueryResponse:
        """Interpreter query for message rendering of a device hit, with the
        inventory restricted to join candidates where provably safe."""
        specs = self._render_restrict_specs(constraint.kind)
        if not specs or not (self._interp._data or {}).get("inventory"):
            return self._interp.query(target, [constraint], review, cfg)
        obj = review.request.object or {}
        ns_tree: dict = {}
        cluster_tree: dict = {}
        for spec, col in specs:
            index = self._render_index(spec)
            for val in _col_values(obj, col):
                for ns, apiver, name, entry in index.get(val, ()):
                    if spec.scope == "cluster":
                        # cluster-scope root has no namespace level
                        cluster_tree.setdefault(apiver, {}).setdefault(
                            spec.kind, {})[name] = entry
                    else:
                        ns_tree.setdefault(ns, {}).setdefault(
                            apiver, {}).setdefault(
                                spec.kind, {})[name] = entry
        return self._interp.query(
            target, [constraint], review, cfg,
            data_override={"inventory": {"namespace": ns_tree,
                                         "cluster": cluster_tree}},
        )

    def _render_restrict_specs(self, kind):
        """List of (InvTableSpec, subject column) when every inventory
        access of the kind's program is a join with a plain column-read
        subject; None when restriction would be unsafe (or no program)."""
        if kind in self._render_specs:
            return self._render_specs[kind]
        prog = self._programs.get(kind)
        specs: Optional[list] = []
        if prog is None:
            specs = None
        else:
            for node in expr_nodes(prog.program):
                if not isinstance(node, _N.InventoryUniqueJoin):
                    continue
                if isinstance(node.subject, _N.FeatSid) and \
                        _col_restrictable(node.subject.col):
                    specs.append((node.spec, node.subject.col))
                else:
                    # transformed or review-level subject: the object walk
                    # can't reproduce it — render with the full inventory
                    specs = None
                    break
        self._render_specs[kind] = specs
        return specs

    def _render_index(self, spec):
        """value -> [(ns, apiver, name, obj)] for one InvTableSpec, cached
        per inventory-kind data version (mirrors inventory_cols)."""
        import re as _re

        key = spec.key()
        version = (self._data_kind_versions.get(spec.kind,
                                                self._data_version)
                   if self._data_kind_versions else self._data_version)
        cached = self._render_idx.get(key)
        if cached is not None and cached[0] == version:
            return cached[1]
        index: dict = {}
        rx = _re.compile(spec.apiver_regex) if spec.apiver_regex else None
        inv = (self._interp._data or {}).get("inventory", {})
        if spec.scope == "cluster":
            # cluster root is {apiver: {Kind: {name: obj}}}: walk it as a
            # single pseudo-namespace
            roots = [("", inv.get("cluster", {}) or {})]
        else:
            roots = list((inv.get("namespace", {}) or {}).items())
        for ns, by_apiver in roots:
            if not isinstance(by_apiver, dict):
                continue
            for apiver, by_kind in by_apiver.items():
                if rx is not None and not rx.search(str(apiver)):
                    continue
                if not isinstance(by_kind, dict):
                    continue
                objs = by_kind.get(spec.kind)
                if not isinstance(objs, dict):
                    continue
                for name, entry in objs.items():
                    for val in walk_join_values(entry, spec.join_path):
                        if isinstance(val, str):
                            index.setdefault(val, []).append(
                                (ns, apiver, name, entry))
        self._render_idx[key] = (version, index)
        return index

    def dump(self) -> dict:
        d = self._interp.dump()
        d["lowered"] = sorted(self._programs)
        d["fallback"] = dict(self._lower_errors)
        return d

    def get_description_for_stat(self, stat_name: str) -> str:
        return self._interp.get_description_for_stat(stat_name)

    def lowered_kinds(self) -> list[str]:
        return sorted(self._programs)

    def fallback_kinds(self) -> dict[str, str]:
        return dict(self._lower_errors)
