"""The port's driver: vectorized detection + exact host rendering.

Port of ``gatekeeper_tpu/drivers/tpu_driver.py`` (``TpuDriver``).  Split of
labor:

- ``add_template`` compiles the Rego source twice: (a) interpreter modules
  (exact oracle + message rendering), (b) a lowered predicate Program where
  the template is in the vectorizable fragment (ir/lower_rego), evaluated
  by ``ir/program.CompiledProgram`` inside the audit sweep
  (``parallel/sweep.SweepEvaluator``) and inside ``query_batch``.
- With a ``cel_driver``, CEL (K8sNativeValidation) templates install too:
  their validations lower onto the same predicate IR (ir/lower_cel) and
  join the same grids; the CEL evaluator is their exact oracle and message
  renderer, as the interpreter is for Rego.
- ``query`` (single review) delegates to the CEL evaluator (CEL kinds)
  and the interpreter (Rego kinds), in that order.
- ``query_batch`` (many reviews: the webhook microbatch, the audit's
  non-swept kinds) flattens once, evaluates each lowered template's [C, N]
  grid on ``device``, ANDs it with the match mask on the host and renders
  the hits through the exact engines; other kinds run their exact engine
  over their mask-filtered pairs.
- ``render_query`` renders a device-detected hit through the CEL
  evaluator (CEL kinds) or the interpreter, the latter with the inventory
  restricted to join candidates where provably safe.
- External-data joins (``external_data`` in a lowered template) read
  ``ext:<provider>:{ok,val}`` tables that ``extdata_cols`` builds through
  the attached or process-active ``ExtDataLane`` (extdata/lane.py); without
  a lane, or in its ``perkey`` mode, such kinds run through the
  interpreter, whose builtin resolves per key.

Generations (``drivers/generation.py``): with ``generation_swap`` a
template change stages and a ``GenerationCoordinator`` lowers it on a
background thread once started, warms it and swaps it in atomically
(``_install_generation``); until then, and without the flag, it lowers
inline.  Both routes consult the ``compile_cache`` when one is given.

Hooks as in the JAX package: ``query_batch`` runs under a
``device.query_batch`` span with the ``device.dispatch`` fault site and
apportions its wall to templates by host mask occupancy when cost
attribution is active; ``metrics`` counts lowered and fallback templates.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from gatekeeper_tpu_torch import resolve_device
from gatekeeper_tpu_torch.apis.constraints import Constraint
from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate
from gatekeeper_tpu_torch.client.types import (QueryResponse, Result, Stat,
                                               StatsEntry)
from gatekeeper_tpu_torch.drivers.base import ReviewCfg
from gatekeeper_tpu_torch.drivers.rego_driver import RegoDriver
from gatekeeper_tpu_torch.ir import masks as masks_mod
from gatekeeper_tpu_torch.ir import nodes as _N
from gatekeeper_tpu_torch.ir.lower_cel import lower_cel_template
from gatekeeper_tpu_torch.ir.lower_rego import lower_template
from gatekeeper_tpu_torch.ir.program import (CompiledProgram, LowerError,
                                             build_inventory_tables,
                                             build_param_table, expr_nodes,
                                             extdata_key_cols,
                                             walk_join_values)
from gatekeeper_tpu_torch.ops.flatten import (K_STR, Flattener, RaggedCol,
                                              ScalarCol, Schema, Vocab,
                                              _axis_items, _walk)
from gatekeeper_tpu_torch.target.review import GkReview

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
    """Implements the Driver protocol + the batched device path.

    ``device`` is where ``query_batch`` evaluates its grids unless the call
    names another ("cuda" by default; resolved when a batch has a lowered
    kind, which raises without a card).  The audit sweep, and the audit's
    ``query_batch`` calls, run on its ``SweepEvaluator``'s device.

    With a ``cel_driver``, CEL (K8sNativeValidation) templates are accepted
    too (see the module docstring)."""

    def __init__(self, batch_bucket: int = 256, device: str = "cuda",
                 cel_driver=None, generation_swap: bool = False,
                 compile_cache=None, metrics=None):
        self._interp = RegoDriver()
        # metrics.registry.MetricsRegistry (optional): lowering coverage
        # counters per template kind
        self.metrics = metrics
        self._cel = cel_driver  # optional CELDriver
        self._cel_kinds: set = set()  # kinds owned by the CEL engine
        self.vocab = Vocab()
        self._programs: dict[str, CompiledProgram] = {}  # kind -> compiled
        self._lower_errors: dict[str, str] = {}  # kind -> why fallback
        # on-disk lowering cache (drivers/generation.CompileCache),
        # consulted by the inline path and by generation builds
        self._compile_cache = compile_cache
        # kind -> content digest of the installed template (replaced, never
        # mutated): the snapshot's plan digest reads it, so a template edit
        # re-chunks the resident rows
        self.template_digests: dict = {}
        # monotone epoch of the compiled plane, bumped on every template
        # install (inline or swap): the sweep's schema cache keys on it
        self.plan_epoch = 0
        self._swap_lock = threading.Lock()
        # generation_swap: template changes stage and compile through a
        # GenerationCoordinator (background once started); None = inline
        self.gen_coord = None
        # (objects, review_docs, pad_n) of the latest query_batch: the
        # generation warm's shape reference (generation mode only)
        self._warm_ref = None
        # (plan_epoch, programs dict, union Schema): query_batch's cached
        # flatten union of those programs
        self._qb_schema = None
        if generation_swap:
            from gatekeeper_tpu_torch.drivers.generation import \
                GenerationCoordinator

            self.gen_coord = GenerationCoordinator(self, cache=compile_cache,
                                                   metrics=metrics)
        self._data_version = 0
        self._data_kind_versions: dict = {}  # inventory kind -> version
        self._inv_cache: dict = {}  # kind -> (versions, cols, exact)
        self._render_specs: dict = {}  # kind -> Optional[list[(spec, col)]]
        self._render_idx: dict = {}  # spec.key() -> (version, index)
        self._dev_cache: dict = {}  # host array id -> device tensor (LRU)
        self.batch_bucket = batch_bucket
        self.device = device
        # device->host transfer accounting for query_batch (grid fetches),
        # the admission-side twin of the sweep evaluator's perf["d2h_bytes"]
        self.perf: dict = {}
        # extdata/lane.ExtDataLane: explicit attachment wins over the
        # process-active lane (see _active_extdata)
        self.extdata_lane = None

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

    def _count_lowering(self, kind: str, engine: str, lowered: bool) -> None:
        if self.metrics is None:
            return
        from gatekeeper_tpu_torch.metrics import registry as M

        self.metrics.inc_counter(
            M.LOWERING_LOWERED if lowered else M.LOWERING_FALLBACK,
            {"kind": kind, "engine": engine})

    # --- Driver protocol (delegating lifecycle to the exact engine) ------
    def name(self) -> str:
        return DRIVER_NAME

    def has_source_for(self, template: ConstraintTemplate) -> bool:
        if self._interp.has_source_for(template):
            return True
        return self._cel is not None and self._cel.has_source_for(template)

    def add_template(self, template: ConstraintTemplate) -> None:
        if self.gen_coord is not None:
            # generation mode: synchronous validation + staged compile; the
            # serving programs are untouched until the swap
            self.gen_coord.submit_add(template)
            return
        if not self._interp.has_source_for(template) and \
                self._cel is not None and self._cel.has_source_for(template):
            self._add_cel_template(template)
            return
        self._interp.add_template(template)
        self._note_digest(template)
        self._cel_kinds = self._cel_kinds - {template.kind}
        compiled = self._interp._templates[template.kind]
        program, err, _hit = self._lower_or_cached(
            template.kind, "rego", template,
            lambda: lower_template(compiled.modules, compiled.package,
                                   template.kind, self.vocab,
                                   schema_hint=template.parameters_schema))
        self._install(template.kind, program, err, "rego")

    def _note_digest(self, template) -> None:
        from gatekeeper_tpu_torch.drivers.generation import template_digest

        self.template_digests = {**self.template_digests,
                                 template.kind: template_digest(template)}

    def _lower_or_cached(self, kind: str, engine: str, template,
                         lower_fn) -> tuple:
        """(CompiledProgram | None, lowering error | None, from_cache):
        the on-disk compile cache's answer when its entry's vocab snapshot
        replays here (no lowering, no trial table), else lower, trial-build
        and persist the result (program or error)."""
        cache = self._compile_cache
        digest = ""
        if cache is not None:
            from gatekeeper_tpu_torch.drivers.generation import \
                template_digest

            digest = template_digest(template)
            hit = cache.get(digest, engine, self.vocab)
            if hit is not None:
                tag, val = hit
                if tag == "program":
                    return CompiledProgram(val), None, True
                return None, val, True
        try:
            program = lower_fn()
            self._trial_param_table(program, kind)
        except LowerError as e:
            if cache is not None:
                cache.put(digest, engine, None, str(e), self.vocab)
            return None, str(e), False
        if cache is not None:
            cache.put(digest, engine, program, None, self.vocab)
        return CompiledProgram(program), None, False

    # --- generation machinery (drivers/generation.py) -------------------
    def _lower_staged(self, staged) -> tuple:
        """Lower one staged template for a generation build (serving state
        untouched).  Returns (program, err, from_cache)."""
        kind = staged.template.kind
        hint = staged.template.parameters_schema
        if staged.engine == "cel":
            def lower_fn():
                return lower_cel_template(staged.artifact, kind,
                                          self.vocab, schema_hint=hint)
        else:
            def lower_fn():
                return lower_template(staged.artifact.modules,
                                      staged.artifact.package, kind,
                                      self.vocab, schema_hint=hint)
        program, err, from_cache = self._lower_or_cached(
            kind, staged.engine, staged.template, lower_fn)
        self._count_lowering(kind, staged.engine, program is not None)
        return program, err, from_cache

    def _install_generation(self, gen) -> None:
        """The swap point: every serving structure is REPLACED with a fresh
        object (attribute assignments under the swap lock), never mutated
        in place, so batches that captured the old dicts finish on the
        generation they started on."""
        with self._swap_lock:
            self._interp._templates = dict(gen.interp_templates)
            if self._cel is not None:
                self._cel._templates = dict(gen.cel_templates)
            self._cel_kinds = set(gen.cel_kinds)
            self._programs = dict(gen.programs)
            self._lower_errors = dict(gen.lower_errors)
            self.template_digests = dict(gen.digests)
            self._inv_cache = {}
            self._render_specs = {}
            self._render_idx = {}
            self.plan_epoch += 1

    def _trial_param_table(self, program, kind: str) -> None:
        """Compile-time dry run of build_param_table with a synthetic
        empty constraint: structural table errors surface HERE as a
        LowerError (falling back to the exact engine) instead of erroring
        every sweep."""
        trial = Constraint(kind=kind, name="__lower_trial__", match={},
                           parameters={}, enforcement_action="deny")
        build_param_table(program, [trial], self.vocab)

    def _add_cel_template(self, template: ConstraintTemplate) -> None:
        self._cel.add_template(template)
        self._note_digest(template)
        self._cel_kinds = self._cel_kinds | {template.kind}
        compiled = self._cel._templates[template.kind]
        program, err, _hit = self._lower_or_cached(
            template.kind, "cel", template,
            lambda: lower_cel_template(
                compiled, template.kind, self.vocab,
                schema_hint=template.parameters_schema))
        self._install(template.kind, program, err, "cel")

    def _install(self, kind: str, program, err, engine: str) -> None:
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
        self._count_lowering(kind, engine, program is not None)
        self.plan_epoch += 1
        self._inv_cache.pop(kind, None)
        self._render_specs.pop(kind, None)

    def remove_template(self, template_kind: str) -> None:
        if self.gen_coord is not None:
            self.gen_coord.submit_remove(template_kind)
            return
        if template_kind in self._cel_kinds:
            self._cel.remove_template(template_kind)
            self._cel_kinds = self._cel_kinds - {template_kind}
        else:
            self._interp.remove_template(template_kind)
        programs = dict(self._programs)
        programs.pop(template_kind, None)
        errors = dict(self._lower_errors)
        errors.pop(template_kind, None)
        self.template_digests = {k: v for k, v in
                                 self.template_digests.items()
                                 if k != template_kind}
        self._programs = programs  # copy-on-write (see _install)
        self._lower_errors = errors
        self.plan_epoch += 1
        self._inv_cache.pop(template_kind, None)
        self._render_specs.pop(template_kind, None)

    def add_constraint(self, constraint: Constraint) -> None:
        if constraint.kind in self._cel_kinds:
            self._cel.add_constraint(constraint)
        else:
            if self.gen_coord is not None and \
                    self.gen_coord.is_staged(constraint.kind):
                # the template is in the desired set (serving, or staged
                # and not swapped in yet): the constraint is accepted now
                # and matches from the swap on.  Checking the serving
                # templates here too would race a swap that lands between
                # that check and the interpreter's own
                return
            self._interp.add_constraint(constraint)

    def remove_constraint(self, constraint: Constraint) -> None:
        if constraint.kind in self._cel_kinds:
            self._cel.remove_constraint(constraint)
        else:
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

    # --- external-data join tables (extdata/lane.py) --------------------
    def _active_extdata(self):
        """The lane this driver joins through: an explicitly attached one
        or the process/context-active lane (--extdata-lane)."""
        if self.extdata_lane is not None:
            return self.extdata_lane
        from gatekeeper_tpu_torch.extdata import lane as lane_mod

        return lane_mod.active()

    def extdata_ready(self, kind: str, programs=None) -> bool:
        """True when the kind may ride the device grid as far as external
        data goes: no external-data joins at all, or an active lane in a
        device-join mode (batched/differential) with extractable key
        columns.  The perkey mode (the authoritative reference) and
        lane-less processes route external-data kinds through the
        interpreter, whose ``external_data`` builtin resolves per key."""
        prog = (programs if programs is not None
                else self._programs).get(kind)
        if prog is None:
            return True
        keymap, extractable = extdata_key_cols(prog.program)
        if not keymap and extractable:
            return True
        lane = self._active_extdata()
        return extractable and lane is not None and lane.device_join()

    def extdata_cols(self, kind: str, batch, programs=None) -> tuple:
        """(cols, ready): vocab-padded ``ext:`` join tables covering every
        key THIS batch's subject columns reference.  Per provider the key
        strings dedupe across the whole batch off the flattened sid
        arrays, the lane bulk-fetches the misses (one transport call per
        ``max_keys_per_call`` chunk; warm columns make none), and the
        resident column serves the arrays.  Value strings intern here, so
        callers build vocab-derived tables (``vocab_tables``, the StrPred
        needle rows) AFTER this call."""
        prog = (programs if programs is not None
                else self._programs).get(kind)
        if prog is None:
            return {}, True
        keymap, extractable = extdata_key_cols(prog.program)
        if not keymap and extractable:
            return {}, True
        lane = self._active_extdata()
        if lane is None or not lane.device_join() or not extractable:
            return {}, False
        requests: dict = {}
        for provider in sorted(keymap):
            sids: set = set()
            for spec in keymap[provider]:
                col = batch.scalars.get(spec)
                if col is None:
                    col = batch.raggeds.get(spec)
                if col is None:
                    continue  # column absent from this batch's schema
                s = col.sid[col.kind == K_STR]
                if s.size:
                    sids.update(int(x) for x in np.unique(s) if x >= 0)
            requests[provider] = sorted(self.vocab.string(s) for s in sids)
        if len(requests) > 1:
            # land every provider's misses in one fan-out, then build the
            # tables from the warm columns (the build interns value strings
            # and stays on this thread)
            lane.ensure_many(requests)
        cols: dict = {}
        for provider, keys in requests.items():
            cols.update(lane.tables_for(provider, keys, self.vocab))
        return cols, True

    def extdata_differential(self, target, kind, cons, reviews, grid,
                             mask, cfg) -> None:
        """``--extdata-lane differential``: the grid's verdicts must match
        the exact interpreter (whose external_data builtin resolved through
        the same lane, checked per key) on every live (constraint, review)
        mask cell."""
        from gatekeeper_tpu_torch.extdata.lane import ExtDataDivergence

        for ci, con in enumerate(cons):
            for oi in np.nonzero(mask[ci, : len(reviews)])[0].tolist():
                ref = self._interp.query(target, [con], reviews[oi], cfg)
                want = bool(ref.results)
                got = bool(grid[ci, oi])
                if want != got:
                    r = reviews[oi]
                    raise ExtDataDivergence(
                        f"extdata differential: {kind}/{con.name} on "
                        f"{r.request.namespace}/{r.request.name}: "
                        f"device={got} interpreter={want}")

    def query(self, target, constraints, review, cfg=None) -> QueryResponse:
        cel_cons = [c for c in constraints if c.kind in self._cel_kinds]
        if not cel_cons:
            return self._interp.query(target, constraints, review, cfg)
        rego_cons = [c for c in constraints if c.kind not in self._cel_kinds]
        resp = self._cel.query(target, cel_cons, review, cfg)
        if rego_cons:
            r2 = self._interp.query(target, rego_cons, review, cfg)
            resp.results.extend(r2.results)
            resp.stats_entries.extend(r2.stats_entries)
            if r2.trace:
                resp.trace = (resp.trace + "\n" + r2.trace
                              if resp.trace else r2.trace)
        return resp

    # --- restricted-inventory hit rendering ------------------------------
    # Rendering a device-detected hit re-runs the interpreter; for
    # referential templates that naively rescans the WHOLE inventory per hit.
    # A lowered program only reaches inventory through its
    # InventoryUniqueJoin equality, so entries whose join value differs from
    # the review object's subject values cannot satisfy any clause — the
    # interpreter may run against just the join-key-matching candidates.
    def render_query(self, target, constraint, review,
                     cfg=None) -> QueryResponse:
        """Exact-engine query for message rendering of a device hit: the
        CEL evaluator for CEL kinds, else the interpreter with the inventory
        restricted to join candidates where provably safe."""
        if constraint.kind in self._cel_kinds:
            return self._cel.query(target, [constraint], review, cfg)
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
        return {
            "batchEvalNS": "nanoseconds spent in the device verdict kernel",
            "flattenNS": "nanoseconds spent flattening objects to columns",
        }.get(stat_name, self._interp.get_description_for_stat(stat_name))

    def lowered_kinds(self) -> list[str]:
        return sorted(self._programs)

    def fallback_kinds(self) -> dict[str, str]:
        return dict(self._lower_errors)

    # --- the batched device path ------------------------------------------
    def query_batch(
        self,
        target: str,
        constraints: Sequence[Constraint],
        reviews: Sequence[GkReview],
        cfg: Optional[ReviewCfg] = None,
        render_messages: bool = True,
        device: Optional[str] = None,
    ) -> list[QueryResponse]:
        """Evaluate all constraints against all reviews in one device pass.

        Returns one QueryResponse per review.  This is the kernel behind the
        webhook batcher and the audit's non-swept kinds.  ``device``: where
        the grids evaluate (default: the driver's own ``device``); it is
        resolved only when some kind is lowered, so a batch of fallback
        kinds never needs the card."""
        from gatekeeper_tpu_torch.observability import costattr, tracing

        t0 = time.perf_counter()
        occ: dict = {}
        with tracing.span("device.query_batch", n=len(reviews),
                          constraints=len(constraints)):
            out = self._query_batch_impl(target, constraints, reviews, cfg,
                                         render_messages, device,
                                         occ_out=occ)
        attr = costattr.active()
        if attr is not None and occ:
            # the shared admission pass (flatten + grid + render) splits
            # across templates by host mask row occupancy — per-template
            # shares sum back to this span's wall time
            attr.attribute(time.perf_counter() - t0,
                           {k: 1.0 + v for k, v in occ.items()},
                           costattr.EP_WEBHOOK, costattr.PHASE_DISPATCH,
                           rows=occ)
        return out

    def _query_batch_impl(self, target, constraints, reviews, cfg,
                          render_messages, device,
                          occ_out: Optional[dict] = None
                          ) -> list[QueryResponse]:
        cfg = cfg or ReviewCfg()
        n = len(reviews)
        responses = [QueryResponse() for _ in range(n)]
        if n == 0 or not constraints:
            return responses
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        fault_point("device.dispatch", lane="query_batch", n=n)

        objects = [r.request.object or {} for r in reviews]
        namespaces = [r.namespace for r in reviews]
        sources = [r.source for r in reviews]

        by_kind: dict[str, list[Constraint]] = {}
        for con in constraints:
            by_kind.setdefault(con.kind, []).append(con)

        # capture the programs ONCE: a template install replaces the dict
        # (never mutates it), so this batch finishes on the programs it
        # started on
        programs = self._programs
        cel_kinds = self._cel_kinds
        lowered_kinds = [k for k in by_kind
                         if k in programs
                         and self.inventory_exact(k, programs=programs)
                         and self.extdata_ready(k, programs=programs)]
        fallback_kinds = [k for k in by_kind if k not in lowered_kinds]
        if lowered_kinds:
            dev = resolve_device(self.device if device is None else device)

        t0 = time.perf_counter_ns()
        # DELETE reviews diverge for CEL kinds (the CEL evaluator sees
        # object null and oldObject = the object) while the flattened
        # columns carry the copied object: those (constraint, review)
        # pairs go through the CEL evaluator instead of the grid
        cel_delete_idx = [
            oi for oi, r in enumerate(reviews)
            if r.request.operation == "DELETE"
        ] if cel_kinds else []
        verdicts: dict[str, np.ndarray] = {}
        # flatten once with the union schema (identity columns are always
        # needed for match masks, even when every kind falls back)
        # the union is pinned to the captured program set (sorted, the
        # merge the pre-swap warm performs), not to the kinds with
        # constraints in this batch, so constraint churn never reshapes the
        # flatten; merged once per plan epoch
        cached = self._qb_schema
        if cached is not None and cached[0] == self.plan_epoch \
                and cached[1] is programs:
            schema = cached[2]
        else:
            schema = Schema()
            for kind in sorted(programs):
                schema.merge(programs[kind].program.schema)
            self._qb_schema = (self.plan_epoch, programs, schema)
        # power-of-two padding above the base bucket bounds the distinct
        # batch shapes at log2(max N)
        pad_n = self.batch_bucket
        while pad_n < n:
            pad_n *= 2
        tf = time.perf_counter_ns()
        review_docs = [
            {
                "kind": r.request.kind,
                "operation": r.request.operation,
                "name": r.request.name,
                "namespace": r.request.namespace,
                "userInfo": r.request.user_info,
                # UPDATE-delta policies compare object fields against
                # oldObject fields; absent outside UPDATE/DELETE, so such
                # rules stay vacuous on CREATE, as in the interpreter
                "oldObject": r.request.old_object,
            }
            for r in reviews
        ]
        batch = Flattener(schema, self.vocab).flatten(
            objects, pad_n=pad_n, reviews=review_docs)
        flatten_ns = time.perf_counter_ns() - tf
        if self.gen_coord is not None:
            # the latest real batch (references, not copies): the pre-swap
            # warm replays it through the next generation
            self._warm_ref = (objects, review_docs, pad_n)
        te = time.perf_counter_ns()
        batch_memo: dict = {}  # this batch's uploads, shared across kinds
        # every kind's parameter, extdata and inventory tables BEFORE any
        # run: their builds intern strings, and a vocab that grew after a
        # run's vocab tables would rebuild (and re-upload) them next batch
        inputs: dict = {}
        for kind in lowered_kinds:
            prog = programs[kind]
            table = build_param_table(prog.program, by_kind[kind],
                                      self.vocab)
            ext_cols, _ext_ok = self.extdata_cols(kind, batch,
                                                  programs=programs)
            extra = self.inventory_cols(kind, programs=programs)[0]
            if ext_cols:
                extra = {**extra, **ext_cols}
            inputs[kind] = (table, ext_cols, extra)
        for kind in lowered_kinds:
            prog = programs[kind]
            cons = by_kind[kind]
            table, ext_cols, extra = inputs[kind]
            grid = prog.run(batch, table, vocab=self.vocab,
                            extra_cols=extra,
                            device=dev,
                            dev_cache=self._dev_cache,
                            batch_cache=batch_memo)
            mask = masks_mod.constraint_masks(
                cons, batch, self.vocab, objects, namespaces, sources)
            if occ_out is not None:
                occ_out[kind] = int(mask.sum())
            # the admission grid is folded on the host (batches are small
            # and per-request rendering needs every hit anyway): account
            # the fetch next to the audit lane's
            self.perf["d2h_bytes"] = (self.perf.get("d2h_bytes", 0.0)
                                      + grid.nbytes)
            grid = grid[:, : batch.n] & mask
            if ext_cols:
                lane = self._active_extdata()
                if lane is not None and lane.mode == "differential":
                    self.extdata_differential(target, kind, cons, reviews,
                                              grid, mask, cfg)
            if kind in cel_kinds and cel_delete_idx:
                for ci, con in enumerate(cons):
                    for oi in cel_delete_idx:
                        if mask[ci, oi]:
                            qr = self._cel.query(target, [con], reviews[oi],
                                                 cfg)
                            responses[oi].results.extend(qr.results)
                    grid[ci, cel_delete_idx] = False
            verdicts[kind] = grid
        eval_ns = time.perf_counter_ns() - te

        # render hits through the exact engine
        for kind in lowered_kinds:
            grid = verdicts[kind]
            for ci, con in enumerate(by_kind[kind]):
                for oi in np.nonzero(grid[ci, :n])[0].tolist():
                    if render_messages:
                        qr = self.render_query(target, con, reviews[oi], cfg)
                        responses[oi].results.extend(qr.results)
                        if qr.trace:
                            responses[oi].trace = (
                                (responses[oi].trace + "\n" + qr.trace)
                                if responses[oi].trace else qr.trace)
                    else:
                        responses[oi].results.append(
                            Result(target=target, msg="", constraint=con.raw))

        # fallback kinds: exact engine on match-filtered pairs
        for kind in fallback_kinds:
            cons = by_kind[kind]
            engine = (self._cel.query if kind in cel_kinds
                      else self._interp.query)
            mask = masks_mod.constraint_masks(
                cons, batch, self.vocab, objects, namespaces, sources)
            if occ_out is not None:
                occ_out[kind] = int(mask[:, :n].sum())
            for ci, con in enumerate(cons):
                for oi in np.nonzero(mask[ci, :n])[0].tolist():
                    qr = engine(target, [con], reviews[oi], cfg)
                    responses[oi].results.extend(qr.results)

        if cfg.stats:
            total_ns = time.perf_counter_ns() - t0
            source = {"type": "engine", "value": DRIVER_NAME}
            responses[0].stats_entries.append(StatsEntry(
                scope="batch",
                stats_for=f"{len(constraints)} constraints x {n} objects",
                stats=[Stat("batchEvalNS", eval_ns, source),
                       Stat("flattenNS", flatten_ns, source),
                       Stat("totalNS", total_ns, source)]))
        return responses
