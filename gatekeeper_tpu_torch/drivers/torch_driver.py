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

Not ported yet: generation swaps, the compile cache, the external-data
lane, cost attribution, tracing and metrics.  Kinds with external-data
joins therefore never ride the device grid (``extdata_ready`` is False
for them) and run through the interpreter.
"""

from __future__ import annotations

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
from gatekeeper_tpu_torch.ops.flatten import (Flattener, RaggedCol,
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
                 cel_driver=None):
        self._interp = RegoDriver()
        self._cel = cel_driver  # optional CELDriver
        self._cel_kinds: set = set()  # kinds owned by the CEL engine
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
        self._dev_cache: dict = {}  # host array id -> device tensor (LRU)
        self.batch_bucket = batch_bucket
        self.device = device
        # device->host transfer accounting for query_batch (grid fetches),
        # the admission-side twin of the sweep evaluator's perf["d2h_bytes"]
        self.perf: dict = {}

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
        if self._interp.has_source_for(template):
            return True
        return self._cel is not None and self._cel.has_source_for(template)

    def add_template(self, template: ConstraintTemplate) -> None:
        if not self._interp.has_source_for(template) and \
                self._cel is not None and self._cel.has_source_for(template):
            self._add_cel_template(template)
            return
        self._interp.add_template(template)
        self._cel_kinds = self._cel_kinds - {template.kind}
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

    def _add_cel_template(self, template: ConstraintTemplate) -> None:
        self._cel.add_template(template)
        self._cel_kinds = self._cel_kinds | {template.kind}
        compiled = self._cel._templates[template.kind]
        try:
            program = lower_cel_template(
                compiled, template.kind, self.vocab,
                schema_hint=template.parameters_schema)
            self._trial_param_table(program, template.kind)
        except LowerError as e:
            self._install(template.kind, None, str(e))
            return
        self._install(template.kind, CompiledProgram(program), None)

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
        if template_kind in self._cel_kinds:
            self._cel.remove_template(template_kind)
            self._cel_kinds = self._cel_kinds - {template_kind}
        else:
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
        if constraint.kind in self._cel_kinds:
            self._cel.add_constraint(constraint)
        else:
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
        cfg = cfg or ReviewCfg()
        n = len(reviews)
        responses = [QueryResponse() for _ in range(n)]
        if n == 0 or not constraints:
            return responses

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
        schema = Schema()
        for kind in lowered_kinds:
            schema.merge(programs[kind].program.schema)
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
        te = time.perf_counter_ns()
        batch_memo: dict = {}  # this batch's uploads, shared across kinds
        for kind in lowered_kinds:
            prog = programs[kind]
            cons = by_kind[kind]
            table = build_param_table(prog.program, cons, self.vocab)
            grid = prog.run(batch, table, vocab=self.vocab,
                            extra_cols=self.inventory_cols(
                                kind, programs=programs)[0],
                            device=dev,
                            dev_cache=self._dev_cache,
                            batch_cache=batch_memo)
            mask = masks_mod.constraint_masks(
                cons, batch, self.vocab, objects, namespaces, sources)
            # the admission grid is folded on the host (batches are small
            # and per-request rendering needs every hit anyway): account
            # the fetch next to the audit lane's
            self.perf["d2h_bytes"] = (self.perf.get("d2h_bytes", 0.0)
                                      + grid.nbytes)
            grid = grid[:, : batch.n] & mask
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
