"""Device path-match kernel for mutation (BASELINE config #4).

The reference walks every (mutator, object) pair through the recursive
mutate function (pkg/mutation/mutators/core/mutation_function.go:26-239).
Here a parsed location path lowers to a fixed-depth index program over the
flattened token columns — the same predicate IR the verdict kernels use —
answering, per (mutator, object), "would the host walk CHANGE this
object?" as one [M, N] device grid.  The convergence loop (and the actual
tree surgery) stays host-side: the grid is the mass prefilter that keeps
the per-object Python walk off the no-op pairs.

Supported fragment (compile-or-fallback, like template lowering):
- Assign with a literal scalar value (no assignIf / fromMetadata /
  externalData), location = object nodes with at most ONE list node
  (glob ``[k: *]`` or string-keyed ``[k: v]``);
- AssignMetadata (labels/annotations keys, add-only semantics);
- no path tests (MustExist / MustNotExist).

Everything else returns None → the host walk is authoritative.  Parity
with ``core.mutate`` is asserted by tests/test_mutation_device.py
(including the walk's error outcomes — traversing a non-map — which
count as "no change").

Port of ``gatekeeper_tpu/mutation/device.py``: the grids are torch ops of
``CompiledProgram.run`` on ``device`` (default ``"cuda"``), and the host
numpy ``_np_eval`` stays the fast path for one program row over a burst.
``perf`` counts the rows each route decided (``np_eval_rows``,
``program_rows``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gatekeeper_tpu_torch.ir import nodes as N
from gatekeeper_tpu_torch.ir.program import CompiledProgram, build_param_table
from gatekeeper_tpu_torch.mutation.path_parser import ListNode, ObjectNode
from gatekeeper_tpu_torch.ops.flatten import (Axis, Flattener, K_FALSE, K_MAP,
                                        K_NULL, K_NUM, K_OTHER, K_TRUE,
                                        RaggedCol, ScalarCol, Schema)

_TRUE = N.ConstBool(True)
_FALSE = N.ConstBool(False)


def _and(*terms):
    flat = [t for t in terms if t is not _TRUE]
    if any(t is _FALSE for t in flat):
        return _FALSE
    if not flat:
        return _TRUE
    return flat[0] if len(flat) == 1 else N.And(tuple(flat))


def _or(*terms):
    flat = [t for t in terms if t is not _FALSE]
    if any(t is _TRUE for t in flat):
        return _TRUE
    if not flat:
        return _FALSE
    return flat[0] if len(flat) == 1 else N.Or(tuple(flat))


class _PathLowerer:
    def __init__(self, vocab):
        self.vocab = vocab
        self.schema = Schema()

    def _scol(self, path: tuple) -> ScalarCol:
        col = ScalarCol(path)
        if col not in self.schema.scalars:
            self.schema.scalars.append(col)
        return col

    def _rcol(self, axis: Axis, subpath: tuple) -> RaggedCol:
        col = RaggedCol(axis, subpath)
        if col not in self.schema.raggeds:
            self.schema.raggeds.append(col)
        return col

    def _prefix_ok(self, col_of, parts: tuple) -> N.Expr:
        """Every present proper prefix must be a map (a present non-map
        intermediate makes the walk ERROR → no change)."""
        gates = []
        for i in range(1, len(parts)):
            col = col_of(parts[:i])
            gates.append(_or(N.Not(N.Present(col)), N.KindIs(col, K_MAP)))
        return _and(*gates)

    def _equal(self, col_of, path: tuple, value) -> N.Expr:
        """deep_equal(current, value) for a literal scalar ``value``
        (bools never equal numbers — core._deep_equal)."""
        col = col_of(path)
        if isinstance(value, bool):
            return N.KindIs(col, K_TRUE if value else K_FALSE)
        if value is None:
            return N.KindIs(col, K_NULL)
        if isinstance(value, str):
            return N.EqStr(N.FeatSid(col),
                           N.ConstSid(self.vocab.intern(value)))
        if isinstance(value, (int, float)):
            return _and(N.KindIs(col, K_NUM),
                        N.CmpNum(N.FeatNum(col), "eq",
                                 N.ConstNum(float(value))))
        raise ValueError(f"non-scalar value {value!r}")

    def lower(self, path, value, add_only: bool) -> tuple:
        """(change, error) predicates for one mutator's location path —
        change ⇔ the walk mutates; error ⇔ the walk raises MutateError
        (a present non-map intermediate / non-list at a list node).  The
        two are disjoint: an error aborts and rolls back."""
        list_idx = [i for i, p in enumerate(path)
                    if isinstance(p, ListNode)]
        if len(list_idx) > 1:
            raise ValueError("multiple list nodes")
        if not isinstance(value, (str, int, float, bool, type(None))):
            raise ValueError("non-scalar assign value")

        if not list_idx:
            parts = tuple(p.name for p in path)
            col_of = self._scol
            ok = self._prefix_ok(col_of, parts)
            leaf = col_of(parts)
            if add_only:
                change = _and(ok, N.Not(N.Present(leaf)))
            else:
                change = _and(ok, N.Not(self._equal(col_of, parts, value)))
            return change, N.Not(ok)

        g = list_idx[0]
        node: ListNode = path[g]
        if node.key_value is not None and not isinstance(
                node.key_value, str):
            raise ValueError("non-string list key")
        outer = tuple(p.name for p in path[:g])
        rest = tuple(p.name for p in path[g + 1:])
        if not rest:
            raise ValueError("list node is the path leaf (item assign)")
        if not outer:
            raise ValueError("list node at the path root")

        outer_ok = self._prefix_ok(self._scol, outer)
        list_col = self._scol(outer)
        axis = Axis(((outer,),))
        self._rcol(axis, ())  # materialize the axis counts

        def icol_of(parts: tuple) -> RaggedCol:
            return self._rcol(axis, parts)

        item_is_map = N.KindIs(icol_of(()), K_MAP)
        item_ok = self._prefix_ok(icol_of, rest)
        if add_only:
            item_change = N.Not(N.Present(icol_of(rest)))
        else:
            item_change = N.Not(self._equal(icol_of, rest, value))
        per_item = _and(item_is_map, item_ok, item_change)
        bad_list = _and(N.Present(list_col),
                        N.Not(N.KindIs(list_col, K_OTHER)))

        if node.glob:
            # glob never creates (absent/non-list/empty → no change); ANY
            # traversed item hitting a present non-map intermediate ERRORS
            # the whole walk — the system rolls back, so nothing changes
            any_err = N.AnyAxis(axis, _and(item_is_map, N.Not(item_ok)))
            err = _or(N.Not(outer_ok), bad_list, any_err)
            change = _and(outer_ok, N.KindIs(list_col, K_OTHER),
                          N.AnyAxis(axis, per_item), N.Not(any_err))
            return change, err

        key_eq = N.EqStr(N.FeatSid(icol_of((node.key_field,))),
                         N.ConstSid(self.vocab.intern(node.key_value)))
        matched_change = N.AnyAxis(axis, _and(item_is_map, key_eq,
                                              item_ok, item_change))
        matched_err = N.AnyAxis(axis, _and(item_is_map, key_eq,
                                           N.Not(item_ok)))
        no_match = N.Not(N.AnyAxis(axis, _and(item_is_map, key_eq)))
        # missing keyed item: the walk creates it and sets the leaf →
        # always a change (add-only too — the fresh leaf is absent);
        # an absent list is created the same way, a present NON-list errors
        list_ok = _or(N.Not(N.Present(list_col)),
                      N.KindIs(list_col, K_OTHER))
        err = _or(N.Not(outer_ok), bad_list, matched_err)
        change = _and(outer_ok, list_ok, _or(matched_change, no_match),
                      N.Not(matched_err))
        return change, err


class MutationPrefilter:
    """[M, N] would-change grids for a set of lowerable mutators.

    ``flatten_lane`` selects the columnizer the grids run over
    (``ops.flatten.FLATTEN_LANES``): ``auto`` takes the raw-bytes
    threaded C lane when the caller hands RawJSON objects over (the
    ``--mutate-ingest raw`` burst path) and the dict walker otherwise;
    ``differential`` runs raw THEN dict per batch and asserts the
    columns bit-identical (the ingest-lane proof)."""

    def __init__(self, vocab=None, flatten_lane: str = "auto",
                 device: str = "cuda"):
        from gatekeeper_tpu_torch import resolve_device
        from gatekeeper_tpu_torch.ops.flatten import Vocab

        # a vocab of its own: never the driver's, whose lock the served
        # process arms for the validating batcher and the audit loop
        self.vocab = vocab if vocab is not None else Vocab()
        self.flatten_lane = flatten_lane
        self.device = resolve_device(device)
        # object rows decided per route: the host numpy interpretation
        # (``_np_eval``) or the compiled program on ``device``
        self.perf = {"np_eval_rows": 0, "program_rows": 0}
        self._programs: dict = {}  # id -> (CompiledProgram, schema)
        self._unsupported: dict = {}  # id -> reason

    def add_mutator(self, mutator) -> bool:
        """Compile one mutator's path program; False → host-only."""
        key = mutator.id
        try:
            value = getattr(mutator, "value", None)
            if mutator.kind == "Assign":
                if getattr(mutator, "assign_if", None):
                    raise ValueError("assignIf")
                if getattr(mutator, "from_metadata", None) is not None \
                        or getattr(mutator, "external", None) is not None:
                    raise ValueError("fromMetadata/externalData")
                add_only = False
            elif mutator.kind == "AssignMetadata":
                add_only = True
            else:
                raise ValueError(f"kind {mutator.kind}")
            if getattr(mutator, "tester", None) is not None and \
                    getattr(mutator.tester, "_by_depth", None):
                raise ValueError("path tests")
            if isinstance(value, (int, float)) and \
                    not isinstance(value, bool) and \
                    float(np.float32(value)) != float(value):
                # device equality compares float32 columns: a value that
                # doesn't round-trip f32 exactly could report "equal"
                # (no change) where the host's exact compare mutates —
                # keep such mutators host-authoritative
                raise ValueError("non-float32-exact numeric value")
            low = _PathLowerer(self.vocab)
            change, err = low.lower(mutator.path, value, add_only)
            self._programs[key] = (
                CompiledProgram(N.Program(
                    template_kind=f"mutator:{key}", expr=change,
                    params=(), schema=low.schema)),
                CompiledProgram(N.Program(
                    template_kind=f"mutator-err:{key}", expr=err,
                    params=(), schema=low.schema)),
                # change ∨ error in ONE program: the batched lane's
                # relevance test needs only this grid per mutator; the
                # err split runs lazily for mutators that actually have
                # relevant objects (halves the per-burst program runs)
                CompiledProgram(N.Program(
                    template_kind=f"mutator-rel:{key}",
                    expr=_or(change, err),
                    params=(), schema=low.schema)),
            )
            self._unsupported.pop(key, None)
            return True
        except (ValueError, Exception) as e:  # noqa: BLE001 — fallback
            self._programs.pop(key, None)
            self._unsupported[key] = str(e)
            return False

    def lowered_ids(self) -> list:
        return sorted(self._programs, key=str)

    def unsupported(self) -> dict:
        return dict(self._unsupported)

    def _grids(self, mutators: Sequence, objects: Sequence[dict],
               which: int, pad_n: Optional[int] = None) -> np.ndarray:
        n = len(objects)
        out = np.zeros((len(mutators), n), bool)
        todo = [(mi, self._programs[m.id][which])
                for mi, m in enumerate(mutators)
                if m.id in self._programs]
        if not todo or n == 0:
            return out
        schema = Schema()
        for _mi, prog in todo:
            schema.merge(prog.program.schema)
        pad = pad_n or max(8, 1 << (n - 1).bit_length())
        batch = Flattener(schema, self.vocab,
                          lane=self.flatten_lane).flatten(
            objects, pad_n=pad)
        for mi, prog in todo:
            out[mi] = self._run_program(prog, batch, n)
        return out

    def _run_program(self, prog, batch, n: int) -> np.ndarray:
        """One program row ([N] bool) through ``CompiledProgram.run`` on
        the prefilter's device."""
        table = build_param_table(prog.program, [_NoParams()], self.vocab)
        self.perf["program_rows"] += n
        return prog.run(batch, table, vocab=self.vocab,
                        device=self.device)[0, :n]

    def _run_on_batch(self, mutator, which: int, batch, n: int):
        """One program row ([N] bool) over an already-flattened batch.

        Mutator predicate programs are tiny (a handful of presence/kind/
        equality gates); at webhook-burst sizes one device dispatch per
        program costs far more than the arithmetic, so a direct numpy interpretation of
        the SAME expr tree is the fast path — semantics mirror
        ir/program.py:eval_expr for the fragment node set, and any node
        outside it takes the compiled program on the device (differential
        parity is pinned either way)."""
        prog = self._programs[mutator.id][which]
        try:
            out = _np_eval(prog.program.expr, batch, n)
        except _NpUnsupported:
            return self._run_program(prog, batch, n)
        self.perf["np_eval_rows"] += n
        return np.broadcast_to(np.asarray(out, bool), (n,))

    def relevance_and_batch(self, mutators: Sequence,
                            objects: Sequence[dict],
                            pad_n: Optional[int] = None) -> tuple:
        """(change∨error [M, N], ColumnBatch) with ONE flatten — the
        batched mutation lane's entry point: ONE combined relevance
        program runs per mutator over a shared columnize pass, and the
        host-side batch stays available for columnar patch emission
        (presence/kind reads) and the lazy error split
        (:meth:`error_row`)."""
        n = len(objects)
        rel = np.zeros((len(mutators), n), bool)
        todo = [(mi, m) for mi, m in enumerate(mutators)
                if m.id in self._programs]
        if not todo or n == 0:
            return rel, None
        schema = Schema()
        for _mi, m in todo:
            for prog in self._programs[m.id]:
                schema.merge(prog.program.schema)
        pad = pad_n or max(8, 1 << (n - 1).bit_length())
        batch = Flattener(schema, self.vocab,
                          lane=self.flatten_lane).flatten(
            objects, pad_n=pad)
        for mi, m in todo:
            rel[mi] = self._run_on_batch(m, 2, batch, n)
        return rel, batch

    def error_row(self, mutator, batch, n: int):
        """[N] bool error row over the shared batch (lazy: only runs
        for mutators that actually have relevant objects)."""
        return self._run_on_batch(mutator, 1, batch, n)

    def would_change(self, mutators: Sequence, objects: Sequence[dict],
                     pad_n: Optional[int] = None) -> np.ndarray:
        """[M, N] bool: grid[m, n] ⇔ the host walk would change object n
        with mutator m (rows for non-lowered mutators are False —
        callers route those through the host walk)."""
        return self._grids(mutators, objects, 0, pad_n)

    def would_error(self, mutators: Sequence, objects: Sequence[dict],
                    pad_n: Optional[int] = None) -> np.ndarray:
        """[M, N] bool: the host walk would raise MutateError (present
        non-map intermediate, non-list at a list node)."""
        return self._grids(mutators, objects, 1, pad_n)


class _NoParams:
    """Parameter-less constraint stand-in for build_param_table."""

    parameters: dict = {}


class _NpUnsupported(Exception):
    """Expr node outside the numpy fast path's fragment."""


def _np_eval(expr, batch, n: int):
    """Numpy interpretation of a mutator predicate over a host-side
    ColumnBatch — the node-for-node mirror of eval_expr (ir/program.py)
    restricted to the fragment _PathLowerer emits: ConstBool / And / Or
    / Not / Present / KindIs / EqStr(FeatSid, ConstSid) /
    CmpNum(eq, FeatNum, ConstNum) / AnyAxis."""

    def feat(col, field, in_axis):
        store = batch.raggeds if isinstance(col, RaggedCol) \
            else batch.scalars
        c = store.get(col)
        if c is None:
            raise _NpUnsupported(str(col))
        a = getattr(c, field)[:n]
        if in_axis and not isinstance(col, RaggedCol):
            a = a[:, None]  # _expand_for_ctx: scalar under an axis
        return a

    def sidlike(e, in_axis):
        if isinstance(e, N.FeatSid):
            kind = feat(e.col, "kind", in_axis)
            return feat(e.col, "sid", in_axis), kind == 4  # K_STR
        if isinstance(e, N.ConstSid):
            return np.int32(e.sid), np.bool_(True)
        raise _NpUnsupported(type(e).__name__)

    def ev(e, in_axis):
        if isinstance(e, N.ConstBool):
            return np.bool_(e.value)
        if isinstance(e, N.Not):
            return np.logical_not(ev(e.inner, in_axis))
        if isinstance(e, N.And):
            out = None
            for t in e.terms:
                v = ev(t, in_axis)
                out = v if out is None else out & v
            return out if out is not None else np.bool_(True)
        if isinstance(e, N.Or):
            out = None
            for t in e.terms:
                v = ev(t, in_axis)
                out = v if out is None else out | v
            return out if out is not None else np.bool_(False)
        if isinstance(e, N.Present):
            return feat(e.col, "kind", in_axis) > 0
        if isinstance(e, N.KindIs):
            return feat(e.col, "kind", in_axis) == e.kind
        if isinstance(e, N.EqStr):
            if e.negate:
                raise _NpUnsupported("EqStr negate")
            lv, lok = sidlike(e.lhs, in_axis)
            rv, rok = sidlike(e.rhs, in_axis)
            return lok & rok & (lv == rv)
        if isinstance(e, N.CmpNum):
            if e.op != "eq" or not isinstance(e.lhs, N.FeatNum) or \
                    not isinstance(e.rhs, N.ConstNum):
                raise _NpUnsupported("CmpNum")
            kind = feat(e.lhs.col, "kind", in_axis)
            num = feat(e.lhs.col, "num", in_axis)
            return (kind == K_NUM) & (num == np.float32(e.rhs.value))
        if isinstance(e, N.AnyAxis):
            if in_axis:
                raise _NpUnsupported("nested AnyAxis")
            counts = batch.axis_counts.get(e.axis)
            if counts is None:
                raise _NpUnsupported(str(e.axis))
            counts = counts[:n]
            inner = ev(e.inner, True)
            if getattr(inner, "ndim", 0) < 2:
                return np.asarray(inner) & (counts > 0)
            m = inner.shape[1]
            valid = np.arange(m) < counts[:, None]
            return np.any(inner & valid, axis=1)
        raise _NpUnsupported(type(e).__name__)

    return ev(expr, False)
