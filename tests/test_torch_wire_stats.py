"""The warm pass's wire narrowing in the port (``parallel/sweep.py``:
``col_stats_update``, ``merge_pad_stats``, the stats branch of
``pack_transfer_cols``, ``unpack_transfer_cols`` on the device, and
``SweepEvaluator.warm_pass``) against the JAX package's
``parallel/sharded.py``.

The host half is a copy: on the library's columns and on a case list that
covers every wire dtype (``|n1``, ``|u1``, ``<u2``, integral ``<f4``), a
constant column, an alias, the ``|u1`` dictionary remap and a chunk that
drifts outside the corpus stats, the buffers must be byte-identical and
the layouts equal.  Each unpack (torch, on the CPU) must equal JAX's under
``jax.jit`` value for value and dtype for dtype.  Verdicts after a
``warm_pass`` must equal the stats-free sweep's and the JAX package's
``warm_pass`` + sweep."""

import glob
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.parallel import sharded as J  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir.convert import to_tensor  # noqa: E402
from gatekeeper_tpu_torch.parallel import sweep as T  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.rawjson import peek_kind  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import (library_dir,  # noqa
                                                  load_library)
from gatekeeper_tpu_torch.utils.unstructured import \
    load_yaml_file  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

N_OBJECTS = 600
CHUNK = 64
# the warm-pass verdict cases run a library subset, so the JAX package's
# warm pass (one compile per hit-buffer step) stays short
KEEP = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits",
        "K8sDisallowedTags", "K8sHttpsOnly", "K8sReplicaLimits",
        "K8sPSPCapabilities", "K8sNoPrivileged")


@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=11)


def _port_client(objects, skip=()):
    cel = TCELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel)
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    load_library(client, skip_kinds=skip)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    return client, driver


def _skip():
    kinds = [load_yaml_file(p)[0]["spec"]["crd"]["spec"]["names"]["kind"]
             for p in glob.glob(os.path.join(library_dir(), "*", "*",
                                             "template.yaml"))]
    assert set(KEEP) <= set(kinds)
    return tuple(k for k in kinds if k not in KEEP)


def _same_packing(cols, pad_n, tstats, jstats):
    tb, tl = T.pack_transfer_cols(cols, pad_n, stats=tstats)
    jb, jl = J.pack_transfer_cols(cols, pad_n, stats=jstats)
    assert tl == jl
    assert tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].dtype == jb[k].dtype, k
        assert tb[k].tobytes() == jb[k].tobytes(), k
    return tb, tl


def _same_unpack(bufs, layout, pad_n, cols):
    """The port's unpack (torch) equals JAX's under jit and the columns.
    The buffers cross as the sweep stages them: in ``torch_dtype`` (int64
    and float64 narrowed, ``<u2`` as the same bits in int16)."""
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        v.view(np.int16) if k == "<u2" else v)).to(T.torch_dtype(k))
        for k, v in bufs.items()}
    got = T.unpack_transfer_cols(dev, layout, pad_n)
    want = jax.jit(lambda b: J.unpack_transfer_cols(b, layout, pad_n))(
        {k: np.ascontiguousarray(v) for k, v in bufs.items()})
    for key, sub, *_rest in layout:
        g = got[key] if sub is None else got[key][sub]
        w = np.asarray(want[key] if sub is None else want[key][sub])
        c = to_tensor(cols[key] if sub is None else cols[key][sub], "cpu")
        assert str(g.numpy().dtype) == str(w.dtype), (key, sub)
        assert g.dtype == c.dtype, (key, sub)
        assert np.array_equal(g.numpy(), w), (key, sub)
        assert torch.equal(g, c), (key, sub)


def test_library_columns_pack_like_jax(objects):
    """Every routed group's chunks of the library corpus: equal stats,
    byte-identical narrowed buffers and layouts, equal unpacks; the later
    half of the chunks, packed with the first half's stats only, drift
    and still pack and unpack exactly."""
    client, driver = _port_client(objects)
    ev = T.SweepEvaluator(driver, device="cpu")
    cons = client.constraints()
    router = T.make_kind_router(cons)
    groups: dict = {}
    for o in objects:
        g = router(peek_kind(o))
        if g:
            groups.setdefault(g, []).append(o)
    kinds = set()
    checked = 0
    for g, objs in groups.items():
        cg = [c for c in cons if c.kind in g]
        flats = [ev.sweep_flatten(cg, objs[i: i + CHUNK])
                 for i in range(0, len(objs), CHUNK)]
        flats = [f for f in flats if f]
        for part in (flats, flats[: max(1, len(flats) // 2)]):
            ts, js = {}, {}
            for f in part:
                T.col_stats_update(ts, f.cols)
                J.col_stats_update(js, f.cols)
            T.merge_pad_stats(ts)
            J.merge_pad_stats(js)
            assert ts == js
            for f in flats:
                bufs, layout = _same_packing(f.cols, f.pad_n, ts, js)
                _same_unpack(bufs, layout, f.pad_n, f.cols)
                kinds |= {e[2] for e in layout}
                checked += 1
    assert checked >= 20
    assert {"|n1", "|u1", "<u2", "const", "alias"} <= kinds


def _mk_cols(rng, n):
    shared = rng.integers(-1, 3000, (n, 4)).astype(np.int32)
    return {
        # u2 sid + nibble kind + integral-float num
        "a": {"sid": rng.integers(-1, 40000, (n, 8)).astype(np.int32),
              "kind": rng.integers(-1, 7, (n, 8)).astype(np.int8),
              "num": rng.integers(0, 60000, (n, 8)).astype(np.float32)},
        # dictionary remap (4 distinct values, range >> u1) + an odd-width
        # nibble candidate that falls back to u1
        "b": {"sid": rng.choice(
                  np.array([-1, 5, 70000, 123456], np.int32), (n, 4)),
              "count": rng.integers(0, 8, n).astype(np.int32)},
        # corpus-constant: elided to a layout scalar
        "c": np.full((n, 8), -1, np.int32),
        # genuine floats: as they are
        "d": {"num": rng.standard_normal((n, 2)).astype(np.float32)},
        # int64 in u1 range, and one array under two keys: an alias
        "e": {"idx": rng.integers(-1, 200, (n, 3)).astype(np.int64),
              "sid": shared},
        "f": {"sid": shared},
        # booleans and a constant boolean
        "g": {"flag": rng.integers(0, 2, (n, 2)).astype(bool),
              "same": np.ones((n, 1), bool)},
    }


def _drift(cols):
    out = {k: ({s: v.copy() for s, v in val.items()}
               if isinstance(val, dict) else val.copy())
           for k, val in cols.items()}
    out["f"]["sid"] = out["e"]["sid"]  # keep the alias
    out["b"]["sid"][0, 0] = 999999   # outside the corpus dictionary
    out["a"]["kind"][0, 0] = 100     # outside the nibble range
    out["c"][0, 0] = 7               # breaks the constant
    out["a"]["num"][0, 0] = 0.5      # the integral f4 drifts fractional
    out["e"]["idx"][0, 0] = 70000    # past u2
    out["g"]["same"][0, 0] = False
    return out


@pytest.mark.parametrize("case", ["corpus", "drift", "no-stats",
                                  "empty-stats", "multichunk"])
def test_every_wire_kind_packs_like_jax(case):
    n = 64
    rng = np.random.default_rng(0)
    cols = _mk_cols(rng, n)
    ts, js = {}, {}
    T.col_stats_update(ts, cols)
    J.col_stats_update(js, cols)
    assert ts == js
    if case == "corpus":
        bufs, layout = _same_packing(cols, n, ts, js)
        wires = {e[2] for e in layout}
        assert {"<u2", "|n1", "|u1", "const", "<f4", "alias",
                "|b1"} <= wires
        assert any(isinstance(e[7], tuple) and e[2] == "|u1"
                   for e in layout)  # the dictionary remap
        _same_unpack(bufs, layout, n, cols)
    elif case == "drift":
        drift = _drift(cols)
        bufs, layout = _same_packing(drift, n, ts, js)
        _same_unpack(bufs, layout, n, drift)
        assert not any(e[0] == "c" and e[2] == "const" for e in layout)
    elif case in ("no-stats", "empty-stats"):
        stats = None if case == "no-stats" else {}
        bufs, layout = _same_packing(cols, n, stats, stats)
        _same_unpack(bufs, layout, n, cols)
        assert {e[2] for e in layout} == {"<i4", "|i1", "<f4", "<i8",
                                          "|b1", "alias"}
    else:
        chunks = [_mk_cols(rng, n) for _ in range(3)]
        ts, js = {}, {}
        for ch in chunks:
            T.col_stats_update(ts, ch)
            J.col_stats_update(js, ch)
        layouts = []
        for ch in chunks:
            bufs, layout = _same_packing(ch, n, ts, js)
            _same_unpack(bufs, layout, n, ch)
            layouts.append(layout)
        assert layouts[0] == layouts[1] == layouts[2]


def test_merge_pad_stats_like_jax():
    stats = {("rg:x", "sid"): (3, 9, 3, frozenset({3, 9}), False),
             ("rg:x", "num"): (1.0, 4.0, None, None, True),
             ("mk:y", "kind"): (0, 0, 0, None, False),
             ("pl:z", "sid"): (3, 9, None, None, False)}
    js = dict(stats)
    T.merge_pad_stats(stats)
    J.merge_pad_stats(js)
    assert stats == js
    assert stats[("rg:x", "sid")] == (-1, 9, None, frozenset({-1, 3, 9}),
                                      False)


@pytest.mark.parametrize("bias", [0, 1])
def test_u2_widens_like_numpy(bias):
    """``<u2`` crosses as the same bits in int16 and widens back with
    ``& 0xFFFF``: every value of the range survives the staging the sweep
    uses (an int16 page viewed as uint16)."""
    vals = np.arange(-bias, 0xFFFF - bias, 7, dtype=np.int32)
    n = len(vals) // 2 * 2
    col = vals[:n].reshape(n // 2, 2)
    stats = {("k", None): (int(col.min()), int(col.max()), None, None,
                           False)}
    stage = {}

    def alloc(dt, shape):
        stage[dt] = torch.empty(shape, dtype=T.torch_dtype(dt))
        arr = stage[dt].numpy()
        return arr.view(np.uint16) if dt == "<u2" else arr

    bufs, layout = T.pack_transfer_cols({"k": col}, n // 2, stats=stats,
                                        alloc=alloc)
    assert layout[0][2] == "<u2" and stage["<u2"].dtype == torch.int16
    out = T.unpack_transfer_cols(stage, layout, n // 2)
    assert out["k"].dtype == torch.int32
    np.testing.assert_array_equal(out["k"].numpy(), col)
    np.testing.assert_array_equal(
        bufs["<u2"], (col + 1).astype(np.uint16))


def test_sweep_upload_narrows_after_stats(objects):
    """The sweep's staged upload with corpus stats: fewer wire bytes, and
    the device columns equal the per-column upload."""
    client, driver = _port_client(objects)
    ev = T.SweepEvaluator(driver, device="cpu")
    cons = client.constraints()
    pods = [o for o in objects if o["kind"] == "Pod"][:CHUNK]
    flat = ev.sweep_flatten(cons, pods)
    keep: list = []
    ev._upload_cols(flat.cols, flat.pad_n, keep)
    plain = ev.perf["wire_bytes"]
    T.col_stats_update(ev._col_stats, flat.cols)
    ev.perf_reset()
    got = ev._upload_cols(flat.cols, flat.pad_n, keep)
    assert ev.perf["wire_bytes"] < plain / 2
    for key, val in flat.cols.items():
        vals = val if isinstance(val, dict) else {None: val}
        outs = got[key] if isinstance(val, dict) else {None: got[key]}
        for sub, a in vals.items():
            want = to_tensor(a, "cpu")
            assert outs[sub].dtype == want.dtype, (key, sub)
            assert torch.equal(outs[sub], want), (key, sub)


def _summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


@pytest.mark.parametrize("collect,exact", [("reduced", False),
                                           ("reduced", True),
                                           ("masks", True)])
def test_warm_pass_verdicts_match_stats_free_and_jax(objects, monkeypatch,
                                                     collect, exact):
    skip = _skip()
    client, driver = _port_client(objects, skip)
    plain_ev = T.SweepEvaluator(driver, device="cpu", collect=collect)
    cfg = TConfig(chunk_size=CHUNK, exact_totals=exact)
    plain = _summary(TManager(client, lambda: iter(objects), cfg,
                              evaluator=plain_ev).audit())

    client, driver = _port_client(objects, skip)
    ev = T.SweepEvaluator(driver, device="cpu", collect=collect)
    fetched = []
    real_fetch = ev._fetch
    monkeypatch.setattr(ev, "_fetch", lambda p: fetched.append(p) or
                        real_fetch(p))
    ev.warm_pass(client.constraints(), iter(objects), CHUNK,
                 return_bits=exact)
    # nothing collected: no fetch, and no hit-buffer state moved
    assert fetched == []
    assert all(st == {"cap": 256, "low": 0, "pinned": False, "blast": None}
               for st in ev._hit_state.values())
    assert ev._col_stats and ev._width_targets
    warm = _summary(TManager(client, lambda: iter(objects), cfg,
                             evaluator=ev).audit())
    assert warm == plain
    assert ev.perf["wire_bytes"] < plain_ev.perf["wire_bytes"]

    cel = JCELDriver()
    jdriver = TpuDriver(cel_driver=cel)
    jclient = JClient(target=JTarget(), drivers=[jdriver, cel],
                      enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(jclient, skip_kinds=skip)
    for o in objects:
        if o["kind"] == "Ingress":
            jclient.add_data(o)
    jev = J.ShardedEvaluator(jdriver, J.make_mesh(1), collect=collect)
    jev.warm_pass(jclient.constraints(), iter(objects), CHUNK,
                  return_bits=exact)
    jrun = JManager(jclient, lambda: iter(objects),
                    JConfig(chunk_size=CHUNK, exact_totals=exact,
                            pipeline="off"), evaluator=jev).audit()
    assert warm == _summary(jrun)
    assert ev._col_stats == jev._col_stats
    # the flatten key classes differ by package: compare their reprs
    assert {repr(k): v for k, v in ev._width_targets.items()} == \
        {repr(k): v for k, v in jev._width_targets.items()}
    state = ev.warm_state()
    assert state["col_stats"] == ev._col_stats
    fresh = T.SweepEvaluator(driver, device="cpu")
    fresh.restore_warm_state(state)
    assert fresh._col_stats == ev._col_stats
    assert fresh._width_targets == ev._width_targets
