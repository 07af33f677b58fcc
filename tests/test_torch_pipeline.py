"""The port's host-throughput machinery (gatekeeper_tpu_torch/pipeline/,
the staged schedule of audit/manager.py, the flatten worker processes and
the packed upload of parallel/sweep.py, the mutation lane's ingest lanes
and the CLI flags), on the CPU, against the JAX package.

- the staged executor: order across a worker pool, bounded queues under
  backpressure, a stage error and a source error that propagate without
  a hang, measurable overlap, a stage restart within ``max_retries``;
- ``resolve_schedule`` for every mode and for ``auto`` on 1 and 8 cores
  (serial on both: the port's stages share the interpreter lock);
- the library corpus (``make_cluster_objects(2000, seed=11)``, chunks of
  256, Ingresses as inventory) on both collect lanes, with exact totals
  and without: the port's pipelined relist equals its serial relist and
  the JAX ``AuditManager`` with ``pipeline="on"`` (totals, kept
  ``(kind, name, namespace, message)`` in order).  Exact totals render
  every hit through the interpreter, so those cases audit the first 800
  objects, both lanes against the JAX masks lane's run;
- a ``RawJSON`` lister with ``flatten_workers=2`` and
  ``flatten_lane="raw"`` equal to the dict lister's serial run, every
  chunk the columnizer's clamp lets fan out reporting ``raw+workers``;
- ``pipeline="differential"``; a failing fold stage degrading to serial;
- the packed upload against the per-column upload; the vocab a bijection
  after a pipelined pass with two flatten threads over new strings;
- ``MutationLane(ingest=raw|differential)`` against the dict lane and the
  JAX lane; the CLI's ``--pipeline``/``--flatten-lane``/
  ``--flatten-workers`` runs against the JAX CLI's stdout."""

import ast
import copy
import inspect
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.mutation.system import \
    MutationSystem as JSystem  # noqa: E402
from gatekeeper_tpu.mutlane import MutationLane as JLane  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch import pipeline as P  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir.convert import to_tensor  # noqa: E402
from gatekeeper_tpu_torch.mutation.system import \
    MutationSystem as TSystem  # noqa: E402
from gatekeeper_tpu_torch.mutlane import MutationLane  # noqa: E402
from gatekeeper_tpu_torch.ops import flatten as tflatten  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.pipeline import (PipelineError, Stage,  # noqa
                                           StagedPipeline)
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.rawjson import RawJSON, as_raw  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_OBJECTS = 2000
N_EXACT = 800
CHUNK = 256


# --- the executor ----------------------------------------------------------

def test_executor_preserves_order_across_worker_pool():
    """A multi-worker stage emits in INPUT order whatever the completion
    order; a None result drops the item."""
    rng = np.random.default_rng(3)
    delays = rng.random(150) * 0.003
    out = []

    def jitter(x):
        time.sleep(delays[x])
        return None if x % 7 == 3 else x * 2

    run = StagedPipeline([
        Stage("jitter", jitter, workers=4, queue_cap=2),
        Stage("sink", lambda x: (out.append(x), None)[1], queue_cap=2),
    ]).run(range(150))
    assert out == [x * 2 for x in range(150) if x % 7 != 3]
    assert run.source_items == 150
    assert run.stage("jitter").items == 150
    assert run.stage("sink").items == len(out)


def test_executor_backpressure_bounds_queues_and_completes():
    """Queue bounds of 1: no deadlock, no queue past its bound, and the
    source measurably stalls on the bounded queue."""
    out = []
    run = StagedPipeline([
        Stage("slow", lambda x: (time.sleep(0.002), x)[1], queue_cap=1),
        Stage("sink", lambda x: (out.append(x), None)[1], queue_cap=1),
    ], source_cap=1).run(range(60))
    assert out == list(range(60))
    for s in run.stages:
        assert s.queue_highwater <= 1, (s.name, s.queue_highwater)
    assert run.source_stall_s > 0


def test_executor_stage_error_propagates_without_hanging():
    def boom(x):
        if x == 5:
            raise ValueError("stage blew up")
        return x

    t0 = time.perf_counter()
    with pytest.raises(PipelineError) as ei:
        StagedPipeline([
            Stage("boom", boom, queue_cap=1),
            Stage("sink", lambda x: None, queue_cap=1),
        ]).run(range(1000))
    assert time.perf_counter() - t0 < 30  # unwound, not deadlocked
    assert ei.value.stage == "boom"
    assert isinstance(ei.value.__cause__, ValueError)


def test_executor_source_error_propagates():
    def src():
        yield 1
        raise RuntimeError("lister died")

    with pytest.raises(PipelineError) as ei:
        StagedPipeline([Stage("s", lambda x: None)]).run(src())
    assert ei.value.stage == "<source>"


def test_executor_overlap_is_measurable():
    """Two stages waiting with the interpreter lock released overlap:
    the stages' busy sum exceeds the pipeline wall."""
    run = StagedPipeline([
        Stage("a", lambda x: (time.sleep(0.01), x)[1], queue_cap=2),
        Stage("b", lambda x: (time.sleep(0.01), None)[1], queue_cap=2),
    ]).run(range(20))
    assert run.stage_busy_sum() > run.wall_s * 1.3, (
        run.stage_busy_sum(), run.wall_s)
    assert 0 < run.summary()["overlap_ratio"]


def test_executor_stage_restart_within_max_retries():
    """A worker whose fn raises re-runs the SAME item up to max_retries
    times: every item arrives once, in order, and the retries count; past
    the budget the pipeline aborts."""
    failed = set()
    out = []

    def flaky(x):
        if x % 4 == 1 and x not in failed:
            failed.add(x)
            raise RuntimeError(f"transient {x}")
        return x

    run = StagedPipeline([
        Stage("flaky", flaky, max_retries=1),
        Stage("sink", lambda x: (out.append(x), None)[1]),
    ]).run(range(20))
    assert out == list(range(20))
    assert run.stage("flaky").retries == 5
    assert run.summary()["stages"]["flaky"]["retries"] == 5

    def always(x):
        raise RuntimeError("persistent")

    with pytest.raises(PipelineError) as ei:
        StagedPipeline([Stage("always", always, max_retries=2)]).run(
            range(3))
    assert ei.value.stage == "always"


# --- schedule resolution ---------------------------------------------------

@pytest.mark.parametrize("mode,cores,capable,want", [
    ("off", 8, True, "serial"),
    ("on", 1, True, "pipelined"),
    ("differential", 8, True, "differential"),
    ("auto", 1, True, "serial"),
    ("auto", 8, True, "serial"),
    ("on", 8, False, "serial"),
])
def test_resolve_schedule(monkeypatch, mode, cores, capable, want):
    monkeypatch.setattr(P, "effective_cpu_count", lambda: cores)
    assert P.resolve_schedule(mode, capable) == want


def test_resolve_schedule_unknown_mode_raises():
    with pytest.raises(ValueError, match="sideways"):
        P.resolve_schedule("sideways", True)


# --- the library audit ------------------------------------------------------

@pytest.fixture(scope="module")
def objects():
    return make_cluster_objects(N_OBJECTS, seed=11)


@pytest.fixture(scope="module")
def jax_runs():
    """(JAX collect lane, exact) -> summary of the JAX pipelined audit."""
    return {}


def _summary(run):
    kept = {key: [(v.kind, v.name, v.namespace, v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept


def _jax_run(objects, collect, exact):
    cel = JCELDriver()
    driver = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    jload(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = ShardedEvaluator(driver, make_mesh(1), violations_limit=20,
                          collect=collect)
    cfg = JConfig(chunk_size=CHUNK, exact_totals=exact, pipeline="on")
    mgr = JManager(client, lambda: iter(objects), cfg, evaluator=ev)
    run = mgr.audit()
    assert mgr.perf["pipelined"] == 1.0
    return run


def _port(objects, collect="reduced", exact=False, flatten_lane="auto",
          flatten_workers=0, lister_objects=None, **cfg):
    """(manager, evaluator) of the port over the library on the CPU."""
    cel = TCELDriver()
    driver = TorchDriver(cel_driver=cel, device="cpu")
    client = TClient(target=TTarget(), drivers=[driver, cel],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    tload(client)
    for o in objects:
        if o["kind"] == "Ingress":
            client.add_data(o)
    ev = SweepEvaluator(driver, device="cpu", violations_limit=20,
                        collect=collect, flatten_lane=flatten_lane,
                        flatten_workers=flatten_workers)
    listed = objects if lister_objects is None else lister_objects
    mgr = TManager(client, lambda: iter(listed),
                   TConfig(chunk_size=CHUNK, exact_totals=exact, **cfg),
                   evaluator=ev)
    return mgr, ev


@pytest.mark.parametrize("collect,exact", [
    ("reduced", False), ("masks", False), ("reduced", True),
    ("masks", True)])
def test_pipelined_relist_matches_serial_and_jax(objects, jax_runs, collect,
                                                 exact):
    objs = objects[:N_EXACT] if exact else objects
    # exact totals do not depend on the JAX collect lane (the JAX
    # package's own tests hold its lanes equal): both port lanes are held
    # against the JAX masks lane's run
    jkey = ("masks" if exact else collect, exact)
    if jkey not in jax_runs:
        jax_runs[jkey] = _summary(_jax_run(objs, *jkey))
    mgr_s, _ = _port(objs, collect, exact, pipeline="off")
    serial = _summary(mgr_s.audit())
    assert mgr_s.perf["pipelined"] == 0.0 and mgr_s.pipe_stats is None
    mgr_p, _ = _port(objs, collect, exact, pipeline="on",
                     pipeline_flatten_workers=2)
    piped = _summary(mgr_p.audit())
    assert mgr_p.perf["pipelined"] == 1.0
    assert "degraded_to_serial" not in mgr_p.perf
    stats = mgr_p.pipe_stats
    assert set(stats["stages"]) == {"flatten", "dispatch", "collect",
                                    "fold_render"}
    assert stats["stages"]["flatten"]["workers"] == 2
    assert 0.0 <= stats["device_idle_fraction"] <= 1.0
    assert stats["device_wait_s"] >= 0.0
    assert mgr_p.perf["pipe_wall"] > 0 and mgr_p.perf["pipe_stage_busy_sum"]
    assert piped == serial
    assert piped == jax_runs[jkey]
    assert sum(serial[1].values()) > 0 and serial[0] == len(objs)


def test_raw_lister_with_flatten_workers(objects):
    """RawJSON objects through the raw lane and two worker processes,
    pipelined, equal the dict lister's serial run; every chunk took the
    raw lane, and every chunk big enough to split took the workers."""
    mgr_s, _ = _port(objects, pipeline="off")
    want = _summary(mgr_s.audit())
    raws = [as_raw(o) for o in objects]
    try:
        mgr, ev = _port(objects, flatten_lane="raw", flatten_workers=2,
                        lister_objects=raws, pipeline="on")
        run = mgr.audit()
    finally:
        tflatten.shutdown_flatten_pools()
    assert _summary(run) == want
    assert run.flatten_workers == 2
    lanes = {k.split("/", 1)[1]: v for k, v in ev.perf.items()
             if k.startswith("flatten_chunks/")}
    assert set(lanes) <= {"raw", "raw+workers"}, lanes
    assert lanes["raw+workers"] == ev.perf["flatten_fanout_chunks"] > 0
    assert ev.perf.get("fl_worker_fallbacks", 0) == 0
    assert ev.perf["fl_c_columnize"] > 0


def test_differential_schedule_sets_ok(objects):
    mgr, _ = _port(objects[:600], pipeline="differential")
    mgr_s, _ = _port(objects[:600], pipeline="off")
    assert _summary(mgr.audit()) == _summary(mgr_s.audit())
    assert mgr.perf["pipeline_differential_ok"] == 1.0


def test_failing_fold_stage_degrades_to_serial(objects):
    """A fold_render stage that raises (it has no retry budget) aborts
    the pipeline; the pass reruns on the serial schedule with the same
    output."""
    objs = objects[:600]
    mgr_s, _ = _port(objs, pipeline="off")
    want = _summary(mgr_s.audit())
    mgr, _ = _port(objs, pipeline="on")
    fold = mgr._process_swept

    def failing_on_stage_threads(*args, **kw):
        if threading.current_thread().name.startswith("pipe-fold_render"):
            raise RuntimeError("fold stage failure")
        return fold(*args, **kw)

    mgr._process_swept = failing_on_stage_threads
    assert _summary(mgr.audit()) == want
    assert mgr.perf["degraded_to_serial"] == 1.0
    assert mgr.perf["pipelined"] == 0.0 and mgr.pipe_stats is None


def test_packed_upload_equals_per_column_upload(objects):
    """The relist's columns cross as one buffer per dtype; the views the
    programs read equal the per-column upload, dtype narrowing included."""
    mgr, ev = _port(objects[:300])
    cons = [c for c in mgr._audit_constraints()]
    pods = [o for o in objects if o["kind"] == "Pod"][:200]
    flat = ev.sweep_flatten(cons, pods)
    keep: list = []
    ev.perf_reset()
    got = ev._upload_cols(flat.cols, flat.pad_n, keep)
    n_dtypes = len({np.asarray(a).dtype.str for v in flat.cols.values()
                    for a in (v.values() if isinstance(v, dict) else [v])})
    assert ev.perf["h2d_copies"] == ev.perf["h2d_col_buffers"] == n_dtypes
    assert len(keep) == n_dtypes and n_dtypes >= 3
    assert set(got) == set(flat.cols)
    for key, val in flat.cols.items():
        vals = val if isinstance(val, dict) else {None: val}
        outs = got[key] if isinstance(val, dict) else {None: got[key]}
        for sub, a in vals.items():
            want = to_tensor(a, "cpu")
            assert outs[sub].dtype == want.dtype, (key, sub)
            assert outs[sub].shape == want.shape, (key, sub)
            assert bool((outs[sub] == want).all()), (key, sub)


class _YieldingDict(dict):
    """A vocab ``_to_id`` that sleeps inside every insert, between an
    intern's choice of the new id and its append: without the vocab's
    lock another thread's intern lands in that gap."""

    def __setitem__(self, key, value):
        time.sleep(0.0002)
        super().__setitem__(key, value)


def test_vocab_stays_a_bijection_under_two_flatten_threads():
    """Two flatten threads (the Python columnizer, which interns through
    ``Vocab.intern``) and the dispatch thread (parameter tables) intern
    into one vocab, with a thread switch forced inside every insert: the
    pipelined pass arms the vocab's lock, so every string keeps exactly
    one id, and the verdicts equal a serial run's."""
    objs = make_cluster_objects(600, seed=17)
    for i, o in enumerate(objs):  # a new string in every object
        o["metadata"]["name"] = f"{o['metadata']['name']}-{i}"
    mgr_s, _ = _port(objs, pipeline="off")
    want = _summary(mgr_s.audit())
    mgr, ev = _port(objs, flatten_lane="py", pipeline="on",
                    pipeline_flatten_workers=2)
    mgr.config.chunk_size = 64
    vocab = ev.driver.vocab
    vocab._to_id = _YieldingDict(vocab._to_id)
    got = _summary(mgr.audit())
    assert vocab._lock is not None
    assert len(set(vocab._to_str)) == len(vocab._to_str) \
        == len(vocab._to_id)
    assert all(vocab._to_id[s] == i for i, s in enumerate(vocab._to_str))
    assert {o["metadata"]["name"] for o in objs} <= set(vocab._to_str)
    assert got == want


def test_native_module_loads_once_under_concurrent_first_use(monkeypatch):
    """The pipeline's flatten threads reach the native columnizer's first
    load together: every one of them gets the module (none takes the
    Python flattener for its batch), and it builds once."""
    from gatekeeper_tpu_torch.ops import native

    monkeypatch.setattr(native, "_mods", {})
    monkeypatch.setattr(native, "_tried", set())
    built = []

    def slow_build(name, src_file):
        time.sleep(0.2)
        built.append(name)
        return ("module", name)

    monkeypatch.setattr(native, "_build", slow_build)
    barrier = threading.Barrier(4)
    got = []

    def first_use():
        barrier.wait()
        got.append(native.load())

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got == [("module", "gtpu_flatten")] * 4
    assert built == ["gtpu_flatten"]


def test_flatten_worker_never_touches_torch():
    """The forked worker runs only the C columnizer: its main loop and
    the modules it reaches (ops/native.py, ops/flatten.py) reference no
    torch."""
    src = inspect.getsource(tflatten._flatten_worker_main)
    assert "torch." not in src.replace("gatekeeper_tpu_torch.", "")
    from gatekeeper_tpu_torch.ops import native

    for mod in (native, tflatten):
        tree = ast.parse(inspect.getsource(mod))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "torch"
                           for a in node.names), mod.__name__
            elif isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != "torch", \
                    mod.__name__


# --- the mutation lane's ingest ---------------------------------------------

def _assign(name, location, value, extra=None, kinds=("Pod",)):
    params = {"assign": {"value": value}}
    params.update(extra or {})
    return {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
            "metadata": {"name": name},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": list(kinds)}],
                     "location": location, "parameters": params}}


MUTATORS = [
    _assign("pull-policy", "spec.containers[name: *].imagePullPolicy",
            "Always"),
    _assign("host-network", "spec.hostNetwork", False),
    _assign("priority", "spec.priority", 100),
    {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
     "kind": "AssignMetadata", "metadata": {"name": "owner-label"},
     "spec": {"location": "metadata.labels.owner",
              "parameters": {"assign": {"value": "platform-team"}}}},
    _assign("dns-policy-cond", "spec.dnsPolicy", "ClusterFirst",
            extra={"assignIf": {"in": ["Default"]}}),
]


def _outcome(o):
    return (o.changed, o.patch, o.error, o.obj, o.lane, o.iterations)


@pytest.mark.parametrize("ingest", ["raw", "differential"])
def test_mutation_lane_ingest_matches_dict_and_jax(ingest):
    js, ts = JSystem(), TSystem()
    for m in MUTATORS:
        js.upsert_unstructured(copy.deepcopy(m))
        ts.upsert_unstructured(copy.deepcopy(m))
    objs = make_cluster_objects(300, seed=29)
    objs.append({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "weird"},
                 "spec": {"containers": "notalist"}})
    lane = MutationLane(ts, device="cpu", ingest=ingest)
    got = [_outcome(o) for o in lane.mutate_objects(
        copy.deepcopy(objs), want_objects=True)]
    want_dict = [_outcome(o) for o in MutationLane(ts, device="cpu")
                 .mutate_objects(copy.deepcopy(objs), want_objects=True)]
    want_jax = [_outcome(o) for o in JLane(js, ingest=ingest)
                .mutate_objects(copy.deepcopy(objs), want_objects=True)]
    assert got == want_dict == want_jax
    assert {"device", "host"} <= {o[4] for o in got}
    assert lane.compiled().prefilter.flatten_lane == (
        "differential" if ingest == "differential" else "auto")
    burst = lane._ingest_objects(objs[:3])
    assert all(isinstance(o, RawJSON) for o in burst)


def test_mutation_lane_ingest_fallback_and_unknown():
    ts = TSystem()
    lane = MutationLane(ts, device="cpu", ingest="raw")
    unserializable = [{"kind": "Pod", "x": {1, 2}}]
    assert lane._ingest_objects(unserializable) is unserializable
    with pytest.raises(ValueError, match="ingest"):
        MutationLane(ts, device="cpu", ingest="bytes")


# --- the CLI -------------------------------------------------------------------

def _manifest_dir(tmp_path):
    lib = os.path.join(ROOT, "library", "general")
    i = 0
    for name in ("requiredlabels", "allowedrepos", "containerlimits"):
        for f in ("template.yaml", "samples/constraint.yaml",
                  "samples/example_allowed.yaml",
                  "samples/example_disallowed.yaml"):
            with open(os.path.join(lib, name, f)) as fh:
                (tmp_path / f"{i:02d}.yaml").write_text(fh.read())
            i += 1
    return tmp_path


def test_cli_pipeline_and_raw_lane_match_jax_cli(tmp_path):
    """``--pipeline on --flatten-lane raw --flatten-workers 2`` and
    ``--pipeline off`` print the JAX CLI's kept lines; stderr names the
    schedule and the core count."""
    _manifest_dir(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for label, pkg, extra in (
            ("jax", "gatekeeper_tpu", []),
            ("on", "gatekeeper_tpu_torch",
             ["--device", "cpu", "--pipeline", "on", "--flatten-lane",
              "raw", "--flatten-workers", "2", "--audit-chunk-size", "4"]),
            ("off", "gatekeeper_tpu_torch",
             ["--device", "cpu", "--pipeline", "off"])):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--manifests", str(tmp_path),
             "--once", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        runs[label] = p
    assert runs["on"].stdout == runs["off"].stdout == runs["jax"].stdout
    assert runs["on"].stdout.count("\n") >= 3
    assert re.search(r"audit schedule: pipelined \(--pipeline on, \d+ "
                     r"effective cores\)", runs["on"].stderr)
    assert "audit schedule: serial (--pipeline off" in runs["off"].stderr
    assert "flatten_workers=2" in runs["on"].stderr


@pytest.mark.parametrize("extra,want", [
    ([], "audit schedule: serial (--pipeline auto"),
    (["--pipeline", "on", "--audit-source", "snapshot"],
     "audit schedule: serial (--pipeline on"),
])
def test_cli_schedule_line_names_the_schedule_that_runs(tmp_path, extra,
                                                         want):
    """The default ``auto`` resolves to serial on any core count, and the
    snapshot source evaluates serially whatever ``--pipeline`` says: the
    stderr line names the schedule that runs."""
    _manifest_dir(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(tmp_path), "--once", "--device", "cpu", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert want in p.stderr
    assert p.stdout.count("\n") >= 3
