"""``gator replay`` and its core (``gatekeeper_tpu_torch/replay/core.py``)
against the JAX package's, on the CPU.

- A corpus of 90 admissions over a 5-template library slice, captured
  through the port's ``ValidationHandler`` with a capture-mode
  ``FlightRecorder``, and the same bodies through the JAX package's: the
  two sinks hold the same decisions.
- ``read_corpus`` skips and counts the same lines (a torn tail too).
- An identical candidate replays with 0 divergences, bit-identical, and
  with the serving pass's compile cache warm, 0 fresh lowerings.
- A candidate without one deny-firing constraint attributes every
  ``newly_allowed`` divergence to it, in both packages alike.
- Spill replay: each package spills the same objects through its own
  snapshot; the reports' ``by_constraint``, ``divergences``, ``rows`` and
  ``errors`` are equal, and the port's ``SnapshotSpill.load`` keeps the
  two-way vocab prefix rule.
- The CLI's exit codes; the ``REPLAY_*`` metrics and the ``replay.*``
  spans.
- The deliberate differences (ROADMAP queue 3): the spill header's
  versions, and a delta spill, which the port reassembles."""

import contextlib
import copy
import importlib.util
import io
import json
import os
import shutil

import pytest

from gatekeeper_tpu.replay import core as jcore
from gatekeeper_tpu_torch.gator import cli as tcli
from gatekeeper_tpu_torch.gator import reader
from gatekeeper_tpu_torch.metrics import registry as M
from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry
from gatekeeper_tpu_torch.replay import core as tcore
from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects
from gatekeeper_tpu_torch.utils.unstructured import name_of
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
RECORD_KEYS = ("endpoint", "decision", "uid", "kind", "namespace", "name",
               "message", "code", "request")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stop(runtime) -> None:
    gc = getattr(runtime.driver, "gen_coord", None)
    if gc is not None:
        gc.stop()


def port_serve_and_record(docs, bodies, sink, cache_dir) -> int:
    """The JAX replay bench's serving pass on the port: a
    ``ValidationHandler`` over ``TorchDriver(device="cpu")`` with the
    compile cache, a capture-mode flight recorder; returns the denies."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.generation import CompileCache
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.observability import flightrec
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    cel = CELDriver()
    driver = TorchDriver(device="cpu", cel_driver=cel,
                         compile_cache=CompileCache(cache_dir))
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    for doc in docs:
        if reader.is_template(doc):
            client.add_template(doc)
    for doc in docs:
        if reader.is_constraint(doc):
            client.add_constraint(doc)
    handler = ValidationHandler(client)
    rec = flightrec.FlightRecorder(capacity=64, sink_path=sink,
                                   capture=True)
    denies = 0
    with flightrec.activate(rec):
        for body in bodies:
            denies += 0 if handler.handle(body).allowed else 1
    rec.close()
    return denies


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX replay bench's corpus (90 bodies, 5 library templates),
    recorded once by each package, each with its own warm compile
    cache."""
    bench = _load_tool("bench_replay")
    docs = bench._library_docs()
    bodies = bench._admission_bodies(90)
    out = {"docs": docs}
    for pkg in ("jax", "port"):
        cache = str(tmp_path_factory.mktemp(f"{pkg}-cc"))
        sink = os.path.join(str(tmp_path_factory.mktemp(f"{pkg}-sink")),
                            "decisions.jsonl")
        if pkg == "jax":
            served = bench._serve_and_record(copy.deepcopy(docs),
                                             copy.deepcopy(bodies), sink,
                                             cache)["denies"]
            records, counts = jcore.read_corpus(sink)
        else:
            served = port_serve_and_record(copy.deepcopy(docs),
                                           copy.deepcopy(bodies), sink,
                                           cache)
            records, counts = tcore.read_corpus(sink)
        out[pkg] = {"cache": cache, "sink": sink, "denies": served,
                    "records": records, "counts": counts}
    return out


def _dropped(records) -> str:
    denied = set()
    for r in records:
        if r["decision"] == "deny":
            denied |= tcore.recorded_constraints(r.get("message", ""))
    assert denied
    return sorted(denied)[0]


def _replay(core, docs, records, cache, **kw):
    extra = {"device": "cpu"} if core is tcore else {}
    runtime = core.load_candidate(copy.deepcopy(docs),
                                  compile_cache_dir=cache,
                                  metrics=kw.pop("load_metrics", None),
                                  **extra)
    try:
        return core.replay_decisions(records, runtime, **kw)
    finally:
        _stop(runtime)


def test_corpus_captured_like_jax(corpus):
    j, t = corpus["jax"], corpus["port"]
    assert t["counts"] == j["counts"] == {"lines": 90, "replayed": 90}
    assert t["denies"] == j["denies"] > 0
    assert [{k: r.get(k) for k in RECORD_KEYS} for r in t["records"]] == \
        [{k: r.get(k) for k in RECORD_KEYS} for r in j["records"]]


def test_read_corpus_skip_and_count_matches_jax(tmp_path, corpus):
    good = {"endpoint": "validate", "decision": "allow", "uid": "g",
            "request": {"uid": "g"}}
    deny = {"endpoint": "validate", "decision": "deny", "uid": "d",
            "message": "[some-con] no", "request": {"uid": "d"}}
    path = tmp_path / "sink.jsonl"
    path.write_text(
        json.dumps(good) + "\n" + "{half a line\n" + "42\n"
        + json.dumps({"endpoint": "audit", "decision": "allow",
                      "request": {}}) + "\n"
        + json.dumps({"endpoint": "validate", "decision": "shed",
                      "request": {}}) + "\n"
        + json.dumps({"endpoint": "validate", "decision": "deny"}) + "\n"
        + json.dumps(deny) + "\n"
        + '{"endpoint": "validate", "deci')
    got = tcore.read_corpus(str(path))
    assert got == jcore.read_corpus(str(path))
    assert got[1] == {"lines": 8, "replayed": 2, "malformed": 2,
                      "endpoint": 1, "unreplayable_decision": 1,
                      "no_body": 1, "truncated_tail": 1}
    sink = corpus["port"]["sink"]
    assert tcore.read_corpus(sink, limit=10) == \
        jcore.read_corpus(sink, limit=10)


def test_identical_candidate_bit_identical_zero_lowerings(corpus):
    j, t = corpus["jax"], corpus["port"]
    metrics = MetricsRegistry()
    got = _replay(tcore, corpus["docs"], t["records"], t["cache"],
                  differential=True, metrics=metrics, skipped=t["counts"],
                  load_metrics=metrics)
    want = _replay(jcore, corpus["docs"], j["records"], j["cache"],
                   differential=True, skipped=j["counts"])
    same = ("records", "skipped", "recorded", "candidate", "newly_denied",
            "newly_allowed", "message_changed", "errors", "by_constraint",
            "divergences", "divergences_total", "top_offenders",
            "differential", "lowering")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["differential"]["bit_identical"]
    assert got["divergences_total"] == 0 and got["records"] == 90
    cc = got["compile_cache"]
    assert cc["misses"] == 0 and cc["hits"] == 5
    assert metrics.get_counter(M.REPLAY_RECORDS,
                               {"outcome": "replayed"}) == 90
    assert metrics.counter_total(M.REPLAY_DIVERGENCE) == 0
    assert metrics.get_gauge(M.REPLAY_SECONDS) is not None


def test_modified_candidate_attributes_newly_allowed(corpus):
    j, t = corpus["jax"], corpus["port"]
    drop = _dropped(t["records"])
    assert drop == _dropped(j["records"])
    docs = [d for d in corpus["docs"]
            if not (reader.is_constraint(d) and name_of(d) == drop)]
    metrics = MetricsRegistry()
    got = _replay(tcore, docs, t["records"], t["cache"], metrics=metrics)
    want = _replay(jcore, docs, j["records"], j["cache"])
    same = ("newly_denied", "newly_allowed", "by_constraint", "divergences",
            "divergences_total", "top_offenders", "candidate")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["newly_allowed"] > 0 and got["newly_denied"] == 0
    assert got["by_constraint"][drop]["newly_allowed"] > 0
    assert all(d["kind"] == "newly_allowed"
               and drop in d["constraints_removed"]
               for d in got["divergences"])
    assert metrics.get_counter(M.REPLAY_DIVERGENCE,
                               {"kind": "newly_allowed"}) == \
        got["newly_allowed"]


def test_replay_opens_its_spans(corpus):
    from gatekeeper_tpu_torch.observability import tracing

    t = corpus["port"]
    tracer = tracing.Tracer(seed=0)
    with tracing.activate(tracer):
        _replay(tcore, corpus["docs"], t["records"][:20], t["cache"],
                chunk=8)
    names = [s["name"] for tr in tracer.traces() for s in tr["spans"]]
    assert names.count("replay.run") == 1
    assert names.count("replay.chunk") == 3


# --- the CLI ------------------------------------------------------------------

def _docs_file(tmp_path, docs, name="candidate.json"):
    p = tmp_path / name
    p.write_text(json.dumps(docs, default=str))
    return str(p)


def run(argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(["--device", "cpu", "replay", *argv])
    return rc, out.getvalue(), err.getvalue()


def test_replay_cli_exit_codes(corpus, tmp_path):
    t = corpus["port"]
    cand = _docs_file(tmp_path, corpus["docs"])
    rc, out, _ = run(["-f", t["sink"], "--candidate", cand,
                      "--differential", "--compile-cache", t["cache"],
                      "-o", "json"])
    report = json.loads(out)
    assert rc == 0 and report["differential"]["bit_identical"]
    assert report["compile_cache"]["misses"] == 0
    drop = _dropped(t["records"])
    lacking = _docs_file(tmp_path, [
        d for d in corpus["docs"]
        if not (reader.is_constraint(d) and name_of(d) == drop)], "l.json")
    rc, out, _ = run(["-f", t["sink"], "--candidate", lacking,
                      "--differential", "--compile-cache", t["cache"]])
    assert rc == 1 and "MISMATCHES" in out and drop in out
    assert run(["--candidate", cand])[0] == 2
    assert run(["-f", t["sink"], "--from-spill", "x",
                "--candidate", cand])[0] == 2
    assert run(["-f", t["sink"]])[0] == 2
    assert run(["-f", t["sink"], "--candidate",
                str(tmp_path / "nope.yaml")])[0] == 1
    assert run(["-f", t["sink"], "--candidate",
                _docs_file(tmp_path, [], "empty.json")])[0] == 1


# --- spill-at-rv replay -------------------------------------------------------

def _spill(pkg: str, docs, root: str, delta: bool = False) -> dict:
    """One package's snapshot audit of 60 synthetic objects, spilled."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    core = mod("replay.core")
    snapshot = mod("snapshot")
    manager = mod("audit.manager")
    if pkg == "gatekeeper_tpu":
        sharded = mod("parallel.sharded")
        runtime = core.load_candidate(copy.deepcopy(docs))
        evaluator = sharded.ShardedEvaluator(
            runtime.driver, sharded.make_mesh(), violations_limit=20)
    else:
        runtime = core.load_candidate(copy.deepcopy(docs), device="cpu")
        evaluator = mod("parallel.sweep").SweepEvaluator(
            runtime.driver, device="cpu", violations_limit=20)
    cluster = mod("sync.source").FakeCluster()
    for o in make_cluster_objects(60, seed=23):
        cluster.apply(copy.deepcopy(o))
    snap = snapshot.ClusterSnapshot(evaluator, snapshot.SnapshotConfig())
    mgr = manager.AuditManager(
        runtime.client, lister=lambda: iter(cluster.list()),
        config=manager.AuditConfig(audit_source="snapshot", chunk_size=64,
                                   exact_totals=False, pipeline="off"),
        evaluator=evaluator, snapshot=snap)
    mgr.audit()
    tdig = snapshot.templates_digest(runtime.client)
    wrote = snapshot.SnapshotSpill(root, delta=delta).save(
        snap, templates=tdig)
    assert wrote["ok"] and wrote["rows"] == 60
    _stop(runtime)
    return {"root": root, "tdig": tdig}


@pytest.fixture(scope="module")
def spilled(corpus, tmp_path_factory):
    return {pkg: _spill(name, corpus["docs"],
                        str(tmp_path_factory.mktemp(f"{pkg}-spill")))
            for pkg, name in (("jax", "gatekeeper_tpu"),
                              ("port", "gatekeeper_tpu_torch"))}


SPILL_SAME = ("rows", "recorded_constraints", "candidate_constraints",
              "errors", "by_constraint", "divergences", "divergences_total",
              "top_offenders")


@pytest.mark.parametrize("modified", [False, True])
def test_spill_replay_matches_jax(corpus, spilled, modified):
    jspill = jcore.read_spill(spilled["jax"]["root"])
    tspill = tcore.read_spill(spilled["port"]["root"])
    assert tspill["rows"] == jspill["rows"] == 60
    assert tspill["objects"] == jspill["objects"]
    assert tspill["verdicts"] == jspill["verdicts"] != {}
    docs = corpus["docs"]
    if modified:
        drop = sorted(n for n, rows in tspill["verdicts"].items()
                      if rows)[0]
        docs = [d for d in docs
                if not (reader.is_constraint(d) and name_of(d) == drop)]
    reports = {}
    for pkg, core, spill in (("jax", jcore, jspill),
                             ("port", tcore, tspill)):
        extra = {"device": "cpu"} if core is tcore else {}
        runtime = core.load_candidate(
            copy.deepcopy(docs), compile_cache_dir=corpus[pkg]["cache"],
            **extra)
        try:
            reports[pkg] = core.replay_spill(spill, runtime,
                                             differential=not modified)
        finally:
            _stop(runtime)
    got, want = reports["port"], reports["jax"]
    assert {k: got[k] for k in SPILL_SAME} == {k: want[k] for k in SPILL_SAME}
    if modified:
        per = got["by_constraint"][drop]
        assert per == {"newly_violating": 0,
                       "newly_clean": len(tspill["verdicts"][drop])}
    else:
        assert got["differential"] == want["differential"]
        assert got["differential"]["bit_identical"]
        assert got["divergences_total"] == 0
        assert got["compile_cache"]["misses"] == 0


def test_replay_cli_from_spill(corpus, spilled, tmp_path):
    cand = _docs_file(tmp_path, corpus["docs"])
    rc, out, _ = run(["--from-spill", spilled["port"]["root"],
                      "--candidate", cand, "--differential",
                      "--compile-cache", corpus["port"]["cache"], "-o",
                      "json"])
    report = json.loads(out)
    assert rc == 0 and report["source"] == "spill" and report["rows"] == 60
    assert report["differential"]["bit_identical"]


def test_read_spill_rejects_a_corrupt_section(spilled, tmp_path):
    d = str(tmp_path / "spill-copy")
    shutil.copytree(spilled["port"]["root"], d)
    rows_p = os.path.join(d, "snapshot.rows.pkl")
    with open(rows_p, "r+b") as f:
        f.seek(os.path.getsize(rows_p) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    for core in (tcore, jcore):
        with pytest.raises(ValueError, match="sha256"):
            core.read_spill(d)


def test_spill_vocab_two_way_prefix_rule(corpus, spilled):
    """The port's ``SnapshotSpill.load`` vocab gate, as the JAX test of
    the same name holds the JAX one: the boot vocab a prefix of the
    spill's replays the tail; the spill's a prefix of a grown vocab is a
    hit with nothing to replay; a diverged overlap is a counted miss that
    keeps the spill."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               SnapshotConfig,
                                               SnapshotSpill)
    from gatekeeper_tpu_torch.snapshot.persist import MISS_VOCAB

    root = spilled["port"]["root"]
    tdig = spilled["port"]["tdig"]
    runtime = tcore.load_candidate(
        copy.deepcopy(corpus["docs"]),
        compile_cache_dir=corpus["port"]["cache"], device="cpu")
    try:
        ev = SweepEvaluator(runtime.driver, device="cpu",
                            violations_limit=20)
        cons = [c for c in runtime.client.constraints()
                if c.actions_for(AUDIT_EP)]
        vocab = runtime.driver.vocab
        assert SnapshotSpill(root).load(
            ClusterSnapshot(ev, SnapshotConfig()), cons,
            templates=tdig) is not None
        spilled_len = len(vocab._to_str)
        for i in range(5):
            vocab.intern(f"sibling-churn-{i}")
        sp = SnapshotSpill(root)
        assert sp.load(ClusterSnapshot(ev, SnapshotConfig()), cons,
                       templates=tdig) is not None
        assert sp.miss_reasons == {}
        assert len(vocab._to_str) == spilled_len + 5
        vocab._to_str[spilled_len - 1] = "conflicting-intern"
        snap_c = ClusterSnapshot(ev, SnapshotConfig())
        sp2 = SnapshotSpill(root)
        assert sp2.load(snap_c, cons, templates=tdig) is None
        assert sp2.miss_reasons == {MISS_VOCAB: 1}
        assert snap_c.stale
        assert os.path.exists(os.path.join(root, "snapshot.json"))
    finally:
        _stop(runtime)


# --- deliberate differences (ROADMAP queue 3) -----------------------------------

def test_spill_header_records_torch_and_cuda_not_jax(spilled):
    import torch

    theader = tcore.read_spill(spilled["port"]["root"])["header"]
    jheader = jcore.read_spill(spilled["jax"]["root"])["header"]
    assert theader["torch"] == torch.__version__
    assert theader["cuda"] == str(torch.version.cuda)
    assert "jax" not in theader and "jaxlib" not in theader
    assert "jax" in jheader and "torch" not in jheader
    same = set(theader) & set(jheader)
    assert {"format", "flatten_schema_version", "rows", "sections"} <= same


def test_delta_spill_replays_in_the_port_only(corpus, tmp_path):
    """A delta spill's rows section lists its groups' own sections: the
    port's ``read_spill`` reassembles them (as ``SnapshotSpill.load``
    does); the JAX one reads no group and finds no object."""
    t = _spill("gatekeeper_tpu_torch", corpus["docs"],
               str(tmp_path / "port"), delta=True)
    j = _spill("gatekeeper_tpu", corpus["docs"], str(tmp_path / "jax"),
               delta=True)
    got = tcore.read_spill(t["root"])
    assert got["rows"] == 60 and len(got["objects"]) == 60
    assert got["objects"] == tcore.read_spill(
        _spill("gatekeeper_tpu_torch", corpus["docs"],
               str(tmp_path / "full"))["root"])["objects"]
    assert jcore.read_spill(j["root"])["objects"] == []
