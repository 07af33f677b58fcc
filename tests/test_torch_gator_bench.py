"""``gator bench`` in the port against the JAX package's, on the CPU: the
fields that are not timings (``objects``, ``iterations``, ``violations``,
``lowering``, ``pipeline.schedule``) must be equal for

- the ``rego``, ``cel`` and ``tpu`` engines on ``allowedrepos`` and
  ``containerlimitscel`` (``tpu``: ``TorchDriver.query_batch`` in the port);
- the ``sweep`` engine on both collect lanes over the library and
  ``make_cluster_objects(512, seed=0)`` (the audit's defaults: chunks of
  500, exact totals);
- the ``mutate`` engine over the mutation bench's 8 mutators and 256
  objects;

and the ``--output json`` documents must carry the same keys.  The
sweep engine's masks lane on the card is held in
``test_torch_gator_card.py``."""

import contextlib
import copy
import io
import json
import os

import pytest

from gatekeeper_tpu.gator import bench as jbench
from gatekeeper_tpu.gator import reader as jreader
from gatekeeper_tpu.utils.synthetic import make_cluster_objects as jobjects
from gatekeeper_tpu_torch.gator import bench as tbench
from gatekeeper_tpu_torch.gator import cli as tcli
from gatekeeper_tpu_torch.gator import reader as treader
from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LIBRARY = os.path.join(ROOT, "library")
NOT_TIMINGS = ("engine", "objects", "iterations", "violations", "lowering")


def run(main, argv) -> tuple:
    """(exit code, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _fields(r) -> dict:
    d = r.to_dict()
    out = {k: d.get(k) for k in NOT_TIMINGS}
    if d.get("pipeline") is not None:
        out["schedule"] = d["pipeline"]["schedule"]
    return out


def _dir_objs(name: str) -> list:
    return treader.read_sources([os.path.join(LIBRARY, "general", name)])


@pytest.mark.parametrize("engine", ["rego", "cel", "tpu"])
@pytest.mark.parametrize("libdir", ["allowedrepos", "containerlimitscel"])
def test_review_engines_match_jax(engine, libdir):
    objs = _dir_objs(libdir)
    j = jbench.run_bench(copy.deepcopy(objs), engine, 2)
    t = tbench.run_bench(objs, engine, 2, device="cpu")
    assert _fields(t) == _fields(j)
    assert t.objects > 0 and set(t.to_dict()) == set(j.to_dict())
    if engine == "tpu":
        assert t.lowering["lowered"] == 1 and t.violations > 0


@pytest.fixture(scope="module")
def sweep_objs():
    objs = treader.read_sources([LIBRARY]) + make_cluster_objects(512,
                                                                  seed=0)
    assert objs == jreader.read_sources([LIBRARY]) + jobjects(512, seed=0)
    return objs


@pytest.fixture(scope="module")
def jax_sweep(sweep_objs):
    """The JAX sweep engine once, serial (its violations do not depend on
    the collect lane)."""
    return jbench.run_bench(copy.deepcopy(sweep_objs), "sweep", 1,
                            pipeline="off")


@pytest.mark.parametrize("collect", ["reduced", "masks"])
def test_sweep_engine_matches_jax(sweep_objs, jax_sweep, collect):
    t = tbench.run_bench(copy.deepcopy(sweep_objs), "sweep", 1,
                         pipeline="off", collect=collect, device="cpu")
    assert _fields(t) == _fields(jax_sweep)
    assert t.objects == 512 + 152 and t.violations > 8000
    assert t.lowering["lowered"] == 46
    assert set(t.to_dict()) == set(jax_sweep.to_dict())


def test_sweep_engine_schedules(sweep_objs, jax_sweep):
    """``--pipeline on`` runs pipelined with the serial run's totals;
    ``auto`` resolves to serial in the port (ROADMAP queue 3: the stages
    share the interpreter lock), where the JAX package pipelines on a
    host with more than one effective core."""
    objs = sweep_objs[:300] + [o for o in sweep_objs[300:]
                               if treader.is_template(o)
                               or treader.is_constraint(o)]
    on = tbench.run_bench(copy.deepcopy(objs), "sweep", 1, pipeline="on",
                          device="cpu")
    off = tbench.run_bench(copy.deepcopy(objs), "sweep", 1, pipeline="off",
                           device="cpu")
    auto = tbench.run_bench(copy.deepcopy(objs), "sweep", 1, device="cpu")
    assert on.pipeline["schedule"] == "pipelined"
    assert off.pipeline["schedule"] == auto.pipeline["schedule"] == "serial"
    assert on.violations == off.violations == auto.violations > 0
    assert "stages" in on.pipeline


def _assign(name, location, value, extra=None):
    params = {"assign": {"value": value}}
    params.update(extra or {})
    return {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
            "metadata": {"name": name},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Pod"]}],
                     "location": location, "parameters": params}}


def _assign_meta(name, location, value):
    return {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
            "kind": "AssignMetadata", "metadata": {"name": name},
            "spec": {"location": location,
                     "parameters": {"assign": {"value": value}}}}


# the mutation bench's 8 mutators: 6 the prefilter lowers, 2 host-only
MUTATORS = [
    _assign("pull-policy", "spec.containers[name: *].imagePullPolicy",
            "Always"),
    _assign("host-network", "spec.hostNetwork", False),
    _assign("run-as-nonroot", "spec.securityContext.runAsNonRoot", True),
    _assign("priority", "spec.priority", 100),
    _assign_meta("owner-label", "metadata.labels.owner", "platform-team"),
    _assign_meta("audit-ann", "metadata.annotations.audited", "true"),
    {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "ModifySet",
     "metadata": {"name": "topo-keys"},
     "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                           "kinds": ["Service"]}],
              "location": "spec.topologyKeys",
              "parameters": {"operation": "merge",
                             "values": {"fromList": ["zone"]}}}},
    _assign("dns-policy-cond", "spec.dnsPolicy", "ClusterFirst",
            extra={"assignIf": {"in": ["Default"]}}),
]


def test_mutate_engine_matches_jax():
    objs = MUTATORS + make_cluster_objects(256, seed=0)
    j = jbench.run_bench(copy.deepcopy(objs), "mutate", 2)
    t = tbench.run_bench(copy.deepcopy(objs), "mutate", 2, device="cpu")
    timing = ("host_objs_per_sec", "batched_objs_per_sec", "speedup")

    def fields(r):
        out = _fields(r)
        out["lowering"] = {k: v for k, v in r.lowering.items()
                           if k not in timing}
        return out

    assert fields(t) == fields(j)
    assert t.objects == 256 and t.violations > 0
    assert t.lowering["lowered_mutators"] == 6
    assert t.lowering["host_only_mutators"] == 2
    assert set(t.lowering) == set(j.lowering)


def test_mutate_engine_needs_mutators_and_objects():
    for objs in (make_cluster_objects(4, seed=0), MUTATORS):
        with pytest.raises(ValueError):
            tbench.run_bench(copy.deepcopy(objs), "mutate", 1, device="cpu")


def test_cli_json_keys_and_text_match_jax(tmp_path):
    """``--output json`` with ``--attribution``: the same documents (keys,
    and every field that is not a timing), through both CLIs."""
    f = str(tmp_path / "objs.json")
    with open(f, "w") as fh:
        json.dump(_dir_objs("allowedrepos"), fh)
    argv = ["bench", "-f", f, "--engine", "tpu", "-n", "2", "-o", "json",
            "--attribution"]
    from gatekeeper_tpu.gator import cli as jcli

    jrc, jout, _ = run(jcli.main, argv)
    trc, tout, terr = run(tcli.main, ["--device", "cpu", *argv])
    assert trc == jrc == 0
    jdoc, tdoc = json.loads(jout), json.loads(tout)
    assert [set(d) for d in tdoc] == [set(d) for d in jdoc]
    assert {k: tdoc[0][k] for k in NOT_TIMINGS} == \
        {k: jdoc[0][k] for k in NOT_TIMINGS}
    assert set(tdoc[1]["attribution"]) == set(jdoc[1]["attribution"])
    assert "[tpu] spans (top self-time):" in terr
    assert "gator.bench.pass" in terr
    # the text report names the engine and its lowering, as in JAX
    trc, text, _ = run(tcli.main, ["--device", "cpu", "bench", "-f", f,
                                   "--engine", "tpu", "-n", "1"])
    assert trc == 0 and "lowering: 1/1 templates" in text
    trace = str(tmp_path / "trace.json")
    trc, _out, terr = run(tcli.main, ["--device", "cpu", "bench", "-f", f,
                                      "--engine", "cel", "-n", "1",
                                      "--trace", trace])
    assert trc == 0 and f"-> {trace}" in terr
    with open(trace) as fh:
        assert json.load(fh)["traceEvents"]
