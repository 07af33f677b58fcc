"""The harness finds every cell's configuration, traffic mix, driver, audit
source and per-layer readers by name, and ``BENCHMARK.json`` keeps to the
shape the harness and its contract expect."""

import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from harness import core  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = core.benchmark_spec(ROOT)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    cells = len(SPEC["workloads"])
    # a full check of 24 cells must fit its 43,200 s
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert cells <= 24


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_by_name(cell):
    c, _entry, config, mix = core.find_cell(SPEC, cell["name"])
    assert c is cell and cell["chips"] == 1
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert 1 <= len(cell["why"]) <= 200
    driver = core.plugin("drivers", mix["driver"])
    assert all(callable(getattr(driver, f)) for f in ("run", "check",
                                                      "control"))
    if "source" in mix:
        assert callable(core.plugin("sources", mix["source"]).build)
    assert config["library_digest"] == core.library_digest(
        os.path.join(ROOT, config["library"]))
    for key in ("source", "guarantees", "assumed", "control"):
        assert config[key], key
    assert isinstance(config["reduced"], list)
    reported = {m["name"] for m in core.cell_metrics(SPEC, cell["name"],
                                                     "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    layer = core.cell_metrics(SPEC, cell["name"], "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert 1 <= len(entry["source"]) <= 200 and "\n" not in entry["source"]
    assert all(NAME.match(k) for k in entry["reduced"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert callable(core.metric_reader(metric["name"]))
        assert metric["name"].endswith("_roofline") == (metric["unit"]
                                                        == "%")


def test_unknown_names_fail_loudly():
    with pytest.raises(core.BenchError):
        core.find_cell(SPEC, "no-such-cell")
    with pytest.raises(core.BenchError):
        core.metric_reader("no_such_metric")
    for folder in ("drivers", "sources"):
        with pytest.raises(core.BenchError):
            core.plugin(folder, "no_such_name")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_the_check_groups_cover_every_constraint_once(entry):
    sys.path.insert(0, os.path.join(BENCH, "reference"))
    from reference import check

    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    groups = config["check"]["groups"]
    keys = check.all_keys(os.path.join(ROOT, config["library"]))
    named = config["check"]["always"] + [k for g in groups for k in g]
    assert sorted(named) == keys  # each once
    seen = set()
    for seed in range(len(groups)):
        seen |= set(check.checked_keys(os.path.join(ROOT, config["library"]),
                                       config["check"], seed + 3 * 10**9))
    assert sorted(seen) == keys


def test_a_changed_library_changes_the_digest(tmp_path):
    import shutil

    lib = tmp_path / "library"
    shutil.copytree(os.path.join(ROOT, "library"), lib)
    before = core.library_digest(str(lib))
    path = lib / "general" / "requiredlabels" / "template.yaml"
    path.write_text(path.read_text() + "\n# edited\n")
    assert core.library_digest(str(lib)) != before
