"""The arithmetic of the readers of the program's phase clock, on
synthetic ``layer`` dicts: what each divides, and the ``None`` it returns
where its inputs are missing or zero (a program without the phase clock
reads nothing)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import core  # noqa: E402

PER_OBJECT = [("list_route_us_per_object", "list_route"),
              ("snapshot_collect_us_per_object", "snapshot_collect"),
              ("collector_us_per_object", "gc")]


@pytest.mark.parametrize("metric,key", PER_OBJECT)
def test_per_object_readers_divide_the_managers_seconds(metric, key):
    read = core.metric_reader(metric)
    layer = {"objects": 400_000, "mgr_perf": {key: 2.0, "other": 9.0}}
    assert read(layer) == pytest.approx(5.0)


@pytest.mark.parametrize("metric,key", PER_OBJECT)
@pytest.mark.parametrize("layer", [
    {},
    {"objects": 10},
    {"objects": 10, "mgr_perf": {}},
    {"objects": 0, "mgr_perf": "KEY"},
    {"objects": 10, "mgr_perf": "ZERO"},
])
def test_per_object_readers_read_nothing_without_their_counter(metric, key,
                                                                layer):
    layer = dict(layer)
    if layer.get("mgr_perf") == "KEY":
        layer["mgr_perf"] = {key: 1.0}
    elif layer.get("mgr_perf") == "ZERO":
        layer["mgr_perf"] = {key: 0.0}
    assert core.metric_reader(metric)(layer) is None


def test_render_per_hit_divides_seconds_by_renders():
    read = core.metric_reader("render_us_per_hit")
    assert read({"mgr_perf": {"render": 0.5, "n_renders": 2000}}) == \
        pytest.approx(250.0)
    # the window's object count plays no part
    assert read({"objects": 1, "mgr_perf": {"render": 0.5,
                                            "n_renders": 2000}}) == \
        pytest.approx(250.0)


@pytest.mark.parametrize("mperf", [
    {}, {"n_renders": 40}, {"render": 0.2}, {"render": 0.2, "n_renders": 0},
    {"render": 0.0, "n_renders": 40}])
def test_render_per_hit_reads_nothing_without_both(mperf):
    assert core.metric_reader("render_us_per_hit")(
        {"objects": 10, "mgr_perf": mperf}) is None


def _profile(kernels):
    return {"kernels": kernels, "busy_s": 0.01}


def test_launches_per_dispatch_leaves_out_folds_copies_and_sets():
    read = core.metric_reader("grid_launches_per_dispatch")
    kernels = {
        "void at::native::elementwise_kernel<128, 4>": [300, 0.002],
        "void at::native::reduce_kernel<512, 1>": [100, 0.001],
        "void fold_rows<true, 4>(...)": [12, 0.0004],
        "void fold_rows<false, 4>(...)": [4, 0.0001],
        "Memcpy HtoD (Pinned -> Device)": [50, 0.003],
        "Memset (Device)": [8, 0.0001],
    }
    # 24 dispatches over 2 sweeps: 12 a sweep, as in the profiled one
    layer = {"profile": _profile(kernels), "sweeps": 2,
             "perf": {"dispatches": 24.0}}
    assert read(layer) == pytest.approx(400 / 12)


@pytest.mark.parametrize("layer", [
    {},
    {"profile": None, "sweeps": 2, "perf": {"dispatches": 4.0}},
    {"profile": _profile({"k": [3, 0.1]}), "sweeps": 2, "perf": {}},
    {"profile": _profile({"k": [3, 0.1]}), "sweeps": 2,
     "perf": {"dispatches": 0.0}},
    {"profile": _profile({"k": [3, 0.1]}), "sweeps": 0,
     "perf": {"dispatches": 4.0}},
    {"profile": _profile({}), "sweeps": 2, "perf": {"dispatches": 4.0}},
    {"profile": _profile({"fold_rows<true, 4>": [3, 0.1],
                          "Memcpy DtoH": [2, 0.1]}),
     "sweeps": 2, "perf": {"dispatches": 4.0}},
])
def test_launches_per_dispatch_reads_nothing_without_its_inputs(layer):
    assert core.metric_reader("grid_launches_per_dispatch")(layer) is None


def test_every_phase_metric_is_declared_as_the_readers_assume():
    spec = core.benchmark_spec()
    by_name = {m["name"]: m for m in spec["per_layer"]}
    want = {"list_route_us_per_object": ("us/object", "list and route",
                                         "program_counter"),
            "snapshot_collect_us_per_object": (
                "us/object", "audit manager and render", "program_counter"),
            "render_us_per_hit": ("us/render", "audit manager and render",
                                  "program_counter"),
            "collector_us_per_object": ("us/object", "python runtime",
                                        "program_counter"),
            "grid_launches_per_dispatch": ("launches", "grid",
                                           "device_trace")}
    for name, (unit, layer, source) in want.items():
        m = by_name[name]
        assert (m["unit"], m["layer"], m["source"]) == (unit, layer, source)
        assert m["better"] == "lower"
        assert m["moves"] == "audit_objects_per_s"
