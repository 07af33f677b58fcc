"""``collector_ms_per_full`` on synthetic ``layer`` dicts: the window's
full-collection seconds over their number, in milliseconds, and ``None``
where either counter is missing or zero (a program without them)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import core  # noqa: E402


def test_it_divides_the_full_collections_seconds_by_their_number():
    read = core.metric_reader("collector_ms_per_full")
    layer = {"objects": 400_000,
             "mgr_perf": {"gc": 9.0, "gc_full": 8.0, "gc_full_s": 0.4}}
    assert read(layer) == pytest.approx(50.0)
    # the window's object count plays no part
    layer["objects"] = 1
    assert read(layer) == pytest.approx(50.0)


@pytest.mark.parametrize("layer", [
    {},
    {"objects": 10},
    {"objects": 10, "mgr_perf": {}},
    {"objects": 10, "mgr_perf": {"gc": 1.5}},
    {"objects": 10, "mgr_perf": {"gc_full": 3.0}},
    {"objects": 10, "mgr_perf": {"gc_full_s": 0.2}},
    {"objects": 10, "mgr_perf": {"gc_full": 0.0, "gc_full_s": 0.0}},
    {"objects": 10, "mgr_perf": {"gc_full": 0.0, "gc_full_s": 0.2}},
])
def test_it_reads_nothing_without_both_counters(layer):
    assert core.metric_reader("collector_ms_per_full")(layer) is None
