"""The yardstick's arithmetic: the cluster generator, the device's
busy-interval union, the fold kernels' bytes, the collector's clock."""

import gc
import hashlib
import json
import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import core, trace  # noqa: E402
from harness.cluster import (iter_cluster_objects,  # noqa: E402
                             scaled_counts)

with open(os.path.join(BENCH, "configs", "library-150k.json")) as _f:
    KINDS = json.load(_f)["kinds"]
# sha256 of the 150k mix scaled to 2,000 objects, at seed 0, as JSON with
# sorted keys: pins the generator, so that no later change moves the inputs
FROZEN_DIGEST = ("229b64c7e32608fa7fc8592ccfc5df51"
                 "2c55b33f35eec4c4909d4d6714412cbc")


def _digest(objs) -> str:
    return hashlib.sha256(json.dumps(objs, sort_keys=True).encode()
                          ).hexdigest()


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_017, 2**31 + 5])
def test_the_generator_gives_the_same_objects_for_a_seed(seed):
    counts = scaled_counts(KINDS, 1500)
    a = list(iter_cluster_objects(counts, seed=seed))
    b = list(iter_cluster_objects(counts, seed=seed))
    assert a == b
    assert a != list(iter_cluster_objects(counts, seed=seed + 1))


def test_the_generator_is_frozen():
    objs = list(iter_cluster_objects(scaled_counts(KINDS, 2000), seed=0))
    kinds = {o["kind"] for o in objs}
    assert kinds == {"Pod", "Service", "Ingress", "Deployment", "Namespace",
                     "Node", "RoleBinding", "ClusterRoleBinding"}
    assert _digest(objs) == FROZEN_DIGEST


@pytest.mark.parametrize("seed", [1, 3_000_000_017])
def test_every_seed_gives_the_configurations_counts(seed):
    counts = {"Pod": 700, "Node": 25, "Namespace": 50, "Service": 50,
              "Ingress": 50, "Deployment": 53, "binding": 43}
    objs = list(iter_cluster_objects(counts, seed=seed))
    got: dict = {}
    for o in objs:
        kind = o["kind"] if "Binding" not in o["kind"] else "binding"
        got[kind] = got.get(kind, 0) + 1
    assert got == counts
    namespaces = {o["metadata"]["name"] for o in objs
                  if o["kind"] == "Namespace"}
    assert len(namespaces) == 50
    for o in objs:
        ns = o["metadata"].get("namespace")
        assert ns is None or ns in namespaces
    assert len({(o["kind"], o["metadata"]["name"]) for o in objs}) == \
        len(objs)


def test_the_configuration_holds_the_published_counts():
    assert KINDS["Pod"] == 150_000 and KINDS["Node"] == 5_000
    assert KINDS["Namespace"] == 10_000 and KINDS["Service"] == 10_000
    assert scaled_counts(KINDS) == KINDS
    small = scaled_counts(KINDS, 2000)
    assert 1990 <= sum(small.values()) <= 2010 and min(small.values()) >= 1


def test_the_collector_clock_counts_full_collections():
    CollectorClock = core.plugin("drivers", "audit").CollectorClock

    with CollectorClock() as clock:
        gc.collect()
        gc.collect(0)
    assert clock.full == 1 and clock.full_s > 0
    assert clock.all_s >= clock.full_s
    assert clock not in gc.callbacks


def _evt(name, start, end, device):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def test_idle_share_is_one_less_the_union_of_device_intervals():
    events = [
        _evt("bench.window", 0, 1000, False),
        _evt("bench.window", 0, 1000, True),   # the annotation: no work
        _evt("kernel_a", 100, 200, True),
        _evt("kernel_b", 150, 250, True),      # overlaps kernel_a
        _evt("void fold_rows<true, true>", 500, 600, True),
        _evt("Memcpy HtoD (Pinned -> Device)", 590, 700, True),
        _evt("kernel_c", 1100, 1200, True),    # outside the window
    ]
    out = trace.analyse(events, [("flatten", 0, 400)])
    assert out["window_s"] == pytest.approx(1000e-6)
    # union: [100, 250] + [500, 700] = 350 us
    assert out["busy_s"] == pytest.approx(350e-6)
    assert out["idle_share"] == pytest.approx(0.65)
    assert out["fold_s"] == pytest.approx(100e-6)
    assert out["fold_events"] == 1
    assert out["other_kernel_s"] == pytest.approx(200e-6)
    # gaps [0, 100] and [250, 500] have their middles in flatten,
    # [700, 1000] outside every span
    assert out["gaps"]["flatten"] == pytest.approx(350e-6)
    assert out["gaps"]["outside the harness spans"] == pytest.approx(
        300e-6)
    assert sum(out["gaps"].values()) == pytest.approx(650e-6)


def test_a_profile_without_device_work_reads_nothing():
    out = trace.analyse([_evt("bench.window", 0, 1000, False)], [])
    assert out["busy_s"] is None and out["idle_share"] is None


@pytest.mark.parametrize("fused,nbytes", [(True, 2_888_336),
                                          (False, 1_446_368)])
def test_fold_bound_bytes(fused, nbytes):
    ms, by, b = trace.fold_bound(44, 32768, 20, fused)
    assert b == nbytes and by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_fold_roofline_reads_launches_against_device_time():
    read = core.metric_reader("fold_roofline")
    bound_s = trace.fold_bound(44, 32768, 20, True)[0] / 1e3
    prof = {"fold_launches": [("fused_fold", (44, 32768, 20), 4)],
            "fold_events": 4, "fold_s": 4 * bound_s * 10}
    assert read({"profile": prof}) == pytest.approx(10.0)
    assert read({"profile": dict(prof, fold_events=3)}) is None
    assert read({"profile": None}) is None
