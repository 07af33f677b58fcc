"""A run whose timed path is broken underneath comes out ``correct: false``.

Each case skips the harness's look for a card (``device="cpu"``), drives the
rest of a run at a small size, and breaks the program in one of the ways
its cells can break: a sweep that leaves its state unchanged, half of each
chunk left out, an answer altered where it is produced.  (The
exchange between cards cannot be left out: every cell takes one card.)  A
sound run of the same size comes out correct.
"""

import json
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.append(p)

from harness import core, main  # noqa: E402

SEED = 3_000_000_419


def _run(workload: str, hook=None, capsys=None, seconds: str = "2"):
    mix = {}
    if "resident" in workload:
        mix = {"residency": "on"}  # "auto" declines a CPU evaluator
    overrides = {"objects": 2000, "workers": 2, "mix": mix}
    if hook is not None:
        overrides["program_hooks"] = hook
    rc = main.main(["--workload", workload, "--seed", str(SEED),
                    "--seconds", seconds, "--trace", "0"],
                   time.perf_counter(), device="cpu", overrides=overrides)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


# --- audit ------------------------------------------------------------------
def audit_unchanged(stack):
    stack["mgr"]._process_swept = lambda *a, **k: None


def audit_half(stack):
    ev = stack["evaluator"]
    submit = ev.sweep_submit

    def half(constraints, objects, *a, **k):
        return submit(constraints, objects[:max(1, len(objects) // 2)],
                      *a, **k)

    ev.sweep_submit = half


def audit_altered(stack):
    driver = stack["driver"]
    render = driver.render_query

    def altered(*a, **k):
        resp = render(*a, **k)
        for r in resp.results[:1]:
            r.msg += " (altered)"
        return resp

    driver.render_query = altered


@pytest.mark.parametrize("workload", ["library-150k.relist",
                                      "library-150k.resident"])
def test_a_sound_audit_is_correct(workload, capsys):
    line = _run(workload, capsys=capsys)
    assert line["correct"] is True
    assert set(line["compared"]) == {"objects_off", "incomplete",
                                     "totals_off", "kept_wrong"}
    assert list(line)[-1] == "compared"


def resident_unchanged(stack):
    stack["mgr"]._fold_snapshot_chunk = lambda *a, **k: None


def resident_half(stack):
    ev = stack["evaluator"]
    flatten = ev.sweep_flatten_resident

    def half(rg, positions, *a, **k):
        return flatten(rg, positions[:max(1, len(positions) // 2)], *a, **k)

    ev.sweep_flatten_resident = half


@pytest.mark.parametrize("workload,fault,number", [
    ("library-150k.relist", audit_unchanged, "totals_off"),
    ("library-150k.relist", audit_half, "totals_off"),
    ("library-150k.relist", audit_altered, "kept_wrong"),
    ("library-150k.resident", resident_unchanged, "totals_off"),
    ("library-150k.resident", resident_half, "totals_off"),
    ("library-150k.resident", audit_altered, "kept_wrong")],
    ids=["relist-unchanged", "relist-half", "relist-altered",
         "resident-unchanged", "resident-half", "resident-altered"])
def test_a_broken_audit_is_not_correct(workload, fault, number, capsys):
    line = _run(workload, fault, capsys)
    assert line["correct"] is False
    assert line["compared"][number]["value"] > 0


# --- runs that cannot measure -----------------------------------------------
def test_no_card_no_result(capsys):
    rc = main.main(["--workload", "library-150k.relist", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_changed_library_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(core, "library_digest", lambda root: "0" * 64)
    rc = main.main(["--workload", "library-150k.relist", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], time.perf_counter(),
                   device="cpu", overrides={"objects": 100})
    assert rc != 0
    assert capsys.readouterr().out == ""
