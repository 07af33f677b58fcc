"""Each configuration's control (the reference with one stated guarantee
broken, in the program's place) comes out not correct: at a size a test run
holds, on three seeds.  ``control.py`` runs the same at the cells' own
sizes on the card's host."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("workload,objects", [
    ("library-150k.relist", 8000), ("library-150k.resident", 8000)])
def test_the_control_fails_the_comparison(workload, objects):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "control.py"), "--workload",
         workload, "--seeds", "21", "22", "23", "--objects", str(objects),
         "--workers", "2"],
        capture_output=True, text=True, timeout=600, check=True)
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert line["correct"] is False
        assert max(v["value"] for v in line["compared"].values()) > 0

