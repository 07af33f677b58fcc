"""One short run of the relist cell on the card: it exits 0 and its last
line says ``correct: true``.  Skips where there is no card.  Run on the
card as ``python -m pytest benchmark/tests -m cuda -q``."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_a_short_relist_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "library-150k.relist", "--seed", "3000000555", "--seconds", "3",
         "--trace", "0"], cwd=os.path.dirname(BENCH), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert {"audit_objects_per_s", "setup_s"} <= set(line["metrics"])
