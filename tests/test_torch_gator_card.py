"""``gator bench --engine sweep --collect masks`` on the card (marked
``cuda``; skips without one): the masks lane launches the hand-written
``epilogue`` kernel and its violations equal the ``--device cpu`` run's.
No JAX here, so it runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_gator_card.py -m cuda -q
"""

import copy
import os

import pytest
import torch

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.cuda
def test_sweep_engine_masks_lane_launches_the_epilogue_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from gatekeeper_tpu_torch.gator import bench, reader
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    objs = reader.read_sources([os.path.join(ROOT, "library")]) + \
        make_cluster_objects(512, seed=0)
    cpu = bench.run_bench(copy.deepcopy(objs), "sweep", 1, collect="masks",
                          device="cpu")
    fold.epilogue.launches = 0
    card = bench.run_bench(copy.deepcopy(objs), "sweep", 1, collect="masks",
                           device="cuda")
    assert fold.epilogue.launches > 0
    assert card.violations == cpu.violations > 0
    assert card.objects == cpu.objects > 512
