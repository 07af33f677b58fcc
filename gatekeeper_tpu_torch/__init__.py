"""gatekeeper_tpu_torch: the PyTorch + CUDA port of gatekeeper_tpu.

A second package beside ``gatekeeper_tpu`` (the JAX reference), with every
module at the same relative path.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``gatekeeper_tpu``: host-only modules are kept as
copies.  Device code runs on one NVIDIA H100; the hand-written kernels live
in ``csrc/`` and build at first use.  Entry points take ``device=`` and
default to ``"cuda"``; only a caller that asks for ``"cpu"`` gets the plain
PyTorch versions of the kernels.

The port covers the library audit sweep, validating and mutating
admission and expansion so far: YAML loading, the Rego and CEL front ends
and lowering, the columnar flatten, the grid evaluator (``ir/program.py``),
the driver (``drivers/torch_driver.py``, with the batched
``query_batch``), the one-device sweep (``parallel/sweep.py``) with both
fold kernels (``ops/fold.py``), the serial audit schedule with its
expansion generator stage (``audit/manager.py``), the resident snapshot and
its device residency (``snapshot/``), mutation (``mutation/``, with the
device prefilter) and its batched lane (``mutlane/``), expansion
(``expansion/``), the webhook (``webhook/``: ``/v1/admit``, ``/v1/mutate``)
and ``python -m gatekeeper_tpu_torch --manifests DIR [--once]``.
"""

__version__ = "0.1.0"


def resolve_device(device: str = "cuda"):
    """The torch device an entry point runs on.  ``"cuda"`` (the default)
    requires a CUDA card and raises without one — it never falls back to
    the CPU quietly; ``"cpu"`` must be asked for."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
