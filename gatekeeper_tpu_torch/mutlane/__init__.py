"""Batched mutation + expansion lane (PAPER.md L5, vectorized).

The reference treats mutation (`mutation.System.Mutate`, the `/v1/mutate`
webhook) and expansion (`expansion.System.Expand`) as strictly per-object
host walks.  This package gives both the batched treatment the validation
path already has:

- :mod:`lane` — compile the mutator registry into one columnar program
  (the Assign/AssignMetadata fragment ``mutation/device.py`` lowers), so
  a burst of objects is columnized once, classified by one [M, N]
  change/error grid, and answered with per-object RFC-6902 patch columns;
  the host fixed-point loop stays authoritative for everything the
  fragment excludes and is the bit-identity reference.
- :mod:`webhook` — the `/v1/mutate` microbatching handler (graceful
  drain, sharing the validation lane's semantics).
- :mod:`expand_stage` — the level-synchronous batched expansion stage:
  generator objects expand structurally per level and their resultants
  batch-mutate through the lane with ``Source=Generated``, for the audit
  sweep (shift-left auditing at sweep scale).

Port of ``gatekeeper_tpu/mutlane``: every entry point takes ``device=``
(default ``"cuda"``) for the prefilter's grids.
"""

from gatekeeper_tpu_torch.mutlane.lane import (MutationDifferentialError,
                                         MutationLane, MutationOutcome)
from gatekeeper_tpu_torch.mutlane.expand_stage import (BatchedExpander,
                                                 ExpandResult,
                                                 ExpansionStage)
from gatekeeper_tpu_torch.mutlane.webhook import (BatchedMutationHandler,
                                            MutationBatcher)

__all__ = [
    "BatchedExpander",
    "BatchedMutationHandler",
    "ExpandResult",
    "ExpansionStage",
    "MutationBatcher",
    "MutationDifferentialError",
    "MutationLane",
    "MutationOutcome",
]
