"""Batched external-data join lane (validation + mutation); port of
``gatekeeper_tpu/extdata``.

- :mod:`gatekeeper_tpu_torch.extdata.column` — ProviderColumn, the resident
  keyed store (TTL expiry, invalidation on Provider reconcile).
- :mod:`gatekeeper_tpu_torch.extdata.lane` — ExtDataLane: per-batch key
  dedupe, one bulk transport call per (provider, batch) through the
  existing ProviderCache semantics, vocab-padded device join tables,
  batched mutation-placeholder resolution, and the
  batched | perkey | differential lane switch.
"""

from gatekeeper_tpu_torch.extdata.column import ProviderColumn  # noqa: F401
from gatekeeper_tpu_torch.extdata.lane import (  # noqa: F401
    ExtDataDivergence,
    ExtDataLane,
    activate,
    active,
    install,
    uninstall,
)
