"""Watch-driven incremental audit: the resident columnar cluster
snapshot (see :mod:`gatekeeper_tpu_torch.snapshot.store` for the design)
and its device residency.  The spill of the persist slice
(``SnapshotSpill``, ``SnapshotSpiller``, ``templates_digest``) is not
ported yet."""

from gatekeeper_tpu_torch.snapshot.device_residency import (  # noqa: F401
    DeviceResidency,
    ResidentGroup,
)
from gatekeeper_tpu_torch.snapshot.ingest import (  # noqa: F401
    WatchIngester,
    gvks_of,
)
from gatekeeper_tpu_torch.snapshot.store import (  # noqa: F401
    ClusterSnapshot,
    GroupStore,
    SnapshotConfig,
    VerdictStore,
    concat_group_rows,
    obj_key,
    row_signature,
)
