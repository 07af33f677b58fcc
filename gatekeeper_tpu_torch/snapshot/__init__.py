"""Watch-driven incremental audit: the resident columnar cluster
snapshot (see :mod:`gatekeeper_tpu_torch.snapshot.store` for the design)
its device residency, and its disk spill (:mod:`gatekeeper_tpu_torch.
snapshot.persist`)."""

from gatekeeper_tpu_torch.snapshot.device_residency import (  # noqa: F401
    DeviceResidency,
    ResidentGroup,
)
from gatekeeper_tpu_torch.snapshot.ingest import (  # noqa: F401
    WatchIngester,
    gvks_of,
)
from gatekeeper_tpu_torch.snapshot.persist import (  # noqa: F401
    SnapshotSpill,
    SnapshotSpiller,
    templates_digest,
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
