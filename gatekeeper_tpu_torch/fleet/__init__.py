"""Fleet mode: one evaluator, N clusters — shared compile/executable
caches, cross-cluster chunk packing, per-cluster snapshots (see
:mod:`gatekeeper_tpu_torch.fleet.evaluator` for the design)."""

from gatekeeper_tpu_torch.fleet.config import (  # noqa: F401
    ClusterSpec,
    FleetConfig,
    library_key,
    load_cluster_spec,
    load_fleet_config,
    parse_fleet_config,
    split_cluster_docs,
)
from gatekeeper_tpu_torch.fleet.evaluator import (  # noqa: F401
    FleetCluster,
    FleetEvaluator,
    LibraryRuntime,
    check_cluster_id,
)
