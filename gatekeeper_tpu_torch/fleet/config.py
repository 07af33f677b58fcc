"""``--fleet-config clusters.json``: the fleet's cluster roster.

Shape (every field but ``id``/``manifests`` optional)::

    {"clusters": [
       {"id": "prod-eu-1", "manifests": ["clusters/prod-eu-1/"]},
       {"id": "prod-eu-2", "manifests": ["clusters/prod-eu-2/"]}],
     "packChunks": 0}

Each cluster's ``manifests`` (files/dirs, the ``gator`` reader formats)
split by document kind: ConstraintTemplates + Constraints form the
cluster's POLICY LIBRARY (the runtime-sharing key — clusters whose
library documents digest identically share one compiled runtime), and
every other document is CLUSTER STATE (loaded into that cluster's
object source).  ``packChunks`` caps how many same-group cluster
chunks one packed dispatch carries (0 = auto: the runtime's cluster
count).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ClusterSpec:
    cluster_id: str
    manifests: list = field(default_factory=list)


@dataclass
class FleetConfig:
    clusters: list = field(default_factory=list)  # [ClusterSpec]
    pack_chunks: int = 0  # 0 = auto (cluster count per runtime)


def parse_fleet_config(doc: dict) -> FleetConfig:
    from gatekeeper_tpu_torch.fleet.evaluator import check_cluster_id

    cfg = FleetConfig()
    raw = doc.get("clusters") or []
    if not raw:
        raise ValueError("fleet config names no clusters")
    seen: set = set()
    for entry in raw:
        cid = check_cluster_id(str(entry.get("id", "")))
        if cid in seen:
            raise ValueError(f"duplicate cluster id {cid!r}")
        seen.add(cid)
        cfg.clusters.append(ClusterSpec(
            cluster_id=cid,
            manifests=list(entry.get("manifests") or [])))
    cfg.pack_chunks = int(doc.get("packChunks", 0))
    return cfg


def load_fleet_config(path: str) -> FleetConfig:
    with open(path) as f:
        return parse_fleet_config(json.load(f))


def split_cluster_docs(objs: list) -> tuple:
    """(library_docs, state_docs): templates + constraints are the
    policy library, everything else is cluster state."""
    from gatekeeper_tpu_torch.gator import reader

    library: list = []
    state: list = []
    for obj in objs:
        if reader.is_template(obj) or reader.is_constraint(obj):
            library.append(obj)
        else:
            state.append(obj)
    return library, state


def library_key(library_docs: list) -> str:
    """Content digest of one cluster's policy library documents — the
    runtime-sharing key (order-independent: two clusters listing the
    same docs in different file orders still share)."""
    blobs = sorted(json.dumps(d, sort_keys=True, default=str)
                   for d in library_docs)
    return hashlib.sha256("\n".join(blobs).encode()).hexdigest()


def load_cluster_spec(spec: ClusterSpec,
                      filenames: Optional[list] = None) -> tuple:
    """(library_key, library_docs, state_docs) of one roster entry."""
    from gatekeeper_tpu_torch.gator import reader

    objs = reader.read_sources(filenames or spec.manifests)
    library, state = split_cluster_docs(objs)
    return library_key(library), library, state
