"""Audit source ``snapshot``: every sweep audits the resident snapshot.

Set-up applies the cluster to a ``FakeCluster``, which a ``WatchIngester``
streams into a ``ClusterSnapshot``, and keeps its columns on the device
through a ``DeviceResidency`` in the mix's ``residency`` mode.  The program's
audit then reads the snapshot (the mix sets ``audit_source`` to
``snapshot``), so flatten and upload are bypassed.
"""


def build(stack: dict, raws: list, cfg, mix: dict) -> None:
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    evaluator = stack["evaluator"]
    cluster = FakeCluster()
    for o in stack["objects"]:
        cluster.apply(o)
    snap = ClusterSnapshot(evaluator, SnapshotConfig())
    ingester = WatchIngester(snap, cluster, gvks_of(cluster.list()))
    ingester.start()
    residency = DeviceResidency(evaluator, mode=mix["residency"])
    stack.update(residency=residency, snapshot=snap, close=ingester.stop)
    stack["mgr"] = AuditManager(stack["client"], lister=cluster.list,
                                config=cfg, evaluator=evaluator,
                                snapshot=snap, residency=residency)
