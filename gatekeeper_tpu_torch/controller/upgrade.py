"""Startup CRD storage-version migration (upgrade manager).

Reference: pkg/upgrade/manager.go:31-60 — on boot, gatekeeper lists its
own CRDs and re-writes ``status.storedVersions`` so that decommissioned
API versions (v1alpha1/v1beta1 cleanup) can be dropped from etcd before a
future release removes them from the CRD spec.

Why this is nearly n/a in this framework's shape: every CRD this
framework synthesizes (constraint kinds from templates, the framework's
own types) is served at a SINGLE version, and all state reconstructs
from the apiserver on boot (SURVEY.md §5.4) — there is no multi-version
stored state to migrate.  The manager below still performs the
reference-equivalent contract so operators upgrading from a cluster
previously managed by the Go reference (whose CRDs may carry legacy
stored versions) converge: any stored version no longer present in a
CRD's ``spec.versions`` is pruned from ``status.storedVersions``,
keeping at most the served versions.

Wired by ``controller.manager`` at startup (one pass; the reference runs
it once per boot too).
"""

from __future__ import annotations

from typing import Optional

from gatekeeper_tpu_torch.utils.logging import log_event

CRD_GVK = ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")

# CRD groups this framework owns (reference: upgrade manager only touches
# gatekeeper CRDs — constraints + its own API groups)
OWNED_GROUP_SUFFIXES = (
    "gatekeeper.sh",
)


def _owned(crd: dict) -> bool:
    group = ((crd.get("spec") or {}).get("group")) or ""
    return any(group == s or group.endswith("." + s)
               for s in OWNED_GROUP_SUFFIXES)


class UpgradeManager:
    """One-shot stored-version migration over an ObjectSource cluster."""

    def __init__(self, cluster):
        self.cluster = cluster

    def upgrade(self) -> int:
        """Prune stale entries from ``status.storedVersions`` of every
        owned CRD; returns the number of CRDs migrated."""
        try:
            crds = self.cluster.list(CRD_GVK)
        except Exception as e:  # discovery may not serve CRDs (tests)
            log_event("info", f"upgrade: CRD list unavailable: {e}",
                      process="upgrade")
            return 0
        migrated = 0
        for crd in crds or []:
            if not _owned(crd):
                continue
            spec_versions = [
                v.get("name") for v in
                ((crd.get("spec") or {}).get("versions") or [])
                if isinstance(v, dict)
            ]
            status = crd.get("status") or {}
            stored = list(status.get("storedVersions") or [])
            kept = [v for v in stored if v in spec_versions]
            if kept == stored:
                continue
            crd = dict(crd)
            crd["status"] = dict(status)
            crd["status"]["storedVersions"] = kept
            try:
                # CRD status is a subresource on a real apiserver: a main
                # PUT silently drops it (found in round-3 review)
                write = getattr(self.cluster, "apply_status",
                                self.cluster.apply)
                write(crd)
                migrated += 1
                log_event(
                    "info",
                    "upgrade: pruned storedVersions of "
                    f"{(crd.get('metadata') or {}).get('name')}: "
                    f"{stored} -> {kept}",
                    process="upgrade",
                )
            except Exception as e:
                log_event(
                    "warning",
                    "upgrade: migrating "
                    f"{(crd.get('metadata') or {}).get('name')} "
                    f"failed: {e}",
                    process="upgrade",
                )
        return migrated


def run_upgrade(cluster) -> Optional[int]:
    """Convenience wrapper used by the controller manager at boot."""
    return UpgradeManager(cluster).upgrade()
