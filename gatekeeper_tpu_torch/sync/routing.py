"""Remote-cluster routing.

Reference: pkg/routing (cache.go:19-40, wired main.go:664-716,
--enable-remote-cluster): gatekeeper runs against a TARGET cluster while
keeping its own operational state — everything in the
``status.gatekeeper.sh`` group plus local Secrets (webhook certs) — on the
MANAGEMENT cluster it is deployed in.  ``RoutingCluster`` implements the
same split over the ObjectSource seam: reads/writes/watches route per-GVK,
so the controllers and audit run unmodified against either shape.
"""

from __future__ import annotations

from typing import Callable, Optional

from gatekeeper_tpu_torch.sync.source import Event, gvk_of

STATUS_GROUP = "status.gatekeeper.sh"


OPERATOR_NAMESPACE = "gatekeeper-system"


def _routes_to_management(gvk: tuple, namespace: str = None) -> bool:
    group, _version, kind = gvk
    if group == STATUS_GROUP:
        return True
    # LOCAL Secrets (the operator namespace: webhook serving certs) live
    # management-side; the target cluster's Secrets are ordinary audited
    # objects (ref pkg/routing routes the operator-local secret only)
    if (group, kind) == ("", "Secret"):
        return namespace is None or namespace == OPERATOR_NAMESPACE
    return False


class RoutingCluster:
    """Routes object traffic between a management and a target cluster
    (same interface as FakeCluster / any ObjectSource)."""

    def __init__(self, management, target):
        self.management = management
        self.target = target

    def _for(self, gvk: tuple, namespace: str = None):
        return (self.management
                if _routes_to_management(gvk, namespace) else self.target)

    def apply(self, obj: dict) -> None:
        from gatekeeper_tpu_torch.utils.unstructured import namespace_of

        self._for(gvk_of(obj), namespace_of(obj)).apply(obj)

    def apply_status(self, obj: dict) -> None:
        from gatekeeper_tpu_torch.utils.unstructured import namespace_of

        src = self._for(gvk_of(obj), namespace_of(obj))
        getattr(src, "apply_status", src.apply)(obj)

    def delete(self, obj: dict) -> None:
        from gatekeeper_tpu_torch.utils.unstructured import namespace_of

        self._for(gvk_of(obj), namespace_of(obj)).delete(obj)

    def get(self, gvk: tuple, namespace: str, name: str) -> Optional[dict]:
        return self._for(gvk, namespace).get(gvk, namespace, name)

    def list(self, gvk: Optional[tuple] = None) -> list:
        if gvk is not None:
            # collection-level routing has no namespace: Secret lists span
            # the TARGET (audit must see the real cluster's Secrets) —
            # only the status group is management-only
            group = gvk[0]
            src = self.management if group == STATUS_GROUP else self.target
            out = src.list(gvk)
            if (group, gvk[2]) == ("", "Secret"):
                # writes to operator-local Secrets (webhook certs) routed
                # management-side — merge them so a component that writes
                # the cert Secret sees its own write in a list (ADVICE r2).
                # Management WINS for the operator namespace: the target
                # cluster may run its own gatekeeper whose same-named cert
                # Secret must not show up as a duplicate identity
                from gatekeeper_tpu_torch.utils.unstructured import \
                    namespace_of

                out = [o for o in out
                       if namespace_of(o) != OPERATOR_NAMESPACE]
                out += [o for o in self.management.list(gvk)
                        if namespace_of(o) == OPERATOR_NAMESPACE]
            return out
        # unfiltered list spans both clusters (management state is
        # gatekeeper-internal and comes last); a live target has no
        # unfiltered list — iterate its discovered GVKs
        if hasattr(self.target, "server_preferred_gvks"):
            out = []
            for gvk_t in self.target.server_preferred_gvks():
                out.extend(self.target.list(gvk_t))
        else:
            out = list(self.target.list())
        return out + list(self.management.list())

    def subscribe(self, gvk: tuple, callback: Callable[[Event], None],
                  replay: bool = False):
        # NOTE: Secret WATCHES are target-only (unlike list(), which merges
        # operator-local management Secrets): components needing the cert
        # Secret must use get() — a watch will not observe management-side
        # writes.  Matches the reference, where the cert-controller reads
        # its secret with a direct client, not via the informer plane.
        src = self.management if gvk[0] == STATUS_GROUP else self.target
        return src.subscribe(gvk, callback, replay=replay)

    # --- live-target passthroughs (KubeCluster surface) ---------------
    def server_preferred_gvks(self) -> list:
        """Discovery spans the TARGET cluster (audit sweeps its objects;
        management holds only gatekeeper-internal state)."""
        return self.target.server_preferred_gvks()

    def list_iter(self, gvk: tuple):
        src = self.management if gvk[0] == STATUS_GROUP else self.target
        if hasattr(src, "list_iter"):
            return src.list_iter(gvk)
        return iter(src.list(gvk))

    def close(self):
        for c in (self.management, self.target):
            if hasattr(c, "close"):
                c.close()
