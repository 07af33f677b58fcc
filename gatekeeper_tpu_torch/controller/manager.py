"""Reconciliation manager: cluster state → framework state.

The reference wires 17 controllers over controller-runtime
(pkg/controller/controller.go:178-293); the equivalents here subscribe to the
cluster source and reconcile each resource family into its system:

- ConstraintTemplate → client.add_template (+ dynamic constraint-kind watch,
  mirroring constrainttemplate_controller.go:516) → constraints →
  client.add_constraint
- Config → process excluder + CacheManager.upsert_source (config_controller)
- SyncSet → CacheManager.upsert_source (syncset_controller)
- Assign/AssignMetadata/ModifySet/AssignImage → mutation system
- ExpansionTemplate → expansion system
- Provider → provider cache
- Connection → export system

Operation gating mirrors ``--operation`` pod sharding
(pkg/operations/operations.go): a webhook pod runs no audit, the audit pod
serves no admission — both reconcile the shared state.
"""

from __future__ import annotations

import sys
import threading
from typing import Iterable, Optional

from gatekeeper_tpu_torch.apis.constraints import CONSTRAINTS_GROUP
from gatekeeper_tpu_torch.expansion.system import (EXPANSION_GROUP,
                                                   ExpansionSystem)
from gatekeeper_tpu_torch.externaldata.providers import (PROVIDER_GROUP,
                                                         ProviderCache)
from gatekeeper_tpu_torch.mutation.mutators import (MUTATIONS_GROUP,
                                                    MUTATOR_KINDS)
from gatekeeper_tpu_torch.mutation.system import MutationSystem
from gatekeeper_tpu_torch.readiness.tracker import Tracker
from gatekeeper_tpu_torch.sync.cachemanager import CacheManager
from gatekeeper_tpu_torch.sync.process import ProcessExcluder
from gatekeeper_tpu_torch.sync.source import DELETED, Event, FakeCluster
from gatekeeper_tpu_torch.utils.unstructured import (deep_get, gvk_of,
                                                     name_of)

TEMPLATES_GVK = ("templates.gatekeeper.sh", "v1", "ConstraintTemplate")
CONFIG_GVK = ("config.gatekeeper.sh", "v1alpha1", "Config")
SYNCSET_GVK = ("syncset.gatekeeper.sh", "v1alpha1", "SyncSet")
EXPANSION_GVK = (EXPANSION_GROUP, "v1alpha1", "ExpansionTemplate")
PROVIDER_GVK = (PROVIDER_GROUP, "v1beta1", "Provider")
CONNECTION_GVK = ("connection.gatekeeper.sh", "v1alpha1", "Connection")
WEBHOOKCONFIG_GVK = ("admissionregistration.k8s.io", "v1",
                     "ValidatingWebhookConfiguration")

ALL_OPERATIONS = ("audit", "webhook", "mutation-webhook",
                  "mutation-controller", "status", "generate")

# per-pod status substrate (reference: apis/status/v1beta1)
STATUS_GROUP = "status.gatekeeper.sh"
STATUS_VERSION = "v1beta1"
STATUS_KIND_FOR = {
    "ConstraintTemplate": "ConstraintTemplatePodStatus",
    CONSTRAINTS_GROUP: "ConstraintPodStatus",
    "Config": "ConfigPodStatus",
    "ExpansionTemplate": "ExpansionTemplatePodStatus",
    "Assign": "MutatorPodStatus",
    "AssignMetadata": "MutatorPodStatus",
    "ModifySet": "MutatorPodStatus",
    "AssignImage": "MutatorPodStatus",
    "Provider": "ExternalDataProviderPodStatus",
    "Connection": "ConnectionPodStatus",
}


class Manager:
    def __init__(
        self,
        client,
        cluster: FakeCluster,
        operations: Iterable[str] = ALL_OPERATIONS,
        mutation_system: Optional[MutationSystem] = None,
        expansion_system: Optional[ExpansionSystem] = None,
        provider_cache: Optional[ProviderCache] = None,
        extdata_lane=None,  # extdata/lane.ExtDataLane
        export_system=None,
        metrics=None,
        pod_name: Optional[str] = None,
        readiness_retries: int = 0,
    ):
        import os

        self.client = client
        self.cluster = cluster
        self.operations = set(operations)
        self.pod_name = pod_name or os.environ.get(
            "POD_NAME", "gatekeeper-tpu-0")
        self.tracker = Tracker(retries=readiness_retries)
        self.excluder = ProcessExcluder()
        self.webhookconfig_cache = None  # validating webhook match scope
        self.provider_cache = provider_cache or ProviderCache()
        # batched external-data join lane (extdata/lane.py): Provider
        # reconciles invalidate its resident columns so spec changes
        # (URL, CA, timeout) can't serve stale join answers
        self.extdata_lane = extdata_lane
        self.mutation_system = mutation_system or MutationSystem(
            provider_cache=self.provider_cache)
        self.expansion_system = expansion_system or ExpansionSystem(
            mutation_system=self.mutation_system)
        self.export_system = export_system
        self.metrics = metrics
        self.cache_manager = CacheManager(
            client, cluster, excluder=self.excluder,
            readiness_tracker=self.tracker, metrics=metrics,
        )
        self._constraint_watches: dict[str, callable] = {}  # kind -> cancel
        self._lock = threading.RLock()
        self._template_errors: dict[str, str] = {}
        self._requeue_delay: dict[str, float] = {}  # backoff continuity
        # Config spec.validation.traces[] (per-request webhook tracing)
        self.validation_traces: list = []

    def is_assigned(self, op: str) -> bool:
        """Reference: operations.IsAssigned (operations.go:92)."""
        return op in self.operations or "*" in self.operations

    # --- generation swap (drivers/generation.py) ------------------------
    def generation_coordinator(self):
        """The device driver's GenerationCoordinator, or None (no device
        driver / --generation-swap off)."""
        for d in self.client.drivers:
            gc = getattr(d, "gen_coord", None)
            if gc is not None:
                return gc
        return None

    def begin_background_compile(self) -> bool:
        """Flip template reconciles from inline compile to the
        enqueue-and-swap lane.  Called once boot reconcile has settled
        (manifests loaded, warm pass done): boot stays synchronous —
        readiness and the warm loop see compiled templates — while every
        LATER reconcile only stages + notifies; the background thread
        compiles the next generation and swaps it in off the serving
        path.  Returns True when a coordinator exists and is running."""
        gc = self.generation_coordinator()
        if gc is None:
            return False
        gc.start()
        return True

    # --- boot (reference: readiness tracker seeding, ready_tracker.go:326)
    def start(self) -> "Manager":
        # stored-version migration first (reference: pkg/upgrade runs
        # before controllers, manager.go:31-60) — prunes legacy
        # storedVersions from owned CRDs left by older deployments
        from gatekeeper_tpu_torch.controller.upgrade import run_upgrade

        run_upgrade(self.cluster)

        def boot_list(gvk):
            # a missing CRD / transient apiserver error must not crash
            # boot: the watch plane retries with backoff, readiness just
            # starts with zero expectations for that kind
            try:
                return self.cluster.list(gvk)
            except Exception as e:
                print(f"boot list {gvk}: {e}", file=sys.stderr)  # noqa: T201
                return []

        boot_templates = boot_list(TEMPLATES_GVK)
        for obj in boot_templates:
            self.tracker.expect("templates", name_of(obj))
        self.tracker.populated("templates")
        # per-template constraint listers (reference: SingleRunner listers
        # per template kind, ready_tracker.go:326): each pre-existing
        # template's constraints become expectations, observed as the
        # dynamic watches reconcile them
        for obj in boot_templates:
            ckind = deep_get(obj,
                             ("spec", "crd", "spec", "names", "kind"), "")
            if not ckind:
                continue
            for con in boot_list((CONSTRAINTS_GROUP, "v1beta1", ckind)):
                self.tracker.expect("constraints",
                                    (ckind, name_of(con)))
        for gvk, kind in ((CONFIG_GVK, "config"),
                          (EXPANSION_GVK, "expansions"),
                          (PROVIDER_GVK, "providers")):
            for obj in boot_list(gvk):
                self.tracker.expect(kind, name_of(obj))
            self.tracker.populated(kind)
        for gvk in [TEMPLATES_GVK, CONFIG_GVK, SYNCSET_GVK, EXPANSION_GVK,
                    PROVIDER_GVK, CONNECTION_GVK, WEBHOOKCONFIG_GVK]:
            self.cluster.subscribe(gvk, self._dispatch, replay=True)
        for mkind in MUTATOR_KINDS:
            for version in ("v1", "v1beta1", "v1alpha1"):
                self.cluster.subscribe((MUTATIONS_GROUP, version, mkind),
                                       self._dispatch, replay=True)
        self.tracker.populated("mutators")
        # status controllers: fold per-pod status CRs into parent status
        for status_kind in sorted(set(STATUS_KIND_FOR.values())):
            self.cluster.subscribe(
                (STATUS_GROUP, STATUS_VERSION, status_kind),
                self._dispatch, replay=True)
        # constraints tracked once their kinds exist; mark populated for the
        # boot snapshot (dynamic watches will observe them)
        self.tracker.populated("constraints")
        self.tracker.populated("data")
        return self

    # --- dispatch -------------------------------------------------------
    def _dispatch(self, event: Event) -> None:
        group, _version, kind = gvk_of(event.obj)
        if event.type == DELETED and group != STATUS_GROUP and (
                kind in STATUS_KIND_FOR or group in STATUS_KIND_FOR):
            # every replica removes ITS pod-status with the parent (the
            # reference's status controllers do the same), so recreated
            # parents never fold departed pods' orphans
            self._delete_pod_status(event.obj)
        try:
            if (group, kind) == (TEMPLATES_GVK[0], TEMPLATES_GVK[2]):
                self._reconcile_template(event)
            elif group == CONSTRAINTS_GROUP:
                self._reconcile_constraint(event)
            elif (group, kind) == (CONFIG_GVK[0], CONFIG_GVK[2]):
                self._reconcile_config(event)
            elif (group, kind) == (SYNCSET_GVK[0], SYNCSET_GVK[2]):
                self._reconcile_syncset(event)
            elif group == MUTATIONS_GROUP and kind in MUTATOR_KINDS:
                self._reconcile_mutator(event)
            elif (group, kind) == (EXPANSION_GVK[0], EXPANSION_GVK[2]):
                self._reconcile_expansion(event)
            elif (group, kind) == (PROVIDER_GVK[0], PROVIDER_GVK[2]):
                self._reconcile_provider(event)
            elif (group, kind) == (CONNECTION_GVK[0], CONNECTION_GVK[2]):
                self._reconcile_connection(event)
            elif (group, kind) == (WEBHOOKCONFIG_GVK[0],
                                   WEBHOOKCONFIG_GVK[2]):
                self._reconcile_webhookconfig(event)
            elif group == STATUS_GROUP:
                self._reconcile_podstatus(event)
        except Exception as e:  # reconcile errors surface via status
            self._set_status(event.obj, error=str(e))

    # --- per-family reconcilers ----------------------------------------
    def _reconcile_template(self, event: Event) -> None:
        name = name_of(event.obj)
        if event.type == DELETED:
            kind = deep_get(event.obj,
                            ("spec", "crd", "spec", "names", "kind"), "")
            if kind:
                self.client.remove_template(kind)
                cancel = self._constraint_watches.pop(kind, None)
                if cancel:
                    cancel()
                self._prune_constraints_of(kind)
            # a template deleted before its boot expectation was observed
            # must not wedge /readyz (reference CancelExpect on delete)
            self.tracker.cancel("templates", name)
            return
        try:
            crd = self.client.add_template(event.obj)
        except Exception as e:
            # compile failure: cancel the readiness expectation
            # (constrainttemplate_controller.go:391,484) and prune the
            # kind's constraint expectations (they can never be observed)
            self._prune_constraints_of(deep_get(
                event.obj, ("spec", "crd", "spec", "names", "kind"), ""))
            cancelled = self.tracker.try_cancel("templates", name)
            self._template_errors[name] = str(e)
            self._set_status(event.obj, error=str(e))
            if not cancelled:
                # retry budget remains (--readiness-retries > 0 / -1):
                # requeue with backoff until the budget is spent or the
                # template compiles — without this, nothing re-triggers
                # reconcile and /readyz wedges forever (the reference
                # controller requeues failing reconciles)
                delay = self._requeue_delay.pop(name, 1.0)
                self._requeue_delay[name] = min(delay * 2, 30.0)
                self._requeue_template(name, delay)
            return
        self._template_errors.pop(name, None)
        self.tracker.observe("templates", name)
        if self.metrics is not None:
            self.metrics.set_gauge("constraint_templates",
                                   len(self.client.templates()), {})
        kind = crd["spec"]["names"]["kind"]
        try:
            self._manage_vap(event.obj, kind)
        except Exception as e:
            # VAP generation failure is a status condition, never a reconcile
            # abort (the template stays live and its constraints watched)
            self._set_status(event.obj, error=f"vap generation: {e}")
        with self._lock:
            if kind not in self._constraint_watches:
                # dynamic watch for the constraint kind
                # (constrainttemplate_controller.go:516)
                self._constraint_watches[kind] = self.cluster.subscribe(
                    (CONSTRAINTS_GROUP, "v1beta1", kind), self._dispatch,
                    replay=True,
                )
        self._set_status(event.obj, created=True)

    def _prune_constraints_of(self, kind: str) -> None:
        """The kind's constraint expectations die with its template."""
        if kind:
            self.tracker.prune("constraints", lambda k: k[0] == kind)

    def _requeue_template(self, name: str, delay_s: float = 1.0) -> None:
        """Re-reconcile a failing template after a backoff, reading the
        CURRENT object (a delete or a fixed re-apply in the meantime
        wins).  The retry runs the FULL reconcile — on success the
        constraint-kind watch, VAP management, status and metrics all
        happen exactly as for a watch-event reconcile.  The failure path
        doubles the delay (capped 30s) via _requeue_delay; the chain dies
        when the template compiles, is deleted, or try_cancel spends the
        readiness budget."""
        import threading as _threading

        from gatekeeper_tpu_torch.sync.source import MODIFIED, Event

        def fire():
            cur = self.cluster.get(TEMPLATES_GVK, "", name)
            if cur is None or name not in self._template_errors:
                self._requeue_delay.pop(name, None)
                return  # deleted or fixed meanwhile
            self._reconcile_template(Event(MODIFIED, cur))
            if name not in self._template_errors:
                self._requeue_delay.pop(name, None)

        t = _threading.Timer(delay_s, fire)
        t.daemon = True
        t.start()

    def _reconcile_constraint(self, event: Event) -> None:
        if event.type == DELETED:
            self.client.remove_constraint(event.obj)
            # deleted before observed must not wedge readiness
            self.tracker.cancel(
                "constraints",
                (event.obj.get("kind", ""), name_of(event.obj)))
        else:
            self.client.add_constraint(event.obj)
            self.tracker.observe(
                "constraints",
                (event.obj.get("kind", ""), name_of(event.obj)))
            self._manage_vapb(event.obj)
        if self.metrics is not None:
            self.metrics.set_gauge("constraints",
                                   len(self.client.constraints()), {})

    def _reconcile_config(self, event: Event) -> None:
        name = name_of(event.obj)
        # reference enforces the singleton name "config" (policy.go:489-494)
        if name != "config":
            self._set_status(event.obj, error="config name must be 'config'")
            return
        if event.type == DELETED:
            self.cache_manager.remove_source(("config", name))
            # excluder reset must wipe + replay like any excluder change
            self.cache_manager.replace_excluder(ProcessExcluder())
            self.validation_traces = []
            return
        match_entries = deep_get(event.obj, ("spec", "match"), []) or []
        self.cache_manager.replace_excluder(
            ProcessExcluder.from_config_match(match_entries))
        # per-request decision tracing selectors (config_types.go:42-54),
        # consulted by the webhook via Manager.validation_traces
        self.validation_traces = deep_get(
            event.obj, ("spec", "validation", "traces"), []) or []
        gvks = []
        for e in deep_get(event.obj, ("spec", "sync", "syncOnly"), []) or []:
            gvks.append((e.get("group", ""), e.get("version", ""),
                        e.get("kind", "")))
        self.cache_manager.upsert_source(("config", name), gvks)
        self.tracker.observe("config", name)

    def _reconcile_syncset(self, event: Event) -> None:
        name = name_of(event.obj)
        if event.type == DELETED:
            self.cache_manager.remove_source(("syncset", name))
            return
        gvks = []
        for e in deep_get(event.obj, ("spec", "gvks"), []) or []:
            gvks.append((e.get("group", ""), e.get("version", ""),
                        e.get("kind", "")))
        self.cache_manager.upsert_source(("syncset", name), gvks)

    def _reconcile_mutator(self, event: Event) -> None:
        from gatekeeper_tpu_torch.mutation.mutators import MutatorID

        _g, _v, kind = gvk_of(event.obj)
        if event.type == DELETED:
            self.mutation_system.remove(
                MutatorID(kind=kind, name=name_of(event.obj)))
        else:
            self.mutation_system.upsert_unstructured(event.obj)
            if self.metrics is not None:
                self.metrics.inc_counter(
                    "mutator_ingestion_count", {"status": "active"})
                self.metrics.set_gauge(
                    "mutator_conflicting_count",
                    len(self.mutation_system.conflicts()), {})

    def _reconcile_expansion(self, event: Event) -> None:
        if event.type == DELETED:
            self.expansion_system.remove_template(name_of(event.obj))
        else:
            self.expansion_system.upsert_template(event.obj)
            self.tracker.observe("expansions", name_of(event.obj))

    def _reconcile_provider(self, event: Event) -> None:
        name = name_of(event.obj)
        if event.type == DELETED:
            self.provider_cache.remove(name)
        else:
            self.provider_cache.upsert(event.obj)
            self.tracker.observe("providers", name)
        if self.extdata_lane is not None:
            # belt-and-braces with the ProviderCache listener: a lane
            # wired to a DIFFERENT cache still invalidates on reconcile
            self.extdata_lane.invalidate(name)

    def _reconcile_connection(self, event: Event) -> None:
        if self.export_system is None:
            return
        if event.type == DELETED:
            self.export_system.remove_connection(name_of(event.obj))
        else:
            self.export_system.upsert_connection_cr(event.obj)

    # --- status (reference: per-pod *PodStatus CRs folded by status
    # controllers; single-process equivalent writes .status directly) ----
    # --- per-pod status CRs (reference: apis/status/v1beta1 + the 7
    # status controllers, e.g. constraintstatus_controller.go:251) -------
    def _set_status(self, obj: dict, error: Optional[str] = None,
                    created: bool = False) -> None:
        """Write THIS pod's status as a namespaced *PodStatus object; the
        status fold (_reconcile_podstatus, running in every replica)
        aggregates all pods' entries into the parent's .status.byPod —
        the reference's multi-replica coordination substrate (no leader
        election; per-pod CRs avoid write contention)."""
        group, version, kind = gvk_of(obj)
        status_kind = STATUS_KIND_FOR.get(
            kind if kind in STATUS_KIND_FOR else group)
        name = name_of(obj)
        namespace = deep_get(obj, ("metadata", "namespace"), "") or ""
        if status_kind is None or not name:
            return
        entry = {
            "id": self.pod_name,
            "observedGeneration": deep_get(
                obj, ("metadata", "generation"), 1),
            "operations": sorted(self.operations),
        }
        if error is not None:
            entry["errors"] = [{"message": error}]
        pod_status = {
            "apiVersion": f"{STATUS_GROUP}/{STATUS_VERSION}",
            "kind": status_kind,
            "metadata": {
                "name": f"{self.pod_name}-{kind}-{name}".lower(),
                "namespace": "gatekeeper-system",
                "labels": {
                    "internal.gatekeeper.sh/pod": self.pod_name,
                    "internal.gatekeeper.sh/parent-kind": kind,
                    "internal.gatekeeper.sh/parent-name": name,
                    "internal.gatekeeper.sh/parent-group": group,
                    "internal.gatekeeper.sh/parent-version": version,
                    "internal.gatekeeper.sh/parent-namespace": namespace,
                },
            },
            "status": {**entry, "created": created},
        }
        existing = self.cluster.get(
            (STATUS_GROUP, STATUS_VERSION, status_kind),
            "gatekeeper-system", pod_status["metadata"]["name"])
        if existing is not None and \
                existing.get("status") == pod_status["status"]:
            # unchanged PodStatus won't fire the watch, but the PARENT may
            # have been rewritten without status (spec update): refold
            self._fold_parent(status_kind, kind, name, group, version,
                              namespace)
            return
        self.cluster.apply(pod_status)

    def _delete_pod_status(self, obj: dict) -> None:
        group, version, kind = gvk_of(obj)
        status_kind = STATUS_KIND_FOR.get(
            kind if kind in STATUS_KIND_FOR else group)
        name = name_of(obj)
        if status_kind is None or not name:
            return
        self.cluster.delete({
            "apiVersion": f"{STATUS_GROUP}/{STATUS_VERSION}",
            "kind": status_kind,
            "metadata": {
                "name": f"{self.pod_name}-{kind}-{name}".lower(),
                "namespace": "gatekeeper-system",
            },
        })

    def _reconcile_podstatus(self, event: Event) -> None:
        """Fold every pod's *PodStatus for one parent into the parent's
        .status.byPod (the reference's status controllers)."""
        labels = deep_get(event.obj, ("metadata", "labels"), {}) or {}
        p_kind = labels.get("internal.gatekeeper.sh/parent-kind", "")
        p_name = labels.get("internal.gatekeeper.sh/parent-name", "")
        p_group = labels.get("internal.gatekeeper.sh/parent-group", "")
        p_version = labels.get("internal.gatekeeper.sh/parent-version", "")
        p_ns = labels.get("internal.gatekeeper.sh/parent-namespace", "")
        if not p_kind or not p_name:
            return
        _g, _v, status_kind = gvk_of(event.obj)
        self._fold_parent(status_kind, p_kind, p_name, p_group, p_version,
                          p_ns)

    def _fold_parent(self, status_kind, p_kind, p_name, p_group,
                     p_version, p_namespace: str = "") -> None:
        entries = []
        created = False
        for ps in self.cluster.list(
                (STATUS_GROUP, STATUS_VERSION, status_kind)):
            pl = deep_get(ps, ("metadata", "labels"), {}) or {}
            if pl.get("internal.gatekeeper.sh/parent-kind") != p_kind or \
                    pl.get("internal.gatekeeper.sh/parent-name") != p_name:
                continue
            st = dict(ps.get("status") or {})
            created = created or bool(st.pop("created", False))
            entries.append(st)
        entries.sort(key=lambda e: e.get("id", ""))
        parent = self.cluster.get((p_group, p_version, p_kind),
                                  p_namespace, p_name)
        if parent is None:
            return
        status = dict(parent.get("status") or {})
        if status.get("byPod") == entries and \
                status.get("created", False) == created:
            return  # converged: break the reconcile echo
        status["byPod"] = entries
        status["created"] = created
        updated = dict(parent)
        updated["status"] = status
        self.cluster.apply(updated)

    def template_error(self, name: str) -> Optional[str]:
        return self._template_errors.get(name)

    # --- VAP generation (reference: manageVAP at constrainttemplate_
    # controller.go:503-524 + manageVAPB at constraint_controller.go:375;
    # gated by generateVAP in the CEL source) ---------------------------
    def _cel_driver(self):
        for d in self.client.drivers:
            if hasattr(d, "template_to_vap"):
                return d
        return None

    def _reconcile_webhookconfig(self, event: Event) -> None:
        """webhookconfig cache (reference: webhookconfig_controller.go:293
        + webhookconfigcache/): cache the validating webhook's match scope
        so generated VAPs mirror it, then refresh every generated VAP."""
        if event.type == "DELETED":
            self.webhookconfig_cache = None
        else:
            hooks = event.obj.get("webhooks") or []
            scope = {}
            for h in hooks:
                if "validation" not in h.get("name", ""):
                    continue
                scope = {
                    "namespaceSelector": h.get("namespaceSelector"),
                    "objectSelector": h.get("objectSelector"),
                    "rules": h.get("rules"),
                }
                break
            self.webhookconfig_cache = scope or None
        # re-emit VAPs for every CEL template under the new scope
        for tobj in self.cluster.list(TEMPLATES_GVK):
            kind = (((tobj.get("spec") or {}).get("crd") or {})
                    .get("spec") or {}).get("names", {}).get("kind")
            if kind:
                self._manage_vap(tobj, kind)

    def _manage_vap(self, template_obj: dict, kind: str) -> None:
        driver = self._cel_driver()
        if driver is None:
            return
        compiled = getattr(driver, "_templates", {}).get(kind)
        if compiled is None or not getattr(compiled, "generate_vap", False):
            return
        from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate

        t = ConstraintTemplate.from_unstructured(template_obj)
        self.cluster.apply(driver.template_to_vap(
            t, webhook_scope=self.webhookconfig_cache))

    def _manage_vapb(self, constraint_obj: dict) -> None:
        driver = self._cel_driver()
        if driver is None:
            return
        kind = constraint_obj.get("kind", "")
        compiled = getattr(driver, "_templates", {}).get(kind)
        if compiled is None or not getattr(compiled, "generate_vap", False):
            return
        from gatekeeper_tpu_torch.apis.constraints import Constraint

        template = self.client.get_template(kind)
        if template is None:
            return
        con = Constraint.from_unstructured(constraint_obj)
        self.cluster.apply(driver.constraint_to_vap_binding(con, template))
