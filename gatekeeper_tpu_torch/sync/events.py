"""Kubernetes Events emission for denies and audit violations.

Reference behavior this mirrors:
- webhook: ``--emit-admission-events`` +
  ``--admission-events-involved-namespace``
  (pkg/webhook/policy.go:276-340) — one corev1 Event per (result, scoped
  action), reason FailedAdmission / WarningAdmission / DryrunViolation,
  source component "gatekeeper-webhook".
- audit: ``--emit-audit-events`` + ``--audit-events-involved-namespace``
  (pkg/audit/manager.go:1247-1296) — one Event per KEPT violation, reason
  AuditViolation, component "gatekeeper-audit".

The recorder mirrors record.EventRecorder's two load-bearing properties:

- **async fire-and-forget**: emits enqueue to a bounded queue drained by
  one background thread — the admission hot path and the audit pass never
  block on an apiserver round-trip (a slow events endpoint must not push
  requests toward the webhook timeout).  Queue overflow drops the event
  (reported via ``on_error``), exactly the broadcaster's backpressure.
- **series aggregation**: a repeat of the same (involvedObject, reason,
  message) — e.g. the same persisting violation re-kept every 60s audit
  pass — bumps ``count``/``lastTimestamp`` on the EXISTING Event object
  instead of minting a new etcd object per pass.

Emission is best-effort and never fails the calling plane.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from gatekeeper_tpu_torch.utils.unstructured import gvk_of


def violation_ref(gk_namespace: str, rkind: str, rname: str,
                  rnamespace: str, rrv: str, ruid: str,
                  ckind: str, cname: str, cnamespace: str,
                  involved_namespace: bool) -> dict:
    """The Event's involvedObject (reference getViolationRef,
    pkg/audit/manager.go:1279-1296): events land in the gatekeeper
    namespace keyed by a synthetic resource/constraint UID, unless
    ``involved_namespace`` routes them into the violating resource's own
    namespace with its real uid/resourceVersion."""
    ens = gk_namespace
    if involved_namespace and rnamespace:
        ens = rnamespace
    ref = {"kind": rkind, "name": rname, "namespace": ens}
    if involved_namespace and ruid and rrv:
        ref["uid"] = ruid
        ref["resourceVersion"] = rrv
    elif not involved_namespace:
        ref["uid"] = (f"{rkind}/{rnamespace}/{rname}/"
                      f"{ckind}/{cnamespace}/{cname}")
    return ref


_AGG_CACHE_CAP = 4096  # aggregation keys retained (LRU)


class EventRecorder:
    """Best-effort async corev1 Event writer over any cluster client
    exposing ``apply``/``create`` (KubeCluster, FakeCluster,
    RoutingCluster).  One daemon worker drains the queue; repeats of the
    same (ref, reason, message) aggregate onto the existing Event."""

    def __init__(self, cluster, component: str,
                 gk_namespace: str = "gatekeeper-system",
                 involved_namespace: bool = False,
                 on_error=None, queue_cap: int = 1024):
        self.cluster = cluster
        self.component = component
        self.gk_namespace = gk_namespace
        self.involved_namespace = involved_namespace
        self.on_error = on_error
        self._seq = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_cap)
        # (ref-uid-or-name, ns, reason, message) -> [event_name, count],
        # insertion-ordered for LRU eviction
        self._agg: dict = {}
        self._worker = threading.Thread(
            target=self._drain, daemon=True,
            name=f"event-recorder-{component}")
        self._worker.start()

    def annotated_event(self, ref: dict, annotations: dict,
                        reason: str, message: str,
                        event_type: str = "Warning") -> None:
        """Enqueue; never blocks the caller (drop + report on overflow)."""
        self._seq += 1
        try:
            self._q.put_nowait((ref, dict(annotations), reason, message,
                                event_type, self._seq))
        except queue.Full:
            if self.on_error is not None:
                self.on_error(RuntimeError(
                    f"event queue full; dropped {reason} for "
                    f"{ref.get('name', '')}"))

    def flush(self, timeout: float = 10.0) -> None:
        """Wait (bounded) until every enqueued event has been written
        (tests, shutdown).  Never blocks past ``timeout`` — a wedged
        apiserver write must not hang shutdown."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._q.mutex:
                if self._q.unfinished_tasks == 0:
                    return
            time.sleep(0.005)

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._worker.join(timeout=5.0)

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # never die on event IO
                if self.on_error is not None:
                    self.on_error(e)
            finally:
                self._q.task_done()

    def _write(self, ref, annotations, reason, message, event_type, seq):
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        ns = ref.get("namespace", self.gk_namespace)
        # kind is part of the key even when the ref has a uid-less name
        # (involved-namespace audit refs): a Pod "foo" and a Service
        # "foo" must not aggregate onto one Event
        agg_key = (ref.get("kind", ""),
                   ref.get("uid") or ref.get("name", ""), ns, reason,
                   message)
        hit = self._agg.get(agg_key)
        if hit is not None:
            # series repeat (same persisting violation re-emitted by a
            # later audit pass): bump count/lastTimestamp on the existing
            # object instead of minting a new one per interval
            name, count, first_ts = hit
            hit[1] = count + 1
            self._agg[agg_key] = self._agg.pop(agg_key)  # LRU touch
            self.cluster.apply({
                "apiVersion": "v1", "kind": "Event",
                "metadata": {"name": name, "namespace": ns,
                             "annotations": annotations},
                "involvedObject": ref,
                "reason": reason, "message": message, "type": event_type,
                "source": {"component": self.component},
                "firstTimestamp": first_ts,  # preserved across bumps
                "lastTimestamp": ts, "count": count + 1,
            })
            return
        # client-go convention: <refname>.<unique-suffix>
        name = f"{ref.get('name', '') or 'unknown'}.{time.time_ns():x}{seq:x}"
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": ns,
                         "annotations": annotations},
            "involvedObject": ref,
            "reason": reason,
            "message": message,
            "type": event_type,
            "source": {"component": self.component},
            "firstTimestamp": ts,
            "lastTimestamp": ts,
            "count": 1,
        }
        create = getattr(self.cluster, "create", None)
        if create is not None:
            create(event)
        else:
            self.cluster.apply(event)
        self._agg[agg_key] = [name, 1, ts]
        while len(self._agg) > _AGG_CACHE_CAP:
            self._agg.pop(next(iter(self._agg)))


def _event_text(action: str) -> tuple:
    """(eventMsg, reason) per scoped enforcement action
    (pkg/webhook/policy.go:320-331)."""
    if action == "dryrun":
        return "Dryrun violation", "DryrunViolation"
    if action == "warn":
        return ('Admission webhook "validation.gatekeeper.sh" raised a '
                "warning for this request"), "WarningAdmission"
    return ('Admission webhook "validation.gatekeeper.sh" denied request',
            "FailedAdmission")


def admission_event_sink(recorder: EventRecorder):
    """ValidationHandler ``event_sink``: called with (req, results) after
    the deny/warn partition; emits one Event per (result, action)."""

    def sink(req, results) -> None:
        kind = req.kind or {}
        obj = req.object or {}
        meta = obj.get("metadata") or {}
        resource_name = req.name or meta.get("name", "") \
            or meta.get("generateName", "")
        for r in results:
            con = r.constraint or {}
            cmeta = con.get("metadata") or {}
            cgroup, cversion, ckind = gvk_of(con)
            actions = (r.scoped_enforcement_actions
                       if r.enforcement_action == "scoped"
                       else [r.enforcement_action])
            annotations = {
                "process": "admission",
                "event_type": "violation",
                "constraint_name": cmeta.get("name", ""),
                "constraint_group": cgroup,
                "constraint_api_version": cversion,
                "constraint_kind": ckind,
                "constraint_action": r.enforcement_action,
                "constraint_enforcement_actions": ",".join(actions),
                "resource_group": kind.get("group", ""),
                "resource_api_version": kind.get("version", ""),
                "resource_kind": kind.get("kind", ""),
                "resource_namespace": req.namespace,
                "resource_name": resource_name,
                "request_username": (req.user_info or {}).get(
                    "username", ""),
            }
            ref = violation_ref(
                recorder.gk_namespace, kind.get("kind", ""), resource_name,
                meta.get("namespace", "") or req.namespace,
                meta.get("resourceVersion", ""), meta.get("uid", ""),
                ckind, cmeta.get("name", ""), cmeta.get("namespace", ""),
                recorder.involved_namespace)
            for action in actions:
                event_msg, reason = _event_text(action)
                if recorder.involved_namespace:
                    message = (f"{event_msg}, Constraint: "
                               f"{cmeta.get('name', '')}, Message: {r.msg}")
                else:
                    message = (f"{event_msg}, Resource Namespace: "
                               f"{req.namespace}, Constraint: "
                               f"{cmeta.get('name', '')}, Message: {r.msg}")
                recorder.annotated_event(ref, annotations, reason, message)

    return sink


def audit_event_sink(recorder: EventRecorder):
    """AuditManager ``event_sink``: called with the finished AuditRun;
    emits one Event per kept violation (pkg/audit/manager.go:1247)."""

    def sink(run) -> None:
        for (ckind, cname), violations in run.kept.items():
            for v in violations:
                con = v.constraint
                cmeta = (con.raw.get("metadata") or {}) \
                    if con is not None else {}
                cnamespace = cmeta.get("namespace", "")
                annotations = {
                    "process": "audit",
                    "auditTimestamp": run.timestamp,
                    "event_type": "violation_audited",
                    "constraint_group": "constraints.gatekeeper.sh",
                    "constraint_api_version": "v1beta1",
                    "constraint_kind": ckind,
                    "constraint_name": cname,
                    "constraint_namespace": cnamespace,
                    "constraint_action": v.enforcement_action,
                    "resource_group": v.group,
                    "resource_api_version": v.version,
                    "resource_kind": v.kind,
                    "resource_namespace": v.namespace,
                    "resource_name": v.name,
                }
                ref = violation_ref(
                    recorder.gk_namespace, v.kind, v.name, v.namespace,
                    "", "", ckind, cname, cnamespace,
                    recorder.involved_namespace)
                if recorder.involved_namespace:
                    message = (f"Constraint: {cname}, "
                               f"Message: {v.message}")
                else:
                    message = (f"Resource Namespace: {v.namespace}, "
                               f"Constraint: {cname}, "
                               f"Message: {v.message}")
                recorder.annotated_event(ref, annotations,
                                         "AuditViolation", message)

    return sink
