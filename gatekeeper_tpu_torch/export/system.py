"""Violation export plane.

Reference: pkg/export — ``System`` maps Connection CRs to pluggable drivers;
the audit publishes audit_started / violation / audit_ended messages
(audit/manager.go:267-295,931-936).  Drivers here: **disk** (rotating
audit-run files, reference disk/disk.go), **stdout**, and **dapr**
(pub-sub publish through the localhost sidecar HTTP API, reference
export/dapr/dapr.go:93).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class ExportError(Exception):
    pass


class DiskDriver:
    """Rotating per-audit-run violation files (reference: export/disk)."""

    def __init__(self, path: str, max_audit_results: int = 3):
        self.base = path
        self.max_audit_results = max_audit_results
        self._current: Optional[object] = None
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)

    def publish(self, msg: dict) -> None:
        with self._lock:
            if msg.get("event") == "audit_started":
                self._rotate(msg.get("auditID", ""))
            if self._current is not None:
                self._current.write(json.dumps(msg) + "\n")
                self._current.flush()
            if msg.get("event") == "audit_ended" and self._current:
                self._current.close()
                self._current = None

    def _rotate(self, audit_id: str) -> None:
        if self._current is not None:
            self._current.close()
        safe = audit_id.replace(":", "_").replace("/", "_") or str(
            int(time.time()))
        self._current = open(
            os.path.join(self.base, f"audit_{safe}.jsonl"), "w")
        self._cleanup()

    def _cleanup(self) -> None:
        """Keep only the newest N runs (reference: disk/cleanup.go)."""
        runs = sorted(
            (f for f in os.listdir(self.base) if f.startswith("audit_")),
            key=lambda f: os.path.getmtime(os.path.join(self.base, f)),
        )
        for f in runs[: max(0, len(runs) - self.max_audit_results)]:
            os.unlink(os.path.join(self.base, f))


class StdoutDriver:
    def publish(self, msg: dict) -> None:
        print("export:", json.dumps(msg), flush=True)


class DaprDriver:
    """dapr pub-sub export (reference: export/dapr/dapr.go): publishes
    each message to the local sidecar's HTTP API,
    POST http://127.0.0.1:<port>/v1.0/publish/<component>/<topic>.  The
    sidecar port follows the DAPR_HTTP_PORT convention."""

    def __init__(self, component: str = "pubsub",
                 topic: str = "audit-channel",
                 port: Optional[int] = None,
                 timeout_s: float = 5.0):
        self.component = component
        self.topic = topic
        self.port = port if port is not None else int(
            os.environ.get("DAPR_HTTP_PORT", "3500"))
        self.timeout_s = timeout_s

    def publish(self, msg: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/v1.0/publish/"
            f"{self.component}/{self.topic}",
            data=json.dumps(msg).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                if r.status >= 300:
                    raise ExportError(
                        f"dapr sidecar returned {r.status}")
        except ExportError:
            raise
        except Exception as e:
            raise ExportError(f"dapr publish failed: {e}") from e


DRIVERS = {"disk": DiskDriver, "stdout": StdoutDriver, "dapr": DaprDriver}


class ExportSystem:
    """Connection registry + publish fan-in (reference: export/system.go)."""

    def __init__(self):
        self._connections: dict[str, object] = {}
        self._lock = threading.Lock()

    def upsert_connection(self, name: str, driver: str, config: dict) -> None:
        cls = DRIVERS.get(driver)
        if cls is None:
            raise ExportError(f"unknown export driver {driver!r}")
        with self._lock:
            if driver == "disk":
                self._connections[name] = cls(
                    config.get("path", "/tmp/gatekeeper-exports"),
                    int(config.get("maxAuditResults", 3)),
                )
            elif driver == "dapr":
                self._connections[name] = cls(
                    component=config.get("component", "pubsub"),
                    topic=config.get("topic", "audit-channel"),
                    port=(int(config["port"]) if "port" in config
                          else None),
                )
            else:
                self._connections[name] = cls()

    def upsert_connection_cr(self, obj: dict) -> None:
        """Connection CR (reference: apis/connection + export controller)."""
        spec = obj.get("spec") or {}
        name = (obj.get("metadata") or {}).get("name", "")
        self.upsert_connection(name, spec.get("driver", ""),
                               spec.get("config") or {})

    def remove_connection(self, name: str) -> None:
        with self._lock:
            self._connections.pop(name, None)

    def publish(self, msg: dict) -> list:
        """Returns per-connection errors (fed back into connection status in
        the reference, audit/manager.go:1317-1340)."""
        errors = []
        with self._lock:
            conns = list(self._connections.items())
        for name, driver in conns:
            try:
                driver.publish(msg)
            except Exception as e:
                errors.append((name, str(e)))
        return errors

    # audit-facing helpers (message shapes per audit/manager.go:267-295)
    def publish_audit_started(self, audit_id: str):
        return self.publish({"event": "audit_started", "auditID": audit_id})

    def publish_violation(self, audit_id: str, violation) -> list:
        return self.publish({
            "event": "violation",
            "auditID": audit_id,
            "constraint": str(violation.constraint.key()),
            "enforcementAction": violation.enforcement_action,
            "group": violation.group,
            "version": violation.version,
            "kind": violation.kind,
            "namespace": violation.namespace,
            "name": violation.name,
            "message": violation.message,
        })

    def publish_audit_ended(self, audit_id: str):
        return self.publish({"event": "audit_ended", "auditID": audit_id})
