"""Canonical structured logging.

Reference: pkg/logging/logging.go — fixed semantic keys shared by deny logs
(policy.go:276-296), audit violation logs (manager.go:1218-1245) and template
lifecycle logs, so log pipelines can rely on stable field names.
"""

from __future__ import annotations

import json
import logging
import sys
import time

# canonical keys (logging.go:52)
PROCESS = "process"
DETAILS = "details"
EVENT_TYPE = "event_type"
TEMPLATE_NAME = "template_name"
CONSTRAINT_GROUP = "constraint_group"
CONSTRAINT_API_VERSION = "constraint_api_version"
CONSTRAINT_KIND = "constraint_kind"
CONSTRAINT_NAME = "constraint_name"
CONSTRAINT_NAMESPACE = "constraint_namespace"
CONSTRAINT_ACTION = "constraint_action"
CONSTRAINT_ANNOTATIONS = "constraint_annotations"
CONSTRAINT_STATUS = "constraint_status"
AUDIT_ID = "audit_id"
RESOURCE_GROUP = "resource_group"
RESOURCE_KIND = "resource_kind"
RESOURCE_API_VERSION = "resource_api_version"
RESOURCE_NAMESPACE = "resource_namespace"
RESOURCE_NAME = "resource_name"
RESOURCE_LABELS = "resource_labels"
REQUEST_USERNAME = "request_username"

_logger = logging.getLogger("gatekeeper_tpu_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)


class _WarnSampler:
    """WARN+ rate limit: at most ``rate`` warning/error lines per second
    (reference: main.go zap sampling, WARN+ sampled 100/s); dropped-line
    counts surface on the next emitted record."""

    def __init__(self, rate: int = 100):
        self.rate = rate
        self._window = 0.0
        self._count = 0
        self._dropped = 0

    def admit(self) -> tuple:
        """(emit: bool, dropped_since_last_emit: int)"""
        now = time.monotonic()
        if now - self._window >= 1.0:
            self._window = now
            self._count = 0
        if self._count >= self.rate:
            self._dropped += 1
            return False, 0
        self._count += 1
        dropped, self._dropped = self._dropped, 0
        return True, dropped


_warn_sampler = _WarnSampler()


def log_event(level: str, msg: str, **fields) -> None:
    """zapr-style JSON line with canonical keys; WARN+ is sampled."""
    record = {"level": level, "ts": time.time(), "msg": msg}
    record.update({k: v for k, v in fields.items() if v is not None})
    if level in ("warning", "error"):
        emit, dropped = _warn_sampler.admit()
        if not emit:
            return
        if dropped:
            record["sampled_dropped"] = dropped
    line = json.dumps(record, default=str)
    if level == "error":
        _logger.error(line)
    elif level == "warning":
        _logger.warning(line)
    else:
        _logger.info(line)


def log_deny(result, req, process: str = "admission") -> None:
    """Structured deny log (reference: policy.go:276-296 with
    --log-denies)."""
    constraint = result.constraint or {}
    meta = constraint.get("metadata") or {}
    kind = (req.kind or {}) if req is not None else {}
    log_event(
        "info",
        "denied admission: " + result.msg,
        **{
            PROCESS: process,
            EVENT_TYPE: "violation",
            CONSTRAINT_GROUP: "constraints.gatekeeper.sh",
            CONSTRAINT_KIND: constraint.get("kind", ""),
            CONSTRAINT_NAME: meta.get("name", ""),
            CONSTRAINT_ACTION: result.enforcement_action,
            RESOURCE_GROUP: kind.get("group", ""),
            RESOURCE_KIND: kind.get("kind", ""),
            RESOURCE_NAMESPACE: req.namespace if req else "",
            RESOURCE_NAME: req.name if req else "",
            REQUEST_USERNAME: (req.user_info or {}).get("username", "")
            if req else "",
        },
    )


def log_audit_violation(violation, audit_id: str) -> None:
    """Reference: manager.go:1218-1245."""
    constraint = violation.constraint
    log_event(
        "info",
        violation.message,
        **{
            PROCESS: "audit",
            EVENT_TYPE: "violation_audited",
            AUDIT_ID: audit_id,
            CONSTRAINT_KIND: constraint.kind,
            CONSTRAINT_NAME: constraint.name,
            CONSTRAINT_ACTION: violation.enforcement_action,
            RESOURCE_GROUP: violation.group,
            RESOURCE_API_VERSION: violation.version,
            RESOURCE_KIND: violation.kind,
            RESOURCE_NAMESPACE: violation.namespace,
            RESOURCE_NAME: violation.name,
        },
    )
