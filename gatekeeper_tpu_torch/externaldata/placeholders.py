"""External-data placeholders for mutation values.

Reference: the framework's ExternalDataPlaceholder leaf — Assign mutators
with an externalData source insert placeholders during the mutation loop;
the system resolves them at convergence via batched provider calls
(pkg/mutation/system_external_data.go:21-221).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ExternalDataPlaceholder:
    provider: str
    data_source: str = "ValueAtLocation"  # or "Username"
    default: Any = None
    failure_policy: str = "Fail"  # Fail | Ignore | UseDefault
    location: str = ""
    original_value: Any = None
