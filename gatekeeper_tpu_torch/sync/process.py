"""Process excluder: per-process namespace exemptions.

Reference: pkg/controller/config/process/excluder.go — the Config CR's
``spec.match`` lists namespace globs excluded per process (webhook / audit /
sync / mutation-webhook / *).
"""

from __future__ import annotations

from typing import Iterable

from gatekeeper_tpu_torch.match import wildcard

PROCESSES = ("audit", "sync", "webhook", "mutation-webhook", "*")


class ProcessExcluder:
    def __init__(self):
        self._excluded: dict[str, list[str]] = {p: [] for p in PROCESSES}

    @staticmethod
    def from_config_match(entries: Iterable[dict]) -> "ProcessExcluder":
        """entries: Config CR spec.match = [{processes: [...],
        excludedNamespaces: [...]}]."""
        ex = ProcessExcluder()
        for entry in entries or []:
            for proc in entry.get("processes") or ["*"]:
                if proc not in ex._excluded:
                    continue
                ex._excluded[proc].extend(entry.get("excludedNamespaces") or [])
        return ex

    def add(self, processes: Iterable[str], namespaces: Iterable[str]) -> None:
        for p in processes:
            if p in self._excluded:
                self._excluded[p].extend(namespaces)

    def is_excluded(self, process: str, namespace: str) -> bool:
        if not namespace:
            return False
        patterns = self._excluded.get(process, []) + self._excluded["*"]
        return any(wildcard.matches(p, namespace) for p in patterns)

    def equals(self, other: "ProcessExcluder") -> bool:
        return self._excluded == other._excluded

    def replace(self, other: "ProcessExcluder") -> None:
        self._excluded = {k: list(v) for k, v in other._excluded.items()}
