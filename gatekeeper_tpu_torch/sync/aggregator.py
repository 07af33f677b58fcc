"""GVK aggregator: who wants which kinds synced.

Reference: pkg/cachemanager/aggregator/aggregator.go — sources (the Config
singleton, each SyncSet) upsert GVK wish-lists; the aggregate drives the
watch set, with reverse indexing so removing a source prunes only GVKs no
other source wants.
"""

from __future__ import annotations

from typing import Iterable, Optional


GVK = tuple  # (group, version, kind)


class GVKAggregator:
    def __init__(self):
        self._by_source: dict[tuple, set] = {}  # (source_type, name) -> {gvk}
        self._by_gvk: dict[GVK, set] = {}  # gvk -> {source key}

    def upsert(self, key: tuple, gvks: Iterable[GVK]) -> None:
        new = set(gvks)
        old = self._by_source.get(key, set())
        for gone in old - new:
            holders = self._by_gvk.get(gone)
            if holders:
                holders.discard(key)
                if not holders:
                    del self._by_gvk[gone]
        for added in new - old:
            self._by_gvk.setdefault(added, set()).add(key)
        self._by_source[key] = new

    def remove(self, key: tuple) -> None:
        self.upsert(key, ())
        self._by_source.pop(key, None)

    def gvks(self) -> set:
        return set(self._by_gvk)

    def is_watched(self, gvk: GVK) -> bool:
        return gvk in self._by_gvk

    def sources_for(self, gvk: GVK) -> set:
        return set(self._by_gvk.get(gvk, ()))
