"""ProviderColumn: the resident keyed store of one provider's responses.

Copy of ``gatekeeper_tpu/extdata/column.py`` (host-only).  The snapshot
store's idea applied to external data: responses stay RESIDENT between
bursts/chunks keyed by the raw key string, so a
steady-state burst whose keys are already landed makes zero transport
calls.  Entries expire by TTL (the refresh re-lands them through the
bulk path) and the whole column invalidates when its Provider object is
reconciled (spec change = the cached answers may no longer hold).

A monotone ``version`` bumps on every landing / invalidation; the lane's
vocab-padded device tables key their caches on it, so a warm column
serves the SAME numpy arrays chunk over chunk (the evaluators' device
table caches then skip the host->device upload too).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ProviderColumn:
    def __init__(self, provider: str, ttl_s: float = 180.0,
                 clock: Callable[[], float] = time.monotonic):
        self.provider = provider
        self.ttl_s = ttl_s
        self._clock = clock
        # key -> (landed_at, value, error-or-None).  A stale-served
        # refresh re-lands with a fresh stamp: the column's staleness
        # window stacks on the transport cache's own TTL model (bounded,
        # and the breaker paces the retries underneath).
        self._entries: dict = {}
        self._version = 0
        self._lock = threading.Lock()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def missing(self, keys) -> list:
        """Keys not resident (or past TTL), first-occurrence order,
        deduped — the bulk fetch list."""
        now = self._clock()
        out: list = []
        seen: set = set()
        with self._lock:
            for k in keys:
                if k in seen:
                    continue
                seen.add(k)
                hit = self._entries.get(k)
                if hit is None or now - hit[0] >= self.ttl_s:
                    out.append(k)
        return out

    def land(self, results: dict) -> None:
        """Store ``key -> (value, error-or-None)`` pairs; bumps the
        version (device tables rebuild lazily)."""
        if not results:
            return
        now = self._clock()
        with self._lock:
            for k, (v, e) in results.items():
                self._entries[k] = (now, v, e)
            self._version += 1

    def get(self, key) -> Optional[tuple]:
        """(value, error-or-None) for a resident key, None if never
        landed.  Freshness is ensure()'s job — a key that survived a
        failed refresh reads its last landed value (the stale-serve
        semantics of the transport cache, kept resident)."""
        with self._lock:
            hit = self._entries.get(key)
            return None if hit is None else (hit[1], hit[2])

    def snapshot(self) -> dict:
        """key -> (value, error-or-None) — the table-build read."""
        with self._lock:
            return {k: (v, e) for k, (_t, v, e) in self._entries.items()}

    def invalidate(self) -> None:
        """Provider reconcile: drop everything (the next batch refetches
        through the bulk path)."""
        with self._lock:
            self._entries.clear()
            self._version += 1

    # --- spill persistence (the JAX package's snapshot/persist.py reads
    # these; the port has no spill yet) ---------------------------------
    def export_entries(self) -> dict:
        """``key -> (remaining_ttl_s, value, error)`` — absolute clock
        stamps do not survive a restart (the default clock is
        monotonic), so the spill records each key's REMAINING ttl and
        the import re-stamps against the new process's clock."""
        now = self._clock()
        with self._lock:
            return {k: (self.ttl_s - (now - t), v, e)
                    for k, (t, v, e) in self._entries.items()}

    def import_entries(self, entries: dict, elapsed_s: float = 0.0
                       ) -> int:
        """Re-land spilled entries; ``elapsed_s`` is the wall time the
        process spent down (spill ``saved_at`` to load) — keys whose
        remaining TTL it consumed are DROPPED, so a warm restart
        re-fetches only what actually expired.  Returns keys landed."""
        now = self._clock()
        landed = 0
        with self._lock:
            for k, (remaining, v, e) in entries.items():
                remaining -= max(0.0, elapsed_s)
                if remaining <= 0:
                    continue
                self._entries[k] = (now - (self.ttl_s - remaining), v, e)
                landed += 1
            if landed:
                self._version += 1
        return landed
