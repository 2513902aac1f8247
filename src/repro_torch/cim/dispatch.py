"""Compiled-schedule cache and dispatch counters.

Port of the substrate services of `repro.cim.dispatch`: a bounded LRU of
schedule programs keyed by schedule structure (`repro_torch.cim.macro`
stores one `CompiledSchedule` per key), hit/miss/eviction counters, and
`dispatches` — the number of schedule-program invocations, the
deterministic walltime proxy (a warm macro matmul is exactly one).

The banked tiling dispatcher (`execute_tiled`, the vmap over tiles) and the
mesh path wait: the serve decode this slice ports is unbanked. The fused
kernel already takes a leading tile axis for them.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

from . import array as array_mod
from . import opset

#: program-table capacity (the reference's default)
_DEFAULT_CAPACITY = 256


class BoundedLRU:
    """Move-to-front bounded mapping with hit/miss/eviction counters. An
    insert past capacity evicts the coldest entry; correctness never
    depends on residency."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity < 1:
            raise opset.CimOpError(
                f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: "OrderedDict[object, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        """Look up, counting a hit (and refreshing recency) or a miss.
        Callers that miss MUST build and `put` under the same key."""
        if key in self._data:
            self.hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.misses += 1
        return default

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        self._evict()

    def _evict(self) -> None:
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def items(self):
        return self._data.items()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data), "evictions": self.evictions,
                "capacity": self.capacity}


_PROGRAMS = BoundedLRU()
_DISPATCHES = 0


def cache_stats() -> Dict[str, int]:
    """Program-table hits/misses/evictions, `dispatches` (schedule-program
    invocations) and the aggregated resident-region counters."""
    stats = _PROGRAMS.stats()
    stats["dispatches"] = _DISPATCHES
    stats.update(array_mod.resident_stats())
    return stats


def clear_schedule_cache() -> None:
    global _DISPATCHES
    _PROGRAMS.clear()
    _DISPATCHES = 0


def count_dispatch(n: int = 1) -> None:
    """Record `n` schedule-program invocations (see cache_stats)."""
    global _DISPATCHES
    _DISPATCHES += n


def program_cache_get(key):
    """Look up a schedule program, counting a hit or a miss. Callers that
    miss MUST build and `program_cache_put` under the same key."""
    return _PROGRAMS.get(key)


def program_cache_put(key, prog) -> None:
    _PROGRAMS.put(key, prog)
