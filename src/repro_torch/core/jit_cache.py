"""LRU kernel registry with per-family hit/miss/eviction counters.

The engine's plan cache (descriptor -> plan) and kernel cache
(descriptor + plan knobs -> built executor, with its device-resident tile
tables) are both instances.  Every key is a tuple whose first element is
the kernel-family name, which is how the stats are bucketed.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Hashable


def _family_of(key: Hashable) -> str:
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return "other"


class LruCache:
    """Thread-safe LRU mapping with per-family hit/miss/eviction stats."""

    def __init__(self, max_entries: int = 4096):
        self._lock = threading.Lock()
        self._store: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._max = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._by_family: Dict[str, Dict[str, int]] = {}

    def _bucket(self, family: str) -> Dict[str, int]:
        return self._by_family.setdefault(
            family, {"hits": 0, "misses": 0, "evictions": 0})

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                self._bucket(_family_of(key))["hits"] += 1
                return self._store[key]
        # Build outside the lock: builds can be slow.
        value = builder()
        with self._lock:
            if key not in self._store:
                while len(self._store) >= self._max:
                    evicted_key, _ = self._store.popitem(last=False)
                    self.evictions += 1
                    self._bucket(_family_of(evicted_key))["evictions"] += 1
                self._store[key] = value
                self.misses += 1
                self._bucket(_family_of(key))["misses"] += 1
            else:  # raced with another builder thread; theirs won
                self._store.move_to_end(key)
                self.hits += 1
                self._bucket(_family_of(key))["hits"] += 1
            return self._store[key]

    def put(self, key: Hashable, value: Any) -> None:
        """Insert or overwrite ``key`` (refreshing recency), no hit or miss
        counted: the engine puts a fresh autotuned winner on the tuned
        tier's key, over any model plan resolved there before."""
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            while len(self._store) > self._max:
                evicted_key, _ = self._store.popitem(last=False)
                self.evictions += 1
                self._bucket(_family_of(evicted_key))["evictions"] += 1

    def family_stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {fam: dict(c) for fam, c in self._by_family.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def clear(self):
        with self._lock:
            self._store.clear()
            self._reset_counters_locked()

    def reset_stats(self):
        """Zero the counters but keep the entries."""
        with self._lock:
            self._reset_counters_locked()

    def _reset_counters_locked(self):
        self.hits = self.misses = self.evictions = 0
        self._by_family.clear()


KernelCache = LruCache

GLOBAL_KERNEL_CACHE = LruCache()
