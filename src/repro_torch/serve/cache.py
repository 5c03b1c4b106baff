"""LRU cache of lowered programs / warm jitted runners, with counters.

A cache *hit* means a request batch reuses an existing compilation — the
whole point of the serving layer, since per-graph jit dominates small-graph
inference cost.  Every miss invokes the builder exactly once, so
``compiles`` is the miss count under a clearer name; tests assert it stays
flat after warmup.

The cache is **thread-safe** for the async serving tier: concurrent
``get_or_build`` calls for *different* keys build in parallel (overlapping
compilation across size classes is the point of the worker pool), while
concurrent calls for the *same* key build once — later arrivals block on
the in-flight build and count as hits (this is what lets a background
warmup compile race a real request without duplicating the jit).

Multi-tenancy: entries may carry an ``owner`` (the model a runner belongs
to) and :meth:`ProgramCache.set_budget` caps how many entries one owner may
hold — an owner over budget evicts its *own* LRU entry, so one chatty model
cannot evict another tenant's warm runners out of a shared cache.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, Iterator, Optional


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/eviction counters for one :class:`ProgramCache`."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def compiles(self) -> int:
        """Builder invocations — one per miss, by construction."""
        return self.misses

    @property
    def requests(self) -> int:
        """Total lookups (hits + misses)."""
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served warm (0.0 when no lookups yet)."""
        return self.hits / self.requests if self.requests else 0.0

    def as_dict(self) -> Dict[str, float]:
        """JSON-able view of every counter plus the derived rate."""
        return dict(hits=self.hits, misses=self.misses, compiles=self.compiles,
                    evictions=self.evictions, hit_rate=round(self.hit_rate, 4))


class ProgramCache:
    """Bounded LRU mapping structure signatures -> warm compiled runners.

    ``capacity`` bounds total entries; per-owner budgets (optional, see
    :meth:`set_budget`) additionally bound any one tenant's share.  All
    public methods are thread-safe; builders run *outside* the lock so
    distinct keys compile concurrently.
    """

    def __init__(self, capacity: int = 32):
        """Create an empty cache holding at most ``capacity`` entries.

        Raises:
            ValueError: if ``capacity`` is less than one.
        """
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._owners: Dict[Hashable, str] = {}
        self._budgets: Dict[str, int] = {}
        self._building: Dict[Hashable, threading.Event] = {}
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> Iterator[Hashable]:
        """Iterate over the cached keys (snapshot, LRU -> MRU order)."""
        with self._lock:
            return iter(list(self._entries.keys()))

    # -------------------------------------------------------- multi-tenancy
    def set_budget(self, owner: str, max_entries: int) -> None:
        """Cap how many entries ``owner`` may hold at once.

        An insert that takes the owner over budget evicts the owner's own
        least-recently-used entry first; other tenants are untouched.

        Raises:
            ValueError: if ``max_entries`` is less than one.
        """
        if max_entries < 1:
            raise ValueError("budget must be >= 1")
        with self._lock:
            self._budgets[owner] = int(max_entries)

    def owner_counts(self) -> Dict[str, int]:
        """Entries currently held per owner (unowned entries under ``""``)."""
        with self._lock:
            out: Dict[str, int] = {}
            for key in self._entries:
                own = self._owners.get(key, "")
                out[own] = out.get(own, 0) + 1
            return out

    # --------------------------------------------------------------- lookup
    def get(self, key: Hashable) -> Optional[Any]:
        """Peek without counting a request (no builder, no LRU eviction)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            return None

    def get_or_build(self, key: Hashable, builder: Callable[[], Any],
                     owner: Optional[str] = None) -> Any:
        """Return the cached value for ``key``, building it on first miss.

        Args:
            key: hashable structure signature.
            builder: zero-arg callable producing the value; invoked at most
                once per distinct key across all threads (a failed build
                releases the key so a later call may retry).
            owner: optional tenant tag for per-owner eviction budgets.

        Returns:
            The cached (or freshly built) value.
        """
        while True:
            with self._lock:
                if key in self._entries:
                    self.stats.hits += 1
                    self._entries.move_to_end(key)
                    return self._entries[key]
                pending = self._building.get(key)
                if pending is None:
                    self._building[key] = threading.Event()
                    self.stats.misses += 1
                    break
            # another thread is building this key: wait, then re-check (the
            # re-check counts as a hit — we never invoked the builder)
            pending.wait()
        try:
            value = builder()
        except BaseException:
            with self._lock:
                self._building.pop(key).set()     # unblock waiters; they retry
            raise
        with self._lock:
            self._entries[key] = value
            if owner is not None:
                self._owners[key] = owner
            self._evict_locked(owner)
            self._building.pop(key).set()
        return value

    def _evict_locked(self, owner: Optional[str]) -> None:
        """Apply the owner budget (if any) then the global capacity."""
        budget = self._budgets.get(owner) if owner is not None else None
        if budget is not None:
            while sum(1 for k in self._entries
                      if self._owners.get(k) == owner) > budget:
                victim = next(k for k in self._entries
                              if self._owners.get(k) == owner)
                self._drop_locked(victim)
        while len(self._entries) > self.capacity:
            self._drop_locked(next(iter(self._entries)))

    def _drop_locked(self, key: Hashable) -> None:
        del self._entries[key]
        self._owners.pop(key, None)
        self.stats.evictions += 1

    # ------------------------------------------------------------- plumbing
    def clear(self) -> None:
        """Drop every entry (counters are kept; see :meth:`reset_counters`)."""
        with self._lock:
            self._entries.clear()
            self._owners.clear()

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction counters without touching entries."""
        with self._lock:
            self.stats = CacheStats()
