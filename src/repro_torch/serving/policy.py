"""Warm-pool residency policies and the policy-driven :class:`InstancePool`.

The paper's Fig. 7 memory/throughput trade hinges on what the controller
keeps warm under a RAM budget.  The seed hard-coded LRU; this module makes
the policy pluggable:

* :class:`LRUPolicy` — the classic recency stack (seed behaviour);
* :class:`GDSFPolicy` — Greedy-Dual-Size-Frequency: residency priority
  ``H = clock + freq * cost / size`` where ``cost`` is the *predicted
  re-cold-start latency* from the Eq. 1 planner.  Functions that are
  popular and expensive to re-boot out-prioritise cheap adapters even when
  recently touched — the cache literature's answer to skewed traces;
* :class:`TTLPolicy` — keep-warm grace window (the paper's §2.1 fixed-TTL
  baseline): entries expire ``ttl_s`` after last touch, eviction order is
  earliest expiry.

:class:`InstancePool` delegates every residency decision to its policy and
keeps honest accounting: ``put`` returns ``False`` (and counts a
rejection) when an instance cannot be cached — including the silent-drop
case the seed had, where an instance larger than the *whole* budget
evicted everything and then vanished without the caller learning.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable


@runtime_checkable
class PoolPolicy(Protocol):
    """Residency-ordering strategy for :class:`InstancePool`.

    The pool owns budget accounting and the instance map; the policy owns
    *ordering*: which resident function is evicted next, and whether an
    entry has aged out.
    """

    def on_admit(self, fn: str, nbytes: int, cost: float) -> None:
        """``fn`` became resident (``cost`` = predicted re-cold-start s)."""
        ...

    def on_refresh(self, fn: str, nbytes: int, cost: float) -> None:
        """A resident ``fn`` was re-put (end-of-request accounting update);
        NOT a new access — frequency policies must not count it."""
        ...

    def on_access(self, fn: str) -> None:
        """``fn`` served a warm hit."""
        ...

    def on_evict(self, fn: str) -> None:
        """``fn`` was evicted to make room (aging policies may react)."""
        ...

    def on_remove(self, fn: str) -> None:
        """``fn`` left the pool without an eviction decision (explicit drop,
        or a re-put refreshing its accounting)."""
        ...

    def victim(self) -> Optional[str]:
        """Next function to evict (None if the policy tracks nothing)."""
        ...

    def expired(self, fn: str) -> bool:
        """Has ``fn`` aged out? (time-based policies only)"""
        ...


class LRUPolicy:
    """Evict the least-recently-used function (seed behaviour)."""

    def __init__(self) -> None:
        self._order: "OrderedDict[str, None]" = OrderedDict()

    def on_admit(self, fn: str, nbytes: int, cost: float) -> None:
        self._order[fn] = None
        self._order.move_to_end(fn)

    on_refresh = on_admit

    def on_access(self, fn: str) -> None:
        if fn in self._order:
            self._order.move_to_end(fn)

    def on_evict(self, fn: str) -> None:
        self._order.pop(fn, None)

    on_remove = on_evict

    def victim(self) -> Optional[str]:
        return next(iter(self._order), None)

    def expired(self, fn: str) -> bool:
        return False


class GDSFPolicy:
    """Greedy-Dual-Size-Frequency, cost = predicted re-cold-start latency.

    Priority ``H(fn) = L + freq(fn) * cost(fn) / size(fn)``; evict the
    minimum-H entry and raise the clock ``L`` to its H (the aging term that
    lets new entries compete with long-resident ones).  ``size`` is scaled
    to MiB so priorities stay in a sane float range.
    """

    def __init__(self) -> None:
        self.clock = 0.0
        self._h: Dict[str, float] = {}
        self._freq: Dict[str, int] = {}
        self._cost: Dict[str, float] = {}
        self._size: Dict[str, int] = {}

    def _priority(self, fn: str) -> float:
        size_mib = max(self._size[fn], 1) / float(1 << 20)
        return self.clock + self._freq[fn] * self._cost[fn] / size_mib

    def on_admit(self, fn: str, nbytes: int, cost: float) -> None:
        self._freq[fn] = self._freq.get(fn, 0) + 1
        self._cost[fn] = max(cost, 1e-9)
        self._size[fn] = nbytes
        self._h[fn] = self._priority(fn)

    def on_refresh(self, fn: str, nbytes: int, cost: float) -> None:
        # accounting update only (size may change, e.g. a device copy
        # appeared): the warm hit was already counted by on_access
        self._freq.setdefault(fn, 1)
        self._cost[fn] = max(cost, 1e-9)
        self._size[fn] = nbytes
        self._h[fn] = self._priority(fn)

    def on_access(self, fn: str) -> None:
        if fn in self._h:
            self._freq[fn] += 1
            self._h[fn] = self._priority(fn)

    def on_evict(self, fn: str) -> None:
        # canonical GDSF: only a true eviction raises the clock (to the
        # victim's H) — refreshes/drops must not, or the clock races ahead
        # on every warm hit and the policy degenerates to recency order
        h = self._h.pop(fn, None)
        if h is not None:
            self.clock = max(self.clock, h)
        self._size.pop(fn, None)
        # frequency/cost survive eviction: a re-admitted function resumes
        # its history (the "F" in GDSF is lifetime frequency)

    def on_remove(self, fn: str) -> None:
        self._h.pop(fn, None)
        self._size.pop(fn, None)

    def victim(self) -> Optional[str]:
        if not self._h:
            return None
        return min(self._h, key=self._h.get)

    def expired(self, fn: str) -> bool:
        return False


class TTLPolicy:
    """Fixed keep-warm grace window; eviction order = earliest expiry."""

    def __init__(self, ttl_s: float = 600.0,
                 clock: Optional[callable] = None) -> None:
        self.ttl_s = ttl_s
        self._clock = clock or time.monotonic
        self._deadline: Dict[str, float] = {}

    def on_admit(self, fn: str, nbytes: int, cost: float) -> None:
        self._deadline[fn] = self._clock() + self.ttl_s

    on_refresh = on_admit

    def on_access(self, fn: str) -> None:
        if fn in self._deadline:
            self._deadline[fn] = self._clock() + self.ttl_s

    def on_evict(self, fn: str) -> None:
        self._deadline.pop(fn, None)

    on_remove = on_evict

    def victim(self) -> Optional[str]:
        if not self._deadline:
            return None
        return min(self._deadline, key=self._deadline.get)

    def expired(self, fn: str) -> bool:
        dl = self._deadline.get(fn)
        return dl is not None and self._clock() > dl


POLICIES = {"lru": LRUPolicy, "gdsf": GDSFPolicy, "ttl": TTLPolicy}


def make_policy(name: str, **kw) -> PoolPolicy:
    try:
        return POLICIES[name](**kw)
    except KeyError:
        raise ValueError(
            f"unknown pool policy {name!r}; one of {sorted(POLICIES)}"
        ) from None


class InstancePool:
    """Warm instances under a memory budget, residency ordered by a
    :class:`PoolPolicy` (the paper's keep-warm behaviour; Fig. 7's
    memory/throughput trade).  Thread-safe: one cluster worker serves
    many concurrent functions."""

    def __init__(self, budget_bytes: int, policy: Optional[PoolPolicy] = None):
        self.budget = budget_bytes
        self.policy = policy or LRUPolicy()
        self._pool: Dict[str, Tuple[object, int]] = {}
        self.used = 0
        self._lock = threading.RLock()
        # counters (surfaced in Cluster.metrics / bench rows)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejections = 0

    def __len__(self) -> int:
        return len(self._pool)

    def contains(self, fn: str) -> bool:
        """Non-counting residency probe: is ``fn`` warm right now?  Unlike
        :meth:`get`, this neither bumps the hit/miss counters nor touches
        policy recency — the scheduler's placement and steal gates ask
        constantly, and those probes must not distort keep-alive stats or
        eviction order."""
        with self._lock:
            return fn in self._pool and not self.policy.expired(fn)

    def get(self, fn: str):
        with self._lock:
            item = self._pool.get(fn)
            if item is not None and self.policy.expired(fn):
                self._evict(fn)
                item = None
            if item is None:
                self.misses += 1
                return None
            self.hits += 1
            self.policy.on_access(fn)
            return item[0]

    def put(self, fn: str, inst, nbytes: int, *, cost: float = 0.0) -> bool:
        """Cache ``inst`` under the budget.  Returns ``False`` when the
        instance could not be kept warm (larger than the whole budget, or
        the policy refused to clear room) — callers surface this so an
        always-cold function is visible in metrics instead of silently
        re-booting forever."""
        with self._lock:
            refresh = fn in self._pool    # re-put refreshes size accounting
            if refresh:
                self._evict(fn, count=False)
            if nbytes > self.budget:
                self.rejections += 1
                return False
            while self.used + nbytes > self.budget:
                victim = self.policy.victim()
                if victim is None or victim not in self._pool:
                    break
                self._evict(victim)
            if self.used + nbytes > self.budget:
                self.rejections += 1
                return False
            self._pool[fn] = (inst, nbytes)
            self.used += nbytes
            if refresh:
                self.policy.on_refresh(fn, nbytes, cost)
            else:
                self.policy.on_admit(fn, nbytes, cost)
            return True

    def drop(self, fn: str) -> None:
        with self._lock:
            if fn in self._pool:
                self._evict(fn, count=False)

    def size_of(self, fn: str) -> Optional[int]:
        """Bytes charged against the budget for ``fn`` (None if not resident)."""
        with self._lock:
            item = self._pool.get(fn)
            return item[1] if item is not None else None

    def _evict(self, fn: str, count: bool = True) -> None:
        inst, nb = self._pool.pop(fn)
        self.used -= nb
        if count:
            self.policy.on_evict(fn)
            self.evictions += 1
        else:
            self.policy.on_remove(fn)

    @property
    def warm_hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._pool),
                "used_bytes": self.used,
                "budget_bytes": self.budget,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejections": self.rejections,
                "warm_hit_rate": round(self.warm_hit_rate, 4),
                "policy": type(self.policy).__name__,
            }
