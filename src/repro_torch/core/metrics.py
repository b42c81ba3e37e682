"""Cold-start metrics: the A/B/C/D breakdown of the paper's Table 2.

    T_cold = max(c, bytes_unique / bw_store) + init + faults_shared · lat_mem
             └──A──┘ └────────B────────────┘  └─C─┘  └──────────D──────────┘

A — instance pre-configuration (buffer allocation, device-state restore)
B — eager restoration from storage (batched, bandwidth-bound)
C — residual, un-memoizable initialization (KV alloc, RNG, channels)
D — execution-time slowdown: demand-paged chunks + copy-on-write faults
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class _Timer:
    __slots__ = ("t0",)

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


@dataclass
class ColdStartMetrics:
    strategy: str = ""
    function: str = ""
    # A: pre-configuration
    t_preconfig: float = 0.0
    # B: eager restore
    t_eager: float = 0.0
    eager_bytes: int = 0
    eager_chunks: int = 0
    # content-addressed dedup: bytes actually read after collapsing
    # duplicate digests (the scatter-read engine reads each digest once,
    # however many chunks reference it); equals eager_bytes when the eager
    # set shares nothing with itself
    eager_unique_bytes: int = 0
    # C: residual init
    t_init: float = 0.0
    # D: execution-time restoration overhead
    t_demand: float = 0.0
    demand_bytes: int = 0
    demand_chunks: int = 0
    t_cow: float = 0.0
    cow_faults: int = 0
    cow_bytes: int = 0
    # execution
    t_exec: float = 0.0
    # extra bookkeeping
    shared_bytes_mapped: int = 0  # base bytes served from the in-RAM pool
    # tier breakdown of the B phase (tiered stores only): which storage tier
    # served how much of the eager set, remote-link time, and bytes promoted
    # downward as a side effect of this restore
    tier_chunks: Dict[str, int] = field(default_factory=dict)
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    remote_fetch_s: float = 0.0
    promoted_bytes: int = 0
    # recovery work the B phase absorbed (fault injection / real faults):
    # tier-read retries beyond the first attempt, and chunks healed from
    # another tier or a shared base after a failed or corrupt read
    read_retries: int = 0
    repaired_chunks: int = 0
    # demand-paged restore (REAP-style record-and-prefetch): the recorded
    # set is prefetched in the background while execution starts; chunks the
    # recording *missed* fault in on first access, and recorded chunks the
    # execution never touched were prefetched for nothing
    demand_paged: bool = False
    prefetch_bytes: int = 0
    demand_faults: int = 0
    demand_fault_bytes: int = 0
    false_prefetch_bytes: int = 0

    @property
    def boot_latency(self) -> float:
        """VMM-start → ready-to-accept (Fig. 5a)."""
        return self.t_preconfig + self.t_eager + self.t_init

    @property
    def exec_latency(self) -> float:
        """request-sent → response (Fig. 5b); includes D overheads."""
        return self.t_exec

    @property
    def d_overhead(self) -> float:
        return self.t_demand + self.t_cow

    @property
    def end_to_end(self) -> float:
        """Fig. 5c — the metric that matters for FaaS."""
        return self.boot_latency + self.t_exec

    def breakdown_ms(self) -> Dict[str, float]:
        return {
            "A": self.t_preconfig * 1e3,
            "B": self.t_eager * 1e3,
            "C": self.t_init * 1e3,
            "D": self.d_overhead * 1e3,
            "exec": self.t_exec * 1e3,
            "e2e": self.end_to_end * 1e3,
        }

    def row(self) -> Dict[str, object]:
        r: Dict[str, object] = {"strategy": self.strategy, "function": self.function}
        r.update({k: round(v, 3) for k, v in self.breakdown_ms().items()})
        r.update(
            eager_bytes=self.eager_bytes,
            eager_unique_bytes=self.eager_unique_bytes,
            demand_chunks=self.demand_chunks,
            cow_faults=self.cow_faults,
            shared_bytes=self.shared_bytes_mapped,
        )
        if self.tier_bytes:
            r["tier_bytes"] = dict(self.tier_bytes)
            r["remote_fetch_ms"] = round(self.remote_fetch_s * 1e3, 3)
            r["promoted_bytes"] = self.promoted_bytes
        if self.read_retries or self.repaired_chunks:
            r["read_retries"] = self.read_retries
            r["repaired_chunks"] = self.repaired_chunks
        if self.demand_paged:
            r["demand_paged"] = True
            r["prefetch_bytes"] = self.prefetch_bytes
            r["demand_faults"] = self.demand_faults
            r["demand_fault_bytes"] = self.demand_fault_bytes
            r["false_prefetch_bytes"] = self.false_prefetch_bytes
        return r


def timer() -> _Timer:
    return _Timer()
