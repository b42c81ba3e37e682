"""First-principles cold-start model (paper Eq. 1) and the restore planner.

    T_cold = max(c, bytes_unique / bw_store) + init + n_shared_faults · lat_mem

On the TPU fleet the same structure holds with one extra pipelined phase —
host→HBM DMA — folded into the ``max`` (both are restore bandwidth phases and
overlap, §3.2 "only the first two steps can occur concurrently"):

    T_cold = max(c, bytes_unique / bw_store, bytes_resident / bw_dma)
             + init + n_shared_faults · lat_host

The planner uses this model to (a) predict per-strategy cold-start latency
(validated against measured numbers in ``benchmarks/bench_breakdown.py``),
and (b) choose eager-vs-lazy placement per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .snapshot import ResolvedArray
from .workingset import WorkingSet

Path = str


@dataclass(frozen=True)
class StorageModel:
    """Hardware constants of a deployment tier."""

    name: str
    bw_store: float      # bytes/s — streaming bandwidth of the diff store
    lat_store: float     # s — per-request random-read latency of the store
    bw_mem: float        # bytes/s — host RAM copy bandwidth
    lat_mem: float       # s — host RAM access latency (CoW fault service)
    bw_dma: float        # bytes/s — host→device (HBM) DMA bandwidth
    preconfig: float     # s — constant instance pre-configuration cost (c)

    def eager_time(
        self,
        nbytes: int,
        nchunks: int = 1,
        split: Optional[Dict[str, int]] = None,
        shared_hit: float = 0.0,
    ) -> float:
        """One batched sequential read (readv).  ``split`` — bytes of the
        eager set per residency tier — is ignored by the flat model; the
        tiered subclass prices each stream at its own tier's constants.

        ``shared_hit`` is the content-addressed dedup discount for flat
        models: the fraction of the (unique) eager bytes expected to be
        served from the shared RAM chunk cache because a sibling function
        referencing the same digests already warmed them.  Those bytes
        stream at ``bw_mem``; only the rest pays the store."""
        if nbytes == 0:
            return 0.0
        shared_hit = min(max(shared_hit, 0.0), 1.0)
        store_bytes = nbytes * (1.0 - shared_hit)
        t = self.lat_store + store_bytes / self.bw_store
        if shared_hit > 0.0:
            t += (nbytes - store_bytes) / self.bw_mem
        return t

    def demand_time(self, nbytes: int, nchunks: int) -> float:
        """Synchronous per-chunk faults: latency-dominated."""
        return nchunks * self.lat_store + nbytes / self.bw_store

    def cow_time(self, nbytes: int, nfaults: int) -> float:
        return nfaults * self.lat_mem + nbytes / self.bw_mem


@dataclass(frozen=True)
class TierModel:
    """Constants of one level of a storage hierarchy (RAM / NVMe / remote)."""

    name: str            # must match the TieredChunkStore tier name
    bw_store: float      # bytes/s
    lat_store: float     # s per batched request

    def stream_time(self, nbytes: int) -> float:
        if nbytes == 0:
            return 0.0
        return self.lat_store + nbytes / self.bw_store


@dataclass(frozen=True)
class TieredStorageModel(StorageModel):
    """Eq. 1 over a storage hierarchy.

    The pipelined restore engine overlaps the per-tier streams (remote
    fetch, local ``preadv``, RAM memcpy), so the B term is the *max* of the
    per-tier stream times over the eager set's actual residency split —
    not their sum.  Bytes in the split not covered by a modelled tier fall
    back to the flat ``bw_store``/``lat_store`` constants.

    Residency splits may carry ``"<tier>!down"`` buckets — bytes whose
    holding tier's circuit breaker is open (see
    :meth:`~repro.core.tiers.TieredChunkStore.residency`).  Those bytes
    are priced at ``outage_penalty_s`` on top of the tier's healthy stream
    time: retries, breaker probes and repair reads make a dead tier
    catastrophically slow, and pricing it so is exactly what steers
    ``Strategy.AUTO`` toward strategies that avoid the dead tier.
    """

    tiers: Tuple[TierModel, ...] = ()
    outage_penalty_s: float = 30.0

    def eager_time(
        self,
        nbytes: int,
        nchunks: int = 1,
        split: Optional[Dict[str, int]] = None,
        shared_hit: float = 0.0,
    ) -> float:
        if nbytes == 0:
            return 0.0
        if not split or not self.tiers:
            # no measured residency: fall back to the flat pricing, which
            # still honours the expected shared-hit discount
            return super().eager_time(nbytes, nchunks, shared_hit=shared_hit)
        # the split is *measured* residency — shared chunks a sibling
        # already RAM-warmed show up in the "ram" bucket, so the discount
        # is already priced and shared_hit is deliberately ignored
        t = 0.0
        covered = 0
        for tm in self.tiers:
            b = split.get(tm.name, 0)
            covered += b
            if b:
                t = max(t, tm.stream_time(b))
            bd = split.get(tm.name + "!down", 0)
            if bd:
                covered += bd
                t = max(t, self.outage_penalty_s + tm.stream_time(bd))
        rest = nbytes - covered
        if rest > 0:
            t = max(t, self.lat_store + rest / self.bw_store)
        return t


# --- presets ---------------------------------------------------------------

# The paper's evaluation hardware: SATA SSD, 500 MB/s seq read, 50 us random.
PAPER_C220G5 = StorageModel(
    name="paper-c220g5", bw_store=500e6, lat_store=50e-6,
    bw_mem=60e9, lat_mem=100e-9, bw_dma=60e9, preconfig=5e-3,
)

# TPU v5e host tiers (targets for deployment; dry-run constants).
TPU_LOCAL_SSD = StorageModel(
    name="tpu-local-ssd", bw_store=3.0e9, lat_store=80e-6,
    bw_mem=80e9, lat_mem=100e-9, bw_dma=32e9, preconfig=3e-3,
)
TPU_OBJECT_STORE = StorageModel(
    name="tpu-object-store", bw_store=1.2e9, lat_store=5e-3,
    bw_mem=80e9, lat_mem=100e-9, bw_dma=32e9, preconfig=3e-3,
)

# A worker restoring through the full hierarchy: RAM chunk cache over local
# NVMe over a shared object store.  The flat constants (bw_store/lat_store)
# price bytes whose residency is unknown — conservatively, the local tier.
TPU_TIERED = TieredStorageModel(
    name="tpu-tiered", bw_store=3.0e9, lat_store=80e-6,
    bw_mem=80e9, lat_mem=100e-9, bw_dma=32e9, preconfig=3e-3,
    tiers=(
        TierModel(name="ram", bw_store=60e9, lat_store=2e-6),
        TierModel(name="local", bw_store=3.0e9, lat_store=80e-6),
        TierModel(name="remote", bw_store=1.2e9, lat_store=5e-3),
    ),
)


def calibrate_container(tmpdir: str, nbytes: int = 64 * 1024 * 1024) -> StorageModel:
    """Measure this container's actual constants (used by the real benches)."""
    import os
    import time

    import numpy as np

    path = os.path.join(tmpdir, "calib.bin")
    buf = np.random.randint(0, 255, nbytes, dtype=np.uint8)
    with open(path, "wb") as f:  # atomic-ok: throwaway calibration scratch file, not persistent state
        f.write(buf.tobytes())
        os.fsync(f.fileno())

    def _drop():
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)

    # sequential read bandwidth — from the medium, not the page cache
    _drop()
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        f.read()
    bw = nbytes / (time.perf_counter() - t0)
    # random chunk latency (cache dropped each probe)
    lats = []
    with open(path, "rb", buffering=0) as f:
        for i in range(16):
            _drop()
            f.seek((i * 9973 * 4096) % (nbytes - 4096))
            t0 = time.perf_counter()
            f.read(4096)
            lats.append(time.perf_counter() - t0)
    lat = float(np.median(lats))
    # mem copy bandwidth
    t0 = time.perf_counter()
    _ = buf.copy()
    bw_mem = nbytes / (time.perf_counter() - t0)
    os.unlink(path)
    return StorageModel(
        name="container-measured", bw_store=bw, lat_store=lat,
        bw_mem=bw_mem, lat_mem=200e-9, bw_dma=bw_mem, preconfig=1e-3,
    )


# ---------------------------------------------------------------------------
# Eq. 1 prediction per strategy
# ---------------------------------------------------------------------------

@dataclass
class ColdStartPrediction:
    strategy: str
    A: float  # max-term constant c
    B: float  # eager restore
    C: float  # residual init
    D: float  # demand + CoW during execution
    @property
    def total(self) -> float:
        return max(self.A, self.B) + self.C + self.D


@dataclass
class SnapshotSizes:
    """Byte-level facts the model consumes, derived from manifests."""

    full_bytes: int            # all non-zero chunks (REAP's full snapshot)
    diff_bytes: int            # unique (dirty) chunks only
    ws_bytes: int              # diff ∩ working set
    ws_full_bytes: int         # full-snapshot ∩ working set (REAP's eager set)
    ws_chunks: int
    non_ws_diff_bytes: int
    non_ws_diff_chunks: int
    shared_bytes: int          # base bytes mapped from RAM
    cow_bytes: int             # shared bytes written during execution
    cow_faults: int
    init_compute: float        # measured function-init compute time (SEUSS C)
    residual_init: float       # un-memoizable init (all strategies)
    exec_demand_miss_bytes: int = 0   # WS misses observed at runtime
    exec_demand_miss_chunks: int = 0
    # per-strategy eager-set residency: {"full"|"diff"|"ws"|"ws_full":
    # {tier name: bytes}} — measured from the TieredChunkStore, consumed by
    # TieredStorageModel.eager_time (empty → flat single-tier pricing)
    tier_splits: Dict[str, Dict[str, int]] = None  # type: ignore[assignment]
    # per-category fraction of the (unique) eager bytes that are shared
    # (digest refcount > 1: the base or a sibling function references the
    # same chunk) AND currently RAM-resident — the content-addressed
    # warm-hit discount a flat StorageModel applies when it has no
    # residency split to price from.  Byte counts above are digest-unique:
    # the scatter-read engine reads each digest once.
    shared_hit_fracs: Dict[str, float] = None  # type: ignore[assignment]
    # measured recording (REAP record mode): digest-unique bytes/chunks of
    # the recorded working set over the full snapshot — the prefetch volume
    # of a demand-paged restore.  ``has_recording`` gates Strategy.AUTO's
    # demand-paged choice: without a measured recording the synthetic WS is
    # not trustworthy enough to bet the B term on.
    recorded_bytes: int = 0
    recorded_chunks: int = 0
    has_recording: bool = False

    def split(self, key: str) -> Optional[Dict[str, int]]:
        if not self.tier_splits:
            return None
        return self.tier_splits.get(key)

    def shared_hit(self, key: str) -> float:
        if not self.shared_hit_fracs:
            return 0.0
        return self.shared_hit_fracs.get(key, 0.0)


def predict(strategy: str, s: SnapshotSizes, hw: StorageModel) -> ColdStartPrediction:
    def eager(key: str, nbytes: int) -> float:
        # unique bytes, the measured residency split (tiered models), and
        # the expected shared-hit discount (flat models) — see SnapshotSizes
        return hw.eager_time(nbytes, split=s.split(key),
                             shared_hit=s.shared_hit(key))

    if strategy == "regular":
        return ColdStartPrediction(
            strategy, A=hw.preconfig,
            B=eager("full", s.full_bytes),
            C=s.init_compute + s.residual_init, D=0.0,
        )
    if strategy == "reap":
        # full-function snapshot: WS eager, the rest demand-paged at runtime.
        return ColdStartPrediction(
            strategy, A=hw.preconfig,
            B=(eager("ws_full", s.ws_full_bytes) if s.ws_full_bytes
               else eager("full", s.full_bytes)),
            C=s.residual_init,
            D=hw.demand_time(s.exec_demand_miss_bytes, s.exec_demand_miss_chunks),
        )
    if strategy == "seuss":
        return ColdStartPrediction(
            strategy, A=hw.preconfig, B=0.0,
            C=s.init_compute + s.residual_init,
            D=hw.cow_time(s.cow_bytes, s.cow_faults),
        )
    if strategy == "snapfaas-":
        return ColdStartPrediction(
            strategy, A=hw.preconfig,
            B=eager("diff", s.diff_bytes),
            C=s.residual_init,
            D=hw.cow_time(s.cow_bytes, s.cow_faults),
        )
    if strategy == "snapfaas":
        return ColdStartPrediction(
            strategy, A=hw.preconfig,
            B=eager("ws", s.ws_bytes),
            C=s.residual_init,
            D=hw.cow_time(s.cow_bytes, s.cow_faults)
            + hw.demand_time(s.exec_demand_miss_bytes, s.exec_demand_miss_chunks),
        )
    raise ValueError(strategy)


def predict_demand_paged(
    strategy: str, s: SnapshotSizes, hw: StorageModel
) -> ColdStartPrediction:
    """Eq. 1 for the record-and-prefetch variant of a snapshot strategy.

    Demand paging removes the B term from the boot path entirely: the
    recorded set streams in the background while execution starts, so the
    request pays only the part of the stream that outlasts A + C, plus a
    per-chunk fault-service charge (every first access crosses the
    MaterializedArray fault path even on a RAM hit), plus the usual CoW and
    recorded-set-miss charges.  Everything lands in D — overlapped
    background work is execution-time slowdown, not boot latency:

        T_cold = A + C + max(0, stream − (A + C)) + faults + CoW + misses
    """
    if strategy not in ("reap", "snapfaas", "snapfaas-"):
        raise ValueError(
            f"demand paging applies to snapshot strategies, not {strategy!r}")
    if strategy == "reap":
        key, nbytes = "ws_full", (s.ws_full_bytes or s.full_bytes)
        cow = 0.0
    elif strategy == "snapfaas":
        key, nbytes = "ws", s.ws_bytes
        cow = hw.cow_time(s.cow_bytes, s.cow_faults)
    else:  # snapfaas-: background-eager over the whole diff
        key, nbytes = "diff", s.diff_bytes
        cow = hw.cow_time(s.cow_bytes, s.cow_faults)
    stream = hw.eager_time(nbytes, split=s.split(key),
                           shared_hit=s.shared_hit(key))
    nchunks = s.recorded_chunks or s.ws_chunks
    fault_service = nchunks * hw.lat_mem + nbytes / hw.bw_mem
    miss = hw.demand_time(s.exec_demand_miss_bytes, s.exec_demand_miss_chunks)
    A = hw.preconfig
    C = s.residual_init
    D = max(0.0, stream - (A + C)) + fault_service + cow + miss
    return ColdStartPrediction(
        strategy=strategy + "+demand", A=A, B=0.0, C=C, D=D,
    )


def lower_bound(s: SnapshotSizes, hw: StorageModel) -> float:
    """The paper's practical lower bound (§8): pre-config overlapped with the
    minimal unique-byte eager read, plus irreducible init."""
    return (
        max(hw.preconfig, hw.eager_time(s.ws_bytes, split=s.split("ws"),
                                        shared_hit=s.shared_hit("ws")))
        + s.residual_init
    )


# ---------------------------------------------------------------------------
# eager/lazy placement planner
# ---------------------------------------------------------------------------

@dataclass
class RestorePlan:
    eager: Set[Tuple[Path, int]]
    lazy: Set[Tuple[Path, int]]
    predicted_eager_s: float
    predicted_lazy_s: float


def plan_restore(
    resolved: Dict[Path, ResolvedArray],
    ws: Optional[WorkingSet],
    hw: StorageModel,
    *,
    miss_access_prob: float = 0.05,
) -> RestorePlan:
    """Per-chunk eager/lazy decision for the diff chunks.

    A chunk in the working set is accessed with probability ~1 → always
    eager (bandwidth cost beats a guaranteed synchronous fault).  A chunk
    outside the WS is accessed with small probability p → lazy iff

        p · (lat_store + size/bw)  <  size/bw        (marginal eager cost)

    which at typical p and chunk sizes keeps cold chunks on disk — exactly
    the paper's §3.2 conclusion, now *derived* instead of assumed.
    """
    eager: Set[Tuple[Path, int]] = set()
    lazy: Set[Tuple[Path, int]] = set()
    e_bytes = 0
    lazy_cost = 0.0
    for path, ra in resolved.items():
        for idx in ra.dirty_indices():
            _, ref = ra.sources[idx]
            if ref.zero:
                continue
            key = (path, idx)
            in_ws = ws is None or key in ws
            if in_ws:
                eager.add(key)
                e_bytes += ref.size
            else:
                p = miss_access_prob
                cost_if_lazy = p * (hw.lat_store + ref.size / hw.bw_store)
                cost_if_eager = ref.size / hw.bw_store
                if cost_if_lazy < cost_if_eager:
                    lazy.add(key)
                    lazy_cost += cost_if_lazy
                else:
                    eager.add(key)
                    e_bytes += ref.size
    return RestorePlan(
        eager=eager, lazy=lazy,
        predicted_eager_s=hw.eager_time(e_bytes),
        predicted_lazy_s=lazy_cost,
    )


# ---------------------------------------------------------------------------
# placement cost terms (Eq. 1 applied to scheduling)
# ---------------------------------------------------------------------------

def queue_wait_s(depth: int, mean_service_s: float, concurrency: int = 1) -> float:
    """Expected wait a request pays joining a lane with ``depth`` requests
    already queued, when the lane drains ``concurrency`` requests at a time
    with mean service time ``mean_service_s`` — the load half of a
    placement/stealing decision (the other half is Eq. 1's cold price)."""
    if depth <= 0:
        return 0.0
    return depth * max(mean_service_s, 0.0) / max(concurrency, 1)


def steal_breakeven(
    depth: int,
    mean_service_s: float,
    cold_cost_s: float,
    *,
    warm: bool = False,
    concurrency: int = 1,
) -> bool:
    """Is pulling a queued request to an idle lane worth it?

    Leaving the request at home pays the expected queue wait
    (:func:`queue_wait_s`); moving it pays the thief's re-cold-start
    price — zero if the function is already warm there, else the Eq. 1
    total the planner predicted for the best strategy.  Steal iff the
    wait strictly exceeds the price, so a warm thief always wins and a
    cold thief only wins when the victim's backlog is genuinely more
    expensive than one more cold start."""
    price = 0.0 if warm else max(cold_cost_s, 0.0)
    return queue_wait_s(depth, mean_service_s, concurrency) > price
