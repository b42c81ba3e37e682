"""Tiered chunk storage: RAM cache over local packs over a remote store.

The paper's Eq. 1 charges eager restoration at ``bytes_unique / bw_store`` —
but *which* ``bw_store`` depends on where the bytes live.  Real fleets
restore from a hierarchy: a host-RAM chunk cache (~GB/s memcpy), local NVMe
packs (the existing coalesced-``preadv`` engine), and a shared remote tier
(an object store: high latency, throttled bandwidth, snapshots that were not
born on this worker).  Prior snapshot systems get their wins from exactly
this structure — record-and-prefetch across the hierarchy (REAP,
arXiv:2101.09355) and loading only what the critical path needs (FaaSLight,
arXiv:2207.08175).

This module composes three :class:`StorageTier` implementations behind one
:class:`TieredChunkStore` that is drop-in for :class:`ChunkStore`:

* :class:`RamCacheTier`    — bounded, digest-keyed LRU byte cache; hits are
  a single memcpy into the destination buffer; evictions are counted.
* :class:`PackTier`        — today's local pack directory and zero-copy
  scatter-read engine, unchanged.
* :class:`RemoteTier`      — a second pack directory behind a configurable
  latency/bandwidth throttle (shared-line model: concurrent fetches queue
  on aggregate bandwidth, each request pays its own latency).

``read_batch_into`` serves each destination from the warmest tier holding
its digest, *pipelined*: remote fetches are issued first (the long pole),
local coalesced ``preadv`` runs overlap them, RAM hits memcpy last, and the
call completes when all three streams land.  Remote payloads are promoted
downward (appended to a local promotion pack + inserted into the RAM cache)
in the background so the next restore finds them warm.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    TimeoutError as _FutureTimeout,
    wait as _wait_futures,
)
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from .chunkstore import (
    COALESCE_GAP,
    _ZERO_DIGEST,
    ChunkRef,
    ChunkStore,
    PackWriter,
    _get_io_pool,
    chunk_digest,
    digest_many,
)
from .faults import (
    ChunkIntegrityError,
    CircuitBreaker,
    DeadlineExceededError,
    FaultInjector,
    RetryPolicy,
    TierReadError,
    TierUnavailableError,
)

# RAM-tier reads above this size fan the memcpys across the I/O pool:
# fresh destination buffers page-fault on first write, and parallel copies
# absorb those faults the same way the preadv path does.
_RAM_PARALLEL_BYTES = 4 * 1024 * 1024

_fetch_pool: Optional[ThreadPoolExecutor] = None
_fetch_lock = threading.Lock()


def _get_fetch_pool() -> ThreadPoolExecutor:
    global _fetch_pool
    with _fetch_lock:
        if _fetch_pool is None:
            _fetch_pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="tier-fetch"
            )
    return _fetch_pool


# Hedged remote fetches run on their own small pool: the primary attempt may
# already be occupying a tier-fetch thread, and a hedge queued behind it on
# the same pool could never win the race it exists to run.
_hedge_pool: Optional[ThreadPoolExecutor] = None
_hedge_lock = threading.Lock()


def _get_hedge_pool() -> ThreadPoolExecutor:
    global _hedge_pool
    with _hedge_lock:
        if _hedge_pool is None:
            _hedge_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tier-hedge"
            )
    return _hedge_pool


@dataclass(frozen=True)
class TierSpec:
    """Configuration of a worker's storage hierarchy."""

    ram_bytes: int = 256 << 20          # RAM chunk-cache capacity (0 → off)
    remote_root: Optional[str] = None   # default: <store root>/remote
    remote_bw: float = 1.2e9            # bytes/s — simulated object store
    remote_lat: float = 5e-3            # s per fetch request
    promote_on_fetch: bool = True       # remote hits promote downward
    #: digest-verify every chunk read; corrupt payloads are quarantined and
    #: repaired from another tier / a shared base, never silently served
    verify_reads: bool = True
    retry: Optional[RetryPolicy] = None     # None → RetryPolicy() defaults
    faults: Optional[FaultInjector] = None  # chaos: wrap stream tiers


@dataclass
class TierReadStats:
    """Per-read outcome: which tier served how much (one restore's B phase)."""

    tier_chunks: Dict[str, int] = field(default_factory=dict)
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    remote_fetch_s: float = 0.0
    promoted_bytes: int = 0
    retries: int = 0            # tier-read attempts beyond the first
    repaired_chunks: int = 0    # chunks healed from another tier / base
    repaired_bytes: int = 0
    verify_failures: int = 0    # digest mismatches detected

    def add(self, tier: str, chunks: int, nbytes: int) -> None:
        self.tier_chunks[tier] = self.tier_chunks.get(tier, 0) + chunks
        self.tier_bytes[tier] = self.tier_bytes.get(tier, 0) + nbytes


class StorageTier(Protocol):
    """One level of the restore hierarchy that streams payloads from a
    medium (pack file, remote link).

    Stream tiers answer residency (``has``) and serve reads into
    caller-provided buffers (``read_into``).  Movement between tiers
    (promotion, demotion, prefetch) is orchestrated by
    :class:`TieredChunkStore` — tiers stay dumb so new ones (e.g. a
    peer-to-peer tier) slot in without touching the restore engine.  The
    RAM cache deliberately sits outside this protocol: the composed store
    grabs its payloads at classification time so a concurrent eviction can
    never strand a read mid-flight.
    """

    name: str

    def has(self, digest: str) -> bool:
        ...

    def read_into(self, items: Sequence[Tuple[ChunkRef, memoryview]]) -> int:
        """Fill each destination view with its chunk's payload; returns
        bytes read from this tier's medium."""
        ...


class RamCacheTier:
    """Bounded digest-keyed LRU byte cache (the warmest tier).

    Thread-safe.  ``put`` refuses payloads larger than the whole capacity
    and evicts LRU entries (counted) until the new payload fits.

    ``on_residency_change`` (optional) fires after mutations that *remove*
    resident digests — LRU evictions, discards, clear — *outside* the
    tier lock.  The composed store wires it to its ``residency_epoch``
    bump so cached restore plans and Eq. 1 tables learn that a residency
    snapshot naming this tier went stale; without it, LRU evictions were
    the one tier movement nothing advertised.  Plain insertions do NOT
    fire (a split that misses a fresh insertion is only conservatively
    stale — the chunk reads fine from a colder tier — and per-insert
    bumps would invalidate every cached plan on every demand fault); the
    batch movement operations that insert (prefetch, promotion) advertise
    themselves instead.
    """

    name = "ram"

    def __init__(self, capacity_bytes: int,
                 on_residency_change: Optional[callable] = None):
        self.capacity = capacity_bytes
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()
        self.used = 0
        self._lock = threading.Lock()
        self._on_change = on_residency_change
        self.hits = 0
        self.hit_bytes = 0
        self.evictions = 0
        self.insertions = 0

    def _changed(self) -> None:
        if self._on_change is not None:
            self._on_change()

    def has(self, digest: str) -> bool:
        with self._lock:
            return digest in self._cache

    def get(self, digest: str) -> Optional[bytes]:
        with self._lock:
            payload = self._cache.get(digest)
            if payload is None:
                return None
            self._cache.move_to_end(digest)
            self.hits += 1
            self.hit_bytes += len(payload)
            return payload

    def put(self, digest: str, payload: bytes) -> bool:
        n = len(payload)
        if n > self.capacity:
            return False
        evicted = 0
        with self._lock:
            if digest in self._cache:
                self._cache.move_to_end(digest)
                return True
            while self.used + n > self.capacity and self._cache:
                _, old = self._cache.popitem(last=False)
                self.used -= len(old)
                self.evictions += 1
                evicted += 1
            self._cache[digest] = payload
            self.used += n
            self.insertions += 1
        if evicted:
            self._changed()
        return True

    def discard(self, digests: Iterable[str]) -> None:
        removed = 0
        with self._lock:
            for d in digests:
                old = self._cache.pop(d, None)
                if old is not None:
                    self.used -= len(old)
                    removed += 1
        if removed:
            self._changed()

    def clear(self) -> None:
        with self._lock:
            had = bool(self._cache)
            self._cache.clear()
            self.used = 0
        if had:
            self._changed()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity_bytes": self.capacity,
                "used_bytes": self.used,
                "entries": len(self._cache),
                "hits": self.hits,
                "hit_bytes": self.hit_bytes,
                "evictions": self.evictions,
                "insertions": self.insertions,
            }


class PackTier:
    """The local pack directory + coalesced-``preadv`` scatter-read engine."""

    name = "local"

    def __init__(self, store: ChunkStore):
        self.store = store

    def has(self, digest: str) -> bool:
        return digest in self.store

    def read_into(
        self,
        items: Sequence[Tuple[ChunkRef, memoryview]],
        *,
        parallel: bool = True,
        coalesce_gap: int = COALESCE_GAP,
    ) -> int:
        return self.store.read_batch_into(
            list(items), parallel=parallel, coalesce_gap=coalesce_gap
        )


class RemoteTier:
    """Simulated object store: a second pack directory behind a throttle.

    The throttle uses a shared-line model: a single lock-protected
    ``line_free`` timestamp serializes aggregate bandwidth (concurrent
    fetches queue their transfer time on the line), while each request
    additionally pays its own ``lat`` before first byte — the behaviour of
    a bandwidth-capped store link with per-request latency.
    """

    name = "remote"

    def __init__(self, store: ChunkStore, *, bw: float, lat: float):
        self.store = store
        self.bw = bw
        self.lat = lat
        self._line_lock = threading.Lock()
        self._line_free = 0.0
        self.fetches = 0
        self.fetched_bytes = 0
        self.fetch_s = 0.0

    def has(self, digest: str) -> bool:
        return digest in self.store

    def _throttle(self, nbytes: int, t_start: float) -> None:
        """Sleep until the simulated transfer would have completed."""
        with self._line_lock:
            start = max(t_start, self._line_free)
            done = start + (nbytes / self.bw if self.bw > 0 else 0.0)
            self._line_free = done
        deadline = done + self.lat
        delay = deadline - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

    def read_into(self, items: Sequence[Tuple[ChunkRef, memoryview]]) -> int:
        t0 = time.perf_counter()
        n = self.store.read_batch_into(list(items))
        self._throttle(n, t0)
        dt = time.perf_counter() - t0
        with self._line_lock:
            self.fetches += 1
            self.fetched_bytes += n
            self.fetch_s += dt
        return n

    def stats(self) -> Dict[str, float]:
        with self._line_lock:
            return {
                "bw_bytes_s": self.bw,
                "lat_s": self.lat,
                "fetches": self.fetches,
                "fetched_bytes": self.fetched_bytes,
                "fetch_s": round(self.fetch_s, 6),
            }


@dataclass
class PrefetchStats:
    """Outcome of one working-set prefetch (registration / shard assignment)."""

    prefetched_bytes: int = 0
    prefetched_chunks: int = 0
    remote_bytes: int = 0       # bytes that had to cross the remote link
    remote_fetch_s: float = 0.0
    already_warm: int = 0       # chunks already RAM-resident


class TieredChunkStore:
    """RAM / local-pack / remote hierarchy behind the ``ChunkStore`` API.

    Writes (snapshot capture) land in the local pack tier, exactly as
    before.  Reads are served per-tier — see module docstring.  The store
    tracks a ``residency_epoch`` that bumps on any tier movement (promotion,
    demotion, prefetch, RAM clear) so cached restore plans and Eq. 1
    prediction tables know when their placement assumptions went stale.
    """

    def __init__(self, root: str, *, spec: Optional[TierSpec] = None):
        self.root = root
        self.spec = spec or TierSpec()
        self._lock = threading.Lock()   # before any tier that may call back
        self.residency_epoch = 0
        self.faults = self.spec.faults
        self.retry = self.spec.retry or RetryPolicy()
        self._retry_lock = threading.Lock()
        self._retry_rng = np.random.default_rng(0x5EED)
        self.local = ChunkStore(root)
        self.pack = PackTier(self.local)
        if self.faults is not None:
            self.pack = self.faults.wrap_tier(self.pack)
        # RAM-tier removals (LRU evictions, discards) are tier movement
        # like any other: advertise them on the residency epoch so a
        # plan's tier_split can never silently claim an evicted digest
        self.ram = RamCacheTier(self.spec.ram_bytes,
                                on_residency_change=self._bump_epoch)
        # per-stream-tier health gates; a state transition is placement
        # information (an open remote breaker reprices every restore plan),
        # so it rides the same residency-epoch bus as tier movement
        self.breakers: Dict[str, CircuitBreaker] = {
            t: CircuitBreaker(t, on_state_change=self._on_breaker_change)
            for t in ("local", "remote")
        }
        remote_root = self.spec.remote_root or os.path.join(root, "remote")
        self._remote_root = remote_root
        self._remote = None
        if os.path.isdir(os.path.join(remote_root, "packs")):
            self._remote = self._make_remote()
        self._promote_pack: Optional[PackWriter] = None   # guarded-by: _lock
        self._promote_seq = 0                             # guarded-by: _lock
        self._promote_futures: List[Future] = []          # guarded-by: _lock
        # telemetry counters: plain += is a read-modify-write, so racing
        # readers lose increments; a dedicated leaf lock (never held while
        # calling into any tier) keeps the health numbers exact
        self._stats_lock = threading.Lock()
        self.promoted_bytes = 0                 # guarded-by: _stats_lock
        self.promoted_chunks = 0                # guarded-by: _stats_lock
        self.demoted_bytes = 0                  # guarded-by: _stats_lock
        self.prefetched_bytes = 0               # guarded-by: _stats_lock
        self.prefetch_fetch_s = 0.0             # guarded-by: _stats_lock
        self.prefetch_skipped_chunks = 0        # guarded-by: _stats_lock
        # recovery accounting (surfaced via tier_stats()["health"])
        self.verified_chunks = 0                # guarded-by: _stats_lock
        self.verify_failures = 0                # guarded-by: _stats_lock
        self.repaired_chunks = 0                # guarded-by: _stats_lock
        self.repaired_bytes = 0                 # guarded-by: _stats_lock
        self.read_retries = 0                   # guarded-by: _stats_lock
        self.fail_fast_reads = 0                # guarded-by: _stats_lock
        self.hedged_fetches = 0                 # guarded-by: _stats_lock
        self.hedge_wins = 0                     # guarded-by: _stats_lock
        self.quarantined: set = set()   # (digest, tier)  # guarded-by: _stats_lock
        self._fallback_sources: List = []       # guarded-by: _lock

    # ------------------------------------------------------------ tier admin

    def _make_remote(self):
        remote = RemoteTier(
            ChunkStore(self._remote_root),
            bw=self.spec.remote_bw, lat=self.spec.remote_lat,
        )
        if self.faults is not None:
            return self.faults.wrap_tier(remote)
        return remote

    @property
    def remote(self) -> RemoteTier:
        """The remote tier (created on first use — demotion or a
        pre-populated ``remote_root``)."""
        with self._lock:
            if self._remote is None:
                self._remote = self._make_remote()
            return self._remote

    @property
    def has_remote(self) -> bool:
        return self._remote is not None

    def tier_of(self, digest: str) -> Optional[str]:
        """Warmest tier holding ``digest`` (None → unknown digest)."""
        if self.ram.has(digest):
            return "ram"
        if digest in self.local:
            return "local"
        if self._remote is not None and self._remote.has(digest):
            return "remote"
        return None

    def residency(self, refs: Sequence[ChunkRef]) -> Dict[str, int]:
        """Bytes of ``refs`` resident per tier (zero chunks excluded; each
        digest counted once — this is the planner's Eq. 1 input).

        A tier whose circuit breaker is open reports under ``"<tier>!down"``
        so the planner can price reads against a dead tier at its outage
        penalty instead of its healthy bandwidth — that is how breaker state
        steers ``Strategy.AUTO`` and ``restore_plan`` around the outage."""
        split: Dict[str, int] = {}
        seen = set()
        down = {t for t, b in self.breakers.items() if b.is_open}
        for ref in refs:
            if ref.zero or ref.digest in seen:
                continue
            seen.add(ref.digest)
            tier = self.tier_of(ref.digest)
            if tier is not None:
                key = tier + "!down" if tier in down else tier
                split[key] = split.get(key, 0) + ref.size
        return split

    def _bump_epoch(self) -> None:
        with self._lock:
            self.residency_epoch += 1

    def _on_breaker_change(self, name: str, state: str) -> None:
        # breaker transitions change what a read of this tier costs: cached
        # restore plans and AUTO's Eq. 1 tables must re-derive their splits
        self._bump_epoch()

    def add_fallback_source(self, source) -> None:
        """Register a last-resort repair source: ``source(ref) -> bytes | None``
        re-synthesizes a chunk payload from outside the tier hierarchy (the
        registry wires in the shared base pool, so base-content chunks heal
        even when every stream tier has lost or corrupted them)."""
        with self._lock:
            self._fallback_sources.append(source)

    # -------------------------------------------------- movement: demote/up

    def demote(self, refs: Sequence[ChunkRef]) -> int:
        """Move chunks to the remote tier (simulating snapshots born
        elsewhere): payloads are copied into a remote pack, then forgotten
        by the local index and RAM cache.  Returns bytes demoted."""
        remote = self.remote
        payloads: List[bytes] = []
        move: List[ChunkRef] = []
        seen = set()
        for ref in refs:
            if ref.zero or ref.digest in seen:
                continue
            seen.add(ref.digest)
            if ref.digest not in self.local or remote.has(ref.digest):
                continue
            try:
                payload = self.local.get_chunk(ref)
            except KeyError:
                continue    # a racing demote already moved it
            payloads.append(payload)
            move.append(ref)
        if not move:
            return 0
        with self._lock:
            self._promote_seq += 1
            pack_id = f"demote-{self._promote_seq:06d}"
        pack = remote.store.open_pack(pack_id)
        remote.store.put_chunks(pack, payloads, refs=move)
        pack.close()
        remote.store.save_index()
        self.local.forget([r.digest for r in move])
        self.local.save_index()
        self.ram.discard([r.digest for r in move])
        moved = sum(len(p) for p in payloads)
        with self._stats_lock:
            self.demoted_bytes += moved
        self._bump_epoch()
        return moved

    def _promote_payloads(
        self, pairs: Sequence[Tuple[ChunkRef, bytes]], *, to_ram: bool = True
    ) -> int:
        """Append remote-fetched payloads to the local promotion pack and
        (optionally) the RAM cache.  Runs off the restore's critical path.

        Order matters: payloads are appended and **flushed** before their
        index entries are published — an indexed digest is instantly
        readable by concurrent scatter-reads, which would otherwise
        ``preadv`` past the buffered (unflushed) tail of the pack."""
        fresh = [(r, p) for r, p in pairs if r.digest not in self.local]
        if to_ram:
            inserted = 0
            for ref, payload in pairs:
                if self.ram.put(ref.digest, payload):
                    inserted += 1
            if inserted:
                # one batch-level advertisement for the RAM lift (per-chunk
                # insertion bumps would thrash every cached plan)
                self._bump_epoch()
        if fresh:
            with self._lock:
                if self._promote_pack is None:
                    self._promote_seq += 1
                    self._promote_pack = self.local.open_pack(
                        f"promote-{self._promote_seq:06d}"
                    )
                entries = [
                    (r.digest, self._promote_pack.append(p)) for r, p in fresh
                ]
                self._promote_pack.flush()
                self.local.register_chunks(entries)
            with self._stats_lock:
                self.promoted_chunks += len(fresh)
                self.promoted_bytes += sum(len(p) for _, p in fresh)
            self._bump_epoch()
        return sum(len(p) for _, p in fresh)

    def _track_promotion(self, future: Future) -> None:
        """Retain a background-promotion future, pruning completed ones so
        the list stays bounded on long-running serve paths."""
        with self._lock:
            self._promote_futures = [
                f for f in self._promote_futures if not f.done()
            ]
            self._promote_futures.append(future)

    def join_promotions(self) -> None:
        """Wait for background promotions (tests / orderly shutdown)."""
        with self._lock:
            futures, self._promote_futures = self._promote_futures, []
        for f in futures:
            f.result()

    def prefetch(
        self, refs: Sequence[ChunkRef], *, to_ram: bool = True
    ) -> PrefetchStats:
        """Pull a working set into the warm tiers ahead of restores.

        Remote-resident chunks cross the throttled link once (and are
        promoted to local packs); local chunks are optionally lifted into
        the RAM cache.  This is the registration/shard-assignment step —
        deliberately off the cold-start critical path.
        """
        stats = PrefetchStats()
        remote_items: List[Tuple[ChunkRef, bytes]] = []
        fetch: List[ChunkRef] = []
        lift_ram = to_ram and self.ram.capacity > 0
        seen = set()
        for ref in refs:
            if ref.zero or ref.digest in seen:
                continue
            seen.add(ref.digest)
            if self.ram.has(ref.digest):
                stats.already_warm += 1
                continue
            if ref.digest in self.local:
                # local chunks only move if the RAM tier can actually take
                # them — with RAM disabled they are already as warm as the
                # hierarchy gets, so don't pay (or count) a pointless read
                if lift_ram:
                    try:
                        payload = self.local.get_chunk(ref)
                    except KeyError:
                        # demoted between lookup and read: fetch remotely
                        fetch.append(ref)
                        continue
                    if self.ram.put(ref.digest, payload):
                        stats.prefetched_bytes += ref.size
                        stats.prefetched_chunks += 1
                continue
            fetch.append(ref)
        if fetch:
            bufs = [bytearray(r.size) for r in fetch]
            t0 = time.perf_counter()
            try:
                self._remote_read(
                    [(r, memoryview(b)) for r, b in zip(fetch, bufs)]
                )
            except (KeyError, TierReadError):
                # prefetch is best-effort warming: a dead or raced remote
                # tier must not fail registration — skip the remote set and
                # let the cold start demand-fault whatever it truly needs
                with self._stats_lock:
                    self.prefetch_skipped_chunks += len(fetch)
                fetch = []
            if fetch:
                stats.remote_fetch_s = time.perf_counter() - t0
                remote_items = [(r, bytes(b)) for r, b in zip(fetch, bufs)]
                if self.spec.verify_reads:
                    # never promote an unverified payload into the warm
                    # tiers; corrupt fetches are dropped (demand reads
                    # repair them properly later)
                    digests = digest_many([p for _, p in remote_items])
                    bad = sum(1 for (r, _), d in zip(remote_items, digests)
                              if d != r.digest)
                    if bad:
                        with self._stats_lock:
                            self.verify_failures += bad
                        remote_items = [
                            (r, p) for (r, p), d in zip(remote_items, digests)
                            if d == r.digest
                        ]
                self._promote_payloads(remote_items, to_ram=to_ram)
                stats.remote_bytes = sum(r.size for r, _ in remote_items)
                stats.prefetched_bytes += stats.remote_bytes
                stats.prefetched_chunks += len(remote_items)
        if stats.prefetched_chunks:
            self._bump_epoch()
        with self._stats_lock:
            self.prefetched_bytes += stats.prefetched_bytes
            self.prefetch_fetch_s += stats.remote_fetch_s
        return stats

    # -------------------------------------------------- refcounted GC (CAS)

    def pin(self, digests, owner: str) -> None:
        """Snapshot references live on the *local* store's owner table
        (one table per hierarchy — a digest demoted to the remote tier is
        still the same logical chunk)."""
        self.local.pin(digests, owner)

    def unpin(self, digests, owner: str) -> List[str]:
        return self.local.unpin(digests, owner)

    def refcount(self, digest: str) -> int:
        return self.local.refcount(digest)

    def shared_digests(self):
        return self.local.shared_digests()

    def reclaim(self, digests: Sequence[str]) -> int:
        """Make garbage digests unreachable across the whole hierarchy:
        RAM cache entries are discarded, and both pack tiers forget their
        index entries.  Returns bytes made unreachable (payloads stay in
        their packs until :meth:`compact`)."""
        digests = list(digests)
        if not digests:
            return 0
        self.ram.discard(digests)
        remote_only = 0
        if self._remote is not None:
            rs = self._remote.store
            # promoted chunks exist in BOTH pack tiers; count each logical
            # chunk once (the local forget below already covers those)
            remote_only = sum(
                rs.location(d).size for d in digests
                if d not in self.local and d in rs
            )
        freed = self.local.forget(digests) + remote_only
        if self._remote is not None:
            self._remote.store.forget(digests)
        self._bump_epoch()
        return freed

    def compact(self) -> int:
        """Rewrite the local pack tier down to its live (indexed) chunks.
        In-flight promotions are drained first — their pack is folded into
        the rewrite and a fresh one opens on the next promotion."""
        self.join_promotions()
        with self._lock:
            if self._promote_pack is not None:
                self._promote_pack.close()
                self._promote_pack = None
        reclaimed = self.local.compact()
        self._bump_epoch()
        return reclaimed

    # ------------------------------------------------------------ write path

    def open_pack(self, pack_id: str) -> PackWriter:
        return self.local.open_pack(pack_id)

    def put_chunks(self, pack, payloads, refs=None):
        return self.local.put_chunks(pack, payloads, refs=refs)

    def save_index(self) -> None:
        self.local.save_index()
        if self._remote is not None:
            self._remote.store.save_index()

    # ------------------------------------------- fault-tolerant tier reads
    #
    # Every stream-tier read funnels through _local_read/_remote_read:
    # retries with backoff under the policy's deadline, per-tier circuit
    # breaking (the remote breaker fails fast while open; the local tier
    # has nowhere to fail over to wholesale, so its breaker only reports
    # health), and — for remote — optional hedged fetches.  Payload
    # verification and quarantine-and-repair sit above, in
    # read_batch_into/get_chunk.

    def _backoff(self, attempt: int) -> float:
        with self._retry_lock:
            return self.retry.backoff_s(attempt, self._retry_rng)

    def _local_read(
        self,
        items: Sequence[Tuple[ChunkRef, memoryview]],
        *,
        parallel: bool = True,
        coalesce_gap: int = COALESCE_GAP,
        stats: Optional[TierReadStats] = None,
    ) -> int:
        """Pack-tier read with retry/backoff.  ``KeyError`` (an index race
        with concurrent tier movement) passes through untouched — the
        caller's re-classify fallback owns that case; only medium faults
        (IOError and kin) are retried and, exhausted, surface typed."""
        breaker = self.breakers["local"]
        policy = self.retry
        deadline = time.monotonic() + policy.deadline_s
        last: Optional[BaseException] = None
        for attempt in range(policy.max_attempts):
            try:
                n = self.pack.read_into(
                    items, parallel=parallel, coalesce_gap=coalesce_gap
                )
                breaker.record_success()
                return n
            except KeyError:
                raise
            except (IOError, OSError, TierUnavailableError) as exc:
                last = exc
                breaker.record_failure()
                if attempt + 1 >= policy.max_attempts:
                    break
                with self._stats_lock:
                    self.read_retries += 1
                if stats is not None:
                    stats.retries += 1
                delay = self._backoff(attempt)
                if time.monotonic() + delay >= deadline:
                    raise DeadlineExceededError(
                        [r.digest for r, _ in items], "local", exc)
                time.sleep(delay)
        raise TierReadError([r.digest for r, _ in items], "local", last)

    def _local_get(self, ref: ChunkRef) -> bytes:
        """Single-chunk demand-fault read from the local tier, with the same
        retry/breaker discipline as :meth:`_local_read`.  Reads through
        ``self.local.get_chunk`` (not the pack scatter path) so a demote
        racing the caller's residency check surfaces as ``KeyError`` for
        re-classification, exactly as before the fault layer existed."""
        breaker = self.breakers["local"]
        policy = self.retry
        deadline = time.monotonic() + policy.deadline_s
        last: Optional[BaseException] = None
        for attempt in range(policy.max_attempts):
            try:
                if self.faults is not None:
                    self.faults.before_read("local", [(ref, None)])
                payload = self.local.get_chunk(ref)
                if self.faults is not None:
                    buf = bytearray(payload)
                    self.faults.after_read("local", [(ref, memoryview(buf))])
                    payload = bytes(buf)
                breaker.record_success()
                return payload
            except KeyError:
                raise
            except (IOError, OSError, TierUnavailableError) as exc:
                last = exc
                breaker.record_failure()
                if attempt + 1 >= policy.max_attempts:
                    break
                with self._stats_lock:
                    self.read_retries += 1
                delay = self._backoff(attempt)
                if time.monotonic() + delay >= deadline:
                    raise DeadlineExceededError([ref.digest], "local", exc)
                time.sleep(delay)
        raise TierReadError([ref.digest], "local", last)

    def _remote_read(
        self,
        items: Sequence[Tuple[ChunkRef, memoryview]],
        *,
        stats: Optional[TierReadStats] = None,
    ) -> int:
        """Remote-tier read: breaker-gated, retried, optionally hedged.

        Each attempt lands in scratch buffers and is copied into the caller
        views only on success, so an abandoned hedge (or a failed attempt)
        can never partially fill a destination the restore will map."""
        remote = self.remote
        breaker = self.breakers["remote"]
        policy = self.retry
        digests = [r.digest for r, _ in items]
        if not breaker.allow():
            with self._stats_lock:
                self.fail_fast_reads += len(items)
            raise TierUnavailableError(
                digests, "remote", "circuit breaker open")
        deadline = time.monotonic() + policy.deadline_s
        last: Optional[BaseException] = None
        for attempt in range(policy.max_attempts):
            scratch = [(r, memoryview(bytearray(r.size))) for r, _ in items]
            try:
                n = self._remote_attempt(remote, scratch)
            except KeyError:
                # index race with tier movement: the tier answered, it just
                # no longer holds the digest — the caller re-classifies
                raise
            except (IOError, OSError, TierUnavailableError) as exc:
                last = exc
                breaker.record_failure()
                if attempt + 1 >= policy.max_attempts or breaker.is_open:
                    break
                with self._stats_lock:
                    self.read_retries += 1
                if stats is not None:
                    stats.retries += 1
                delay = self._backoff(attempt)
                if time.monotonic() + delay >= deadline:
                    raise DeadlineExceededError(digests, "remote", exc)
                time.sleep(delay)
            else:
                breaker.record_success()
                for (_, sv), (_, dv) in zip(scratch, items):
                    dv[:] = sv
                return n
        if time.monotonic() >= deadline:
            raise DeadlineExceededError(digests, "remote", last)
        raise TierReadError(digests, "remote", last)

    def _remote_attempt(self, remote, scratch) -> int:
        hedge_after = self.retry.hedge_after_s
        if hedge_after is None:
            return remote.read_into(scratch)
        pool = _get_hedge_pool()
        first = pool.submit(remote.read_into, scratch)
        try:
            return first.result(timeout=hedge_after)
        except _FutureTimeout:
            pass
        # primary is dragging its tail: race a duplicate fetch against it,
        # first success wins (the loser writes into buffers nobody reads)
        with self._stats_lock:
            self.hedged_fetches += 1
        shadow = [(r, memoryview(bytearray(r.size))) for r, _ in scratch]
        second = pool.submit(remote.read_into, shadow)
        pending = {first, second}
        while pending:
            done, pending = _wait_futures(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                if fut.exception() is None:
                    if fut is second:
                        with self._stats_lock:
                            self.hedge_wins += 1
                        for (_, sv), (_, dv) in zip(shadow, scratch):
                            dv[:] = sv
                    return fut.result()
        return first.result()   # both failed: surface the primary's error

    # -------------------------------------- verification + quarantine/repair

    def _verify_views(
        self,
        checks: Sequence[Tuple[ChunkRef, memoryview, str]],
        *,
        stats: Optional[TierReadStats] = None,
    ) -> None:
        """Digest-check freshly filled destination views; mismatches are
        repaired in place (or raise :class:`ChunkIntegrityError`)."""
        if not checks:
            return
        digests = digest_many([v for _, v, _ in checks])
        with self._stats_lock:
            self.verified_chunks += len(checks)
        for (ref, view, tier), got in zip(checks, digests):
            if got != ref.digest:
                with self._stats_lock:
                    self.verify_failures += 1
                if stats is not None:
                    stats.verify_failures += 1
                self._recover_chunk(ref, view, tier,
                                    corrupt=True, stats=stats)

    def _read_candidate(self, src: str, ref: ChunkRef) -> Optional[bytes]:
        """Best-effort raw read of one repair candidate.  Deliberately
        bypasses the fault wrappers (verification already guarantees
        correctness; re-injecting faults into repair would loop) — except
        that an injected *outage* still applies: a down tier has no
        readable medium for repair either."""
        try:
            if src == "ram":
                return self.ram.get(ref.digest)
            if src == "local":
                if self.faults is not None and self.faults.tier_down("local"):
                    return None
                if ref.digest in self.local:
                    return self.local.get_chunk(ref)
                return None
            if src == "remote":
                if self._remote is None or not self._remote.has(ref.digest):
                    return None
                if self.faults is not None and self.faults.tier_down("remote"):
                    return None
                return self._remote.store.get_chunk(ref)
            if src == "base":
                with self._lock:
                    sources = list(self._fallback_sources)
                for fn in sources:
                    payload = fn(ref)
                    if payload is not None:
                        return payload
        except (KeyError, IOError, OSError):
            return None
        return None

    def _quarantine(self, ref: ChunkRef, tier: str) -> None:
        """Make a corrupt stored copy unreachable (it can never be served;
        a later repair re-registers a verified payload in its place)."""
        with self._stats_lock:
            self.quarantined.add((ref.digest, tier))
        if tier == "ram":
            self.ram.discard([ref.digest])
        elif tier == "local":
            self.local.forget([ref.digest])
            self._bump_epoch()
        elif tier == "remote" and self._remote is not None:
            self._remote.store.forget([ref.digest])
            self._bump_epoch()

    def _recover_chunk(
        self,
        ref: ChunkRef,
        view: memoryview,
        bad_tier: str,
        *,
        corrupt: bool,
        stats: Optional[TierReadStats] = None,
    ) -> None:
        """Heal one chunk whose read failed (``corrupt=False``) or failed
        verification (``corrupt=True``).

        A corrupt read retries its own tier first — injected faults corrupt
        the read in flight, not the stored payload, so a same-tier re-read
        is the cheapest repair; only a copy that is corrupt *at rest* gets
        quarantined.  Then warmer-to-colder through the other tiers and
        finally the registered base sources.  Every candidate is verified
        before it is served; if nothing verifies, the read raises typed —
        :class:`ChunkIntegrityError` when a corrupt copy was seen,
        :class:`TierReadError` when the data was simply unreachable."""
        saw_corrupt = corrupt
        tried: List[str] = []
        sources = ([bad_tier] if corrupt else [])
        sources += [t for t in ("ram", "local", "remote", "base")
                    if t != bad_tier]
        for src in sources:
            payload = self._read_candidate(src, ref)
            if payload is None:
                continue
            tried.append(src)
            if len(payload) == ref.size and chunk_digest(payload) == ref.digest:
                view[:] = payload
                with self._stats_lock:
                    self.repaired_chunks += 1
                    self.repaired_bytes += ref.size
                if stats is not None:
                    stats.repaired_chunks += 1
                    stats.repaired_bytes += ref.size
                payload = bytes(payload)
                self.ram.put(ref.digest, payload)   # verified → warm again
                if src in ("remote", "base") and ref.digest not in self.local:
                    self._track_promotion(_get_fetch_pool().submit(
                        self._promote_payloads, [(ref, payload)]
                    ))
                return
            saw_corrupt = True
            self._quarantine(ref, src)
        if saw_corrupt:
            raise ChunkIntegrityError(ref.digest, ref.size,
                                      tried or [bad_tier])
        raise TierReadError([ref.digest], bad_tier,
                            "no readable copy in any tier or base")

    # ------------------------------------------------------------- read path

    def __contains__(self, digest: str) -> bool:
        return digest == _ZERO_DIGEST or self.tier_of(digest) is not None

    def location(self, digest: str):
        """Physical location in whichever pack tier holds the digest
        (local wins; promoted chunks exist in both)."""
        try:
            if digest in self.local:
                return self.local.location(digest)
        except KeyError:
            pass  # demoted between lookup and read — fall through to remote
        if self._remote is not None and self._remote.has(digest):
            return self._remote.store.location(digest)
        return self.local.location(digest)  # consistent KeyError

    def _remote_only_digests(self) -> List[str]:
        if self._remote is None:
            return []
        return [d for d in self._remote.store.digests()
                if d not in self.local]

    @property
    def num_chunks(self) -> int:
        # union across pack tiers: a promoted chunk lives in both but is
        # one logical chunk
        return self.local.num_chunks + len(self._remote_only_digests())

    def stored_bytes(self) -> int:
        total = self.local.stored_bytes()
        if self._remote is not None:
            rs = self._remote.store
            total += sum(rs.location(d).size
                         for d in self._remote_only_digests())
        return total

    def get_chunk(self, ref: ChunkRef) -> bytes:
        """Single-chunk (demand-fault) read: warmest tier wins; remote
        faults pay the throttle and promote downward.

        Lookup and read are not atomic against concurrent tier movement
        (a demote can forget a local digest between the ``in`` check and
        the pack read), so a tier-level miss re-classifies through the
        whole hierarchy before giving up — a chunk is only ``KeyError``
        when *no* tier holds it (i.e. it was genuinely reclaimed).

        Reads go through the retried/breaker-gated tier paths and are
        digest-verified before they are served or cached."""
        if ref.zero:
            return b"\x00" * ref.size
        for _attempt in range(2):
            got = self._read_one(ref)
            if got is None:
                continue    # movement race: re-classify once more
            payload, tier = got
            if self.spec.verify_reads and chunk_digest(payload) != ref.digest:
                with self._stats_lock:
                    self.verify_failures += 1
                buf = bytearray(payload)
                self._recover_chunk(ref, memoryview(buf), tier, corrupt=True)
                payload = bytes(buf)
            if tier != "ram":
                self.ram.put(ref.digest, payload)
            if tier == "remote" and self.spec.promote_on_fetch:
                # off the faulting request's critical path, like the batch
                # promotion — the D phase pays the remote link, not the
                # pack append/flush
                self._track_promotion(_get_fetch_pool().submit(
                    self._promote_payloads, [(ref, payload)]
                ))
            return payload
        # digest absent from every tier means it was genuinely reclaimed;
        # tier faults raise TierReadError above
        raise KeyError(ref.digest)  # keyerror-ok: documented reclaim contract

    def _read_one(self, ref: ChunkRef) -> Optional[Tuple[bytes, str]]:
        """One classification pass of the demand-fault path: ``(payload,
        tier)`` from the warmest holder, or ``None`` on a movement race."""
        payload = self.ram.get(ref.digest)
        if payload is not None:
            return payload, "ram"
        if ref.digest in self.local:
            try:
                payload = self._local_get(ref)
            except KeyError:
                return None     # demoted between lookup and read
            except TierReadError:
                buf = bytearray(ref.size)
                view = memoryview(buf)
                self._recover_chunk(ref, view, "local", corrupt=False)
                payload = bytes(buf)
            return payload, "local"
        if self._remote is not None and self._remote.has(ref.digest):
            buf = bytearray(ref.size)
            view = memoryview(buf)
            try:
                self._remote_read([(ref, view)])
            except KeyError:
                return None     # moved again mid-flight: re-classify
            except TierReadError:
                self._recover_chunk(ref, view, "remote", corrupt=False)
            return bytes(buf), "remote"
        return None

    def read_batch(self, refs: Sequence[ChunkRef]) -> Dict[str, bytes]:
        """Legacy digest→payload batched read, tier-aware."""
        out: Dict[str, bytes] = {}
        local_refs: List[ChunkRef] = []
        for ref in refs:
            if ref.zero or ref.digest in out:
                continue
            payload = self.ram.get(ref.digest)
            if payload is not None:
                out[ref.digest] = payload
            elif ref.digest in self.local:
                local_refs.append(ref)
            else:
                out[ref.digest] = self.get_chunk(ref)  # remote (throttled)
        if local_refs:
            try:
                fetched = self.local.read_batch(local_refs)
            except KeyError:
                # a concurrent demote moved chunks between classification
                # and the read — re-fault each through the full hierarchy
                for ref in local_refs:
                    if ref.digest not in out:
                        out[ref.digest] = self.get_chunk(ref)
            else:
                if self.spec.verify_reads and fetched:
                    by_digest = {r.digest: r for r in local_refs}
                    keys = list(fetched)
                    digests = digest_many([fetched[k] for k in keys])
                    for key, got in zip(keys, digests):
                        if got != key:
                            with self._stats_lock:
                                self.verify_failures += 1
                            ref = by_digest[key]
                            buf = bytearray(ref.size)
                            self._recover_chunk(ref, memoryview(buf),
                                                "local", corrupt=True)
                            fetched[key] = bytes(buf)
                out.update(fetched)
        return out

    def read_batch_into(
        self,
        dests: Sequence[Tuple[ChunkRef, memoryview]],
        *,
        parallel: bool = True,
        coalesce_gap: int = COALESCE_GAP,
        stats: Optional[TierReadStats] = None,
        promote: Optional[bool] = None,
    ) -> int:
        """Tier-aware pipelined scatter-read.

        Remote fetches launch first (the bandwidth-throttled long pole),
        the local coalesced-``preadv`` engine runs concurrently with them,
        and RAM hits memcpy while both are in flight.  Remote payloads are
        promoted downward in the background (unless ``promote=False``).
        Returns bytes read across all tiers.

        Stream-tier reads are retried and breaker-gated; once every stream
        lands, each filled destination is digest-verified and corrupt or
        unreadable chunks are healed from another tier or a registered
        base source (:meth:`add_fallback_source`) — a restore either maps
        byte-correct payloads or raises typed, never wrong bytes.
        """
        if promote is None:
            promote = self.spec.promote_on_fetch
        primary: Dict[str, memoryview] = {}
        dup: List[Tuple[str, memoryview]] = []
        ram_items: List[Tuple[ChunkRef, memoryview, bytes]] = []
        local_items: List[Tuple[ChunkRef, memoryview]] = []
        remote_items: List[Tuple[ChunkRef, memoryview]] = []
        for ref, buf in dests:
            if ref.zero:
                continue
            view = memoryview(buf)
            if view.ndim != 1 or view.itemsize != 1:
                view = view.cast("B")
            if len(view) != ref.size:
                raise ValueError(
                    f"dest for {ref.digest} has {len(view)} bytes, "
                    f"want {ref.size}"
                )
            if ref.digest in primary:
                dup.append((ref.digest, view))
                continue
            primary[ref.digest] = view
            # classification grabs the RAM payload immediately so a
            # concurrent eviction cannot strand the read
            payload = self.ram.get(ref.digest)
            if payload is not None:
                ram_items.append((ref, view, payload))
            elif ref.digest in self.local:
                local_items.append((ref, view))
            elif self._remote is not None and self._remote.has(ref.digest):
                remote_items.append((ref, view))
            else:
                raise KeyError(ref.digest)  # keyerror-ok: absent from every tier = reclaimed, same contract as get_chunk

        total = 0
        remote_future: Optional[Future] = None
        t_remote = 0.0
        local_fallback = False
        if remote_items:
            remote_future = _get_fetch_pool().submit(
                self._remote_read, remote_items, stats=stats
            )
            t_remote = time.perf_counter()
        if local_items:
            try:
                total += self._local_read(
                    local_items, parallel=parallel,
                    coalesce_gap=coalesce_gap, stats=stats,
                )
            except KeyError:
                # a concurrent demote() moved chunks between classification
                # and the read — re-classify and re-dispatch the batch
                # through the full hierarchy (idempotent: overwrites any
                # partial fills; keeps batching, promote and stats honest)
                local_fallback = True
                total += self.read_batch_into(
                    local_items, parallel=parallel,
                    coalesce_gap=coalesce_gap, stats=stats, promote=promote,
                )
            except TierReadError:
                # the pack medium kept failing past the retry budget —
                # heal chunk by chunk from the other tiers / base sources
                local_fallback = True
                for ref, view in local_items:
                    self._recover_chunk(ref, view, "local",
                                        corrupt=False, stats=stats)
                total += sum(r.size for r, _ in local_items)
        ram_bytes = sum(len(p) for _, _, p in ram_items)
        if parallel and ram_bytes > _RAM_PARALLEL_BYTES and len(ram_items) > 1:
            # ctypes.memmove releases the GIL, so fanned-out copies overlap
            # the page faults fresh destination buffers take on first write
            # (memoryview slice-assign holds the GIL and cannot)
            nshards = min(8, len(ram_items))
            shards = [ram_items[i::nshards] for i in range(nshards)]

            def _copy(shard):
                for _, view, payload in shard:
                    ctypes.memmove(
                        ctypes.addressof(ctypes.c_char.from_buffer(view)),
                        payload, len(payload),
                    )

            list(_get_io_pool().map(_copy, shards))
        else:
            for _, view, payload in ram_items:
                view[:] = payload
        total += ram_bytes
        promoting_bytes = 0
        remote_fallback = False
        if remote_future is not None:
            try:
                total += remote_future.result()
            except KeyError as exc:
                # the remote index changed between classification and the
                # read (e.g. a racing movement) — re-classify and
                # re-dispatch, like the local fallback above.  A second
                # miss means the chunks are genuinely gone everywhere:
                # surface that typed (chunk ids + tier + cause), not as a
                # bare KeyError the caller cannot classify.
                remote_fallback = True
                try:
                    total += self.read_batch_into(
                        remote_items, parallel=parallel,
                        coalesce_gap=coalesce_gap, stats=stats,
                        promote=promote,
                    )
                except KeyError as exc2:
                    raise TierReadError(
                        [r.digest for r, _ in remote_items], "remote", exc2
                    ) from exc
            except TierReadError:
                # remote link down / retries exhausted: heal chunk by chunk
                # (warm tiers, then base sources) instead of failing the
                # whole restore on one dead tier
                remote_fallback = True
                for ref, view in remote_items:
                    self._recover_chunk(ref, view, "remote",
                                        corrupt=False, stats=stats)
                total += sum(r.size for r, _ in remote_items)
            t_remote = time.perf_counter() - t_remote
            if promote and not remote_fallback:
                pairs = [
                    (ref, bytes(view)) for ref, view in remote_items
                ]
                # what promotion will actually append (racing promotions of
                # the same digests may shrink this further; close enough
                # for per-restore accounting)
                promoting_bytes = sum(
                    r.size for r, _ in pairs if r.digest not in self.local
                )
                self._track_promotion(
                    _get_fetch_pool().submit(self._promote_payloads, pairs)
                )
        if self.spec.verify_reads:
            # verify once per primary destination, after every stream has
            # landed and before dup copies fan the payloads out.  Fallback
            # re-dispatches verified (or healed) their own chunks already.
            checks: List[Tuple[ChunkRef, memoryview, str]] = [
                (r, v, "ram") for r, v, _ in ram_items
            ]
            if not local_fallback:
                checks += [(r, v, "local") for r, v in local_items]
            if not remote_fallback:
                checks += [(r, v, "remote") for r, v in remote_items]
            self._verify_views(checks, stats=stats)
        for digest, view in dup:
            view[:] = primary[digest]
        if stats is not None:
            if ram_items:
                stats.add("ram", len(ram_items),
                          sum(len(p) for _, _, p in ram_items))
            if local_items and not local_fallback:
                stats.add("local", len(local_items),
                          sum(r.size for r, _ in local_items))
            if remote_items and not remote_fallback:
                stats.add("remote", len(remote_items),
                          sum(r.size for r, _ in remote_items))
                stats.remote_fetch_s += t_remote
                stats.promoted_bytes += promoting_bytes
        return total

    # ------------------------------------------------------------- lifecycle

    def close(self) -> None:
        self.join_promotions()
        with self._lock:
            if self._promote_pack is not None:
                self._promote_pack.close()
                self._promote_pack = None
        self.local.save_index()
        self.local.close()
        if self._remote is not None:
            self._remote.store.close()

    def drop_page_cache(self, *, clear_ram: bool = True) -> None:
        """Benchmark hygiene: evict pack pages from the OS page cache (both
        pack directories) and, by default, empty the RAM tier — a measured
        cold start then hits the storage media.  Pass ``clear_ram=False``
        to measure RAM-tier-warm restores."""
        self.join_promotions()
        with self._lock:
            if self._promote_pack is not None:
                self._promote_pack.close()
                self._promote_pack = None
        self.local.drop_page_cache()
        if self._remote is not None:
            self._remote.store.drop_page_cache()
        if clear_ram and self.ram.capacity:
            self.ram.clear()
            self._bump_epoch()

    def tier_stats(self) -> Dict[str, object]:
        """Counters for fleet metrics (Cluster.metrics → replay driver)."""
        out: Dict[str, object] = {
            "ram": self.ram.stats(),
            "local": {
                "chunks": self.local.num_chunks,
                "stored_bytes": self.local.stored_bytes(),
            },
        }
        with self._stats_lock:
            out["promoted_bytes"] = self.promoted_bytes
            out["promoted_chunks"] = self.promoted_chunks
            out["demoted_bytes"] = self.demoted_bytes
            out["prefetched_bytes"] = self.prefetched_bytes
            out["prefetch_fetch_s"] = round(self.prefetch_fetch_s, 6)
            out["health"] = {
                "breakers": {t: b.stats() for t, b in self.breakers.items()},
                "verified_chunks": self.verified_chunks,
                "verify_failures": self.verify_failures,
                "repaired_chunks": self.repaired_chunks,
                "repaired_bytes": self.repaired_bytes,
                "quarantined_chunks": len(self.quarantined),
                "read_retries": self.read_retries,
                "fail_fast_reads": self.fail_fast_reads,
                "hedged_fetches": self.hedged_fetches,
                "hedge_wins": self.hedge_wins,
                "prefetch_skipped_chunks": self.prefetch_skipped_chunks,
            }
        # epoch reads are advertised lock-free everywhere else too
        out["residency_epoch"] = self.residency_epoch
        if self._remote is not None:
            out["remote"] = self._remote.stats()
        if self.faults is not None:
            out["faults"] = self.faults.counters_snapshot()
        return out
