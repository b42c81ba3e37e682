"""Planned restore engine: resolve once, scatter-read forever.

The seed restore path re-resolved the (base, diff) layering, re-planned the
eager read and re-walked every chunk's digest dict on *every* cold start —
and each eager byte crossed three buffers on its way to the instance (pack
read → digest-keyed bytes → frombuffer → destination slice).  This module
splits restoration into:

* :func:`build_restore_plan` — run once per (function, strategy) and cached
  on the :class:`~repro.core.registry.FunctionRecord`.  Resolves layering,
  classifies every chunk (shared / eager / pending-pool / pending-store),
  and pre-computes each eager chunk's destination offset.
* :func:`execute_restore_plan` — the per-cold-start hot path: allocate the
  private buffers, hand ``(ref, destination view)`` pairs to
  ``ChunkStore.read_batch_into`` (coalesced ``preadv`` scatter-reads, a
  thread pool overlapping I/O across packs), wire up MaterializedArrays.
  Zero intermediate copies; the plan itself allocates nothing per restore.

Arrays whose diff is fully eager and whose base lives in the pool also get
an :class:`~repro.core.restore.ArrayPatch`: their diff chunks are read into
a packed rows buffer instead of being assembled on the host, so the serving
layer can apply them on-device with the ``snapshot_patch`` Pallas kernel
(base chunks never cross the host at all).  Host reads still work — the
rows buffer doubles as a pending-chunk source.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .chunkstore import ChunkRef, ChunkStore
from .metrics import ColdStartMetrics, timer
from .restore import ArrayPatch, BasePool, MaterializedArray, RestoredInstance
from .snapshot import ArrayMeta, SnapshotManifest, resolve
from .workingset import WorkingSet

Path = str

PendingEntry = Tuple[int, Optional[ChunkRef], str]


@dataclass(frozen=True)
class PlanArray:
    """Everything execute() needs to materialize one array, precomputed."""

    path: Path
    meta: ArrayMeta
    shared: bool
    # private-array placement (all offsets precomputed at build time):
    pending: Tuple[PendingEntry, ...] = ()
    eager: Tuple[Tuple[int, ChunkRef], ...] = ()       # (buffer offset, ref)
    # on-device patch layout (None → not patchable):
    patch_sel: Optional[np.ndarray] = None             # (n_chunks,) int32
    patch_rows: int = 0                                # rows in the buffer
    patch_row_of: Optional[Dict[int, int]] = None
    patch_eager: Tuple[Tuple[int, ChunkRef], ...] = () # (row offset, ref)
    # demand-paged plans: store-pending chunk indices the recording covers
    # (prefetched in the background; materialized on first access)
    recorded: Optional[frozenset] = None


@dataclass
class RestorePlan:
    """Cached restore recipe for one (function, strategy) pair."""

    function: str
    strategy: str
    base_id: Optional[str]
    diff_id: str
    arrays: List[PlanArray]
    device_state: Dict[str, Any]
    eager_bytes: int = 0
    eager_chunks: int = 0
    #: eager bytes after collapsing duplicate digests — what the engine
    #: actually streams from storage (content addressing: N chunk slots
    #: referencing one digest are read once and replicated by memcpy)
    unique_eager_bytes: int = 0
    shared_bytes: int = 0
    # tier placement of the eager set when built against a tiered store:
    # {tier name: bytes} plus the store's residency epoch at build time —
    # the registry rebuilds the plan when promotion/demotion moved chunks
    tier_split: Dict[str, int] = field(default_factory=dict)
    residency_epoch: int = -1
    # demand-paged restore (REAP record-and-prefetch): nothing is streamed
    # eagerly; the recorded set is prefetched in the background and every
    # chunk materializes lazily on first access
    demand_paged: bool = False
    prefetch_refs: Tuple[ChunkRef, ...] = ()
    prefetch_bytes: int = 0

    def eager_refs(self) -> List[ChunkRef]:
        if self.demand_paged:
            return list(self.prefetch_refs)
        return [
            ref
            for pa in self.arrays
            for _, ref in (*pa.eager, *pa.patch_eager)
        ]


def build_restore_plan(
    base: Optional[SnapshotManifest],
    diff: SnapshotManifest,
    *,
    working_set: Optional[WorkingSet],
    strategy: str,
    function: str = "",
    use_pool: bool = True,
    store: Optional[ChunkStore] = None,
    demand_paged: bool = False,
) -> RestorePlan:
    """Resolve layering and classify every chunk — once, off the hot path.

    ``use_pool`` is True for the layered strategies (base chunks memcpy from
    the in-RAM pool) and False for REAP (no sharing: base chunks read from
    storage like everything else).

    ``demand_paged`` flips the B phase from streaming to prefetching: no
    chunk is read eagerly; every store chunk stays pending (lazily faulted
    on first access, verified), and the subset ``working_set`` covers — the
    *recorded* set — is prefetched toward RAM in the background instead.
    """
    resolved = resolve(base, diff)
    device_state: Dict[str, Any] = dict(base.device_state) if base else {}
    device_state.update(diff.device_state)

    arrays: List[PlanArray] = []
    eager_bytes = eager_chunks = shared_bytes = 0
    prefetch_refs: List[ChunkRef] = []
    prefetch_bytes = 0
    for path, ra in resolved.items():
        meta = ra.meta
        dirty = ra.dirty_indices()
        if use_pool and not dirty:
            arrays.append(PlanArray(path=path, meta=meta, shared=True))
            shared_bytes += meta.nbytes
            continue

        def in_ws(idx: int) -> bool:
            return working_set is None or (path, idx) in working_set

        base_meta = base.arrays.get(path) if base is not None else None
        patchable = (
            use_pool
            and not demand_paged
            and bool(dirty)
            and base_meta is not None
            and base_meta.shape == meta.shape
            and base_meta.dtype == meta.dtype
            and base_meta.chunk_bytes == meta.chunk_bytes
            and meta.chunk_bytes % np.dtype(meta.dtype).itemsize == 0
            and all(in_ws(i) for i in dirty)
        )

        pending: List[PendingEntry] = []
        eager: List[Tuple[int, ChunkRef]] = []
        patch_eager: List[Tuple[int, ChunkRef]] = []
        recorded: Set[int] = set()
        row_of: Dict[int, int] = {}
        sel = (
            np.full(len(ra.sources), -1, dtype=np.int32) if patchable else None
        )
        n_rows = 0
        zero_row: Optional[int] = None
        cb = meta.chunk_bytes
        for idx, (src, ref) in enumerate(ra.sources):
            lo = idx * cb
            if src == "base":
                if ref.zero:
                    continue
                if use_pool:
                    pending.append((idx, None, "pool"))
                elif demand_paged:
                    pending.append((idx, ref, "store"))
                    if in_ws(idx):
                        recorded.add(idx)
                        prefetch_refs.append(ref)
                        prefetch_bytes += ref.size
                elif in_ws(idx):
                    eager.append((lo, ref))
                else:
                    pending.append((idx, ref, "store"))
                continue
            # diff chunk
            if patchable:
                assert sel is not None
                if ref.zero:
                    if zero_row is None:
                        zero_row = n_rows
                        n_rows += 1
                    sel[idx] = zero_row
                else:
                    row_of[idx] = n_rows
                    sel[idx] = n_rows
                    patch_eager.append((n_rows * cb, ref))
                    pending.append((idx, None, "rows"))
                    n_rows += 1
                continue
            if ref.zero:
                continue
            if demand_paged:
                pending.append((idx, ref, "store"))
                if in_ws(idx):
                    recorded.add(idx)
                    prefetch_refs.append(ref)
                    prefetch_bytes += ref.size
            elif in_ws(idx):
                eager.append((lo, ref))
            else:
                pending.append((idx, ref, "store"))

        eager_bytes += sum(r.size for _, r in eager)
        eager_bytes += sum(r.size for _, r in patch_eager)
        eager_chunks += len(eager) + len(patch_eager)
        arrays.append(PlanArray(
            path=path, meta=meta, shared=False,
            pending=tuple(pending), eager=tuple(eager),
            patch_sel=sel if patchable else None,
            patch_rows=n_rows,
            patch_row_of=row_of if patchable else None,
            patch_eager=tuple(patch_eager),
            recorded=frozenset(recorded) if demand_paged else None,
        ))

    plan = RestorePlan(
        function=function, strategy=strategy,
        base_id=base.snapshot_id if base else None,
        diff_id=diff.snapshot_id,
        arrays=arrays, device_state=device_state,
        eager_bytes=eager_bytes, eager_chunks=eager_chunks,
        shared_bytes=shared_bytes,
        demand_paged=demand_paged,
        prefetch_refs=tuple(prefetch_refs),
        prefetch_bytes=prefetch_bytes,
    )
    uniq: Set[str] = set()
    for r in plan.eager_refs():
        if r.digest not in uniq:
            uniq.add(r.digest)
            plan.unique_eager_bytes += r.size
    # record where the eager set lives right now (tiered stores): the Eq. 1
    # input for this plan, and the staleness stamp the registry checks.
    # The epoch is read BEFORE the residency pass: movement landing during
    # the pass then leaves the plan stamped with the older epoch, so the
    # registry's next refresh re-derives the split (the reverse order could
    # pin a pre-movement split under a post-movement epoch — permanently).
    if store is not None and hasattr(store, "residency"):
        epoch = store.residency_epoch
        plan.tier_split = store.residency(plan.eager_refs())
        plan.residency_epoch = epoch
    return plan


def execute_restore_plan(
    plan: RestorePlan,
    store: ChunkStore,
    pool: Optional[BasePool],
    *,
    residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    promote: Optional[bool] = None,
) -> RestoredInstance:
    """The cold-start hot path: allocate, scatter-read, done.

    Steps map to Eq. 1: A = buffer pre-allocation + device-state restore,
    B = one parallel tier-aware scatter-read of every eager chunk — on a
    :class:`~repro.core.tiers.TieredChunkStore` the remote fetch, local
    ``preadv`` and RAM memcpy streams run pipelined (overlapped), and the
    per-tier outcome lands in the metrics,
    C = residual init, D = charged later by MaterializedArray.

    ``promote`` forwards to the tiered store: whether remote-fetched chunks
    are promoted downward (None → the store's configured default).
    """
    m = ColdStartMetrics(strategy=plan.strategy, function=plan.function)
    t = timer()

    # A: allocate every private buffer up front and wire the instance.
    arrays: Dict[Path, MaterializedArray] = {}
    dests: List[Tuple[ChunkRef, memoryview]] = []
    for pa in plan.arrays:
        if pa.shared:
            assert pool is not None
            arrays[pa.path] = MaterializedArray.shared(
                pa.path, pa.meta, pool.get(pa.path)
            )
            continue
        buf = np.zeros(pa.meta.nbytes, dtype=np.uint8)
        ma = MaterializedArray.private(
            pa.path, pa.meta, buf, list(pa.pending), store, pool,
            recorded=pa.recorded,
        )
        if pa.patch_sel is not None:
            rows = np.zeros(pa.patch_rows * pa.meta.chunk_bytes, dtype=np.uint8)
            ma.patch = ArrayPatch(
                sel=pa.patch_sel, rows=rows,
                row_of=pa.patch_row_of or {}, chunk_bytes=pa.meta.chunk_bytes,
            )
            mv_rows = memoryview(rows)
            for off, ref in pa.patch_eager:
                dests.append((ref, mv_rows[off : off + ref.size]))
        if pa.eager:
            mv = memoryview(buf)
            for off, ref in pa.eager:
                dests.append((ref, mv[off : off + ref.size]))
        arrays[pa.path] = ma
    m.shared_bytes_mapped = plan.shared_bytes
    m.t_preconfig = t.lap()

    # B (demand-paged): stream nothing — kick off a background prefetch of
    # the recorded set through the tiered store's pipelined stages and let
    # execution start immediately.  The prefetch is purely advisory: chunks
    # it has not reached yet (and chunks the recording missed) fault in
    # synchronously through the verified ``get_chunk`` path, so a failed or
    # slow prefetch can delay but never corrupt.
    if plan.demand_paged:
        m.demand_paged = True
        m.prefetch_bytes = plan.prefetch_bytes
        inst = RestoredInstance(
            function=plan.function, strategy=plan.strategy, arrays=arrays,
            device_state=dict(plan.device_state), metrics=m,
        )
        if plan.prefetch_refs and hasattr(store, "prefetch"):
            import threading

            refs = list(plan.prefetch_refs)

            def _bg() -> None:
                try:
                    store.prefetch(refs)
                except Exception:  # broad-ok: best-effort background warming must never kill the worker
                    pass  # misses fault in verified demand reads later

            th = threading.Thread(
                target=_bg, name=f"ws-prefetch-{plan.function}", daemon=True
            )
            th.start()
            inst.prefetch_thread = th
        m.t_eager = t.lap()
        if residual_init is not None:
            inst.device_state = residual_init(inst.device_state)
        m.t_init = t.lap()
        return inst

    # B: one batched parallel scatter-read, straight into the buffers.
    # Tiered stores pipeline remote fetch / local preadv / RAM memcpy and
    # report the per-tier split; flat stores take the plain path.
    if hasattr(store, "tier_stats"):
        from .tiers import TierReadStats

        stats = TierReadStats()
        store.read_batch_into(dests, stats=stats, promote=promote)
        m.tier_chunks = stats.tier_chunks
        m.tier_bytes = stats.tier_bytes
        m.remote_fetch_s = stats.remote_fetch_s
        m.promoted_bytes = stats.promoted_bytes
        m.read_retries = stats.retries
        m.repaired_chunks = stats.repaired_chunks
    else:
        store.read_batch_into(dests)
    m.t_eager = t.lap()
    m.eager_bytes = plan.eager_bytes
    m.eager_chunks = plan.eager_chunks
    m.eager_unique_bytes = plan.unique_eager_bytes

    # C: residual, un-memoizable initialization.
    device_state = dict(plan.device_state)
    if residual_init is not None:
        device_state = residual_init(device_state)
    m.t_init = t.lap()

    return RestoredInstance(
        function=plan.function, strategy=plan.strategy, arrays=arrays,
        device_state=device_state, metrics=m,
    )
