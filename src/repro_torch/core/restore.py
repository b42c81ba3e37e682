"""Snapshot restoration: the paper's §5.2 "Restoration", adapted.

Four strategies are implemented, matching the paper's evaluation matrix:

* ``regular``      — no snapshot: parse the variant's source checkpoint and
                     run full initialization (boot-from-kernel analogue).
* ``reap``         — REAP_SF: one *full-function* snapshot on disk, nothing
                     shared; eagerly read the working set, demand-page the
                     rest at execution time.
* ``seuss``        — SEUSS_SF: share the in-RAM base pool copy-on-write, then
                     *import the function from source* (pay init compute).
* ``snapfaas-``    — base pool shared CoW + eagerly read the **entire** diff.
* ``snapfaas``     — base pool shared CoW + eagerly read only the diff's
                     working set; demand-page the remaining diff chunks.

Mechanical notes (documented deviations, see DESIGN.md §6):

* Arrays must be contiguous for XLA, so an array containing *any* diff chunk
  is assembled into a private buffer (base chunks memcpy'd from the RAM pool,
  diff chunks read from storage).  Arrays untouched by the diff are shared
  zero-copy from the pool until first write (CoW fault, counted).
* Demand paging is per-chunk, triggered the moment the runtime first reads
  the array — i.e. synchronously during execution, like REAP's page faults.
  Arrays whose leaves a request never touches are never materialized.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .chunkstore import ChunkRef, ChunkStore
from .metrics import ColdStartMetrics, timer
from .snapshot import ArrayMeta, ResolvedArray, SnapshotManifest, resolve
from .workingset import AccessLog, WorkingSet

Path = str


# ---------------------------------------------------------------------------
# base pool (the in-RAM zygote memory)
# ---------------------------------------------------------------------------

class BasePool:
    """Host-RAM resident, read-only assembly of a base snapshot.

    Loaded once per worker at bootstrap (cluster manager replicates base
    snapshots to every worker's memory, §5.3) — *not* on the cold-start path.
    """

    def __init__(self, manifest: SnapshotManifest):
        self.manifest = manifest
        self._arrays: Dict[Path, np.ndarray] = {}

    @staticmethod
    def load(store: ChunkStore, manifest: SnapshotManifest) -> "BasePool":
        pool = BasePool(manifest)
        # one scatter-read across every array: payloads land directly in the
        # pool buffers (zero intermediate copies)
        bufs: Dict[Path, np.ndarray] = {}
        dests: List[Tuple[ChunkRef, memoryview]] = []
        for path, meta in manifest.arrays.items():
            buf = np.zeros(meta.nbytes, dtype=np.uint8)
            bufs[path] = buf
            mv = memoryview(buf)
            off = 0
            for c in meta.chunks:
                assert c is not None
                if not c.zero:
                    dests.append((c, mv[off : off + c.size]))
                off += c.size
        store.read_batch_into(dests)
        for path, meta in manifest.arrays.items():
            arr = bufs[path].view(np.dtype(meta.dtype)).reshape(meta.shape)
            arr.flags.writeable = False
            pool._arrays[path] = arr
        return pool

    def get(self, path: Path) -> np.ndarray:
        return self._arrays[path]

    def chunk_bytes_of(self, path: Path, idx: int) -> np.ndarray:
        """uint8 view of one chunk of a pooled array (for private assembly)."""
        meta = self.manifest.arrays[path]
        flat = self._arrays[path].reshape(-1).view(np.uint8)
        lo = idx * meta.chunk_bytes
        return flat[lo : lo + min(meta.chunk_bytes, meta.nbytes - lo)]

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._arrays.values())


# ---------------------------------------------------------------------------
# per-instance materialized arrays
# ---------------------------------------------------------------------------

_SHARED = "shared"
_PRIVATE = "private"


@dataclass
class ArrayPatch:
    """On-device patch descriptor: base ⊕ diff as a selective-copy kernel.

    ``rows`` holds every non-zero eager diff chunk of the array, packed as
    fixed-stride rows (the scatter-read engine reads payloads straight into
    them); ``sel[i]`` is the row overriding chunk ``i`` of the array, or -1
    to keep the base chunk.  Zero diff chunks point at a shared all-zero row.
    This is exactly the input layout of ``kernels.snapshot_patch``.
    """

    sel: np.ndarray            # (n_chunks,) int32
    rows: np.ndarray           # uint8, n_rows * chunk_bytes (flat)
    row_of: Dict[int, int]     # non-zero diff chunk idx -> row
    chunk_bytes: int

    def rows_2d(self) -> np.ndarray:
        return self.rows.reshape(-1, self.chunk_bytes)


class MaterializedArray:
    """One array of a restored instance.

    States: SHARED (zero-copy pool view, CoW on write) or PRIVATE (own
    buffer, possibly with lazily-pending chunks).
    """

    __slots__ = ("path", "meta", "state", "_arr", "_buf", "_pending", "_store",
                 "_pool", "written", "patch", "_dev", "access_log", "_recorded")

    def __init__(self, path: Path, meta: ArrayMeta):
        self.path = path
        self.meta = meta
        self.state = _PRIVATE
        self._arr: Optional[np.ndarray] = None
        self._buf: Optional[np.ndarray] = None  # uint8 backing for private
        # pending chunks: (idx, ref|None, "store"|"pool"|"rows") — "pool"
        # entries memcpy from the in-RAM base (CoW-page materialization,
        # term D); "store" entries are synchronous disk faults (REAP
        # semantics); "rows" entries memcpy from the already-read packed
        # diff-rows buffer of ``patch`` (no storage I/O).
        self._pending: List[Tuple[int, Optional[ChunkRef], str]] = []
        self._store: Optional[ChunkStore] = None
        self._pool: Optional["BasePool"] = None
        self.written = False
        # on-device patch descriptor (set by the planned restore engine when
        # the array is base⊕diff patchable on the accelerator) + the cached
        # patched device array
        self.patch: Optional["ArrayPatch"] = None
        self._dev: Optional[Any] = None
        # recording mode: every read/ensure_rows is mirrored into this log
        self.access_log: Optional[AccessLog] = None
        # demand-paged restore: store-chunk indices the recording predicted;
        # a store materialization *outside* this set is a demand fault
        self._recorded: Optional[Set[int]] = None

    # -- constructors ------------------------------------------------------
    @staticmethod
    def shared(path: Path, meta: ArrayMeta, pool_arr: np.ndarray) -> "MaterializedArray":
        ma = MaterializedArray(path, meta)
        ma.state = _SHARED
        ma._arr = pool_arr
        return ma

    @staticmethod
    def private(
        path: Path,
        meta: ArrayMeta,
        buf: np.ndarray,
        pending: List[Tuple[int, Optional[ChunkRef], str]],
        store: ChunkStore,
        pool: Optional["BasePool"] = None,
        recorded: Optional[Set[int]] = None,
    ) -> "MaterializedArray":
        ma = MaterializedArray(path, meta)
        ma._buf = buf
        ma._pending = pending
        ma._store = store
        ma._pool = pool
        ma._recorded = recorded
        return ma

    def _materialize_chunk(self, idx: int, ref: Optional[ChunkRef], src: str) -> int:
        assert self._buf is not None
        lo = idx * self.meta.chunk_bytes
        if src == "pool":
            assert self._pool is not None
            data = self._pool.chunk_bytes_of(self.path, idx)
            self._buf[lo : lo + len(data)] = data
            return len(data)
        if src == "rows":
            assert self.patch is not None
            size = min(self.meta.chunk_bytes, self.meta.nbytes - lo)
            row = self.patch.row_of[idx]
            self._buf[lo : lo + size] = self.patch.rows_2d()[row, :size]
            return size
        assert self._store is not None and ref is not None
        data = self._store.get_chunk(ref)
        self._buf[lo : lo + len(data)] = np.frombuffer(data, dtype=np.uint8)
        return len(data)

    # -- access --------------------------------------------------------------
    @property
    def resident(self) -> bool:
        return not self._pending

    def read(self, metrics: Optional[ColdStartMetrics] = None) -> np.ndarray:
        """Materialize (demand-paging any pending chunks) and return."""
        if self.access_log is not None:
            self.access_log.touch(self.path)
        return self._read(metrics)

    def _read(self, metrics: Optional[ColdStartMetrics] = None) -> np.ndarray:
        """`read` minus access logging (internal fast path)."""
        if self.state == _SHARED:
            assert self._arr is not None
            return self._arr
        if self._pending:
            t0 = time.perf_counter()
            nbytes = 0
            n_store = 0
            faults = 0
            fault_bytes = 0
            for idx, ref, src in self._pending:
                nb = self._materialize_chunk(idx, ref, src)
                if src == "store":
                    nbytes += nb
                    n_store += 1
                    if self._recorded is not None and idx not in self._recorded:
                        faults += 1
                        fault_bytes += nb
            self._pending = []
            if metrics is not None:
                metrics.t_demand += time.perf_counter() - t0
                metrics.demand_chunks += n_store
                metrics.demand_bytes += nbytes
                metrics.demand_faults += faults
                metrics.demand_fault_bytes += fault_bytes
        if self._arr is None:
            assert self._buf is not None
            self._arr = self._buf.view(np.dtype(self.meta.dtype)).reshape(self.meta.shape)
        return self._arr

    def ensure_rows(
        self, rows, metrics: Optional[ColdStartMetrics] = None
    ) -> np.ndarray:
        """Materialize only the chunks covering the given leading-axis rows
        (REAP's demand faults, at access granularity), then return a view of
        the buffer WITHOUT materializing the remaining pending chunks.

        Rows outside the working set fault in correctly here — they are just
        synchronous disk reads charged to execution time (term D). Rows never
        requested keep base-snapshot content in the buffer; by construction
        (the serving layer ensures every gathered row) they are never read."""
        if self.access_log is not None:
            self.access_log.touch_rows(self.path, rows)
        if self.state == _SHARED or not self._pending:
            return self._read(metrics)
        from .workingset import rows_to_chunks

        need = rows_to_chunks(self.meta, rows)
        t0 = time.perf_counter()
        still: List[Tuple[int, Optional[ChunkRef], str]] = []
        nbytes = 0
        hit = 0
        faults = 0
        fault_bytes = 0
        for idx, ref, src in self._pending:
            if idx in need:
                nb = self._materialize_chunk(idx, ref, src)
                if src == "store":
                    nbytes += nb
                    hit += 1
                    if self._recorded is not None and idx not in self._recorded:
                        faults += 1
                        fault_bytes += nb
            else:
                still.append((idx, ref, src))
        self._pending = still
        if metrics is not None:
            metrics.t_demand += time.perf_counter() - t0
            metrics.demand_chunks += hit
            metrics.demand_bytes += nbytes
            metrics.demand_faults += faults
            metrics.demand_fault_bytes += fault_bytes
        if self._arr is None:
            self._arr = self._buf.view(np.dtype(self.meta.dtype)).reshape(self.meta.shape)
        return self._arr

    def unread_recorded_bytes(self) -> int:
        """Bytes of recorded (prefetched) store chunks still pending — i.e.
        prefetched but never touched by the execution (false prefetch)."""
        if self._recorded is None:
            return 0
        total = 0
        for idx, ref, src in self._pending:
            if src == "store" and ref is not None and idx in self._recorded:
                total += ref.size
        return total

    def write(self, metrics: Optional[ColdStartMetrics] = None) -> np.ndarray:
        """Return a writable buffer; a first write to a SHARED array is a
        copy-on-write fault (term D)."""
        if self.access_log is not None:
            self.access_log.touch(self.path)
        if self.state == _SHARED:
            t0 = time.perf_counter()
            assert self._arr is not None
            priv = np.array(self._arr)  # the CoW copy
            self._arr = priv
            self.state = _PRIVATE
            if metrics is not None:
                metrics.t_cow += time.perf_counter() - t0
                metrics.cow_faults += 1
                metrics.cow_bytes += priv.nbytes
        else:
            self.read(metrics)
        self.written = True
        self._dev = None  # device copy no longer reflects host content
        assert self._arr is not None
        if not self._arr.flags.writeable:
            self._arr = np.array(self._arr)
        return self._arr


@dataclass
class RestoredInstance:
    """A cold-started function instance: arrays + device state + metrics."""

    function: str
    strategy: str
    arrays: Dict[Path, MaterializedArray]
    device_state: Dict[str, Any]
    metrics: ColdStartMetrics
    # background prefetch of the recorded set (demand-paged restore only);
    # purely advisory — chunks it has not reached yet fault in verified
    prefetch_thread: Optional[Any] = None

    def attach_access_log(self, log: Optional[AccessLog]) -> None:
        """Mirror every subsequent read into ``log`` (None detaches)."""
        for ma in self.arrays.values():
            ma.access_log = log

    def finalize_demand_paging(self) -> None:
        """After execution: recorded chunks still pending were prefetched for
        nothing — account them as false-prefetch bytes."""
        if self.metrics.demand_paged:
            self.metrics.false_prefetch_bytes = sum(
                ma.unread_recorded_bytes() for ma in self.arrays.values())

    def value(self, path: Path) -> np.ndarray:
        return self.arrays[path].read(self.metrics)

    def writable(self, path: Path) -> np.ndarray:
        return self.arrays[path].write(self.metrics)

    def pytree(self, paths: Optional[Sequence[Path]] = None) -> Dict[Path, np.ndarray]:
        """Materialize the requested (default: all) leaves."""
        ps = list(paths) if paths is not None else list(self.arrays)
        return {p: self.value(p) for p in ps}

    def shared_base_written_ratio(self) -> float:
        """Fig. 1: fraction of shared base bytes CoW-written during exec."""
        shared = [a for a in self.arrays.values() if a.state == _SHARED or a.written]
        base_bytes = sum(a.meta.nbytes for a in shared)
        if base_bytes == 0:
            return 0.0
        return self.metrics.cow_bytes / base_bytes


# ---------------------------------------------------------------------------
# strategy implementations
# ---------------------------------------------------------------------------

def _assemble_private(
    store: ChunkStore,
    pool: Optional[BasePool],
    path: Path,
    ra: ResolvedArray,
    eager_payloads: Dict[str, bytes],
    eager_set: Optional[Set[Tuple[Path, int]]],
) -> MaterializedArray:
    """Build a private buffer: eager diff chunks are written now (from the
    batched read); base chunks stay PENDING against the in-RAM pool (lazy
    CoW-page materialization — page granularity, like the paper's mmap);
    non-eager diff chunks stay pending against the store (demand faults)."""
    meta = ra.meta
    buf = np.zeros(meta.nbytes, dtype=np.uint8)
    pending: List[Tuple[int, Optional[ChunkRef], str]] = []
    for idx, (src, ref) in enumerate(ra.sources):
        lo = idx * meta.chunk_bytes
        hi = lo + ref.size
        if src == "base":
            if ref.zero:
                continue
            if pool is not None:
                pending.append((idx, None, "pool"))  # lazy RAM memcpy
            else:
                # no pool (REAP): base chunks are part of the full snapshot
                if eager_set is None or (path, idx) in eager_set:
                    data = eager_payloads.get(ref.digest)
                    if data is None:
                        data = store.get_chunk(ref)
                    buf[lo:hi] = np.frombuffer(data, dtype=np.uint8)
                else:
                    pending.append((idx, ref, "store"))
        else:  # diff
            if ref.zero:
                continue
            if eager_set is None or (path, idx) in eager_set:
                data = eager_payloads.get(ref.digest)
                if data is None:
                    data = store.get_chunk(ref)
                buf[lo:hi] = np.frombuffer(data, dtype=np.uint8)
            else:
                pending.append((idx, ref, "store"))
    return MaterializedArray.private(path, meta, buf, pending, store, pool)


def restore_layered(
    store: ChunkStore,
    base: SnapshotManifest,
    diff: SnapshotManifest,
    pool: BasePool,
    *,
    working_set: Optional[WorkingSet] = None,
    residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    function: str = "",
) -> RestoredInstance:
    """SnapFaaS (working_set given) / SnapFaaS− (working_set None).

    Steps map to Eq. 1:
      A  pre-configuration + device-state restore
      B  batched eager read of diff chunks (all, or WS only)
      C  residual init
      D  (charged later, during execution, by MaterializedArray)
    """
    strategy = "snapfaas" if working_set is not None else "snapfaas-"
    m = ColdStartMetrics(strategy=strategy, function=function)
    t = timer()

    # A: resolve layering, restore device state, set up instance bookkeeping.
    resolved = resolve(base, diff)
    device_state = dict(base.device_state)
    device_state.update(diff.device_state)
    m.t_preconfig = t.lap()

    # B: one batched (readv-style) eager read of the chosen diff chunks.
    eager_keys: List[Tuple[Path, int, ChunkRef]] = []
    for path, ra in resolved.items():
        for idx in ra.dirty_indices():
            _, ref = ra.sources[idx]
            if ref.zero:
                continue
            if working_set is None or (path, idx) in working_set:
                eager_keys.append((path, idx, ref))
    payloads = store.read_batch([r for _, _, r in eager_keys])
    eager_set: Optional[Set[Tuple[Path, int]]] = (
        {(p, i) for p, i, _ in eager_keys} if working_set is not None else None
    )

    arrays: Dict[Path, MaterializedArray] = {}
    for path, ra in resolved.items():
        if not ra.dirty_indices():
            arrays[path] = MaterializedArray.shared(path, ra.meta, pool.get(path))
            m.shared_bytes_mapped += ra.meta.nbytes
        else:
            arrays[path] = _assemble_private(store, pool, path, ra, payloads, eager_set)
    m.t_eager = t.lap()
    m.eager_bytes = sum(r.size for _, _, r in eager_keys)
    m.eager_chunks = len(eager_keys)

    # C: residual, un-memoizable initialization.
    if residual_init is not None:
        device_state = residual_init(device_state)
    m.t_init = t.lap()

    return RestoredInstance(
        function=function, strategy=strategy, arrays=arrays,
        device_state=device_state, metrics=m,
    )


def restore_reap(
    store: ChunkStore,
    full: SnapshotManifest,
    *,
    working_set: Optional[WorkingSet],
    residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    function: str = "",
) -> RestoredInstance:
    """REAP_SF: full-function snapshot, WS eager + demand-page the rest.

    Nothing is shared: every instance re-reads its entire state from disk
    (eagerly or on fault) — the fundamental cost the paper's Fig. 6 shows.
    """
    m = ColdStartMetrics(strategy="reap", function=function)
    t = timer()
    resolved = resolve(None, full)  # every chunk reads as "diff" (unique)
    device_state = dict(full.device_state)
    m.t_preconfig = t.lap()

    eager_keys: List[Tuple[Path, int, ChunkRef]] = []
    for path, ra in resolved.items():
        for idx, (_, ref) in enumerate(ra.sources):
            if ref.zero:
                continue
            if working_set is None or (path, idx) in working_set:
                eager_keys.append((path, idx, ref))
    payloads = store.read_batch([r for _, _, r in eager_keys])
    eager_set = {(p, i) for p, i, _ in eager_keys}
    arrays = {
        path: _assemble_private(store, None, path, ra, payloads, eager_set)
        for path, ra in resolved.items()
    }
    m.t_eager = t.lap()
    m.eager_bytes = sum(r.size for _, _, r in eager_keys)
    m.eager_chunks = len(eager_keys)

    if residual_init is not None:
        device_state = residual_init(device_state)
    m.t_init = t.lap()
    return RestoredInstance(
        function=function, strategy="reap", arrays=arrays,
        device_state=device_state, metrics=m,
    )


def restore_seuss(
    store: ChunkStore,
    base: SnapshotManifest,
    pool: BasePool,
    *,
    source_loader: Callable[[], Dict[Path, np.ndarray]],
    residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    function: str = "",
) -> RestoredInstance:
    """SEUSS_SF: CoW-share the in-RAM base, then import the function from its
    *source* — i.e. pay function initialization compute instead of restoring
    a diff snapshot (the cost SEUSS-style designs cannot memoize)."""
    m = ColdStartMetrics(strategy="seuss", function=function)
    t = timer()
    device_state = dict(base.device_state)
    arrays: Dict[Path, MaterializedArray] = {}
    for path, meta in base.arrays.items():
        arrays[path] = MaterializedArray.shared(path, meta, pool.get(path))
        m.shared_bytes_mapped += meta.nbytes
    m.t_preconfig = t.lap()
    m.t_eager = 0.0  # SEUSS restores memory by mmap only (constant, ~0) — §6.3 B

    # C: function import & init from source (measured, not memoized).
    loaded = source_loader()
    for path, arr in loaded.items():
        meta = ArrayMeta(shape=tuple(arr.shape), dtype=str(arr.dtype),
                         chunk_bytes=base.arrays[path].chunk_bytes if path in base.arrays
                         else 256 * 1024, chunks=[])
        ma = MaterializedArray(path, meta)
        ma._arr = arr
        arrays[path] = ma
    if residual_init is not None:
        device_state = residual_init(device_state)
    m.t_init = t.lap()
    return RestoredInstance(
        function=function, strategy="seuss", arrays=arrays,
        device_state=device_state, metrics=m,
    )


def restore_regular(
    *,
    source_loader: Callable[[], Dict[Path, np.ndarray]],
    base_loader: Callable[[], Dict[Path, np.ndarray]],
    residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    function: str = "",
) -> RestoredInstance:
    """No snapshots: full environment + function initialization from source
    (the boot-from-kernel baseline the paper normalizes against)."""
    m = ColdStartMetrics(strategy="regular", function=function)
    t = timer()
    m.t_preconfig = t.lap()
    base_arrays = base_loader()       # "boot the runtime": load base weights
    arrays: Dict[Path, MaterializedArray] = {}
    for path, arr in base_arrays.items():
        meta = ArrayMeta(tuple(arr.shape), str(arr.dtype), 256 * 1024, [])
        ma = MaterializedArray(path, meta)
        ma._arr = arr
        arrays[path] = ma
    m.t_eager = t.lap()               # B: bulk state load from storage
    loaded = source_loader()          # C: function import/init
    for path, arr in loaded.items():
        meta = ArrayMeta(tuple(arr.shape), str(arr.dtype), 256 * 1024, [])
        ma = MaterializedArray(path, meta)
        ma._arr = arr
        arrays[path] = ma
    device_state: Dict[str, Any] = {}
    if residual_init is not None:
        device_state = residual_init(device_state)
    m.t_init = t.lap()
    return RestoredInstance(
        function=function, strategy="regular", arrays=arrays,
        device_state=device_state, metrics=m,
    )
