"""Content-addressed chunk store with pack files.

This is the storage substrate for SnapFaaS-style layered snapshots.

Design notes (mapping to the paper):

* A VM snapshot is a *sparse file of dirty 4 KiB pages* plus a JSON metadata
  file.  Our unit is a *chunk* (default 256 KiB) of an array's serialized
  bytes; a snapshot is a *pack file* (all chunk payloads, appended
  sequentially) plus a JSON manifest.
* Eager restoration in the paper is `readv` of the dirty pages — sequential,
  batched, at disk bandwidth.  Here eager restoration is a single pass over
  the pack file reading (sorted, coalesced) ranges.
* Demand paging in the paper is file-mmap + synchronous page faults.  Here
  lazy chunks are materialized one at a time from an ``mmap`` of the pack
  file, charged at access time.
* Content addressing (BLAKE2b-128) gives structural dedup: diff snapshots
  store only chunks whose digest differs from the base, and identical chunks
  across *snapshots* (e.g. adjacent training checkpoints) are stored once.
* All-zero chunks are elided entirely (the paper's sparse-file holes).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

DEFAULT_CHUNK_BYTES = 256 * 1024

# Gap (bytes) below which two ranges are merged into one sequential read.
COALESCE_GAP = 64 * 1024

# Max iovec segments per preadv call (POSIX IOV_MAX is >= 1024 on Linux).
_IOV_MAX = 1024

# Scatter reads larger than this are split so multiple threads can overlap
# I/O within a single pack.
_SPLIT_BYTES = 4 * 1024 * 1024

_ZERO_DIGEST = "0" * 32

_HAVE_PREADV = hasattr(os, "preadv")


class IndexCorruptionError(RuntimeError):
    """``index.json`` failed to parse or has the wrong shape.

    A truncated or garbled index means the store can no longer locate chunk
    payloads; silently starting empty would orphan every pack.  Callers see
    the path and the underlying cause and decide (restore from a replica,
    re-capture snapshots, ...).
    """


class DigestCollisionError(IndexCorruptionError):
    """Two chunks with the same BLAKE2b-128 digest but different lengths.

    A true 128-bit collision is astronomically unlikely; in practice this
    means a corrupt index, a corrupt manifest, or mixed stores.  Serving
    whichever payload was indexed first would hand a function the wrong
    bytes, silently — so every path that could do that (index load, chunk
    publication, scatter-read planning) raises this instead.
    """


#: Current on-disk ``index.json`` schema.  See ``docs/migration.md`` for
#: the upgrade path from the legacy layouts (v1 flat digest map, v0
#: per-function offset lists).
INDEX_VERSION = 2

_io_pool: Optional[ThreadPoolExecutor] = None
_hash_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _get_io_pool() -> ThreadPoolExecutor:
    # I/O threads spend their life blocked in preadv (GIL released), so the
    # right pool size tracks queue depth, not core count
    global _io_pool
    with _pool_lock:
        if _io_pool is None:
            _io_pool = ThreadPoolExecutor(
                max_workers=min(16, 4 * (os.cpu_count() or 2)),
                thread_name_prefix="chunkstore-io",
            )
    return _io_pool


def _get_hash_pool() -> ThreadPoolExecutor:
    global _hash_pool
    with _pool_lock:
        if _hash_pool is None:
            _hash_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 2),
                thread_name_prefix="chunkstore-hash",
            )
    return _hash_pool


def chunk_digest(data: bytes | memoryview) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def digest_many(payloads: Sequence[bytes | memoryview]) -> List[str]:
    """BLAKE2b over a batch of chunks.

    hashlib releases the GIL for buffers > 2 KiB, so batches large enough to
    amortize thread handoff are hashed across a shared pool; tiny batches run
    inline.
    """
    total = sum(len(p) for p in payloads)
    if len(payloads) < 4 or total < (1 << 20):
        return [chunk_digest(p) for p in payloads]
    return list(_get_hash_pool().map(chunk_digest, payloads))


def is_zero(data: bytes | memoryview) -> bool:
    # vectorized: no per-call zero-buffer allocation, no bytes() copy
    if len(data) == 0:
        return True
    return not np.frombuffer(data, dtype=np.uint8).any()


@dataclass(frozen=True)
class ChunkRef:
    """Reference to one chunk of serialized bytes."""

    digest: str
    size: int

    @property
    def zero(self) -> bool:
        return self.digest == _ZERO_DIGEST

    def to_json(self) -> list:
        return [self.digest, self.size]

    @staticmethod
    def from_json(obj: Sequence) -> "ChunkRef":
        return ChunkRef(digest=obj[0], size=int(obj[1]))


def zero_ref(size: int) -> ChunkRef:
    return ChunkRef(digest=_ZERO_DIGEST, size=size)


def scan_chunks(
    buf: memoryview, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> List[ChunkRef]:
    """Chunk ``buf`` and compute every chunk's ref in one vectorized pass.

    Zero detection runs as a single ``np.add.reduceat`` over the whole buffer
    (no per-chunk zero-buffer compares); only non-zero chunks are hashed,
    batched across the hash pool.
    """
    n = len(buf)
    if n == 0:
        return []
    arr = np.frombuffer(buf, dtype=np.uint8)
    starts = np.arange(0, n, chunk_bytes, dtype=np.int64)
    nonzero_counts = np.add.reduceat(arr != 0, starts)
    refs: List[Optional[ChunkRef]] = [None] * len(starts)
    to_hash: List[int] = []
    for i, lo in enumerate(starts):
        size = min(chunk_bytes, n - int(lo))
        if nonzero_counts[i] == 0:
            refs[i] = zero_ref(size)
        else:
            to_hash.append(i)
    if to_hash:
        digests = digest_many(
            [buf[int(starts[i]) : int(starts[i]) + chunk_bytes] for i in to_hash]
        )
        for i, d in zip(to_hash, digests):
            size = min(chunk_bytes, n - int(starts[i]))
            refs[i] = ChunkRef(digest=d, size=size)
    return refs  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# scatter-read planning
# ---------------------------------------------------------------------------

def coalesce_ranges(
    ranges: Sequence[Tuple[int, int]], gap: int = COALESCE_GAP
) -> List[Tuple[int, int, List[int]]]:
    """Group byte ranges into sequential runs.

    ``ranges`` is a list of ``(offset, size)``.  Returns runs as
    ``(start, end, member_indices)`` sorted by start, where members are
    indices into ``ranges`` in offset order and any two consecutive members
    within a run are separated by at most ``gap`` bytes.  Every input range
    appears in exactly one run, and runs never overlap.
    """
    if not ranges:
        return []
    order = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    runs: List[Tuple[int, int, List[int]]] = []
    start, end = ranges[order[0]][0], ranges[order[0]][0] + ranges[order[0]][1]
    members = [order[0]]
    for i in order[1:]:
        off, size = ranges[i]
        if off <= end + gap:
            end = max(end, off + size)
            members.append(i)
        else:
            runs.append((start, end, members))
            start, end, members = off, off + size, [i]
    runs.append((start, end, members))
    return runs


@dataclass(frozen=True)
class ChunkLoc:
    """Physical location of a chunk inside a pack file."""

    pack: str
    offset: int
    size: int


class PackWriter:
    """Appends chunk payloads to a single pack file (sequential layout).

    Sequential layout is load-bearing for performance: the eager restore path
    reads a snapshot's working set as a handful of coalesced sequential
    ranges, which is what lets restoration run at the storage medium's
    *bandwidth* rather than its random-read latency (paper §3.2).
    """

    def __init__(self, path: str, pack_id: str):
        # append, never truncate: a reopened store may hand out a pack id
        # that already exists on disk (e.g. re-capturing `base-<family>`
        # after a restart) while the loaded index still points into the
        # old payloads — "wb" here would destroy them.  Appending is safe:
        # existing offsets stay valid, and the index dedup means identical
        # re-captures write nothing at all.
        self._f = open(path, "ab")  # atomic-ok: append-only pack; readers only see offsets the fsynced index publishes
        self.pack_id = pack_id
        self.offset = self._f.tell()

    def append(self, data: bytes | memoryview) -> ChunkLoc:
        n = self._f.write(data)
        loc = ChunkLoc(pack=self.pack_id, offset=self.offset, size=n)
        self.offset += n
        return loc

    def flush(self) -> None:
        """Make appended payloads visible to readers (page cache, no fsync).
        Long-lived writers (tier promotion packs) flush after each batch."""
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()


def _read_segments(fd: int, offset: int, iovecs: List[memoryview]) -> int:
    """Read one sequential run, scattering into ``iovecs`` (preadv when
    available, pread fallback), looping on short reads."""
    want = sum(len(v) for v in iovecs)
    if _HAVE_PREADV:
        got = 0
        iov = list(iovecs)
        while iov:
            n = os.preadv(fd, iov, offset + got)
            if n <= 0:
                raise IOError(
                    f"short scatter read: got {got} of {want} bytes at {offset}"
                )
            got += n
            while iov and n >= len(iov[0]):
                n -= len(iov[0])
                iov.pop(0)
            if iov and n:
                iov[0] = iov[0][n:]
        return got
    pos = offset
    for v in iovecs:
        mv = v
        while len(mv):
            data = os.pread(fd, len(mv), pos)
            if not data:
                raise IOError(f"short read at {pos}")
            mv[: len(data)] = data
            mv = mv[len(data):]
            pos += len(data)
    return pos - offset


class ChunkStore:
    """Directory-backed content-addressed chunk store.

    Layout::

        root/
          packs/<pack_id>.pack     chunk payloads, append-only
          index.json               digest -> (pack, offset, size)

    The index is the paper's snapshot *metadata*; packs are the sparse files.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "packs"), exist_ok=True)
        self._index: Dict[str, ChunkLoc] = {}
        self._refs: Dict[str, Set[str]] = {}  # digest -> referencing owners
        self._mmaps: Dict[str, mmap.mmap] = {}
        self._files: Dict[str, object] = {}
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()
        self._load_index()

    # ------------------------------------------------------------------ index

    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    def _ingest(self, digest: str, loc: ChunkLoc) -> None:
        """Add one index entry, rejecting same-digest/different-length
        collisions instead of silently keeping whichever came first."""
        prev = self._index.get(digest)
        if prev is not None:
            if prev.size != loc.size:
                raise DigestCollisionError(
                    f"digest {digest} indexed with length {prev.size} "
                    f"(pack {prev.pack!r}) but also {loc.size} "
                    f"(pack {loc.pack!r}); refusing to serve either"
                )
            return
        self._index[digest] = loc

    def _load_index(self) -> None:
        """Load ``index.json``, auto-upgrading legacy layouts in memory.

        * **v2** (current): ``{"version": 2, "chunks": {digest: [pack,
          offset, size]}, "refs": {digest: [owner, ...]}}`` — owners are
          snapshot/function names, so reload + re-registration is
          idempotent.
        * **v1** (legacy): a bare ``{digest: [pack, offset, size]}`` map —
          upgraded by wrapping; refs start empty (chunks written before
          refcounting are treated as permanently live).
        * **v0** (legacy): per-function offset lists, ``{"functions":
          {fn: {array: [[pack, offset, size, digest], ...]}}}`` — flattened
          into the digest map; the same digest appearing under several
          functions dedups (that was the point of going content-addressed)
          and its owner set is seeded with the functions naming it.

        The upgraded form is only persisted on the next :meth:`save_index`
        (load never writes).  Collisions on differing lengths raise
        :class:`DigestCollisionError` whichever layout they hide in.
        """
        p = self._index_path()
        if not os.path.exists(p):
            return
        try:
            with open(p) as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise TypeError(f"index root is {type(raw).__name__}, not dict")
            if "version" in raw:                      # v2
                version = int(raw["version"])
                if version > INDEX_VERSION:
                    raise ValueError(f"index version {version} is newer than "
                                     f"supported {INDEX_VERSION}")
                for d, v in raw["chunks"].items():
                    self._ingest(d, ChunkLoc(pack=v[0], offset=int(v[1]),
                                             size=int(v[2])))
                self._refs = {d: set(owners) for d, owners in
                              raw.get("refs", {}).items() if owners}
            elif "functions" in raw:                  # v0: per-function rows
                for fn, arrays in raw["functions"].items():
                    for rows in arrays.values():
                        for row in rows:
                            pack, offset, size, digest = (
                                row[0], int(row[1]), int(row[2]), row[3])
                            self._ingest(digest, ChunkLoc(
                                pack=pack, offset=offset, size=size))
                    # each function owns the digests it names (however
                    # many of its arrays repeat them)
                    named: Set[str] = {
                        row[3] for rows in arrays.values() for row in rows
                    }
                    for digest in named:
                        self._refs.setdefault(digest, set()).add(fn)
            else:                                     # v1: flat digest map
                for d, v in raw.items():
                    self._ingest(d, ChunkLoc(pack=v[0], offset=int(v[1]),
                                             size=int(v[2])))
        except DigestCollisionError:
            raise
        except (ValueError, TypeError, KeyError, IndexError, AttributeError) as e:
            raise IndexCorruptionError(
                f"chunk index {p} is corrupt ({e!r}); refusing to start with "
                f"an empty index over existing packs"
            ) from e

    def save_index(self) -> None:
        """Persist the index atomically: write a temp file, fsync, then
        ``os.replace`` — a crash mid-write leaves the previous index intact,
        never a truncated one.  Always writes the current (v2) layout;
        loading a legacy index and saving it back is the upgrade path.

        Saves serialise on their own lock: two concurrent saves sharing one
        temp path would race the replace (the loser's ``os.replace`` finds
        its temp file already moved — a FileNotFoundError the concurrency
        soak flushed out).  The snapshot happens inside the save lock, so
        a later save can never be overtaken by an earlier snapshot."""
        with self._save_lock:
            with self._lock:
                raw = {
                    "version": INDEX_VERSION,
                    "chunks": {d: [l.pack, l.offset, l.size]
                               for d, l in self._index.items()},
                    "refs": {d: sorted(owners)
                             for d, owners in self._refs.items() if owners},
                }
            tmp = self._index_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(raw, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._index_path())

    def register_chunks(self, entries: Iterable[Tuple[str, ChunkLoc]]) -> None:
        """Publish already-written chunk locations into the index.

        Writers that append to a long-lived pack (tier promotion) must
        flush the pack *before* registering — a digest visible in the index
        is immediately readable by concurrent scatter-reads, so indexing
        ahead of the flush would let ``preadv`` race past EOF."""
        with self._lock:
            for digest, loc in entries:
                self._ingest(digest, loc)

    # -------------------------------------------------------------- refcounts

    def pin(self, digests: Iterable[str], owner: str) -> None:
        """Record that snapshot ``owner`` references these digests.

        References are *owner sets*, not bare counters: pinning the same
        (owner, digest) pair twice is a no-op, so re-registering a function
        over a reopened store (whose persisted refs already name it) cannot
        inflate counts and wedge GC.  Zero digests are ignored; unknown
        digests may be pinned (a manifest can reference a chunk stored in a
        colder tier of the same hierarchy)."""
        with self._lock:
            for d in digests:
                if d == _ZERO_DIGEST:
                    continue
                self._refs.setdefault(d, set()).add(owner)

    def unpin(self, digests: Iterable[str], owner: str) -> List[str]:
        """Drop ``owner``'s reference to each digest; returns the digests
        left with no owners (now garbage — the caller decides whether to
        :meth:`forget`/:meth:`compact` them).  Digests with no ref entry at
        all (stored before refcounting — legacy v1 indexes) are treated as
        permanently live and never returned."""
        dead: List[str] = []
        with self._lock:
            for d in digests:
                if d == _ZERO_DIGEST:
                    continue
                owners = self._refs.get(d)
                if owners is None:
                    continue
                owners.discard(owner)
                if not owners:
                    del self._refs[d]
                    dead.append(d)
        return dead

    def refcount(self, digest: str) -> int:
        """Number of snapshots referencing ``digest`` (0 = unknown)."""
        with self._lock:
            return len(self._refs.get(digest, ()))

    def shared_digests(self) -> Set[str]:
        """Digests referenced by more than one snapshot (the cross-function
        dedup working set — what the planner's shared-hit fraction prices)."""
        with self._lock:
            return {d for d, owners in self._refs.items() if len(owners) > 1}

    def compact(self) -> int:
        """Rewrite every *indexed* chunk into a fresh pack and delete the
        old pack files — the physical half of garbage collection
        (:meth:`forget` only makes bytes unreachable).  Returns bytes
        reclaimed on disk.  Not concurrency-safe: quiesce in-flight reads
        AND writers (a writer's pack could be deleted under it); index
        entries published mid-compaction are preserved, but their pack
        must not predate the compaction."""
        pack_dir = os.path.join(self.root, "packs")
        old_packs = set(os.listdir(pack_dir))
        before = sum(
            os.path.getsize(os.path.join(pack_dir, f)) for f in old_packs
        )
        with self._lock:
            live = sorted(self._index.items(),
                          key=lambda kv: (kv[1].pack, kv[1].offset))
        # a previous compaction may have left its pack behind — pick a pack
        # id we are not about to read from
        seq = 1
        while f"compact-{seq:06d}.pack" in old_packs:
            seq += 1
        pack_id = f"compact-{seq:06d}"
        writer = self.open_pack(pack_id)
        new_index: Dict[str, ChunkLoc] = {}
        # stream chunk-by-chunk: peak memory is one chunk, not the store
        for d, l in live:
            new_index[d] = writer.append(
                self.get_chunk(ChunkRef(digest=d, size=l.size))
            )
        writer.close()
        with self._lock:
            # keep entries published since `live` was snapshotted (they
            # point into packs newer than old_packs, which survive below)
            for d, loc in self._index.items():
                new_index.setdefault(d, loc)
            self._index = new_index
        self.close()  # old mmaps/fds go away before their packs do
        self.save_index()
        for name in old_packs:
            os.unlink(os.path.join(pack_dir, name))
        after = sum(
            os.path.getsize(os.path.join(pack_dir, f))
            for f in os.listdir(pack_dir)
        )
        return before - after

    def forget(self, digests: Iterable[str]) -> int:
        """Drop index entries (payload bytes stay in their packs, now
        unreachable).  Used by tier demotion: a chunk moved to a colder tier
        must stop resolving as local.  Returns bytes forgotten."""
        freed = 0
        with self._lock:
            for d in digests:
                loc = self._index.pop(d, None)
                if loc is not None:
                    freed += loc.size
        return freed

    def __contains__(self, digest: str) -> bool:
        return digest == _ZERO_DIGEST or digest in self._index

    def location(self, digest: str) -> ChunkLoc:
        return self._index[digest]

    def digests(self) -> List[str]:
        """All indexed digests (tier accounting: union across stores)."""
        with self._lock:
            return list(self._index)

    @property
    def num_chunks(self) -> int:
        return len(self._index)

    def stored_bytes(self) -> int:
        return sum(l.size for l in self._index.values())

    # ------------------------------------------------------------------ write

    def open_pack(self, pack_id: str) -> PackWriter:
        path = os.path.join(self.root, "packs", f"{pack_id}.pack")
        return PackWriter(path, pack_id)

    def put_chunks(
        self,
        pack: PackWriter,
        payloads: Sequence[bytes | memoryview],
        refs: Optional[Sequence[ChunkRef]] = None,
    ) -> List[ChunkRef]:
        """Store payloads, deduping against the index. Returns refs in order.

        ``refs`` may carry precomputed ChunkRefs (from :func:`scan_chunks`)
        so zero-detection and hashing are not redone per chunk.
        """
        if refs is None:
            zero_mask = [is_zero(p) for p in payloads]
            digests = digest_many(
                [p for p, z in zip(payloads, zero_mask) if not z]
            )
            it = iter(digests)
            refs = [
                zero_ref(len(p)) if z else ChunkRef(digest=next(it), size=len(p))
                for p, z in zip(payloads, zero_mask)
            ]
        out: List[ChunkRef] = []
        for data, ref in zip(payloads, refs):
            if ref.zero:
                out.append(ref)
                continue
            with self._lock:
                prev = self._index.get(ref.digest)
                if prev is not None and prev.size != ref.size:
                    raise DigestCollisionError(
                        f"digest {ref.digest} already stored with length "
                        f"{prev.size}, refusing to alias a {ref.size}-byte "
                        f"chunk onto it"
                    )
            if prev is None:
                loc = pack.append(data)
                with self._lock:
                    # re-check under lock (another writer may have raced)
                    self._index.setdefault(ref.digest, loc)
            out.append(ref)
        return out

    # ------------------------------------------------------------------- read

    def _pack_mmap(self, pack_id: str, need_end: int = 0) -> mmap.mmap:
        with self._lock:
            m = self._mmaps.get(pack_id)
            if m is not None and need_end > len(m):
                # The pack grew after mapping (tier promotion appends to a
                # long-lived pack) — map again to cover the new tail.  The
                # stale mapping is NOT closed here: a concurrent get_chunk
                # may still be slicing it; dropping the reference lets GC
                # unmap once the last reader is done.
                self._files[pack_id].close()  # type: ignore[attr-defined]
                m = None
            if m is None:
                f = open(os.path.join(self.root, "packs", f"{pack_id}.pack"), "rb")
                m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                self._files[pack_id] = f
                self._mmaps[pack_id] = m
        return m

    def _loc_for(self, ref: ChunkRef) -> ChunkLoc:
        """Resolve a ref, rejecting length-mismatched digest collisions
        instead of silently serving whichever chunk was indexed first."""
        loc = self._index[ref.digest]
        if loc.size != ref.size:
            raise DigestCollisionError(
                f"digest {ref.digest} requested with length {ref.size} but "
                f"indexed with length {loc.size} (pack {loc.pack!r})"
            )
        return loc

    def get_chunk(self, ref: ChunkRef) -> bytes:
        """Single-chunk (demand-paged) read."""
        if ref.zero:
            return b"\x00" * ref.size
        loc = self._loc_for(ref)
        m = self._pack_mmap(loc.pack, need_end=loc.offset + loc.size)
        return m[loc.offset : loc.offset + loc.size]

    def verify_chunk(self, ref: ChunkRef) -> bool:
        """Does the stored payload still hash to its digest?  (Scrub /
        quarantine probe; False covers both corruption and absence.)"""
        if ref.zero:
            return True
        try:
            return chunk_digest(self.get_chunk(ref)) == ref.digest
        except (KeyError, IOError, OSError):
            return False

    def read_batch(
        self, refs: Sequence[ChunkRef]
    ) -> Dict[str, bytes]:
        """Eager (readv-style) batched read.

        Reads are grouped per pack and issued in offset order with adjacent
        ranges coalesced — the `readv` of the paper's eager restoration.
        Returns digest -> payload (zero chunks excluded; caller synthesizes).
        """
        by_pack: Dict[str, List[ChunkLoc]] = {}
        wanted: Dict[Tuple[str, int], str] = {}
        seen: Set[str] = set()
        for ref in refs:
            if ref.zero or ref.digest in seen:
                continue
            seen.add(ref.digest)
            loc = self._loc_for(ref)
            by_pack.setdefault(loc.pack, []).append(loc)
            wanted[(loc.pack, loc.offset)] = ref.digest
        out: Dict[str, bytes] = {}
        for pack_id, locs in by_pack.items():
            locs.sort(key=lambda l: l.offset)
            path = os.path.join(self.root, "packs", f"{pack_id}.pack")
            with open(path, "rb", buffering=0) as f:
                # coalesce adjacent/overlapping ranges into sequential reads
                i = 0
                n = len(locs)
                while i < n:
                    start = locs[i].offset
                    end = locs[i].offset + locs[i].size
                    j = i + 1
                    while j < n and locs[j].offset <= end + 64 * 1024:
                        end = max(end, locs[j].offset + locs[j].size)
                        j += 1
                    f.seek(start)
                    blob = f.read(end - start)
                    for k in range(i, j):
                        l = locs[k]
                        d = wanted[(pack_id, l.offset)]
                        out[d] = blob[l.offset - start : l.offset - start + l.size]
                    i = j
        return out

    # ------------------------------------------------------- zero-copy read

    def _pack_fd(self, pack_id: str) -> int:
        """Shared O_RDONLY fd per pack; pread/preadv take explicit offsets so
        one fd serves all reader threads."""
        with self._lock:
            fd = self._fds.get(pack_id)
            if fd is None:
                fd = os.open(
                    os.path.join(self.root, "packs", f"{pack_id}.pack"), os.O_RDONLY
                )
                self._fds[pack_id] = fd
        return fd

    def read_batch_into(
        self,
        dests: Sequence[Tuple[ChunkRef, memoryview]],
        *,
        parallel: bool = True,
        coalesce_gap: int = COALESCE_GAP,
    ) -> int:
        """Planned scatter-read: each chunk's payload lands **directly** in
        its destination buffer with zero intermediate copies.

        ``dests`` pairs each ChunkRef with a writable buffer of exactly
        ``ref.size`` bytes.  Zero refs are skipped (callers keep destination
        buffers zeroed).  Repeated digests are read once and replicated with
        a memcpy.  Per pack, ranges are sorted and coalesced into sequential
        runs executed with ``preadv`` (destination views interleaved with a
        scratch view covering each coalescing gap); large runs are split and
        all runs are issued across a small thread pool so I/O overlaps
        between packs and within large packs.

        Returns the number of bytes read from storage (gap bytes included).
        """
        primary: Dict[str, memoryview] = {}
        dup: List[Tuple[str, memoryview]] = []
        by_pack: Dict[str, List[Tuple[int, int, memoryview]]] = {}
        for ref, buf in dests:
            if ref.zero:
                continue
            view = memoryview(buf)
            if view.ndim != 1 or view.itemsize != 1:
                view = view.cast("B")
            if len(view) != ref.size:
                raise ValueError(
                    f"dest for {ref.digest} has {len(view)} bytes, want {ref.size}"
                )
            if ref.digest in primary:
                dup.append((ref.digest, view))
                continue
            primary[ref.digest] = view
            loc = self._loc_for(ref)
            by_pack.setdefault(loc.pack, []).append((loc.offset, loc.size, view))

        # plan: per pack, coalesce into runs of (file_offset, [iovec segments])
        jobs: List[Tuple[int, int, List[memoryview]]] = []  # (fd, offset, iovecs)
        for pack_id, items in by_pack.items():
            fd = self._pack_fd(pack_id)
            runs = coalesce_ranges([(off, size) for off, size, _ in items],
                                   gap=coalesce_gap)
            for start, end, members in runs:
                segs: List[memoryview] = []
                pos = start
                for i in members:
                    off, size, view = items[i]
                    if off > pos:  # coalescing gap → discard into scratch
                        segs.append(memoryview(bytearray(off - pos)))
                        pos = off
                    if off + size <= pos:
                        continue  # fully inside an already-covered range
                    if off < pos:  # partial overlap (shouldn't happen: chunks
                        view = view[pos - off:]  # are disjoint, but stay safe)
                        off = pos
                    segs.append(view)
                    pos = off + len(view)
                if pos < end:
                    segs.append(memoryview(bytearray(end - pos)))
                # split long runs so threads overlap I/O inside one pack, and
                # respect IOV_MAX per syscall
                cur: List[memoryview] = []
                cur_off = start
                cur_bytes = 0
                for seg in segs:
                    cur.append(seg)
                    cur_bytes += len(seg)
                    if cur_bytes >= _SPLIT_BYTES or len(cur) >= _IOV_MAX:
                        jobs.append((fd, cur_off, cur))
                        cur_off += cur_bytes
                        cur, cur_bytes = [], 0
                if cur:
                    jobs.append((fd, cur_off, cur))

        total = 0
        if parallel and len(jobs) > 1:
            for n in _get_io_pool().map(lambda j: _read_segments(*j), jobs):
                total += n
        else:
            for j in jobs:
                total += _read_segments(*j)

        for digest, view in dup:
            view[:] = primary[digest]
        return total

    def close(self) -> None:
        with self._lock:
            for m in self._mmaps.values():
                m.close()
            for f in self._files.values():
                f.close()  # type: ignore[attr-defined]
            for fd in self._fds.values():
                os.close(fd)
            self._mmaps.clear()
            self._files.clear()
            self._fds.clear()

    def drop_page_cache(self) -> None:
        """Evict pack pages from the OS page cache so benchmark reads hit
        the storage medium (closes mmaps first; they pin pages)."""
        self.close()
        pack_dir = os.path.join(self.root, "packs")
        for name in os.listdir(pack_dir):
            path = os.path.join(pack_dir, name)
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def chunk_payloads(
    buf: memoryview, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> List[memoryview]:
    """Split a serialized array buffer into chunk payload views."""
    return [buf[i : i + chunk_bytes] for i in range(0, len(buf), chunk_bytes)]
