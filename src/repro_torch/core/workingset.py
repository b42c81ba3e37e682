"""Working-set estimation (REAP-style, paper §4.2).

REAP restores a snapshot fully on-demand once, records which pages fault in,
and on subsequent cold-starts eagerly prefetches exactly that set.  In a
managed array runtime there are no hardware page faults to trap, so the
equivalent observation channel is *cooperative access tracking*: the serving
runtime materializes arrays through :class:`AccessLog`, which records which
arrays — and for gather-type accesses (embedding rows, MoE expert blocks)
which *row ranges* — a profiled request actually touches.

The resulting :class:`WorkingSet` is the paper's WS file: a set of
(array path, chunk index) pairs over the *diff* snapshot (SnapFaaS only
applies WS to diffs, §4.2 — base chunks are in RAM already, prefetching them
from disk is meaningless).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .snapshot import ArrayMeta, ResolvedArray

Path = str
ChunkKey = Tuple[Path, int]


def _atomic_json_dump(path: str, obj: object) -> None:
    """Write ``obj`` as JSON with the same crash-safe discipline as the
    chunk-store index: write a sibling tmp file, flush + fsync, then
    atomically rename over the destination.

    Registered as an approved atomic helper with the ``atomicio``
    analyzer pass (``repro.analysis``): persistent-state writes under
    ``core/`` must route through a helper like this one, and the A3 rule
    audits the helper body itself for the fsync + replace pair."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class AccessLog:
    """Records which parts of which arrays an execution touched."""

    touched_full: Set[Path] = field(default_factory=set)
    touched_rows: Dict[Path, Set[int]] = field(default_factory=dict)

    def touch(self, path: Path) -> None:
        """The whole array was (potentially) read."""
        self.touched_full.add(path)

    def touch_rows(self, path: Path, rows: Iterable[int]) -> None:
        """Only these leading-axis rows were read (embedding gather, expert
        dispatch).  Overrides ``touch`` for the same path."""
        self.touched_rows.setdefault(path, set()).update(int(r) for r in rows)

    def merge(self, other: "AccessLog") -> None:
        self.touched_full |= other.touched_full
        for p, rows in other.touched_rows.items():
            self.touched_rows.setdefault(p, set()).update(rows)


def rows_to_chunks(meta: ArrayMeta, rows: Iterable[int]) -> Set[int]:
    """Map touched leading-axis rows to chunk indices of the byte stream."""
    if not meta.shape:
        return {0}
    row_bytes = meta.nbytes // max(1, meta.shape[0])
    out: Set[int] = set()
    for r in rows:
        lo = r * row_bytes
        hi = (r + 1) * row_bytes
        out.update(range(lo // meta.chunk_bytes, (hi - 1) // meta.chunk_bytes + 1))
    return out


@dataclass
class WorkingSet:
    """The WS file: diff-snapshot chunks observed in one profiled run."""

    snapshot_id: str
    chunks: FrozenSet[ChunkKey]

    def __contains__(self, key: ChunkKey) -> bool:
        return key in self.chunks

    def size(self) -> int:
        return len(self.chunks)

    def bytes_for(self, resolved: Dict[Path, ResolvedArray]) -> int:
        total = 0
        for path, idx in self.chunks:
            ra = resolved.get(path)
            if ra is None or idx >= len(ra.sources):
                continue
            src, ref = ra.sources[idx]
            if src == "diff" and not ref.zero:
                total += ref.size
        return total

    def save(self, root: str) -> str:
        os.makedirs(os.path.join(root, "ws"), exist_ok=True)
        p = os.path.join(root, "ws", f"{self.snapshot_id}.json")
        _atomic_json_dump(p, {"snapshot_id": self.snapshot_id,
                              "chunks": sorted([list(c) for c in self.chunks])})
        return p

    @staticmethod
    def load(root: str, snapshot_id: str) -> "WorkingSet":
        p = os.path.join(root, "ws", f"{snapshot_id}.json")
        with open(p) as f:
            o = json.load(f)
        return WorkingSet(
            snapshot_id=o["snapshot_id"],
            chunks=frozenset((c[0], int(c[1])) for c in o["chunks"]),
        )


@dataclass
class ChunkRecording:
    """A measured working set: the chunks (in *array* coordinates, i.e. over
    the full-snapshot layout) that profiled executions of a function actually
    touched.

    Unlike :class:`WorkingSet` (which is a projection onto one snapshot's
    dirty chunks) a recording is snapshot-independent — it survives
    re-registration against a new diff and is merged across the N profiled
    requests REAP-style.  It is persisted per function under
    ``root/ws/recording-<function>.json`` with the same atomic fsync'd
    write-and-rename discipline as ``index.json``.
    """

    function: str
    chunks: FrozenSet[ChunkKey]
    version: int = 1
    n_profiles: int = 1

    def __contains__(self, key: ChunkKey) -> bool:
        return key in self.chunks

    def merged(self, other: "ChunkRecording") -> "ChunkRecording":
        """Union of two recordings (REAP merges the record of every profiled
        request); bumps the version so cached plans re-price."""
        return ChunkRecording(
            function=self.function,
            chunks=self.chunks | other.chunks,
            version=max(self.version, other.version) + 1,
            n_profiles=self.n_profiles + other.n_profiles,
        )

    def rows_for(self, path: Path, meta: ArrayMeta) -> Set[int]:
        """Chunk indices recorded for one array."""
        return {i for (p, i) in self.chunks if p == path}

    @staticmethod
    def _path_for(root: str, function: str) -> str:
        return os.path.join(root, "ws", f"recording-{function}.json")

    def save(self, root: str) -> str:
        os.makedirs(os.path.join(root, "ws"), exist_ok=True)
        p = self._path_for(root, self.function)
        _atomic_json_dump(p, {
            "function": self.function,
            "version": int(self.version),
            "n_profiles": int(self.n_profiles),
            "chunks": sorted([list(c) for c in self.chunks]),
        })
        return p

    @staticmethod
    def load(root: str, function: str) -> Optional["ChunkRecording"]:
        """Load a persisted recording; a missing, truncated, or corrupt file
        yields ``None`` (the caller falls back to eager restore) rather than
        an error — recordings are an optimisation, never a correctness
        dependency."""
        p = ChunkRecording._path_for(root, function)
        try:
            with open(p) as f:
                o = json.load(f)
            return ChunkRecording(
                function=str(o["function"]),
                chunks=frozenset((str(c[0]), int(c[1])) for c in o["chunks"]),
                version=int(o["version"]),
                n_profiles=int(o["n_profiles"]),
            )
        except (OSError, ValueError, KeyError, TypeError, IndexError):
            return None

    @staticmethod
    def delete(root: str, function: str) -> None:
        try:
            os.unlink(ChunkRecording._path_for(root, function))
        except OSError:
            pass


def build_recording(
    function: str,
    resolved: Dict[Path, ResolvedArray],
    log: AccessLog,
) -> ChunkRecording:
    """Convert an access log into a recording over *all* chunks of the
    full-snapshot layout (not just dirty ones).

    Unlike :func:`build_working_set`, row-level and full-array observations
    for the same path are *unioned*: a profiled run that gathered rows of an
    embedding and later streamed the whole table must record both.
    """
    keys: Set[ChunkKey] = set()
    for path, ra in resolved.items():
        nchunks = len(ra.sources)
        touched: Set[int] = set()
        if path in log.touched_full:
            touched.update(range(nchunks))
        if path in log.touched_rows:
            touched.update(i for i in rows_to_chunks(ra.meta, log.touched_rows[path])
                           if i < nchunks)
        keys.update((path, i) for i in touched)
    return ChunkRecording(function=function, chunks=frozenset(keys))


def build_working_set(
    snapshot_id: str,
    resolved: Dict[Path, ResolvedArray],
    log: AccessLog,
) -> WorkingSet:
    """Convert an access log into a WS over the *diff* chunks only."""
    keys: Set[ChunkKey] = set()
    for path, ra in resolved.items():
        dirty = set(ra.dirty_indices())
        if not dirty:
            continue
        if path in log.touched_rows:
            touched = rows_to_chunks(ra.meta, log.touched_rows[path])
            keys.update((path, i) for i in touched & dirty)
        elif path in log.touched_full:
            keys.update((path, i) for i in dirty)
    return WorkingSet(snapshot_id=snapshot_id, chunks=frozenset(keys))


def working_set_from_recording(
    snapshot_id: str,
    resolved: Dict[Path, ResolvedArray],
    recording: ChunkRecording,
) -> WorkingSet:
    """Project a measured recording onto one snapshot's dirty chunks.

    Stale entries (paths or chunk indices that no longer exist in the
    snapshot) are silently dropped — a recording taken against an older
    registration must degrade to a smaller WS, never to an error.
    """
    keys: Set[ChunkKey] = set()
    for path, idx in recording.chunks:
        ra = resolved.get(path)
        if ra is None or idx >= len(ra.sources):
            continue
        if ra.sources[idx][0] == "diff":
            keys.add((path, idx))
    return WorkingSet(snapshot_id=snapshot_id, chunks=frozenset(keys))
