"""Layered snapshots: base / diff manifests over the chunk store.

Paper mapping (§4, §5.2):

* **base snapshot** — everything initialized *before* any function-specific
  work: here, the pretrained weights of an architecture family (plus any
  family-level serving state).  One per "runtime"; cached in host RAM by the
  :class:`~repro.core.registry.ZygoteRegistry` and shared copy-on-write.
* **diff snapshot** — chunks dirtied by *function* initialization: here, the
  per-variant delta (fine-tuned tensors, adapter-merged layers, new heads).
  A diff records, per array, only the chunk indices whose digest differs from
  the base, "diff values override base values".
* **device state JSON** — the paper snapshots CPU registers + virtio device
  state into a JSON file.  Our analogue is the non-array instance state:
  RNG seed, step counter, config/mesh fingerprints.  Restoring it is the
  constant `c` of Eq. 1.

Manifests are topology-independent (chunks are cut over each array's logical
byte stream, not its device layout) — this is what makes *elastic* restore
(different mesh after a failure) possible, the paper-§9 "one snapshot per VM
size" limitation solved the way they propose.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .chunkstore import (
    DEFAULT_CHUNK_BYTES,
    ChunkRef,
    ChunkStore,
    chunk_payloads,
    scan_chunks,
    zero_ref,
)

# Pytree paths are flattened to "a/b/c" strings so manifests are pure JSON.
Path = str


@dataclass
class ArrayMeta:
    """Per-array manifest entry: logical shape/dtype + its chunk row."""

    shape: Tuple[int, ...]
    dtype: str
    chunk_bytes: int
    chunks: List[Optional[ChunkRef]]
    # For diff snapshots: indices present in ``chunks`` override the base;
    # ``None`` entries mean "inherit from base".  For base/full snapshots
    # every entry is a ChunkRef.

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape, dtype=np.int64)))

    def num_chunks(self) -> int:
        return len(self.chunks)

    def to_json(self) -> dict:
        return {
            "shape": list(self.shape),
            "dtype": self.dtype,
            "chunk_bytes": self.chunk_bytes,
            "chunks": [c.to_json() if c is not None else None for c in self.chunks],
        }

    @staticmethod
    def from_json(o: dict) -> "ArrayMeta":
        return ArrayMeta(
            shape=tuple(o["shape"]),
            dtype=o["dtype"],
            chunk_bytes=int(o["chunk_bytes"]),
            chunks=[ChunkRef.from_json(c) if c is not None else None for c in o["chunks"]],
        )


@dataclass
class SnapshotManifest:
    snapshot_id: str
    kind: str  # "base" | "diff" | "full"
    runtime: str  # architecture family ("zygote" identity)
    parent: Optional[str]  # base snapshot id for diffs
    mesh_fingerprint: str
    arrays: Dict[Path, ArrayMeta]
    device_state: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0

    # -- sizes ------------------------------------------------------------
    def logical_bytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())

    def stored_bytes(self) -> int:
        """Bytes of chunk payload this snapshot references (non-None, non-zero)."""
        total = 0
        for a in self.arrays.values():
            for c in a.chunks:
                if c is not None and not c.zero:
                    total += c.size
        return total

    def chunk_count(self) -> int:
        return sum(
            1 for a in self.arrays.values() for c in a.chunks if c is not None and not c.zero
        )

    def to_json(self) -> dict:
        return {
            "snapshot_id": self.snapshot_id,
            "kind": self.kind,
            "runtime": self.runtime,
            "parent": self.parent,
            "mesh_fingerprint": self.mesh_fingerprint,
            "device_state": self.device_state,
            "created_at": self.created_at,
            "arrays": {p: a.to_json() for p, a in self.arrays.items()},
        }

    @staticmethod
    def from_json(o: dict) -> "SnapshotManifest":
        return SnapshotManifest(
            snapshot_id=o["snapshot_id"],
            kind=o["kind"],
            runtime=o["runtime"],
            parent=o.get("parent"),
            mesh_fingerprint=o.get("mesh_fingerprint", ""),
            arrays={p: ArrayMeta.from_json(a) for p, a in o["arrays"].items()},
            device_state=o.get("device_state", {}),
            created_at=float(o.get("created_at", 0.0)),
        )

    def save(self, root: str) -> str:
        """Persist the manifest with the same fsync-and-rename discipline
        as the chunk index: rename-without-fsync can publish a manifest
        whose bytes never reached the platter, and a manifest that names
        chunks is the one file a crash must never truncate."""
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        p = os.path.join(root, "manifests", f"{self.snapshot_id}.json")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
        return p

    @staticmethod
    def load(root: str, snapshot_id: str) -> "SnapshotManifest":
        p = os.path.join(root, "manifests", f"{snapshot_id}.json")
        with open(p) as f:
            return SnapshotManifest.from_json(json.load(f))


# --------------------------------------------------------------------------
# pytree <-> flat path dict
# --------------------------------------------------------------------------

def flatten_pytree(tree: Any, prefix: str = "") -> Dict[Path, np.ndarray]:
    """Flatten a nested dict/list pytree of arrays to {'a/b/0': ndarray}."""
    out: Dict[Path, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(flatten_pytree(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_paths(flat: Dict[Path, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_pytree` into nested dicts (lists stay dicts
    keyed by their stringified index — callers that need exact structure keep
    their own treedef; the serving/training runtimes do)."""
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _array_bytes(arr: np.ndarray) -> memoryview:
    arr = np.ascontiguousarray(arr)
    return memoryview(arr).cast("B")


# --------------------------------------------------------------------------
# snapshot capture
# --------------------------------------------------------------------------

def take_snapshot(
    store: ChunkStore,
    snapshot_id: str,
    tree: Any,
    *,
    kind: str = "full",
    runtime: str = "generic",
    parent: Optional[str] = None,
    mesh_fingerprint: str = "",
    device_state: Optional[Dict[str, Any]] = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> SnapshotManifest:
    """Capture a full/base snapshot: every chunk of every array."""
    flat = tree if _is_flat(tree) else flatten_pytree(tree)
    pack = store.open_pack(snapshot_id)
    arrays: Dict[Path, ArrayMeta] = {}
    for path, arr in flat.items():
        buf = _array_bytes(arr)
        # one vectorized zero-scan + batched hash pass over the whole array
        refs = scan_chunks(buf, chunk_bytes)
        refs = store.put_chunks(pack, chunk_payloads(buf, chunk_bytes), refs=refs)
        arrays[path] = ArrayMeta(
            shape=tuple(arr.shape), dtype=str(arr.dtype), chunk_bytes=chunk_bytes, chunks=list(refs)
        )
    pack.close()
    store.save_index()
    m = SnapshotManifest(
        snapshot_id=snapshot_id,
        kind=kind,
        runtime=runtime,
        parent=parent,
        mesh_fingerprint=mesh_fingerprint,
        arrays=arrays,
        device_state=device_state or {},
        created_at=time.time(),
    )
    return m


def take_diff_snapshot(
    store: ChunkStore,
    snapshot_id: str,
    tree: Any,
    base: SnapshotManifest,
    *,
    runtime: Optional[str] = None,
    mesh_fingerprint: str = "",
    device_state: Optional[Dict[str, Any]] = None,
) -> SnapshotManifest:
    """Capture a diff snapshot against ``base``.

    This is the dirty-page-tracking capture of §5.2: for each array, chunk it
    and store only chunks whose digest differs from the base's chunk at the
    same index.  Arrays absent from the base (new heads, adapters) are stored
    in full.  Arrays identical to base contribute *zero* stored bytes.
    """
    flat = tree if _is_flat(tree) else flatten_pytree(tree)
    pack = store.open_pack(snapshot_id)
    arrays: Dict[Path, ArrayMeta] = {}
    for path, arr in flat.items():
        buf = _array_bytes(arr)
        base_meta = base.arrays.get(path)
        cb = base_meta.chunk_bytes if base_meta is not None else DEFAULT_CHUNK_BYTES
        payloads = chunk_payloads(buf, cb)
        if (
            base_meta is None
            or base_meta.shape != tuple(arr.shape)
            or base_meta.dtype != str(arr.dtype)
        ):
            # new or reshaped array: store whole
            refs = store.put_chunks(pack, payloads)
            arrays[path] = ArrayMeta(
                shape=tuple(arr.shape), dtype=str(arr.dtype), chunk_bytes=cb, chunks=list(refs)
            )
            continue
        chunks: List[Optional[ChunkRef]] = []
        dirty_payloads: List[memoryview] = []
        dirty_refs: List[ChunkRef] = []
        # one vectorized zero-scan + batched hash pass, then compare digests
        refs = scan_chunks(buf, cb)
        for i, (p, ref) in enumerate(zip(payloads, refs)):
            base_ref = base_meta.chunks[i]
            if ref.zero:
                chunks.append(None if base_ref == ref else ref)
                continue
            if base_ref is not None and base_ref.digest == ref.digest:
                chunks.append(None)  # clean — inherit from base
            else:
                dirty_payloads.append(p)
                dirty_refs.append(ref)
                chunks.append(ref)
        if dirty_payloads:
            store.put_chunks(pack, dirty_payloads, refs=dirty_refs)
        arrays[path] = ArrayMeta(
            shape=tuple(arr.shape), dtype=str(arr.dtype), chunk_bytes=cb, chunks=chunks
        )
    pack.close()
    store.save_index()
    return SnapshotManifest(
        snapshot_id=snapshot_id,
        kind="diff",
        runtime=runtime or base.runtime,
        parent=base.snapshot_id,
        mesh_fingerprint=mesh_fingerprint,
        arrays=arrays,
        device_state=device_state or {},
        created_at=time.time(),
    )


def _is_flat(tree: Any) -> bool:
    return isinstance(tree, dict) and all(
        isinstance(v, np.ndarray) for v in tree.values()
    )


def manifest_digests(*manifests: Optional[SnapshotManifest]) -> List[str]:
    """Every non-zero chunk digest the given manifests reference, with
    multiplicity *one per manifest* (refcounting unit: a manifest either
    needs a digest or it doesn't — how many of its arrays repeat the chunk
    is irrelevant to whether it may be collected)."""
    out: List[str] = []
    for m in manifests:
        if m is None:
            continue
        seen: set = set()
        for a in m.arrays.values():
            for c in a.chunks:
                if c is not None and not c.zero and c.digest not in seen:
                    seen.add(c.digest)
                    out.append(c.digest)
    return out


def synthesize_full(
    base: SnapshotManifest,
    diff: SnapshotManifest,
    snapshot_id: str,
) -> SnapshotManifest:
    """Build a *full* manifest for the (base, diff) stack without touching
    a single payload byte.

    This is the content-addressed capture path for functions registered
    from a shared base: the effective chunk map is resolved (diff overrides
    base) and written down as a full manifest whose every ChunkRef points
    at chunks the store already holds.  No re-chunking, no re-hashing, no
    pack writes — where :func:`take_snapshot` pays a full scan of every
    array, this pays a dictionary merge.
    """
    resolved = resolve(base, diff)
    arrays: Dict[Path, ArrayMeta] = {}
    for path, ra in resolved.items():
        arrays[path] = ArrayMeta(
            shape=ra.meta.shape, dtype=ra.meta.dtype,
            chunk_bytes=ra.meta.chunk_bytes,
            chunks=[ref for _, ref in ra.sources],
        )
    device_state = dict(base.device_state)
    device_state.update(diff.device_state)
    return SnapshotManifest(
        snapshot_id=snapshot_id,
        kind="full",
        runtime=diff.runtime or base.runtime,
        parent=None,
        mesh_fingerprint=diff.mesh_fingerprint or base.mesh_fingerprint,
        arrays=arrays,
        device_state=device_state,
        created_at=time.time(),
    )


# --------------------------------------------------------------------------
# layered resolution
# --------------------------------------------------------------------------

@dataclass
class ResolvedArray:
    """Effective view of one array through a (base, diff) stack."""

    path: Path
    meta: ArrayMeta  # shape/dtype/chunking of the *effective* array
    # per chunk index: ("base"|"diff", ChunkRef)
    sources: List[Tuple[str, ChunkRef]]

    def dirty_indices(self) -> List[int]:
        return [i for i, (src, _) in enumerate(self.sources) if src == "diff"]


def resolve(base: Optional[SnapshotManifest], diff: Optional[SnapshotManifest]) -> Dict[Path, ResolvedArray]:
    """Compute the effective chunk map: diff overrides base (§4.1)."""
    out: Dict[Path, ResolvedArray] = {}
    if base is not None and diff is not None and diff.parent != base.snapshot_id:
        raise ValueError(
            f"diff {diff.snapshot_id} was cut against base {diff.parent}, not {base.snapshot_id}"
        )
    base_arrays = base.arrays if base is not None else {}
    diff_arrays = diff.arrays if diff is not None else {}
    for path in sorted(set(base_arrays) | set(diff_arrays)):
        bmeta = base_arrays.get(path)
        dmeta = diff_arrays.get(path)
        if dmeta is None:
            assert bmeta is not None
            sources = [("base", c) for c in bmeta.chunks]  # type: ignore[list-item]
            out[path] = ResolvedArray(path=path, meta=bmeta, sources=sources)  # type: ignore[arg-type]
            continue
        if bmeta is None or bmeta.shape != dmeta.shape or bmeta.dtype != dmeta.dtype:
            # diff fully defines the array
            sources = [("diff", c) for c in dmeta.chunks]  # type: ignore[list-item]
            out[path] = ResolvedArray(path=path, meta=dmeta, sources=sources)  # type: ignore[arg-type]
            continue
        sources = []
        for i, dref in enumerate(dmeta.chunks):
            if dref is None:
                sources.append(("base", bmeta.chunks[i]))
            else:
                sources.append(("diff", dref))
        out[path] = ResolvedArray(path=path, meta=dmeta, sources=sources)
    return out
