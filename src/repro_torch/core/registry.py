"""Zygote registry: base snapshots per runtime family + function lifecycle.

This is the worker-side realization of the paper's Fig. 4 workflow:

* **system bootstrap** — ``register_runtime`` generates a base snapshot per
  supported runtime (architecture family) and loads it into the in-RAM pool
  (the cluster manager's replication step).
* **function registration** — ``register_function`` converts the variant's
  source into a diff snapshot against the family base, then invokes it once
  with mock arguments under access tracking to produce the WS file.
* **client request (cold)** — ``cold_start`` restores an instance using the
  requested strategy; the controller (serving layer) then executes.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .chunkstore import DEFAULT_CHUNK_BYTES, ChunkRef, ChunkStore
from .metrics import ColdStartMetrics
from .planner import SnapshotSizes, StorageModel
from .tiers import PrefetchStats, TieredChunkStore, TierSpec
from .restore import (
    BasePool,
    RestoredInstance,
    restore_layered,
    restore_reap,
    restore_regular,
    restore_seuss,
)
from .restore_plan import RestorePlan, build_restore_plan, execute_restore_plan
from .snapshot import (
    SnapshotManifest,
    flatten_pytree,
    manifest_digests,
    resolve,
    synthesize_full,
    take_diff_snapshot,
    take_snapshot,
)
from .workingset import (
    AccessLog,
    ChunkRecording,
    WorkingSet,
    build_recording,
    build_working_set,
    working_set_from_recording,
)

Path = str

STRATEGIES = ("regular", "reap", "seuss", "snapfaas-", "snapfaas")

# snapshot strategies served by the planned restore engine (the others
# restore via source loaders and have no plan)
PLANNED_STRATEGIES = ("reap", "snapfaas-", "snapfaas")


@dataclass
class FunctionRecord:
    name: str
    runtime: str
    diff: SnapshotManifest
    full: SnapshotManifest              # REAP baseline needs a full snapshot
    ws: Optional[WorkingSet] = None     # over the diff (SnapFaaS)  # guarded-by: plan_lock [writes]
    ws_full: Optional[WorkingSet] = None  # over the full (REAP)  # guarded-by: plan_lock [writes]
    # measured working set: chunks recorded from real profiled invocations
    # (REAP record mode); persisted per function, survives reopen, merged
    # across profiles.  When present it overrides declared access logs.
    recording: Optional[ChunkRecording] = None  # guarded-by: plan_lock [writes]
    source_path: str = ""               # original checkpoint (SEUSS/regular)
    init_compute_s: float = 0.0         # measured function-init compute
    plans: Dict[str, RestorePlan] = field(default_factory=dict)  # per strategy  # guarded-by: plan_lock
    # cached eager-set refs per planner category (residency-independent;
    # cleared with the working set) — keeps tier-movement replans to a
    # residency() dict lookup instead of two full resolve() passes
    category_refs: Optional[Dict[str, List[ChunkRef]]] = None  # guarded-by: plan_lock
    # serialises plan build + tier-split refresh: concurrent refreshes
    # interleaving their (tier_split, residency_epoch) writes could pin a
    # stale split under the newest epoch — permanently, until the next
    # movement (no further bump would ever invalidate it)
    plan_lock: threading.Lock = field(default_factory=threading.Lock,
                                      repr=False, compare=False)


class ZygoteRegistry:
    """One per worker. Owns the storage hierarchy, base pools and function
    records.  The store is a :class:`~repro.core.tiers.TieredChunkStore`
    (RAM chunk cache over local packs over an optional simulated remote
    tier); ``tiers`` configures capacities and the remote throttle."""

    def __init__(
        self,
        root: str,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        tiers: Optional[TierSpec] = None,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.store = TieredChunkStore(os.path.join(root, "store"), spec=tiers)
        self.chunk_bytes = chunk_bytes
        self.bases: Dict[str, SnapshotManifest] = {}
        self.pools: Dict[str, BasePool] = {}
        self.functions: Dict[str, FunctionRecord] = {}
        # the RAM-resident base pools double as a repair source: a base
        # chunk lost or corrupted in every stream tier re-synthesizes from
        # the pool's bytes (digest-verified by the store before it is
        # served or re-registered)
        self._base_index: Optional[Dict[str, Tuple[str, Any, int]]] = None  # guarded-by: _base_index_lock
        self._base_index_lock = threading.Lock()
        self.store.add_fallback_source(self._base_chunk_payload)

    # -- bootstrap ----------------------------------------------------------

    def register_runtime(
        self,
        family: str,
        base_tree: Any,
        *,
        device_state: Optional[Dict[str, Any]] = None,
        mesh_fingerprint: str = "",
    ) -> SnapshotManifest:
        base = take_snapshot(
            self.store, f"base-{family}", base_tree,
            kind="base", runtime=family, mesh_fingerprint=mesh_fingerprint,
            device_state=device_state, chunk_bytes=self.chunk_bytes,
        )
        base.save(self.root)
        # the runtime (zygote) itself owns the base chunks, independent of
        # any function — deregistering every function must not collect them
        self.store.pin(manifest_digests(base), owner=base.snapshot_id)
        self.bases[family] = base
        self.pools[family] = BasePool.load(self.store, base)
        with self._base_index_lock:
            self._base_index = None     # rebuilt lazily over the new base
        return base

    def _base_chunk_payload(self, ref: ChunkRef) -> Optional[bytes]:
        """Repair source for the tiered store: re-synthesize a base-content
        chunk from the RAM-resident base pools.  Returns ``None`` for
        digests that are not base content — the store then gives up and
        raises typed."""
        with self._base_index_lock:
            index = self._base_index
            if index is None:
                index = {}
                for family, base in self.bases.items():
                    for path, meta in base.arrays.items():
                        for i, cref in enumerate(meta.chunks):
                            if cref is not None and not cref.zero:
                                index.setdefault(cref.digest,
                                                 (family, path, i))
                self._base_index = index
        entry = index.get(ref.digest)
        if entry is None:
            return None
        family, path, idx = entry
        pool = self.pools.get(family)
        if pool is None:
            return None
        try:
            return bytes(pool.chunk_bytes_of(path, idx))
        except (KeyError, IndexError):
            return None

    # -- registration ---------------------------------------------------------

    def register_function(
        self,
        name: str,
        family: str,
        variant_tree: Any,
        *,
        source_path: str = "",
        device_state: Optional[Dict[str, Any]] = None,
    ) -> FunctionRecord:
        """Register a function from its *complete* variant tree.

        The diff capture dedups against the base by digest, and the full
        capture dedups against the whole index (put_chunks), so a sibling
        sharing the base writes only its unique chunks — but it still pays
        the full scan-and-hash pass over every array.  Functions that are
        *born* as a delta should use :meth:`register_from_base`, which
        skips the full capture entirely.
        """
        if name in self.functions:
            raise ValueError(f"function {name!r} already registered")
        base = self.bases[family]
        flat = flatten_pytree(variant_tree) if not _flat(variant_tree) else variant_tree
        diff = take_diff_snapshot(
            self.store, f"diff-{name}", flat, base, device_state=device_state,
        )
        diff.save(self.root)
        full = take_snapshot(
            self.store, f"full-{name}", flat,
            kind="full", runtime=family, device_state=device_state,
            chunk_bytes=self.chunk_bytes,
        )
        full.save(self.root)
        return self._record(name, family, diff, full, source_path)

    def register_from_base(
        self,
        name: str,
        family: str,
        delta_tree: Any,
        *,
        source_path: str = "",
        device_state: Optional[Dict[str, Any]] = None,
    ) -> FunctionRecord:
        """Shared-base registration: the content-addressed fast path.

        ``delta_tree`` holds only the arrays that differ from (or don't
        exist in) the family base; everything absent inherits the base
        byte-for-byte.  Capture cost is proportional to the *delta*: the
        diff snapshot chunks and hashes only the delta arrays, and the
        full manifest is synthesized from the (base, diff) resolution
        without reading or writing a single payload byte
        (:func:`~repro.core.snapshot.synthesize_full`).  Ten functions
        sharing one base store the base once plus ten deltas.
        """
        if name in self.functions:
            raise ValueError(f"function {name!r} already registered")
        base = self.bases[family]
        flat = flatten_pytree(delta_tree) if not _flat(delta_tree) else delta_tree
        diff = take_diff_snapshot(
            self.store, f"diff-{name}", flat, base, device_state=device_state,
        )
        diff.save(self.root)
        full = synthesize_full(base, diff, f"full-{name}")
        full.save(self.root)
        return self._record(name, family, diff, full, source_path)

    def _record(
        self, name: str, family: str, diff: SnapshotManifest,
        full: SnapshotManifest, source_path: str,
    ) -> FunctionRecord:
        # ONE owner per function over the union of its manifests' digests:
        # a chunk referenced by both the diff and the synthesized full is
        # still one function-reference, so a function-private chunk never
        # masquerades as cross-function shared
        self.store.pin(set(manifest_digests(diff, full)), owner=name)
        rec = FunctionRecord(
            name=name, runtime=family, diff=diff, full=full, source_path=source_path,
        )
        # a persisted recording from an earlier profiled run survives
        # registry reopen / re-registration; a truncated or corrupt file
        # loads as None (fall back to declared/eager behavior, never error)
        rec.recording = ChunkRecording.load(self.root, name)  # unguarded-ok: record not yet published
        self.functions[name] = rec
        return rec

    def deregister_function(self, name: str, *, compact: bool = False) -> int:
        """Remove a function and garbage-collect its now-unreferenced
        chunks (refcounted: chunks shared with the base or with sibling
        functions survive untouched).  Returns the bytes made unreachable
        by THIS deregistration; pass ``compact=True`` to also rewrite the
        local packs, physically reclaiming all accumulated garbage (its
        total is not folded into the return value).
        """
        rec = self.functions.pop(name, None)
        if rec is None:
            raise KeyError(name)  # keyerror-ok: lookup contract — name never registered, not a fault
        dead = self.store.unpin(
            set(manifest_digests(rec.diff, rec.full)), owner=name
        )
        freed = self.store.reclaim(dead) if hasattr(self.store, "reclaim") \
            else self.store.forget(dead)
        for m in (rec.diff, rec.full):
            p = os.path.join(self.root, "manifests", f"{m.snapshot_id}.json")
            if os.path.exists(p):
                os.unlink(p)
        for ws in (rec.ws, rec.ws_full):
            if ws is not None:
                p = os.path.join(self.root, "ws", f"{ws.snapshot_id}.json")
                if os.path.exists(p):
                    os.unlink(p)
        ChunkRecording.delete(self.root, name)
        self.store.save_index()
        if compact:
            self.store.compact()
        return freed

    # -- dedup accounting -----------------------------------------------------

    def dedup_stats(self) -> Dict[str, object]:
        """Cross-function dedup effectiveness of the content-addressed
        store: ``referenced_bytes`` is what per-function (flat) stores
        would hold — one full snapshot per function plus each runtime's
        base — vs the ``unique_bytes`` actually stored.  Diff manifests
        are not counted: their digests are a subset of the function's full
        manifest, so adding them would overstate the ratio."""
        referenced = 0
        for fam, base in self.bases.items():
            referenced += base.stored_bytes()
        for rec in self.functions.values():
            referenced += rec.full.stored_bytes()
        unique = self.store.stored_bytes()
        shared = self.store.shared_digests() \
            if hasattr(self.store, "shared_digests") else set()
        return {
            "functions": len(self.functions),
            "referenced_bytes": referenced,
            "unique_bytes": unique,
            "dedup_ratio": round(unique / referenced, 4) if referenced else 1.0,
            "shared_digests": len(shared),
        }

    def generate_working_set(self, name: str, log: AccessLog) -> None:
        """Mock invocation already happened under ``log``; cut WS files.

        A *measured* recording (from :meth:`record_access`, possibly loaded
        from disk at registration) takes precedence over the declared log:
        re-registration must not clobber what profiled executions observed.

        The WS swap and plan-cache clear happen under the record's
        ``plan_lock``: a plan build racing this method either finishes
        first (and is cleared here) or starts after (and reads the new
        working set) — it can never re-publish a stale-WS plan right
        after the clear, where nothing would ever invalidate it."""
        rec = self.functions[name]
        base = self.bases[rec.runtime]
        if rec.recording is not None:
            ws = working_set_from_recording(
                rec.diff.snapshot_id, resolve(base, rec.diff), rec.recording
            )
            ws_full = working_set_from_recording(
                rec.full.snapshot_id, resolve(None, rec.full), rec.recording
            )
        else:
            ws = build_working_set(
                rec.diff.snapshot_id, resolve(base, rec.diff), log
            )
            ws_full = build_working_set(
                rec.full.snapshot_id, resolve(None, rec.full), log
            )
        with rec.plan_lock:
            rec.ws = ws
            rec.ws_full = ws_full
            rec.plans.clear()  # WS changed → cached eager placement is stale
            rec.category_refs = None
        ws.save(self.root)
        ws_full.save(self.root)

    def record_access(self, name: str, log: AccessLog) -> ChunkRecording:
        """Fold one profiled invocation's access log into the function's
        recording (REAP's record phase), re-cut the working sets from the
        merged recording, and persist everything crash-safely.

        Recordings are merged across the N profiled requests: the recorded
        set only ever grows, so a chunk any profile touched is prefetched
        for all future demand-paged restores."""
        rec = self.functions[name]
        base = self.bases[rec.runtime]
        new = build_recording(name, resolve(None, rec.full), log)
        merged = rec.recording.merged(new) if rec.recording is not None else new
        ws = working_set_from_recording(
            rec.diff.snapshot_id, resolve(base, rec.diff), merged
        )
        ws_full = working_set_from_recording(
            rec.full.snapshot_id, resolve(None, rec.full), merged
        )
        with rec.plan_lock:
            rec.recording = merged
            rec.ws = ws
            rec.ws_full = ws_full
            rec.plans.clear()
            rec.category_refs = None
        merged.save(self.root)      # atomic write-and-rename (crash-safe)
        ws.save(self.root)
        ws_full.save(self.root)
        return merged

    # -- tier movement --------------------------------------------------------

    def _category_refs(self, name: str) -> Dict[str, List[ChunkRef]]:
        """Eager-set chunk refs per planner category (full/diff/ws/ws_full).

        Cached on the record: the categorisation depends only on manifests
        and working sets, not tier residency, so tier movement never pays
        the resolve passes again.

        Compute *and* publish run under ``plan_lock``: a lock-free
        check-then-act here could read the old working set, lose the race
        with :meth:`generate_working_set`'s swap-and-clear, and then
        publish refs cut from the dead WS — permanently, since nothing
        would ever invalidate them again."""
        rec = self.functions[name]
        with rec.plan_lock:
            return self._category_refs_locked(rec)

    def _category_refs_locked(
        self, rec: FunctionRecord
    ) -> Dict[str, List[ChunkRef]]:  # holds-lock: plan_lock
        if rec.category_refs is not None:
            return rec.category_refs
        base = self.bases[rec.runtime]
        resolved = resolve(base, rec.diff)
        full_resolved = resolve(None, rec.full)
        out: Dict[str, List[ChunkRef]] = {
            "full": [
                c for a in rec.full.arrays.values()
                for c in a.chunks if c is not None and not c.zero
            ],
            "diff": [
                ra.sources[i][1]
                for ra in resolved.values()
                for i in ra.dirty_indices()
                if not ra.sources[i][1].zero
            ],
        }
        for key, ws, res in (("ws", rec.ws, resolved),
                             ("ws_full", rec.ws_full, full_resolved)):
            refs: List[ChunkRef] = []
            if ws is not None:
                for path, idx in ws.chunks:
                    ra = res.get(path)
                    if ra is None or idx >= len(ra.sources):
                        continue
                    _, ref = ra.sources[idx]
                    if not ref.zero:
                        refs.append(ref)
            out[key] = refs
        rec.category_refs = out
        return out

    def prefetch_working_set(
        self, name: str, category: str = "ws"
    ) -> PrefetchStats:
        """Promote ``name``'s working set into the warm tiers (RAM cache +
        local packs) — the registration/shard-assignment prefetch step.
        Remote-resident WS chunks cross the throttled link here, once, so
        cold starts stop paying it.

        ``category`` selects which eager set to warm: ``"ws"`` (default;
        falls back to the whole diff when no WS was generated), ``"diff"``,
        ``"ws_full"`` or ``"full"``.  The full-snapshot categories matter
        for cross-function sharing: warming one function's ``ws_full``
        RAM-caches the base-content chunks every sibling's REAP restore
        reads, because residency is digest-keyed, not function-keyed."""
        if category not in ("ws", "diff", "ws_full", "full"):
            raise ValueError(
                f"unknown prefetch category {category!r}; one of "
                f"'ws', 'diff', 'ws_full', 'full'"
            )
        cats = self._category_refs(name)
        if category == "ws":
            refs = cats["ws"] if cats["ws"] else cats["diff"]
        else:
            refs = cats[category]
        return self.store.prefetch(refs)

    def demote_function(self, name: str) -> int:
        """Move ``name``'s snapshot chunks to the remote tier (simulating a
        function whose snapshots were captured on another worker).  Base
        chunks shared with the runtime family stay local — demoting them
        would move every sibling function's data too."""
        rec = self.functions[name]
        base = self.bases[rec.runtime]
        base_digests = {
            c.digest for a in base.arrays.values()
            for c in a.chunks if c is not None and not c.zero
        }
        refs = [
            c for m in (rec.diff, rec.full) for a in m.arrays.values()
            for c in a.chunks
            if c is not None and not c.zero and c.digest not in base_digests
        ]
        return self.store.demote(refs)

    # -- cold start -----------------------------------------------------------

    def _refresh_tier_split(self, plan: RestorePlan) -> None:
        """Re-derive a plan's ``tier_split`` when residency moved — with the
        epoch taken *atomically* with the rebuild.

        The former check-then-act (read epoch, compute residency, publish
        both) raced concurrent tier movement two ways: a demote completing
        mid-``residency()`` could publish a half-moved split, and two
        interleaved refreshes could leave a stale split pinned under the
        newest epoch — which no future bump would ever invalidate.  Callers
        hold the record's ``plan_lock`` (one refresh at a time); here the
        epoch is re-checked after the residency pass, retrying if movement
        landed during it."""
        for _ in range(4):
            epoch = self.store.residency_epoch
            if plan.residency_epoch == epoch:
                return
            split = self.store.residency(plan.eager_refs())
            if self.store.residency_epoch == epoch:
                plan.tier_split = split
                plan.residency_epoch = epoch
                return
        # movement kept landing during the rebuild: publish the last split
        # under the epoch read *before* it was computed — conservatively
        # stale, so the very next call re-derives it
        plan.tier_split = split
        plan.residency_epoch = epoch

    def restore_plan(
        self, name: str, strategy: str, *, demand_paged: bool = False
    ) -> RestorePlan:
        """The cached RestorePlan for (function, strategy); built on first
        use, with its tier placement refreshed when residency moved.

        Resolving layers, classifying chunks and computing scatter-read
        destinations happens here exactly once — chunk classification does
        not depend on tier residency, so promotion/demotion (which bumps
        the store's ``residency_epoch``) only re-derives the plan's
        ``tier_split`` (a dict lookup per eager digest), never the plan.
        Build and refresh run under the record's ``plan_lock``: concurrent
        cold starts of one function see exactly one plan, and a tier-split
        refresh can never interleave with another and pin a stale split
        under a fresh epoch.

        ``demand_paged`` selects the record-and-prefetch variant: the same
        chunk classification, but the eager set becomes a background
        prefetch and everything materializes lazily (cached separately).
        """
        rec = self.functions[name]
        with rec.plan_lock:
            return self._restore_plan_locked(
                rec, name, strategy, demand_paged=demand_paged
            )

    def _restore_plan_locked(
        self, rec: FunctionRecord, name: str, strategy: str,
        *, demand_paged: bool = False,
    ) -> RestorePlan:  # holds-lock: plan_lock
        key = strategy + ("+demand" if demand_paged else "")
        plan = rec.plans.get(key)
        if plan is not None:
            self._refresh_tier_split(plan)
            return plan
        base = self.bases[rec.runtime]
        if strategy == "snapfaas":
            if rec.ws is None:
                raise ValueError(f"{name}: no working set; run generate_working_set")
            plan = build_restore_plan(
                base, rec.diff, working_set=rec.ws,
                strategy="snapfaas", function=name, store=self.store,
                demand_paged=demand_paged,
            )
        elif strategy == "snapfaas-":
            plan = build_restore_plan(
                base, rec.diff, working_set=None,
                strategy="snapfaas-", function=name, store=self.store,
                demand_paged=demand_paged,
            )
        elif strategy == "reap":
            plan = build_restore_plan(
                None, rec.full, working_set=rec.ws_full,
                strategy="reap", function=name, use_pool=False,
                store=self.store, demand_paged=demand_paged,
            )
        else:
            raise ValueError(f"no restore plan for strategy {strategy!r}")
        rec.plans[key] = plan
        return plan

    def cold_start(
        self,
        name: str,
        strategy: str,
        *,
        residual_init: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
        source_loader: Optional[Callable[[], Dict[Path, np.ndarray]]] = None,
        base_loader: Optional[Callable[[], Dict[Path, np.ndarray]]] = None,
        engine: Optional[str] = None,
        promote: Optional[bool] = None,
        demand_paged: bool = False,
    ) -> RestoredInstance:
        """Cold-start ``name`` with ``strategy``.

        ``engine`` selects the snapshot-restore implementation for the
        snapshot strategies: "planned" (default; cached RestorePlan +
        zero-copy parallel scatter-reads) or "legacy" (the seed per-restore
        resolve + 3-copy batched read — kept as the benchmark baseline).
        Defaults to ``$REPRO_RESTORE_ENGINE`` or "planned".

        ``promote`` is the tier hint: whether remote-fetched eager chunks
        are promoted into the warm tiers (None → store default).

        ``demand_paged`` requests record-and-prefetch restore: background
        prefetch of the recorded set plus lazy verified fault-in.  Honored
        only for the planned snapshot strategies; everything else (legacy
        engine, seuss/regular) silently restores eagerly — demand paging is
        an optimisation, never a correctness dependency.
        """
        rec = self.functions[name]
        base = self.bases[rec.runtime]
        pool = self.pools[rec.runtime]
        engine = engine or os.environ.get("REPRO_RESTORE_ENGINE", "planned")
        if engine not in ("planned", "legacy"):
            raise ValueError(f"unknown restore engine {engine!r}")
        if engine == "planned" and strategy in PLANNED_STRATEGIES:
            plan = self.restore_plan(name, strategy, demand_paged=demand_paged)
            return execute_restore_plan(
                plan, self.store, pool if strategy != "reap" else None,
                residual_init=residual_init, promote=promote,
            )
        if strategy == "snapfaas":
            if rec.ws is None:
                raise ValueError(f"{name}: no working set; run generate_working_set")
            return restore_layered(
                self.store, base, rec.diff, pool,
                working_set=rec.ws, residual_init=residual_init, function=name,
            )
        if strategy == "snapfaas-":
            return restore_layered(
                self.store, base, rec.diff, pool,
                working_set=None, residual_init=residual_init, function=name,
            )
        if strategy == "reap":
            return restore_reap(
                self.store, rec.full, working_set=rec.ws_full,
                residual_init=residual_init, function=name,
            )
        if strategy == "seuss":
            assert source_loader is not None, "seuss needs a source loader"
            return restore_seuss(
                self.store, base, pool,
                source_loader=source_loader, residual_init=residual_init,
                function=name,
            )
        if strategy == "regular":
            assert source_loader is not None and base_loader is not None
            return restore_regular(
                source_loader=source_loader, base_loader=base_loader,
                residual_init=residual_init, function=name,
            )
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")

    # -- model facts ------------------------------------------------------------

    def sizes(self, name: str, *, residual_init_s: float = 0.0) -> SnapshotSizes:
        """Byte-level facts for Eq. 1.  All eager-set byte counts are
        *unique* (digest-deduped) — the scatter-read engine reads each
        digest once however many chunks reference it, so deduped bytes are
        what the B term actually streams.  ``shared_hit_fracs`` carries,
        per category, the fraction of those bytes that are multi-referenced
        (shared with the base or a sibling function) *and* currently
        RAM-resident — the expected cross-function warm-hit discount for
        flat (non-tiered) storage models."""
        rec = self.functions[name]
        base = self.bases[rec.runtime]
        resolved = resolve(base, rec.diff)
        cats = self._category_refs(name)
        shared_digests = self.store.shared_digests() \
            if hasattr(self.store, "shared_digests") else set()

        unique: Dict[str, int] = {}
        shared_hit_fracs: Dict[str, float] = {}
        for key, refs in cats.items():
            seen = set()
            total = hit = 0
            for r in refs:
                if r.zero or r.digest in seen:
                    continue
                seen.add(r.digest)
                total += r.size
                if r.digest in shared_digests and \
                        self.store.tier_of(r.digest) == "ram":
                    hit += r.size
            unique[key] = total
            shared_hit_fracs[key] = hit / total if total else 0.0

        diff_bytes = unique["diff"]
        ws_bytes = unique["ws"] if rec.ws is not None else diff_bytes
        shared = sum(
            ra.meta.nbytes for ra in resolved.values() if not ra.dirty_indices()
        )
        # actual residency split of each strategy's eager set, so a
        # TieredStorageModel prices B from where the bytes really live
        tier_splits = {
            key: self.store.residency(refs) for key, refs in cats.items()
        }
        # measured recording (if any): digest-unique bytes of the recorded
        # set over the full snapshot — what a demand-paged restore prefetches
        recorded_bytes = recorded_chunks = 0
        if rec.recording is not None:
            full_resolved = resolve(None, rec.full)
            seen_rec = set()
            for path, idx in rec.recording.chunks:
                ra = full_resolved.get(path)
                if ra is None or idx >= len(ra.sources):
                    continue
                ref = ra.sources[idx][1]
                if ref.zero or ref.digest in seen_rec:
                    continue
                seen_rec.add(ref.digest)
                recorded_bytes += ref.size
                recorded_chunks += 1
        return SnapshotSizes(
            full_bytes=unique["full"],
            diff_bytes=diff_bytes,
            ws_bytes=ws_bytes,
            ws_full_bytes=unique["ws_full"],
            ws_chunks=rec.ws.size() if rec.ws else 0,
            non_ws_diff_bytes=max(0, diff_bytes - ws_bytes),
            non_ws_diff_chunks=0,
            shared_bytes=shared,
            cow_bytes=0,
            cow_faults=0,
            init_compute=rec.init_compute_s,
            residual_init=residual_init_s,
            tier_splits=tier_splits,
            shared_hit_fracs=shared_hit_fracs,
            recorded_bytes=recorded_bytes,
            recorded_chunks=recorded_chunks,
            has_recording=rec.recording is not None,
        )


def _flat(tree: Any) -> bool:
    return isinstance(tree, dict) and all(isinstance(v, np.ndarray) for v in tree.values())
