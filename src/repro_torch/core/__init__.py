"""SnapFaaS-in-JAX core: layered snapshot engine for model-instance
cold-starts (the paper's primary contribution, adapted to a TPU fleet).

Public API:

* :class:`~repro.core.chunkstore.ChunkStore` — content-addressed pack store
* :func:`~repro.core.snapshot.take_snapshot` / ``take_diff_snapshot`` /
  ``resolve`` — layered base/diff manifests
* :class:`~repro.core.workingset.AccessLog` / ``build_working_set`` — REAP-
  style working-set files
* :mod:`~repro.core.restore` — regular / reap / seuss / snapfaas− / snapfaas
  restoration strategies with A/B/C/D metrics
* :mod:`~repro.core.planner` — Eq. 1 first-principles cold-start model
* :class:`~repro.core.registry.ZygoteRegistry` — worker-side lifecycle
"""

from .chunkstore import (
    DEFAULT_CHUNK_BYTES,
    INDEX_VERSION,
    ChunkRef,
    ChunkStore,
    DigestCollisionError,
    IndexCorruptionError,
)
from .faults import (
    CHAOS_PROFILES,
    ChunkIntegrityError,
    CircuitBreaker,
    DeadlineExceededError,
    FaultError,
    FaultInjector,
    FaultMatrix,
    FaultyTier,
    RetryPolicy,
    TierReadError,
    TierUnavailableError,
    WorkerCrashError,
    chaos_profile,
)
from .metrics import ColdStartMetrics
from .planner import (
    PAPER_C220G5,
    TPU_LOCAL_SSD,
    TPU_OBJECT_STORE,
    TPU_TIERED,
    ColdStartPrediction,
    SnapshotSizes,
    StorageModel,
    TieredStorageModel,
    TierModel,
    calibrate_container,
    lower_bound,
    plan_restore,
    predict,
    predict_demand_paged,
)
from .tiers import (
    PackTier,
    PrefetchStats,
    RamCacheTier,
    RemoteTier,
    StorageTier,
    TieredChunkStore,
    TierReadStats,
    TierSpec,
)
from .registry import PLANNED_STRATEGIES, STRATEGIES, FunctionRecord, ZygoteRegistry
from .restore import (
    ArrayPatch,
    BasePool,
    MaterializedArray,
    RestoredInstance,
    restore_layered,
    restore_reap,
    restore_regular,
    restore_seuss,
)
from .restore_plan import (
    RestorePlan,
    build_restore_plan,
    execute_restore_plan,
)
from .snapshot import (
    ArrayMeta,
    SnapshotManifest,
    flatten_pytree,
    manifest_digests,
    resolve,
    synthesize_full,
    take_diff_snapshot,
    take_snapshot,
    unflatten_paths,
)
from .workingset import (
    AccessLog,
    ChunkRecording,
    WorkingSet,
    build_recording,
    build_working_set,
    working_set_from_recording,
)

__all__ = [
    "AccessLog", "ArrayMeta", "ArrayPatch", "BasePool", "CHAOS_PROFILES",
    "ChunkIntegrityError", "ChunkRecording", "ChunkRef",
    "ChunkStore", "CircuitBreaker", "ColdStartMetrics", "ColdStartPrediction",
    "DEFAULT_CHUNK_BYTES", "DeadlineExceededError", "DigestCollisionError",
    "FaultError", "FaultInjector", "FaultMatrix", "FaultyTier",
    "FunctionRecord",
    "INDEX_VERSION", "IndexCorruptionError",
    "RetryPolicy", "TierReadError", "TierUnavailableError",
    "WorkerCrashError", "chaos_profile",
    "MaterializedArray", "manifest_digests", "synthesize_full",
    "PAPER_C220G5", "PLANNED_STRATEGIES", "PackTier", "PrefetchStats",
    "RamCacheTier", "RemoteTier", "RestoredInstance", "RestorePlan",
    "STRATEGIES",
    "SnapshotManifest", "SnapshotSizes", "StorageModel", "StorageTier",
    "TPU_LOCAL_SSD",
    "TPU_OBJECT_STORE", "TPU_TIERED", "TierModel", "TierReadStats",
    "TierSpec", "TieredChunkStore", "TieredStorageModel", "WorkingSet",
    "build_recording", "build_restore_plan",
    "build_working_set", "calibrate_container", "execute_restore_plan",
    "flatten_pytree", "lower_bound", "plan_restore", "predict",
    "predict_demand_paged", "resolve",
    "restore_layered", "restore_reap", "restore_regular", "restore_seuss",
    "take_diff_snapshot", "take_snapshot", "unflatten_paths",
    "working_set_from_recording",
    "ZygoteRegistry",
]
