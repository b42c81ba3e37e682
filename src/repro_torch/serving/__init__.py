from .api import (
    ColdStartOptions,
    FailureKind,
    InvocationRequest,
    InvocationResult,
    NpzSourceResolver,
    SourceResolver,
    Strategy,
    select_strategy,
)
from .policy import (
    GDSFPolicy,
    InstancePool,
    LRUPolicy,
    PoolPolicy,
    TTLPolicy,
    make_policy,
)
from .admission import (
    AdmissionConfig,
    AdmissionController,
    ShedError,
    percentiles,
)
from .scheduler import (
    AffinityPlacement,
    AutoscaleConfig,
    Autoscaler,
    PLACEMENTS,
    PlacementPolicy,
    StaticHashPlacement,
    StealConfig,
    WorkerView,
    make_placement,
)
from .loadgen import (
    InvocationTrace,
    TRACE_PATTERNS,
    TracedArrival,
    azure_trace,
    diurnal_trace,
    make_trace,
    mmpp_trace,
    poisson_trace,
)
from .cluster import Cluster, TraceReplayReport
from .worker import FunctionSpec, RequestResult, Worker
from .trace import (
    build_cluster,
    build_functions,
    make_requests,
    replay_cluster_trace,
    replay_trace,
    summarize,
    zipf_schedule,
)

__all__ = [
    "AdmissionConfig", "AdmissionController", "AffinityPlacement",
    "AutoscaleConfig", "Autoscaler", "Cluster", "ColdStartOptions",
    "FailureKind",
    "FunctionSpec", "GDSFPolicy", "InstancePool", "InvocationRequest",
    "InvocationResult", "InvocationTrace", "LRUPolicy", "NpzSourceResolver",
    "PLACEMENTS", "PlacementPolicy", "PoolPolicy", "RequestResult",
    "ShedError", "SourceResolver", "StaticHashPlacement", "StealConfig",
    "Strategy",
    "TRACE_PATTERNS", "TTLPolicy", "TraceReplayReport", "TracedArrival",
    "Worker", "WorkerView", "azure_trace", "build_cluster",
    "build_functions",
    "diurnal_trace", "make_placement", "make_policy", "make_requests",
    "make_trace",
    "mmpp_trace", "percentiles", "poisson_trace", "replay_cluster_trace",
    "replay_trace", "select_strategy", "summarize", "zipf_schedule",
]
