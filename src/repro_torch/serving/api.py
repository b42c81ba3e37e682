"""Typed invocation API for the serving layer.

The seed's request path was a string-typed synchronous call
(``Worker.handle(fn, tokens, strategy="snapfaas", ...)``).  This module
gives the lifecycle real types so the planner's Eq. 1 model can drive
strategy selection at request time and a multi-worker scheduler can carry
requests through queues without loss of information:

* :class:`Strategy` — the snapshot-strategy enum, including
  :attr:`Strategy.AUTO` which resolves per function via
  :func:`select_strategy` (argmin of :func:`repro.core.planner.predict`
  over the function's :class:`~repro.core.planner.SnapshotSizes` and the
  deployment's :class:`~repro.core.planner.StorageModel`);
* :class:`ColdStartOptions` / :class:`InvocationRequest` — what a client
  submits;
* :class:`InvocationResult` — what comes back, cold or warm, with the
  full A/B/C/D metrics attached on cold paths;
* :class:`SourceResolver` / :class:`NpzSourceResolver` — the declared
  source-artifact loaders that ``seuss``/``regular`` cold starts boot
  from (previously ad-hoc closures inside ``Worker._loaders``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.metrics import ColdStartMetrics
from repro_torch.core.planner import ColdStartPrediction, SnapshotSizes, StorageModel, predict


class Strategy(str, enum.Enum):
    """Cold-start strategy.  Members compare equal to their wire strings
    (``Strategy.SNAPFAAS == "snapfaas"``), so the enum flows through the
    registry and metrics layers unchanged."""

    REGULAR = "regular"
    REAP = "reap"
    SEUSS = "seuss"
    SNAPFAAS_MINUS = "snapfaas-"
    SNAPFAAS = "snapfaas"
    #: planner-driven: pick the cheapest fixed strategy per function via Eq. 1
    AUTO = "auto"

    def __str__(self) -> str:  # json.dumps / f-strings emit the wire name
        return self.value

    @classmethod
    def coerce(cls, value: "Strategy | str") -> "Strategy":
        if isinstance(value, Strategy):
            return value
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"unknown strategy {value!r}; one of "
                f"{[s.value for s in cls]}"
            ) from None

    @classmethod
    def fixed(cls) -> Tuple["Strategy", ...]:
        """All concrete strategies (everything but AUTO)."""
        return tuple(s for s in cls if s is not cls.AUTO)


class FailureKind(str, enum.Enum):
    """Typed failure taxonomy of the serving layer.

    Every submitted request resolves to exactly one terminal bucket —
    ``completed`` (possibly :attr:`FAULT_RECOVERED`), :attr:`SHED`,
    :attr:`TIMEOUT` or :attr:`FAULT_FATAL` — so the conservation invariant
    ``submitted == completed + shed + failed`` stays checkable under
    injected faults.
    """

    #: refused at admission (queue full) — no work was attempted
    SHED = "shed"
    #: failed with a deadline/timeout error (e.g. the retry policy's
    #: per-request deadline expired against a stalled tier)
    TIMEOUT = "timeout"
    #: completed successfully, but only after recovery work (tier-read
    #: retries, chunk repair, or worker failover) — latency is suspect
    FAULT_RECOVERED = "fault_recovered"
    #: failed terminally: unrecoverable fault (integrity, dead tiers,
    #: all workers down, or an unexpected error)
    FAULT_FATAL = "fault_fatal"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def classify(cls, exc: BaseException) -> "FailureKind":
        """Bucket a raised invocation error (shed is handled upstream)."""
        if isinstance(exc, TimeoutError):
            return cls.TIMEOUT
        return cls.FAULT_FATAL


def select_strategy(
    sizes: SnapshotSizes, hw: StorageModel
) -> Tuple["Strategy", Dict["Strategy", ColdStartPrediction]]:
    """Eq. 1 put to work: predict every fixed strategy's cold-start latency
    for this function on this deployment tier and return the argmin (plus
    the full prediction table, for metrics/debugging)."""
    preds = {s: predict(s.value, sizes, hw) for s in Strategy.fixed()}
    # totals tie whenever the preconfig constant dominates (tiny functions);
    # break ties toward fewer eager bytes, then less exec-time overhead, then
    # toward snapfaas (min picks the first minimum in iteration order).
    order = (Strategy.SNAPFAAS, Strategy.SNAPFAAS_MINUS, Strategy.REAP,
             Strategy.SEUSS, Strategy.REGULAR)
    best = min(order, key=lambda s: (preds[s].total, preds[s].B, preds[s].D,
                                     preds[s].C))
    return best, preds


@dataclass(frozen=True)
class ColdStartOptions:
    """How a cold start (if one happens) should run.

    The tier hints steer the storage hierarchy: ``prefetch`` forces a
    working-set promotion into the warm tiers (RAM cache + local packs)
    before the boot is timed — what the scheduler does on shard
    assignment — and ``promote`` controls whether remote-fetched eager
    chunks are promoted downward as a side effect of this restore
    (``None`` → the store's configured default).  ``promote`` covers the
    eager B phase only; execution-time demand faults always follow the
    store's ``promote_on_fetch`` default.

    ``record`` runs this invocation in REAP's record mode: every array
    read is mirrored into an access log and folded into the function's
    persisted recording afterwards (merged across profiled requests).
    ``demand_paging`` selects the record-and-prefetch restore: ``True``
    forces it, ``False`` forces eager, and ``None`` (default) lets
    :attr:`Strategy.AUTO` choose it when the measured working set prices
    cheaper under Eq. 1 — fixed strategies stay eager unless forced.
    """

    strategy: Strategy = Strategy.SNAPFAAS
    force_cold: bool = False            # bypass the warm pool (bench/measure)
    engine: Optional[str] = None        # "planned" | "legacy" | None (env default)
    prefetch: bool = False              # promote the WS to warm tiers first
    #: which eager set the prefetch hint warms: "ws" (default), "diff",
    #: "ws_full" or "full".  The full-snapshot categories warm the shared
    #: base-content digests too — residency is content-addressed, so one
    #: prefetch serves every sibling function referencing those chunks.
    prefetch_category: str = "ws"
    promote: Optional[bool] = None      # remote fetches promote downward
    record: bool = False                # profile this run into the recording
    demand_paging: Optional[bool] = None  # True/False force; None → AUTO picks

    def with_strategy(self, strategy: "Strategy | str") -> "ColdStartOptions":
        import dataclasses

        return dataclasses.replace(self, strategy=Strategy.coerce(strategy))


@dataclass(frozen=True)
class InvocationRequest:
    """One client request against a registered function."""

    function: str
    tokens: np.ndarray
    options: ColdStartOptions = field(default_factory=ColdStartOptions)


@dataclass(frozen=True)
class InvocationResult:
    """Outcome of one invocation.

    ``requested`` is what the client asked for (possibly AUTO);
    ``strategy`` is the concrete strategy the cold start ran with (or
    would have run with, on a warm hit — ``cold`` disambiguates).
    """

    function: str
    cold: bool
    requested: Strategy
    strategy: Strategy
    latency_s: float
    boot_s: float
    exec_s: float
    queue_s: float = 0.0                 # scheduler wait (Cluster paths)
    pooled: bool = True                  # did the instance fit the warm pool?
    worker_id: int = 0
    metrics: Optional[ColdStartMetrics] = None
    output: Any = None
    #: the request completed, but recovery work happened on its path
    #: (tier-read retries, chunk repair, or a worker failover re-dispatch)
    fault_recovered: bool = False


@runtime_checkable
class SourceResolver(Protocol):
    """Declared access to a function's on-disk source artifacts.

    ``seuss`` boots by importing the function's source; ``regular``
    additionally boots the whole runtime image.  Both deliberately pay the
    storage parse+copy cost those designs cannot memoize (paper §2.2).
    """

    def load_source(self) -> Dict[str, np.ndarray]:
        """Flat path → array of the function's own (diff) source."""
        ...

    def load_base(self) -> Dict[str, np.ndarray]:
        """Flat path → array of the runtime family's base image."""
        ...


@dataclass
class NpzSourceResolver:
    """Default :class:`SourceResolver`: ``npz`` artifacts on disk, with
    in-memory fallbacks for functions registered without files."""

    source_path: str = ""
    base_path: str = ""
    source_fallback: Optional[Callable[[], Dict[str, np.ndarray]]] = None
    base_fallback: Optional[Callable[[], Dict[str, np.ndarray]]] = None

    def load_source(self) -> Dict[str, np.ndarray]:
        import os

        if self.source_path and os.path.exists(self.source_path):
            with np.load(self.source_path) as z:
                return {k: z[k] for k in z.files}
        if self.source_fallback is not None:
            return self.source_fallback()
        raise FileNotFoundError(self.source_path or "<no source declared>")

    def load_base(self) -> Dict[str, np.ndarray]:
        import os

        if self.base_path and os.path.exists(self.base_path):
            with np.load(self.base_path) as z:
                return {k.replace("|", "/"): z[k] for k in z.files}
        if self.base_fallback is not None:
            return self.base_fallback()
        raise FileNotFoundError(self.base_path or "<no base image declared>")
