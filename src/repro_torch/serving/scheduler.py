"""Pluggable placement, work stealing and autoscaling for the cluster.

PR 5 measured the problem this module removes: at 4x oversaturation the
p99 *queueing* delay is ~2.5-2.9 s while p99 cold boot is 30-60 ms — the
bottleneck is where work runs, not how fast it restores.  Static blake2b
sharding (``_shard_of``) is oblivious to all three signals the system
already computes:

* **live load** — admission-lane occupancy per worker;
* **warm residency** — which worker holds a warm instance / the
  function's snapshots and working set;
* **chunk-sharing affinity** — siblings registered from one shared base
  (``FunctionSpec.delta``) reference the same content digests, so
  co-locating them makes the digest-keyed RAM residency and ``ws_full``
  prefetch from the content-addressed store actually get hit.

This module mirrors the ``PoolPolicy`` pattern: the cluster owns the
mechanism (home map, registration, failover) and delegates the *decision*
to a :class:`PlacementPolicy`.  Two policies ship:

* :class:`StaticHashPlacement` — the PR 5 behaviour (stable blake2b over
  the active workers), kept as the default and the bench baseline;
* :class:`AffinityPlacement` — deterministic scoring over
  :class:`WorkerView` snapshots: sibling co-location and warm residency
  pull a function toward a worker, live queue depth and the Eq. 1-priced
  cost of the functions already homed there push it away.

Work stealing (:class:`StealConfig`) and queue-driven worker autoscaling
(:class:`AutoscaleConfig` + :class:`Autoscaler`) complete the elasticity
story: idle admission lanes pull queued requests from the deepest lane
when the function is (or can cheaply be made) warm on the stealing
worker — the breakeven is Eq. 1's re-cold-start price against the
expected queue wait (:func:`repro.core.planner.steal_breakeven`) — and a
monitor thread scales the worker count between configured bounds as
sustained lane depth crosses hysteresis thresholds.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, TYPE_CHECKING, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - import cycle guards
    from repro_torch.serving.admission import AdmissionController
    from repro_torch.serving.cluster import Cluster


def _shard_of(name: str, n: int) -> int:
    """Stable function → worker assignment (survives process restarts)."""
    h = hashlib.blake2b(name.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % n


@dataclass(frozen=True)
class WorkerView:
    """One candidate worker, as a placement decision sees it.

    Snapshots are taken by the cluster under its topology lock, so a
    policy scores a consistent picture; every field is cheap to read
    (counters and dict lookups — no I/O on the placement path)."""

    worker_id: int
    queue_depth: int        # live admission-lane occupancy (0 when no lanes)
    n_functions: int        # functions currently homed on this worker
    assigned_cost_s: float  # Σ Eq. 1 re-cold-start price of the homed set
    warm: bool              # the placed function has a warm instance here
    registered: bool        # its snapshots/WS/Eq. 1 table already exist here
    siblings: int           # homed functions sharing its affinity key


@runtime_checkable
class PlacementPolicy(Protocol):
    """Function → worker decision strategy (the ``PoolPolicy`` of
    scheduling).  The cluster owns the home map and registration; the
    policy owns only the *choice* among candidate views."""

    name: str

    def place(self, fn: str, views: Sequence[WorkerView]) -> int:
        """Return the ``worker_id`` of the chosen candidate.  ``views`` is
        non-empty and sorted by ``worker_id``; the decision must be
        deterministic in its inputs (replays and tests depend on it)."""
        ...


class StaticHashPlacement:
    """PR 5 behaviour: stable blake2b hash over the candidate list.

    Load-, warmth- and affinity-oblivious by design — it is the bench
    baseline the affinity policy is measured against, and the right
    choice when assignment stability across restarts matters more than
    balance."""

    name = "static"

    def place(self, fn: str, views: Sequence[WorkerView]) -> int:
        return views[_shard_of(fn, len(views))].worker_id


class AffinityPlacement:
    """Score candidates by affinity, warmth and live load; argmax wins.

    The score is a weighted sum (higher = better)::

        + affinity_weight * min(siblings, sibling_cap)
        + warm_weight       (a warm instance is the cheapest possible run)
        + registered_weight (snapshots + WS prefetch already paid here)
        - load_weight * (queue_depth + n_functions)
        - cost_weight * assigned_cost_s

    ``assigned_cost_s`` is the summed Eq. 1 re-cold-start price of the
    functions already homed on the worker — the same per-function model
    Strategy.AUTO resolves from — so an expensive fine-tune counts for
    more load than three cheap adapters.  Sibling pull is capped so one
    huge family cannot absorb every worker's capacity.  Ties break toward
    the lowest worker_id: placement is a pure function of the views, so
    identical registration sequences produce identical assignments."""

    name = "affinity"

    def __init__(
        self,
        *,
        affinity_weight: float = 4.0,
        warm_weight: float = 2.0,
        registered_weight: float = 1.0,
        load_weight: float = 1.0,
        cost_weight: float = 1.0,
        sibling_cap: int = 8,
    ) -> None:
        self.affinity_weight = affinity_weight
        self.warm_weight = warm_weight
        self.registered_weight = registered_weight
        self.load_weight = load_weight
        self.cost_weight = cost_weight
        self.sibling_cap = sibling_cap

    def score(self, v: WorkerView) -> float:
        s = self.affinity_weight * min(v.siblings, self.sibling_cap)
        if v.warm:
            s += self.warm_weight
        if v.registered:
            s += self.registered_weight
        s -= self.load_weight * (v.queue_depth + v.n_functions)
        s -= self.cost_weight * v.assigned_cost_s
        return s

    def place(self, fn: str, views: Sequence[WorkerView]) -> int:
        best = max(views, key=lambda v: (self.score(v), -v.worker_id))
        return best.worker_id


PLACEMENTS = {"static": StaticHashPlacement, "affinity": AffinityPlacement}


def make_placement(policy: "str | PlacementPolicy | None", **kw) -> PlacementPolicy:
    """Coerce a policy name (or pass through an instance) like
    :func:`repro.serving.policy.make_policy` does for pool policies."""
    if policy is None:
        return StaticHashPlacement()
    if isinstance(policy, str):
        try:
            return PLACEMENTS[policy](**kw)
        except KeyError:
            raise ValueError(
                f"unknown placement policy {policy!r}; one of "
                f"{sorted(PLACEMENTS)}"
            ) from None
    return policy


@dataclass(frozen=True)
class StealConfig:
    """Work-stealing rules for idle admission lanes.

    A lane with nothing queued may pull a request from the *deepest*
    foreign lane, oldest-first, when the victim's backlog is at least
    ``min_depth`` and the function is warm on the thief — or can cheaply
    be made warm: its Eq. 1 re-cold-start price is at most ``max_cold_s``
    AND below the expected queue wait it would otherwise pay at home
    (:func:`repro.core.planner.steal_breakeven`).  Requests whose
    function currently holds the single-flight lock are never stolen:
    their cheapest path is riding the in-flight leader's warm instance
    at home, not paying a fresh cold start elsewhere.

    Cold steals additionally require ``min_cold_depth``: a cold steal is
    an *investment* — the thief pays a boot (and, on a small host, the
    boot's CPU steals cycles from every other lane) to become a second
    warm home for the function.  That trade only pays off against a
    sustained backlog, so it is gated on a deeper queue than the free
    warm steals, which drain blips profitably at any depth."""

    min_depth: int = 2
    max_cold_s: float = 1.0
    min_cold_depth: int = 4

    def __post_init__(self) -> None:
        if self.min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        if self.max_cold_s < 0:
            raise ValueError("max_cold_s must be >= 0")
        if self.min_cold_depth < self.min_depth:
            raise ValueError("min_cold_depth must be >= min_depth")


@dataclass(frozen=True)
class AutoscaleConfig:
    """Queue-depth-driven worker autoscaling bounds and hysteresis.

    The monitor samples the deepest open lane's backlog every
    ``interval_s``; ``up_after`` consecutive samples at or above
    ``high_depth`` add one worker (up to ``max_workers``), ``down_after``
    consecutive samples at or below ``low_depth`` retire the shallowest
    lane's worker (down to ``min_workers``).  The asymmetric hysteresis
    (fast up, slow down) is deliberate: a missed burst sheds requests, a
    late scale-down only wastes a warm worker."""

    min_workers: int = 1
    max_workers: int = 4
    high_depth: int = 8
    low_depth: int = 1
    interval_s: float = 0.05
    up_after: int = 2
    down_after: int = 8

    def __post_init__(self) -> None:
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.low_depth > self.high_depth:
            raise ValueError("low_depth must be <= high_depth")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("hysteresis counts must be >= 1")


class Autoscaler:
    """Background monitor that elastically resizes the worker fleet.

    Started by :meth:`Cluster.replay_trace` when an
    :class:`AutoscaleConfig` is given.  Scale-up activates (or builds) a
    worker via :meth:`Cluster.scale_up` — the new worker gets the
    runtime broadcast immediately and functions lazily, through the same
    failover re-registration material steals use — and opens an
    admission lane for it.  Scale-down closes the shallowest lane (its
    queued requests are redistributed, never lost) and retires the
    worker to standby; a later scale-up reactivates it with its packs,
    pools and jitted families intact."""

    def __init__(self, cluster: "Cluster", controller: "AdmissionController",
                 config: AutoscaleConfig):
        self.cluster = cluster
        self.controller = controller
        self.config = config
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = self.cluster._clock()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def _now(self) -> float:
        return self.cluster._clock() - self._t0

    def _loop(self) -> None:
        cfg = self.config
        up = down = 0
        while not self._stop.wait(cfg.interval_s):
            depth = self.controller.max_open_depth()
            n = self.cluster.n_active()
            if depth >= cfg.high_depth and n < cfg.max_workers:
                up += 1
                down = 0
                if up >= cfg.up_after:
                    worker = self.cluster.scale_up(t_s=self._now(),
                                                   lane_depth=depth)
                    if worker is not None:
                        self.controller.add_lane(worker)
                    up = 0
            elif depth <= cfg.low_depth and n > cfg.min_workers:
                down += 1
                up = 0
                if down >= cfg.down_after:
                    wid = self.controller.shallowest_open_lane()
                    if wid is not None and self.controller.close_lane(wid):
                        self.cluster.retire_worker(wid, t_s=self._now(),
                                                   lane_depth=depth)
                    down = 0
            else:
                up = down = 0
