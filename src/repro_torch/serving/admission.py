"""Admission control: bounded queues, overload shedding and work stealing
in front of :class:`~repro.serving.cluster.Cluster`.

Before this layer existed, callers hand-rolled submit loops against the
cluster's unbounded executor: arrival bursts piled up invisibly, queueing
delay was indistinguishable from cold-start time, and overload had no
release valve.  The :class:`AdmissionController` gives the serving path the
production behaviours the paper's fleet framing assumes:

* **bounded per-worker queues** — each worker shard has its own lane with
  a queue-depth cap; a request that arrives to a full lane is *shed*
  (counted, and its future fails fast with :class:`ShedError`) instead of
  growing an unbounded backlog;
* **concurrency caps** — each lane executes at most
  ``worker_concurrency`` requests at a time, modelling per-machine CPU
  slots; everything else waits *in the queue*, where the wait is measured;
* **work stealing** — when the cluster carries a
  :class:`~repro.serving.scheduler.StealConfig`, a lane whose own queue is
  empty pulls requests from the deepest foreign lane instead of idling,
  provided the cluster's :meth:`steal_ok` gate approves (function warm on
  the thief, or its Eq. 1 re-cold-start price beats the expected queue
  wait; never while the function's single-flight lock is held).  Stolen
  requests execute pinned to the thief worker, with crash failover intact;
* **elastic lanes** — the autoscaler can :meth:`add_lane` for a worker it
  just activated and :meth:`close_lane` for one it retires; a closed
  lane's queued requests are redistributed to open lanes, never dropped;
* **timing split** — every admitted request's end-to-end latency is
  decomposed into queueing delay (arrival → execution start, including
  single-flight waits behind a leader's cold boot), cold-start boot and
  execution, so fleet percentiles (p50/p95/p99) can separate "the queue
  was long" from "the restore was slow".

Lanes are explicit deques drained by dedicated lane threads (not
``ThreadPoolExecutor`` queues, which would hide the backlog from the
stealing and autoscaling logic).  One controller-wide mutex + condition
guards all lane state; executions run outside it.  Conservation is the
load-bearing invariant: across all lanes,
``submitted == completed + shed + queued + running`` at every instant —
per-lane counts may diverge under stealing (a request submits to its home
lane but completes on the thief's), which is why totals, not lanes, are
what the soak and hypothesis tests assert.

The controller is deliberately a thin, inspectable object — the cluster
stays usable without it (direct ``submit`` bypasses admission), and the
replay driver (:meth:`Cluster.replay_trace`) builds one per run.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, TYPE_CHECKING

import numpy as np

from repro_torch.serving.api import InvocationRequest, InvocationResult

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.scheduler import StealConfig


class ShedError(RuntimeError):
    """Request refused at admission: the target worker's queue was full."""

    def __init__(self, function: str, worker_id: int, queue_depth: int):
        super().__init__(
            f"request for {function!r} shed: worker {worker_id} queue "
            f"full ({queue_depth} waiting)"
        )
        self.function = function
        self.worker_id = worker_id
        self.queue_depth = queue_depth


@dataclass(frozen=True)
class AdmissionConfig:
    """Per-worker admission limits.

    ``worker_concurrency`` bounds how many requests execute concurrently
    per worker; ``queue_depth`` bounds how many *more* may wait behind
    them.  A request is admitted while the lane holds fewer than
    ``queue_depth + worker_concurrency`` requests in total, so a free
    execution slot is never wasted by a shed.  ``queue_depth=0`` means no
    waiting room: anything beyond the executing requests is shed.
    """

    queue_depth: int = 64
    worker_concurrency: int = 4

    def __post_init__(self) -> None:
        if self.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if self.worker_concurrency < 1:
            raise ValueError("worker_concurrency must be >= 1")


def percentiles(
    values: Sequence[float], points: Sequence[float] = (50, 95, 99)
) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` in milliseconds, rounded.
    Empty input yields an empty dict (JSON-friendly: no NaNs)."""
    if not len(values):
        return {}
    arr = np.asarray(values, dtype=np.float64)
    return {
        f"p{g:g}": round(float(np.percentile(arr, g)) * 1e3, 3)
        for g in points
    }


class _Pending:
    """One admitted request parked in a lane's queue."""

    __slots__ = ("request", "submitted_t", "future", "steal_to")

    def __init__(self, request: InvocationRequest, submitted_t: float,
                 future: "Future[InvocationResult]"):
        self.request = request
        self.submitted_t = submitted_t
        self.future = future
        # worker_id the request was stolen to; None means "run at home"
        self.steal_to: Optional[int] = None


class _Lane:
    """One worker shard's admission lane: a bounded waiting room drained by
    ``worker_concurrency`` dedicated threads.  All mutable state is guarded
    by the owning controller's mutex."""

    def __init__(self, worker_id: int, cfg: AdmissionConfig):
        self.worker_id = worker_id
        self.cfg = cfg
        self.queue: Deque[_Pending] = deque()   # guarded-by: _mu
        # closed lanes stop admitting and draining
        self.open = True          # guarded-by: _mu
        self.running = 0          # guarded-by: _mu
        self.submitted = 0        # guarded-by: _mu
        # resolved (successfully or with an error)
        self.completed = 0        # guarded-by: _mu
        self.failed = 0           # subset of completed that raised  # guarded-by: _mu
        self.shed = 0             # guarded-by: _mu
        self.steals = 0           # pulled from others  # guarded-by: _mu
        self.stolen = 0           # pulled from this lane  # guarded-by: _mu
        self.max_waiting = 0      # guarded-by: _mu
        self.max_running = 0      # guarded-by: _mu

    @property
    def occupancy(self) -> int:
        # holds-lock: _mu
        return len(self.queue) + self.running

    def note_depth(self) -> None:
        # holds-lock: _mu
        # queue depth = backlog beyond the execution slots (requests a
        # free thread could not immediately absorb)
        self.max_waiting = max(
            self.max_waiting,
            max(0, len(self.queue) + self.running - self.cfg.worker_concurrency),
        )

    def stats(self) -> Dict[str, int]:
        # holds-lock: _mu
        return {
            "worker_id": self.worker_id,
            "open": self.open,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "steals": self.steals,
            "stolen": self.stolen,
            "waiting": len(self.queue),
            "running": self.running,
            "max_queue_depth": self.max_waiting,
            "max_running": self.max_running,
        }


class AdmissionController:
    """Bounded-queue admission in front of a cluster's worker shards.

    ``submit`` returns a ``Future[InvocationResult]`` that either resolves
    with the invocation's result (``queue_s`` carrying the measured
    admission-queue + single-flight wait) or fails fast with
    :class:`ShedError` when the target lane is full.  Counting is
    conservation-checked: ``submitted == completed + shed + failed`` once
    all futures resolve (the soak and hypothesis tests assert this).

    Work stealing engages automatically when the cluster exposes a
    ``steal`` config and a ``steal_ok`` gate; clusters without them (and
    test stubs) get plain per-lane behaviour.
    """

    def __init__(self, cluster: "Cluster", config: Optional[AdmissionConfig] = None):
        self.cluster = cluster
        self.config = config or AdmissionConfig()
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._closing = False     # guarded-by: _mu
        # guarded-by: _mu [writes] — shutdown joins outside the lock
        self._threads: List[threading.Thread] = []  # guarded-by: _mu [writes]
        self._steal_cfg: "Optional[StealConfig]" = getattr(cluster, "steal", None)
        workers = getattr(cluster, "active_workers", None)
        workers = workers() if callable(workers) else cluster.workers
        self._lanes: List[_Lane] = []       # guarded-by: _mu
        self._by_wid: Dict[int, _Lane] = {}  # guarded-by: _mu
        self._clock = cluster._clock
        with self._mu:
            for w in workers:
                self._new_lane(w.worker_id)
        # the cluster's fleet metrics surface this controller's stats
        cluster._admission = self

    # -- lane lifecycle (callers: __init__, Autoscaler) -----------------------

    def _new_lane(self, worker_id: int) -> _Lane:
        # holds-lock: _mu
        """Create (or reopen) a lane and its drain threads.  _mu held."""
        lane = self._by_wid.get(worker_id)
        if lane is None:
            lane = _Lane(worker_id, self.config)
            self._lanes.append(lane)
            self._by_wid[worker_id] = lane
        lane.open = True
        for i in range(self.config.worker_concurrency):
            t = threading.Thread(
                target=self._loop, args=(lane,),
                name=f"admit-w{worker_id}-{i}", daemon=True,
            )
            self._threads.append(t)
            t.start()
        return lane

    def add_lane(self, worker) -> None:
        """Open an admission lane for a newly activated worker (its old
        threads, if it was retired earlier, have already exited)."""
        with self._mu:
            if self._closing:
                return
            lane = self._by_wid.get(worker.worker_id)
            if lane is not None and lane.open:
                return
            self._new_lane(worker.worker_id)
            self._cv.notify_all()

    def close_lane(self, worker_id: int) -> bool:
        """Close a lane for a worker being retired.  Its queued requests are
        redistributed to the shallowest open lanes (admitted stays admitted
        — redistribution ignores the depth bound); its threads finish their
        in-flight request and exit.  Refuses to close the last open lane."""
        with self._mu:
            lane = self._by_wid.get(worker_id)
            if lane is None or not lane.open:
                return False
            if sum(1 for l in self._lanes if l.open) <= 1:
                return False
            lane.open = False
            while lane.queue:
                p = lane.queue.popleft()
                tgt = min(
                    (l for l in self._lanes if l.open),
                    key=lambda l: (l.occupancy, l.worker_id),
                )
                tgt.queue.append(p)
                tgt.note_depth()
            self._cv.notify_all()
            return True

    # -- submission -----------------------------------------------------------

    def _open_lane_for(self, function: str) -> _Lane:
        # holds-lock: _mu
        """The home worker's lane, or — when that lane is closed/missing
        (autoscale retired the home between placement and submit) — the
        shallowest open lane.  _mu held."""
        home = self.cluster.worker_for(function).worker_id
        lane = self._by_wid.get(home)
        if lane is not None and lane.open:
            return lane
        return min(
            (l for l in self._lanes if l.open),
            key=lambda l: (l.occupancy, l.worker_id),
        )

    def lane_for(self, function: str) -> _Lane:
        with self._mu:
            return self._open_lane_for(function)

    def submit(self, request: InvocationRequest) -> "Future[InvocationResult]":
        """Admit (or shed) one request; the returned future resolves to the
        typed result or raises :class:`ShedError`.

        The admission bound counts the lane's total occupancy (executing +
        waiting) against ``worker_concurrency + queue_depth``, so the bound
        cannot over-shed during a drain-thread wakeup window and an idle
        lane always admits."""
        cfg = self.config
        submitted_t = self._clock()
        shed_exc: Optional[ShedError] = None
        fut: "Future[InvocationResult]" = Future()
        with self._mu:
            if self._closing:
                raise RuntimeError("cannot submit after shutdown")
            lane = self._open_lane_for(request.function)
            lane.submitted += 1
            if lane.occupancy >= cfg.queue_depth + cfg.worker_concurrency:
                lane.shed += 1
                shed_exc = ShedError(
                    request.function, lane.worker_id, len(lane.queue)
                )
            else:
                lane.queue.append(_Pending(request, submitted_t, fut))
                lane.note_depth()
                self._cv.notify_all()
        if shed_exc is not None:
            fut.set_exception(shed_exc)
            self.cluster._note_shed()
        return fut

    # -- draining -------------------------------------------------------------

    def _loop(self, lane: _Lane) -> None:
        """Drain thread: serve the lane's own queue first, then steal."""
        while True:
            with self._mu:
                while True:
                    pending = self._next(lane)
                    if pending is not None:
                        break
                    if self._closing or not lane.open:
                        return
                    self._cv.wait(timeout=0.1)
                lane.running += 1
                lane.max_running = max(lane.max_running, lane.running)
            self._dispatch(lane, pending)

    def _next(self, lane: _Lane) -> Optional[_Pending]:
        # holds-lock: _mu
        if lane.queue:
            return lane.queue.popleft()
        return self._try_steal(lane)

    def _try_steal(self, thief: _Lane) -> Optional[_Pending]:
        # holds-lock: _mu
        """Pull the oldest stealable request from the deepest foreign lane.
        The cluster's ``steal_ok`` gate enforces the warm-or-cheap rule and
        skips functions whose single-flight lock is busy.  _mu held (the
        gate only touches cluster-side locks, never this controller's)."""
        cfg = self._steal_cfg
        steal_ok = getattr(self.cluster, "steal_ok", None)
        if cfg is None or steal_ok is None:
            return None
        victims = sorted(
            (l for l in self._lanes
             if l is not thief and len(l.queue) >= cfg.min_depth),
            key=lambda l: len(l.queue), reverse=True,
        )
        for victim in victims:
            depth = len(victim.queue)
            for i, p in enumerate(victim.queue):
                if steal_ok(thief.worker_id, p.request.function, depth):
                    del victim.queue[i]
                    victim.stolen += 1
                    thief.steals += 1
                    p.steal_to = thief.worker_id
                    note = getattr(self.cluster, "_note_steal", None)
                    if note is not None:
                        note()
                    return p
        return None

    def _dispatch(self, lane: _Lane, p: _Pending) -> None:
        try:
            if p.future.set_running_or_notify_cancel():
                worker = None
                if p.steal_to is not None:
                    by_id = getattr(self.cluster, "worker_by_id", None)
                    worker = by_id(p.steal_to) if by_id is not None else None
                try:
                    if worker is not None:
                        result = self.cluster._run(
                            p.request, p.submitted_t, worker=worker
                        )
                    else:
                        result = self.cluster._run(p.request, p.submitted_t)
                    p.future.set_result(result)
                except BaseException as exc:  # broad-ok: routed to the caller via future.set_exception
                    with self._mu:
                        lane.failed += 1
                    p.future.set_exception(exc)
        finally:
            with self._mu:
                lane.running -= 1
                lane.completed += 1
                self._cv.notify_all()

    # -- autoscaler probes ----------------------------------------------------

    def max_open_depth(self) -> int:
        """Deepest open lane's *queued* backlog (the autoscale signal)."""
        with self._mu:
            return max((len(l.queue) for l in self._lanes if l.open),
                       default=0)

    def shallowest_open_lane(self) -> Optional[int]:
        """worker_id of the least-loaded open lane (scale-down victim)."""
        with self._mu:
            lanes = [l for l in self._lanes if l.open]
            if len(lanes) <= 1:
                return None
            return min(lanes, key=lambda l: (l.occupancy, -l.worker_id)).worker_id

    def lane_depths(self) -> Dict[int, int]:
        """Live occupancy per open lane (placement's queue-depth signal).

        Deliberately lock-free: the cluster calls this from its placement
        path, which the submit path reaches while already holding this
        controller's mutex — taking ``_mu`` here would self-deadlock.  The
        reads are GIL-atomic ints; placement only needs an advisory
        snapshot, not a consistent one."""
        return {l.worker_id: l.occupancy
                for l in list(self._lanes)  # unguarded-ok: advisory snapshot; _mu here would self-deadlock
                if l.open}  # unguarded-ok: see above

    def queue_depth_peaks(self) -> Dict[str, int]:
        """Per-worker peak queue depth over the controller's lifetime
        (string keys: this lands in benchmark JSON)."""
        with self._mu:
            return {str(l.worker_id): l.max_waiting for l in self._lanes}

    # -- metrics / lifecycle --------------------------------------------------

    def metrics(self) -> Dict[str, object]:
        with self._mu:
            lanes = [lane.stats() for lane in self._lanes]
        return {
            "queue_depth_limit": self.config.queue_depth,
            "worker_concurrency": self.config.worker_concurrency,
            "submitted": sum(l["submitted"] for l in lanes),
            "completed": sum(l["completed"] for l in lanes),
            "failed": sum(l["failed"] for l in lanes),
            "shed": sum(l["shed"] for l in lanes),
            "steals": sum(l["steals"] for l in lanes),
            "max_queue_depth": max((l["max_queue_depth"] for l in lanes),
                                   default=0),
            "per_lane": lanes,
        }

    def shutdown(self, wait: bool = True) -> None:
        with self._mu:
            self._closing = True
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=60.0)

    def __enter__(self) -> "AdmissionController":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
