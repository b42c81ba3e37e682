"""Multi-worker scheduler: the paper's fleet view of cold starts.

A :class:`Cluster` places registered functions across N :class:`Worker`\\ s
through a pluggable :class:`~repro.serving.scheduler.PlacementPolicy`
(static blake2b hashing by default; affinity-, warmth- and load-aware
scoring with ``placement="affinity"``) — a function's snapshots, working
sets and warm instances live on exactly one *home* worker.  Invocations
run concurrently on an executor sized from the admission caps, and
concurrent cold starts of the *same* function serialise behind a
per-function single-flight lock (the second request rides the first boot's
warm instance instead of duplicating the restore I/O).
``deregister_function`` takes the same lock, so garbage collection can
never reclaim chunks out from under an in-flight cold start of the same
function.

``submit`` returns a ``Future[InvocationResult]``; ``replay`` drives a
request list through the executor as fast as it can, and ``replay_trace``
replays a timed :class:`~repro.serving.loadgen.InvocationTrace` through an
:class:`~repro.serving.admission.AdmissionController` (bounded per-worker
queues, concurrency caps, overload shedding, and — when the cluster
carries a :class:`~repro.serving.scheduler.StealConfig` — work stealing
between lanes).  Passing an
:class:`~repro.serving.scheduler.AutoscaleConfig` to ``replay_trace``
additionally runs a queue-depth-driven autoscaler that grows and shrinks
the worker fleet between configured bounds during the replay.
``metrics`` aggregates the fleet view — per-worker pool stats, cold/warm
counts, a ``scheduler`` section (placement policy, steals, scale events)
and a ``serving`` section with the p50/p95/p99 end-to-end latency and its
queueing-delay / boot / execution split.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import WorkerCrashError
from repro_torch.core.planner import PAPER_C220G5, StorageModel, steal_breakeven
from repro_torch.core.tiers import TierSpec
from repro_torch.models import Model
from repro_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    ShedError,
    percentiles,
)
from repro_torch.serving.api import (
    ColdStartOptions,
    FailureKind,
    InvocationRequest,
    InvocationResult,
    Strategy,
)
from repro_torch.serving.loadgen import InvocationTrace
from repro_torch.serving.policy import PoolPolicy
from repro_torch.serving.scheduler import (
    AutoscaleConfig,
    Autoscaler,
    PlacementPolicy,
    StealConfig,
    WorkerView,
    _shard_of,          # re-exported: pre-scheduler callers import it here
    make_placement,
)
from repro_torch.serving.worker import FunctionSpec, Worker

#: serving-stat samples kept for percentile reporting (a soak run does not
#: grow memory without bound); the window is a uniform reservoir over the
#: whole run, not a newest-win tail
_SERVING_SAMPLE_CAP = 65536


class _Reservoir:
    """Uniform sample of a stream (Vitter's Algorithm R).

    The previous ``deque(maxlen=cap)`` kept only the *newest* ``cap``
    samples, so percentiles over a long replay described the run's tail
    (where queues are drained) instead of the run.  Every arrival now has
    probability ``cap / n_seen`` of being in the window, independent of
    when it arrived.  Seeded, so identical replays report identical
    percentiles.  Callers synchronise externally (the cluster's results
    lock)."""

    def __init__(self, cap: int, seed: int = 0):
        self.cap = cap
        self.n_seen = 0
        self._items: List = []
        self._rng = random.Random(seed)

    def add(self, item) -> None:
        self.n_seen += 1
        if len(self._items) < self.cap:
            self._items.append(item)
        else:
            j = self._rng.randrange(self.n_seen)
            if j < self.cap:
                self._items[j] = item

    def snapshot(self) -> List:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


class Cluster:
    """N workers + an invocation scheduler.

    ``policy_factory`` builds one fresh :class:`PoolPolicy` per worker
    (policies hold per-worker state, so sharing one instance is wrong);
    ``None`` keeps each worker's LRU default.  ``placement`` picks the
    function→worker policy (``"static"``/``"affinity"`` or a
    :class:`PlacementPolicy` instance); ``steal`` enables work stealing
    between admission lanes (``True`` for defaults, or a
    :class:`StealConfig`); ``admission`` sets the cluster's default
    :class:`AdmissionConfig`, which also sizes the shared executor
    (``n_workers * (worker_concurrency + 2)`` threads, clamped to
    [8, 128]) so direct submits can't starve the lanes.
    """

    def __init__(
        self,
        root: str,
        *,
        n_workers: int = 2,
        pool_budget_bytes: int = 1 << 30,
        chunk_bytes: int = 64 * 1024,
        policy_factory: Optional[Callable[[], PoolPolicy]] = None,
        storage: StorageModel = PAPER_C220G5,
        max_concurrency: Optional[int] = None,
        tiers: Optional[TierSpec] = None,
        prefetch_on_register: bool = True,
        placement: "str | PlacementPolicy" = "static",
        steal: "StealConfig | bool | None" = None,
        admission: Optional[AdmissionConfig] = None,
        device: Optional[str] = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        # ctor material kept so autoscaling can build identical workers
        self._root = root
        self._pool_budget_bytes = pool_budget_bytes
        self._chunk_bytes = chunk_bytes
        self._policy_factory = policy_factory
        self._storage = storage
        self._tiers = tiers
        self._prefetch_on_register = prefetch_on_register
        self._max_concurrency = max_concurrency
        self._device = device
        self.placement = make_placement(placement)
        self.steal: Optional[StealConfig] = (
            StealConfig() if steal is True else (steal or None)
        )
        self._admission_cfg = admission or AdmissionConfig()
        self.workers = [
            Worker(
                os.path.join(root, f"worker{i}"),
                pool_budget_bytes=pool_budget_bytes,
                chunk_bytes=chunk_bytes,
                pool_policy=policy_factory() if policy_factory else None,
                storage=storage,
                worker_id=i,
                tiers=tiers,
                prefetch_on_register=prefetch_on_register,
                device=device,
            )
            for i in range(n_workers)
        ]
        self._executor = ThreadPoolExecutor(
            max_workers=max_concurrency or self._executor_target(n_workers),
            thread_name_prefix="cluster",
        )
        self._flight: Dict[str, threading.Lock] = {}   # guarded-by: _flight_guard
        self._flight_guard = threading.Lock()
        self._results_lock = threading.Lock()
        self._clock = time.perf_counter
        self.n_requests = 0                 # guarded-by: _results_lock
        self.n_cold = 0                     # guarded-by: _results_lock
        self.n_shed = 0                     # guarded-by: _results_lock
        # typed failure taxonomy (FailureKind buckets) + worker health
        self.n_timeout = 0                  # guarded-by: _results_lock
        self.n_fault_fatal = 0              # guarded-by: _results_lock
        self.n_fault_recovered = 0          # guarded-by: _results_lock
        self.n_worker_crashes = 0           # guarded-by: _results_lock
        # worker_ids detected crashed
        self._dead: set = set()             # guarded-by: _results_lock
        # failover state: re-registration material for surviving workers
        self._specs: Dict[str, FunctionSpec] = {}
        # family → (model, base_params, shared jitted fwd)
        self._runtimes: Dict[str, Tuple[Model, object, object]] = {}
        # scheduling state: sticky home per function + the placement
        # signals (affinity key, Eq. 1 cost), guarded by the topology lock
        self._topology = threading.Lock()
        self._home: Dict[str, int] = {}     # guarded-by: _topology
        self._affinity: Dict[str, Optional[str]] = {}  # guarded-by: _topology
        self._fn_cost: Dict[str, float] = {}           # guarded-by: _topology
        # worker_ids scaled down (standby)
        self._retired: set = set()          # guarded-by: _topology
        self._next_worker_idx = n_workers   # guarded-by: _topology
        self.scale_events: List[Dict] = []  # guarded-by: _topology
        self.n_steals = 0                   # guarded-by: _results_lock
        # mean boot+exec (steal gate)
        self._service_ema: Optional[float] = None   # guarded-by: _results_lock
        self.queue_s_total = 0.0            # guarded-by: _results_lock
        # (queue_s, boot_s, exec_s, e2e_s, cold) per completed request —
        # a uniform reservoir over the run (see _Reservoir)
        self._samples = _Reservoir(_SERVING_SAMPLE_CAP)  # guarded-by: _results_lock
        self._admission: Optional[AdmissionController] = None

    def _executor_target(self, n_active: int) -> int:
        """Executor width derived from the admission caps: every lane can
        run ``worker_concurrency`` requests plus headroom for direct
        submits, instead of the old ``min(32, 4 * n_workers)`` guess that
        ignored the configured concurrency entirely."""
        return max(8, min(128, n_active * (self._admission_cfg.worker_concurrency + 2)))

    def _resize_executor(self) -> None:
        # holds-lock: _topology
        """Re-derive the executor width after a scale event (callers hold
        the topology lock).  An explicit ``max_concurrency`` is a user cap
        and is never overridden."""
        if self._max_concurrency is not None:
            return
        target = self._executor_target(len(self.workers) - len(self._retired))
        # ThreadPoolExecutor spawns threads lazily up to _max_workers, so
        # raising the bound grows on demand; lowering it only stops new
        # spawns (surplus idle threads are harmless and die with shutdown)
        self._executor._max_workers = target

    # -- registration (broadcast runtimes, shard functions) -------------------

    def register_runtime(self, family: str, model: Model, base_params) -> None:
        """Cluster-manager replication: every worker gets the family's base
        snapshot and a SHARED jitted step (paper Fig. 4 bootstrap) — one
        compile per (shape, family) process-wide, so work stealing and
        scale-up never stall a victim's overflow behind a per-worker
        recompile."""
        fwd = None
        for w in self.workers:
            w.register_runtime(family, model, base_params, fwd=fwd)
            fwd = w._fwd[family]
        self._runtimes[family] = (model, base_params, fwd)

    def register_function(self, spec: FunctionSpec) -> Worker:
        """Register ``spec`` on its home shard; returns the owning worker.

        Registration on the owning worker also promotes the function's
        working set into that worker's warm tiers (RAM chunk cache + local
        packs) — the shard-assignment prefetch, so even a first request
        against a remote-born snapshot restores from warm storage.

        Serialises behind the function's single-flight lock (like
        ``deregister_function``): a request racing a re-registration waits
        until the record, working set and Eq. 1 table are complete instead
        of observing a half-registered function."""
        lock = self._acquire_flight(spec.name)
        try:
            with self._topology:
                # chunk-sharing affinity: siblings registered from one
                # shared base (delta specs) reference the same content
                # digests, so the placement policy co-locates them; plain
                # variants get no key and spread by load
                self._affinity[spec.name] = (
                    spec.family if getattr(spec, "delta", None) is not None
                    else None
                )
            w = self.worker_for(spec.name)
            w.register_function(spec)
            # keep the spec for worker failover: queued requests re-home
            # onto a surviving shard by re-registering from this record
            self._specs[spec.name] = spec
            cost = self._predict_cost(w, spec.name)
            if cost is not None:
                with self._topology:
                    self._fn_cost[spec.name] = cost
            return w
        finally:
            lock.release()

    def prefetch_function(self, fn: str, category: str = "ws"):
        """Re-run the WS prefetch on ``fn``'s owning worker (e.g. after its
        warm tiers were dropped, or after a shard reassignment)."""
        return self.worker_for(fn).prefetch_function(fn, category)

    def record_function(
        self, fn: str, tokens: "np.ndarray", *, n_profiles: int = 1,
    ) -> InvocationResult:
        """Profile ``fn`` REAP-style through the normal request path:
        ``n_profiles`` forced-cold invocations in record mode on the owning
        worker, each folding its access log into the function's persisted
        recording (merged, crash-safe).  Subsequent demand-paged restores —
        and ``Strategy.AUTO``'s Eq. 1 pricing — use the measured working
        set.  Returns the last profile's result."""
        out: Optional[InvocationResult] = None
        for _ in range(max(1, n_profiles)):
            out = self.invoke(InvocationRequest(
                function=fn, tokens=np.asarray(tokens),
                options=ColdStartOptions(record=True, force_cold=True),
            ))
        assert out is not None
        return out

    def deregister_function(self, fn: str) -> int:
        """Remove ``fn`` from its home shard and garbage-collect its
        now-unreferenced chunks (shared-base chunks survive — refcounted).
        Returns bytes made unreachable on the owning worker.

        Serialises behind ``fn``'s single-flight lock: an in-flight cold
        start of the same function finishes (and its bytes stay readable)
        before GC reclaims anything; requests queued behind the removal
        fail with a clear "not registered" error instead of reading
        reclaimed chunks."""
        lock = self._acquire_flight(fn)
        try:
            self._specs.pop(fn, None)
            freed = self.worker_for(fn).deregister_function(fn)
            with self._topology:
                self._home.pop(fn, None)
                self._affinity.pop(fn, None)
                self._fn_cost.pop(fn, None)
        finally:
            # retire the lock object while still holding it, so any waiter
            # that acquires it next fails the _acquire_flight re-check and
            # retries on the next lifetime's lock
            with self._flight_guard:
                if self._flight.get(fn) is lock:
                    del self._flight[fn]
            lock.release()
        return freed

    def alive_workers(self) -> List[Worker]:
        """Workers not detected as crashed.  With every worker dead, the
        full list is returned so invocations surface the crash error
        instead of dying on an empty shard space."""
        with self._results_lock:
            dead = set(self._dead)
        alive = [w for w in self.workers if w.worker_id not in dead]
        return alive or self.workers

    def active_workers(self) -> List[Worker]:
        """Workers not retired by the autoscaler (crashed or not)."""
        with self._topology:
            retired = set(self._retired)
        return [w for w in self.workers if w.worker_id not in retired]

    def active_alive_workers(self) -> List[Worker]:
        """The placement candidate set: neither crashed nor retired.  Falls
        back to :meth:`alive_workers` if scale-down and crashes conspire to
        empty it (an invocation must always have a target to fail on)."""
        with self._results_lock:
            dead = set(self._dead)
        with self._topology:
            retired = set(self._retired)
        out = [w for w in self.workers
               if w.worker_id not in dead and w.worker_id not in retired]
        return out or self.alive_workers()

    def n_active(self) -> int:
        return len(self.active_alive_workers())

    def worker_by_id(self, worker_id: int) -> Optional[Worker]:
        for w in self.workers:
            if w.worker_id == worker_id:
                return w
        return None

    def worker_for(self, fn: str) -> Worker:
        """The function's home worker.  Homes are sticky: once the
        placement policy assigns one, it holds until the home crashes or
        is retired, at which point the function is re-placed over the
        surviving candidates (and the new home sticks in turn).  Stickiness
        is what makes warm residency and replays deterministic — a
        function does not migrate just because queue depths moved."""
        candidates = self.active_alive_workers()
        with self._topology:
            home = self._home.get(fn)
        if home is not None:
            for w in candidates:
                if w.worker_id == home:
                    return w
        return self._place(fn, candidates)

    def _place(self, fn: str, candidates: List[Worker]) -> Worker:
        """Run the placement policy over live views and record the home."""
        if len(candidates) == 1:
            chosen = candidates[0]
        else:
            views = self._views(fn, candidates)
            wid = self.placement.place(fn, views)
            chosen = next(
                (w for w in candidates if w.worker_id == wid), candidates[0]
            )
        with self._topology:
            self._home[fn] = chosen.worker_id
        return chosen

    def _views(self, fn: str, candidates: List[Worker]) -> List[WorkerView]:
        """Per-candidate :class:`WorkerView` snapshots: live lane
        occupancy, homed-function count and summed Eq. 1 cost, warm/
        registered residency, and sibling count under ``fn``'s affinity
        key."""
        adm = self._admission
        depths = adm.lane_depths() if adm is not None else {}
        views: List[WorkerView] = []
        with self._topology:
            key = self._affinity.get(fn)
            homed: Dict[int, List[str]] = {}
            for g, h in self._home.items():
                homed.setdefault(h, []).append(g)
            for w in sorted(candidates, key=lambda w: w.worker_id):
                fns = homed.get(w.worker_id, [])
                views.append(WorkerView(
                    worker_id=w.worker_id,
                    queue_depth=int(depths.get(w.worker_id, 0)),
                    n_functions=len(fns),
                    assigned_cost_s=round(
                        sum(self._fn_cost.get(g, 0.0) for g in fns), 6),
                    warm=w.pool.contains(fn),
                    registered=fn in w.specs,
                    siblings=0 if key is None else sum(
                        1 for g in fns
                        if g != fn and self._affinity.get(g) == key
                    ),
                ))
        return views

    @staticmethod
    def _predict_cost(worker: Worker, fn: str) -> Optional[float]:
        """The Eq. 1 best-strategy cold total the planner computed at
        registration (Strategy.AUTO's argmin) — the price a steal or a
        scale-up pays to run ``fn`` on a fresh worker."""
        try:
            return float(worker.predicted_cost(fn, Strategy.AUTO))
        except (KeyError, ValueError, AttributeError):
            # unregistered fn / no AUTO prediction recorded: no estimate
            return None

    def predicted_cold_cost(self, fn: str) -> Optional[float]:
        with self._topology:
            cost = self._fn_cost.get(fn)
        if cost is not None:
            return cost
        for w in self.workers:
            if fn in w.specs:
                return self._predict_cost(w, fn)
        return None

    # -- work stealing + autoscaling -------------------------------------------

    def steal_ok(self, thief_worker_id: int, fn: str, victim_depth: int) -> bool:
        """The admission layer's stealing gate: may an idle lane on
        ``thief_worker_id`` pull a queued request for ``fn`` from a lane
        ``victim_depth`` deep?

        A warm thief always qualifies — its stolen requests ride the
        pooled instance through the lock-free warm path, so an in-flight
        cold start elsewhere is irrelevant.  A cold thief is held to a
        deeper backlog (``steal.min_cold_depth``: booting a second warm
        home is an investment, not a free drain), never steals while
        ``fn``'s single-flight lock is held (the steal would serialise
        behind the in-flight boot it was meant to dodge), and otherwise
        only when the Eq. 1 re-cold-start price is small
        (``steal.max_cold_s``) *and* beaten by the expected queue wait at
        home (the measured mean service time drives
        :func:`~repro.core.planner.steal_breakeven`).
        """
        cfg = self.steal
        if cfg is None or victim_depth < cfg.min_depth:
            return False
        worker = self.worker_by_id(thief_worker_id)
        if worker is None:
            return False
        if fn in worker.specs and worker.pool.contains(fn):
            return True
        if victim_depth < cfg.min_cold_depth:
            return False
        with self._flight_guard:
            lock = self._flight.get(fn)
        if lock is not None and lock.locked():
            return False
        cost = self.predicted_cold_cost(fn)
        if cost is None or cost > cfg.max_cold_s:
            return False
        with self._results_lock:
            service_s = self._service_ema
        conc = (self._admission.config.worker_concurrency
                if self._admission is not None
                else self._admission_cfg.worker_concurrency)
        return steal_breakeven(
            victim_depth, service_s if service_s is not None else 0.05,
            cost, warm=False, concurrency=conc,
        )

    def _note_steal(self) -> None:
        with self._results_lock:
            self.n_steals += 1

    def _note_scale(self, action: str, worker_id: int, t_s: float,
                    lane_depth: int) -> None:
        # holds-lock: _topology
        self.scale_events.append({
            "t_s": round(t_s, 4),
            "action": action,
            "worker_id": worker_id,
            "n_active": len(self.workers) - len(self._retired),
            "lane_depth": lane_depth,
        })

    def scale_up(self, *, t_s: float = 0.0, lane_depth: int = 0) -> Optional[Worker]:
        """Add one worker to the active fleet.  A retired standby is
        reactivated first (its packs, pools and jitted families are
        intact); otherwise a fresh worker is built with the cluster's ctor
        material and given the runtime broadcast.  Functions arrive on it
        lazily, through the same failover re-registration path crashes
        use.  The heavy build runs outside the topology lock so placement
        is never blocked behind a worker bootstrap."""
        with self._results_lock:
            dead = set(self._dead)
        with self._topology:
            for w in self.workers:
                if w.worker_id in self._retired and w.worker_id not in dead:
                    self._retired.discard(w.worker_id)
                    self._note_scale("up", w.worker_id, t_s, lane_depth)
                    self._resize_executor()
                    return w
            wid = self._next_worker_idx
            self._next_worker_idx += 1
        worker = Worker(
            os.path.join(self._root, f"worker{wid}"),
            pool_budget_bytes=self._pool_budget_bytes,
            chunk_bytes=self._chunk_bytes,
            pool_policy=self._policy_factory() if self._policy_factory else None,
            storage=self._storage,
            worker_id=wid,
            tiers=self._tiers,
            prefetch_on_register=self._prefetch_on_register,
            device=self._device,
        )
        for family, (model, params, fwd) in list(self._runtimes.items()):
            worker.register_runtime(family, model, params, fwd=fwd)
        with self._topology:
            self.workers.append(worker)
            self._note_scale("up", wid, t_s, lane_depth)
            self._resize_executor()
        return worker

    def retire_worker(self, worker_id: int, *, t_s: float = 0.0,
                      lane_depth: int = 0) -> bool:
        """Remove a worker from the active fleet (scale-down).  The worker
        is kept as a standby — in-flight requests pinned to it finish, and
        a later scale-up reactivates it warm — but its homed functions
        re-place lazily onto the remaining actives on their next request.
        Refuses to retire the last active worker."""
        with self._topology:
            active = [w.worker_id for w in self.workers
                      if w.worker_id not in self._retired]
            if worker_id not in active or len(active) <= 1:
                return False
            self._retired.add(worker_id)
            for fn, h in list(self._home.items()):
                if h == worker_id:
                    del self._home[fn]
            self._note_scale("down", worker_id, t_s, lane_depth)
            self._resize_executor()
        return True

    # -- worker failure detection + failover ----------------------------------

    def _mark_dead(self, worker_id: int) -> None:
        with self._results_lock:
            if worker_id not in self._dead:
                self._dead.add(worker_id)
                self.n_worker_crashes += 1

    def _ensure_registered(self, worker: Worker, fn: str) -> None:
        """Lazy failover re-registration, under ``fn``'s single-flight lock.

        After a crash re-shards ``fn`` onto a survivor, the first request
        to arrive there (each queued re-dispatch included) finds the
        function missing and replays its registration from the cluster's
        spec record.  Doing this lazily — on the request path, under the
        lock the request already holds — sidesteps the deadlock an eager
        mass re-registration would risk (it would need *other* functions'
        flight locks while their holders wait on failover state)."""
        if fn in worker.specs:
            return
        spec = self._specs.get(fn)
        if spec is None:
            return      # never registered: worker.invoke raises the KeyError
        if spec.family not in worker.models:
            runtime = self._runtimes.get(spec.family)
            if runtime is not None:
                worker.register_runtime(spec.family, *runtime)
        worker.register_function(spec)

    def _invoke_with_failover(
        self, request: InvocationRequest, first: Optional[Worker] = None
    ) -> Tuple[InvocationResult, bool]:
        """Invoke on the current home shard — or on ``first`` when a work
        steal pinned the request to the thief worker — failing over on
        worker crashes.  Returns ``(result, crash_recovered)``; raises
        :class:`~repro.core.faults.WorkerCrashError` only when every
        worker is down."""
        fn = request.function
        crash_recovered = False
        last: Optional[WorkerCrashError] = None
        for _ in range(len(self.workers) + 1):
            worker = None
            if first is not None:
                with self._results_lock:
                    pinned_dead = first.worker_id in self._dead
                worker, first = (None if pinned_dead else first), None
            if worker is None:
                worker = self.worker_for(fn)
            self._ensure_registered(worker, fn)
            try:
                return worker.invoke(request), crash_recovered
            except WorkerCrashError as exc:
                # detection: mark the worker dead (conserved in metrics),
                # then re-dispatch onto the next survivor — the request is
                # not lost, it pays the re-registration as recovery work
                self._mark_dead(worker.worker_id)
                crash_recovered = True
                last = exc
        raise last if last is not None else WorkerCrashError(
            -1, "no workers available")

    # -- invocation -----------------------------------------------------------

    def _flight_lock(self, fn: str) -> threading.Lock:
        with self._flight_guard:
            lock = self._flight.get(fn)
            if lock is None:
                lock = self._flight[fn] = threading.Lock()
            return lock

    def _acquire_flight(self, fn: str) -> threading.Lock:
        """Acquire ``fn``'s *current* single-flight lock.

        A deregistration retires the lock object it held (and a
        re-registration mints a fresh one), so a waiter that looked the
        lock up before the retirement could acquire an orphaned object and
        run unserialised against holders of the fresh lock.  Re-checking
        the mapping after the acquire closes that window: an acquired lock
        is only honoured while it is still the published one."""
        while True:
            lock = self._flight_lock(fn)
            lock.acquire()
            with self._flight_guard:
                if self._flight.get(fn) is lock:
                    return lock
            lock.release()

    def _warm_target(self, request: InvocationRequest,
                     worker: Optional[Worker]) -> Optional[Worker]:
        """The worker the warm fast path may invoke on without the flight
        lock, or None when the request must take the locked cold path.

        Warm requests against a pooled instance run concurrently — that is
        the whole point of ``worker_concurrency`` — so single-flight
        serialises *cold starts* only.  The residency peek is advisory: an
        eviction between the peek and the invoke cold-starts unserialised
        (a duplicate boot at worst — restores read content-addressed
        chunks, so two in flight waste I/O but corrupt nothing)."""
        if request.options.force_cold:
            # a forced cold start IS a cold start: it must serialise under
            # the flight lock (deregistration GC parks on that lock too)
            return None
        target = worker if worker is not None else self.worker_for(
            request.function)
        fn = request.function
        if fn not in target.specs or not target.pool.contains(fn):
            return None
        with self._results_lock:
            if target.worker_id in self._dead:
                return None
        return target

    def _run(
        self, request: InvocationRequest, submitted: float,
        worker: Optional[Worker] = None,
    ) -> InvocationResult:
        # single-flight: concurrent COLD requests to one function
        # serialise, so at most one cold start per function is in flight;
        # followers hit the warm instance the leader just pooled.  Warm
        # requests bypass the lock (see _warm_target).  ``worker`` pins a
        # stolen request to the thief (failover still applies if it died).
        lock = None
        target = self._warm_target(request, worker)
        if target is None:
            lock = self._acquire_flight(request.function)
        try:
            # queue_s = executor wait + single-flight wait: a follower
            # blocked behind a leader's cold boot reports that time here,
            # not as a suspiciously instant warm latency_s
            queue_s = time.perf_counter() - submitted
            if lock is None:
                try:
                    result, crash_recovered = target.invoke(request), False
                except (WorkerCrashError, KeyError):
                    # crash or deregistration raced the warm peek: escalate
                    # to the locked path, whose failover re-registration
                    # assumes the flight lock is held
                    lock = self._acquire_flight(request.function)
                    result, crash_recovered = self._invoke_with_failover(
                        request, first=worker)
            else:
                result, crash_recovered = self._invoke_with_failover(
                    request, first=worker)
        except ShedError:
            raise
        except BaseException as exc:  # broad-ok: classified via FailureKind, recorded, re-raised
            kind = FailureKind.classify(exc)
            with self._results_lock:
                if kind is FailureKind.TIMEOUT:
                    self.n_timeout += 1
                else:
                    self.n_fault_fatal += 1
            raise
        finally:
            if lock is not None:
                lock.release()
        recovered = crash_recovered or result.fault_recovered
        result = dataclasses.replace(result, queue_s=queue_s,
                                     fault_recovered=recovered)
        with self._results_lock:
            self.n_requests += 1
            self.n_cold += int(result.cold)
            self.n_fault_recovered += int(recovered)
            self.queue_s_total += queue_s
            self._samples.add((
                queue_s, result.boot_s, result.exec_s,
                queue_s + result.latency_s, result.cold,
            ))
            # mean-service EMA feeds the steal-breakeven cost model
            service_s = result.boot_s + result.exec_s
            self._service_ema = (
                service_s if self._service_ema is None
                else 0.9 * self._service_ema + 0.1 * service_s
            )
        return result

    def _note_shed(self) -> None:
        """Admission-layer callback: one request was shed before reaching
        any worker (it never appears in ``n_requests``)."""
        with self._results_lock:
            self.n_shed += 1

    def submit(self, request: InvocationRequest) -> "Future[InvocationResult]":
        """Schedule one invocation; returns a Future of the typed result."""
        return self._executor.submit(self._run, request, time.perf_counter())

    def invoke(self, request: InvocationRequest) -> InvocationResult:
        """Synchronous convenience over :meth:`submit`."""
        return self.submit(request).result()

    # -- trace replay ---------------------------------------------------------

    def replay(
        self, requests: Iterable[InvocationRequest], *,
        max_inflight: Optional[int] = None,
    ) -> List[InvocationResult]:
        """Drive a request trace through the scheduler concurrently,
        preserving result order.  ``max_inflight`` bounds how far the driver
        runs ahead of completions (an open-loop arrival cap)."""
        requests = list(requests)
        results: List[Optional[InvocationResult]] = [None] * len(requests)
        window = max_inflight or len(requests) or 1
        inflight: List[tuple] = []
        for i, req in enumerate(requests):
            if len(inflight) >= window:
                j, fut = inflight.pop(0)
                results[j] = fut.result()
            inflight.append((i, self.submit(req)))
        for j, fut in inflight:
            results[j] = fut.result()
        return results  # type: ignore[return-value]

    def replay_trace(
        self,
        trace: InvocationTrace,
        specs: Sequence[FunctionSpec],
        *,
        strategy: "object | str" = "snapfaas",
        options: Optional[ColdStartOptions] = None,
        admission: Optional[AdmissionConfig] = None,
        autoscale: Optional[AutoscaleConfig] = None,
        time_scale: float = 1.0,
        seq: int = 32,
    ) -> "TraceReplayReport":
        """Replay a timed :class:`InvocationTrace` through the admission
        layer — the fleet-under-load driver.

        Requests are submitted at their trace arrival times (scaled by
        ``time_scale``; ``0`` submits as fast as possible — a pure stress
        replay) to a fresh :class:`AdmissionController` with bounded
        per-worker queues.  Each request either completes (its result's
        ``queue_s`` carries the measured admission + single-flight wait),
        is shed at a full queue, or fails; the report conserves
        ``submitted == completed + shed + failed`` and summarises the
        p50/p95/p99 end-to-end latency with its queueing split, plus the
        run's scheduler telemetry (placement policy, steals, scale events,
        per-worker queue-depth peaks).  ``autoscale`` runs a
        :class:`~repro.serving.scheduler.Autoscaler` for the duration of
        the replay, growing and shrinking the active fleet between the
        configured bounds as sustained lane depth crosses the hysteresis
        thresholds.  The same trace replayed under different
        ``policy_factory`` clusters is the keep-alive policy comparison
        (Fig. 7 under real arrivals).
        """
        vocab = self.workers[0].models[specs[0].family].cfg.vocab_size
        timed = trace.requests(specs, vocab, strategy=strategy,
                               options=options, seq=seq)
        ctrl = AdmissionController(self, admission or self._admission_cfg)
        scaler: Optional[Autoscaler] = None
        with self._topology:
            n_events_before = len(self.scale_events)
        if autoscale is not None:
            scaler = Autoscaler(self, ctrl, autoscale)
            scaler.start()
        futures: List["Future[InvocationResult]"] = []
        t_start = self._clock()
        try:
            for t_arrival, req in timed:
                if time_scale > 0:
                    delay = t_arrival * time_scale - (self._clock() - t_start)
                    if delay > 0:
                        time.sleep(delay)
                futures.append(ctrl.submit(req))
            results: List[Optional[InvocationResult]] = [None] * len(futures)
            shed = [False] * len(futures)
            errors: List[Tuple[int, BaseException]] = []
            for i, fut in enumerate(futures):
                try:
                    results[i] = fut.result()
                except ShedError:
                    shed[i] = True
                except Exception as e:  # broad-ok: collected into the errors list and reported
                    errors.append((i, e))
            wall_s = self._clock() - t_start
        finally:
            if scaler is not None:
                scaler.stop()
            ctrl.shutdown()
        admission_m = ctrl.metrics()
        with self._topology:
            events = [dict(e) for e in self.scale_events[n_events_before:]]
        scheduler = {
            "placement": self.placement.name,
            "steal": self.steal is not None,
            "steals": admission_m.get("steals", 0),
            "scale_events": events,
            "queue_depth_peaks": ctrl.queue_depth_peaks(),
            "n_workers_final": self.n_active(),
        }
        return TraceReplayReport(
            trace=trace, results=results, shed=shed, errors=errors,
            wall_s=wall_s, admission=admission_m, scheduler=scheduler,
        )

    # -- fleet metrics ---------------------------------------------------------

    def serving_stats(self) -> Dict:
        """Percentile view of the request path: end-to-end latency and its
        queueing-delay / boot / execution split, over a uniform reservoir
        of the whole run (completed requests; sheds are counted
        separately).  ``n_seen`` is the total stream length the
        ``n_samples``-sized window represents."""
        with self._results_lock:
            samples = self._samples.snapshot()
            n_seen = self._samples.n_seen
            n_shed = self.n_shed
            failures = {
                str(FailureKind.SHED): self.n_shed,
                str(FailureKind.TIMEOUT): self.n_timeout,
                str(FailureKind.FAULT_RECOVERED): self.n_fault_recovered,
                str(FailureKind.FAULT_FATAL): self.n_fault_fatal,
            }
            dead_workers = sorted(self._dead)
            n_worker_crashes = self.n_worker_crashes
        cold = [s for s in samples if s[4]]
        out = {
            "n_samples": len(samples),
            "n_seen": n_seen,
            "n_shed": n_shed,
            "failures": failures,
            "dead_workers": dead_workers,
            "n_worker_crashes": n_worker_crashes,
            "e2e_ms": percentiles([s[3] for s in samples]),
            "queue_ms": percentiles([s[0] for s in samples]),
            "exec_ms": percentiles([s[2] for s in samples]),
            "cold_boot_ms": percentiles([s[1] for s in cold]),
            "n_cold_samples": len(cold),
        }
        if self._admission is not None:
            out["admission"] = self._admission.metrics()
        return out

    def metrics(self) -> Dict:
        with self._results_lock:
            dead = set(self._dead)
        per_worker = []
        for w in self.workers:
            per_worker.append({
                "worker_id": w.worker_id,
                "alive": w.worker_id not in dead,
                "functions": sorted(w.specs),
                "pool": w.pool.stats(),
                "tiers": w.tier_stats(),
                "dedup": w.registry.dedup_stats(),
            })
        pools = [w.pool for w in self.workers]
        hits = sum(p.hits for p in pools)
        misses = sum(p.misses for p in pools)
        with self._results_lock:
            n_req, n_cold = self.n_requests, self.n_cold
            queue_total = self.queue_s_total
        # fleet view of the storage hierarchy: what the warm tiers absorbed
        # and what the remote link cost (the replay driver reports these) —
        # reuse the per-worker snapshots so both views are consistent
        tier_stats = [pw["tiers"] for pw in per_worker]
        ram_hits = sum(t["ram"]["hits"] for t in tier_stats)
        ram_hit_bytes = sum(t["ram"]["hit_bytes"] for t in tier_stats)
        ram_evictions = sum(t["ram"]["evictions"] for t in tier_stats)
        remote = [t["remote"] for t in tier_stats if "remote" in t]
        tiers = {
            "ram_hits": ram_hits,
            "ram_hit_bytes": ram_hit_bytes,
            "ram_evictions": ram_evictions,
            "promoted_bytes": sum(t["promoted_bytes"] for t in tier_stats),
            "demoted_bytes": sum(t["demoted_bytes"] for t in tier_stats),
            "prefetched_bytes": sum(t["prefetched_bytes"] for t in tier_stats),
            "prefetch_fetch_s": round(
                sum(t["prefetch_fetch_s"] for t in tier_stats), 6),
            "remote_fetches": sum(r["fetches"] for r in remote),
            "remote_fetched_bytes": sum(r["fetched_bytes"] for r in remote),
            "remote_fetch_s": round(sum(r["fetch_s"] for r in remote), 6),
        }
        # fleet recovery view: verification/repair/retry work the storage
        # hierarchy absorbed (all zeros on a fault-free run)
        health_rows = [t.get("health", {}) for t in tier_stats]
        tiers["health"] = {
            key: sum(h.get(key, 0) for h in health_rows)
            for key in (
                "verified_chunks", "verify_failures", "repaired_chunks",
                "repaired_bytes", "quarantined_chunks", "read_retries",
                "fail_fast_reads", "hedged_fetches", "hedge_wins",
                "prefetch_skipped_chunks",
            )
        }
        # fleet dedup view: what a per-function (flat) store would hold vs
        # the unique bytes the content-addressed stores actually hold
        dedup_rows = [pw["dedup"] for pw in per_worker]
        referenced = sum(d["referenced_bytes"] for d in dedup_rows)
        unique = sum(d["unique_bytes"] for d in dedup_rows)
        dedup = {
            "referenced_bytes": referenced,
            "unique_bytes": unique,
            "dedup_ratio": round(unique / referenced, 4) if referenced else 1.0,
            "shared_digests": sum(d["shared_digests"] for d in dedup_rows),
        }
        # injected-fault counters: the injector is shared through the tier
        # spec, so any worker's handle reports the whole run's injections
        chaos = None
        for w in self.workers:
            if getattr(w, "faults", None) is not None:
                chaos = w.faults.counters_snapshot()
                break
        with self._topology:
            retired = sorted(self._retired)
            scale_events = [dict(e) for e in self.scale_events]
        with self._results_lock:
            n_steals = self.n_steals
        scheduler = {
            "placement": self.placement.name,
            "steal": dataclasses.asdict(self.steal) if self.steal else None,
            "steals": n_steals,
            "n_workers_active": len(self.workers) - len(retired),
            "retired_workers": retired,
            "scale_events": scale_events,
        }
        out = {
            "n_workers": len(self.workers),
            "n_requests": n_req,
            "n_cold": n_cold,
            "scheduler": scheduler,
            "serving": self.serving_stats(),
            "cold_fraction": round(n_cold / n_req, 4) if n_req else 0.0,
            "mean_queue_ms": round(queue_total / n_req * 1e3, 3) if n_req else 0.0,
            "pool": {
                "hits": hits,
                "misses": misses,
                "evictions": sum(p.evictions for p in pools),
                "rejections": sum(p.rejections for p in pools),
                "used_bytes": sum(p.used for p in pools),
                "budget_bytes": sum(p.budget for p in pools),
                "warm_hit_rate": round(hits / (hits + misses), 4)
                                 if hits + misses else 0.0,
            },
            "tiers": tiers,
            "dedup": dedup,
            "per_worker": per_worker,
        }
        if chaos is not None:
            out["chaos"] = chaos
        return out

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


@dataclasses.dataclass
class TraceReplayReport:
    """Outcome of one :meth:`Cluster.replay_trace` run.

    ``results[i]`` is the i-th arrival's :class:`InvocationResult` (or
    ``None`` if it was shed/failed); ``shed[i]`` marks admission sheds;
    ``errors`` carries (index, exception) for hard failures.  The
    conservation invariant ``submitted == completed + shed + failed``
    holds by construction.
    """

    trace: InvocationTrace
    results: List[Optional[InvocationResult]]
    shed: List[bool]
    errors: List[Tuple[int, BaseException]]
    wall_s: float
    admission: Dict
    # scheduler telemetry for the run: placement policy name, steal count,
    # autoscale events and per-worker queue-depth peaks
    scheduler: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_submitted(self) -> int:
        return len(self.results)

    @property
    def n_completed(self) -> int:
        return sum(1 for r in self.results if r is not None)

    @property
    def n_shed(self) -> int:
        return sum(self.shed)

    @property
    def n_failed(self) -> int:
        return len(self.errors)

    @property
    def n_timeout(self) -> int:
        """Failures in the TIMEOUT bucket (deadline/timeout errors)."""
        return sum(
            1 for _, e in self.errors
            if FailureKind.classify(e) is FailureKind.TIMEOUT
        )

    @property
    def n_fault_fatal(self) -> int:
        """Failures that were terminal faults (everything non-timeout)."""
        return self.n_failed - self.n_timeout

    @property
    def n_fault_recovered(self) -> int:
        """Completed requests that needed recovery work (retries, chunk
        repair, or worker failover) on their path."""
        return sum(1 for r in self.results
                   if r is not None and r.fault_recovered)

    def failures(self) -> Dict[str, int]:
        """The typed failure taxonomy, one count per FailureKind bucket
        (fault_recovered counts *completed* requests, so it is not part of
        the conservation sum)."""
        return {
            str(FailureKind.SHED): self.n_shed,
            str(FailureKind.TIMEOUT): self.n_timeout,
            str(FailureKind.FAULT_RECOVERED): self.n_fault_recovered,
            str(FailureKind.FAULT_FATAL): self.n_fault_fatal,
        }

    def completed(self) -> List[InvocationResult]:
        return [r for r in self.results if r is not None]

    def summary(self) -> Dict:
        """JSON-ready percentile summary (the bench ``trace_serving`` row)."""
        done = self.completed()
        cold = [r for r in done if r.cold]
        return {
            "pattern": self.trace.pattern,
            "seed": self.trace.seed,
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_shed": self.n_shed,
            "n_failed": self.n_failed,
            "failures": self.failures(),
            "n_cold": len(cold),
            "wall_s": round(self.wall_s, 4),
            "offered_rps": round(self.trace.mean_rps, 3),
            "e2e_ms": percentiles([r.queue_s + r.latency_s for r in done]),
            "queue_ms": percentiles([r.queue_s for r in done]),
            "exec_ms": percentiles([r.exec_s for r in done]),
            "cold_boot_ms": percentiles([r.boot_s for r in cold]),
            "max_queue_depth": self.admission.get("max_queue_depth", 0),
            "placement": self.scheduler.get("placement", "static"),
            "steal": self.scheduler.get("steal", False),
            "steals": self.scheduler.get("steals", 0),
            "scale_events": self.scheduler.get("scale_events", []),
            "queue_depth_peaks": self.scheduler.get("queue_depth_peaks", {}),
            "n_workers_final": self.scheduler.get("n_workers_final"),
        }
