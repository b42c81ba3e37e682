"""Deterministic fault injection and the recovery primitives it exercises.

The paper's Eq. 1 prices a cold start on a substrate that never lies; a
production snapshot store restores from exactly the layers that fail in
practice — remote tiers stall or disappear, pack payloads rot, workers die
mid-replay.  This module supplies both halves of the robustness story:

* **injection** — a seedable :class:`FaultInjector` driven by a
  :class:`FaultMatrix` wraps any :class:`~repro.core.tiers.StorageTier`
  (via :class:`FaultyTier`) and the worker execution path
  (``before_invoke``), injecting transient IOErrors, read timeouts,
  slow/partial reads, payload bit-flips, remote-tier outages and worker
  crashes — all from one seeded RNG, so a failing chaos run replays
  exactly;
* **recovery** — the typed failure taxonomy
  (:class:`ChunkIntegrityError`, :class:`TierReadError`,
  :class:`TierUnavailableError`, :class:`DeadlineExceededError`,
  :class:`WorkerCrashError`), the :class:`RetryPolicy` (exponential
  backoff + jitter + per-request deadline, optional hedging) and the
  per-tier :class:`CircuitBreaker` that
  :class:`~repro.core.tiers.TieredChunkStore` drives its self-healing
  read path with.

Named chaos profiles (:func:`chaos_profile`) back the replay CLI's
``--chaos`` flag and the ``chaos`` bench section.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# typed failure taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of the typed storage/worker failure taxonomy."""


class TierReadError(FaultError):
    """A tier read failed for identifiable chunks, after recovery tried.

    Carries the chunk digests, the tier that failed and the underlying
    cause, so retry/repair layers (and the failure taxonomy) can classify
    it — the fix for the bare ``KeyError``/``IOError`` the tiered read
    path used to leak.
    """

    def __init__(self, digests: Sequence[str], tier: str,
                 cause: "BaseException | str | None" = None):
        self.digests = list(digests)
        self.tier = tier
        self.cause = cause
        head = ", ".join(d[:12] for d in self.digests[:4])
        more = f" (+{len(self.digests) - 4} more)" if len(self.digests) > 4 else ""
        super().__init__(
            f"read of chunk(s) {head}{more} failed on tier {tier!r}: {cause}"
        )


class TierUnavailableError(TierReadError):
    """The tier is down (injected outage, or its circuit breaker is open)."""


class DeadlineExceededError(TierReadError, TimeoutError):
    """The retry policy's per-request deadline expired before a read
    succeeded.  Also a ``TimeoutError``, so the serving taxonomy counts it
    in the ``timeout`` bucket."""


class ChunkIntegrityError(FaultError):
    """A chunk's payload failed digest verification and no tier or shared
    base held a good copy — the read is refused rather than served wrong."""

    def __init__(self, digest: str, size: int = 0,
                 tried: Sequence[str] = ()):
        self.digest = digest
        self.size = size
        self.tried = list(tried)
        super().__init__(
            f"chunk {digest[:12]} ({size} B) failed digest verification and "
            f"could not be repaired (sources tried: {self.tried})"
        )


class WorkerCrashError(FaultError):
    """The worker process died (injected) — the cluster fails it over."""

    def __init__(self, worker_id: int, detail: str = "injected crash"):
        self.worker_id = worker_id
        super().__init__(f"worker {worker_id} crashed: {detail}")


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter under a per-request deadline.

    ``hedge_after_s`` (None → off) arms hedged fetches: if the first
    remote attempt has not landed after that long, a duplicate fetch is
    issued and the first success wins — the standard tail-latency
    treatment for a lossy remote link.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    jitter: float = 0.5          # ± fraction of the backoff
    deadline_s: float = 10.0
    hedge_after_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")

    def backoff_s(self, attempt: int,
                  rng: Optional[np.random.Generator] = None) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * float(rng.random()) - 1.0)
        return max(0.0, d)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Per-tier health gate: closed → open → half-open → closed.

    ``failure_threshold`` consecutive failures open the breaker; while
    open, ``allow()`` fails fast (no reads reach the dead tier).  After
    ``reset_after_s`` one probe is let through (half-open): success closes
    the breaker, failure re-opens it.  ``on_state_change(name, state)``
    fires outside the breaker lock on every transition — the tiered store
    wires it to its residency-epoch bump so cached restore plans and
    Eq. 1 tables re-price around the dead tier.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str = "", *, failure_threshold: int = 4,
                 reset_after_s: float = 0.5,
                 clock=time.monotonic,
                 on_state_change=None):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._on_change = on_state_change
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.n_opens = 0
        self.n_fail_fast = 0

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == self.OPEN
                    and self._clock() - self._opened_at >= self.reset_after_s):
                return self.HALF_OPEN
            return self._state

    @property
    def is_open(self) -> bool:
        """True while reads should avoid this tier (open, not yet probing)."""
        return self.state == self.OPEN

    def _transition(self, state: str) -> Optional[str]:
        """Set state under the lock held by the caller; returns the new
        state if it changed (the caller fires the callback lock-free)."""
        if self._state == state:
            return None
        self._state = state
        if state == self.OPEN:
            self._opened_at = self._clock()
            self.n_opens += 1
        return state

    def _notify(self, changed: Optional[str]) -> None:
        if changed is not None and self._on_change is not None:
            self._on_change(self.name, changed)

    # -- protocol --------------------------------------------------------------

    def allow(self) -> bool:
        """May a read proceed?  Open → False (fail fast); half-open →
        exactly one probe at a time."""
        with self._lock:
            if self._state != self.OPEN:
                return True
            if self._clock() - self._opened_at < self.reset_after_s:
                self.n_fail_fast += 1
                return False
            # half-open: admit one probe, everyone else keeps failing fast
            if self._probing:
                self.n_fail_fast += 1
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            changed = self._transition(self.CLOSED)
        self._notify(changed)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            changed = None
            if self._state == self.OPEN:
                # a failed half-open probe: restart the cooldown
                self._opened_at = self._clock()
            elif self._failures >= self.failure_threshold:
                changed = self._transition(self.OPEN)
        self._notify(changed)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._state,
                "failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "reset_after_s": self.reset_after_s,
                "opens": self.n_opens,
                "fail_fast": self.n_fail_fast,
            }


# ---------------------------------------------------------------------------
# fault matrix + injector
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultMatrix:
    """Per-fault probabilities (and schedules) of one chaos run.

    Probabilities are per read call (``transient_ioerror``,
    ``read_timeout``, ``slow_read``, ``partial_read``), per chunk
    (``bit_flip``) or per invocation (``worker_crash``).
    ``remote_outage`` is a wall-clock window (seconds since the injector
    was created) during which every remote read fails with
    :class:`TierUnavailableError`.  ``crash_after`` deterministically
    crashes one worker (``crash_worker_id``, or whichever reaches the
    count first) at its Nth invocation — the "crash one worker
    mid-replay" schedule the chaos soak uses.
    """

    seed: int = 0
    transient_ioerror: float = 0.0
    read_timeout: float = 0.0
    timeout_s: float = 0.05
    slow_read: float = 0.0
    slow_s: float = 0.02
    partial_read: float = 0.0
    bit_flip: float = 0.0
    remote_outage: Optional[Tuple[float, float]] = None
    worker_crash: float = 0.0
    crash_worker_id: Optional[int] = None
    crash_after: Optional[int] = None
    tiers: Tuple[str, ...] = ("local", "remote")


class FaultInjector:
    """Seeded fault source shared by every tier wrapper and worker hook.

    One injector per chaos run: all draws come from a single seeded RNG
    under a lock, so a given (matrix, call sequence) replays the same
    faults.  Tiers are wrapped with :meth:`wrap_tier`; the worker
    execution path calls :meth:`before_invoke`.  ``fail_tier`` /
    ``heal_tier`` toggle an outage by hand (tests, breaker probes)."""

    def __init__(self, matrix: Optional[FaultMatrix] = None, *,
                 clock=time.monotonic):
        self.matrix = matrix or FaultMatrix()
        self._rng = np.random.default_rng(self.matrix.seed)
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self._down: set = set()
        self._crashed: set = set()
        self._invocations: Dict[int, int] = {}
        self.counters: Dict[str, int] = {}

    # -- bookkeeping ----------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def _p(self, prob: float) -> bool:
        if prob <= 0.0:
            return False
        with self._lock:
            return float(self._rng.random()) < prob

    def _randint(self, n: int) -> int:
        with self._lock:
            return int(self._rng.integers(n))

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["crashed_workers"] = sorted(self._crashed)
        out["tiers_down"] = sorted(self._down)
        return out

    # -- tier availability ------------------------------------------------------

    def fail_tier(self, name: str) -> None:
        with self._lock:
            self._down.add(name)

    def heal_tier(self, name: str) -> None:
        with self._lock:
            self._down.discard(name)

    def reset_clock(self) -> None:
        """Re-arm the matrix's time-relative faults (the ``remote_outage``
        window) to count from *now* instead of injector construction.
        Call after setup work (registration, prefetch) so a windowed
        outage lands on the traffic being measured."""
        with self._lock:
            self._t0 = self._clock()

    def tier_down(self, name: str) -> bool:
        with self._lock:
            if name in self._down:
                return True
        win = self.matrix.remote_outage
        if name == "remote" and win is not None:
            t = self._clock() - self._t0
            return win[0] <= t < win[1]
        return False

    # -- read-path hooks (called by FaultyTier) --------------------------------

    def before_read(self, tier: str, items: Sequence) -> None:
        if self.tier_down(tier):
            self._count(f"{tier}.outage_reads")
            raise TierUnavailableError(
                [r.digest for r, _ in items], tier, "injected outage"
            )
        if tier not in self.matrix.tiers:
            return
        m = self.matrix
        if self._p(m.transient_ioerror):
            self._count(f"{tier}.transient_ioerror")
            raise IOError(f"injected transient fault on tier {tier!r}")
        if self._p(m.read_timeout):
            self._count(f"{tier}.read_timeout")
            time.sleep(m.timeout_s)
        elif self._p(m.slow_read):
            self._count(f"{tier}.slow_read")
            time.sleep(m.slow_s)

    def after_read(self, tier: str, items: Sequence) -> None:
        """Corrupt payloads *in flight* (after the medium read, before the
        caller sees them) — what digest verification must catch."""
        if tier not in self.matrix.tiers:
            return
        m = self.matrix
        if m.bit_flip > 0.0:
            flips = 0
            for _ref, view in items:
                if self._p(m.bit_flip) and len(view):
                    view[self._randint(len(view))] ^= 0x40
                    flips += 1
            if flips:
                self._count(f"{tier}.bit_flip", flips)
        if m.partial_read > 0.0 and items and self._p(m.partial_read):
            _ref, view = items[self._randint(len(items))]
            half = len(view) // 2
            if half:
                view[half:] = b"\x00" * (len(view) - half)
                self._count(f"{tier}.partial_read")

    def wrap_tier(self, tier) -> "FaultyTier":
        return FaultyTier(tier, self)

    # -- worker hook ------------------------------------------------------------

    def before_invoke(self, worker_id: int) -> None:
        """Raise :class:`WorkerCrashError` per the crash schedule.  A
        crashed worker stays crashed — every later invocation against it
        fails too, until the cluster fails it over."""
        with self._lock:
            if worker_id in self._crashed:
                raise WorkerCrashError(worker_id, "worker is down")
            n = self._invocations.get(worker_id, 0) + 1
            self._invocations[worker_id] = n
        m = self.matrix
        if (m.crash_after is not None and not self._crashed
                and m.crash_worker_id in (None, worker_id)
                and n >= m.crash_after):
            self._crash(worker_id)
        if self._p(m.worker_crash):
            self._crash(worker_id)

    def _crash(self, worker_id: int) -> None:
        with self._lock:
            self._crashed.add(worker_id)
        self._count("worker_crash")
        raise WorkerCrashError(worker_id)


class FaultyTier:
    """A :class:`~repro.core.tiers.StorageTier` wrapper injecting the
    matrix's read faults.  Everything except ``read_into`` delegates, so
    the wrapper is transparent to residency checks, stats and the
    underlying store handle."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._inj = injector

    @property
    def name(self) -> str:
        return self._inner.name

    def has(self, digest: str) -> bool:
        return self._inner.has(digest)

    def read_into(self, items, **kwargs) -> int:
        self._inj.before_read(self.name, items)
        n = self._inner.read_into(items, **kwargs)
        self._inj.after_read(self.name, items)
        return n

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


# ---------------------------------------------------------------------------
# named chaos profiles (CLI / bench / CI)
# ---------------------------------------------------------------------------

CHAOS_PROFILES = ("remote-outage", "lossy-disk", "flaky-worker", "standard")


def chaos_profile(name: str, *, seed: int = 0) -> FaultMatrix:
    """Named fault matrices for the replay CLI and the chaos bench.

    * ``remote-outage`` — the remote tier disappears for the first second
      of the run (breaker + graceful degradation path);
    * ``lossy-disk``    — local pack reads flip bits and throw transient
      IOErrors (verification + quarantine-and-repair path);
    * ``flaky-worker``  — each invocation has a small chance of killing
      its worker (failover path);
    * ``standard``      — the acceptance matrix: a remote outage window,
      1% corrupt reads, and one worker crash early in the replay.
    """
    if name == "remote-outage":
        return FaultMatrix(seed=seed, remote_outage=(0.0, 1.0))
    if name == "lossy-disk":
        return FaultMatrix(seed=seed, transient_ioerror=0.02, bit_flip=0.02,
                           tiers=("local",))
    if name == "flaky-worker":
        return FaultMatrix(seed=seed, worker_crash=0.02)
    if name == "standard":
        return FaultMatrix(seed=seed, bit_flip=0.01,
                           remote_outage=(0.1, 0.6), crash_after=5)
    raise ValueError(
        f"unknown chaos profile {name!r}; one of {CHAOS_PROFILES}"
    )
