"""Trace-driven load engine: arrival processes for serving benchmarks.

The paper's Eq. 1 numbers are *per-invocation* limits; a fleet's cold-start
behaviour only shows up under concurrent, bursty arrivals (vHive's
benchmarking methodology makes this point, and production FaaS traces —
Shahrad et al. 2020's Azure dataset — are heavy-tailed in both function
popularity and arrival rate).  This module generates deterministic,
seedable :class:`InvocationTrace`\\ s from four arrival models:

* ``poisson``  — homogeneous Poisson arrivals at a fixed mean RPS;
* ``mmpp``     — bursty 2-state Markov-modulated Poisson process (a quiet
  base rate with exponentially-dwelling burst episodes at a multiple of
  it) — the classic burstiness model;
* ``diurnal``  — inhomogeneous Poisson with a sinusoidal day/night rate
  curve, sampled by Lewis–Shedler thinning;
* ``azure``    — Azure-trace-style *per-function* schedules: every
  function gets its own Poisson process whose rate is its share of the
  aggregate RPS under a Zipf popularity law, and the streams are merged.

All four models pick *which* function each arrival hits from a Zipf
popularity skew (``azure`` gets the skew from the per-function rates
themselves).  Traces are pure data — sorted arrival offsets plus function
indices and per-request token seeds — so the same seed always produces
the same trace, byte for byte, independent of what replays it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.api import ColdStartOptions, InvocationRequest, Strategy


@dataclass(frozen=True)
class TracedArrival:
    """One request in a trace: when it arrives, whom it hits, and the seed
    its tokens are drawn from (so replays are byte-deterministic)."""

    t: float              # arrival offset (s) from trace start
    function_idx: int     # index into the replayed function list
    seed: int             # per-request token seed


@dataclass(frozen=True)
class InvocationTrace:
    """A deterministic arrival schedule (the unit the replay driver runs).

    ``arrivals`` are sorted by ``t``.  ``pattern``/``params``/``seed``
    record provenance so benchmark JSON rows are self-describing.
    """

    pattern: str
    seed: int
    duration_s: float
    n_functions: int
    arrivals: Tuple[TracedArrival, ...]
    params: Dict[str, float] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def mean_rps(self) -> float:
        return len(self.arrivals) / self.duration_s if self.duration_s else 0.0

    def requests(
        self,
        specs: Sequence,
        vocab: int,
        *,
        strategy: "Strategy | str" = Strategy.SNAPFAAS,
        options: Optional[ColdStartOptions] = None,
        seq: int = 32,
    ) -> List[Tuple[float, InvocationRequest]]:
        """Materialize ``(arrival offset, typed request)`` pairs against a
        registered function suite.  Tokens are drawn from each arrival's own
        seed, so two materializations of the same trace are byte-identical."""
        from repro_torch.serving.trace import request_tokens

        base = options or ColdStartOptions(strategy=Strategy.coerce(strategy))
        out: List[Tuple[float, InvocationRequest]] = []
        for a in self.arrivals:
            spec = specs[a.function_idx % len(specs)]
            toks = request_tokens(
                spec, np.random.default_rng(a.seed), vocab,
                seq=getattr(spec, "exec_seq", seq),
            )
            out.append((a.t, InvocationRequest(
                function=spec.name, tokens=toks, options=base,
            )))
        return out


def zipf_weights(n_functions: int, alpha: float) -> np.ndarray:
    """Normalized Zipf popularity over function ranks (rank 0 hottest)."""
    w = np.arange(1, n_functions + 1, dtype=np.float64) ** -float(alpha)
    return w / w.sum()


def _finalize(
    pattern: str, times: np.ndarray, n_functions: int, alpha: float,
    seed: int, duration_s: float, params: Dict[str, float],
    fn_idx: Optional[np.ndarray] = None,
) -> InvocationTrace:
    """Sort arrivals, draw function targets (Zipf) and token seeds."""
    order = np.argsort(times, kind="stable")
    times = times[order]
    rng = np.random.default_rng(seed ^ 0x5EED)
    if fn_idx is None:
        fn_idx = rng.choice(
            n_functions, size=len(times), p=zipf_weights(n_functions, alpha)
        )
    else:
        fn_idx = fn_idx[order]
    # token seeds are drawn once, in arrival order — deterministic per trace
    tok_seeds = rng.integers(0, 2**31 - 1, size=len(times))
    arrivals = tuple(
        TracedArrival(t=float(t), function_idx=int(f), seed=int(s))
        for t, f, s in zip(times, fn_idx, tok_seeds)
    )
    return InvocationTrace(
        pattern=pattern, seed=seed, duration_s=duration_s,
        n_functions=n_functions, arrivals=arrivals, params=dict(params),
    )


def poisson_trace(
    *, rps: float, duration_s: float, n_functions: int,
    zipf_alpha: float = 1.1, seed: int = 0,
) -> InvocationTrace:
    """Homogeneous Poisson arrivals: exponential inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    # draw ~20% headroom of gaps, then trim to the window (cheap, exact)
    n_est = max(16, int(rps * duration_s * 1.2) + 16)
    times = np.cumsum(rng.exponential(1.0 / rps, size=n_est))
    while times[-1] < duration_s:  # pragma: no cover - headroom almost always enough
        times = np.concatenate(
            [times, times[-1] + np.cumsum(rng.exponential(1.0 / rps, size=n_est))]
        )
    times = times[times < duration_s]
    return _finalize(
        "poisson", times, n_functions, zipf_alpha, seed, duration_s,
        {"rps": rps, "zipf_alpha": zipf_alpha},
    )


def mmpp_trace(
    *, rps: float, duration_s: float, n_functions: int,
    burst_factor: float = 8.0, burst_fraction: float = 0.1,
    mean_dwell_s: float = 0.5, zipf_alpha: float = 1.1, seed: int = 0,
) -> InvocationTrace:
    """Bursty 2-state MMPP: a quiet state and a burst state whose rate is
    ``burst_factor``× quieter-state's, dwelling exponentially in each.

    Rates are chosen so the *time-averaged* rate equals ``rps``:
    ``rps = (1-f)·lam_quiet + f·lam_burst`` with ``f = burst_fraction``.
    """
    if burst_fraction <= 0 or burst_fraction >= 1:
        raise ValueError("burst_fraction must be in (0, 1)")
    lam_quiet = rps / (1.0 - burst_fraction + burst_fraction * burst_factor)
    lam_burst = lam_quiet * burst_factor
    # state dwell times: mean_dwell_s in burst, scaled to hit burst_fraction
    dwell_burst = mean_dwell_s
    dwell_quiet = dwell_burst * (1.0 - burst_fraction) / burst_fraction
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = 0.0
    in_burst = False
    while t < duration_s:
        dwell = rng.exponential(dwell_burst if in_burst else dwell_quiet)
        end = min(t + dwell, duration_s)
        lam = lam_burst if in_burst else lam_quiet
        if lam > 0:
            tt = t + rng.exponential(1.0 / lam)
            while tt < end:
                times.append(tt)
                tt += rng.exponential(1.0 / lam)
        t = end
        in_burst = not in_burst
    return _finalize(
        "mmpp", np.asarray(times), n_functions, zipf_alpha, seed, duration_s,
        {"rps": rps, "burst_factor": burst_factor,
         "burst_fraction": burst_fraction, "mean_dwell_s": mean_dwell_s,
         "zipf_alpha": zipf_alpha},
    )


def diurnal_trace(
    *, rps: float, duration_s: float, n_functions: int,
    period_s: Optional[float] = None, depth: float = 0.8,
    zipf_alpha: float = 1.1, seed: int = 0,
) -> InvocationTrace:
    """Inhomogeneous Poisson with a sinusoidal rate curve
    ``λ(t) = rps·(1 + depth·sin(2πt/period))`` (Lewis–Shedler thinning).
    ``period_s`` defaults to the trace duration — one full day/night cycle.
    """
    if not 0.0 <= depth <= 1.0:
        raise ValueError("depth must be in [0, 1]")
    period = period_s or duration_s
    lam_max = rps * (1.0 + depth)
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= duration_s:
            break
        lam_t = rps * (1.0 + depth * np.sin(2.0 * np.pi * t / period))
        if rng.random() * lam_max <= lam_t:
            times.append(t)
    return _finalize(
        "diurnal", np.asarray(times), n_functions, zipf_alpha, seed,
        duration_s,
        {"rps": rps, "period_s": period, "depth": depth,
         "zipf_alpha": zipf_alpha},
    )


def azure_trace(
    *, rps: float, duration_s: float, n_functions: int,
    zipf_alpha: float = 1.1, seed: int = 0,
) -> InvocationTrace:
    """Azure-trace-style synthetic workload: per-function Poisson schedules.

    Each function's rate is its Zipf share of the aggregate ``rps`` (the
    Shahrad et al. 2020 observation: a few functions dominate invocations
    while a long tail is invoked rarely — exactly the regime where
    keep-alive policy and cold-start cost interact).  Streams are generated
    independently per function and merged, so the hot function arrives in
    near-steady state while tail functions arrive cold almost every time.
    """
    weights = zipf_weights(n_functions, zipf_alpha)
    rng = np.random.default_rng(seed)
    all_times: List[np.ndarray] = []
    all_idx: List[np.ndarray] = []
    for i, w in enumerate(weights):
        lam = rps * float(w)
        if lam <= 0:
            continue
        n_est = max(4, int(lam * duration_s * 1.5) + 8)
        times = np.cumsum(rng.exponential(1.0 / lam, size=n_est))
        while times[-1] < duration_s:  # pragma: no cover
            times = np.concatenate(
                [times,
                 times[-1] + np.cumsum(rng.exponential(1.0 / lam, size=n_est))]
            )
        times = times[times < duration_s]
        all_times.append(times)
        all_idx.append(np.full(len(times), i, dtype=np.int64))
    times = np.concatenate(all_times) if all_times else np.empty(0)
    fn_idx = np.concatenate(all_idx) if all_idx else np.empty(0, np.int64)
    return _finalize(
        "azure", times, n_functions, zipf_alpha, seed, duration_s,
        {"rps": rps, "zipf_alpha": zipf_alpha}, fn_idx=fn_idx,
    )


TRACE_PATTERNS: Dict[str, Callable[..., InvocationTrace]] = {
    "poisson": poisson_trace,
    "mmpp": mmpp_trace,
    "diurnal": diurnal_trace,
    "azure": azure_trace,
}


def make_trace(
    pattern: str, *, rps: float, duration_s: float, n_functions: int,
    zipf_alpha: float = 1.1, seed: int = 0, **kw,
) -> InvocationTrace:
    """Build a trace by pattern name (``poisson``/``mmpp``/``diurnal``/
    ``azure``); extra keywords go to the pattern's generator."""
    try:
        gen = TRACE_PATTERNS[pattern]
    except KeyError:
        raise ValueError(
            f"unknown trace pattern {pattern!r}; one of "
            f"{sorted(TRACE_PATTERNS)}"
        ) from None
    return gen(rps=rps, duration_s=duration_s, n_functions=n_functions,
               zipf_alpha=zipf_alpha, seed=seed, **kw)
