"""Traffic of a cell, made from its workload file and the seed alone.

One general generator reads the mix's parameters:

* ``loop``: ``open`` (arrivals on a schedule, whatever the system does) or
  ``closed`` (``clients`` callers, each sending its next request when the
  last one returned);
* ``arrivals`` (open loop): ``{"kind": "poisson", "rate_per_s": r}`` with a
  fixed count, ``round(r * seconds)`` arrivals whose gaps are the
  exponential's quantiles in a seeded order, so that every seed offers the
  same work; ``mmpp`` is ``serving/loadgen.py``'s bursty draw (the count
  varies with the trace seed);
* ``functions``: the kinds of the cell's functions, ranked by popularity;
  ``popularity``: ``{"kind": "zipf", "alpha": a}`` or ``{"kind": "uniform"}``.
  Each function's share of the requests is fixed (largest remainder), the
  order seeded;
* ``batch`` and ``seq_lens``: every request is ``batch`` rows of one of the
  lengths, the lengths in equal shares, in a seeded order;
* ``trace_seed``: the arrival times and the orders come from it and not
  from the run's seed, so that every run replays one trace and the run's
  seed draws the data (weights, deltas, tokens) alone.

Tokens are drawn from each request's own seed; a function whose delta
changes some embedding rows gets them as the last tokens of every row, so
that the output depends on them.  ``zipf_weights`` and ``mmpp_times`` are
frozen copies of ``repro_torch.serving.loadgen``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Arrival:
    t: Optional[float]     # offset from the window's start (open loop)
    fn: int                # index into the workload's functions
    seq: int               # tokens per row
    tok_seed: int


def _rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tag]))


# -- frozen copies of repro_torch.serving.loadgen ------------------------------

def zipf_weights(n_functions: int, alpha: float) -> np.ndarray:
    """Normalized Zipf popularity over function ranks (rank 0 hottest)."""
    w = np.arange(1, n_functions + 1, dtype=np.float64) ** -float(alpha)
    return w / w.sum()


def mmpp_times(rps: float, duration_s: float, seed: int, *, burst_factor: float = 8.0,
               burst_fraction: float = 0.1, mean_dwell_s: float = 0.5) -> np.ndarray:
    """Bursty 2-state MMPP whose time-averaged rate is ``rps``."""
    if not 0 < burst_fraction < 1:
        raise ValueError("burst_fraction must be in (0, 1)")
    lam_quiet = rps / (1.0 - burst_fraction + burst_fraction * burst_factor)
    lam_burst = lam_quiet * burst_factor
    dwell_burst = mean_dwell_s
    dwell_quiet = dwell_burst * (1.0 - burst_fraction) / burst_fraction
    rng = _rng(seed, 1)
    times: List[float] = []
    t, in_burst = 0.0, False
    while t < duration_s:
        end = min(t + rng.exponential(dwell_burst if in_burst else dwell_quiet), duration_s)
        lam = lam_burst if in_burst else lam_quiet
        tt = t + rng.exponential(1.0 / lam)
        while tt < end:
            times.append(tt)
            tt += rng.exponential(1.0 / lam)
        t, in_burst = end, not in_burst
    return np.asarray(times, dtype=np.float64)


# -- the generator ----------------------------------------------------------------

def poisson_times(rps: float, duration_s: float, seed: int) -> np.ndarray:
    """``round(rps * duration_s)`` arrivals whose gaps are the exponential's
    quantiles at (i + 0.5) / n in a seeded order, scaled so the last one
    comes a mean gap before the end: the same gaps for every seed."""
    n = int(round(rps * duration_s))
    if n < 1:
        raise ValueError(f"a rate of {rps}/s offers no request in {duration_s} s")
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rps
    gaps = gaps[_rng(seed, 1).permutation(n)]
    times = np.cumsum(gaps) - gaps[0]
    return times * (duration_s * (n - 1) / n) / max(times[-1], 1e-12)


def shares(weights: Sequence[float], n: int) -> np.ndarray:
    """How many of ``n`` items each weight gets (largest remainder)."""
    w = np.asarray(weights, dtype=np.float64)
    exact = w / w.sum() * n
    out = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - out), kind="stable")[: n - int(out.sum())]
    out[rest] += 1
    return out


def popularity(wl: Dict[str, Any]) -> np.ndarray:
    pop = wl["popularity"]
    n = len(wl["functions"])
    if pop["kind"] == "zipf":
        return zipf_weights(n, pop["alpha"])
    if pop["kind"] == "uniform":
        return np.full(n, 1.0 / n)
    raise ValueError(f"unknown popularity {pop['kind']!r}")


def _mix(wl: Dict[str, Any], n: int, seed: int, tag: int) -> List[Arrival]:
    """``n`` requests: function and length shares fixed, their orders drawn
    from the trace seed, each request's token seed from the run's."""
    fns = np.repeat(np.arange(len(wl["functions"])), shares(popularity(wl), n))
    lens = np.repeat(np.asarray(wl["seq_lens"]),
                     shares(np.ones(len(wl["seq_lens"])), n))
    rng = _rng(wl["trace_seed"], 2, tag)
    fns, lens = fns[rng.permutation(n)], lens[rng.permutation(n)]
    tok = _rng(seed, 3, tag).integers(0, 2**62, size=n)
    return [Arrival(None, int(f), int(s), int(k)) for f, s, k in zip(fns, lens, tok)]


def open_schedule(wl: Dict[str, Any], seconds: float, seed: int) -> List[Arrival]:
    arr = wl["arrivals"]
    kind, ts = arr["kind"], wl["trace_seed"]
    if kind == "poisson":
        times = poisson_times(arr["rate_per_s"], seconds, ts)
    elif kind == "mmpp":
        times = mmpp_times(arr["rate_per_s"], seconds, ts,
                           **{k: arr[k] for k in ("burst_factor", "burst_fraction",
                                                  "mean_dwell_s") if k in arr})
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    mix = _mix(wl, len(times), seed, 0)
    return [Arrival(float(t), a.fn, a.seq, a.tok_seed) for t, a in zip(times, mix)]


def closed_stream(wl: Dict[str, Any], seed: int) -> Iterator[Arrival]:
    """Rounds holding every function and every length in equal shares, each
    round in its own order: the clients take the next request from this
    one stream."""
    per_round = len(wl["functions"]) * len(wl["seq_lens"])
    r = 0
    while True:
        yield from _mix(wl, per_round, seed, 1 + r)
        r += 1


def tokens(vocab: int, batch: int, seq: int, tok_seed: int,
           rows: Sequence[int] = ()) -> np.ndarray:
    """(batch, seq) int32 token ids; ``rows`` (a function's changed
    embedding rows) end every row, each row in its own order."""
    rng = np.random.default_rng(tok_seed)
    t = rng.integers(0, vocab, size=(batch, seq), dtype=np.int64)
    if len(rows):
        k = min(len(rows), seq)
        for b in range(batch):
            t[b, seq - k:] = rng.permutation(np.asarray(rows))[:k]
    return t.astype(np.int32)
