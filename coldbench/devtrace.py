"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` records the card's operations (kernels, copies, sets)
while the window runs.  A ``record_function`` marker at the window's start
ties the trace's clock to the host's ``perf_counter``, so that the idle
gaps can be named by what the host was doing then: the benchmark records
each invocation's host interval and its boot and exec shares.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "coldbench.window"


@dataclass
class HostSpan:
    """One invocation on the host (perf_counter seconds)."""

    start: float
    end: float
    cold: bool
    boot_s: float


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]          # (full name, seconds) per device op
    device_ops: List[List]                    # [[short name, seconds]] top 10
    idle_gaps: List[List]                     # [[what the host did, seconds]] top 10


def short_name(name: str) -> str:
    """A kernel's identifier without return type, namespace, template or
    parameter list."""
    n = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
            continue
        if ch in ">)":
            depth = max(0, depth - 1)
            continue
        if depth == 0:
            out.append(ch)
    s = "".join(out).strip() or name[:64]
    return s.split("::")[-1][:64]


def busy_and_gaps(ivals: Sequence[Tuple[int, int]], lo: int,
                  hi: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The length of the union of ``ivals`` (each inside [lo, hi]) and the
    gaps in [lo, hi] that no interval covers."""
    busy, gaps, cur_a, cur_b = 0, [], None, lo
    for a, b in sorted(ivals):
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    gaps.append((cur_b, hi))
    return busy, [g for g in gaps if g[1] > g[0]]


class DeviceTrace:
    def __init__(self, use_cuda: bool):
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if use_cuda else [])
        self.use_cuda = use_cuda
        self.prof = profile(activities=acts)
        self.spans: List[HostSpan] = []
        self.t0 = self.t1 = 0.0

    def start(self) -> float:
        self.prof.start()
        with record_function(MARK):
            self.t0 = time.perf_counter()
        return self.t0

    def stop(self) -> None:
        if self.use_cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> Summary:
        events = self.prof.profiler.kineto_results.events()
        mark_ns: Optional[int] = None
        dev: List[Tuple[int, int, str]] = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.duration_ns(), e.name()))
            elif mark_ns is None and e.name() == MARK:
                mark_ns = e.start_ns()
        if mark_ns is None:
            raise RuntimeError("the trace holds no window marker")
        lo, hi = mark_ns, mark_ns + int((self.t1 - self.t0) * 1e9)
        kernels, ivals, by_name = [], [], {}
        for s, d, name in dev:
            a, b = max(s, lo), min(s + d, hi)
            if b <= a:
                continue
            kernels.append((name, d * 1e-9))
            ivals.append((a, b))
            k = short_name(name)
            by_name[k] = by_name.get(k, 0.0) + d * 1e-9
        busy, gaps = busy_and_gaps(ivals, lo, hi)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        to_host = lambda ns: self.t0 + (ns - lo) * 1e-9  # noqa: E731
        idle = [[f"{self.host_state(to_host((a + b) / 2))} at {(a - lo) * 1e-9:.3f} s",
                 (b - a) * 1e-9] for a, b in gaps]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return Summary(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                       device_ops=[[k, v] for k, v in top], idle_gaps=idle)

    def host_state(self, t: float) -> str:
        live = [s for s in self.spans if s.start <= t < s.end]
        if any(s.cold and t < s.start + s.boot_s for s in live):
            return "cold start restoring on the host"
        if live:
            return "invocation on the host (params, launches, sync)"
        return "no invocation running"


def wrap_invoke(worker, spans: List[HostSpan]) -> None:
    """Record every invocation of ``worker`` as a host span (and a
    ``record_function`` range in the trace)."""
    inner = worker.invoke

    def invoke(request):
        t = time.perf_counter()
        with record_function("coldbench.invoke"):
            res = inner(request)
        spans.append(HostSpan(t, time.perf_counter(), res.cold, res.boot_s))
        return res

    worker.invoke = invoke


def count(kernels: Sequence[Tuple[str, float]], pattern: str) -> Tuple[int, float]:
    """(calls, device seconds) of the device ops whose name matches."""
    rx = re.compile(pattern)
    hits = [d for n, d in kernels if rx.search(n)]
    return len(hits), float(sum(hits))
