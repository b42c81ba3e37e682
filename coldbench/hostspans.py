"""The port's host spans beside the device trace of a window.

``SpanTrace`` is ``devtrace.DeviceTrace`` with the port's recorder
(``repro_torch.obs``) on for the window: it enables the recorder just
before the profiler starts and drains it once the profiler has stopped,
and its summary adds every idle gap of the window (not only the ten
longest) on the host's ``perf_counter_ns`` clock, through the same
``coldbench.window`` marker that ``DeviceTrace`` anchors the trace with.
The spans are on that clock already, so the two can be laid over each
other.

The readers below take a context with ``spans`` (what ``obs.drain()``
returned, or None), ``trace`` (a ``SpanSummary``, or None), ``t0`` and
``t_end`` (the window on the ``perf_counter`` clock), and return None
where there is nothing to read:

* ``fwd_launch_ms_p50``: the median ``worker.forward`` of the warm
  invocations that started in the window, the host's enqueue time of one
  forward;
* ``device_wait_ms_p50``: the median, per warm invocation, of
  ``worker.sync`` + ``worker.output``, how long a lane is blocked on the
  card;
* ``idle_launch_pct``: the share of the window in which the card ran
  nothing while at least one lane was inside ``worker.forward``;
* ``idle_worker_pct``: the share in which the card ran nothing, no lane was
  inside ``worker.forward`` and at least one was elsewhere inside
  ``worker.invoke``.

The two idle shares are disjoint parts of the idle gaps, so their sum is
at most ``idle_pct``; what is left is idle time with no request inside the
worker (admission, the cluster, the callers).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

import devtrace
from harness import pct

Ival = Tuple[int, int]

#: idle gaps by length, in ns: (label, lower end)
GAP_CLASSES = (("<0.1ms", 0), ("0.1-1ms", 100_000), ("1-10ms", 1_000_000), (">=10ms", 10_000_000))


@dataclass
class SpanSummary(devtrace.Summary):
    gaps: List[Ival] = field(default_factory=list)   # every idle gap, perf_counter_ns


class SpanTrace(devtrace.DeviceTrace):
    """A device trace with the port's recorder on for its window."""

    #: the most recent trace started (what a tool reads after ``run_cell``)
    last: Optional["SpanTrace"] = None

    def __init__(self, use_cuda: bool):
        super().__init__(use_cuda)
        self.recorded: Optional[Dict[str, Any]] = None
        self.result: Optional[SpanSummary] = None

    def start(self) -> float:
        """``DeviceTrace.start`` with one event recorded before the marker:
        the profiler is slow to record a thread's first event, and the
        marker's start would then lead ``t0`` by a millisecond or more."""
        from repro_torch import obs

        SpanTrace.last = self
        obs.enable()
        self.prof.start()
        with record_function("coldbench.settle"):
            pass
        with record_function(devtrace.MARK):
            self.t0 = time.perf_counter()
        return self.t0

    def stop(self) -> None:
        from repro_torch import obs

        super().stop()
        self.recorded = obs.drain()
        obs.disable()

    def anchor(self) -> Tuple[int, List[Ival]]:
        """The window marker's start on the trace's clock, and every device
        operation's (start, end) there."""
        mark, dev = None, []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif mark is None and e.name() == devtrace.MARK:
                mark = e.start_ns()
        if mark is None:
            raise RuntimeError("the trace holds no window marker")
        return mark, dev

    def to_host_ns(self, trace_ns: int, mark: int) -> int:
        """A time of the trace on the ``perf_counter_ns`` clock."""
        return round(self.t0 * 1e9) + (trace_ns - mark)

    def summary(self) -> SpanSummary:
        base = super().summary()
        mark, dev = self.anchor()
        lo, hi = mark, mark + int((self.t1 - self.t0) * 1e9)
        ivals = [(max(a, lo), min(b, hi)) for a, b in dev if min(b, hi) > max(a, lo)]
        _, gaps = devtrace.busy_and_gaps(ivals, lo, hi)
        self.result = SpanSummary(**vars(base), gaps=[
            (self.to_host_ns(a, mark), self.to_host_ns(b, mark)) for a, b in gaps])
        return self.result


# -- interval arithmetic ------------------------------------------------------

def union(ivals: Sequence[Ival]) -> List[Ival]:
    """Sorted disjoint intervals covering exactly what ``ivals`` cover."""
    out: List[List[int]] = []
    for a, b in sorted(ivals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(x: Sequence[Ival], y: Sequence[Ival]) -> List[Ival]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(ivals: Sequence[Ival]) -> int:
    return sum(b - a for a, b in ivals)


# -- the readers ----------------------------------------------------------------

def _spans(ctx) -> Optional[list]:
    got = getattr(ctx, "spans", None)
    return None if got is None else got["spans"]


def warm_requests(ctx) -> set:
    """Request ids of the warm invocations that started in the window."""
    lo, hi = ctx.t0 * 1e9, ctx.t_end * 1e9
    return {s.request for s in _spans(ctx) or ()
            if s.name == "worker.invoke" and not s.attrs.get("cold", True)
            and lo <= s.start_ns < hi}


def fwd_launch_ms_p50(ctx) -> Optional[float]:
    if _spans(ctx) is None:
        return None
    warm = warm_requests(ctx)
    d = [s.end_ns - s.start_ns for s in _spans(ctx)
         if s.name == "worker.forward" and s.request in warm]
    return pct(d, 50) * 1e-6 if d else None


def device_wait_ms_p50(ctx) -> Optional[float]:
    if _spans(ctx) is None:
        return None
    warm = warm_requests(ctx)
    per: Dict[int, int] = {}
    for s in _spans(ctx):
        if s.name in ("worker.sync", "worker.output") and s.request in warm:
            per[s.request] = per.get(s.request, 0) + s.end_ns - s.start_ns
    return pct(list(per.values()), 50) * 1e-6 if per else None


def _covered(spans, name: str) -> List[Ival]:
    return union([(s.start_ns, s.end_ns) for s in spans if s.name == name])


def idle_split(ctx) -> Optional[Tuple[float, float]]:
    """(``idle_launch_pct``, ``idle_worker_pct``), or None without a CUDA
    trace or spans."""
    tr, spans = getattr(ctx, "trace", None), _spans(ctx)
    gaps = getattr(tr, "gaps", None)
    if tr is None or tr.busy_s <= 0 or gaps is None or spans is None:
        return None
    g, fwd = union(gaps), _covered(spans, "worker.forward")
    in_invoke = intersect(g, _covered(spans, "worker.invoke"))
    launch = length(intersect(g, fwd))
    worker = length(in_invoke) - length(intersect(in_invoke, fwd))
    window_ns = tr.window_s * 1e9
    return 100.0 * launch / window_ns, 100.0 * worker / window_ns


def idle_launch_pct(ctx) -> Optional[float]:
    split = idle_split(ctx)
    return None if split is None else split[0]


def idle_worker_pct(ctx) -> Optional[float]:
    split = idle_split(ctx)
    return None if split is None else split[1]


READERS = {"fwd_launch_ms.p50": fwd_launch_ms_p50, "device_wait_ms.p50": device_wait_ms_p50,
           "idle_launch_pct": idle_launch_pct, "idle_worker_pct": idle_worker_pct}


# -- what the tool prints --------------------------------------------------------

def span_table(spans) -> Dict[str, Dict[str, float]]:
    """Per span name: count, p50 and p95 of the duration, the median and the
    sum of its self time (duration less its children's), in ms."""
    kids: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + s.end_ns - s.start_ns
    by: Dict[str, List[Tuple[int, int]]] = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        by.setdefault(s.name, []).append((d, d - kids.get(s.id, 0)))
    return {name: {"count": len(v), "p50_ms": pct([d for d, _ in v], 50) * 1e-6,
                   "p95_ms": pct([d for d, _ in v], 95) * 1e-6,
                   "self_p50_ms": pct([x for _, x in v], 50) * 1e-6,
                   "self_total_ms": sum(x for _, x in v) * 1e-6}
            for name, v in sorted(by.items())}


def gap_classes(gaps: Sequence[Ival], window_s: float) -> Dict[str, Dict[str, float]]:
    """Idle gaps by length: how many, their sum in ms and % of the window."""
    out = {label: {"count": 0, "ms": 0.0, "pct": 0.0} for label, _ in GAP_CLASSES}
    for a, b in gaps:
        label = [lab for lab, low in GAP_CLASSES if b - a >= low][-1]
        out[label]["count"] += 1
        out[label]["ms"] += (b - a) * 1e-6
    for v in out.values():
        v["pct"] = v["ms"] * 1e-3 / window_s * 100.0
    return out


def lanes(spans) -> List[int]:
    """The threads that ran ``worker.invoke``, in the order they first did."""
    seen: List[int] = []
    for s in spans:
        if s.name == "worker.invoke" and s.thread not in seen:
            seen.append(s.thread)
    return seen


class LaneStates:
    """Each lane's innermost open span at any time (``-``: outside every
    span).  One thread's spans nest, so a sweep over them cuts its time
    into pieces of one innermost span each."""

    def __init__(self, spans):
        self.threads = lanes(spans)
        self._pieces = {th: self._cut([s for s in spans if s.thread == th])
                        for th in self.threads}

    @staticmethod
    def _cut(spans) -> Tuple[List[int], List[str]]:
        ts: List[int] = []
        names: List[str] = []

        def piece(t: int, name: str) -> None:
            if ts and ts[-1] == t:
                names[-1] = name
            else:
                ts.append(t)
                names.append(name)

        stack: list = []
        for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
            while stack and stack[-1].end_ns <= s.start_ns:
                top = stack.pop()
                piece(top.end_ns, stack[-1].name if stack else "-")
            stack.append(s)
            piece(s.start_ns, s.name)
        while stack:
            top = stack.pop()
            piece(top.end_ns, stack[-1].name if stack else "-")
        return ts, names

    def at(self, t: int) -> List[str]:
        out = []
        for th in self.threads:
            ts, names = self._pieces[th]
            i = bisect.bisect_right(ts, t) - 1
            out.append(names[i] if i >= 0 else "-")
        return out


def named_gaps(states: LaneStates, gaps: Sequence[Ival], t0_ns: int,
               n: int = 10) -> List[Dict[str, Any]]:
    """The ``n`` longest gaps, each with every lane's innermost span at its
    middle."""
    return [{"at_s": (a - t0_ns) * 1e-9, "ms": (b - a) * 1e-6, "lanes": states.at((a + b) // 2)}
            for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]]


def idle_by_state(states: LaneStates, gaps: Sequence[Ival], window_s: float,
                  n: int = 8) -> List[Tuple[str, float]]:
    """Idle time (% of the window) by what the lanes were in at each gap's
    middle (innermost spans, sorted; ``-`` for a lane outside the worker):
    the ``n`` largest states."""
    per: Dict[str, int] = {}
    for a, b in gaps:
        key = " | ".join(sorted(states.at((a + b) // 2)))
        per[key] = per.get(key, 0) + b - a
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
    return [(k, v * 1e-9 / window_s * 100.0) for k, v in top]
