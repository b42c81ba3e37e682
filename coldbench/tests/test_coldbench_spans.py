"""The port's spans beside the device trace: the window marker maps a span
onto the trace's clock, the four readers of ``hostspans`` on made-up
windows (the sum rule and where it is an equality), the lanes' innermost
spans, and a traced run on the CPU through ``tools/spans.py``."""

import importlib.util
import json
import os
import time
from types import SimpleNamespace

import pytest
from torch.profiler import record_function

from conftest import BENCH, DATA

import harness
import hostspans
from repro_torch import obs
from repro_torch.obs import Span

MS = 1_000_000


def _tool():
    path = os.path.join(BENCH, "tools", "spans.py")
    spec = importlib.util.spec_from_file_location("coldbench_tool_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_window_marker_maps_a_span_onto_the_trace_within_200_us():
    """Under a CPU profiler window of over 2 s, a ``record_function``
    entered first thing inside a span lands, through the marker, within
    200 us of the span's start, at the window's start and at its end.  An
    event recorded just before each probe, outside its span (as
    ``SpanTrace.start`` records one before its marker), keeps the
    profiler's slow first stamp after a pause out of the probe."""
    tr = hostspans.SpanTrace(False)
    names = ("probe.first", "probe.last")
    tr.start()
    try:
        for name, pause in zip(names, (2.1, 0.0)):
            with record_function("probe.settle"):
                pass
            with obs.span(name):
                with record_function(name):
                    pass
            time.sleep(pause)
    finally:
        tr.stop()
    tr.summary()
    assert tr.t1 - tr.t0 >= 2.0
    spans = {s.name: s for s in tr.recorded["spans"]}
    mark, _ = tr.anchor()
    seen = {e.name(): tr.to_host_ns(e.start_ns(), mark)
            for e in tr.prof.profiler.kineto_results.events() if e.name() in names}
    assert set(seen) == set(names)
    for name, host_ns in seen.items():
        assert abs(host_ns - spans[name].start_ns) <= 200_000, (
            name, host_ns - spans[name].start_ns)


# -- made-up windows ---------------------------------------------------------

class _Ids:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n


def _invocation(ids, rid, thread, t, *, cold=False, fwd=(2, 5), sync=(5, 9), out=(9, 10),
                end=11):
    """One ``worker.invoke`` starting at ``t`` ms with its children (offsets
    in ms)."""
    root = Span(ids(), None, rid, thread, "worker.invoke", t * MS, (t + end) * MS,
                {"function": "f", "cold": cold})
    kids = [Span(ids(), root.id, rid, thread, name, (t + a) * MS, (t + b) * MS, {})
            for name, (a, b) in (("worker.lookup", (0, 1)), ("worker.forward", fwd),
                                 ("worker.sync", sync), ("worker.output", out))]
    return [root] + kids


def _ctx(spans, gaps, window_ms=100, busy_ms=None):
    idle = sum(b - a for a, b in gaps)
    busy_s = (window_ms * MS - idle) * 1e-9 if busy_ms is None else busy_ms * 1e-3
    trace = SimpleNamespace(busy_s=busy_s, window_s=window_ms * 1e-3, gaps=gaps)
    return SimpleNamespace(spans={"spans": spans, "counters": {}}, trace=trace,
                           t0=0.0, t_end=window_ms * 1e-3)


def test_the_span_readers_take_warm_invocations_in_the_window():
    ids = _Ids()
    spans = (_invocation(ids, 1, 1, 0) + _invocation(ids, 2, 2, 20, fwd=(2, 8))
             + _invocation(ids, 3, 1, 40, cold=True, fwd=(2, 30))
             + _invocation(ids, 4, 2, 150, fwd=(2, 40)))  # after the window
    ctx = _ctx(spans, [])
    assert hostspans.warm_requests(ctx) == {1, 2}
    assert hostspans.fwd_launch_ms_p50(ctx) == pytest.approx(3.0)   # 3 and 6: nearest rank
    assert hostspans.device_wait_ms_p50(ctx) == pytest.approx(5.0)  # 4 + 1 each


def test_the_idle_split_and_its_sum_rule():
    """Lane 1 is in its forward 2-5 ms and elsewhere in the worker 0-2 and
    5-11; lane 2 is in its forward 32-35.  Idle: 1-3 (1 ms in the worker, 1
    in a forward), 10-20 (1 in the worker, 9 outside), 33-34 (in a
    forward)."""
    ids = _Ids()
    spans = _invocation(ids, 1, 1, 0) + _invocation(ids, 2, 2, 30)
    gaps = [(1 * MS, 3 * MS), (10 * MS, 20 * MS), (33 * MS, 34 * MS)]
    ctx = _ctx(spans, gaps)
    launch, worker = hostspans.idle_split(ctx)
    assert launch == pytest.approx(2.0)   # 2 ms of 100
    assert worker == pytest.approx(2.0)
    idle = 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
    assert idle == pytest.approx(13.0)
    assert launch + worker <= idle + 1e-9
    assert hostspans.idle_launch_pct(ctx) == launch
    assert hostspans.idle_worker_pct(ctx) == worker


def test_the_sum_rule_is_an_equality_when_the_worker_covers_every_gap():
    ids = _Ids()
    spans = _invocation(ids, 1, 1, 0) + _invocation(ids, 2, 2, 5)
    # lanes inside the worker over 0-16 ms; gaps only there, some in forwards
    gaps = [(1 * MS, 3 * MS), (6 * MS, 8 * MS), (12 * MS, 15 * MS)]
    ctx = _ctx(spans, gaps, window_ms=16)
    launch, worker = hostspans.idle_split(ctx)
    idle = 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
    assert launch + worker == pytest.approx(idle)
    # all idle time inside forwards: it is all launch time
    ctx = _ctx(spans, [(3 * MS, 4 * MS), (8 * MS, 9 * MS)], window_ms=16)
    launch, worker = hostspans.idle_split(ctx)
    assert worker == 0 and launch == pytest.approx(100.0 * 2 / 16)
    # no lane in the worker during the gaps: neither
    ctx = _ctx(spans, [(40 * MS, 50 * MS)], window_ms=60)
    assert hostspans.idle_split(ctx) == (0.0, 0.0)


def test_the_readers_read_nothing_without_spans_or_a_device_trace():
    ids = _Ids()
    spans = _invocation(ids, 1, 1, 0)
    no_spans = SimpleNamespace(spans=None, trace=_ctx(spans, []).trace, t0=0.0, t_end=0.1)
    no_device = _ctx(spans, [(0, 100 * MS)], busy_ms=0)
    no_trace = SimpleNamespace(spans={"spans": spans, "counters": {}}, trace=None,
                               t0=0.0, t_end=0.1)
    parent = SimpleNamespace(trace=None, t0=0.0, t_end=0.1)  # a Ctx without spans
    for ctx in (no_spans, parent):
        assert all(read(ctx) is None for read in hostspans.READERS.values())
    for ctx in (no_device, no_trace):
        assert hostspans.idle_launch_pct(ctx) is None
        assert hostspans.idle_worker_pct(ctx) is None
        assert hostspans.fwd_launch_ms_p50(ctx) == pytest.approx(3.0)


def test_interval_arithmetic():
    u = hostspans.union([(5, 8), (1, 3), (2, 4), (8, 9), (10, 10)])
    assert u == [(1, 4), (5, 9)]
    assert hostspans.intersect(u, [(0, 2), (3, 6), (7, 20)]) == [(1, 2), (3, 4), (5, 6), (7, 9)]
    assert hostspans.length(u) == 7


def test_lane_states_name_the_innermost_span():
    ids = _Ids()
    spans = _invocation(ids, 1, 7, 0) + _invocation(ids, 2, 9, 20)
    st = hostspans.LaneStates(sorted(spans, key=lambda s: s.start_ns))
    assert st.threads == [7, 9]
    assert st.at(-1) == ["-", "-"]
    assert st.at(int(0.5 * MS)) == ["worker.lookup", "-"]
    assert st.at(int(1.5 * MS)) == ["worker.invoke", "-"]
    assert st.at(3 * MS) == ["worker.forward", "-"]
    assert st.at(int(10.5 * MS)) == ["worker.invoke", "-"]
    assert st.at(23 * MS) == ["-", "worker.forward"]
    gaps = [(1 * MS, 2 * MS), (12 * MS, 18 * MS)]
    named = hostspans.named_gaps(st, gaps, 0)
    assert [g["lanes"] for g in named] == [["-", "-"], ["worker.invoke", "-"]]
    by = dict(hostspans.idle_by_state(st, gaps, 0.1))
    assert by == {"- | -": pytest.approx(6.0), "- | worker.invoke": pytest.approx(1.0)}


def test_gap_classes_by_length():
    gaps = [(0, 50_000), (0, 100_000), (0, 2 * MS), (0, 10 * MS)]
    c = hostspans.gap_classes(gaps, 1.0)
    assert [c[k]["count"] for k in ("<0.1ms", "0.1-1ms", "1-10ms", ">=10ms")] == [1, 1, 1, 1]
    assert c[">=10ms"]["ms"] == pytest.approx(10.0)
    assert c["1-10ms"]["pct"] == pytest.approx(0.2)


def test_span_table_counts_self_time():
    ids = _Ids()
    t = hostspans.span_table(_invocation(ids, 1, 1, 0))
    assert t["worker.invoke"]["count"] == 1
    assert t["worker.invoke"]["p50_ms"] == pytest.approx(11.0)
    assert t["worker.invoke"]["self_total_ms"] == pytest.approx(11.0 - 1 - 3 - 4 - 1)


# -- a traced run on the CPU ---------------------------------------------------

def test_a_traced_cpu_run_drains_spans_and_reads_no_idle_split():
    tool = _tool()
    out, w = tool.traced_window("tiny-ssm.warm", 5, 2.0, device="cpu", base=DATA)
    assert out["correct"], out["checks"]
    spans = w.spans["spans"]
    invokes = [s for s in spans if s.name == "worker.invoke"]
    assert invokes and all(s.attrs["cold"] is False for s in invokes)
    assert len(hostspans.lanes(spans)) > 1
    assert {"worker.forward", "worker.sync", "worker.output", "model.layer"} <= {
        s.name for s in spans}
    assert w.spans["counters"]["worker.h2d_bytes"] == 0
    assert hostspans.idle_launch_pct(w) is None and hostspans.idle_worker_pct(w) is None
    assert hostspans.fwd_launch_ms_p50(w) > 0 and hostspans.device_wait_ms_p50(w) >= 0
    lines = dict(tool.report(out, w))
    json.dumps(lines)  # what the tool prints
    assert set(lines) == {"result", "split", "spans", "counters", "gap_classes",
                          "idle_by_state", "longest_gaps"}
    assert lines["result"]["invocations"] == len(invokes)
    assert "idle_rest_pct" not in lines["split"]
    # the recorder is off again, and the benchmark's own trace is back
    assert obs.span("x") is obs.span("y")
    import devtrace
    assert devtrace.DeviceTrace is not hostspans.SpanTrace


def test_an_untraced_cpu_run_with_one_lane_at_a_time_in_the_forward():
    """``--profiler 0``: the recorder on over an untraced window; with
    ``--lanes`` and ``--serial-forward``, no two forwards overlap."""
    tool = _tool()
    with tool.lanes_base("tiny-ssm.warm", 3, DATA) as base, tool.serial_forward():
        out, rec = tool.recorded_window("tiny-ssm.warm", 5, 2.0, device="cpu", base=base)
    assert out["correct"], out["checks"]
    assert out["per_layer"] == {}
    spans = rec["spans"]
    assert len(hostspans.lanes(spans)) > 1
    inner = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "model.embed")
    heads = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "model.head")
    assert inner and len(inner) == len(heads)
    # each forward's enqueue, from its embedding to its head, runs alone
    calls = [(a, b) for (a, _), (_, b) in zip(inner, heads)]
    assert all(b <= c for (_, b), (c, _) in zip(calls, calls[1:]))
    lines = dict(tool.report_untraced(out, rec))
    json.dumps(lines)
    assert set(lines) == {"result", "spans", "counters"}
    assert lines["result"]["invocations"] == sum(s.name == "worker.invoke" for s in spans)
    assert lines["spans"]["model.layer"]["count"] > 0
    assert obs.span("x") is obs.span("y")
    from repro_torch.serving.worker import Worker
    assert Worker.register_runtime.__name__ == "register_runtime"


@pytest.mark.parametrize("spans", [True, False])
def test_a_reader_that_sets_spans_turns_the_recorder_on(tmp_path, spans):
    """A traced run hands a reader that sets ``SPANS`` the recorder's spans;
    without one, ``ctx.spans`` is None and the recorder is off all through
    the window."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "got.py").write_text(
        ("SPANS = True\n" if spans else "")
        + "def read(ctx):\n"
        "    return -1.0 if ctx.spans is None else float(len(ctx.spans['spans']))\n")
    recording = []

    def watch(cluster, cfg):
        w = cluster.workers[0]
        inner = w.invoke

        def invoke(req):
            recording.append(obs.span("x") is not obs.span("y"))
            return inner(req)
        w.invoke = invoke

    out = harness.run_cell("tiny-ssm.warm", 6, 1.0, True, device="cpu", base=DATA,
                           metrics_base=str(tmp_path), per_layer=["got"], tamper=watch)
    assert out["correct"], out["checks"]
    assert recording and all(r == spans for r in recording)
    if spans:
        assert out["per_layer"]["got"] > 0
    else:
        assert out["per_layer"]["got"] == -1.0
    assert obs.span("x") is obs.span("y")
