"""Run one traced window of a cell with the port's recorder on, and print
where the host was while the card idled.

    python3 coldbench/tools/spans.py CELL SEED SECONDS [--out FILE] [--device cpu]
        [--lanes N] [--profiler 0] [--serial-forward]

The window is ``harness.run_cell``'s traced run, with ``hostspans.SpanTrace``
in place of the device trace: the recorder (``repro_torch.obs``) is on from
just before the profiler starts until it stops.  Printed, one JSON object a
line:

* ``result``: the run's end-to-end metrics, the cell's per-layer metrics
  with the recorder on, ``correct``, busy and window seconds;
* ``split``: ``fwd_launch_ms.p50``, ``device_wait_ms.p50``,
  ``idle_launch_pct``, ``idle_worker_pct`` and the rest of ``idle_pct``;
* ``spans``: per span, count, p50, p95 and self time;
* ``counters``: each counter's difference over the window, and per
  invocation;
* ``gap_classes``: idle time by gap length;
* ``idle_by_state``: idle time by the lanes' innermost spans at each gap's
  middle;
* ``longest_gaps``: the ten longest gaps, named by every lane's innermost
  span at their middle.

``--out`` writes every span, and every gap of 0.1 ms or more, as JSON as
well.  ``--lanes N`` runs the cell with N callers and N lanes.
``--profiler 0`` runs the window untraced, with the recorder on over the
closed loop and no profiler: the spans without the profiler's own cost on
the host; it prints ``result``, ``spans`` and ``counters``.
``--serial-forward`` lets one lane at a time call the family's forward
(a lock around it, inside ``worker.forward``), which shows whether the
enqueue of ``model.layer`` slows because lanes enqueue at once.  This
tool is the reader of the counters and of the spans that no metric
reads.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [os.path.join(ROOT, "src"), BENCH]

import devtrace  # noqa: E402
import harness  # noqa: E402
import hostspans  # noqa: E402
import spec  # noqa: E402


class Window:
    """What the readers of ``hostspans`` read, from one ``SpanTrace``."""

    def __init__(self, tr: hostspans.SpanTrace, seconds: float):
        self.spans, self.trace = tr.recorded, tr.result
        self.t0, self.t_end = tr.t0, tr.t0 + seconds


def traced_window(cell: str, seed: int, seconds: float, device: str = "cuda",
                  base: str = spec.HERE):
    """``run_cell``'s traced run with the recorder on, reading the cell's
    per-layer metrics; returns its result and the ``Window``."""
    man = spec.manifest(ROOT)
    layer = [m["name"] for m in spec.metrics_for(man, cell, "per_layer")]
    devtrace.DeviceTrace, plain = hostspans.SpanTrace, devtrace.DeviceTrace
    try:
        out = harness.run_cell(cell, seed, seconds, True, device=device, per_layer=layer,
                               base=base, metrics_base=spec.HERE)
    finally:
        devtrace.DeviceTrace = plain
    return out, Window(hostspans.SpanTrace.last, seconds)


def recorded_window(cell: str, seed: int, seconds: float, device: str = "cuda",
                    base: str = spec.HERE):
    """``run_cell``'s untraced run with the recorder on over the closed
    loop; returns its result and what the recorder drained."""
    from repro_torch import obs

    plain, got = harness._closed_loop, {}

    def loop(*args):
        obs.enable()
        try:
            return plain(*args)
        finally:
            got.update(obs.drain())
            obs.disable()

    harness._closed_loop = loop
    try:
        out = harness.run_cell(cell, seed, seconds, False, device=device, base=base,
                               metrics_base=spec.HERE)
    finally:
        harness._closed_loop = plain
    return out, got


@contextlib.contextmanager
def lanes_base(cell: str, lanes: int, src: str = spec.HERE):
    """A copy of the cell's configurations and workload (from ``src``) with
    ``lanes`` callers and lanes."""
    base = tempfile.mkdtemp(prefix="coldbench-lanes-")
    try:
        shutil.copytree(os.path.join(src, "configs"), os.path.join(base, "configs"))
        os.makedirs(os.path.join(base, "workloads"))
        wl = spec.load_workload(cell, src)
        wl.update(clients=lanes, worker_concurrency=lanes)
        with open(os.path.join(base, "workloads", f"{cell}.json"), "w") as f:
            json.dump(wl, f)
        yield base
    finally:
        shutil.rmtree(base, ignore_errors=True)


@contextlib.contextmanager
def serial_forward():
    """One lane at a time inside the family's forward: each worker's
    forward is wrapped in one lock as it is registered."""
    from repro_torch.serving.worker import Worker

    plain, lock = Worker.register_runtime, threading.Lock()

    def register(self, family, model, base_params, fwd=None):
        plain(self, family, model, base_params, fwd=fwd)
        inner = self._fwd[family]

        def one_at_a_time(params, tokens):
            with lock:
                return inner(params, tokens)

        self._fwd[family] = one_at_a_time

    Worker.register_runtime = register
    try:
        yield
    finally:
        Worker.register_runtime = plain


def result_line(out, spans, **more):
    """The run's end-to-end metrics, per-layer metrics and check."""
    return {"e2e": {k: v[0] for k, v in out["e2e"].items()},
            "per_layer": out["per_layer"], "correct": out["correct"],
            "attempted": out["attempted"], "failed": out["failed"],
            "invocations": sum(1 for s in spans if s.name == "worker.invoke"),
            "lanes": len(hostspans.lanes(spans)), **more}


def counter_line(counters, spans):
    n_inv = sum(1 for s in spans if s.name == "worker.invoke")
    return {k: {"total": v, "per_invocation": v / n_inv if n_inv else None}
            for k, v in sorted(counters.items())}


def report_untraced(out, rec):
    """The lines of an untraced window, as (key, object) pairs."""
    spans = rec["spans"]
    yield "result", result_line(out, spans)
    yield "spans", hostspans.span_table(spans)
    yield "counters", counter_line(rec["counters"], spans)


def report(out, w: Window):
    """The lines the tool prints, as (key, object) pairs."""
    spans, tr = w.spans["spans"], w.trace
    t0_ns = round(w.t0 * 1e9)
    idle = 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_s > 0 else None
    split = {name: read(w) for name, read in hostspans.READERS.items()}
    if idle is not None and split["idle_launch_pct"] is not None:
        split["idle_pct"] = idle
        split["idle_rest_pct"] = idle - split["idle_launch_pct"] - split["idle_worker_pct"]
    states = hostspans.LaneStates(spans)
    yield "result", result_line(out, spans, busy_s=tr.busy_s, window_s=tr.window_s)
    yield "split", split
    yield "spans", hostspans.span_table(spans)
    yield "counters", counter_line(w.spans["counters"], spans)
    yield "gap_classes", hostspans.gap_classes(tr.gaps, tr.window_s)
    yield "idle_by_state", hostspans.idle_by_state(states, tr.gaps, tr.window_s)
    yield "longest_gaps", hostspans.named_gaps(states, tr.gaps, t0_ns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("seconds", type=float)
    ap.add_argument("--out", default=None,
                    help="write every span and every gap of 0.1 ms or more here (JSON)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=None,
                    help="callers and lanes in place of the cell's")
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1,
                    help="0: untraced, the recorder on and no profiler")
    ap.add_argument("--serial-forward", action="store_true",
                    help="one lane at a time inside the family's forward")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        base = (stack.enter_context(lanes_base(args.cell, args.lanes))
                if args.lanes is not None else spec.HERE)
        if args.serial_forward:
            stack.enter_context(serial_forward())
        if not args.profiler:
            out, rec = recorded_window(args.cell, args.seed, args.seconds, args.device, base)
            for key, obj in report_untraced(out, rec):
                print(json.dumps({key: obj}), flush=True)
            return 0
        out, w = traced_window(args.cell, args.seed, args.seconds, args.device, base)
    for key, obj in report(out, w):
        print(json.dumps({key: obj}), flush=True)
    if args.out:
        t0_ns = round(w.t0 * 1e9)
        with open(args.out, "w") as f:
            json.dump({"t0_ns": t0_ns, "window_s": w.trace.window_s,
                       "gaps": [g for g in w.trace.gaps if g[1] - g[0] >= 100_000],
                       "counters": w.spans["counters"],
                       "spans": [s._asdict() for s in w.spans["spans"]]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
