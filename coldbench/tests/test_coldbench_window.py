"""A stall in the window shows in both timed end-to-end metrics."""

import threading
import time

import harness
from harness import Record


def _window(stall_at=None, stall_s=0.0, n=40, gap=0.05, service=0.02):
    recs, t_free = [], 0.0
    for i in range(n):
        due = i * gap
        start = max(due, t_free)
        if stall_at is not None and i == stall_at:
            start += stall_s
        t_free = start + service
        recs.append(Record(fn=0, seq=8, due=due, sent=due, tok_seed=i, done=t_free, ok=True))
    return recs


def test_a_stall_moves_rate_and_tail():
    seconds = 40 * 0.05
    calm = harness.end_to_end(_window(), seconds, seconds)
    stalled = harness.end_to_end(_window(stall_at=10, stall_s=1.5), seconds, seconds)
    assert stalled["inv_per_s"][0] < calm["inv_per_s"][0]
    assert stalled["e2e_p95_ms"][0] > calm["e2e_p95_ms"][0] + 500


def test_a_stall_in_a_run_on_the_cpu_moves_both(monkeypatch):
    from conftest import DATA

    def stall(cluster, cfg):
        """The whole worker stops for 1.5 s at its 20th invocation."""
        w = cluster.workers[0]
        inner, calls, gate = w.invoke, [], threading.Lock()

        def invoke(req):
            with gate:
                calls.append(1)
                if len(calls) == 20:
                    time.sleep(1.5)
            return inner(req)
        w.invoke = invoke

    kw = dict(device="cpu", base=DATA)
    calm = harness.run_cell("tiny-dense.cold", 4, 2.0, False, **kw)
    slow = harness.run_cell("tiny-dense.cold", 4, 2.0, False, tamper=stall, **kw)
    assert calm["correct"] and slow["correct"]
    assert slow["e2e"]["e2e_p95_ms"][0] > calm["e2e"]["e2e_p95_ms"][0] + 300
    assert slow["e2e"]["inv_per_s"][0] < calm["e2e"]["inv_per_s"][0]


def test_failures_count_as_missing():
    recs = _window()
    recs[3].ok = False
    recs[3].done = None
    out = harness.end_to_end(recs, 2.0, 2.0)
    assert out["inv_per_s"][0] == 39 / 2.0
    assert harness.end_to_end([recs[3]], 2.0, 2.0)["e2e_p95_ms"][0] >= harness.DRAIN_S * 1e3
