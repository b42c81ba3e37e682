"""Traffic is a function of the workload file and the seed alone."""

import numpy as np

from conftest import DATA

import spec
import traffic


def _wl():
    return spec.load_workload("tiny-dense.cold", DATA)


def test_open_schedule_is_the_same_byte_for_byte_for_a_seed():
    a = traffic.open_schedule(_wl(), 30.0, 2**33 + 5)
    b = traffic.open_schedule(_wl(), 30.0, 2**33 + 5)
    assert a == b
    ta = [traffic.tokens(50304, 4, x.seq, x.tok_seed, range(16)).tobytes() for x in a[:5]]
    tb = [traffic.tokens(50304, 4, x.seq, x.tok_seed, range(16)).tobytes() for x in b[:5]]
    assert ta == tb


def test_every_trace_seed_offers_the_same_work_in_another_order():
    wl = _wl()
    a = traffic.open_schedule(dict(wl, trace_seed=1), 30.0, 5)
    b = traffic.open_schedule(dict(wl, trace_seed=2), 30.0, 5)
    assert len(a) == len(b) == round(wl["arrivals"]["rate_per_s"] * 30)
    assert sorted(x.seq for x in a) == sorted(x.seq for x in b)
    assert sorted(x.fn for x in a) == sorted(x.fn for x in b)
    ga, gb = np.diff([x.t for x in a]), np.diff([x.t for x in b])
    assert not np.array_equal(ga, gb)
    # the same gaps but the one that starts the schedule
    assert abs(np.sort(ga).sum() - np.sort(gb).sum()) < np.max(ga) + np.max(gb)
    assert [x.fn for x in a] != [x.fn for x in b]
    assert 0.0 <= a[0].t and a[-1].t < 30.0


def test_a_trace_seed_replays_one_trace_with_the_runs_data():
    wl = _wl()
    a = traffic.open_schedule(wl, 30.0, 1)
    b = traffic.open_schedule(wl, 30.0, 2)
    assert [(x.t, x.fn, x.seq) for x in a] == [(x.t, x.fn, x.seq) for x in b]
    assert [x.tok_seed for x in a] != [x.tok_seed for x in b]


def test_zipf_shares_and_rank_order():
    wl = _wl()
    a = traffic.open_schedule(wl, 30.0, 9)
    counts = np.bincount([x.fn for x in a], minlength=6)
    w = traffic.zipf_weights(6, 1.0)
    assert np.all(np.abs(counts - w * len(a)) < 1.0)
    assert list(counts) == sorted(counts, reverse=True)


def test_closed_stream_rounds_hold_every_function_and_length_equally():
    wl = spec.load_workload("mamba2-780m.warm-long")
    s = traffic.closed_stream(wl, 3)
    rnd = [next(s) for _ in range(9)]
    assert sorted(x.fn for x in rnd) == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert sorted(x.seq for x in rnd) == sorted(wl["seq_lens"] * 3)
    s2 = traffic.closed_stream(wl, 3)
    assert [next(s2) for _ in range(9)] == rnd


def test_adapter_rows_end_every_row():
    t = traffic.tokens(1000, 3, 64, 11, range(40, 56))
    assert all(set(row[-16:]) == set(range(40, 56)) for row in t)


def test_the_frozen_mmpp_draw_repeats_for_a_seed():
    a, b = traffic.mmpp_times(5.0, 20.0, 9), traffic.mmpp_times(5.0, 20.0, 9)
    assert a.tobytes() == b.tobytes() and len(a) > 0
    assert np.all(np.diff(a) > 0) and a[-1] < 20.0
