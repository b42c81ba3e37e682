"""The port's recorder (``repro_torch.obs``): off it records nothing and
hands out one shared no-op context; on, spans nest per thread, a request's
spans share its id, ``drain`` clears, and the registered counters report
how far they moved.  Then the request path's spans through a CPU cluster
behind an ``AdmissionController`` with four lanes."""

import ast
import pathlib
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OBS = ROOT / "src" / "repro_torch" / "obs.py"

INVOKE_CHILDREN = ("worker.lookup", "worker.params", "worker.tokens", "worker.forward",
                   "worker.sync", "worker.pool_put", "worker.output")


@pytest.fixture
def recorder():
    obs.enable()
    try:
        yield obs
    finally:
        obs.disable()
        obs.drain()


def test_off_records_nothing_and_shares_one_context():
    obs.disable()
    obs.drain()
    a, b = obs.span("x"), obs.request("y", function="f")
    assert a is b
    with a as s:
        s.set(cold=True)
        with obs.span("z"):
            pass
    assert obs.drain()["spans"] == []


def test_obs_imports_no_torch():
    tree = ast.parse(OBS.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [n for n in names if n.split(".")[0] == "torch"], names
    assert not [n for n in names if n.startswith(".")], names


def test_spans_nest_per_thread_and_share_the_request_id(recorder):
    barrier = threading.Barrier(3)

    def lane(fn):
        barrier.wait(timeout=10)
        with obs.request("worker.invoke", function=fn) as root:
            with obs.span("worker.forward"):
                with obs.span("model.layer", layer=0):
                    pass
                with obs.span("model.layer", layer=1):
                    pass
            root.set(cold=False)
        with obs.span("outside"):
            pass

    threads = [threading.Thread(target=lane, args=(f"fn{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = obs.drain()["spans"]
    assert len(spans) == 3 * 5
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "worker.invoke"]
    assert sorted(s.attrs["function"] for s in roots) == ["fn0", "fn1", "fn2"]
    assert all(s.attrs["cold"] is False and s.parent is None for s in roots)
    assert len({s.request for s in roots}) == 3 and len({s.thread for s in roots}) == 3
    for s in spans:
        if s.name == "outside":
            assert s.parent is None and s.request is None
            continue
        root = next(r for r in roots if r.thread == s.thread)
        assert s.request == root.request
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        if s.name == "worker.forward":
            assert s.parent == root.id
        if s.name == "model.layer":
            up = by_id[s.parent]
            assert up.name == "worker.forward" and up.thread == s.thread
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    layers = sorted((s.thread, s.attrs["layer"]) for s in spans if s.name == "model.layer")
    assert [l for _, l in layers] == [0, 1] * 3


def test_drain_clears_and_reports_counter_differences(recorder):
    c = obs.LaunchCounter("test.obs.counter")
    c.add()
    c.add(41)
    with obs.span("a"):
        pass
    first = obs.drain()
    assert [s.name for s in first["spans"]] == ["a"]
    assert first["counters"]["test.obs.counter"] == 42
    c.add(8)
    second = obs.drain()
    assert second["spans"] == []
    assert second["counters"]["test.obs.counter"] == 8
    assert obs.drain()["counters"]["test.obs.counter"] == 0


def test_enable_starts_the_counts_afresh():
    c = obs.LaunchCounter("test.obs.before")
    c.add(5)
    obs.enable()
    try:
        c.add(2)
        assert obs.drain()["counters"]["test.obs.before"] == 2
    finally:
        obs.disable()


def test_the_kernels_and_the_worker_count_with_registered_launch_counters():
    from repro_torch import _build
    from repro_torch.kernels import _launch
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.serving import worker

    assert _launch.LaunchCounter is obs.LaunchCounter
    for c, name in ((flash.launches, "flash_attention"), (flash.bwd_launches,
                    "flash_attention_bwd"), (ssd.launches, "ssd_scan"),
                    (ssd.bwd_launches, "ssd_scan_bwd"), (_build.loads, "kernels.loads"),
                    (worker.h2d_bytes, "worker.h2d_bytes"), (worker.syncs, "worker.syncs")):
        assert isinstance(c, obs.LaunchCounter) and c.name == name
        assert obs._counters[name] is c


def test_a_span_closed_by_an_exception_is_recorded(recorder):
    with pytest.raises(KeyError):
        with obs.request("worker.invoke", function="missing"):
            raise KeyError("missing")
    (s,) = obs.drain()["spans"]
    assert s.name == "worker.invoke" and s.request is not None


# ------------------------------------------------- the request path's spans

def _cpu_cluster(tmp_path):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serving.trace import build_cluster

    cfg = reduced(get_config("stablelm-3b"))
    cluster, specs = build_cluster(str(tmp_path), cfg, build_model(cfg), n_workers=1,
                                   n_functions=3, device="cpu")
    return cluster, specs, cfg


def test_every_invocation_has_its_spans_in_order(tmp_path):
    from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                     ColdStartOptions, InvocationRequest)
    from repro_torch.serving.trace import request_tokens

    cluster, specs, cfg = _cpu_cluster(tmp_path)
    rng = np.random.default_rng(3)
    reqs = [InvocationRequest(function=specs[i % 3].name,
                              tokens=request_tokens(specs[i % 3], rng, cfg.vocab_size,
                                                    batch=2, seq=16),
                              options=ColdStartOptions())
            for i in range(16)]
    ctrl = AdmissionController(cluster, AdmissionConfig(queue_depth=16, worker_concurrency=4))
    obs.enable()
    try:
        futs = [ctrl.submit(r) for r in reqs]
        results = [f.result(timeout=120) for f in futs]
    finally:
        obs.disable()
        ctrl.shutdown()
        cluster.shutdown()
    rec = obs.drain()
    spans = rec["spans"]
    roots = [s for s in spans if s.name == "worker.invoke"]
    assert len(roots) == 16
    assert sorted(s.attrs["function"] for s in roots) == sorted(r.function for r in reqs)
    assert sum(s.attrs["cold"] for s in roots) == sum(r.cold for r in results)
    assert len({s.request for s in roots}) == 16
    assert len({s.thread for s in roots}) > 1  # the lanes ran on their own threads
    kids = {}
    for s in spans:
        if s.name != "worker.invoke" and s.request is not None:
            kids.setdefault(s.request, []).append(s)
    for root in roots:
        mine = sorted(kids[root.request], key=lambda s: s.start_ns)
        assert all(s.thread == root.thread for s in mine)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in mine)
        direct = [s.name for s in mine if s.parent == root.id]
        want = list(INVOKE_CHILDREN)
        if root.attrs["cold"]:
            want.insert(1, "worker.restore")
        assert direct == want, direct
        fwd = next(s for s in mine if s.name == "worker.forward")
        inner = [s for s in mine if s.parent == fwd.id]
        assert [s.name for s in inner] == (["model.embed"]
                                           + ["model.layer"] * cfg.num_layers
                                           + ["model.head"])
        assert [s.attrs["layer"] for s in inner[1:-1]] == list(range(cfg.num_layers))
    # a CPU worker copies nothing to a device and waits on none
    assert rec["counters"]["worker.h2d_bytes"] == 0
    assert rec["counters"]["worker.syncs"] == 0


def test_latency_covers_the_output_copy(tmp_path, monkeypatch):
    """``latency_s`` is taken after the output's host copy: a copy made
    slow by 50 ms shows in it, and ``exec_s`` (which ends at the sync)
    does not take it."""
    import time

    from repro_torch.serving import ColdStartOptions, InvocationRequest
    from repro_torch.serving.trace import request_tokens

    cluster, specs, cfg = _cpu_cluster(tmp_path)
    worker = cluster.workers[0]
    toks = request_tokens(specs[0], np.random.default_rng(0), cfg.vocab_size, seq=8)
    req = InvocationRequest(function=specs[0].name, tokens=toks, options=ColdStartOptions())
    worker.invoke(req)  # warm the instance
    slow = torch.Tensor.numpy

    def numpy_after_a_wait(self, *a, **k):
        time.sleep(0.05)
        return slow(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "numpy", numpy_after_a_wait)
    try:
        res = worker.invoke(req)
    finally:
        monkeypatch.undo()
        cluster.shutdown()
    assert not res.cold
    assert res.latency_s >= res.exec_s + 0.05
