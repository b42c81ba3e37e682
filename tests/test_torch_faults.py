"""The port's fault and record paths on the CPU: the worker-crash failover
(the worker's ``before_invoke`` hook), the chaos soak, REAP record mode
(``Worker.record_function``, ``_params_for``'s touch mirroring) then a
forced demand-paged replay, the chaos replay CLI
(``python -m repro_torch.launch.replay``) against the JAX package's
``launch/serve.py``, and the port's examples.

Ported from ``tests/test_faults.py::TestWorkerFailover``, the chaos soak
there (``soak`` marker) and
``tests/test_demand_paging.py::TestWorkerRecordReplay``."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import (
    ChunkRecording,
    FaultError,
    FaultInjector,
    FaultMatrix,
    RetryPolicy,
    TierSpec,
)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHUNK = 4096
# fast remote throttle: semantics, not timing
FAST_REMOTE = dict(remote_bw=10e9, remote_lat=0.0)
# fast backoff so retry-heavy tests stay in the millisecond range
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.0005,
                         max_delay_s=0.002, deadline_s=5.0)


def _tiny_cfg():
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, d_ff=128, vocab_size=256, tie_embeddings=True,
        dtype="float32",
    )


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


# ------------------------------------------------- worker crash + failover

class TestWorkerFailover:
    def _build(self, root, *, faults=None):
        from repro_torch.convert import params_to_flat
        from repro_torch.models import build_model
        from repro_torch.serving.cluster import Cluster
        from repro_torch.serving.worker import FunctionSpec

        model = build_model(_tiny_cfg())
        cluster = Cluster(
            root, n_workers=2, chunk_bytes=CHUNK, device="cpu",
            tiers=TierSpec(ram_bytes=1 << 20, faults=faults, **FAST_REMOTE),
        )
        base_params = model.init(0, device="cpu")
        cluster.register_runtime("t", model, base_params)
        flat = params_to_flat(base_params)
        specs = []
        for i in range(2):
            variant = {k: np.array(v) + 0.01 * (i + 1) for k, v in flat.items()}
            spec = FunctionSpec(name=f"fn{i}", family="t", variant=variant)
            cluster.register_function(spec)
            specs.append(spec)
        return cluster, specs

    def test_crashed_worker_fails_over_and_conserves_requests(self, tmp_path):
        from repro_torch.serving import InvocationRequest

        inj = FaultInjector(FaultMatrix(crash_after=1))
        clean, specs = self._build(str(tmp_path / "clean"))
        chaos, _ = self._build(str(tmp_path / "chaos"), faults=inj)
        toks = np.arange(8, dtype=np.int32).reshape(1, 8) % 256
        with clean, chaos:
            expected = {
                s.name: clean.invoke(InvocationRequest(function=s.name,
                                                       tokens=toks)).output
                for s in specs
            }
            # the very first invocation crashes its worker; the cluster
            # detects it, re-shards onto the survivor, re-registers the
            # function there and re-dispatches — the request is not lost
            served_by = set()
            for s in specs:
                r = chaos.invoke(InvocationRequest(function=s.name, tokens=toks))
                served_by.add(r.worker_id)
                np.testing.assert_array_equal(np.asarray(r.output),
                                              np.asarray(expected[s.name]))
            m = chaos.metrics()
            assert m["serving"]["n_worker_crashes"] == 1
            assert len(m["serving"]["dead_workers"]) == 1
            dead = m["serving"]["dead_workers"][0]
            assert not m["per_worker"][dead]["alive"]
            assert dead not in served_by  # the survivor served both functions
            # the failed-over request completed, flagged as recovered
            assert m["serving"]["failures"]["fault_recovered"] >= 1
            assert m["serving"]["failures"]["fault_fatal"] == 0
            assert m["chaos"]["worker_crash"] == 1
            # requests conserve: every submit completed despite the crash
            assert m["n_requests"] == len(specs)


# ----------------------------------------------------------- chaos soak

@pytest.mark.soak
def test_chaos_soak_conservation_and_byte_equivalence(tmp_path):
    """Short injected-fault soak: replay one trace through a clean fleet
    and a chaos fleet (bit flips + a worker crash mid-replay + a remote
    outage window).  Acceptance: request conservation holds, every error
    is typed, and every completed chaos result is byte-identical to the
    clean fleet's result for the same arrival."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import make_trace
    from repro_torch.serving.trace import build_cluster

    cfg = reduced(get_config("gemma-2b"))
    model = build_model(cfg)
    inj = FaultInjector(FaultMatrix(seed=5, bit_flip=0.02, crash_after=10))
    clean, clean_specs = build_cluster(
        str(tmp_path / "clean"), cfg, model, n_workers=2, n_functions=3, device="cpu",
        tiers=TierSpec(ram_bytes=32 << 20, **FAST_REMOTE),
    )
    chaos, chaos_specs = build_cluster(
        str(tmp_path / "chaos"), cfg, model, n_workers=2, n_functions=3, device="cpu",
        tiers=TierSpec(ram_bytes=32 << 20, faults=inj,
                       retry=FAST_RETRY, **FAST_REMOTE),
    )
    trace = make_trace("poisson", rps=120, duration_s=0.4, n_functions=3,
                       seed=11)
    with clean, chaos:
        clean_rep = clean.replay_trace(trace, clean_specs, time_scale=0)
        assert clean_rep.n_failed == 0 and clean_rep.n_shed == 0

        # cold-restore under faults: demote every function's chunks so the
        # outage window below actually bites, then open/close it mid-replay
        for s in chaos_specs:
            chaos.worker_for(s.name).registry.demote_function(s.name)
        down = threading.Timer(0.05, lambda: inj.fail_tier("remote"))
        heal = threading.Timer(0.30, lambda: inj.heal_tier("remote"))
        down.start(), heal.start()
        try:
            rep = chaos.replay_trace(trace, chaos_specs, time_scale=1.0)
        finally:
            down.cancel(), heal.cancel()
            inj.heal_tier("remote")

        # conservation: every arrival resolved to exactly one bucket
        assert rep.n_submitted == rep.n_completed + rep.n_shed + rep.n_failed
        assert rep.n_submitted == clean_rep.n_submitted
        # every failure is typed — never a bare IOError/KeyError
        for _i, exc in rep.errors:
            assert isinstance(exc, (FaultError, TimeoutError)), exc
        # zero byte-equivalence violations on everything that completed
        for got, want in zip(rep.results, clean_rep.results):
            if got is not None:
                np.testing.assert_array_equal(np.asarray(got.output),
                                              np.asarray(want.output))
        # one worker crashed mid-replay and the fleet kept serving
        m = chaos.metrics()
        assert m["serving"]["n_worker_crashes"] >= 1
        assert rep.n_completed > 0
        # the taxonomy sums are consistent with the report
        assert rep.failures()["shed"] == rep.n_shed
        assert rep.failures()["timeout"] + rep.failures()["fault_fatal"] \
            == rep.n_failed


# ----------------------------------------------------- worker record/replay

class TestWorkerRecordReplay:
    """End-to-end through the serving layer: record mode is observationally
    identical to a plain invocation, the recording persists, and a forced
    demand-paged replay reproduces the output with zero faults."""

    def _worker(self, tmp_path):
        from repro_torch.convert import params_to_flat
        from repro_torch.models import build_model
        from repro_torch.serving.worker import FunctionSpec, Worker

        cfg = _tiny_cfg()
        model = build_model(cfg)
        worker = Worker(str(tmp_path / "w"), chunk_bytes=4096, device="cpu")
        base_params = model.init(0, device="cpu")
        worker.register_runtime("t", model, base_params)
        flat = params_to_flat(base_params)
        variant = {k: np.array(v) for k, v in flat.items()}
        for k in variant:
            if k.endswith("wq"):
                variant[k] = variant[k] + 0.01
        spec = FunctionSpec(name="fn", family="t", variant=variant)
        worker.register_function(spec)
        return worker, spec, cfg

    def test_record_then_demand_replay(self, tmp_path):
        from repro_torch.serving import ColdStartOptions, InvocationRequest, Strategy
        from repro_torch.serving.trace import request_tokens

        worker, spec, cfg = self._worker(tmp_path)
        toks = request_tokens(spec, np.random.default_rng(0), cfg.vocab_size,
                              seq=8)

        def cold(**opts):
            return worker.invoke(InvocationRequest(
                function="fn", tokens=toks,
                options=ColdStartOptions(strategy=Strategy.SNAPFAAS,
                                         force_cold=True, **opts),
            ))

        baseline = cold()
        recorded = worker.record_function("fn", toks, n_profiles=2)
        np.testing.assert_array_equal(
            np.asarray(baseline.output), np.asarray(recorded.output))
        rec = worker.registry.functions["fn"].recording
        assert rec is not None and rec.n_profiles >= 2
        assert ChunkRecording.load(worker.registry.root, "fn") is not None
        assert worker.registry.sizes("fn").has_recording

        first = cold(demand_paging=True)
        second = cold(demand_paging=True)
        for r in (first, second):
            assert r.metrics.demand_paged
            np.testing.assert_array_equal(
                np.asarray(baseline.output), np.asarray(r.output))
        # the recording covered this request: the replay faults nothing in
        assert second.metrics.demand_faults == 0
        # forcing eager on the same function still works and still matches
        eager = cold(demand_paging=False)
        assert not eager.metrics.demand_paged
        np.testing.assert_array_equal(
            np.asarray(baseline.output), np.asarray(eager.output))


# ----------------------------------------------------------- the replay CLI

def _replay(*argv):
    from repro_torch.launch import replay

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert replay.main(list(argv)) == 0
    return json.loads(buf.getvalue())


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "injected":
            out |= _keys(v, prefix + k + "/")
    return out


def test_replay_cli_remote_outage(tmp_path):
    """The assertions the reference CI makes of ``launch/serve.py --chaos
    remote-outage``: the 2 s trace spans the (0, 1) s outage window, so
    requests inside it fail typed and requests after the heal complete."""
    d = _replay("--chaos", "remote-outage", "--rps", "40", "--duration", "2.0",
                "--functions", "2", "--device", "cpu", "--root", str(tmp_path))
    assert d["device"] == "cpu"
    assert d["conservation_holds"], d
    assert d["chaos"]["profile"] == "remote-outage"
    f = d["serving"]["failures"]
    assert set(f) == {"shed", "timeout", "fault_recovered", "fault_fatal"}
    assert f["fault_fatal"] > 0, f
    assert d["summary"]["n_completed"] > 0, d["summary"]
    assert d["tier_health"]["fail_fast_reads"] > 0, d["tier_health"]


def test_replay_cli_failover_matches_the_jax_cli(tmp_path):
    """``--chaos standard`` crashes a worker after 5 invocations: the port's
    document has the JAX CLI's keys (plus ``device``) and both fleets fail
    over once, recovering the request."""
    args = ["--chaos", "standard", "--rps", "40", "--duration", "1.0", "--functions", "2"]
    jax_cli = subprocess.Popen(
        [sys.executable, "launch/serve.py", *args, "--root", str(tmp_path / "jax")],
        cwd=str(ROOT), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _replay(*args, "--device", "cpu", "--root", str(tmp_path / "port"))
    out, err = jax_cli.communicate(timeout=300)
    assert jax_cli.returncode == 0, err[-3000:]
    ref = json.loads(out)
    assert _keys(port) - {"device"} == _keys(ref)
    for d in (port, ref):
        assert d["conservation_holds"], d
        assert d["serving"]["n_worker_crashes"] == 1
        assert len(d["serving"]["dead_workers"]) == 1
        assert d["serving"]["failures"]["fault_recovered"] >= 1
        assert d["chaos"]["injected"]["worker_crash"] == 1
    assert port["summary"]["n_submitted"] == ref["summary"]["n_submitted"]


def test_replay_cli_without_chaos_completes_everything(tmp_path):
    d = _replay("--rps", "40", "--duration", "0.5", "--functions", "2",
                "--time-scale", "0", "--device", "cpu", "--root", str(tmp_path))
    assert d["conservation_holds"]
    assert "chaos" not in d
    s = d["summary"]
    assert s["n_completed"] == s["n_submitted"] > 0
    assert d["serving"]["n_worker_crashes"] == 0


# --------------------------------------------------------------- examples

@pytest.mark.parametrize("example,expect", [
    ("torch_quickstart.py", "device patch on cpu"),
    ("torch_serve_coldstart.py", '"fleet"'),
    ("torch_train_resume.py", "resumed and completed OK"),
])
def test_example_runs_on_the_cpu(example, expect):
    r = subprocess.run([sys.executable, str(ROOT / "examples" / example), "--device", "cpu"],
                       cwd=str(ROOT), env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert expect in r.stdout
