"""The port's serving path on the CPU: ``Worker(device="cpu")`` through
every cold-start strategy, against the JAX worker on the same weights,
specs and tokens (dense, SSM, MoE and hybrid families), over a chunk store
the JAX registry wrote, in bfloat16 with ``ml_dtypes`` blocked, and through
the cluster and the CLI."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.snapshot import flatten_pytree  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_flat, to_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ColdStartOptions, InvocationRequest, Strategy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIVE = ("regular", "reap", "seuss", "snapfaas-", "snapfaas")


def _invoke(worker, fn, tokens, *, strategy="snapfaas", force_cold=False):
    return worker.invoke(InvocationRequest(
        function=fn, tokens=np.asarray(tokens),
        options=ColdStartOptions(strategy=Strategy.coerce(strategy),
                                 force_cold=force_cold),
    ))


# ------------------------------------- analogues of tests/test_runtime.py

class TestServing:
    @pytest.fixture(scope="class")
    def worker_and_specs(self, tmp_path_factory):
        from repro_torch.serving.trace import build_functions
        root = str(tmp_path_factory.mktemp("serve"))
        cfg = reduced(get_config("gemma-2b"))
        model = build_model(cfg)
        return build_functions(root, cfg, model, n_functions=3, device="cpu"), cfg

    def test_all_strategies_same_output(self, worker_and_specs):
        (worker, specs), cfg = worker_and_specs
        from repro_torch.serving.trace import request_tokens
        outs = {}
        for strat in FIVE + ("auto",):
            toks = request_tokens(specs[0], np.random.default_rng(7), cfg.vocab_size)
            outs[strat] = _invoke(worker, specs[0].name, toks, strategy=strat,
                                  force_cold=True).output
        for strat, o in outs.items():
            np.testing.assert_allclose(o, outs["regular"], rtol=1e-5, atol=1e-5,
                                       err_msg=strat)

    def test_warm_hit_skips_boot(self, worker_and_specs):
        (worker, specs), cfg = worker_and_specs
        from repro_torch.serving.trace import request_tokens
        toks = request_tokens(specs[1], np.random.default_rng(3), cfg.vocab_size)
        r1 = _invoke(worker, specs[1].name, toks, force_cold=True)
        r2 = _invoke(worker, specs[1].name, toks)
        assert r1.cold and not r2.cold
        assert r2.boot_s == 0.0
        np.testing.assert_allclose(r1.output, r2.output, rtol=1e-6)

    def test_snapfaas_eager_less_than_minus(self, worker_and_specs):
        (worker, specs), cfg = worker_and_specs
        from repro_torch.serving.trace import request_tokens
        spec = specs[0]
        toks = request_tokens(spec, np.random.default_rng(5), cfg.vocab_size)
        r_ws = _invoke(worker, spec.name, toks, force_cold=True)
        r_full = _invoke(worker, spec.name, toks, strategy="snapfaas-", force_cold=True)
        assert r_ws.metrics.eager_bytes <= r_full.metrics.eager_bytes

    def test_stray_access_is_correct(self, worker_and_specs):
        (worker, specs), cfg = worker_and_specs
        stray = np.asarray([[cfg.vocab_size - 1, 0, 1, 2]], np.int32)
        r_cold = _invoke(worker, specs[0].name, stray, force_cold=True)
        r_reg = _invoke(worker, specs[0].name, stray, strategy="regular", force_cold=True)
        np.testing.assert_allclose(r_cold.output, r_reg.output, rtol=1e-5, atol=1e-5)

    def test_pool_eviction(self):
        from repro_torch.serving.worker import InstancePool
        pool = InstancePool(budget_bytes=100)
        pool.put("a", object(), 60)  # type: ignore[arg-type]
        pool.put("b", object(), 60)  # type: ignore[arg-type]
        assert pool.get("a") is None
        assert pool.get("b") is not None

    def test_device_patch_serves_the_variant(self, worker_and_specs):
        """A snapfaas cold start of the head function patches embed/table
        base ⊕ diff on the worker's device; the result is the variant's
        exact bytes and the pooled base is untouched."""
        (worker, specs), cfg = worker_and_specs
        spec = specs[1]
        base = worker._pool_dev[cfg.name]["embed/table"].clone()
        _invoke(worker, spec.name, np.zeros((1, 4), np.int32), force_cold=True)
        inst = worker.pool.get(spec.name)
        dev = inst.arrays["embed/table"]._dev
        assert dev is not None and dev.device == worker.device
        np.testing.assert_array_equal(to_numpy(dev), spec.variant["embed/table"])
        assert torch.equal(worker._pool_dev[cfg.name]["embed/table"], base)


# ------------------------------------------------------- against JAX

@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """The same weights (JAX's, carried across), specs and tokens in both
    packages' workers."""
    from repro.serving.trace import build_functions as jax_build_functions
    from repro_torch.serving.trace import build_functions
    jcfg = jax_reduced(jax_config("gemma-2b"))
    jm = jax_build(jcfg)
    jroot = str(tmp_path_factory.mktemp("jax"))
    jworker, jspecs = jax_build_functions(jroot, jcfg, jm, n_functions=3)
    flat = flatten_pytree(jax.tree.map(np.asarray, jm.init(0)))
    cfg = reduced(get_config("gemma-2b"))
    model = build_model(cfg)
    base = params_from_flat(flat, "cpu", template=model.param_shapes())
    tworker, tspecs = build_functions(str(tmp_path_factory.mktemp("port")), cfg, model,
                                      n_functions=3, device="cpu", base_params=base)
    return jworker, jspecs, tworker, tspecs, cfg


@pytest.mark.parametrize("strategy", FIVE)
def test_port_worker_matches_jax_worker(jax_and_port, strategy):
    """Same specs and tokens under each strategy: f32, different attention
    summation order (XLA blockwise vs the plain version) → 1e-4."""
    from repro_torch.serving.trace import request_tokens
    jworker, jspecs, tworker, tspecs, cfg = jax_and_port
    for js, ts in zip(jspecs, tspecs):
        assert js.name == ts.name
        for k in js.variant:
            np.testing.assert_array_equal(js.variant[k], ts.variant[k])
        toks = request_tokens(ts, np.random.default_rng(11), cfg.vocab_size)
        want = _invoke(jworker, js.name, toks, strategy=strategy, force_cold=True)
        got = _invoke(tworker, ts.name, toks, strategy=strategy, force_cold=True)
        assert got.output.shape == want.output.shape == (1, 8)
        assert got.output.dtype == np.float32
        np.testing.assert_allclose(got.output, want.output, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_and_port_mamba2(tmp_path_factory):
    """Reduced mamba2 in both packages' workers: JAX's weights carried
    across, the same delta uploads (adapter, head, fine-tune) registered in
    each through ``FunctionSpec(delta=...)``."""
    from repro.serving.worker import FunctionSpec as JSpec
    from repro.serving.worker import Worker as JWorker
    from repro_torch.serving import Worker
    from repro_torch.serving.trace import build_delta_specs
    jcfg = jax_reduced(jax_config("mamba2-780m"))
    jm = jax_build(jcfg)
    jparams = jm.init(0)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    cfg = reduced(get_config("mamba2-780m"))
    model = build_model(cfg)
    specs = build_delta_specs(str(tmp_path_factory.mktemp("src")), cfg, flat)
    jworker = JWorker(str(tmp_path_factory.mktemp("jax")))
    jworker.register_runtime(jcfg.name, jm, jparams)
    tworker = Worker(str(tmp_path_factory.mktemp("port")), device="cpu")
    tworker.register_runtime(cfg.name, model,
                             params_from_flat(flat, "cpu", template=model.param_shapes()))
    for s in specs:
        jworker.register_function(JSpec(name=s.name, family=jcfg.name, delta=s.delta,
                                        touched_rows=s.touched_rows,
                                        source_path=s.source_path))
        tworker.register_function(s)
    return jworker, tworker, specs, cfg


@pytest.mark.parametrize("strategy", ["regular", "snapfaas"])
def test_port_worker_matches_jax_worker_on_mamba2(jax_and_port_mamba2, strategy):
    """64-token requests (2 chunks of 32: the state carry runs); f32, the
    SSD scan and projections summed in other orders → 1e-4."""
    from repro_torch.serving.trace import request_tokens
    jworker, tworker, specs, cfg = jax_and_port_mamba2
    assert [s.name for s in specs] == ["fn0-adapter", "fn1-head", "fn2-finetune"]
    for s in specs:
        toks = request_tokens(s, np.random.default_rng(13), cfg.vocab_size, seq=64)
        want = _invoke(jworker, s.name, toks, strategy=strategy, force_cold=True)
        got = _invoke(tworker, s.name, toks, strategy=strategy, force_cold=True)
        assert got.output.shape == want.output.shape == (1, 8)
        np.testing.assert_allclose(got.output, want.output, rtol=1e-4, atol=1e-4,
                                   err_msg=s.name)


MOE_FAMILIES = ["olmoe-1b-7b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", params=MOE_FAMILIES)
def jax_and_port_moe(request, tmp_path_factory):
    """Reduced olmoe (MoE every layer) and jamba (the hybrid): a JAX worker
    built by JAX's ``build_functions`` (full variants), and the port's
    worker on JAX's weights with the port's delta uploads."""
    from repro.serving.trace import build_functions as jax_build_functions
    from repro_torch.serving import Worker
    from repro_torch.serving.trace import build_delta_specs
    name = request.param
    jcfg = jax_reduced(jax_config(name))
    jm = jax_build(jcfg)
    jworker, jspecs = jax_build_functions(str(tmp_path_factory.mktemp("jax")), jcfg, jm,
                                          n_functions=3)
    flat = flatten_pytree(jax.tree.map(np.asarray, jm.init(0)))
    cfg = reduced(get_config(name))
    model = build_model(cfg)
    specs = build_delta_specs(str(tmp_path_factory.mktemp("src")), cfg, flat)
    tworker = Worker(str(tmp_path_factory.mktemp("port")), device="cpu")
    tworker.register_runtime(cfg.name, model,
                             params_from_flat(flat, "cpu", template=model.param_shapes()))
    for spec in specs:
        tworker.register_function(spec)
    return jworker, jspecs, tworker, specs, flat, cfg


def test_moe_delta_specs_equal_jax_variants(jax_and_port_moe):
    """Each delta upload holds exactly the leaves where JAX's variant
    differs from the base, with JAX's values."""
    _, jspecs, _, specs, flat, _ = jax_and_port_moe
    assert [s.name for s in specs] == [s.name for s in jspecs]
    for js, ts in zip(jspecs, specs):
        differ = {k for k, v in js.variant.items() if not np.array_equal(v, flat[k])}
        assert set(ts.delta) == differ, js.name
        for k in differ:
            np.testing.assert_array_equal(ts.delta[k], js.variant[k], err_msg=k)
        assert ts.touched_rows == js.touched_rows


@pytest.mark.parametrize("strategy", ["regular", "snapfaas"])
def test_port_worker_matches_jax_worker_on_moe(jax_and_port_moe, strategy):
    """32-token requests (one SSD chunk in jamba); f32, capacity factor 8.0
    (drop-free), the attention, scan and expert products summed in other
    orders → 1e-4."""
    from repro_torch.serving.trace import request_tokens
    jworker, jspecs, tworker, specs, _, cfg = jax_and_port_moe
    for js, ts in zip(jspecs, specs):
        toks = request_tokens(ts, np.random.default_rng(17), cfg.vocab_size)
        want = _invoke(jworker, js.name, toks, strategy=strategy, force_cold=True)
        got = _invoke(tworker, ts.name, toks, strategy=strategy, force_cold=True)
        assert got.output.shape == want.output.shape == (1, 8)
        np.testing.assert_allclose(got.output, want.output, rtol=1e-4, atol=1e-4,
                                   err_msg=ts.name)


def test_snapshot_from_jax_registry_restores_in_port(tmp_path):
    """A root written by the JAX registry: the port's worker reopens its
    chunk store, finds every chunk of the same base and function already
    stored (identical digests), and serves from those bytes."""
    from repro.serving.worker import FunctionSpec as JSpec
    from repro.serving.worker import Worker as JWorker
    from repro_torch.serving import FunctionSpec, Worker
    jcfg = jax_reduced(jax_config("stablelm-3b"))
    jm = jax_build(jcfg)
    jparams = jm.init(2)
    root = str(tmp_path / "shared")
    jw = JWorker(root)
    jw.register_runtime(jcfg.name, jm, jparams)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    variant = {k: np.array(v) for k, v in flat.items()}
    for k in variant:
        if k.endswith("ffn/w_in"):
            variant[k] = variant[k] + 0.01
    jw.register_function(JSpec(name="fn", family=jcfg.name, variant=variant))
    toks = np.arange(12, dtype=np.int32)[None] % jcfg.vocab_size
    want = _invoke(jw, "fn", toks, strategy="snapfaas", force_cold=True).output
    stored = jw.registry.store.stored_bytes()
    jbase = jw.registry.bases[jcfg.name]
    del jw

    cfg = reduced(get_config("stablelm-3b"))
    model = build_model(cfg)
    tw = Worker(root, device="cpu")
    assert tw.registry.store.stored_bytes() == stored  # reopened JAX's store
    tw.register_runtime(cfg.name, model,
                        params_from_flat(flat, "cpu", template=model.param_shapes()))
    tw.register_function(FunctionSpec(name="fn", family=cfg.name, variant=variant))
    assert tw.registry.store.stored_bytes() == stored  # nothing new to store
    tbase = tw.registry.bases[cfg.name]
    for path, meta in jbase.arrays.items():
        assert [c.digest for c in tbase.arrays[path].chunks] == \
            [c.digest for c in meta.chunks], path
    for strat in FIVE:
        got = _invoke(tw, "fn", toks, strategy=strat, force_cold=True).output
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=strat)


# ------------------------------------------------------------ bf16

def test_bf16_served_without_ml_dtypes():
    """bfloat16 leaves cross the registry as uint16 bits: every strategy
    serves the same output, and a device-patched leaf holds the variant's
    exact bits — with ``ml_dtypes`` and ``jax`` unimportable."""
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import dataclasses, tempfile
import numpy as np, torch
torch.set_num_threads(2)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import to_numpy
from repro_torch.models import build_model
from repro_torch.serving import ColdStartOptions, InvocationRequest
from repro_torch.serving.trace import build_functions, request_tokens
cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="bfloat16")
model = build_model(cfg)
with tempfile.TemporaryDirectory() as root:
    w, specs = build_functions(root, cfg, model, n_functions=3, device="cpu")
    assert w.registry.bases[cfg.name].arrays["embed/table"].dtype == "uint16"
    patched = 0
    for s in specs:
        toks = request_tokens(s, np.random.default_rng(0), cfg.vocab_size, seq=16)
        outs = []
        for strat in ("regular", "reap", "seuss", "snapfaas-", "snapfaas", "auto"):
            r = w.invoke(InvocationRequest(function=s.name, tokens=toks,
                options=ColdStartOptions(strategy=strat, force_cold=True)))
            assert r.output.dtype == np.float32 and np.isfinite(r.output).all()
            outs.append(r.output)
        for o in outs:
            np.testing.assert_array_equal(o, outs[0])
        inst = w.pool.get(s.name)
        for path, ma in inst.arrays.items():
            if ma._dev is not None:
                assert ma._dev.dtype == torch.bfloat16
                np.testing.assert_array_equal(to_numpy(ma._dev), s.variant[path])
                patched += 1
    assert patched > 0
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


# ------------------------------------------------------ cluster and CLI

def test_cluster_on_cpu_serves_and_counts(tmp_path):
    from repro_torch.serving.trace import build_cluster, replay_cluster_trace, summarize
    cfg = reduced(get_config("gemma-2b"))
    cluster, specs = build_cluster(str(tmp_path), cfg, build_model(cfg), n_workers=2,
                                   n_functions=3, device="cpu")
    assert all(w.device.type == "cpu" for w in cluster.workers)
    with cluster:
        res = replay_cluster_trace(cluster, specs, n_requests=8, cold_fraction=0.5,
                                   strategy="snapfaas", seed=1)
    row = summarize("snapfaas", res)
    assert row["n_cold"] + row["n_warm"] == 8
    assert all(np.isfinite(r.output).all() for r in res)


def _serve(argv):
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


def test_launch_serve_compare_mode_on_cpu(tmp_path):
    out = _serve(["--workers", "2", "--functions", "3", "--requests", "6",
                  "--strategies", "snapfaas", "auto", "--device", "cpu",
                  "--root", str(tmp_path)])
    head = json.loads(out.splitlines()[0])
    assert head["device"] == "cpu"
    assert head["allow_tf32"] == {"matmul": False, "cudnn": False}
    rows, _ = json.JSONDecoder().raw_decode(out[out.index("\n[") + 1:])
    assert [r["strategy"] for r in rows] == ["snapfaas", "auto"]
    assert all(r["n_cold"] + r["n_warm"] == 6 for r in rows)


@pytest.mark.parametrize("family", MOE_FAMILIES)
def test_launch_serve_moe_families_on_cpu(family, tmp_path):
    out = _serve(["--family", family, "--workers", "1", "--functions", "3",
                  "--requests", "4", "--strategies", "regular", "snapfaas",
                  "--device", "cpu", "--root", str(tmp_path)])
    rows, _ = json.JSONDecoder().raw_decode(out[out.index("\n[") + 1:])
    assert [r["strategy"] for r in rows] == ["regular", "snapfaas"]
    assert all(r["n_cold"] + r["n_warm"] == 4 for r in rows)


def test_launch_serve_trace_mode_on_cpu(tmp_path):
    out = _serve(["--workers", "1", "--functions", "2", "--trace", "poisson",
                  "--rps", "40", "--duration", "0.25", "--time-scale", "0",
                  "--device", "cpu", "--root", str(tmp_path)])
    assert '"trace_serving"' in out and '"scheduler"' in out


def test_launch_serve_refuses_cuda_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve(["--root", str(tmp_path)])
