"""Each configuration's module against what the benchmark read before
configurations brought their own: the counts of stablelm-3b and
mamba2-780m equal the parent's formulas exactly at every (batch, length)
of their cells, the reference's float32 logits are bit-equal to the
parent's on the tiny dense and SSM models, and the hybrid's counts follow
the port's own plan of its layers."""

import importlib.util
import os

import pytest
import torch

from conftest import DATA, ROOT

import costs
import inputs
import reference
import spec
import traffic


def _frozen(name):
    path = os.path.join(DATA, f"{name}.py")
    s = importlib.util.spec_from_file_location(f"coldbench_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _cells(config):
    man = spec.manifest(ROOT)
    for w in man["workloads"]:
        if w["config"] == config:
            wl = spec.load_workload(w["name"])
            for s in wl["seq_lens"]:
                yield int(wl["batch"]), int(s)


@pytest.mark.parametrize("config", ["stablelm-3b", "mamba2-780m"])
def test_the_counts_equal_the_parent_formulas_exactly(config):
    old = _frozen("frozen_costs")
    cfg, mod = spec.load_config(config), spec.load_model(config)
    ssm = cfg["family"] == "ssm"
    shapes = list(_cells(config))
    assert shapes
    for b, s in shapes:
        assert mod.forward_flops(cfg, b, s) == old.forward_flops(cfg, b, s)
        calls = mod.kernel_calls(cfg, b, s)
        assert calls["flash_attention"] == ([] if ssm else old.flash_calls(cfg, b, s))
        assert calls["ssd_scan"] == (old.scan_calls(cfg, b, s) if ssm else [])
    assert mod.Reference is reference.Reference


def _weights(name, dtype, seed):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import build_params

    cfgd = dict(spec.load_config(name, DATA), dtype=dtype)
    cfg = ModelConfig(name=cfgd["name"], **spec.model_fields(cfgd))
    return cfgd, inputs.flatten(inputs.make_base(build_params, cfg, seed, torch.device("cpu")))


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("name", ["tiny-dense", "tiny-ssm"])
def test_the_reference_is_bit_equal_to_the_parent(name, quant):
    old = _frozen("frozen_reference")
    for dtype, seed in (("float32", 3), ("bfloat16", 4)):
        cfgd, P = _weights(name, dtype, seed)
        toks = torch.from_numpy(traffic.tokens(cfgd["vocab_size"], 2, 96, seed))
        new = spec.load_model(name, DATA).Reference(cfgd, quant).last_logits(P, toks)
        assert new.dtype == torch.float32
        assert torch.equal(new, old.Reference(cfgd, quant).last_logits(P, toks))


def _plan(cfgd):
    """(mixer, ffn) of every layer, by the port's own plan."""
    from repro_torch.models.blocks import build_plan
    from repro_torch.models.config import ModelConfig

    plan = build_plan(ModelConfig(name=cfgd["name"], **spec.model_fields(cfgd)))
    return [(k.mixer, k.ffn) for k in plan.kinds * plan.n_repeat]


def test_the_hybrid_counts_follow_the_ports_plan():
    cfg, mod = spec.load_config("tiny-hybrid", DATA), spec.load_model("tiny-hybrid", DATA)
    plan = _plan(cfg)
    assert plan == [("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe")]
    b, s = 2, 128
    calls = mod.kernel_calls(cfg, b, s)
    assert calls["flash_attention"] == [costs.flash_call(cfg, b, s)] * sum(
        m == "attn" for m, _ in plan)
    assert calls["ssd_scan"] == [costs.scan_call(cfg, b, s)] * sum(m == "mamba" for m, _ in plan)
    mixer = {"attn": costs.attn_flops(cfg, b, s), "mamba": costs.mamba_flops(cfg, b, s)}
    ffn = {"mlp": costs.mlp_flops(cfg, b * s, cfg["d_ff"]), "moe": costs.moe_flops(cfg, b * s)}
    expect = costs.head_flops(cfg, b) + sum(mixer[m] + ffn[f] for m, f in plan)
    assert mod.forward_flops(cfg, b, s) == pytest.approx(expect, rel=1e-12)
    # a routed FFN counts the router and k of its experts
    D, F = cfg["d_model"], cfg["moe_d_ff"]
    assert ffn["moe"] == b * s * (2 * D * 4 + 2 * 3 * 2 * D * F)
