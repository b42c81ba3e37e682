"""The port's dense, MoE, SSM and hybrid models against the JAX package's:
the parameter template (paths, shapes, dtypes; the encoder-decoder and the
VLM too), logits from JAX-carried weights (the MoE families also at a
capacity that drops tokens), the mamba mixer, and the bfloat16 bit-pattern
conversion."""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.snapshot import flatten_pytree  # noqa: E402
from repro.models import Batch as JBatch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    bf16_bits_to_f32,
    f32_to_bf16_bits,
    params_from_flat,
    params_to_flat,
)
from repro_torch.models import Batch, build_model  # noqa: E402


def _template_set(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _template_set(v, f"{prefix}{k}/")
        else:
            name = str(v.dtype).replace("torch.", "")
            out.add((f"{prefix}{k}", tuple(v.shape), name))
    return out


def _jax_template_set(name, reduce):
    cfg = jax_config(name)
    cfg = jax_reduced(cfg) if reduce else cfg
    shapes = jax_build(cfg).param_shapes()
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {("/".join(str(getattr(p, "key", p)) for p in path), tuple(s.shape), str(s.dtype))
            for path, s in flat}


@pytest.mark.parametrize("name,reduce", [
    ("faas-bench", False), ("stablelm-3b", False), ("gemma-2b", False),
    ("mistral-nemo-12b", False), ("gemma2-27b", True), ("stablelm-3b", True),
    ("mamba2-780m", False), ("mamba2-780m", True),
    ("olmoe-1b-7b", False), ("olmoe-1b-7b", True), ("grok-1-314b", False),
    ("grok-1-314b", True), ("jamba-v0.1-52b", False), ("jamba-v0.1-52b", True),
    ("whisper-small", False), ("whisper-small", True),
    ("paligemma-3b", False), ("paligemma-3b", True),
])
def test_param_shapes_match_jax(name, reduce):
    cfg = get_config(name)
    cfg = reduced(cfg) if reduce else cfg
    shapes = build_model(cfg).param_shapes()
    assert all(v.device.type == "meta" for v in jax.tree.leaves(shapes))
    assert _template_set(shapes) == _jax_template_set(name, reduce)


def test_mamba2_builds_and_its_decode_branch_raises():
    """The SSM family builds; its decode branch takes one token and a cache
    and raises without them (the decode half is held to JAX in
    tests/test_torch_decode.py)."""
    from repro_torch.models.ssm import mamba_mixer
    cfg = reduced(get_config("mamba2-780m"))
    params = build_model(cfg).init(0, device="cpu")
    pos0 = params["blocks"]["pos0"]
    assert {"w_z", "w_xBC", "w_dt", "A_log", "D", "conv_w", "w_out"} <= set(pos0)
    np.testing.assert_allclose(pos0["A_log"][0].numpy(),
                               np.log(np.arange(1, cfg.ssm_heads + 1, dtype=np.float32)))
    layer = {k: v[0] for k, v in pos0.items() if not isinstance(v, dict)}
    h = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="one token and a cache"):
        mamba_mixer(layer, h, cfg, decode=True)
    cache = {"conv": torch.zeros((1, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)),
             "ssm": torch.zeros((1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))}
    with pytest.raises(ValueError, match="one token and a cache"):
        mamba_mixer(layer, torch.zeros((1, 2, cfg.d_model)), cfg, cache=cache, decode=True)
    out, new = mamba_mixer(layer, h, cfg, cache=cache, decode=True)
    assert out.shape == h.shape and new["ssm"].dtype == torch.float32


def _carry(cfg_name, reduce, seq, seed=0, **overrides):
    jcfg = jax_config(cfg_name)
    jcfg = jax_reduced(jcfg) if reduce else jcfg
    jcfg = dataclasses.replace(jcfg, **overrides)
    jm = jax_build(jcfg)
    jparams = jm.init(seed)
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, seq), dtype=np.int32)
    want = np.asarray(jm.logits(jparams, JBatch(tokens=jax.numpy.asarray(tokens))), np.float32)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    tcfg = get_config(cfg_name)
    tcfg = reduced(tcfg) if reduce else tcfg
    tcfg = dataclasses.replace(tcfg, **overrides)
    tm = build_model(tcfg)
    params = params_from_flat(flat, "cpu", template=tm.param_shapes())
    with torch.no_grad():
        got = tm.logits(params, Batch(tokens=torch.from_numpy(tokens)))
    return got, want, flat, params


@pytest.mark.parametrize("name,reduce,seq", [
    ("faas-bench", False, 16),      # the workload model at full width
    ("stablelm-3b", True, 24),      # LayerNorm, SwiGLU, untied head
    ("gemma-2b", True, 24),         # MQA, GeGLU, scaled tied embeddings
    ("gemma2-27b", True, 40),       # local/global windows, both softcaps
    ("mistral-nemo-12b", True, 24),  # GQA
    ("mamba2-780m", True, 96),      # SSD: 3 chunks of 32, the state carried
    ("olmoe-1b-7b", True, 24),      # MoE every layer, MHA
    ("grok-1-314b", True, 24),      # MoE with gelu, GQA
    ("jamba-v0.1-52b", True, 64),   # hybrid: mamba + MLP / MoE, one attention layer
])
def test_logits_from_jax_weights_match(name, reduce, seq):
    """f32 on the CPU; only the summation order differs → rtol/atol 1e-4."""
    got, want, _, _ = _carry(name, reduce, seq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,seq", [("olmoe-1b-7b", 24), ("jamba-v0.1-52b", 64)])
def test_dropping_moe_logits_match_jax(name, seq):
    """Capacity factor 1.0 (the reduced configs' 8.0 is drop-free): the
    forward drops choices, and JAX drops the same ones → f32 1e-4."""
    from repro_torch.models import moe
    with moe.recording([]) as calls:
        got, want, _, _ = _carry(name, True, seq, capacity_factor=1.0)
    assert sum(int((~c["keep"]).sum()) for c in calls) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seq", [32, 96])
def test_mamba_mixer_matches_jax(seq):
    """One mixer on JAX's layer-0 weights: f32, summation order only → 1e-4."""
    from repro.models.ssm import mamba_mixer as jax_mixer
    from repro_torch.models.ssm import mamba_mixer
    jcfg = jax_reduced(jax_config("mamba2-780m"))
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jax_build(jcfg).init(5)["blocks"]["pos0"])
    h = np.random.default_rng(seq).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    want, _ = jax_mixer(jp, jax.numpy.asarray(h), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items() if not isinstance(v, dict)}
    with torch.no_grad():
        got, _ = mamba_mixer(tp, torch.from_numpy(h), reduced(get_config("mamba2-780m")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bf16_model_gives_f32_logits_close_to_jax():
    """bf16 weights and activations round at other places in the two
    frameworks; logits still come out float32, within bf16 precision."""
    got, want, flat, params = _carry("stablelm-3b", True, 16, dtype="bfloat16")
    assert got.dtype == torch.float32
    assert params["blocks"]["pos0"]["wq"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


def test_bf16_leaves_round_trip_bit_exactly():
    jcfg = dataclasses.replace(jax_reduced(jax_config("gemma-2b")), dtype="bfloat16")
    flat = flatten_pytree(jax.tree.map(np.asarray, jax_build(jcfg).init(1)))
    tm = build_model(dataclasses.replace(reduced(get_config("gemma-2b")), dtype="bfloat16"))
    params = params_from_flat(flat, "cpu")  # ml_dtypes bf16 → torch bf16
    back = params_to_flat(params)
    assert list(back) == list(flat)  # flatten_pytree's order
    for k, v in flat.items():
        if v.dtype == ml_dtypes.bfloat16:
            assert back[k].dtype == np.uint16
            np.testing.assert_array_equal(back[k], v.view(np.uint16))
        else:
            np.testing.assert_array_equal(back[k], v)
    again = params_to_flat(params_from_flat(back, "cpu", template=tm.param_shapes()))
    for k in back:
        np.testing.assert_array_equal(again[k], back[k])


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_bf16_moe_leaves_carry_unchanged(name):
    """A bf16 MoE tree from JAX: the 4-D stacked expert weights cross as
    bf16 bits and the router stays float32, both bit for bit, there and
    back; the template's dtypes are JAX's."""
    jcfg = dataclasses.replace(jax_reduced(jax_config(name)), dtype="bfloat16")
    flat = flatten_pytree(jax.tree.map(np.asarray, jax_build(jcfg).init(3)))
    tm = build_model(dataclasses.replace(reduced(get_config(name)), dtype="bfloat16"))
    params = params_from_flat(flat, "cpu", template=tm.param_shapes())
    moe_paths = [k for k in flat if k.endswith("ffn/router")]
    assert moe_paths
    for k in moe_paths:
        pos = k[:-len("router")]
        assert flat[k].dtype == np.float32
        leaf = params["blocks"][k.split("/")[1]]["ffn"]
        assert leaf["router"].dtype == torch.float32
        assert leaf["w_in"].dtype == torch.bfloat16 and leaf["w_in"].dim() == 4
        assert flat[pos + "w_in"].ndim == 4
    back = params_to_flat(params)
    assert list(back) == list(flat)
    for k, v in flat.items():
        want = v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v
        np.testing.assert_array_equal(back[k], want, err_msg=k)


def test_bf16_rounding_helpers_match_torch():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(10000).astype(np.float32) * 10,
                        np.array([0.0, -0.0, np.inf, -np.inf, 1 + 2 ** -8, 1 + 3 * 2 ** -8],
                                 np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(f32_to_bf16_bits(x), want)
    np.testing.assert_array_equal(
        bf16_bits_to_f32(want), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    assert np.isnan(bf16_bits_to_f32(f32_to_bf16_bits(np.array([np.nan], np.float32)))).all()


def test_init_is_seeded_and_shaped():
    m = build_model(reduced(get_config("stablelm-3b")))
    a, b = m.init(3, device="cpu"), m.init(3, device="cpu")
    fa, fb = params_to_flat(a), params_to_flat(b)
    assert {(k, v.shape, str(v.dtype)) for k, v in fa.items()} == _template_set(m.param_shapes())
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    assert float(np.abs(fa["blocks/pos0/wq"]).mean()) > 0
