"""The port's dense model against the JAX package's: the parameter template
(paths, shapes, dtypes), logits from JAX-carried weights, the unported
families, and the bfloat16 bit-pattern conversion."""

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
])
def test_param_shapes_match_jax(name, reduce):
    cfg = get_config(name)
    cfg = reduced(cfg) if reduce else cfg
    shapes = build_model(cfg).param_shapes()
    assert all(v.device.type == "meta" for v in jax.tree.leaves(shapes))
    assert _template_set(shapes) == _jax_template_set(name, reduce)


@pytest.mark.parametrize("name,roadmap", [
    ("olmoe-1b-7b", "MoE"), ("mamba2-780m", "SSM"), ("whisper-small", "enc-dec"),
    ("jamba-v0.1-52b", "SSM"),
])
def test_unported_families_raise(name, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        build_model(reduced(get_config(name))).param_shapes()


def _carry(cfg_name, reduce, seq, seed=0, dtype=None):
    jcfg = jax_config(cfg_name)
    jcfg = jax_reduced(jcfg) if reduce else jcfg
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jm = jax_build(jcfg)
    jparams = jm.init(seed)
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, seq), dtype=np.int32)
    want = np.asarray(jm.logits(jparams, JBatch(tokens=jax.numpy.asarray(tokens))), np.float32)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    tcfg = get_config(cfg_name)
    tcfg = reduced(tcfg) if reduce else tcfg
    if dtype:
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
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
])
def test_logits_from_jax_weights_match(name, reduce, seq):
    """f32 on the CPU; only the summation order differs → rtol/atol 1e-4."""
    got, want, _, _ = _carry(name, reduce, seq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


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
