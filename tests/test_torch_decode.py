"""The port's prefill and decode against the JAX package's: decode attention,
the SSM decode step and conv step, prefill's logits and cache, a decode step
from a JAX cache carried across, the port's own prefill → decode against its
teacher-forced forward, the cache layout, and the step builders.  Inputs
come from numpy seeds; everything runs in float32 on the CPU unless a test
says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
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
from repro.models.attention import decode_attention as jax_decode_attention  # noqa: E402
from repro.models.ssm import conv_step as jax_conv_step  # noqa: E402
from repro.models.ssm import ssd_decode_step as jax_ssd_decode_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat, to_tensor  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402
from repro_torch.models.ssm import conv_step, ssd_decode_step  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)    # f32, summation order only
MODEL = dict(rtol=1e-4, atol=1e-4)  # a whole f32 model, as test_torch_models.py

# reduced configurations: MHA + LayerNorm, GQA, MQA with scaled
# embeddings, local/global with both softcaps, the workload model at full
# width, the SSM, MoE (silu and gelu; capacity factor 8.0, drop-free), the
# hybrid, the encoder-decoder (over stub frames) and the VLM prefix-LM
# (after stub patches): with faas-bench, all ten ARCHS of configs/
ARCHS = [
    ("stablelm-3b", True),
    ("mistral-nemo-12b", True),
    ("gemma-2b", True),
    ("gemma2-27b", True),
    ("faas-bench", False),
    ("mamba2-780m", True),
    ("olmoe-1b-7b", True),
    ("grok-1-314b", True),
    ("jamba-v0.1-52b", True),
    ("whisper-small", True),
    ("paligemma-3b", True),
]
N_FRAMES = 16  # whisper's stub frames, as tests/test_models.py's TestArchSmoke


def _t(a, dtype=torch.float32):
    return to_tensor(np.asarray(a), dtype, "cpu")


# ------------------------------------------------------------ decode attention

# (b, nh, nkv, S, hd, pos, window, softcap)
DECODE_ATTN = {
    "gqa_4to1": (2, 8, 2, 64, 32, 40, 0, 0.0),
    "mha_last_slot": (1, 4, 4, 48, 16, 47, 0, 0.0),
    "window_16": (2, 4, 2, 64, 32, 50, 16, 0.0),
    "softcap_50": (1, 4, 2, 64, 32, 20, 0, 50.0),
    "mqa_pos_0": (2, 4, 1, 32, 32, 0, 0, 0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_ATTN))
def test_decode_attention_matches_jax(name, dtype):
    """f32 2e-5 (summation order); a bf16 cache and query: the weights are
    cast to bf16 before P·V in both, the output rounds to bf16 → 2e-2."""
    b, nh, nkv, S, hd, pos, window, cap = DECODE_ATTN[name]
    rng = np.random.default_rng(S + pos)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.standard_normal((b, 1, nh, hd)).astype(np.float32).astype(np_dt)
    k, v = (rng.standard_normal((b, S, nkv, hd)).astype(np.float32).astype(np_dt)
            for _ in range(2))
    kw = dict(scale=hd ** -0.5, window=window, logit_softcap=cap)
    want = jax_decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(pos, jnp.int32), **kw)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), pos, **kw)
    assert got.dtype == tdt and tuple(got.shape) == (b, 1, nh, hd)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # pos as a one-element tensor gives the same
    again = decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                             torch.tensor([pos], dtype=torch.int32), **kw)
    assert torch.equal(again, got)


# ---------------------------------------------------------------- SSM decode

def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(11)
    b, nh, hd, ds = 2, 4, 16, 8
    state = rng.standard_normal((b, nh, hd, ds)).astype(np.float32)
    x = rng.standard_normal((b, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    B, C = (rng.standard_normal((b, ds)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal((nh,)).astype(np.float32)
    args = (state, x, dt, A, B, C, D)
    want_y, want_st = jax_ssd_decode_step(*(jnp.asarray(a) for a in args))
    got_y, got_st = ssd_decode_step(*(torch.from_numpy(a) for a in args))
    assert got_st.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_step_matches_jax(dtype):
    """The window keeps the pre-conv inputs; y in f32 2e-5, bf16 one ulp."""
    rng = np.random.default_rng(12)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    st = rng.standard_normal((2, 3, 24)).astype(np.float32).astype(np_dt)
    x = rng.standard_normal((2, 24)).astype(np.float32).astype(np_dt)
    w = (rng.standard_normal((4, 24)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    want_y, want_st = jax_conv_step(*(jnp.asarray(a) for a in (st, x, w, bias)))
    got_y, got_st = conv_step(_t(st, tdt), _t(x, tdt), torch.from_numpy(w),
                              torch.from_numpy(bias))
    tol = F32 if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32), **tol)
    np.testing.assert_array_equal(got_st.float().numpy(), np.asarray(want_st, np.float32))


# ------------------------------------------------------- prefill and decode

def _models(name, reduce, seed=0):
    jcfg = jax_config(name)
    tcfg = get_config(name)
    if reduce:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(seed)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, params_from_flat(flat, "cpu", template=tm.param_shapes())


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def _prefix(cfg, b, seed=0):
    """Stub frame (encoder-decoder) or patch (VLM) embeddings, normal x
    0.02 as in tests/test_models.py, or None for the other families."""
    n = N_FRAMES if cfg.is_encoder_decoder else cfg.num_prefix_tokens
    if not n:
        return None
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(np.float32)


def _offset(cfg) -> int:
    """The decode position of text token 0: after a VLM prefix."""
    return 0 if cfg.is_encoder_decoder else cfg.num_prefix_tokens


def _enc_len(cfg) -> int:
    return N_FRAMES if cfg.is_encoder_decoder else 0


def _jbatch(toks, pe):
    return JBatch(tokens=jnp.asarray(toks), prefix_embeds=None if pe is None else jnp.asarray(pe))


def _batch(toks, pe):
    return Batch(tokens=torch.from_numpy(toks),
                 prefix_embeds=None if pe is None else torch.from_numpy(pe))


def _assert_cache_close(got, want, tol):
    """Every leaf of the port's cache against JAX's, by flat path."""
    g = params_to_flat(got)
    w = flatten_pytree(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].shape == w[path].shape, path
        assert g[path].dtype == w[path].dtype, path
        np.testing.assert_allclose(g[path], w[path], err_msg=path, **tol)


PROMPT, CACHE_LEN = 32, 48


@pytest.mark.parametrize("name,reduce", ARCHS)
def test_prefill_matches_jax(name, reduce):
    """Last-token logits (b, 1, V) and every cache leaf, f32 → 1e-4."""
    jm, jparams, tm, params = _models(name, reduce)
    toks = _tokens(jm.cfg.vocab_size, 2, PROMPT)
    pe = _prefix(tm.cfg, 2)
    want_l, want_c = jm.prefill(jparams, _jbatch(toks, pe), CACHE_LEN)
    batch = {"tokens": torch.from_numpy(toks)}
    if pe is not None:
        batch["prefix_embeds"] = torch.from_numpy(pe)
    got_l, got_c = make_prefill_step(tm, CACHE_LEN)(params, batch)
    assert tuple(got_l.shape) == (2, 1, jm.cfg.vocab_size)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **MODEL)
    _assert_cache_close(got_c, want_c, MODEL)


@pytest.mark.parametrize("name,reduce", ARCHS)
def test_decode_step_from_jax_cache_matches_jax(name, reduce):
    """A cache from JAX's prefill, carried across with ``init_cache(...,
    device="meta")`` as the template, then two decode steps in each
    package: logits and the updated cache, f32 → 1e-4."""
    jm, jparams, tm, params = _models(name, reduce, seed=1)
    toks = _tokens(jm.cfg.vocab_size, 2, PROMPT + 2, seed=1)
    pe, off = _prefix(tm.cfg, 2, seed=1), _offset(tm.cfg)
    _, jcache = jm.prefill(jparams, _jbatch(toks[:, :PROMPT], pe), CACHE_LEN)
    flat = flatten_pytree(jax.tree.map(np.asarray, jcache))
    template = tm.init_cache(2, CACHE_LEN, enc_len=_enc_len(tm.cfg), device="meta")
    cache = params_from_flat(flat, "cpu", template=template)
    serve = make_serve_step(tm)
    for pos in (PROMPT, PROMPT + 1):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                      jnp.asarray(pos + off, jnp.int32))
        got, cache = serve(params, cache, torch.from_numpy(toks[:, pos]), pos + off)
        assert tuple(got.shape) == (2, jm.cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    _assert_cache_close(cache, jcache, MODEL)


@pytest.mark.parametrize("name,reduce", ARCHS)
def test_prefill_then_decode_matches_forward(name, reduce):
    """The port alone (the analogue of tests/test_models.py's
    test_prefill_decode_matches_forward): prefill s - 3 tokens, decode the
    last three teacher-forced; each step's logits equal the forward's row,
    f32 → 1e-4.  A VLM prefix shifts the decode positions by its length
    (pos = s - 1 + prefix, as there)."""
    _, _, tm, params = _models(name, reduce, seed=2)
    s = PROMPT
    np_toks = _tokens(tm.cfg.vocab_size, 2, s, seed=2)
    pe, off = _prefix(tm.cfg, 2, seed=2), _offset(tm.cfg)
    toks = torch.from_numpy(np_toks)
    full = tm.logits(params, _batch(np_toks, pe))
    logits, cache = tm.prefill(params, _batch(np_toks[:, :s - 3], pe), CACHE_LEN)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, s - 4].numpy(), **MODEL)
    for pos in range(s - 3, s):
        logits, cache = tm.decode_step(params, cache, toks[:, pos], pos + off)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **MODEL)


@pytest.mark.parametrize("name,reduce", ARCHS)
def test_init_cache_layout_matches_jax(name, reduce):
    jm, _, tm, _ = _models(name, reduce)
    enc = _enc_len(tm.cfg)
    want = {(p, a.shape, str(a.dtype)) for p, a in flatten_pytree(
        jax.tree.map(np.asarray, jm.init_cache(2, CACHE_LEN, enc_len=enc))).items()}
    meta = tm.init_cache(2, CACHE_LEN, enc_len=enc, device="meta")
    got = {(p, a.shape, str(a.dtype)) for p, a in params_to_flat(
        tm.init_cache(2, CACHE_LEN, device="cpu", enc_len=enc)).items()}
    assert got == want
    assert all(t.device.type == "meta" for d in meta.values() for t in d.values())
    bf16 = tm.init_cache(1, 8, "bfloat16", device="meta")
    for d in bf16.values():
        for leaf, t in d.items():
            assert t.dtype == (torch.float32 if leaf == "ssm" else torch.bfloat16)


def test_bf16_prefill_then_decode_close_to_forward():
    """bf16 weights: decode casts the softmax weights to bf16 before P·V as
    JAX does, the forward's flash path keeps them in f32; logits stay
    within bf16 precision of the forward's rows (5e-2, as the bf16 logits
    test of test_torch_models.py)."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="bfloat16")
    tm = build_model(cfg)
    params = tm.init(4, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 1, 24, seed=4))
    full = tm.logits(params, Batch(tokens=toks))
    _, cache = tm.prefill(params, Batch(tokens=toks[:, :20]), 32)
    assert cache["pos0"]["k"].dtype == torch.bfloat16
    for pos in range(20, 24):
        logits, cache = tm.decode_step(params, cache, toks[:, pos], pos)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=5e-2, atol=5e-2)


def test_cache_holds_rotated_keys_and_pre_conv_inputs():
    """The prefill cache holds k after RoPE (the forward's k at each
    position) and, for mamba, the last pre-conv xBC rows."""
    from repro_torch.models.layers import apply_norm, apply_rope
    _, _, tm, params = _models("stablelm-3b", True, seed=3)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 1, 8, seed=3))
    _, cache = tm.prefill(params, Batch(tokens=toks), 16)
    p0 = {k: v[0] for k, v in params["blocks"]["pos0"].items() if not isinstance(v, dict)}
    p0["ln1"] = {k: v[0] for k, v in params["blocks"]["pos0"]["ln1"].items()}
    x = apply_norm(tm._embed(params, toks), p0["ln1"], tm.cfg.norm)
    k = apply_rope(torch.einsum("bld,dgk->blgk", x, p0["wk"]), torch.arange(8),
                   tm.cfg.rope_theta)
    np.testing.assert_allclose(cache["pos0"]["k"][0, :, :8].numpy(), k.numpy(), **F32)
    assert not cache["pos0"]["k"][0, :, 8:].any()

    _, _, sm, sp = _models("mamba2-780m", True, seed=3)
    toks = torch.from_numpy(_tokens(sm.cfg.vocab_size, 1, 32, seed=3))
    _, cache = sm.prefill(sp, Batch(tokens=toks), 48)
    m0 = {k: v[0] for k, v in sp["blocks"]["pos0"].items() if not isinstance(v, dict)}
    ln1 = {k: v[0] for k, v in sp["blocks"]["pos0"]["ln1"].items()}
    x = apply_norm(sm._embed(sp, toks), ln1, sm.cfg.norm)
    xbc = torch.einsum("bld,de->ble", x, m0["w_xBC"])
    width = sm.cfg.ssm_conv
    np.testing.assert_allclose(cache["pos0"]["conv"][0].numpy(),
                               xbc[:, -(width - 1):].numpy(), **F32)


def test_decode_position_outside_the_cache_raises():
    """JAX's dynamic_update_slice clamps such a write to the last slot; the
    port refuses it."""
    _, _, tm, params = _models("stablelm-3b", True)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 1, 8))
    _, cache = tm.prefill(params, Batch(tokens=toks), 8)
    for pos in (8, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            tm.decode_step(params, cache, toks[:, 0], pos)
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill(params, Batch(tokens=toks), 4)
