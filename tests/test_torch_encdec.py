"""The port's encoder-decoder (whisper-small) and VLM prefix-LM (paligemma-3b)
against the JAX package's, reduced, on the CPU: logits, prefill logits and
every cache leaf (the cross-attention's ``ck`` and ``cv`` included), decode
from a JAX cache, the port's own prefill → decode against its forward,
whisper's sinusoidal positions bit for bit, and controls that the checks
see the encoder's bidirectional attention, the cached cross keys and the
prefix-LM mask.  Inputs come from numpy seeds, JAX's weights cross through
``convert``; float32 at 1e-4, bf16 at the tolerance of
tests/test_torch_decode.py.

JAX's ``blockwise_attention`` needs a sequence that its 512-row blocks
divide (``repro/models/attention.py:70``), so the frame counts here are 16
and 32; ``chip_smoke.py`` holds whisper's 1500 frames against the port's
own CPU path."""

import contextlib
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
from repro.models.layers import sinusoidal_positions as jax_sinusoidal  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402

MODEL = dict(rtol=1e-4, atol=1e-4)  # a whole f32 model, summation order only
BF16 = dict(rtol=5e-2, atol=5e-2)   # bf16 weights, as tests/test_torch_decode.py

# (arch, stub embeddings before the text): whisper's frames, paligemma's
# 8 patches (the reduced config's, deliberately not a multiple of a tile)
CASES = [("whisper-small", 16), ("whisper-small", 32), ("paligemma-3b", 8)]
IDS = ["whisper-16-frames", "whisper-32-frames", "paligemma-prefix-8"]
TEXT, CACHE_LEN = 24, 40


def _models(name, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_reduced(jax_config(name)), **overrides)
    tcfg = dataclasses.replace(reduced(get_config(name)), **overrides)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(seed)
    flat = flatten_pytree(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, params_from_flat(flat, "cpu", template=tm.param_shapes())


def _inputs(cfg, n_prefix, b=2, s=TEXT, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    pe = (rng.standard_normal((b, n_prefix, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, pe


def _jb(toks, pe):
    return JBatch(tokens=jnp.asarray(toks), prefix_embeds=jnp.asarray(pe))


def _tb(toks, pe, dtype=torch.float32):
    return Batch(tokens=torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pe).to(dtype))


def _offset(cfg, n_prefix):
    """Decode position of text token 0: after the VLM prefix; whisper's
    text positions start at 0 (the frames are the encoder's)."""
    return 0 if cfg.is_encoder_decoder else n_prefix


def _flat(tree):
    return flatten_pytree(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------ positions

@pytest.mark.parametrize("seq,d_model", [(1, 768), (448, 768), (1500, 768), (24, 128),
                                         (7, 5), (3, 2)])
def test_sinusoidal_positions_bit_equal(seq, d_model):
    """The numpy table of JAX's layers.py, bit for bit (its divisor
    max(1, d_model // 2 - 1) kept), and the rows the model adds, from a
    table it grows to the longest length asked."""
    got = sinusoidal_positions(seq, d_model)
    want = jax_sinusoidal(seq, d_model)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    tm = build_model(dataclasses.replace(reduced(get_config("whisper-small")),
                                         d_model=d_model))
    for first in (seq, 2 * seq + 3):  # the table as long as asked, or longer
        tm._pos_tables.clear()
        tm._positions(first, torch.zeros(()))
        t = tm._positions(seq, torch.zeros(()))
        np.testing.assert_array_equal(t.numpy(), want)
    b = tm._positions(seq, torch.zeros((), dtype=torch.bfloat16))
    np.testing.assert_array_equal(
        b.float().numpy(), np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("name,n_prefix", CASES, ids=IDS)
def test_logits_match_jax(name, n_prefix):
    jm, jparams, tm, params = _models(name)
    toks, pe = _inputs(tm.cfg, n_prefix)
    want = np.asarray(jm.logits(jparams, _jb(toks, pe)), np.float32)
    with torch.no_grad():
        got = tm.logits(params, _tb(toks, pe))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, TEXT, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **MODEL)


@pytest.mark.parametrize("name,n_prefix", CASES, ids=IDS)
def test_prefill_matches_jax(name, n_prefix):
    """Last-token logits and every cache leaf by flat path: self-attention
    k and v padded to the cache, whisper's ck and cv unpadded."""
    jm, jparams, tm, params = _models(name, seed=1)
    toks, pe = _inputs(tm.cfg, n_prefix, seed=1)
    want_l, want_c = jm.prefill(jparams, _jb(toks, pe), CACHE_LEN)
    got_l, got_c = make_prefill_step(tm, CACHE_LEN)(
        params, {"tokens": torch.from_numpy(toks), "prefix_embeds": torch.from_numpy(pe)})
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **MODEL)
    g, w = params_to_flat(got_c), _flat(want_c)
    assert sorted(g) == sorted(w)
    if tm.cfg.is_encoder_decoder:
        assert g["pos0/ck"].shape == (tm.cfg.num_decoder_layers, 2, n_prefix,
                                      tm.cfg.num_kv_heads, tm.cfg.head_dim)
    for path in w:
        assert g[path].shape == w[path].shape and g[path].dtype == w[path].dtype, path
        np.testing.assert_allclose(g[path], w[path], err_msg=path, **MODEL)


@pytest.mark.parametrize("name,n_prefix", CASES, ids=IDS)
def test_decode_from_jax_cache_matches_jax(name, n_prefix):
    """JAX's prefill cache carried across with ``init_cache(...,
    enc_len, device="meta")`` as the template, two decode steps in each
    package: logits and every updated leaf."""
    jm, jparams, tm, params = _models(name, seed=2)
    toks, pe = _inputs(tm.cfg, n_prefix, s=TEXT + 2, seed=2)
    off = _offset(tm.cfg, n_prefix)
    _, jcache = jm.prefill(jparams, _jb(toks[:, :TEXT], pe), CACHE_LEN)
    enc_len = n_prefix if tm.cfg.is_encoder_decoder else 0
    template = tm.init_cache(2, CACHE_LEN, enc_len=enc_len, device="meta")
    cache = params_from_flat(_flat(jcache), "cpu", template=template)
    serve = make_serve_step(tm)
    for pos in (TEXT, TEXT + 1):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                      jnp.asarray(pos + off, jnp.int32))
        got, cache = serve(params, cache, torch.from_numpy(toks[:, pos]), pos + off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    g, w = params_to_flat(cache), _flat(jcache)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path, **MODEL)


@pytest.mark.parametrize("name,n_prefix", CASES, ids=IDS)
def test_prefill_then_decode_matches_forward(name, n_prefix):
    """The port alone, as tests/test_models.py's prefill → decode test:
    prefill s - 3 text tokens, decode the last three teacher-forced at
    pos = s - 1 + prefix for the VLM; each step equals the forward's row."""
    _, _, tm, params = _models(name, seed=3)
    toks, pe = _inputs(tm.cfg, n_prefix, seed=3)
    off, s = _offset(tm.cfg, n_prefix), TEXT
    with torch.no_grad():
        full = tm.logits(params, _tb(toks, pe))
        logits, cache = tm.prefill(params, _tb(toks[:, :s - 3], pe), CACHE_LEN)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, s - 4].numpy(), **MODEL)
        for pos in range(s - 3, s):
            logits, cache = tm.decode_step(params, cache, torch.from_numpy(toks[:, pos]),
                                           pos + off)
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **MODEL)


@pytest.mark.parametrize("name,n_prefix", [CASES[0], CASES[2]], ids=[IDS[0], IDS[2]])
def test_bf16_prefill_then_decode_close_to_forward(name, n_prefix):
    """bf16 weights and stub embeddings: decode rounds P to bf16 before
    P·V as JAX does, the forward's flash path keeps it in f32; the logits
    stay within bf16 precision of the forward's rows, and the cache is
    bf16 (ck and cv too)."""
    _, _, tm, params = _models(name, seed=4, dtype="bfloat16")
    toks, pe = _inputs(tm.cfg, n_prefix, seed=4)
    off, s = _offset(tm.cfg, n_prefix), TEXT
    bf = torch.bfloat16
    with torch.no_grad():
        full = tm.logits(params, _tb(toks, pe, bf))
        _, cache = tm.prefill(params, _tb(toks[:, :s - 4], pe, bf), CACHE_LEN)
        assert all(t.dtype == bf for t in cache["pos0"].values())
        for pos in range(s - 4, s):
            logits, cache = tm.decode_step(params, cache, torch.from_numpy(toks[:, pos]),
                                           pos + off)
            assert logits.dtype == torch.float32
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **BF16)


def test_bf16_logits_close_to_jax():
    """bf16 whisper and paligemma: f32 logits within bf16 precision of
    JAX's (the two frameworks round at other places)."""
    for name, n_prefix in (CASES[0], CASES[2]):
        jm, jparams, tm, params = _models(name, seed=5, dtype="bfloat16")
        toks, pe = _inputs(tm.cfg, n_prefix, seed=5)
        pe = pe.astype(ml_dtypes.bfloat16)
        want = np.asarray(jm.logits(jparams, _jb(toks, pe)), np.float32)
        with torch.no_grad():
            got = tm.logits(params, _tb(toks, pe.astype(np.float32), torch.bfloat16))
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **BF16)


# ------------------------------------------------------------ controls

@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def test_paligemma_prefix_zero_differs():
    """With the prefix mask dropped (prefix_len 0 in every attention) the
    patches attend causally among themselves, and the text's logits move
    off JAX's: the parity tests see the prefix-LM mask."""
    jm, jparams, tm, params = _models("paligemma-3b", seed=6)
    toks, pe = _inputs(tm.cfg, 8, seed=6)
    want = np.asarray(jm.logits(jparams, _jb(toks, pe)), np.float32)
    op = transformer.flash_attention_op
    with torch.no_grad(), _patched(transformer, "flash_attention_op",
                                   lambda *a, prefix_len=0, **kw: op(*a, **kw)):
        got = tm.logits(params, _tb(toks, pe)).numpy()
    assert not np.allclose(got, want, **MODEL), np.abs(got - want).max()


def test_whisper_encoder_run_causal_differs():
    jm, jparams, tm, params = _models("whisper-small", seed=7)
    toks, pe = _inputs(tm.cfg, 16, seed=7)
    want = np.asarray(jm.logits(jparams, _jb(toks, pe)), np.float32)
    stack = api.apply_stack
    with torch.no_grad(), _patched(api, "apply_stack",
                                   lambda *a, causal=True, **kw: stack(*a, causal=True, **kw)):
        got = tm.logits(params, _tb(toks, pe)).numpy()
    assert not np.allclose(got, want, **MODEL), np.abs(got - want).max()


def test_whisper_decode_reads_the_cached_cross_keys():
    """Decode attends over the cached ck and cv, not anything recomputed:
    zeroed, they change every step's logits."""
    _, _, tm, params = _models("whisper-small", seed=8)
    toks, pe = _inputs(tm.cfg, 16, seed=8)
    with torch.no_grad():
        _, cache = tm.prefill(params, _tb(toks[:, :TEXT - 1], pe), CACHE_LEN)
        zeroed = {k: {leaf: t.clone() for leaf, t in d.items()} for k, d in cache.items()}
        zeroed["pos0"]["ck"].zero_()
        zeroed["pos0"]["cv"].zero_()
        tok = torch.from_numpy(toks[:, TEXT - 1])
        good, _ = tm.decode_step(params, cache, tok, TEXT - 1)
        bad, _ = tm.decode_step(params, zeroed, tok, TEXT - 1)
    assert not np.allclose(bad.numpy(), good.numpy(), **MODEL)


def test_whisper_refuses_what_it_cannot_take():
    _, _, tm, params = _models("whisper-small")
    toks, pe = _inputs(tm.cfg, 16)
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.logits(params, Batch(tokens=torch.from_numpy(toks)))
    with pytest.raises(TypeError, match="model's dtype"):
        tm.logits(params, _tb(toks, pe, torch.bfloat16))
    _, cache = tm.prefill(params, _tb(toks, pe), CACHE_LEN)
    for pos in (CACHE_LEN, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            tm.decode_step(params, cache, torch.from_numpy(toks[:, 0]), pos)


# ------------------------------------------------------------ layout and convert

def test_encdec_cache_spans_the_decoder_layers():
    """One slot over num_decoder_layers, not the plan's repeat count (which
    counts the encoder's layers): with 2 encoder and 3 decoder layers both
    packages' caches and parameter trees agree."""
    jm, jparams, tm, params = _models("whisper-small", num_decoder_layers=3)
    assert tm.plan.n_repeat == 2
    want = {(p, a.shape, str(a.dtype)) for p, a in _flat(jm.init_cache(2, 8, enc_len=5)).items()}
    got = {(p, a.shape, str(a.dtype))
           for p, a in params_to_flat(tm.init_cache(2, 8, enc_len=5, device="cpu")).items()}
    assert got == want
    assert tm.init_cache(2, 8, enc_len=5, device="meta")["pos0"]["ck"].shape == (3, 2, 5, 4, 32)
    assert params["blocks"]["pos0"]["cq"].shape[0] == 3
    assert params["enc"]["blocks"]["pos0"]["wq"].shape[0] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_encoder_and_cross_leaves(dtype):
    """JAX's whisper tree (enc/blocks, enc/final_norm, the decoder's
    ln_cross, cq, ck, cv, co) crosses to the port and back bit for bit,
    bf16 as its uint16 bits, with no code beyond the template."""
    jcfg = dataclasses.replace(jax_reduced(jax_config("whisper-small")), dtype=dtype)
    tm = build_model(dataclasses.replace(reduced(get_config("whisper-small")), dtype=dtype))
    flat = _flat(jax_build(jcfg).init(9))
    for leaf in ("enc/blocks/pos0/wq", "enc/final_norm/scale", "enc/final_norm/bias",
                 "blocks/pos0/ln_cross/scale", "blocks/pos0/cq", "blocks/pos0/ck",
                 "blocks/pos0/cv", "blocks/pos0/co"):
        assert leaf in flat, leaf
    params = params_from_flat(flat, "cpu", template=tm.param_shapes())
    assert params["blocks"]["pos0"]["ck"].dtype == transformer.torch_dtype(dtype)
    back = params_to_flat(params)
    assert list(back) == list(flat)
    for k, v in flat.items():
        want = v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v
        np.testing.assert_array_equal(back[k], want, err_msg=k)
