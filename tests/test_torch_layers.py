"""The port's layers and attention oracles against the JAX package's, on the
same numpy-seeded inputs (float32 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# float32 elementwise math: the two libraries' exp / tanh / rsqrt differ by
# an ulp or so, which a few chained operations grow to ~1e-6
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 64))
    sj, st = _pair(rng, (64,))
    bj, bt = _pair(rng, (64,))
    pj, pt = {"scale": sj, "bias": bj}, {"scale": st, "bias": bt}
    _close(tl.apply_norm(xt, pt, norm), jl.apply_norm(xj, pj, norm))


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_activation(kind):
    xj, xt = _pair(np.random.default_rng(1), (4, 33))
    _close(tl.activation(xt, kind), jl.activation(xj, kind))


def test_softcap():
    xj, xt = _pair(np.random.default_rng(2), (3, 17))
    xj, xt = xj * 40, xt * 40
    _close(tl.softcap(xt, 20.0), jl.softcap(xj, 20.0))
    _close(tl.softcap(xt, 0.0), jl.softcap(xj, 0.0))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (2, 40, 3, 32))
    pos = np.arange(40, dtype=np.int32)
    if batched:
        pos = np.stack([pos, pos + 7])
    _close(tl.apply_rope(xt, torch.from_numpy(pos), 10000.0),
           jl.apply_rope(xj, jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"), (False, "gelu")])
def test_mlp(gated, act):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, (2, 6, 48))
    names = ["w_in", "w_out"] + (["w_gate"] if gated else [])
    shapes = {"w_in": (48, 96), "w_out": (96, 48), "w_gate": (48, 96)}
    pj, pt = {}, {}
    for n in names:
        pj[n], pt[n] = _pair(rng, shapes[n])
    _close(tl.mlp(pt, xt, act, gated), jl.mlp(pj, xj, act, gated))


# (b, S, nh, nkv, hd, causal, window, softcap, prefix_len, q_offset, block)
ATTN_CASES = {
    "causal": (2, 64, 4, 4, 16, True, 0, 0.0, 0, 0, 16),
    "bidirectional": (1, 48, 4, 4, 16, False, 0, 0.0, 0, 0, 16),
    "window": (1, 64, 4, 2, 16, True, 12, 0.0, 0, 0, 16),
    "softcap": (1, 64, 4, 4, 16, True, 0, 20.0, 0, 0, 32),
    "gqa": (2, 32, 8, 2, 8, True, 0, 0.0, 0, 0, 16),
    "mqa": (1, 32, 4, 1, 32, True, 0, 0.0, 0, 0, 8),
    "prefix": (1, 32, 2, 2, 16, True, 0, 0.0, 8, 0, 16),
    "q_offset": (1, 16, 2, 2, 16, True, 0, 0.0, 0, 16, 16),
}


def _attn_inputs(case):
    b, S, nh, nkv, hd = case[:5]
    rng = np.random.default_rng(5)
    q = _pair(rng, (b, S, nh, hd))
    k = _pair(rng, (b, S + case[9], nkv, hd))
    v = _pair(rng, (b, S + case[9], nkv, hd))
    kw = dict(scale=hd ** -0.5, causal=case[5], window=case[6],
              logit_softcap=case[7], prefix_len=case[8], q_offset=case[9])
    return q, k, v, kw


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_blockwise_attention_matches_jax(name):
    """Online softmax over blocks, f32: summation order differs → 2e-5."""
    case = ATTN_CASES[name]
    (qj, qt), (kj, kt), (vj, vt), kw = _attn_inputs(case)
    blk = case[10]
    out_t = tatt.blockwise_attention(qt, kt, vt, q_block=blk, kv_block=blk, **kw)
    out_j = jatt.blockwise_attention(qj, kj, vj, q_block=blk, kv_block=blk, **kw)
    _close(out_t, out_j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_naive_attention_matches_jax(name):
    (qj, qt), (kj, kt), (vj, vt), kw = _attn_inputs(ATTN_CASES[name])
    out_t = tatt.naive_attention(qt, kt, vt, **kw)
    out_j = jatt.naive_attention(qj, kj, vj, **kw)
    _close(out_t, out_j, rtol=2e-5, atol=2e-5)
    # and the port's two oracles agree with each other
    blk = ATTN_CASES[name][10]
    _close(tatt.blockwise_attention(qt, kt, vt, q_block=blk, kv_block=blk, **kw),
           out_t.numpy(), rtol=2e-5, atol=2e-5)


def test_bf16_attention_oracles_match_jax():
    """bf16 inputs: p is rounded to bf16 before P·V in both → 2e-2."""
    rng = np.random.default_rng(6)
    x = [rng.standard_normal((1, 32, 4, 16)).astype(np.float32) for _ in range(3)]
    j = [jnp.asarray(a, jnp.bfloat16) for a in x]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in x]
    kw = dict(scale=0.25, causal=True, q_block=16, kv_block=16)
    out_t = tatt.blockwise_attention(*t, **kw).float().numpy()
    out_j = np.asarray(jatt.blockwise_attention(*j, **kw), np.float32)
    np.testing.assert_allclose(out_t, out_j, rtol=2e-2, atol=2e-2)
