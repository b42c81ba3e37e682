"""The port's MoE FFN against the JAX package's ``moe_ffn``: output, aux
loss, top-k choices and the set of kept (token, choice) pairs, over expert
counts, capacities (ample to dropping), groups, activations and dtypes;
token-major slot priority on a case built by hand; the drop-free decode
capacity; a dense oracle and dropped rows.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402

D, F = 16, 32
ACTS = {"silu_gated": ("silu", True), "gelu_gated": ("gelu", True),
        "silu_ungated": ("silu", False)}


def _cfgs(E, K, cf, act="silu_gated"):
    hidden_act, gated = ACTS[act]
    kw = dict(name="t", family="moe", num_layers=1, d_model=D, num_heads=2,
              num_kv_heads=2, d_ff=F, vocab_size=64, num_experts=E,
              num_experts_per_tok=K, moe_d_ff=F, capacity_factor=cf,
              hidden_act=hidden_act, mlp_gated=gated)
    return JaxConfig(**kw), ModelConfig(**kw)


def _params(E, seed, gated=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "w_in": (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32),
         "w_out": (rng.standard_normal((E, F, D)) * 0.3).astype(np.float32)}
    if gated:
        p["w_gate"] = (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)
    return p


def _run_jax(params, x, cfg, monkeypatch, **kw):
    """JAX's moe_ffn under ``jit``; its top-k ids and slots are the values of
    its own calls of ``jax.lax.top_k`` and ``jnp.take_along_axis``, returned
    from the same trace."""
    seen = {}
    top_k, take = jax.lax.top_k, jnp.take_along_axis

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["idx"] = out[1]
        return out

    def rec_take(a, i, axis, **more):
        out = take(a, i, axis, **more)
        seen["slot"] = out[..., 0]
        return out

    def run(p, xj):
        y, aux = jax_moe_ffn(p, xj, cfg, **kw)
        return y, aux, seen["idx"], seen["slot"]

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "take_along_axis", rec_take)
    out = jax.jit(run)({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    monkeypatch.undo()
    y, aux, idx, slot = (np.asarray(a) for a in out)
    return y.astype(np.float32), float(aux), idx, slot


def _run_port(params, x, cfg, dtype=torch.float32, **kw):
    """The port's moe_ffn; its top-k ids and kept set from ``dispatch``."""
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else dtype)
          for k, v in params.items()}
    with torch.no_grad(), moe.recording([]) as calls:
        y, aux = moe_ffn(tp, torch.from_numpy(x.astype(np.float32)).to(dtype), cfg, **kw)
    assert y.dtype == dtype and aux.dtype == torch.float32
    return y.float().numpy(), float(aux), calls[-1]["idx"].numpy(), calls[-1]["keep"].numpy()


def _capacity(cf, t, G, E, K):
    """JAX's Cg, with its fallback to one group."""
    if t % G != 0 or t // G < E // K:
        G = 1
    return max(1, int(cf * (t // G) * K / E))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [64.0, 1.25, 1.0, 0.25])
@pytest.mark.parametrize("E,K", [(4, 1), (8, 2), (64, 8)])
def test_moe_ffn_matches_jax(E, K, cf, groups, act, dtype, monkeypatch):
    """y: f32 1e-5 (summation order only); bf16 x and expert weights, the
    router f32 in both: the expert products and the activation round to
    bf16 at other places in XLA and PyTorch → 3e-2 of max|y|, about four
    bf16 ulps.  aux: 1e-6 in both.  The top-k choices and the kept set are
    equal, not close."""
    jcfg, tcfg = _cfgs(E, K, cf, act)
    params = _params(E, seed=E + K, gated=ACTS[act][1])
    b, s = 2, 16
    x = np.random.default_rng(int(cf * 4) + groups).standard_normal((b, s, D))
    if dtype == "bfloat16":
        params = {k: v if k == "router" else v.astype(ml_dtypes.bfloat16)
                  for k, v in params.items()}
        x = x.astype(ml_dtypes.bfloat16)
        tdt = torch.bfloat16
    else:
        x = x.astype(np.float32)
        tdt = torch.float32
    want, want_aux, want_idx, want_slot = _run_jax(params, x, jcfg, monkeypatch,
                                                   groups=groups)
    tp = {k: np.asarray(v, np.float32) for k, v in params.items()}
    got, aux, idx, keep = _run_port(tp, np.asarray(x, np.float32), tcfg,
                                    dtype=tdt, groups=groups)
    Cg = _capacity(cf, b * s, groups, E, K)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(keep, want_slot < Cg)
    if cf <= 1.0:
        assert not keep.all()           # the dropping capacities drop
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())
    assert abs(aux - want_aux) <= 1e-6


def test_groups_fall_back_to_one():
    """Groups that do not divide the tokens, or leave a group fewer than
    E // K tokens, give the one-group result."""
    _, tcfg = _cfgs(8, 2, 1.0)
    params = {k: torch.from_numpy(v) for k, v in _params(8, seed=1).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 12, D)).astype(np.float32))
    one, aux1 = moe_ffn(params, x, tcfg, groups=1)
    for g in (5, 4):  # 12 % 5 != 0; 12 / 4 = 3 tokens < E / K = 4
        y, aux = moe_ffn(params, x, tcfg, groups=g)
        assert torch.equal(y, one) and torch.equal(aux, aux1)


def test_token_major_priority_on_a_hand_built_case(monkeypatch):
    """Two tokens, two experts, both chosen by each token, one slot per
    expert.  Token 0 prefers expert 0 and token 1 expert 1.  Token-major:
    token 0 takes both slots and token 1 is dropped whole (its output is
    exactly zero).  k-major would keep each token's first choice instead."""
    E, K = 2, 2
    jcfg, tcfg = _cfgs(E, K, 0.5)                # Cg = int(0.5 * 2 * 2 / 2) = 1
    params = _params(E, seed=3)
    params["router"] = np.zeros((D, E), np.float32)
    params["router"][0, 0] = params["router"][1, 1] = 2.0
    x = np.zeros((1, 2, D), np.float32)
    x[0, 0, 0] = x[0, 1, 1] = 1.0
    want, _, want_idx, want_slot = _run_jax(params, x, jcfg, monkeypatch)
    got, _, idx, keep = _run_port(params, x, tcfg)
    np.testing.assert_array_equal(idx[0], [[0, 1], [1, 0]])
    np.testing.assert_array_equal(keep[0], [True, True, False, False])
    np.testing.assert_array_equal(keep, want_slot < 1)
    np.testing.assert_array_equal(idx, want_idx)
    assert not got[0, 1].any() and got[0, 0].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    k_major = moe.k_major_slots(torch.from_numpy(idx), E).numpy() < 1
    np.testing.assert_array_equal(k_major[0], [True, False, True, False])
    assert not np.array_equal(k_major, keep)


def test_k_major_priority_control_moves_the_drops():
    """The checks' fault, on the hand-built case: inside ``k_major_priority``
    the port keeps each token's first choice (token 1 is no longer dropped
    whole); on leaving it the token-major order is back."""
    E, K = 2, 2
    _, tcfg = _cfgs(E, K, 0.5)
    params = _params(E, seed=3)
    params["router"] = np.zeros((D, E), np.float32)
    params["router"][0, 0] = params["router"][1, 1] = 2.0
    x = np.zeros((1, 2, D), np.float32)
    x[0, 0, 0] = x[0, 1, 1] = 1.0
    with moe.k_major_priority():
        bad, _, _, bad_keep = _run_port(params, x, tcfg)
    good, _, _, keep = _run_port(params, x, tcfg)
    np.testing.assert_array_equal(bad_keep[0], [True, False, True, False])
    np.testing.assert_array_equal(keep[0], [True, True, False, False])
    assert bad[0, 1].any() and not good[0, 1].any()


@pytest.mark.parametrize("E,K", [(4, 1), (8, 2), (64, 8)])
@pytest.mark.parametrize("tokens", [1, 2])
def test_decode_capacity_is_drop_free(E, K, tokens):
    """The decode step's capacity E / K keeps every choice of one or two
    tokens: the result equals the ample-capacity one."""
    _, tcfg = _cfgs(E, K, 64.0)
    params = {k: torch.from_numpy(v) for k, v in _params(E, seed=E).items()}
    x = torch.from_numpy(
        np.random.default_rng(tokens).standard_normal((tokens, 1, D)).astype(np.float32))
    ample, _ = moe_ffn(params, x, tcfg)
    decode, _ = moe_ffn(params, x, tcfg, capacity_factor=float(E) / K)
    np.testing.assert_allclose(decode.numpy(), ample.numpy(), rtol=1e-6, atol=1e-7)


def test_ample_capacity_matches_dense():
    """The analogue of tests/test_models.py's TestMoE: with capacity ≥
    tokens, index dispatch equals the every-expert computation weighted by
    the router."""
    E, K, t = 4, 2, 8
    _, tcfg = _cfgs(E, K, 64.0)
    rng = np.random.default_rng(6)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "w_in": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
         "w_gate": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
         "w_out": (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((1, t, D)).astype(np.float32)
    y, aux = moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                     tcfg)
    logits = x[0] @ p["router"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1)[:, :K]
    y_ref = np.zeros((t, D), np.float32)
    for i in range(t):
        g = probs[i, top[i]] / probs[i, top[i]].sum()
        for j, e in enumerate(top[i]):
            h = x[0, i] @ p["w_in"][e]
            gt = x[0, i] @ p["w_gate"][e]
            y_ref[i] += g[j] * ((gt / (1 + np.exp(-gt))) * h) @ p["w_out"][e]
    np.testing.assert_allclose(y[0].numpy(), y_ref, rtol=1e-4, atol=1e-4)
    assert np.isfinite(float(aux))


def test_capacity_drops_tokens():
    """A token whose every choice is dropped comes out exactly zero."""
    _, tcfg = _cfgs(2, 1, 0.25)
    rng = np.random.default_rng(7)
    p = {"router": rng.standard_normal((D, 2)).astype(np.float32),
         "w_in": rng.standard_normal((2, D, F)).astype(np.float32),
         "w_gate": rng.standard_normal((2, D, F)).astype(np.float32),
         "w_out": rng.standard_normal((2, F, D)).astype(np.float32)}
    x = rng.standard_normal((1, 16, D)).astype(np.float32)
    y, _ = moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tcfg)
    zero = (y[0] == 0).all(-1)
    # Cg = int(0.25 * 16 / 2) = 2 slots per expert: 4 tokens kept, 12 zero
    assert int(zero.sum()) == 12
    assert not (y[0][~zero] == 0).all(-1).any()
