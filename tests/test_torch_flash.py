"""The Hopper flash-attention kernel's design, on the CPU.

The kernel (``src/repro_torch/csrc/flash_attention.cu``) runs only on the
card.  What can be checked here is its arithmetic and its launch plan:

- an emulation in plain PyTorch of what the kernel computes, tile by tile:
  float32 products in 3xTF32 (each operand split into hi and lo parts whose
  low 13 mantissa bits are zero, hi.hi + hi.lo + lo.hi), bfloat16 products
  with P rounded to bf16 before P.V, the online softmax over the key tiles
  of the plan's size that the kernel's walk visits for each q tile,
  masked only where the kernel masks.  It is held against the Pallas
  kernel in interpret mode and against the JAX plain versions at the
  kernel tolerances (f32 2e-5, bf16 2e-2), with the prefix-LM mask and
  Sk != S against JAX's ``naive_attention``, and single-term TF32 must
  fail 2e-5: that is why the f32 path splits;
- the tile walk itself (``live_tiles``, ``tile_needs_mask``) over a grid
  of lengths, prefixes and windows: no allowed key skipped, none left
  unmasked;
- the launch plan (``launch_plan``, ``alignment_problem``): every model
  configuration of the port, full and reduced, fits the card's shared
  memory, each plan is an instantiation of the kernel, and what TMA cannot
  read is refused with its reason.
"""

import functools
import re
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models.attention import naive_attention as jax_naive_attention  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    alignment_problem,
    launch_plan,
    live_tiles,
    tile_needs_mask,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------ the emulation

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 mantissa bits cleared: what a TF32 operand keeps."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, arith: str) -> torch.Tensor:
    if arith == "3xtf32":
        ahi, bhi = _tf32(a), _tf32(b)
        alo, blo = _tf32(a - ahi), _tf32(b - bhi)
        return alo @ bhi + ahi @ blo + ahi @ bhi
    if arith == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b  # bf16 values: products exact in f32, f32 sums


def emulate(q, k, v, *, scale, causal, window, softcap, arith, prefix_len=0):
    """The kernel's arithmetic on (b, nh, S, hd) float32 tensors (holding
    bf16 values for ``arith="bf16"``): per q tile of the launch plan, over
    the key tiles its walk visits (``live_tiles``), scores, softcap, the
    masks only on tiles the kernel masks (``tile_needs_mask``), the online
    softmax in f32, P (rounded to bf16 for the bf16 path) times V."""
    b, nh, S, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    dtype = torch.bfloat16 if arith == "bf16" else torch.float32
    plan = launch_plan(dtype, hd)
    tile_k = plan.tile_k
    walk = dict(causal=causal, window=window, prefix_len=prefix_len)
    kx, vx = (x.repeat_interleave(nh // nkv, dim=1) for x in (k, v))
    out = torch.zeros((b, nh, S, hd))
    for q0 in range(0, S, plan.tile_q):
        q_last = min(q0 + plan.tile_q, S) - 1
        qt = q[:, :, q0:q_last + 1]
        rows = qt.shape[2]
        m = torch.full((b, nh, rows, 1), -1e30)
        l = torch.zeros((b, nh, rows, 1))
        acc = torch.zeros((b, nh, rows, hd))
        qp = torch.arange(q0, q_last + 1)[:, None]
        for kt in live_tiles(q0, q_last, Sk, tile_k, **walk):
            k0 = kt * tile_k
            kb, vb = kx[:, :, k0:k0 + tile_k], vx[:, :, k0:k0 + tile_k]
            s = _matmul(qt, kb.transpose(-1, -2), arith) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            if tile_needs_mask(k0, q0, q_last, Sk, tile_k, **walk):
                ok = _allowed(qp, torch.arange(k0, k0 + kb.shape[2])[None, :], **walk)
                s = torch.where(ok, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if arith == "bf16":
                p = p.bfloat16().float()
            acc = acc * alpha + _matmul(p, vb, arith)
            m = m_new
        out[:, :, q0:q_last + 1] = acc / l.clamp_min(1e-30)
    return out


def _allowed(qp, kp, *, causal, window, prefix_len):
    """JAX's ``_mask`` (``repro.models.attention``) over positions."""
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool)
    if causal:
        ok &= (kp <= qp) | (kp < prefix_len)
    if window > 0:
        ok &= qp - kp < window
    return ok


# (b, nh, nkv, S, hd, causal, window, softcap, Pallas block): the Pallas
# kernel needs S % block == 0
PALLAS_CASES = {
    "mha_causal": (2, 4, 4, 128, 32, True, 0, 0.0, 32),
    "bidirectional": (1, 2, 2, 64, 16, False, 0, 0.0, 32),
    "gqa_4to1": (1, 8, 2, 64, 32, True, 0, 0.0, 32),
    "mqa": (2, 4, 1, 64, 32, True, 0, 0.0, 16),
    "window_16": (1, 4, 4, 128, 16, True, 16, 0.0, 32),
    "softcap_20": (1, 4, 2, 64, 32, True, 0, 20.0, 32),
}

# tests/test_torch_cuda.py's FLASH_CASES shapes, (b, nh, nkv, S, hd, causal,
# window, softcap): ragged lengths and other head dims, held against the JAX
# plain version only
CUDA_CASES = {
    "mha_causal": (2, 4, 4, 128, 64, True, 0, 0.0),
    "bidirectional_ragged": (1, 2, 2, 77, 80, False, 0, 0.0),
    "gqa_4to1": (1, 8, 2, 64, 32, True, 0, 0.0),
    "mqa": (2, 4, 1, 37, 32, True, 0, 0.0),
    "window_16": (1, 4, 4, 128, 16, True, 16, 0.0),
    "softcap_20": (1, 4, 2, 64, 32, True, 0, 20.0),
    "head_dim_256": (1, 2, 1, 40, 256, True, 0, 0.0),
    "single_token": (2, 4, 2, 1, 64, True, 0, 0.0),
    "window_crosses_tile_ragged": (1, 4, 2, 200, 64, True, 48, 0.0),
}


def _inputs(case, dtype, seed=0):
    b, nh, nkv, S, hd = case[:5]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, nh, S, hd), (b, nkv, S, hd), (b, nkv, S, hd))]
    if dtype == "bfloat16":
        xs = [x.astype(ml_dtypes.bfloat16) for x in xs]
    kw = dict(scale=hd ** -0.5, causal=case[5], window=case[6], softcap=case[7])
    return xs, kw


def _emulated(xs, kw, dtype, arith=None):
    arith = arith or ("3xtf32" if dtype == "float32" else "bf16")
    t = [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]
    out = emulate(*t, arith=arith, **kw)
    return out.to(_TORCH[dtype]).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_emulated_kernel_matches_pallas_and_jax_ref(name, dtype):
    case = PALLAS_CASES[name]
    xs, kw = _inputs(case, dtype)
    got = _emulated(xs, kw, dtype)
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    want = pallas_flash(*(jnp.asarray(x) for x in xs), block_q=case[8], block_k=case[8],
                        interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)
    ref = jax_attention_ref(*(jnp.asarray(x) for x in xs), **kw)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_emulated_kernel_matches_jax_ref_at_card_shapes(name, dtype):
    xs, kw = _inputs(CUDA_CASES[name], dtype, seed=1)
    got = _emulated(xs, kw, dtype)
    ref = jax_attention_ref(*(jnp.asarray(x) for x in xs), **kw)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# tests/test_torch_cuda.py's prefix-LM and cross-attention cases, (b, nh,
# nkv, S, Sk, hd, causal, window, softcap, prefix_len): held against JAX's
# naive_attention, the oracle of the masks the model's attention applies
MASK_CASES = {
    "prefix_ragged": (1, 4, 2, 200, 200, 64, True, 0, 0.0, 77),
    "prefix_hd256_mqa": (1, 8, 1, 512, 512, 256, True, 0, 0.0, 256),
    "prefix_past_s": (1, 4, 2, 50, 50, 32, True, 0, 0.0, 90),
    "prefix_window": (1, 4, 4, 200, 200, 64, True, 40, 0.0, 100),
    "cross_s64_sk1500": (1, 12, 12, 64, 1500, 64, False, 0, 0.0, 0),
    "cross_ragged_sk_lt_s": (2, 4, 2, 130, 33, 32, False, 0, 0.0, 0),
}


def _mask_inputs(name, dtype, seed=3):
    b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len = MASK_CASES[name]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, nh, S, hd), (b, nkv, Sk, hd), (b, nkv, Sk, hd))]
    if dtype == "bfloat16":
        xs = [x.astype(ml_dtypes.bfloat16) for x in xs]
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    return xs, kw


def _jax_naive(xs, kw):
    """JAX's naive_attention in the kernel's (b, heads, S, hd) layout."""
    q, k, v = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in xs)
    kw = dict(kw)
    out = jax_naive_attention(q, k, v, logit_softcap=kw.pop("softcap"), **kw)
    return np.asarray(out.transpose(0, 2, 1, 3), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_emulated_kernel_matches_jax_prefix_and_cross(name, dtype):
    """The tile walk with a prefix or Sk != S drops no allowed key: the
    emulation, which visits only the walk's tiles and masks only those it
    flags, matches JAX at the kernel tolerances."""
    xs, kw = _mask_inputs(name, dtype)
    got = _emulated(xs, kw, dtype)
    np.testing.assert_allclose(got, _jax_naive(xs, kw), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_attention_ref_matches_jax_prefix_and_cross(name, dtype):
    """The plain version with ``prefix_len`` and Sk != S against JAX's
    naive_attention: float32 2e-5 (summation order); bf16 inputs 2e-2
    (JAX rounds P to bf16 before P.V, the plain version keeps f32)."""
    xs, kw = _mask_inputs(name, dtype)
    tdt = _TORCH[dtype]
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(tdt) for x in xs]
    got = attention_ref(*t, **kw)
    assert got.dtype == tdt and tuple(got.shape) == xs[0].shape
    np.testing.assert_allclose(got.float().numpy(), _jax_naive(xs, kw),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_prefix_reaches_past_the_causal_frontier():
    """A key in the prefix is seen by every query, one after it only from
    its own position on; without a prefix the same inputs give another
    result."""
    xs, kw = _mask_inputs("prefix_ragged", "float32")
    t = [torch.from_numpy(x) for x in xs]
    with_prefix = attention_ref(*t, **kw)
    kw0 = dict(kw, prefix_len=0)
    plain = attention_ref(*t, **kw0)
    # rows at or past the prefix see the same keys either way
    torch.testing.assert_close(with_prefix[:, :, 77:], plain[:, :, 77:])
    assert not torch.allclose(with_prefix[:, :, :76], plain[:, :, :76], atol=1e-3)


@pytest.mark.parametrize("tile_k", [32, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_tile_walk_skips_no_allowed_key_and_masks_the_rest(tile_k, causal):
    """Over a grid of (S, Sk, prefix, window), for every q tile of 64 rows:
    each allowed (q, k) pair lies in a tile the walk visits, each
    disallowed pair in a visited tile lies in one the kernel masks, and
    every visited tile holds an allowed pair where every row has one (a
    causal window over fewer keys than queries leaves rows with none).
    The grid has prefixes that end mid-tile, on a tile edge and past S,
    windows with a prefix, and key lengths other than S."""
    checked = 0
    for S in (1, 50, 64, 200):
        for Sk in sorted({S, 33, 130}):
            for prefix_len in (0, 1, 64, 77, 300):
                for window in (0, 16, 40):
                    walk = dict(causal=causal, window=window, prefix_len=prefix_len)
                    allowed = _allowed(torch.arange(S)[:, None], torch.arange(Sk)[None, :],
                                       **walk)
                    for q0 in range(0, S, 64):
                        q_last = min(q0 + 64, S) - 1
                        rows = allowed[q0:q_last + 1]
                        live = set(live_tiles(q0, q_last, Sk, tile_k, **walk))
                        for kt in range(-(-Sk // tile_k)):
                            block = rows[:, kt * tile_k:(kt + 1) * tile_k]
                            where = (S, Sk, prefix_len, window, q0, kt)
                            if kt not in live:
                                assert not block.any(), where
                                continue
                            assert block.any() or not rows.any(1).all(), where
                            if not block.all() or (kt + 1) * tile_k > Sk:
                                assert tile_needs_mask(kt * tile_k, q0, q_last, Sk, tile_k,
                                                       **walk), where
                            checked += 1
    assert checked > 400


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_single_term_tf32_fails_the_float32_tolerance(name):
    """The control: one TF32 product per pair keeps about three decimal
    digits, so it cannot meet 2e-5 where 3xTF32 does."""
    xs, kw = _inputs(PALLAS_CASES[name], "float32")
    ref = np.asarray(jax_attention_ref(*(jnp.asarray(x) for x in xs), **kw), np.float32)
    split = _emulated(xs, kw, "float32", arith="3xtf32")
    single = _emulated(xs, kw, "float32", arith="tf32")
    np.testing.assert_allclose(split, ref, rtol=2e-5, atol=2e-5)
    assert not np.allclose(single, ref, rtol=2e-5, atol=2e-5), (
        f"single-term TF32 within 2e-5 (max err {np.abs(single - ref).max():.2e})")


def test_emulation_rounds_p_to_bf16_only_on_the_bf16_path():
    """bf16 P moves the output by more than the f32 path's error, and stays
    well inside the bf16 tolerance."""
    xs, kw = _inputs(PALLAS_CASES["mha_causal"], "float32")
    t = [torch.from_numpy(x) for x in xs]
    exact = emulate(*t, arith="3xtf32", **kw)
    p_bf16 = emulate(*[x.bfloat16().float() for x in t], arith="bf16", **kw)
    inputs_bf16 = jax_attention_ref(*(jnp.asarray(x.astype(ml_dtypes.bfloat16).astype(
        np.float32)) for x in xs), **kw)
    err = np.abs(p_bf16.numpy() - np.asarray(inputs_bf16)).max()
    assert 2e-5 < err < 2e-2
    ref = jax_attention_ref(*(jnp.asarray(x) for x in xs), **kw)
    assert np.abs(exact.numpy() - np.asarray(ref)).max() < 2e-5


# ---------------------------------------------------------- the launch plan

def _attention_configs():
    out = []
    for name in ["faas_bench"] + list_archs():
        cfg = get_config(name)
        if cfg.attention_free:
            continue
        out += [(name, cfg), (name + "-reduced", reduced(cfg))]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cfg", _attention_configs(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_plan_takes_every_config(name, cfg, dtype):
    plan = launch_plan(dtype, cfg.head_dim, batch=2, heads=cfg.num_heads, seq=1000)
    assert plan.width >= cfg.head_dim and plan.slabs * plan.slab == plan.width
    assert plan.slab * dtype.itemsize == 128
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.blocks_per_sm * (plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM
    assert plan.stages >= 2 and plan.tile_q == 64 and plan.tile_k % 16 == 0
    tiles = (plan.tile_q + 2 * plan.stages * plan.tile_k) * plan.width * dtype.itemsize
    assert plan.smem_bytes >= tiles
    assert plan.grid == (cfg.num_heads, 2, 16)


def test_every_plan_is_an_instantiation():
    """The launcher refuses a plan it has no instantiation for: every head
    dim the plan takes maps to one (dtype, width, tile_k, stages, CTAs an
    SM) that the source instantiates, with the same shared-memory size."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "flash_attention.cu").read_text()
    inst = set(re.findall(r"launch<(float|__nv_bfloat16), (\d+), (\d+), (\d+), (\d+)>", src))
    assert inst
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    seen = set()
    for dtype in names:
        for hd in range(8, 257, 8):
            p = launch_plan(dtype, hd)
            key = (names[dtype], str(p.width), str(p.tile_k), str(p.stages),
                   str(p.blocks_per_sm))
            assert key in inst, key
            seen.add(key)
    assert seen == inst


@pytest.mark.parametrize("hd", [0, 4, 20, 264])
def test_plan_refuses_head_dims_it_cannot_tile(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        launch_plan(torch.float32, hd)


def test_plan_padding_at_head_dim_80():
    """stablelm-3b's head dim 80 runs in a 128-wide bf16 tile: 37.5 % of the
    tensor-core work multiplies zeros."""
    plan = launch_plan(torch.bfloat16, 80)
    assert (plan.width, plan.slabs) == (128, 2)
    assert plan.padding_waste == pytest.approx(0.375)


def test_alignment_refuses_what_tma_cannot_read():
    x = torch.zeros((1, 4, 8, 33))[..., :32]        # rows of 132 bytes
    why = alignment_problem("k", x.data_ptr(), x.shape, x.stride(), 4)
    assert why is not None and "row stride of 132 bytes" in why
    y = torch.zeros((1, 4, 8, 40))[..., 4:36]        # base 16 bytes in: fine
    assert alignment_problem("q", y.data_ptr(), y.shape, y.stride(), 4) is None
    z = torch.zeros((1, 4, 8, 40))[..., 1:33]        # base 4 bytes in
    why = alignment_problem("q", z.data_ptr(), z.shape, z.stride(), 4)
    assert why is not None and "base address" in why
    h = torch.zeros((1, 3, 8, 40), dtype=torch.bfloat16)[:, :, :, :36]
    why = alignment_problem("v", h.data_ptr(), h.shape, h.stride(), 2)
    assert why is None                               # rows of 80 bytes: fine
    odd = torch.zeros((2, 3, 5, 36), dtype=torch.bfloat16)[..., :32]
    why = alignment_problem("v", odd.data_ptr(), odd.shape, odd.stride(), 2)
    assert why is not None and "row stride of 72 bytes" in why
    s = torch.zeros((1, 4, 8, 64))[..., ::2]
    assert "unit-stride" in alignment_problem("q", s.data_ptr(), s.shape, s.stride(), 4)


def test_alignment_ignores_dims_of_length_one():
    """A dim that is never stepped may carry any stride (PyTorch leaves size-1
    strides arbitrary)."""
    x = torch.zeros((1, 1, 8, 32)).as_strided((1, 1, 8, 32), (3, 5, 32, 1))
    assert alignment_problem("q", x.data_ptr(), x.shape, x.stride(), 4) is None


# ------------------------------------------------------------ the backward
#
# The backward kernel (``csrc/flash_attention_bwd.cu``) runs only on the
# card.  Here: its plain formula against autograd in float64, its launch
# plan and transposed tile walk, and the autograd.Function's plumbing with
# the two kernel entry points stood in by their plain versions.

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref,
    attention_fwd_ref,
    flash_attention_op,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BWD_TILING,
    BWD_WIDTHS,
    MAX_SPLIT,
    FlashBwdPlan,
    bwd_launch_plan,
    bwd_q_tiles,
    bwd_smem,
)

# (b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len)
BWD_CASES = {
    "mha_causal_hd64": (2, 4, 4, 70, 70, 64, True, 0, 0.0, 0),
    "gqa_causal_hd80": (1, 8, 2, 50, 50, 80, True, 0, 0.0, 0),
    "mqa_hd128": (1, 4, 1, 40, 40, 128, True, 0, 0.0, 0),
    "bidirectional": (2, 4, 2, 45, 45, 64, False, 0, 0.0, 0),
    "window": (1, 4, 2, 64, 64, 64, True, 16, 0.0, 0),
    "softcap": (1, 4, 4, 48, 48, 64, True, 0, 30.0, 0),
    "window_softcap": (1, 4, 2, 60, 60, 80, True, 12, 20.0, 0),
    "prefix_mid_tile": (1, 4, 1, 60, 60, 64, True, 0, 0.0, 23),
    "prefix_on_edge": (1, 4, 2, 80, 80, 64, True, 0, 0.0, 64),
    "prefix_past_s": (1, 2, 2, 30, 30, 64, True, 0, 0.0, 50),
    "cross_sk_gt_s": (2, 4, 4, 20, 75, 64, False, 0, 0.0, 0),
    "causal_sk_gt_s": (1, 4, 2, 24, 50, 80, True, 0, 0.0, 0),
}

# several tiles of every kind, ragged S and Sk: the stage ring, the dK / dV
# kernel's two warpgroups and its (q head, q tile) splits, the dQ kernel's
# key splits
MULTI_TILE_BWD_CASES = {
    "multi_tile_gqa_causal_s300_sk450_hd80": (1, 4, 2, 300, 450, 80, True, 0, 0.0, 0),
    "multi_tile_mqa_bidirectional_hd64": (2, 4, 1, 200, 333, 64, False, 0, 0.0, 0),
    "multi_tile_window_softcap_hd128": (1, 4, 2, 260, 260, 128, True, 70, 30.0, 0),
    "multi_tile_prefix_mqa_hd256": (1, 4, 1, 150, 150, 256, True, 0, 0.0, 77),
}


def _bwd_inputs(case, dtype=torch.float64, seed=11):
    b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(dtype) for shape in
               ((b, nh, S, hd), (b, nkv, Sk, hd), (b, nkv, Sk, hd)))
    do = torch.from_numpy(rng.standard_normal((b, nh, S, hd))).to(dtype)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    return q, k, v, do, kw


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_attention_bwd_ref_matches_float64_autograd(name):
    """The explicit formula (float32, from the forward's lse) against
    torch.autograd through ``attention_ref`` in float64, at 5e-6 of each
    gradient's largest entry (float32 sums over at most 128 terms)."""
    q, k, v, do, kw = _bwd_inputs(BWD_CASES[name])
    q64, k64, v64 = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_ref(q64, k64, v64, **kw), (q64, k64, v64), do)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = attention_fwd_ref(q32, k32, v32, **kw)
    got = attention_bwd_ref(q32, k32, v32, o, do32, lse, **kw)
    for g, w, what in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = float((g.double() - w).abs().max())
        assert err <= 5e-6 * float(w.abs().max()), (what, err)


def split_range(n, splits, c):
    """Share ``c`` of ``splits`` of ``n`` items, as the kernels cut a tile's
    work list (``it0`` / ``it1`` and ``j0`` / ``j1`` in the CUDA source)."""
    return range(n * c // splits, n * (c + 1) // splits)


def _tiles_meet(q0, q_last, k0, k_last, *, causal, window, prefix_len):
    """The kernels' test of a (q rows, keys) pair of tiles: does some pair
    meet the masks?  (A row's allowed keys are (q - window, max(q,
    prefix_len - 1)], both ends growing with q.)"""
    ok = q0 <= q_last and k0 <= k_last
    if causal:
        ok = ok and k0 <= max(q_last, prefix_len - 1)
    if window > 0:
        ok = ok and k_last >= q0 - window + 1
    return ok


def _p_ds(s, dp, lse, d, ok, *, scale, softcap, rnd):
    """P and dS of the scores s = q . k and dp = dO . v (rows q, columns
    keys; lse and D per row), 0 where ``ok`` is False (None: unmasked): dS =
    pf (dP - D) with pf = P (1 - tanh^2), rounded by ``rnd`` first (the bf16
    path keeps pf in packed bf16 registers)."""
    x = s * scale
    th = None
    if softcap > 0.0:
        th = torch.tanh(x / softcap)
        x = softcap * th
    p = torch.exp(x - lse[..., None])
    if ok is not None:
        p = torch.where(ok, p, torch.zeros_like(p))
    pf = p if th is None else p * (1.0 - th * th)
    return p, rnd(pf) * (dp - d[..., None])


def emulate_bwd(q, k, v, o, do, lse, *, scale, causal, window, softcap, arith,
                prefix_len=0, sms=132):
    """The backward kernels' arithmetic on (b, nh, S, hd) float32 tensors
    (holding bf16 values for ``arith="bf16"``), in the plan's tile walk:

    - D = rowsum(dO * O) in float32 (the dQ kernel's prologue);
    - dQ: per q tile of ``tile_dq`` rows and each of its 64-row warpgroups,
      over the key tiles of ``tile_k`` keys its walk visits (``live_tiles``),
      in ``split_q`` shares summed in split order; S = Q.K^T, dP = dO.V^T,
      P and dS (masked only where ``tile_needs_mask`` says), dQ += dS.K;
    - dK / dV: per key tile of ``tile_kv`` keys and each of its 64-key
      warpgroups, over the (q head of the group, q tile of ``tile_q`` rows)
      list its walk visits (``bwd_q_tiles``), in ``split_kv`` shares summed
      in split order; dV += P^T.dO, dK += dS^T.Q;

    P, P (1 - tanh^2) and dS rounded to bf16 on the bf16 path; every
    product 3xTF32 (``arith="3xtf32"``), one TF32 term (``"tf32"``, the
    control) or exact f32 sums of bf16 values (``"bf16"``)."""
    b, nh, S, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    rep = nh // nkv
    dtype = torch.bfloat16 if arith == "bf16" else torch.float32
    plan = bwd_launch_plan(dtype, hd, batch=b, heads=nh, kv_heads=nkv, seq=S, kv_seq=Sk,
                           sms=sms)
    walk = dict(causal=causal, window=window, prefix_len=prefix_len)
    rnd = (lambda x: x.bfloat16().float()) if arith == "bf16" else (lambda x: x)
    ew = dict(scale=scale, softcap=softcap, rnd=rnd)
    mm = functools.partial(_matmul, arith=arith)
    delta = (do * o).sum(-1)
    kx, vx = (x.repeat_interleave(rep, dim=1) for x in (k, v))

    def ok(qpos, kpos, q0, q_last, k0, tile):
        if not tile_needs_mask(k0, q0, q_last, Sk, tile, **walk):
            return None
        return _allowed(torch.as_tensor(qpos)[:, None], torch.as_tensor(kpos)[None, :], **walk)

    dq = torch.zeros_like(q)
    for q0 in range(0, S, plan.tile_dq):
        q_last = min(q0 + plan.tile_dq, S) - 1
        tiles = list(live_tiles(q0, q_last, Sk, plan.tile_k, **walk))
        total = 0.0
        for c in range(plan.split_q):
            acc = torch.zeros((b, nh, q_last + 1 - q0, hd))
            for kt in (tiles[i] for i in split_range(len(tiles), plan.split_q, c)):
                k0 = kt * plan.tile_k
                k1 = min(k0 + plan.tile_k, Sk)
                kb, vb = kx[:, :, k0:k1], vx[:, :, k0:k1]
                for w0 in range(q0, q_last + 1, 64):
                    w1 = min(w0 + 64, q_last + 1)
                    if not _tiles_meet(w0, w1 - 1, k0, k1 - 1, **walk):
                        continue
                    s = mm(q[:, :, w0:w1], kb.transpose(-1, -2))
                    dp = mm(do[:, :, w0:w1], vb.transpose(-1, -2))
                    _, ds = _p_ds(s, dp, lse[:, :, w0:w1], delta[:, :, w0:w1],
                                  ok(range(w0, w1), range(k0, k1), w0, w1 - 1, k0,
                                     plan.tile_k), **ew)
                    acc[:, :, w0 - q0:w1 - q0] += mm(rnd(ds), kb)
            total = acc if plan.split_q == 1 else total + acc
        dq[:, :, q0:q_last + 1] = total * scale

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    qg, dog = (x.reshape(b, nkv, rep, S, hd) for x in (q, do))
    lg, dg = (x.reshape(b, nkv, rep, S) for x in (lse, delta))
    for k0 in range(0, Sk, plan.tile_kv):
        k_last = min(k0 + plan.tile_kv, Sk) - 1
        qts = bwd_q_tiles(k0, k_last, S, plan.tile_q, **walk)
        items = [(r, qt) for r in range(rep) for qt in qts]
        tot_k = tot_v = 0.0
        for c in range(plan.split_kv):
            ak = torch.zeros((b, nkv, k_last + 1 - k0, hd))
            av = torch.zeros_like(ak)
            for r, qt in (items[i] for i in split_range(len(items), plan.split_kv, c)):
                t0, t1 = qt * plan.tile_q, min(qt * plan.tile_q + plan.tile_q, S)
                qb, gb = qg[:, :, r, t0:t1], dog[:, :, r, t0:t1]
                for w0 in range(k0, k_last + 1, 64):
                    w1 = min(w0 + 64, k_last + 1)
                    if not _tiles_meet(t0, t1 - 1, w0, w1 - 1, **walk):
                        continue
                    kb, vb = k[:, :, w0:w1], v[:, :, w0:w1]
                    # S^T and dP^T as the kernel forms them, P^T and dS^T
                    st = mm(kb, qb.transpose(-1, -2)).transpose(-1, -2)
                    dpt = mm(vb, gb.transpose(-1, -2)).transpose(-1, -2)
                    p, ds = _p_ds(st, dpt, lg[:, :, r, t0:t1], dg[:, :, r, t0:t1],
                                  ok(range(t0, t1), range(w0, w1), t0, t1 - 1, w0, 64), **ew)
                    av[:, :, w0 - k0:w1 - k0] += mm(rnd(p).transpose(-1, -2), gb)
                    ak[:, :, w0 - k0:w1 - k0] += mm(rnd(ds).transpose(-1, -2), qb)
            if plan.split_kv == 1:
                tot_k, tot_v = ak, av
            else:
                tot_k, tot_v = tot_k + ak, tot_v + av
        dk[:, :, k0:k_last + 1] = tot_k * scale
        dv[:, :, k0:k_last + 1] = tot_v
    return dq, dk, dv


def _emulated_bwd_and_oracle(case, dtype, arith=None, sms=132):
    """(emulated (dq, dk, dv), float64 autograd through ``attention_ref``)
    from one seeded set of inputs, rounded to bf16 for the bf16 path; o and
    lse from the plain forward, o in the working dtype as the card has it."""
    q, k, v, do, kw = _bwd_inputs(case)
    if dtype == "bfloat16":
        q, k, v, do = (x.bfloat16().double() for x in (q, k, v, do))
    x64 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*x64, **kw), x64, do)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = attention_fwd_ref(q32, k32, v32, **kw)
    o = o.to(_TORCH[dtype]).float()
    arith = arith or ("3xtf32" if dtype == "float32" else "bf16")
    got = emulate_bwd(q32, k32, v32, o, do32, lse, arith=arith, sms=sms, **kw)
    return got, want


def _rel_err(got, want):
    """max over dq, dk, dv of max|got - want| / max|want|"""
    return max(float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BWD_CASES) + sorted(MULTI_TILE_BWD_CASES))
def test_emulated_bwd_matches_float64_autograd(name, dtype):
    """The backward kernels' arithmetic and tile walk (splits as the plan
    cuts them for the H100's 132 SMs) against float64 autograd through
    ``attention_ref``: f32 5e-5, bf16 2e-2 of each gradient's largest entry
    (P and dS rounded to bf16 before their products)."""
    case = {**BWD_CASES, **MULTI_TILE_BWD_CASES}[name]
    got, want = _emulated_bwd_and_oracle(case, dtype)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    err = _rel_err(got, want)
    assert err <= (5e-5 if dtype == "float32" else 2e-2), err


@pytest.mark.parametrize("name", sorted(MULTI_TILE_BWD_CASES))
def test_emulated_bwd_splits_sum_what_one_cta_sums(name):
    """The multi-tile cases cross the splits (at 132 SMs) and, on a card of
    one SM, run unsplit: both walks give the same gradients to float32
    summation order."""
    case = MULTI_TILE_BWD_CASES[name]
    b, nh, nkv, S, Sk, hd = case[:6]
    many = bwd_launch_plan(torch.float32, hd, batch=b, heads=nh, kv_heads=nkv, seq=S,
                           kv_seq=Sk)
    one = bwd_launch_plan(torch.float32, hd, batch=b, heads=nh, kv_heads=nkv, seq=S,
                          kv_seq=Sk, sms=1)
    assert (one.split_kv, one.split_q) == (1, 1)
    assert many.split_kv > 1 or many.split_q > 1
    split, _ = _emulated_bwd_and_oracle(case, "float32")
    whole, _ = _emulated_bwd_and_oracle(case, "float32", sms=1)
    for a, c in zip(split, whole):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))


@pytest.mark.parametrize("name", ["gqa_causal_hd80", "window_softcap",
                                  "multi_tile_gqa_causal_s300_sk450_hd80"])
def test_single_term_tf32_fails_the_bwd_float32_tolerance(name):
    """The control: the backward with one TF32 term per product misses 5e-5
    where 3xTF32 meets it."""
    case = {**BWD_CASES, **MULTI_TILE_BWD_CASES}[name]
    got, want = _emulated_bwd_and_oracle(case, "float32")
    assert _rel_err(got, want) <= 5e-5
    single, _ = _emulated_bwd_and_oracle(case, "float32", arith="tf32")
    assert _rel_err(single, want) > 5e-5


def test_attention_bwd_ref_controls_fail():
    """Dropping the causal mask or the softcap's 1 - tanh^2, or taking one
    head of a GQA group instead of the group's sum, moves the gradients far
    outside the tolerance."""
    q, k, v, do, kw = _bwd_inputs(BWD_CASES["window_softcap"])
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = attention_fwd_ref(q32, k32, v32, **kw)
    dq, dk, dv = attention_bwd_ref(q32, k32, v32, o, do32, lse, **kw)
    no_mask = attention_bwd_ref(q32, k32, v32, o, do32, lse,
                                **dict(kw, causal=False, window=0))
    assert float((no_mask[1] - dk).abs().max()) > 0.1 * float(dk.abs().max())
    no_cap = attention_bwd_ref(q32, k32, v32, o, do32, lse, **dict(kw, softcap=0.0))
    assert float((no_cap[0] - dq).abs().max()) > 0.01 * float(dq.abs().max())
    q, k, v, do, kw = _bwd_inputs(BWD_CASES["gqa_causal_hd80"])
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = attention_fwd_ref(q32, k32, v32, **kw)
    _, dk, _ = attention_bwd_ref(q32, k32, v32, o, do32, lse, **kw)
    rep = q.shape[1] // k.shape[1]
    one_head = attention_bwd_ref(q32[:, ::rep], k32, v32, o[:, ::rep], do32[:, ::rep],
                                 lse[:, ::rep].contiguous(), **kw)[1]
    assert float((one_head - dk).abs().max()) > 0.1 * float(dk.abs().max())


def test_lse_of_a_row_without_keys_gives_zero_gradient():
    """A causal window over fewer keys than queries leaves late rows with
    no allowed key: their lse is the sentinel and they send no gradient."""
    q, k, v, do, kw = _bwd_inputs((1, 2, 2, 40, 10, 64, True, 4, 0.0, 0), torch.float32)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    empty = torch.arange(40) >= 10 + 4 - 1
    assert bool((lse[..., empty] == 1e30).all()) and bool(torch.isfinite(lse).all())
    dq, dk, dv = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    assert float(dq[..., empty, :].abs().max()) == 0.0
    keep = dict(kw)
    ref = attention_bwd_ref(q[:, :, ~empty], k, v, o[:, :, ~empty], do[:, :, ~empty],
                            lse[:, :, ~empty].contiguous(), **keep)
    torch.testing.assert_close(dk, ref[1])
    torch.testing.assert_close(dv, ref[2])


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_bwd_tile_walk_covers_every_allowed_pair(tile, causal):
    """The dK / dV kernel's walk (``bwd_q_tiles``: the forward's walk
    transposed, up to the last real key) visits the dQ kernel's (``live_tiles``)
    (q tile, key tile) pairs but those without an allowed pair; every
    allowed (q, k) pair lies in one, and every
    disallowed pair of a visited pair of tiles lies in one the kernels
    mask (``tile_needs_mask``).  Over lengths, key lengths, prefixes (mid
    tile, on an edge, past S) and windows."""
    checked = 0
    for S in (1, 50, 64, 200):
        for Sk in sorted({S, 33, 130}):
            for prefix_len in (0, 1, 64, 77, 300):
                for window in (0, 16, 40):
                    walk = dict(causal=causal, window=window, prefix_len=prefix_len)
                    allowed = _allowed(torch.arange(S)[:, None], torch.arange(Sk)[None, :],
                                       **walk)
                    n_q, n_k = -(-S // tile), -(-Sk // tile)
                    fwd = {(qt, kt) for qt in range(n_q)
                           for kt in live_tiles(qt * tile, min(qt * tile + tile, S) - 1, Sk,
                                                tile, **walk)}
                    bwd = {(qt, kt) for kt in range(n_k)
                           for qt in bwd_q_tiles(kt * tile, min(kt * tile + tile, Sk) - 1, S,
                                                 tile, **walk)}
                    # the dK / dV walk stops at the last real key, so it may
                    # leave out a forward pair that holds only padded keys
                    assert bwd <= fwd, (S, Sk, prefix_len, window)
                    for qt, kt in fwd - bwd:
                        assert not allowed[qt * tile:(qt + 1) * tile,
                                           kt * tile:(kt + 1) * tile].any()
                    _check_unequal_bwd_tiles(allowed, S, Sk, tile, walk)
                    for qt in range(n_q):
                        q0, q_last = qt * tile, min(qt * tile + tile, S) - 1
                        for kt in range(n_k):
                            block = allowed[q0:q_last + 1, kt * tile:(kt + 1) * tile]
                            where = (S, Sk, prefix_len, window, qt, kt)
                            if (qt, kt) not in bwd:
                                assert not block.any(), where
                                continue
                            if not block.all() or (kt + 1) * tile > Sk:
                                assert tile_needs_mask(kt * tile, q0, q_last, Sk, tile,
                                                       **walk), where
                            checked += 1
    assert checked > 400


def _check_unequal_bwd_tiles(allowed, S, Sk, tile_k, walk):
    """The dK / dV walk at the plans' unequal tiles (q tiles of 16, 32 or 64
    rows, key tiles of 64 or 128 keys in 64-key warpgroups): every allowed
    pair lies in a visited (q tile, key tile) whose warpgroup meets it, no
    visited pair of tiles is without an allowed pair, and every disallowed
    pair of a visited warpgroup tile is masked.  The dQ walk (``live_tiles``
    at ``tile_k`` keys, 64-row warpgroups of a 128-row tile) likewise."""
    for tile_q in (16, 32, 64):
        for tile_kv in (64, 128):
            seen = torch.zeros_like(allowed)
            for k0 in range(0, Sk, tile_kv):
                k_last = min(k0 + tile_kv, Sk) - 1
                qts = bwd_q_tiles(k0, k_last, S, tile_q, **walk)
                for qt in range(-(-S // tile_q)):
                    q0, q_last = qt * tile_q, min(qt * tile_q + tile_q, S) - 1
                    block = allowed[q0:q_last + 1, k0:k_last + 1]
                    assert (qt in qts) == bool(block.any()), (S, Sk, walk, tile_q, k0, qt)
                    if qt not in qts:
                        continue
                    for w0 in range(k0, k_last + 1, 64):
                        w_last = min(w0 + 63, k_last)
                        sub = allowed[q0:q_last + 1, w0:w_last + 1]
                        assert _tiles_meet(q0, q_last, w0, w_last, **walk) == bool(sub.any())
                        if not sub.all() or w0 + 64 > Sk:
                            if sub.any():
                                assert tile_needs_mask(w0, q0, q_last, Sk, 64, **walk)
                        seen[q0:q_last + 1, w0:w_last + 1] |= sub
            assert torch.equal(seen, allowed)
    seen = torch.zeros_like(allowed)
    for q0 in range(0, S, 128):
        q_last = min(q0 + 128, S) - 1
        for kt in live_tiles(q0, q_last, Sk, tile_k, **walk):
            k0, k_last = kt * tile_k, min(kt * tile_k + tile_k, Sk) - 1
            for w0 in range(q0, q_last + 1, 64):
                w_last = min(w0 + 63, q_last)
                sub = allowed[w0:w_last + 1, k0:k_last + 1]
                assert _tiles_meet(w0, w_last, k0, k_last, **walk) == bool(sub.any())
                if sub.any() and (not sub.all() or k0 + tile_k > Sk):
                    assert tile_needs_mask(k0, w0, w_last, Sk, tile_k, **walk)
                seen[w0:w_last + 1, k0:k_last + 1] |= sub
    assert torch.equal(seen, allowed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cfg", _attention_configs(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_bwd_plan_takes_every_config(name, cfg, dtype):
    """Every attention configuration of the port gets a backward plan whose
    two kernels fit a block's shared memory (resident tiles, the stages,
    (lse, D), the mbarriers), with a grid that cuts no tile's work into more
    than MAX_SPLIT CTAs."""
    plan = bwd_launch_plan(dtype, cfg.head_dim, batch=2, heads=cfg.num_heads,
                           kv_heads=cfg.num_kv_heads, seq=1024, kv_seq=1500)
    assert isinstance(plan, FlashBwdPlan)
    assert max(plan.smem_kv, plan.smem_q) <= SMEM_PER_BLOCK
    assert plan.width >= cfg.head_dim and plan.width in BWD_WIDTHS[dtype.itemsize]
    assert plan.width - cfg.head_dim < 64          # no whole slab of padding
    assert (plan.smem_kv, plan.smem_q) == bwd_smem(dtype.itemsize, plan.width,
                                                   *BWD_TILING[(dtype.itemsize, plan.width)][:3],
                                                   *BWD_TILING[(dtype.itemsize, plan.width)][4:])
    assert 1 <= plan.split_kv <= MAX_SPLIT and 1 <= plan.split_q <= MAX_SPLIT
    assert plan.grid_q == (-(-1024 // plan.tile_dq) * plan.split_q, cfg.num_heads, 2)
    assert plan.grid_kv == (-(-1500 // plan.tile_kv) * plan.split_kv * plan.col_split,
                            cfg.num_kv_heads, 2)
    assert plan.s_pad(1024) % plan.tile_q == 0 and plan.s_pad(1024) >= 1024
    # the dK / dV CTA's columns are whole 64-column slabs when split
    assert plan.col_split == 1 or plan.width // plan.col_split % 64 == 0
    assert {plan.threads_kv, plan.threads_q} <= {128 + 32, 3 * 128}


def test_every_bwd_plan_is_an_instantiation():
    """Every head dim the backward's plan takes maps to one (dtype, width,
    dK / dV warpgroups, q rows, stages, column halves, dQ warpgroups, keys,
    stages) that ``flash_attention_bwd.cu`` instantiates."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "flash_attention_bwd.cu").read_text()
    inst = set(re.findall(r"width == (\d+)\) return f\(Instance<(float|__nv_bfloat16), "
                          r"(\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>", src))
    assert inst
    assert all(w == w2 for w, _, w2, *_ in inst)
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    seen = set()
    for dtype in names:
        for hd in range(8, 257, 8):
            p = bwd_launch_plan(dtype, hd)
            key = (str(p.width), names[dtype], str(p.width), *map(str, p.as_ints()[:7]))
            assert key in inst, key
            seen.add(key)
    assert seen == inst


# the chip run's backward shapes (b, nh, nkv, S, Sk, hd, dtype): each kernel's
# grid fills the H100's 132 SMs, or its split is as deep as the work allows
CHIP_BWD_SHAPES = {
    "stablelm_train": (4, 32, 32, 1024, 1024, 80, torch.bfloat16),
    "gqa_32_8": (1, 32, 8, 1024, 1024, 128, torch.bfloat16),
    "paligemma_mqa": (1, 8, 1, 512, 512, 256, torch.bfloat16),
    "whisper_encoder": (1, 12, 12, 1500, 1500, 64, torch.bfloat16),
    "whisper_cross": (1, 12, 12, 64, 1500, 64, torch.bfloat16),
    "faas_bench_f32": (1, 6, 6, 256, 256, 64, torch.float32),
}


@pytest.mark.parametrize("name", sorted(CHIP_BWD_SHAPES))
def test_bwd_grid_fills_the_card(name):
    b, nh, nkv, S, Sk, hd, dtype = CHIP_BWD_SHAPES[name]
    p = bwd_launch_plan(dtype, hd, batch=b, heads=nh, kv_heads=nkv, seq=S, kv_seq=Sk)
    most_kv = min(MAX_SPLIT, nh // nkv * -(-S // p.tile_q))
    most_q = min(MAX_SPLIT, -(-Sk // p.tile_k))
    ctas_kv, ctas_q = p.grid_kv[0] * nkv * b, p.grid_q[0] * nh * b
    assert ctas_kv >= 0.75 * 132 or p.split_kv == most_kv, (p.grid_kv, p.split_kv)
    assert ctas_q >= 0.75 * 132 or p.split_q == most_q, (p.grid_q, p.split_q)
    if ctas_kv // p.split_kv >= 132:
        assert p.split_kv == 1
    if ctas_q // p.split_q >= 132:
        assert p.split_q == 1


def _stand_in_kernels(monkeypatch):
    """Route CPU tensors through the CUDA branch of ``flash_attention_op``
    with the kernels' plain versions in their place; returns the calls."""
    calls = {"fwd": 0, "fwd_lse": 0, "bwd": 0}

    def fwd(q, k, v, *, return_lse=False, **kw):
        calls["fwd_lse" if return_lse else "fwd"] += 1
        return attention_fwd_ref(q, k, v, **kw) if return_lse else attention_ref(q, k, v, **kw)

    def bwd(q, k, v, o, do, lse, **kw):
        calls["bwd"] += 1
        assert do.is_contiguous()
        return attention_bwd_ref(q, k, v, o, do, lse, **kw)

    monkeypatch.setattr(flash_ops, "all_on_cpu", lambda *t: False)
    monkeypatch.setattr(flash_ops, "flash_attention", fwd)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd", bwd)
    return calls


@pytest.mark.parametrize("name", ["gqa_causal_hd80", "window_softcap", "prefix_mid_tile",
                                  "cross_sk_gt_s"])
def test_autograd_function_gives_autograds_gradients(monkeypatch, name):
    """On the CUDA route with grad wanted, ``flash_attention_op`` runs the
    forward with lse and the backward entry point through its
    autograd.Function: in the model's (b, s, heads, hd) layout, with GQA
    and a non-contiguous dO, q, k and v get autograd's gradients through
    the plain version."""
    q, k, v, do, kw = _bwd_inputs(BWD_CASES[name], torch.float32)
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    do_l = do.transpose(1, 2)  # (b, s, h, d) view: not contiguous
    assert not do_l.is_contiguous()
    want = torch.autograd.grad(flash_attention_op(ql, kl, vl, **kw), (ql, kl, vl), do_l)
    calls = _stand_in_kernels(monkeypatch)
    out = flash_attention_op(ql, kl, vl, **kw)
    got = torch.autograd.grad(out, (ql, kl, vl), do_l)
    assert calls == {"fwd": 0, "fwd_lse": 1, "bwd": 1}
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * float(w.abs().max()))


def test_cuda_route_without_grad_runs_the_forward_alone(monkeypatch):
    """No gradient wanted: the inference forward, no lse, no backward."""
    q, k, v, _, kw = _bwd_inputs(BWD_CASES["mha_causal_hd64"], torch.float32)
    calls = _stand_in_kernels(monkeypatch)
    ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
    flash_attention_op(ql, kl, vl, **kw)
    with torch.no_grad():
        flash_attention_op(*(t.requires_grad_(True) for t in (ql.clone(), kl, vl)), **kw)
    assert calls == {"fwd": 2, "fwd_lse": 0, "bwd": 0}
