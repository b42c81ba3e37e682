"""The Hopper SSD scan kernel's design, on the CPU.

The kernel (``src/repro_torch/csrc/ssd_scan.cu``) runs only on the card.
What can be checked here is its arithmetic and its launch plan:

- an emulation in plain PyTorch of what its three phases compute, with the
  rounding of every tensor-core operand: chunk states (x o w)^T . B, the
  state passing over the chunks, and the chunk scan exp(cs_i) C_i . S_in^T
  + P . x_j with P = C.B^T o exp(cs_i - cs_j) o dt_j, the decay factored at
  the end of each 64-row tile below the diagonal.  bfloat16: x, B, C are
  exact, and each float32 operand that meets them (x o w, P, S_in) is split
  into hi + lo bf16 parts; float32: 3xTF32 with hi and lo rounded to
  nearest.  It is held against the Pallas kernel in interpret mode and
  against ``repro.models.ssm.ssd_chunked`` at the kernel tolerances (y f32
  2e-5, bf16 2e-2; the state 1e-3), and at mamba2-780m's width.  Controls:
  rounding any one of the split operands to a single bf16, or a single TF32
  product, misses a tolerance that the design meets;
- the prefix sum of the chunk (``prefix_sum``): in the order of the
  reference's ``jnp.cumsum`` (XLA's blocks of 16), bit for bit, which the
  kernel's chunk-state phase also takes;
- the launch plan (``launch_plan``, ``alignment_problem``): every SSM
  configuration of the port, full and reduced, and every CUDA test shape
  fits the card's shared memory, each plan is an instantiation of the
  kernel, and what the kernel cannot take is refused with its reason.
"""

import re
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd_scan as pallas_ssd  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref_module  # noqa: E402
from repro_torch.kernels.ssd import ssd_ref  # noqa: E402
from repro_torch.kernels.ssd.kernel import (  # noqa: E402
    KERNELS_PER_CALL,
    SMEM_PER_BLOCK,
    alignment_problem,
    launch_plan,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STATE_TOL = 1e-3
TILE = 64  # the kernel's row tiles


# ------------------------------------------------------------ the emulation

def _tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 (ties away from zero): what the kernel's
    ``tf32_rn`` keeps."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 mantissa bits cleared (truncation)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _matmul(a: torch.Tensor, b: torch.Tensor, arith: str) -> torch.Tensor:
    """a @ b as the kernel's tensor cores compute it.  ``split_a`` /
    ``split_b``: that f32 operand as bf16 hi + lo, the other exact in bf16;
    ``round_a`` / ``round_b``: that operand rounded once to bf16."""
    if arith in ("3xtf32", "3xtf32_trunc"):
        r = _tf32_rn if arith == "3xtf32" else _tf32_trunc
        ahi, bhi = r(a), r(b)
        alo, blo = r(a - ahi), r(b - bhi)
        return alo @ bhi + ahi @ blo + ahi @ bhi
    if arith == "tf32":
        return _tf32_rn(a) @ _tf32_rn(b)
    if arith == "split_a":
        hi = _bf16(a)
        return hi @ b + _bf16(a - hi) @ b
    if arith == "split_b":
        hi = _bf16(b)
        return a @ hi + a @ _bf16(b - hi)
    if arith == "round_a":
        return _bf16(a) @ b
    if arith == "round_b":
        return a @ _bf16(b)
    assert arith == "exact"
    return a @ b


def emulate(x, dt, A, B, C, D, *, chunk, dtype, f32="3xtf32", round_=()):
    """The kernel's three phases on CPU tensors: x (b, l, nh, hd), dt (b, l,
    nh), A (nh,), B / C (b, l, ds), D (nh,); x, B, C hold bf16 values for
    ``dtype="bfloat16"``.  ``round_`` names bf16 operands rounded once
    instead of split ("p", "w", "s": the controls); ``f32`` the float32
    arithmetic.  Returns (y in ``dtype``, final state)."""
    b, l, nh, hd = x.shape
    nc = l // chunk
    x, B, C = x.float(), B.float(), C.float()
    xc = x.view(b, nc, chunk, nh, hd).permute(0, 1, 3, 2, 4)   # (b, nc, nh, c, hd)
    Bc = B.view(b, nc, chunk, -1)[:, :, None]                  # (b, nc, 1, c, ds)
    Cc = C.view(b, nc, chunk, -1)[:, :, None]
    dtc = dt.view(b, nc, chunk, nh).permute(0, 1, 3, 2)        # (b, nc, nh, c)
    # the prefix sum in the kernel's and the reference's order
    cs = ssd_ref_module.prefix_sum(dt.view(b, nc, chunk, nh) * A, 2).permute(0, 1, 3, 2)
    total = cs[..., -1]
    if dtype == "float32":
        m_state = m_cb = m_px = m_in = f32
    else:
        m_state = "round_a" if "w" in round_ else "split_a"
        m_cb = "exact"
        m_px = "round_a" if "p" in round_ else "split_a"
        m_in = "round_b" if "s" in round_ else "split_b"
    # 1. chunk states: (x o w)^T . B, w_j = dt_j exp(cs_last - cs_j)
    w = dtc * torch.exp(total[..., None] - cs)
    chunk_state = _matmul((xc * w[..., None]).transpose(-1, -2), Bc, m_state)
    # 2. state passing: S_in[k] = S_in[k-1] exp(total[k-1]) + state[k-1]
    s_in = torch.zeros_like(chunk_state)
    run = torch.zeros_like(chunk_state[:, 0])
    for k in range(nc):
        s_in[:, k] = run
        run = run * torch.exp(total[:, k])[..., None, None] + chunk_state[:, k]
    # 3. chunk scan; every exponent masked before exp.  On the diagonal
    # 64-row tiles (S exp(cs_i - cs_j)) dt_j; below them the decay is
    # factored at e, the last row of j's tile: (S exp(cs_i - cs_e)) v_j with
    # v_j = exp(cs_e - cs_j) dt_j
    S = _matmul(Cc, Bc.transpose(-1, -2), m_cb)
    i = torch.arange(chunk)
    tile = i // TILE
    cs_e = cs[..., torch.clamp(tile * TILE + TILE - 1, max=chunk - 1)]
    v = torch.exp(cs_e - cs) * dtc
    below = tile[:, None] > tile[None, :]
    ninf = torch.tensor(float("-inf"))
    u = torch.exp(torch.where(below, cs[..., :, None] - cs_e[..., None, :], ninf))
    on = ~below & (i[:, None] >= i[None, :])
    decay = torch.exp(torch.where(on, cs[..., :, None] - cs[..., None, :], ninf))
    P = torch.where(below, S * u * v[..., None, :], S * decay * dtc[..., None, :])
    y = _matmul(Cc, s_in.transpose(-1, -2), m_in) * torch.exp(cs)[..., None]
    y = y + _matmul(P, xc, m_px) + D[None, None, :, None, None] * xc
    y = y.permute(0, 1, 3, 2, 4).reshape(b, l, nh, hd)
    return y.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32), run


# tests/test_torch_kernels.py's SSD_CASES: (b, l, nh, hd, ds, chunk)
SSD_CASES = {
    "small": (2, 64, 4, 16, 16, 16),
    "wider": (1, 128, 2, 32, 64, 32),
    "mamba2_tile": (2, 64, 4, 64, 128, 64),
    "single_chunk": (1, 64, 1, 16, 16, 64),
}
# mamba2-780m's heads at a 1024-token request: 4 chunks of 256
CARD_SHAPE = (1, 1024, 48, 64, 128, 256)


def _inputs(case, dtype, seed=0):
    """tests/test_kernels.py's inputs: x, dt, B, C in ``dtype``."""
    b, l, nh, hd, ds = case[:5]
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.standard_normal((b, l, nh, hd)).astype(np.float32).astype(np_dt)
    dt = rng.uniform(0.01, 0.5, (b, l, nh)).astype(np_dt)
    A = -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32).astype(np_dt)
    C = rng.standard_normal((b, l, ds)).astype(np.float32).astype(np_dt)
    D = rng.standard_normal((nh,)).astype(np.float32)
    return x, dt, A, B, C, D


def _torch(arrs):
    """The kernel's operands: x, B, C as float32 tensors holding the values,
    dt float32 (the kernel takes dt in float32)."""
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrs]


def _ratio(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 within ``tol``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_emulated_kernel_matches_pallas_and_ssd_chunked(name, dtype):
    case = SSD_CASES[name]
    arrs = _inputs(case, dtype)
    y, st = emulate(*_torch(arrs), chunk=case[5], dtype=dtype)
    jarrs = [jnp.asarray(a) for a in arrs]
    for want_y, want_st in (pallas_ssd(*jarrs, chunk=case[5], interpret=True),
                            jax_ssd_chunked(*jarrs, chunk=case[5])):
        assert _ratio(y.float(), want_y, TOL[dtype]) <= 1
        assert _ratio(st, want_st, STATE_TOL) <= 1


def test_emulated_kernel_at_mamba2_width_bf16():
    """mamba2-780m's heads, l 1024, 4 chunks, against ssd_chunked."""
    arrs = _inputs(CARD_SHAPE, "bfloat16")
    y, st = emulate(*_torch(arrs), chunk=CARD_SHAPE[5], dtype="bfloat16")
    want_y, want_st = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=CARD_SHAPE[5])
    assert _ratio(y.float(), want_y, TOL["bfloat16"]) <= 1
    assert _ratio(st, want_st, STATE_TOL) <= 1


def test_emulated_kernel_at_mamba2_width_f32():
    """The same shape in float32 against ssd_chunked: y at 2e-5, the state
    at 1e-3 (the prefix sum in the reference's order makes 2e-5 reachable)."""
    arrs = _inputs(CARD_SHAPE, "float32")
    y, st = emulate(*_torch(arrs), chunk=CARD_SHAPE[5], dtype="float32")
    want_y, want_st = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=CARD_SHAPE[5])
    assert _ratio(y, want_y, TOL["float32"]) <= 1
    assert _ratio(st, want_st, STATE_TOL) <= 1


def test_float32_y_at_mamba2_width_depends_on_the_prefix_sum_order(monkeypatch):
    """The port's plain version holds y to ssd_chunked at 2e-5 at mamba2
    width with the prefix sum in XLA's order.  ``torch.cumsum`` in its place
    (on the CPU it accumulates float32 in double) moves cs, which reaches
    about -80, by a few ulps, the decays by 1e-5 relative, and y past 2e-5;
    the state holds 1e-3 either way."""
    arrs = _inputs(CARD_SHAPE, "float32")
    t = _torch(arrs)
    want_y, want_st = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=CARD_SHAPE[5])
    ref_y, ref_st = ssd_ref(*t, chunk=CARD_SHAPE[5])
    assert _ratio(ref_y, want_y, TOL["float32"]) <= 1
    assert _ratio(ref_st, want_st, STATE_TOL) <= 1
    monkeypatch.setattr(ssd_ref_module, "prefix_sum", lambda x, dim: torch.cumsum(x, dim))
    cum_y, cum_st = ssd_ref(*t, chunk=CARD_SHAPE[5])
    assert _ratio(cum_y, want_y, TOL["float32"]) > 1
    assert _ratio(cum_st, want_st, STATE_TOL) <= 1


@pytest.mark.parametrize("n", [1, 15, 16, 17, 256, 257, 1024, 4096, 5000])
def test_prefix_sum_is_jnp_cumsum_bit_for_bit(n):
    """Along axis 1 of (b, c, nh) under ``jax.jit``, as ssd_chunked takes
    it: the port's prefix sum gives jnp.cumsum's bits.  Control: a
    sequential float32 sum gives them only while n <= 17 (one block, or one
    element past it)."""
    rng = np.random.default_rng(n)
    da = (rng.uniform(0.01, 0.5, (2, n, 48)) * -rng.uniform(0.5, 2.0, 48)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(da)))
    got = ssd_ref_module.prefix_sum(torch.from_numpy(da), 1).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sequential = np.cumsum(da, axis=1, dtype=np.float32)
    assert np.array_equal(sequential, want) == (n <= 17)


@pytest.mark.parametrize("operand", ["p", "w", "s"])
def test_one_bf16_rounding_misses_a_tolerance(operand):
    """The controls: P (in P . x), x o w (in the chunk state) or S_in (in
    C . S_in^T) rounded once to bf16 instead of split misses y's 2e-2 or the
    state's 1e-3 at mamba2-780m's width, where the split design holds both."""
    arrs = _inputs(CARD_SHAPE, "bfloat16")
    t = _torch(arrs)
    ref_y, ref_st = ssd_ref(*t, chunk=CARD_SHAPE[5])
    ref_y = ref_y.bfloat16().float()
    y, st = emulate(*t, chunk=CARD_SHAPE[5], dtype="bfloat16")
    assert _ratio(y.float(), ref_y, TOL["bfloat16"]) <= 1
    assert _ratio(st, ref_st, STATE_TOL) <= 1
    y1, st1 = emulate(*t, chunk=CARD_SHAPE[5], dtype="bfloat16", round_=(operand,))
    worst = max(_ratio(y1.float(), ref_y, TOL["bfloat16"]), _ratio(st1, ref_st, STATE_TOL))
    assert worst > 1, f"rounding {operand} once stays within the tolerances ({worst:.2f})"


def test_single_term_tf32_fails_the_float32_tolerance():
    """One TF32 product keeps about three decimal digits: it misses 2e-5
    where 3xTF32 holds it."""
    case = SSD_CASES["mamba2_tile"]
    t = _torch(_inputs(case, "float32"))
    ref_y, _ = ssd_ref(*t, chunk=case[5])
    y3, _ = emulate(*t, chunk=case[5], dtype="float32")
    y1, _ = emulate(*t, chunk=case[5], dtype="float32", f32="tf32")
    assert _ratio(y3, ref_y, TOL["float32"]) <= 1
    assert _ratio(y1, ref_y, TOL["float32"]) > 1


def test_rounded_tf32_split_beats_truncation_at_mamba2_width(monkeypatch):
    """hi and lo rounded to nearest halve the float32 error of truncated
    splits (unbiased, 2^-24 against 2^-22 of each operand): at mamba2 width
    truncation spends 90 % of the 2e-5 tolerance on the emulation alone.
    The emulation and the plain version share one prefix sum, so only the
    products differ; it is held at ``torch.cumsum``'s order, on whose data
    the reading was taken (with XLA's order it reads 0.77)."""
    monkeypatch.setattr(ssd_ref_module, "prefix_sum", lambda x, dim: torch.cumsum(x, dim))
    t = _torch(_inputs(CARD_SHAPE, "float32"))
    ref_y, _ = ssd_ref(*t, chunk=CARD_SHAPE[5])
    rn, _ = emulate(*t, chunk=CARD_SHAPE[5], dtype="float32")
    tr, _ = emulate(*t, chunk=CARD_SHAPE[5], dtype="float32", f32="3xtf32_trunc")
    err_rn, err_tr = (float((y - ref_y).abs().max()) for y in (rn, tr))
    assert err_rn < 0.75 * err_tr
    assert _ratio(tr, ref_y, TOL["float32"]) > 0.8


# ---------------------------------------------------------- the launch plan

def _ssm_configs():
    out = []
    for name in list_archs():
        cfg = get_config(name)
        if not cfg.ssm_state:
            continue
        out += [(name, cfg), (name + "-reduced", reduced(cfg))]
    return out


# tests/test_torch_cuda.py's SSD_CASES shapes and chip_smoke.py's
CUDA_SHAPES = {
    "mamba2_two_chunks": (1, 512, 8, 64, 128, 256),
    "one_chunk": (2, 64, 4, 64, 128, 64),
    "ragged_tiles": (1, 192, 3, 32, 16, 96),
    "reduced_mamba2": (2, 96, 8, 32, 16, 32),
    "narrow_many_chunks": (2, 64, 4, 16, 16, 16),
    "odd_dims": (1, 80, 3, 24, 40, 40),
    "many_chunks": (1, 4096, 8, 64, 128, 256),
    "jamba_narrow": (1, 128, 128, 64, 16, 64),
    "mamba2_l1024": (1, 1024, 48, 64, 128, 256),
    "jamba_l1024": (1, 1024, 128, 64, 16, 256),
    "mamba2_l8192": (1, 8192, 48, 64, 128, 256),
}


def _check_plan(plan, dtype, b, l, nh, hd, ds, chunk):
    assert plan.head_pad == 64 >= hd and plan.state_pad in (64, 128)
    assert plan.state_pad >= ds and (plan.state_pad == 64 or ds > 64)
    assert plan.chunk_pad == plan.row_tiles * 64 >= chunk > plan.chunk_pad - 64
    assert plan.chunks == l // chunk
    assert max(plan.smem_state, plan.smem_scan) <= SMEM_PER_BLOCK
    split = plan.state_pad // 64 if dtype == torch.float32 else 1  # float32: 64 ds a CTA
    assert plan.grid_state == (b * l // chunk, nh, split)
    assert plan.grid_scan == (b * l // chunk, nh, plan.row_tiles)
    assert plan.grid_pass[0] * 1024 >= hd * ds and plan.grid_pass[1:] == (nh, b)
    assert plan.kernels == KERNELS_PER_CALL[dtype] == (4 if dtype == torch.float32 else 3)
    if dtype == torch.float32:  # C.B^T once per (batch x chunk, tile pair j <= i)
        assert plan.grid_cb == (b * l // chunk, plan.row_tiles * (plan.row_tiles + 1) // 2)
        assert 0 < plan.smem_cb <= SMEM_PER_BLOCK
    else:
        assert plan.smem_cb == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cfg", _ssm_configs(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_plan_takes_every_ssm_config(name, cfg, dtype):
    chunk = cfg.ssm_chunk
    for l in (chunk, 4 * chunk):
        plan = launch_plan(dtype, cfg.ssm_head_dim, cfg.ssm_state, chunk, batch=2,
                           heads=cfg.ssm_heads, seq=l)
        _check_plan(plan, dtype, 2, l, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CUDA_SHAPES))
def test_plan_takes_every_cuda_shape(name, dtype):
    b, l, nh, hd, ds, chunk = CUDA_SHAPES[name]
    plan = launch_plan(dtype, hd, ds, chunk, batch=b, heads=nh, seq=l)
    _check_plan(plan, dtype, b, l, nh, hd, ds, chunk)


def test_grid_is_chunk_parallel_at_mamba2():
    """b 1, l 1024: 192 chunk-state CTAs and 768 chunk-scan CTAs, against
    the 48 (one per head) of a kernel that walks the chunks in order."""
    plan = launch_plan(torch.bfloat16, 64, 128, 256, batch=1, heads=48, seq=1024)
    assert plan.grid_state == (4, 48, 1) and plan.grid_scan == (4, 48, 4)
    assert plan.ctas == 768 > 48
    assert 3 * (plan.smem_scan + 1024) <= 233_472  # three chunk-scan CTAs an SM


def test_every_plan_is_an_instantiation():
    """The launcher refuses a plan it has no instantiation for: every
    (dtype, ds) the plan takes maps to one (dtype, padded ds) that the
    source instantiates, and the source's shared-memory sizes are the plan's."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "ssd_scan.cu").read_text()
    inst = set(re.findall(r"launch<(float|__nv_bfloat16), (\d+)>", src))
    assert inst
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    seen = set()
    for dtype in names:
        for ds in range(8, 129, 8):
            for hd in range(8, 65, 8):
                p = launch_plan(dtype, hd, ds, 256)
                seen.add((names[dtype], str(p.state_pad)))
    assert seen == inst
    # the source's layout: C_i, stage 0, the region of the entering state
    # and stage 1, 7 x 64 floats and 1 KiB of alignment; a ring of x and B
    # tiles, then 2 c floats and the prefix sum's 272 block totals
    assert "kBBytes + kStage + kR1 + 7 * kT * 4 + 1024" in src
    assert "kStateTiles + 8 * c + 4 * kScanTotals + 1024" in src
    assert "kScanTotals = kMaxChunk / kScanBlock + kScanBlock" in src
    assert "kScanBlock = 16;" in src
    assert "kStages = sizeof(T) == 2 ? 4 : 2" in src
    assert "kStateTiles = kStages * (kXBytes + kStateB)" in src
    assert "kStateW = sizeof(T) == 4 ? 64 : DSP" in src
    p = launch_plan(torch.bfloat16, 64, 128, 256)
    assert p.smem_scan == 16384 + 24576 + 2 * 16384 + 7 * 64 * 4 + 1024
    assert p.smem_state == 4 * (8192 + 16384) + 8 * 256 + 4 * 272 + 1024
    p = launch_plan(torch.float32, 64, 128, 4096)
    assert p.smem_scan == 32768 + 16384 + 32768 + 7 * 64 * 4 + 1024  # no B_j tiles
    assert 2 * (p.smem_scan + 1024) <= 233_472  # two float32 chunk-scan CTAs an SM
    assert p.smem_cb == 2 * 32768 + 1024
    assert "kCBSmem = 2 * kBBytes + 1024" in src
    assert p.smem_state == 2 * (16384 + 16384) + 8 * 4096 + 4 * 272 + 1024  # 64 ds columns


@pytest.mark.parametrize("hd,ds,chunk,match", [
    (20, 16, 64, "head dim 20 is not a multiple of 8"),
    (72, 16, 64, "head dim 72"),
    (64, 12, 64, "state size 12 is not a multiple of 8"),
    (64, 136, 64, "state size 136"),
    (64, 16, 4097, "chunk 4097"),
])
def test_plan_refuses_what_it_cannot_tile(hd, ds, chunk, match):
    with pytest.raises(ValueError, match=match):
        launch_plan(torch.bfloat16, hd, ds, chunk)


def test_plan_refuses_other_dtypes_and_ragged_lengths():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch_plan(torch.float16, 64, 128, 256)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        launch_plan(torch.float32, 64, 128, 256, seq=300)


def test_alignment_takes_the_mixers_views_and_refuses_the_rest():
    """x, B, C as slices of xBC pass whenever hd and ds are multiples of 8;
    a row stride or base that is not a multiple of 16 bytes is refused."""
    for nh, hd, ds, dtype in ((48, 64, 128, torch.bfloat16), (3, 24, 40, torch.bfloat16),
                              (3, 24, 40, torch.float32), (128, 64, 16, torch.bfloat16)):
        d_in = nh * hd
        xbc = torch.zeros((2, 8, d_in + 2 * ds), dtype=dtype)
        x = xbc[..., :d_in].reshape(2, 8, nh, hd)
        for name, t in (("x", x), ("B", xbc[..., d_in:d_in + ds]), ("C", xbc[..., d_in + ds:])):
            assert alignment_problem(name, t.data_ptr(), t.shape, t.stride(),
                                     t.element_size()) is None, (name, nh, hd, ds, dtype)
    odd = torch.zeros((1, 8, 33))[..., :32]           # rows of 132 bytes
    why = alignment_problem("B", odd.data_ptr(), odd.shape, odd.stride(), 4)
    assert why is not None and "132 bytes" in why
    shifted = torch.zeros((1, 8, 40))[..., 1:33]       # base 4 bytes in
    why = alignment_problem("C", shifted.data_ptr(), shifted.shape, shifted.stride(), 4)
    assert why is not None and "base address" in why
    s = torch.zeros((1, 8, 64))[..., ::2]
    assert "unit-stride" in alignment_problem("B", s.data_ptr(), s.shape, s.stride(), 4)
    one = torch.zeros((1, 1, 16)).as_strided((1, 1, 16), (3, 5, 1))  # never stepped
    assert alignment_problem("B", one.data_ptr(), one.shape, one.stride(), 4) is None
