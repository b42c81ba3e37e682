"""The Hopper int8 decode-attention kernel's design, on the CPU.

The kernel (``src/repro_torch/csrc/decode_attention_int8.cu``) runs only on
the card.  What can be checked here is its arithmetic and its launch plan:

- the conversion of an int8 value to float: the byte, offset by 128, put
  into the mantissa of 2^23 by ``__byte_perm`` and 2^23 + 128 subtracted,
  checked as bits over all 256 values;
- an emulation in plain PyTorch of what the kernel computes: the live keys
  cut into 32-key slices, balanced over the splits of the plan; each of a
  CTA's 4 warps walking slices s_lo + warp, + 4, ... with its own online
  softmax (m uniform over the warp, l per lane); the warps merged per CTA,
  the CTAs per cluster, the clusters per (batch, kv head) over ``groups``;
  scores (q . k) k_scale scale and p v_scale.  It is held against the
  Pallas kernel in interpret mode and against ``decode_attention_int8_ref``
  at f32 2e-5 and bf16 2e-2 (the absolute term cut to 1e-2 of max|ref|, as
  on the card).  Controls: combining the splits without rescaling each to
  the common max, or applying the key scale after the softmax, misses;
- the launch plan (``launch_plan``): every attention configuration's decode
  shape, full and reduced, at b 1 and 8 and S up to 32768, runs as one
  kernel a call and fits the card; what the kernel cannot take is refused
  with its reason.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_int8 as pallas_decode  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    KEYS,
    MAX_CLUSTER,
    ROWS,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    STAGES,
    WARPS,
    CLUSTER_FILL,
    check_shape,
    launch_plan,
    scratch_elements,
    smem_layout,
)

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "decode_attention_int8.cu").read_text()
H100_SMS = 132
NEG_INF = -1e30


# ------------------------------------------------------ the int8 conversion

def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)``: byte i of the result is byte
    (sel >> 4 i) & 7 of the 8 bytes x0..x3 y0..y3."""
    src = np.concatenate([x.astype(np.uint32)[:, None] >> (8 * np.arange(4, dtype=np.uint32)),
                          np.full((len(x), 4), y, np.uint32) >> (8 * np.arange(4, dtype=np.uint32))],
                         axis=1) & 0xFF
    out = np.zeros(len(x), np.uint32)
    for i in range(4):
        out |= src[:, (sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def test_int8_conversion_is_exact_for_every_value():
    """The source's conversion, as bits: for every int8 value in every byte
    of a word, (word ^ 0x80808080) permuted into 0x4B000000 with selectors
    0x7650..0x7653, as a float, minus 8388736 is the value."""
    assert "0x80808080u" in SRC and "8388736.f" in SRC
    sels = [int(s, 16) for s in re.findall(r"__byte_perm\(u\[i\], 0x4B000000u, (0x765[0-3])\)", SRC)]
    assert sels == [0x7650, 0x7651, 0x7652, 0x7653]
    vals = np.arange(-128, 128, dtype=np.int32)
    for pos in range(4):
        other = np.roll(vals, 37 * (pos + 1))       # the other bytes of the word
        words = np.zeros(256, np.uint32)
        for j in range(4):
            b = vals if j == pos else np.roll(other, j)
            words |= (b.astype(np.uint32) & 0xFF) << np.uint32(8 * j)
        for j, sel in enumerate(sels):
            bits = _byte_perm(words ^ np.uint32(0x80808080), 0x4B000000, sel)
            got = bits.view(np.float32) - np.float32(8388736.0)
            want = vals if j == pos else np.roll(other, j)
            np.testing.assert_array_equal(got, want.astype(np.float32))


# ------------------------------------------------------------ the emulation

def emulate(q, k, ks, v, vs, pos, *, scale, plan, seq=None, rescale=True,
            scale_after_softmax=False):
    """The kernel's arithmetic on CPU tensors, at ``plan`` for a cache of
    ``seq`` keys (default k's length; k may hold only the live keys).  A CTA
    takes ``plan.heads`` kv heads and stages of ``plan.stage_keys`` keys;
    warp w takes 32 keys of head w % H in each stage (the keys after w // H
    tasks of 32).  ``rescale=False``: splits combined without rescaling
    each to the common max; ``scale_after_softmax``: k_scale applied to p
    instead of the score (the controls)."""
    b, nh, hd = q.shape
    nkv = k.shape[2]
    seq = k.shape[1] if seq is None else seq
    rep = nh // nkv
    R, RB, N, C, G = plan.rows, plan.row_blocks, plan.splits, plan.cluster, plan.groups
    KS, WPH = plan.stage_keys, WARPS // plan.heads     # keys of a stage, warps of a head
    live = max(0, min(int(pos) + 1, seq))
    qf = torch.zeros((b, nkv, RB * R, hd))
    qf[:, :, :rep] = q.float().reshape(b, nkv, rep, hd)
    qf = qf.reshape(b, nkv, RB, R, hd)
    nst = -(-live // KS)
    lo = torch.tensor([n * nst // N for n in range(N)])
    hi = torch.tensor([(n + 1) * nst // N for n in range(N)])
    steps = int((hi - lo).max()) if live else 0
    # per (batch, kv head, row block, split, warp of the head, row)
    m = torch.full((b, nkv, RB, N, WPH, R), NEG_INF)
    lane_l = torch.zeros((b, nkv, RB, N, WPH, R, KEYS))
    acc = torch.zeros((b, nkv, RB, N, WPH, R, hd))
    sub = torch.arange(WPH)
    for t in range(steps):
        st = lo + t                                                     # (N,)
        keys = (st[:, None, None] * KS + sub[None, :, None] * KEYS
                + torch.arange(KEYS))                                   # (N, WPH, 32)
        valid = (st < hi)[:, None, None] & (keys < live)
        idx = keys.clamp(max=live - 1)
        kk = k[:, idx].float().permute(0, 4, 1, 2, 3, 5)                 # (b, g, N, WPH, 32, hd)
        vv = v[:, idx].float().permute(0, 4, 1, 2, 3, 5)
        kss = ks[:, idx].permute(0, 4, 1, 2, 3)[:, :, None, :, :, None]  # (b, g, 1, N, WPH, 1, 32)
        vss = vs[:, idx].permute(0, 4, 1, 2, 3)[:, :, None, :, :, None]
        s = torch.einsum("bgxrd,bgnwjd->bgxnwrj", qf, kk)
        s = s * scale if scale_after_softmax else s * (kss * scale)
        s = torch.where(valid[:, :, None], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid[:, :, None], torch.exp(s - m_new[..., None]), torch.tensor(0.0))
        lane_l = lane_l * alpha[..., None] + p
        pv = p * vss * (kss if scale_after_softmax else 1.0)
        acc = acc * alpha[..., None] + torch.einsum("bgxnwrj,bgnwjd->bgxnwrd", pv, vv)
        m = m_new
    l = lane_l.sum(-1)

    def merge(m, l, acc, dim, rescale):
        M = m.amax(dim)
        w = torch.exp(m - M.unsqueeze(dim)) if rescale else torch.ones_like(m)
        return M, (w * l).sum(dim), (w[..., None] * acc).sum(dim)

    m, l, acc = merge(m, l, acc, 4, True)                              # warps of a head
    m, l, acc = (t.unflatten(3, (G, C)) for t in (m, l, acc))
    m, l, acc = merge(m, l, acc, 4, rescale)                           # CTAs of a cluster
    m, l, acc = merge(m, l, acc, 3, rescale)                           # clusters
    out = acc / l.clamp(min=1e-30)[..., None]                          # (b, g, RB, R, hd)
    out = out.reshape(b, nkv, RB * R, hd)[:, :, :rep].reshape(b, nh, hd)
    return out.to(q.dtype)


# (b, nh, nkv, S, hd, pos): tests/test_torch_cuda.py's DECODE_CASES, the
# stablelm-3b decode path's shape, mistral-nemo and MQA at S 32768 (the
# second level), pos < 0 and pos past S
SHAPES = {
    "gqa_2to1": (2, 4, 2, 128, 32, 38),
    "mqa_8to1": (1, 8, 1, 256, 64, 255),
    "mha_one_tile": (2, 4, 4, 128, 32, 127),
    "stablelm_3b": (1, 32, 32, 2048, 80, 1055),
    "ragged_S": (2, 4, 2, 1000, 32, 999),
    "ragged_S_mid": (1, 4, 2, 333, 16, 200),
    "mistral_nemo_gqa": (2, 32, 8, 4096, 128, 3000),
    "head_dim_256": (1, 2, 1, 300, 256, 150),
    "stablelm_3b_32k": (1, 32, 32, 32768, 80, 32767),
    "mistral_nemo_32k_mid": (4, 32, 8, 32768, 128, 20000),
    "many_small_tiles": (4, 8, 8, 8192, 32, 8191),
    "stablelm_3b_path": (1, 32, 32, 2048, 80, 1039),
    "mistral_nemo_32k": (1, 32, 8, 32768, 128, 32767),
    "mqa_32k": (1, 8, 1, 32768, 256, 32767),
    "pos_negative": (1, 4, 2, 256, 32, -1),
    "pos_past_S": (1, 4, 2, 100, 32, 150),
    "two_heads_a_cta": (8, 4, 2, 32768, 64, 30000),
}


def _inputs(b, nh, nkv, S, hd, pos, dtype, seed=0):
    """q in ``dtype``; int8 K and V and their scales, for the live keys
    only (the rest are never read), as quantize_kv makes them: values in
    -127..127, scales max|x| / 127 of normals."""
    rng = np.random.default_rng(seed)
    live = max(1, min(pos + 1, S))
    q = torch.from_numpy(rng.standard_normal((b, nh, hd)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.integers(-127, 128, (b, live, nkv, hd), dtype=np.int8))
            for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.015, 0.03, (b, live, nkv)).astype(np.float32))
              for _ in range(2))
    return q, k, ks, v, vs


def _tol(dtype, ref):
    """chip_smoke's int8_tol: f32 2e-5; bf16 2e-2 with the absolute term
    cut to 1e-2 of max|ref|."""
    if dtype == torch.float32:
        return dict(rtol=2e-5, atol=2e-5)
    return dict(rtol=2e-2, atol=min(2e-2, 1e-2 * float(ref.float().abs().max())))


def _within(got, want, tol) -> bool:
    d = (got.float() - want.float()).abs()
    return bool((d <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulation_matches_plain_version(name, dtype):
    b, nh, nkv, S, hd, pos = SHAPES[name]
    q, k, ks, v, vs = _inputs(b, nh, nkv, S, hd, pos, dtype)
    plan = launch_plan(dtype, b, S, nh, nkv, hd, H100_SMS)
    got = emulate(q, k, ks, v, vs, pos, scale=hd ** -0.5, plan=plan, seq=S)
    assert got.dtype == dtype and got.shape == (b, nh, hd)
    if pos < 0:  # no live key: zeros, as the TPU kernel's empty sums give
        assert not got.float().abs().any()
        return
    want = tdec.decode_attention_int8_ref(q, k, ks, v, vs, min(pos, S - 1), scale=hd ** -0.5)
    assert _within(got, want, _tol(dtype, want)), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("pos_frac", [0.3, 1.0])
@pytest.mark.parametrize("b,nh,nkv,S,hd,bs", [
    (2, 4, 2, 128, 32, 32),   # GQA 2:1
    (1, 8, 1, 256, 64, 64),   # MQA
    (2, 4, 4, 128, 32, 128),  # MHA, single block
    (1, 32, 32, 2048, 80, 512),   # stablelm-3b's decode shape
])
def test_emulation_matches_pallas(b, nh, nkv, S, hd, bs, pos_frac):
    """tests/test_kernels.py's shapes and the decode path's, f32 q against
    the Pallas kernel in interpret mode at 2e-5."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    kf, vf = (rng.standard_normal((b, S, nkv, hd)).astype(np.float32) for _ in range(2))
    k, ks = tdec.quantize_kv(torch.from_numpy(kf))
    v, vs = tdec.quantize_kv(torch.from_numpy(vf))
    pos = int(pos_frac * (S - 1))
    want = pallas_decode(jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in (k, ks, v, vs)),
                         jnp.asarray(pos, jnp.int32), scale=hd ** -0.5, block_s=bs,
                         interpret=True)
    plan = launch_plan(torch.float32, b, S, nh, nkv, hd, H100_SMS)
    got = emulate(torch.from_numpy(q), k, ks, v, vs, pos, scale=hd ** -0.5, plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("control", ["no_rescale", "scale_after_softmax"])
@pytest.mark.parametrize("name", ["stablelm_3b_path", "mistral_nemo_32k"])
def test_controls_miss(name, control):
    """Splits combined without rescaling each to the common max, or the key
    scale applied after the softmax, miss the float32 tolerance that the
    design holds."""
    b, nh, nkv, S, hd, pos = SHAPES[name]
    q, k, ks, v, vs = _inputs(b, nh, nkv, S, hd, pos, torch.float32, seed=3)
    plan = launch_plan(torch.float32, b, S, nh, nkv, hd, H100_SMS)
    assert plan.splits > 1
    want = tdec.decode_attention_int8_ref(q, k, ks, v, vs, pos, scale=hd ** -0.5)
    kw = dict(scale=hd ** -0.5, plan=plan, seq=S)
    assert _within(emulate(q, k, ks, v, vs, pos, **kw), want, _tol(torch.float32, want))
    bad = emulate(q, k, ks, v, vs, pos, **kw, rescale=control != "no_rescale",
                  scale_after_softmax=control == "scale_after_softmax")
    assert not _within(bad, want, _tol(torch.float32, want))


# ---------------------------------------------------------- the launch plan

def _decode_shapes():
    out = []
    for name in list_archs():
        for cfg in (get_config(name), reduced(get_config(name))):
            if not cfg.num_kv_heads:
                continue
            for b in (1, 8):
                for S in (256, 2048, 32768):
                    out.append((name, cfg, b, S))
    return out


def _check_plan(plan, dtype, b, S, nh, nkv, hd):
    rep = nh // nkv
    H = plan.heads
    assert plan.kernels == 1
    assert H in (1, 2, 4) and nkv % H == 0
    assert plan.rows in ROWS and plan.rows * plan.row_blocks >= rep
    assert plan.rows * (plan.row_blocks - 1) < rep
    assert plan.rows >= min(rep, ROWS[-1])
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.splits == plan.cluster * plan.groups
    lay = smem_layout(plan.rows, hd, H)
    assert plan.smem == lay["smem"] <= SMEM_PER_BLOCK
    assert plan.stage_keys == lay["keys"] == KEYS * WARPS // H
    assert plan.units == b * (nkv // H) * plan.row_blocks
    fit = max(1, SMEM_PER_SM // (plan.smem + 1024))
    slots = min(H100_SMS * min(2, fit), int(H100_SMS * fit * CLUSTER_FILL))
    if plan.splits > 1:   # more splits only while every CTA runs in one wave
        assert plan.ctas <= slots
        assert plan.splits <= -(-S // plan.stage_keys)
    if plan.groups > 1:
        assert 4 <= plan.cluster <= MAX_CLUSTER
        tickets, partials = scratch_elements(H100_SMS)
        assert plan.tickets <= tickets and plan.partials <= partials
    assert 4 * (plan.groups + 1) * H * plan.rows <= lay["yoff"]
    assert lay["ring"] == STAGES * lay["stage"] <= lay["work"]
    assert lay["merge"] <= lay["yoff"] and 4 * (MAX_CLUSTER + 2) * H * plan.rows <= lay["yoff"]
    hr = H * plan.rows
    assert lay["yoff"] + 4 * (hr * hd + MAX_CLUSTER + 2 * MAX_CLUSTER * hr) <= lay["work"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cfg,b,S", _decode_shapes(),
                         ids=lambda x: x if isinstance(x, (str, int)) else "")
def test_plan_takes_every_decode_shape(name, cfg, b, S, dtype):
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    plan = launch_plan(dtype, b, S, nh, nkv, hd, H100_SMS)
    _check_plan(plan, dtype, b, S, nh, nkv, hd)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_takes_every_card_shape(name):
    b, nh, nkv, S, hd, _ = SHAPES[name]
    _check_plan(launch_plan(torch.bfloat16, b, S, nh, nkv, hd, H100_SMS), torch.bfloat16,
                b, S, nh, nkv, hd)


def test_plan_at_the_decode_paths():
    """stablelm-3b's decode step (b 1, 32 kv heads, S 2048): one head a CTA,
    one cluster of 8 per kv head, no second level, and at pos 1039 every
    stage of a CTA is in flight before it computes.  At S 32768 each CTA
    takes 4 heads (320-byte key rows); mistral-nemo and MQA at b 1 need the
    second level; stablelm-3b at b 8 needs none."""
    p = launch_plan(torch.bfloat16, 1, 2048, 32, 32, 80, H100_SMS)
    assert (p.heads, p.splits, p.cluster, p.groups, p.rows) == (1, 8, 8, 1, 1)
    live_stages = -(-1040 // p.stage_keys)
    assert -(-live_stages // p.splits) <= STAGES
    assert p.ctas == 256 and p.tickets == 0 and p.partials == 0
    long1 = launch_plan(torch.bfloat16, 1, 32768, 32, 32, 80, H100_SMS)
    assert long1.heads == 4 and smem_layout(1, 80, 4)["pitch"] == 16 * 21  # 20 chunks, odd
    nemo = launch_plan(torch.bfloat16, 1, 32768, 32, 8, 128, H100_SMS)
    assert nemo.heads == 4 and nemo.rows == 4 and nemo.groups > 1
    assert smem_layout(4, 128, 4)["swizzle"]  # 32 chunks a key row
    assert nemo.tickets == 2 * nemo.cluster and nemo.partials == 2 * nemo.groups * (16 * 128 + 32)
    mqa = launch_plan(torch.bfloat16, 1, 32768, 8, 1, 256, H100_SMS)
    assert mqa.heads == 1 and mqa.rows == 8 and mqa.groups > 1
    assert mqa.smem <= SMEM_PER_BLOCK
    b8 = launch_plan(torch.bfloat16, 8, 32768, 32, 32, 80, H100_SMS)
    assert b8.heads == 4 and b8.groups == 1


def test_plan_takes_one_head_until_warps_walk_long_ranges():
    """The choice of heads a CTA: one while a warp of that plan would walk
    fewer than LONG_SLICES slices of 32 keys, else the most that divide nkv."""
    from repro_torch.kernels.decode_attention.kernel import LONG_SLICES
    for b, S, nh, nkv, hd in ((1, 2048, 32, 32, 80), (1, 32768, 32, 32, 80),
                              (8, 32768, 4, 2, 64), (2, 4096, 32, 8, 128),
                              (4, 8192, 8, 8, 32), (1, 32768, 8, 1, 256)):
        one = launch_plan.__wrapped__(torch.float32, b, S, nh, nkv, hd, H100_SMS)
        lay1 = smem_layout(one.rows, hd, 1)
        stages1 = -(-S // lay1["keys"])
        fit = max(1, SMEM_PER_SM // (lay1["smem"] + 1024))
        slots1 = min(H100_SMS * min(2, fit), int(H100_SMS * fit * CLUSTER_FILL))
        n1 = max(1, min(slots1 // (b * nkv * one.row_blocks), stages1))
        if n1 > MAX_CLUSTER:
            n1 = max(n1 // c * c for c in range(4, MAX_CLUSTER + 1))
        long = -(-stages1 // n1) >= LONG_SLICES
        want = next(h for h in (4, 2, 1) if nkv % h == 0 and smem_layout(
            one.rows, hd, h)["smem"] <= SMEM_PER_BLOCK) if long else 1
        assert one.heads == want, (b, S, nh, nkv, hd)


def test_plan_keeps_within_the_clusters_the_card_holds():
    """Told how many clusters the card holds at once (the wrapper reads it),
    the plan takes fewer groups, or smaller clusters, to stay within it."""
    free = launch_plan(torch.float32, 1, 32768, 8, 1, 64, H100_SMS)
    assert free.units * free.groups == 32
    held = launch_plan(torch.float32, 1, 32768, 8, 1, 64, H100_SMS, 30)
    assert held.cluster == 8 and held.units * held.groups <= 30
    few = launch_plan(torch.float32, 8, 32768, 32, 8, 128, H100_SMS, 20)
    assert few.units * few.groups <= 20 and few.splits == few.cluster * few.groups
    _check_plan(held, torch.float32, 1, 32768, 8, 1, 64)


def test_plan_takes_fewer_heads_where_four_overflow_shared_memory():
    """rep 8 at hd 256 over 4 kv heads: four heads a CTA would need more
    than a CTA's shared memory, so a long cache takes two."""
    assert smem_layout(8, 256, 4)["smem"] > SMEM_PER_BLOCK
    p = launch_plan(torch.bfloat16, 8, 32768, 32, 4, 256, H100_SMS)
    assert p.heads == 2 and p.smem <= SMEM_PER_BLOCK


def test_plan_is_the_sources():
    """The launcher refuses a plan it has no instantiation for; the source's
    constants and shared-memory layout are the plan's."""
    assert set(int(r) for r in re.findall(r"case (\d+): return launch<T, \1>", SRC)) == set(ROWS)
    for const, val in (("kWarps", WARPS), ("kKeys", KEYS), ("kStages", STAGES),
                       ("kMaxCluster", MAX_CLUSTER)):
        assert re.search(rf"constexpr int {const} = {val};", SRC), const
    for line in ("L.keys = kKeys * kWarps / heads;",
                 "L.pitch = 16 * (L.swz ? L.hnc : (L.hnc | 1));",
                 "L.stage = 2 * L.keys * L.pitch + 2 * L.keys * heads * 4;",
                 "L.fixed = (4 * (hr * hd + 3 * kWarps * rows + 4) + 127) / 128 * 128;",
                 "const int merge = 4 * kWarps * L.kg * rows * hd;",
                 "const int comb = 4 * (kMaxCluster + 2) * hr;",
                 "const int recv = 4 * (hr * hd + kMaxCluster + 2 * kMaxCluster * hr);",
                 "L.yoff = merge > comb ? merge : comb;",
                 "if (smem != layout(R, p.hd, p.heads).smem) return kErrPlan;",
                 "4 * (groups + 1) * heads * rows > layout(rows, hd, heads).yoff)",
                 "int* ctr = p.ticket + bgr * C + crank;"):
        assert line in SRC, line
    lay = smem_layout(1, 80, 1)
    assert (lay["pitch"], lay["swizzle"], lay["stage"]) == (80, False, 2 * 128 * 80 + 1024)
    lay = smem_layout(4, 128, 4)
    assert (lay["pitch"], lay["swizzle"], lay["keys"]) == (512, True, 32)
    assert smem_layout(1, 64, 1)["pitch"] == 80   # 4 chunks padded to 5
    assert smem_layout(1, 80, 4)["pitch"] == 336  # 20 chunks padded to 21


@pytest.mark.parametrize("args,exc,match", [
    ((torch.float16, 1, 64, 4, 2, 32), TypeError, "float32 or bfloat16"),
    ((torch.float32, 1, 64, 4, 3, 32), ValueError, "do not group"),
    ((torch.float32, 1, 64, 4, 2, 24), ValueError, "head dim 24 is not a multiple of 16"),
    ((torch.float32, 1, 64, 4, 2, 272), ValueError, "head dim 272"),
    ((torch.float32, 1, 64, 128, 1, 128), ValueError, "a group of 128 heads x 128 exceeds 8192"),
    ((torch.float32, 1, 0, 4, 2, 32), ValueError, "unsupported sizes"),
    ((torch.float32, 70000, 64, 4, 2, 32), ValueError, "unsupported sizes"),
])
def test_plan_refuses_what_the_kernel_cannot_take(args, exc, match):
    with pytest.raises(exc, match=match):
        check_shape(*args)
    with pytest.raises(exc, match=match):
        launch_plan(*args, H100_SMS)


def test_groups_take_rows_past_eight_in_row_blocks():
    """rep above 8 (rep x hd up to 8192) runs in row blocks of 8."""
    p = launch_plan(torch.float32, 1, 1024, 512, 1, 16, H100_SMS)
    assert (p.rows, p.row_blocks) == (8, 64)
    q, k, ks, v, vs = _inputs(1, 24, 1, 256, 16, 200, torch.float32)
    plan = launch_plan(torch.float32, 1, 256, 24, 1, 16, H100_SMS)
    assert (plan.rows, plan.row_blocks) == (8, 3)
    got = emulate(q, k, ks, v, vs, 200, scale=0.25, plan=plan, seq=256)
    want = tdec.decode_attention_int8_ref(q, k, ks, v, vs, 200, scale=0.25)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
