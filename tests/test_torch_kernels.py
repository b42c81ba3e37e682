"""The port's kernels: plain versions against the Pallas kernels (run in
interpret mode, as ``tests/test_kernels.py`` runs them on the CPU), the
wrappers' dispatch, and the build.  The CUDA kernels themselves are tested
on the card by ``tests/test_torch_cuda.py``."""

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_int8 as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_int8_ref as jax_decode_int8_ref,
)
from repro.kernels.decode_attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.snapshot_patch import patch_apply as pallas_patch  # noqa: E402
from repro.kernels.ssd import ssd_scan as pallas_ssd  # noqa: E402
from repro.models.attention import decode_attention as jax_decode_attention  # noqa: E402
from repro.models.attention import naive_attention as jax_naive  # noqa: E402
from repro.models.ssm import causal_conv as jax_causal_conv  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import snapshot_patch as tpatch  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models.ssm import causal_conv  # noqa: E402


# ------------------------------------------------------------ snapshot_patch

def _patch_inputs(dtype, n, c, k, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        base = rng.integers(-100, 100, (n, c)).astype(np.int32)
        diff = rng.integers(-100, 100, (k, c)).astype(np.int32)
    else:
        base = rng.standard_normal((n, c)).astype(np.float32)
        diff = rng.standard_normal((k, c)).astype(np.float32)
        if dtype == "bfloat16":
            base, diff = base.astype(ml_dtypes.bfloat16), diff.astype(ml_dtypes.bfloat16)
    sel = np.full((n,), -1, np.int32)
    for j, r in enumerate(rng.choice(n, size=min(k, n), replace=False)):
        sel[r] = j % k
    return base, diff, sel


_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _to_torch(a, dtype):
    return to_tensor(a, _TORCH[dtype], "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,c,k", [(16, 128, 4), (64, 256, 64), (8, 512, 1)])
def test_patch_replace_plain_is_bit_exact_with_pallas(dtype, n, c, k):
    base, diff, sel = _patch_inputs(dtype, n, c, k)
    want = np.asarray(pallas_patch(jnp.asarray(base), jnp.asarray(diff), jnp.asarray(sel),
                                   mode="replace", interpret=True))
    got = tpatch.patch_apply_op(_to_torch(base, dtype), _to_torch(diff, dtype),
                                torch.from_numpy(sel), mode="replace")
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_array_equal(_bits(got), np.ascontiguousarray(want).view(np.uint8))


def test_patch_replace_on_byte_views_is_dtype_agnostic():
    """The worker's route: bf16 rows moved as uint8 give the same bits."""
    base, diff, sel = _patch_inputs("bfloat16", 16, 64, 4)
    tb, td = _to_torch(base, "bfloat16"), _to_torch(diff, "bfloat16")
    by_bytes = tpatch.patch_apply_op(tb.view(torch.uint8), td.view(torch.uint8),
                                     torch.from_numpy(sel))
    direct = tpatch.patch_apply_op(tb, td, torch.from_numpy(sel))
    np.testing.assert_array_equal(by_bytes.numpy(), _bits(direct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_add_plain_matches_pallas(dtype):
    """f32: same operations in the same order (XLA may contract to an FMA,
    hence 1e-6); bf16: the port rounds once from f32, the Pallas kernel after
    each bf16 op → one bf16 ulp (2^-8 relative)."""
    base, diff, sel = _patch_inputs(dtype, 32, 128, 8, seed=1)
    want = np.asarray(pallas_patch(jnp.asarray(base), jnp.asarray(diff), jnp.asarray(sel),
                                   mode="add", scale=0.5, interpret=True), np.float32)
    got = tpatch.patch_apply_op(_to_torch(base, dtype), _to_torch(diff, dtype),
                                torch.from_numpy(sel), mode="add", scale=0.5)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    untouched = sel < 0
    np.testing.assert_array_equal(_bits(got[torch.from_numpy(untouched)]),
                                  _bits(_to_torch(base, dtype)[torch.from_numpy(untouched)]))


def test_patch_wrapper_routes():
    base = torch.zeros((4, 8))
    diff = torch.ones((1, 8))
    sel = torch.tensor([0, -1, 0, -1], dtype=torch.int32)
    before = tpatch.launches.value
    out = tpatch.patch_apply_op(base, diff, sel)
    assert out[0].eq(1).all() and out[1].eq(0).all()
    assert tpatch.launches.value == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        tpatch.patch_apply(base, diff, sel)  # the kernel wrapper takes CUDA only
    with pytest.raises(ValueError, match="devices"):
        tpatch.patch_apply_op(base.to("meta"), diff.to("meta"), sel.to("meta"))
    with pytest.raises(ValueError, match="at least one row"):
        tpatch.patch_apply_op(base, diff[:0], sel)
    with pytest.raises(TypeError, match="add mode"):
        tpatch.patch_apply_op(base.int(), diff.int(), sel, mode="add")


# ----------------------------------------------------------- flash_attention

# (b, nh, nkv, S, hd, causal, window, softcap, block)
FLASH_CASES = {
    "mha_causal": (2, 4, 4, 128, 32, True, 0, 0.0, 32),
    "bidirectional": (1, 2, 2, 64, 16, False, 0, 0.0, 32),
    "gqa_4to1": (1, 8, 2, 64, 32, True, 0, 0.0, 32),
    "mqa": (2, 4, 1, 64, 32, True, 0, 0.0, 16),
    "window_16": (1, 4, 4, 128, 16, True, 16, 0.0, 32),
    "softcap_20": (1, 4, 2, 64, 32, True, 0, 20.0, 32),
}


def _flash_inputs(case, dtype, seed=0):
    b, nh, nkv, S, hd = case[:5]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, nh, S, hd), (b, nkv, S, hd), (b, nkv, S, hd))]
    if dtype == "bfloat16":
        xs = [x.astype(ml_dtypes.bfloat16) for x in xs]
    kw = dict(scale=hd ** -0.5, causal=case[5], window=case[6], softcap=case[7])
    return xs, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(name, dtype):
    """f32 2e-5 (summation order); bf16 2e-2 (as tests/test_kernels.py)."""
    case = FLASH_CASES[name]
    xs, kw = _flash_inputs(case, dtype)
    blk = case[8]
    want = pallas_flash(*(jnp.asarray(x) for x in xs), block_q=blk, block_k=blk,
                        interpret=True, **kw)
    got = tflash.attention_ref(*(_to_torch(x, dtype) for x in xs), **kw)
    assert got.dtype == _TORCH[dtype]
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # and the JAX plain version, on the same inputs
    ref = jax_attention_ref(*(jnp.asarray(x) for x in xs), **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("S", [4, 37, 100])
def test_flash_op_ragged_lengths_match_jax_naive(S):
    """The op takes the model layout and any S (the Pallas kernel needs
    S % block == 0; the JAX naive oracle does not)."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((1, S, h, 32)).astype(np.float32) for h in (4, 2, 2))
    kw = dict(scale=32 ** -0.5, causal=True, window=16)
    got = tflash.flash_attention_op(*(torch.from_numpy(x) for x in (q, k, v)),
                                    softcap=0.0, **kw)
    want = jax_naive(*(jnp.asarray(x) for x in (q, k, v)), logit_softcap=0.0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_wrapper_routes():
    q = torch.zeros((1, 2, 8, 16))
    before = tflash.launches.value
    tflash.flash_attention_op(q, q, q, scale=0.25)
    assert tflash.launches.value == before
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q, scale=0.25)


# ----------------------------------------------------------------------- ssd

# (b, l, nh, hd, ds, chunk): tests/test_kernels.py's TestSSD shapes
SSD_CASES = {
    "small": (2, 64, 4, 16, 16, 16),
    "wider": (1, 128, 2, 32, 64, 32),
    "mamba2_tile": (2, 64, 4, 64, 128, 64),
    "single_chunk": (1, 64, 1, 16, 16, 64),
}


def _ssd_inputs(case, dtype, seed=0):
    """tests/test_kernels.py's inputs: dt, like x, B and C, in ``dtype``."""
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


def _ssd_torch(arrs, dtype):
    x, dt, A, B, C, D = arrs
    return (_to_torch(x, dtype), _to_torch(dt, dtype), torch.from_numpy(A),
            _to_torch(B, dtype), _to_torch(C, dtype), torch.from_numpy(D))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_plain_matches_pallas_and_ssd_chunked(name, dtype):
    """y at tests/test_kernels.py's TOL (f32 2e-5, bf16 2e-2: y is rounded
    to bf16 per chunk), the f32 state at 1e-3 as there."""
    case = SSD_CASES[name]
    arrs = _ssd_inputs(case, dtype)
    y, st = tssd.ssd_ref(*_ssd_torch(arrs, dtype), chunk=case[5])
    assert y.dtype == _TORCH[dtype] and st.dtype == torch.float32
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    jarrs = [jnp.asarray(a) for a in arrs]
    for want_y, want_st in (pallas_ssd(*jarrs, chunk=case[5], interpret=True),
                            jax_ssd_chunked(*jarrs, chunk=case[5])):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=1e-3, atol=1e-3)


def test_ssd_op_routes():
    arrs = _ssd_torch(_ssd_inputs(SSD_CASES["small"], "float32"), "float32")
    before = tssd.launches.value
    y, st = tssd.ssd_op(*arrs, chunk=16)
    assert tssd.launches.value == before  # the plain version is no launch
    want_y, want_st = tssd.ssd_ref(*arrs, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(*arrs, chunk=16)  # the kernel wrapper takes CUDA only
    with pytest.raises(ValueError, match="devices"):
        tssd.ssd_op(*arrs[:5], arrs[5].to("meta"), chunk=16)


def test_ssd_length_rule_matches_jax():
    """``chunk = min(chunk, l)``, and a length that is not a multiple of the
    chunk is refused by both packages (a 300-token request at chunk 256)."""
    arrs = _ssd_inputs((1, 300, 2, 16, 16), "float32")
    with pytest.raises(AssertionError):
        jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=256)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssd.ssd_op(*_ssd_torch(arrs, "float32"), chunk=256)
    short = _ssd_inputs((1, 48, 2, 16, 16), "float32")  # l < chunk: one chunk of 48
    y, _ = tssd.ssd_op(*_ssd_torch(short, "float32"), chunk=256)
    want, _ = jax_ssd_chunked(*(jnp.asarray(a) for a in short), chunk=256)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    """The same f32 tap loop, cast once: f32 1e-6; bf16 one ulp (2^-8)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 24)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    w = (rng.standard_normal((4, 24)) * 0.1).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    got = causal_conv(_to_torch(x, dtype), torch.from_numpy(w), torch.from_numpy(b))
    want = jax_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == _TORCH[dtype]
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------- decode_attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """Round half to even in both: int8 values bit-equal, scales equal."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 300, 4, 64)) * 3).astype(np.float32)
    x[0, :5, 0, :] = 0.0                       # all-zero rows: scale 1e-12
    x[1, 7, 1, :4] = [127.0, -63.5, 0.5, 1.5]  # ties at .5
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    got_q, got_s = tdec.quantize_kv(_to_torch(x, dtype))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(tdec.dequantize_kv(got_q, got_s).numpy(),
                               np.asarray(x, np.float32), rtol=0, atol=float(got_s.max()))


def _int8_inputs(b, nh, nkv, S, hd, seed=0):
    """tests/test_kernels.py's inputs: f32 q, K and V quantised by JAX."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    kf = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    vf = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    k, ks = jax_quantize_kv(jnp.asarray(kf))
    v, vs = jax_quantize_kv(jnp.asarray(vf))
    return q, kf, vf, [np.array(a) for a in (k, ks, v, vs)]


@pytest.mark.parametrize("pos_frac", [0.3, 1.0])
@pytest.mark.parametrize("b,nh,nkv,S,hd,bs", [
    (2, 4, 2, 128, 32, 32),   # GQA 2:1
    (1, 8, 1, 256, 64, 64),   # MQA
    (2, 4, 4, 128, 32, 128),  # MHA, single block
])
def test_decode_int8_plain_matches_pallas(b, nh, nkv, S, hd, bs, pos_frac):
    """tests/test_kernels.py's shapes and tolerance (2e-5): the Pallas
    kernel in interpret mode against the port's plain version."""
    q, _, _, quant = _int8_inputs(b, nh, nkv, S, hd)
    pos = int(pos_frac * (S - 1))
    want = pallas_decode(jnp.asarray(q), *(jnp.asarray(a) for a in quant),
                         jnp.asarray(pos, jnp.int32), scale=hd ** -0.5, block_s=bs,
                         interpret=True)
    got = tdec.decode_attention_int8_op(torch.from_numpy(q),
                                        *(torch.from_numpy(a) for a in quant),
                                        torch.tensor([pos], dtype=torch.int32),
                                        scale=hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_decode_int8_quantization_error_within_2pct():
    """tests/test_kernels.py's bound: against the model-dtype decode path
    on the unquantised cache, err / max|ref| < 2%."""
    b, nh, nkv, S, hd = 2, 8, 4, 256, 64
    q, kf, vf, quant = _int8_inputs(b, nh, nkv, S, hd, seed=1)
    got = tdec.decode_attention_int8_op(torch.from_numpy(q),
                                        *(torch.from_numpy(a) for a in quant), S - 1,
                                        scale=hd ** -0.5)
    full = jax_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(kf), jnp.asarray(vf),
                                jnp.asarray(S - 1, jnp.int32), scale=hd ** -0.5)[:, 0]
    full = np.asarray(full)
    assert np.abs(got.numpy() - full).max() / np.abs(full).max() < 0.02


@pytest.mark.parametrize("S,pos", [(100, 77), (37, 36), (300, 0)])
def test_decode_int8_ragged_S_matches_jax_ref(S, pos):
    """Any S (the Pallas kernel needs S % block == 0; JAX's plain version
    does not)."""
    q, _, _, quant = _int8_inputs(1, 4, 2, S, 32, seed=S)
    want = jax_decode_int8_ref(jnp.asarray(q), *(jnp.asarray(a) for a in quant),
                               jnp.asarray(pos, jnp.int32), scale=32 ** -0.5)
    got = tdec.decode_attention_int8_op(torch.from_numpy(q),
                                        *(torch.from_numpy(a) for a in quant), pos,
                                        scale=32 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_decode_int8_op_routes():
    q, _, _, quant = _int8_inputs(1, 4, 2, 64, 32)
    args = [torch.from_numpy(q)] + [torch.from_numpy(a) for a in quant]
    before = tdec.launches.value
    out = tdec.decode_attention_int8_op(*args, 10, scale=0.2)
    assert tdec.launches.value == before  # the plain version is no launch
    assert torch.equal(out, tdec.decode_attention_int8_ref(*args, 10, scale=0.2))
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_int8(*args, 10, scale=0.2)  # the kernel takes CUDA only
    with pytest.raises(ValueError, match="devices"):
        tdec.decode_attention_int8_op(*args[:4], args[4].to("meta"), 10, scale=0.2)
    with pytest.raises(ValueError, match="devices"):
        tdec.decode_attention_int8_op(*args, torch.tensor([10], dtype=torch.int32,
                                                          device="meta"), scale=0.2)


# --------------------------------------------------------------------- build

def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["snapshot_patch"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["decode_attention_int8"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
