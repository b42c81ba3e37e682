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

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.snapshot_patch import patch_apply as pallas_patch  # noqa: E402
from repro.models.attention import naive_attention as jax_naive  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import snapshot_patch as tpatch  # noqa: E402


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


# --------------------------------------------------------------------- build

def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["snapshot_patch"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
