"""The port's CUDA kernels and CUDA worker, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode), carries
the ``cuda`` marker and skips without one; the module imports neither JAX
nor the JAX package, so it also runs on a machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import to_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import snapshot_patch as tpatch
from repro_torch.models import build_model
from repro_torch.serving import ColdStartOptions, InvocationRequest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8])
@pytest.mark.parametrize("rows,cols", [(96, 4096), (33, 1001)])
def test_patch_replace_bit_exact(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(0)
    base = torch.randint(0, 100, (rows, cols), generator=g, device=cuda).to(dtype)
    diff = torch.randint(0, 100, (7, cols), generator=g, device=cuda).to(dtype)
    sel = torch.randint(-1, 7, (rows,), generator=g, device=cuda).to(torch.int32)
    before = tpatch.launches.value
    out = tpatch.patch_apply_op(base, diff, sel)
    assert tpatch.launches.value == before + 1
    ref = tpatch.patch_apply_ref(base, diff, sel)
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_add_bit_exact(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn((40, 512), generator=g, device=cuda).to(dtype)
    diff = torch.randn((5, 512), generator=g, device=cuda).to(dtype)
    sel = torch.randint(-1, 5, (40,), generator=g, device=cuda).to(torch.int32)
    out = tpatch.patch_apply_op(base, diff, sel, mode="add", scale=0.25)
    ref = tpatch.patch_apply_ref(base, diff, sel, mode="add", scale=0.25)
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


# (b, nh, nkv, S, hd, causal, window, softcap)
FLASH_CASES = {
    "mha_causal": (2, 4, 4, 128, 64, True, 0, 0.0),
    "bidirectional_ragged": (1, 2, 2, 77, 80, False, 0, 0.0),
    "gqa_4to1": (1, 8, 2, 64, 32, True, 0, 0.0),
    "mqa": (2, 4, 1, 37, 32, True, 0, 0.0),
    "window_16": (1, 4, 4, 128, 16, True, 16, 0.0),
    "softcap_20": (1, 4, 2, 64, 32, True, 0, 20.0),
    "head_dim_256": (1, 2, 1, 40, 256, True, 0, 0.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_matches_plain(cuda, name, dtype):
    """f32 2e-5 and bf16 2e-2, as tests/test_kernels.py holds the TPU kernel."""
    b, nh, nkv, S, hd, causal, window, softcap = FLASH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((b, S, h, hd), generator=g, device=cuda).to(dtype)
               for h in (nh, nkv, nkv))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap)
    before = tflash.launches.value
    out = tflash.flash_attention_op(q, k, v, **kw)
    assert tflash.launches.value == before + 1
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ref = tflash.attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_flash_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_attention(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="unit-stride"):
        tflash.flash_attention(torch.zeros((1, 4, 8, 32), device=cuda)[..., ::2], q, q,
                               scale=1.0)
    with pytest.raises(ValueError, match="group"):
        tflash.flash_attention(q, q[:, :3], q[:, :3], scale=1.0)


def test_worker_on_cuda_launches_both_kernels(cuda, tmp_path):
    from repro_torch.serving.trace import build_functions, request_tokens
    cfg = reduced(get_config("stablelm-3b"))
    worker, specs = build_functions(str(tmp_path), cfg, build_model(cfg), n_functions=3,
                                    device=cuda)
    tpatch.launches.reset()
    tflash.launches.reset()
    spec = specs[1]  # head: the whole embedding table is a diff
    toks = request_tokens(spec, np.random.default_rng(0), cfg.vocab_size, seq=20)
    outs = [worker.invoke(InvocationRequest(
        function=spec.name, tokens=toks,
        options=ColdStartOptions(strategy=s, force_cold=True))).output
        for s in ("regular", "snapfaas")]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert tpatch.launches.value > 0
    assert tflash.launches.value == 2 * cfg.num_layers
    inst = worker.pool.get(spec.name)
    dev = inst.arrays["embed/table"]._dev
    assert dev is not None and dev.is_cuda
    np.testing.assert_array_equal(to_numpy(dev), spec.variant["embed/table"])
