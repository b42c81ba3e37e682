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
from repro_torch.kernels import ssd as tssd
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


# (b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len)
FLASH_CASES = {
    "mha_causal": (2, 4, 4, 128, 128, 64, True, 0, 0.0, 0),
    "bidirectional_ragged": (1, 2, 2, 77, 77, 80, False, 0, 0.0, 0),
    "gqa_4to1": (1, 8, 2, 64, 64, 32, True, 0, 0.0, 0),
    "mqa": (2, 4, 1, 37, 37, 32, True, 0, 0.0, 0),
    "window_16": (1, 4, 4, 128, 128, 16, True, 16, 0.0, 0),
    "softcap_20": (1, 4, 2, 64, 64, 32, True, 0, 20.0, 0),
    "head_dim_256": (1, 2, 1, 40, 40, 256, True, 0, 0.0, 0),
    "gqa_4to1_hd128_s1024": (1, 8, 2, 1024, 1024, 128, True, 0, 0.0, 0),
    "mqa_hd256_s1024": (1, 8, 1, 1024, 1024, 256, True, 0, 0.0, 0),
    "single_token": (2, 4, 2, 1, 1, 64, True, 0, 0.0, 0),
    "window_crosses_tile_ragged": (1, 4, 2, 200, 200, 64, True, 48, 0.0, 0),
    # the prefix-LM mask: a prefix that ends mid-tile, paligemma's MQA at
    # hd 256 over 256 patches, a prefix longer than S, one with a window
    "prefix_ragged": (1, 4, 2, 200, 200, 64, True, 0, 0.0, 77),
    "prefix_hd256_mqa": (1, 8, 1, 512, 512, 256, True, 0, 0.0, 256),
    "prefix_past_s": (1, 4, 2, 50, 50, 32, True, 0, 0.0, 90),
    "prefix_window": (1, 4, 4, 200, 200, 64, True, 40, 0.0, 100),
    # cross-attention: whisper-small's decoder over 1500 frames
    "cross_s64_sk1500": (1, 12, 12, 64, 1500, 64, False, 0, 0.0, 0),
    "cross_s448_sk1500": (1, 12, 12, 448, 1500, 64, False, 0, 0.0, 0),
    "cross_ragged_sk_lt_s": (2, 4, 2, 130, 33, 32, False, 0, 0.0, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_matches_plain(cuda, name, dtype):
    """f32 2e-5 and bf16 2e-2, as tests/test_kernels.py holds the TPU kernel."""
    b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len = FLASH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((b, n, h, hd), generator=g, device=cuda).to(dtype)
               for n, h in ((S, nh), (Sk, nkv), (Sk, nkv)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    before = tflash.launches.value
    out = tflash.flash_attention_op(q, k, v, **kw)
    assert tflash.launches.value == before + 1
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ref = tflash.attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_flash_takes_strided_views(cuda):
    """q, k, v as slices of one fused (b, s, 3 nh, hd) projection, and q as
    a (b, h, s) view of a (s, b, h) buffer: no copy, the result as plain."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, S, nh, hd = 2, 150, 4, 64
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((b, S, 3 * nh, hd), generator=g, device=cuda).to(dtype)
        q, k, v = (qkv[:, :, i * nh:(i + 1) * nh].transpose(1, 2) for i in range(3))
        assert not q.is_contiguous()
        kw = dict(scale=hd ** -0.5, causal=True, window=0, softcap=0.0)
        out = tflash.flash_attention(q, k, v, **kw)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out, tflash.attention_ref(q, k, v, **kw),
                                   rtol=tol, atol=tol)
        sbh = torch.randn((S, b, nh, hd), generator=g, device=cuda).to(dtype)
        q2 = sbh.permute(1, 2, 0, 3)
        out = tflash.flash_attention(q2, k, v, **kw)
        torch.testing.assert_close(out, tflash.attention_ref(q2, k, v, **kw),
                                   rtol=tol, atol=tol)


def test_flash_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_attention(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="unit-stride"):
        tflash.flash_attention(torch.zeros((1, 4, 8, 32), device=cuda)[..., ::2], q, q,
                               scale=1.0)
    with pytest.raises(ValueError, match="group"):
        tflash.flash_attention(q, q[:, :3], q[:, :3], scale=1.0)
    # the tensor-core tiles take the head dim 8 at a time, up to 256
    for hd in (20, 264):
        x = torch.zeros((1, 4, 8, hd), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            tflash.flash_attention(x, x, x, scale=1.0)
    # TMA reads rows whose stride is a multiple of 16 bytes from an aligned base
    odd = torch.zeros((1, 4, 8, 33), device=cuda)[..., :32]
    x = torch.zeros((1, 4, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="row stride of 132 bytes"):
        tflash.flash_attention(x, odd, odd, scale=1.0)
    shifted = torch.zeros((1, 4, 8, 40), device=cuda)[..., 1:33]
    with pytest.raises(ValueError, match="base address"):
        tflash.flash_attention(shifted, x, x, scale=1.0)


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


def _xbc_views(cuda, b, l, nh, hd, ds, dtype, seed=3):
    """x, B, C as the mixer hands them over: strided views into one
    (b, l, nh·hd + 2 ds) activation."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    d_in = nh * hd
    xbc = torch.randn((b, l, d_in + 2 * ds), generator=g, device=cuda).to(dtype)
    x = xbc[..., :d_in].reshape(b, l, nh, hd)
    B, C = xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:]
    dt = torch.rand((b, l, nh), generator=g, device=cuda) * 0.49 + 0.01
    A = -(torch.rand((nh,), generator=g, device=cuda) * 1.5 + 0.5)
    D = torch.randn((nh,), generator=g, device=cuda)
    return x, dt, A, B, C, D


# (b, l, nh, hd, ds, chunk)
SSD_CASES = {
    "mamba2_two_chunks": (1, 512, 8, 64, 128, 256),
    "one_chunk": (2, 64, 4, 64, 128, 64),
    "ragged_tiles": (1, 192, 3, 32, 16, 96),
    "reduced_mamba2": (2, 96, 8, 32, 16, 32),
    "narrow_many_chunks": (2, 64, 4, 16, 16, 16),
    "odd_dims": (1, 80, 3, 24, 40, 40),   # hd, ds off the 16 x 16 / 8 x 32 tilings
    "many_chunks": (1, 4096, 8, 64, 128, 256),  # 16 chunks through the state passing
    "jamba_shaped": (1, 128, 128, 64, 16, 64),  # jamba-v0.1-52b's 128 heads, ds 16
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_matches_plain(cuda, name, dtype):
    """y at f32 2e-5 / bf16 2e-2 and the f32 state at 1e-3, as
    tests/test_kernels.py holds the TPU kernel."""
    b, l, nh, hd, ds, chunk = SSD_CASES[name]
    args = _xbc_views(cuda, b, l, nh, hd, ds, dtype)
    assert not args[0].is_contiguous()
    before = tssd.launches.value
    y, st = tssd.ssd_op(*args, chunk=chunk)
    assert tssd.launches.value == before + 1
    y_ref, st_ref = tssd.ssd_ref(*args, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chunk", [256, 4096])
def test_ssd_prefix_sums_take_the_plain_order(cuda, chunk):
    """The chunk-state kernel's prefix sums cs are the plain version's
    ``prefix_sum`` (XLA's blocks of 16) of dt A bit for bit: one level of
    block totals at mamba2's chunk of 256, two at 4096.  A sequential
    float32 sum gives other bits, so the check tells the orders apart."""
    from repro_torch.kernels.ssd.kernel import ssd_scan_for_grad
    from repro_torch.kernels.ssd.ref import prefix_sum
    b, l, nh, hd, ds = 1, 2 * chunk if chunk == 256 else chunk, 4, 64, 16
    args = _xbc_views(cuda, b, l, nh, hd, ds, torch.float32)
    _, _, cs, _ = ssd_scan_for_grad(*args, chunk=chunk)
    dt, A = args[1].cpu(), args[2].cpu()
    da = (dt * A).view(b, l // chunk, chunk, nh)
    want = prefix_sum(da, 2).permute(0, 1, 3, 2)
    assert torch.equal(cs.cpu().view(torch.int32), want.contiguous().view(torch.int32))
    sequential = torch.zeros_like(da)
    run = torch.zeros_like(da[:, :, 0])
    for i in range(chunk):
        run = run + da[:, :, i]
        sequential[:, :, i] = run
    assert not torch.equal(sequential.permute(0, 1, 3, 2), want)


def test_ssd_rejects_what_it_cannot_take(cuda):
    x, dt, A, B, C, D = _xbc_views(cuda, 1, 96, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssd.ssd_scan(x, dt, A, B, C, D, chunk=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tssd.ssd_scan(x.half(), dt, A, B.half(), C.half(), D, chunk=32)
    with pytest.raises(TypeError, match="dt must be float32"):
        tssd.ssd_scan(x, dt.bfloat16(), A, B, C, D, chunk=32)
    with pytest.raises(TypeError, match="share"):
        tssd.ssd_scan(x, dt, A, B.bfloat16(), C, D, chunk=32)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 32, 1, 128), device=cuda)
        tssd.ssd_scan(big, dt[:, :32, :1], A[:1], B[:, :32], C[:, :32], D[:1], chunk=32)
    with pytest.raises(ValueError, match="unit-stride"):
        tssd.ssd_scan(x, dt, A, B[..., ::2], C[..., ::2], D, chunk=32)


def test_ssd_refuses_what_its_copies_cannot_read(cuda):
    """hd and ds go 16 bytes at a time into the tiles, from 16-byte aligned
    rows: other widths and strides are refused with the reason."""
    x, dt, A, B, C, D = _xbc_views(cuda, 1, 32, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="head dim 12 is not a multiple of 8"):
        tssd.ssd_scan(x[..., :12], dt, A, B, C, D, chunk=32)
    with pytest.raises(ValueError, match="state size 12 is not a multiple of 8"):
        tssd.ssd_scan(x, dt, A, B[..., :12], C[..., :12], D, chunk=32)
    odd = torch.zeros((1, 32, 17), device=cuda)[..., :16]   # rows of 68 bytes
    with pytest.raises(ValueError, match="68 bytes"):
        tssd.ssd_scan(x, dt, A, odd, C, D, chunk=32)
    shifted = torch.zeros((1, 32, 20), device=cuda)[..., 1:17]
    with pytest.raises(ValueError, match="base address"):
        tssd.ssd_scan(x, dt, A, B, shifted, D, chunk=32)


def test_worker_on_cuda_serves_mamba2_through_ssd(cuda, tmp_path):
    from repro_torch.convert import params_to_flat
    from repro_torch.serving import Worker
    from repro_torch.serving.trace import build_delta_specs, request_tokens
    cfg = reduced(get_config("mamba2-780m"))
    model = build_model(cfg)
    worker = Worker(str(tmp_path / "worker"), device=cuda)
    base = model.init(0, device=worker.device)
    worker.register_runtime(cfg.name, model, base)
    specs = build_delta_specs(str(tmp_path), cfg, params_to_flat(base))
    for spec in specs:
        worker.register_function(spec)
    tpatch.launches.reset()
    tflash.launches.reset()
    tssd.launches.reset()
    forwards = 0
    for spec in specs:
        toks = request_tokens(spec, np.random.default_rng(0), cfg.vocab_size, seq=96)
        outs = [worker.invoke(InvocationRequest(
            function=spec.name, tokens=toks,
            options=ColdStartOptions(strategy=s, force_cold=True))).output
            for s in ("regular", "snapfaas")]
        forwards += 2
        assert np.isfinite(outs[0]).all()
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert tssd.launches.value == cfg.num_layers * forwards
    assert tflash.launches.value == 0
    assert tpatch.launches.value > 0


# (b, nh, nkv, S, hd, pos): tests/test_kernels.py's shapes, the path's
# stablelm-3b shape, a ragged S, mistral-nemo's GQA at hd 128
DECODE_CASES = {
    "gqa_2to1": (2, 4, 2, 128, 32, 38),
    "mqa_8to1": (1, 8, 1, 256, 64, 255),
    "mha_one_tile": (2, 4, 4, 128, 32, 127),
    "stablelm_3b": (1, 32, 32, 2048, 80, 1055),
    "ragged_S": (2, 4, 2, 1000, 32, 999),
    "ragged_S_mid": (1, 4, 2, 333, 16, 200),
    "mistral_nemo_gqa": (2, 32, 8, 4096, 128, 3000),
    "head_dim_256": (1, 2, 1, 300, 256, 150),
    # long caches: each warp of a split walks several 32-key slices
    "stablelm_3b_32k": (1, 32, 32, 32768, 80, 32767),
    "mistral_nemo_32k_mid": (4, 32, 8, 32768, 128, 20000),
    "many_small_tiles": (4, 8, 8, 8192, 32, 8191),
    # MQA at b 1: clusters combined through the ticket (the second level)
    "mqa_32k": (1, 8, 1, 32768, 256, 32767),
    "mqa_32k_hd64": (1, 8, 1, 32768, 64, 32767),
    # pos before most splits (they load nothing), and pos past S
    "pos_before_the_splits": (1, 8, 1, 32768, 64, 40),
    "pos_past_S": (1, 4, 2, 100, 32, 150),
    # two kv heads a CTA (a long cache over nkv 2)
    "two_heads_a_cta": (8, 4, 2, 32768, 64, 30000),
}
MULTI_TILE = ("stablelm_3b_32k", "mistral_nemo_32k_mid", "many_small_tiles")


def _decode_inputs(cuda, b, nh, nkv, S, hd, dtype, seed=4):
    from repro_torch.kernels.decode_attention import quantize_kv
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, nh, hd), generator=g, device=cuda).to(dtype)
    k, ks = quantize_kv(torch.randn((b, S, nkv, hd), generator=g, device=cuda))
    v, vs = quantize_kv(torch.randn((b, S, nkv, hd), generator=g, device=cuda))
    return q, k, ks, v, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_int8_matches_plain(cuda, name, dtype):
    """f32 2e-5 and bf16 2e-2, as tests/test_kernels.py holds the TPU
    kernel, the bf16 absolute term cut to 1e-2 of max|ref| (about one bf16
    ulp of the output, which a long cache averages down below 2e-2); pos as
    a device int32 and as a Python int give the same."""
    from repro_torch.kernels import decode_attention as tdec
    b, nh, nkv, S, hd, pos = DECODE_CASES[name]
    args = _decode_inputs(cuda, b, nh, nkv, S, hd, dtype)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    before = tdec.launches.value
    out = tdec.decode_attention_int8_op(*args, pos_t, scale=hd ** -0.5)
    assert tdec.launches.value == before + 1
    ref = tdec.decode_attention_int8_ref(*args, pos, scale=hd ** -0.5)
    assert out.dtype == dtype and out.shape == (b, nh, hd)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        atol = min(2e-2, 1e-2 * ref.float().abs().max().item())
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=atol)
    again = tdec.decode_attention_int8(*args, pos, scale=hd ** -0.5)
    torch.testing.assert_close(again, out, rtol=0, atol=0)


@pytest.mark.parametrize("name", MULTI_TILE)
def test_decode_int8_long_cases_split_over_several_tiles(cuda, name):
    """The cases above that hold the cross-stage rescale: on this card, at
    the plan, each CTA walks more than one stage (each warp more than one
    32-key slice)."""
    from repro_torch.kernels.decode_attention.kernel import plan_for
    b, nh, nkv, S, hd, pos = DECODE_CASES[name]
    plan = plan_for(cuda, torch.float32, b, S, nh, nkv, hd)
    stages = -(-(pos + 1) // plan.stage_keys)
    assert stages // plan.splits > 1


def test_decode_int8_plans_keep_clusters_resident(cuda):
    """Every plan of the cases above asks for no more clusters than the
    card holds at once (a cluster past them would wait for a second wave)."""
    from repro_torch.kernels.decode_attention.kernel import cluster_slots, plan_for
    for b, nh, nkv, S, hd, _ in DECODE_CASES.values():
        for dtype in (torch.float32, torch.bfloat16):
            plan = plan_for(cuda, dtype, b, S, nh, nkv, hd)
            if plan.cluster > 1:
                assert plan.units * plan.groups <= cluster_slots(cuda, dtype, plan)


def test_decode_int8_negative_pos_gives_zeros(cuda):
    from repro_torch.kernels import decode_attention as tdec
    for shape in ((1, 4, 2, 256, 32), (1, 8, 1, 32768, 64)):
        args = _decode_inputs(cuda, *shape, torch.float32)
        for pos in (-1, torch.tensor([-5], dtype=torch.int32, device=cuda)):
            out = tdec.decode_attention_int8(*args, pos, scale=0.2)
            assert out.shape == (shape[0], shape[1], shape[4])
            assert not out.abs().any()


def test_decode_int8_graph_replays_advance_pos(cuda):
    """Ten replays of a CUDA graph of the call and a device-side pos += 37,
    at a shape whose clusters combine through the ticket: every replay
    matches the plain version at its pos, and leaves the counters at zero."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels.decode_attention import kernel as kmod
    b, nh, nkv, S, hd = 1, 8, 1, 32768, 64
    plan = kmod.plan_for(cuda, torch.float32, b, S, nh, nkv, hd)
    assert plan.groups > 1
    args = _decode_inputs(cuda, b, nh, nkv, S, hd, torch.float32)
    pos_t = torch.tensor([1000], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.decode_attention_int8(*args, pos_t, scale=hd ** -0.5)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = tdec.decode_attention_int8(*args, pos_t, scale=hd ** -0.5)
            pos_t.add_(37)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    pos_t.fill_(1000)
    before = tdec.launches.value
    for i in range(10):
        graph.replay()
        torch.cuda.synchronize()
        ref = tdec.decode_attention_int8_ref(*args, 1000 + 37 * i, scale=hd ** -0.5)
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    assert int(pos_t.item()) == 1000 + 370
    assert tdec.launches.value == before  # a replay is no launch of the wrapper
    tickets, _ = kmod._scratch[(args[0].device.index, side.cuda_stream)]
    assert not tickets.any()


def test_decode_int8_plans_of_one_instantiation_alternate(cuda):
    """A long cache (four heads a CTA) and a short one (one head a CTA) run
    the same instantiation with different shared memory; in turns, with the
    occupancy query of each plan between, every call still launches and
    matches the plain version (the opt-in never falls below a plan's)."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels.decode_attention.kernel import cluster_slots, plan_for
    long_shape, short_shape = (1, 32, 32, 32768, 80), (1, 32, 32, 2048, 80)
    plans = [plan_for(cuda, torch.bfloat16, b, S, nh, nkv, hd)
             for b, nh, nkv, S, hd in (long_shape, short_shape)]
    assert plans[0].rows == plans[1].rows and plans[0].smem > plans[1].smem
    cases = [(_decode_inputs(cuda, *shape, torch.bfloat16), pos)
             for shape, pos in ((long_shape, 32767), (short_shape, 1039))]
    for turn in (0, 1, 0, 1, 0):
        args, pos = cases[turn]
        cluster_slots(cuda, torch.bfloat16, plans[1 - turn])
        out = tdec.decode_attention_int8(*args, pos, scale=80 ** -0.5)
        ref = tdec.decode_attention_int8_ref(*args, pos, scale=80 ** -0.5)
        atol = min(2e-2, 1e-2 * ref.float().abs().max().item())
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=atol)


def test_decode_int8_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import decode_attention as tdec
    q, k, ks, v, vs = _decode_inputs(cuda, 1, 4, 2, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tdec.decode_attention_int8(q[..., :24].contiguous(), k[..., :24].contiguous(), ks,
                                   v[..., :24].contiguous(), vs, 3, scale=1.0)
    with pytest.raises(TypeError, match="int8"):
        tdec.decode_attention_int8(q, k.float(), ks, v, vs, 3, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tdec.decode_attention_int8(q.half(), k, ks, v, vs, 3, scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        tdec.decode_attention_int8(q, k, ks, v, vs, torch.tensor([3], device=cuda), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros((1, 32, 4), device=cuda).transpose(1, 2)  # q's shape, not layout
        tdec.decode_attention_int8(strided, k, ks, v, vs, 3, scale=1.0)
    with pytest.raises(ValueError, match="group"):
        tdec.decode_attention_int8(q[:, :3].contiguous(), k, ks, v, vs, 3, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_int8(q, k, ks, v, vs, torch.tensor([3], dtype=torch.int32),
                                   scale=1.0)


@pytest.mark.parametrize("name", ["stablelm-3b", "mamba2-780m", "olmoe-1b-7b",
                                  "grok-1-314b", "jamba-v0.1-52b", "whisper-small",
                                  "paligemma-3b"])
def test_prefill_decode_on_cuda_matches_cpu(cuda, name):
    """The reduced model in float32: prefill (flash or ssd_scan on the
    card; whisper over 24 frame embeddings, paligemma after its 8 patch
    embeddings) and three decode steps against the same steps on the CPU;
    1e-4, summation order only."""
    from repro_torch.convert import params_from_flat, params_to_flat
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg = reduced(get_config(name))
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    params_cpu = params_from_flat(params_to_flat(params), "cpu", template=model.param_shapes())
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 35), dtype=np.int32))
    batch = {"tokens": toks[:, :32]}
    n_prefix = 24 if cfg.is_encoder_decoder else cfg.num_prefix_tokens
    if n_prefix:
        batch["prefix_embeds"] = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, n_prefix, cfg.d_model)).astype(np.float32) * 0.02)
    offset = 0 if cfg.is_encoder_decoder else cfg.num_prefix_tokens
    prefill, serve = make_prefill_step(model, 48 + offset), make_serve_step(model)
    got, cache = prefill(params, {k: v.to(cuda) for k, v in batch.items()})
    want, cache_cpu = prefill(params_cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for pos in range(32, 35):
        got, cache = serve(params, cache, toks[:, pos].to(cuda), pos + offset)
        want, cache_cpu = serve(params_cpu, cache_cpu, toks[:, pos], pos + offset)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _moe_layer(name, dtype, device):
    """Layer 0's MoE weights of the reduced ``name`` and its config."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config(name)), dtype=dtype)
    params = build_model(cfg).init(0, device=device)
    pos = next(p for p in params["blocks"].values() if "router" in p.get("ffn", {}))
    return cfg, {k: v[0] for k, v in pos["ffn"].items()}


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_ffn_on_cuda_matches_cpu(cuda, cf):
    """float32, reduced olmoe: the same top-k choices and kept set (equal),
    y and aux at 1e-5 (summation order only), with and without drops."""
    from repro_torch.models import moe
    cfg, ffn = _moe_layer("olmoe-1b-7b", "float32", cuda)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    with moe.recording([]) as seen:
        y, aux = moe.moe_ffn(ffn, x, cfg, capacity_factor=cf)
        y_cpu, aux_cpu = moe.moe_ffn({k: v.cpu() for k, v in ffn.items()}, x.cpu(), cfg,
                                     capacity_factor=cf)
    (idx, keep), (idx_cpu, keep_cpu) = ((c["idx"], c["keep"]) for c in seen)
    assert torch.equal(idx.cpu(), idx_cpu) and torch.equal(keep.cpu(), keep_cpu)
    assert bool(keep_cpu.all()) == (cf == 8.0)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-6, atol=1e-6)


def test_moe_ffn_does_not_synchronise(cuda):
    """bf16, reduced olmoe at a dropping capacity: one call under the sync
    debug mode that raises on any host synchronisation."""
    from repro_torch.models import moe
    cfg, ffn = _moe_layer("olmoe-1b-7b", "bfloat16", cuda)
    x = torch.randn((1, 64, cfg.d_model), device=cuda).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(ffn, x, cfg, capacity_factor=1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(y.float()).all() and torch.isfinite(aux)


# ------------------------------------------------------------- training

BWD_CASES = {
    "stablelm_hd80_causal": (2, 8, 8, 300, 300, 80, True, 0, 0.0, 0),
    "gqa_window_softcap": (1, 8, 2, 200, 200, 128, True, 48, 30.0, 0),
    "mqa_hd256_prefix": (1, 4, 1, 130, 130, 256, True, 0, 0.0, 77),
    "cross_sk_gt_s": (2, 4, 4, 40, 150, 64, False, 0, 0.0, 0),
    # several tiles of each kernel, ragged S and Sk, splits of the grid
    "multi_tile_gqa_causal_s300_sk450_hd80": (1, 4, 2, 300, 450, 80, True, 0, 0.0, 0),
    "multi_tile_mqa_bidirectional_hd64": (2, 4, 1, 200, 333, 64, False, 0, 0.0, 0),
    "multi_tile_window_softcap_hd128": (1, 4, 2, 260, 260, 128, True, 70, 30.0, 0),
    "multi_tile_prefix_mqa_hd256": (1, 4, 1, 150, 150, 256, True, 0, 0.0, 77),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_flash_bwd_matches_plain_and_is_deterministic(cuda, name, dtype):
    """Through ``flash_attention_op``'s autograd.Function: dq, dk, dv
    against ``attention_bwd_ref`` from the kernel's own o and lse (f32
    5e-5, bf16 2e-2 of each gradient's largest entry), one forward with
    lse and one backward launched, and two backward calls bit-equal."""
    b, nh, nkv, S, Sk, hd, causal, window, softcap, prefix_len = BWD_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, n, h, hd), generator=g, device=cuda).to(dtype)
               .requires_grad_(True) for n, h in ((S, nh), (Sk, nkv), (Sk, nkv)))
    do = torch.randn((b, S, nh, hd), generator=g, device=cuda).to(dtype)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    f0, b0 = tflash.launches.value, tflash.bwd_launches.value
    got = torch.autograd.grad(tflash.flash_attention_op(q, k, v, **kw), (q, k, v), do)
    assert (tflash.launches.value - f0, tflash.bwd_launches.value - b0) == (1, 1)
    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    o, lse = tflash.flash_attention(qt, kt, vt, return_lse=True, **kw)
    again = tflash.flash_attention_bwd(qt, kt, vt, o, do.transpose(1, 2).contiguous(), lse,
                                       **kw)
    ref = tflash.attention_bwd_ref(qt, kt, vt, o, do.transpose(1, 2), lse, **kw)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    for x, y, r in zip(got, again, ref):
        assert torch.equal(x, y.transpose(1, 2))
        r = r.float().transpose(1, 2)
        assert float((x.float() - r).abs().max()) <= tol * float(r.abs().max())



# the backward: (b, l, nh, hd, ds, chunk): reduced mamba2, two mamba2-780m
# chunks, jamba's ds 16 over two chunks, ragged tiles, widths off the tiles,
# two chunks of the largest the backward takes (16 row tiles)
SSD_BWD_CASES = {
    "reduced_mamba2": (2, 96, 8, 32, 16, 32),
    "mamba2_two_chunks": (1, 512, 8, 64, 128, 256),
    "jamba_ds16": (1, 512, 16, 64, 16, 256),
    "ragged_tiles": (1, 192, 3, 32, 16, 96),
    "odd_dims": (1, 80, 3, 24, 40, 40),
    "chunk_1024": (1, 2048, 3, 64, 128, 1024),
}


def _ssd_bwd_inputs(cuda, name, dtype):
    b, l, nh, hd, ds, chunk = SSD_BWD_CASES[name]
    args = _xbc_views(cuda, b, l, nh, hd, ds, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((b, l, nh, hd), generator=g, device=cuda).to(dtype)
    dS = torch.randn((b, nh, hd, ds), generator=g, device=cuda)
    return args, dy, dS, chunk


def _ssd_float64_grads(args, dy, dS, chunk):
    leaves = [t.detach().double().requires_grad_(True) for t in args]
    y, st = tssd.ssd_ref(*leaves, chunk=chunk)
    return torch.autograd.grad((y * dy.double()).sum() + (st * dS.double()).sum(), leaves)


def _ssd_bwd_tol(dtype, name):
    """Of each gradient's largest entry: float32 5e-5 (dA, one signed sum per
    head over the batch's rows, 1e-4), bf16 2e-2."""
    if dtype == torch.bfloat16:
        return 2e-2
    return 1e-4 if name == "dA" else 5e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SSD_BWD_CASES))
def test_ssd_bwd_matches_plain_and_float64_autograd(cuda, name, dtype):
    from repro_torch.kernels.ssd.kernel import ssd_scan_for_grad
    args, dy, dS, chunk = _ssd_bwd_inputs(cuda, name, dtype)
    _, _, cs, s_in = ssd_scan_for_grad(*args, chunk=chunk)
    got = tssd.ssd_scan_bwd(*args, dy, dS, cs, s_in, chunk=chunk)
    plain = tssd.ssd_bwd_ref(*args, dy, dS, chunk=chunk)
    oracle = _ssd_float64_grads(args, dy, dS, chunk)
    for g, n, p, o in zip(got, ("dx", "ddt", "dA", "dB", "dC", "dD"), plain, oracle):
        assert g.dtype == p.dtype and g.shape == p.shape, n
        tol = _ssd_bwd_tol(dtype, n)
        for ref in (p.double(), o):
            assert float((g.double() - ref).abs().max()) <= tol * float(ref.abs().max()), n


@pytest.mark.parametrize("name", ["mamba2_two_chunks", "jamba_ds16"])
def test_ssd_bwd_is_bit_equal_over_two_calls_and_counts_them(cuda, name):
    from repro_torch.kernels.ssd.kernel import ssd_scan_for_grad
    args, dy, dS, chunk = _ssd_bwd_inputs(cuda, name, torch.bfloat16)
    _, _, cs, s_in = ssd_scan_for_grad(*args, chunk=chunk)
    before = tssd.bwd_launches.value
    first = tssd.ssd_scan_bwd(*args, dy, dS, cs, s_in, chunk=chunk)
    second = tssd.ssd_scan_bwd(*args, dy, None, cs, s_in, chunk=chunk)
    third = tssd.ssd_scan_bwd(*args, dy, dS, cs, s_in, chunk=chunk)
    assert tssd.bwd_launches.value == before + 3
    assert all(torch.equal(a, c) for a, c in zip(first, third))
    assert not torch.equal(first[0], second[0])  # the final state's gradient reaches dx


def test_ssd_op_trains_through_the_backward_kernel(cuda):
    """``ssd_op`` under grad: one forward and one backward launch, gradients
    of xBC, dt, A and D against float64 autograd through the plain forward."""
    b, l, nh, hd, ds, chunk = SSD_BWD_CASES["reduced_mamba2"]
    g = torch.Generator(device=cuda).manual_seed(9)
    d_in = nh * hd
    xbc = torch.randn((b, l, d_in + 2 * ds), generator=g, device=cuda).requires_grad_(True)
    dt = (torch.rand((b, l, nh), generator=g, device=cuda) * 0.49 + 0.01).requires_grad_(True)
    A = (-(torch.rand((nh,), generator=g, device=cuda) * 1.5 + 0.5)).requires_grad_(True)
    D = torch.randn((nh,), generator=g, device=cuda).requires_grad_(True)
    dy = torch.randn((b, l, nh, hd), generator=g, device=cuda)

    def loss(xbc, dt, A, D, op):
        x = xbc[..., :d_in].reshape(b, l, nh, hd)
        y, _ = op(x, dt, A, xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:], D, chunk=chunk)
        return (y * dy.to(y.dtype)).sum()

    f0, b0 = tssd.launches.value, tssd.bwd_launches.value
    got = torch.autograd.grad(loss(xbc, dt, A, D, tssd.ssd_op), (xbc, dt, A, D))
    assert (tssd.launches.value - f0, tssd.bwd_launches.value - b0) == (1, 1)
    leaves = [t.detach().double().requires_grad_(True) for t in (xbc, dt, A, D)]
    want = torch.autograd.grad(loss(*leaves, tssd.ssd_ref), leaves)
    for n, x, w in zip(("xBC", "dt", "A", "D"), got, want):
        tol = 1e-4 if n == "A" else 5e-5
        assert float((x.double() - w).abs().max()) <= tol * float(w.abs().max()), n


def test_ssd_bwd_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd.kernel import ssd_scan_for_grad
    args, dy, dS, chunk = _ssd_bwd_inputs(cuda, "reduced_mamba2", torch.float32)
    _, _, cs, s_in = ssd_scan_for_grad(*args, chunk=chunk)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        tssd.ssd_scan_bwd(*args, dy.transpose(2, 3).contiguous().transpose(2, 3), dS, cs,
                          s_in, chunk=chunk)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        tssd.ssd_scan_bwd(*args, dy.bfloat16(), dS, cs, s_in, chunk=chunk)
    with pytest.raises(ValueError, match="dstate must be contiguous float32"):
        tssd.ssd_scan_bwd(*args, dy, dS[:, :1], cs, s_in, chunk=chunk)
    with pytest.raises(ValueError, match="cs must be the forward's"):
        tssd.ssd_scan_bwd(*args, dy, dS, cs[:, :1], s_in, chunk=chunk)
    with pytest.raises(ValueError, match="every tensor must lie on one CUDA device"):
        tssd.ssd_scan_bwd(*args, dy, dS.cpu(), cs, s_in, chunk=chunk)
    long = _xbc_views(cuda, 1, 2048, 2, 16, 16, torch.float32)
    _, _, cs2, s_in2 = ssd_scan_for_grad(*long, chunk=2048)  # the forward takes 2048
    dy2 = torch.zeros((1, 2048, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="chunk 2048 outside 1..1024"):
        tssd.ssd_scan_bwd(*long, dy2, None, cs2, s_in2, chunk=2048)
