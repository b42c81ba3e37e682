"""ctypes binding of the CUDA int8-KV decode-attention kernel
(``csrc/decode_attention_int8.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_int8``.  q (b, nh, hd) is
float32 or bfloat16, k and v int8 (b, S, nkv, hd) with float32 scales
(b, S, nkv), all contiguous; the output comes back in q's dtype.  ``pos``
is a one-element int32 tensor on the same device, which the kernel reads
(a decode loop needs no host sync), or a Python int.  Unlike the TPU kernel
it takes any S (a ragged last tile is masked); hd is a multiple of 16 up to
256.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .._launch import LaunchCounter, check_launch, require_cuda

#: launches of the CUDA kernel, counted where it launches
launches = LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 8192      # rep · hd: the query rows of a group, staged in shared memory
TILE = 128            # keys per tile (kTK in the source)
MAX_SPLITS = 8192
BLOCKS_PER_SM = 8     # pass 1 blocks resident per SM that the split count aims at
_fn_cache = []


def _fn():
    if not _fn_cache:
        fn = _build.load("decode_attention_int8").decode_attention_int8_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def num_splits(dev: torch.device, b: int, S: int, nkv: int) -> int:
    """Splits of S so that b · nkv · splits blocks fill every SM
    ``BLOCKS_PER_SM`` times over, and no split is shorter than a tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = -(-BLOCKS_PER_SM * sms // (b * nkv))
    return max(1, min(want, -(-S // TILE), MAX_SPLITS))


def _check(q, k, k_scale, v, v_scale) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("expected q (b, nh, hd), k / v (b, S, nkv, hd)")
    b, nh, hd = q.shape
    _, S, nkv, _ = k.shape
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != hd
            or tuple(k_scale.shape) != (b, S, nkv) or tuple(v_scale.shape) != (b, S, nkv)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} kv heads")
    if not (16 <= hd <= MAX_HEAD_DIM and hd % 16 == 0):
        raise ValueError(f"head dim {hd} is not a multiple of 16 in 16..{MAX_HEAD_DIM}")
    if (nh // nkv) * hd > MAX_GROUP:
        raise ValueError(f"a group of {nh // nkv} heads x {hd} exceeds {MAX_GROUP}")
    if max(b, nh, nkv) > 65535 or S == 0:
        raise ValueError(f"unsupported sizes b {b}, nh {nh}, nkv {nkv}, S {S}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"k and v must be int8, not {k.dtype}, {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("the scales must be float32")
    for name, t in (("q", q), ("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_int8(
    q: torch.Tensor,        # (b, nh, hd)
    k: torch.Tensor,        # (b, S, nkv, hd) int8
    k_scale: torch.Tensor,  # (b, S, nkv) f32
    v: torch.Tensor,        # (b, S, nkv, hd) int8
    v_scale: torch.Tensor,  # (b, S, nkv) f32
    pos,                    # one-element int32 CUDA tensor, or int
    *,
    scale: float,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns (b, nh, hd) in q's dtype."""
    tensors = [q, k, k_scale, v, v_scale]
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1:
            raise TypeError(f"pos must be one int32, got {pos.dtype} x {pos.numel()}")
        tensors.append(pos)
        pos_ptr, pos_host = pos.data_ptr(), 0
    else:
        pos_ptr, pos_host = None, int(pos)
    dev = require_cuda("decode_attention_int8", *tensors)
    _check(q, k, k_scale, v, v_scale)
    b, nh, hd = q.shape
    _, S, nkv, _ = k.shape
    nsplit = num_splits(dev, b, S, nkv)
    part_m = torch.empty((b, nh, nsplit), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, nh, nsplit, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), k_scale.data_ptr(),
                   v.data_ptr(), v_scale.data_ptr(), pos_ptr, pos_host, b, S, nh, nkv,
                   hd, nsplit, float(scale), part_m.data_ptr(), part_l.data_ptr(),
                   part_acc.data_ptr(), out.data_ptr(), stream)
    check_launch("decode_attention_int8", rc)
    launches.add()
    return out
