"""ctypes binding of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention``.
Takes the TPU kernel's (b, heads, S, hd) view, with any (batch, head, seq)
strides and a unit-stride head dim, so the model's (b, S, heads, hd)
tensors pass as transposed views with no copy; the output is allocated in
the model's layout and returned as the matching view.  Unlike the TPU
kernel it accepts any S (ragged tails are masked).
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
_fn_cache = []


def _fn():
    if not _fn_cache:
        fn = _build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p,
                       ctypes.c_float, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def flash_attention(
    q: torch.Tensor,  # (b, nh, S, hd)
    k: torch.Tensor,  # (b, nkv, Sk, hd)
    v: torch.Tensor,  # (b, nkv, Sk, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns (b, nh, S, hd)."""
    dev = require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, nh, S, hd), k / v (b, nkv, Sk, hd)")
    b, nh, S, hd = q.shape
    _, nkv, Sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} kv heads")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    code = _DTYPES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit-stride head dim")
    out = torch.empty((b, S, nh, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b, nh, nkv, S, Sk, hd, strides,
                   float(scale), int(causal), int(window), float(softcap),
                   stream)
    check_launch("flash_attention", rc)
    launches.add()
    return out
