"""ctypes binding of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.ssd.ssd_scan``.  x, B and C
may be strided views (the mixer slices them out of one ``xBC`` activation)
as long as their last dim has unit stride; nothing is copied.  x, B and C
are float32 or bfloat16 alike, dt, A and D float32; y comes back in x's
dtype, the final state in float32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import _build
from .._launch import LaunchCounter, check_launch, require_cuda
from .ref import check_length

#: launches of the CUDA kernel, counted where it launches
launches = LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 4096
_fn_cache = []


def _fn():
    if not _fn_cache:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def _check(x, dt, A, B, C, D) -> None:
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("expected x (b, l, nh, hd), dt (b, l, nh), B / C (b, l, ds)")
    b, l, nh, hd = x.shape
    if (tuple(dt.shape) != (b, l, nh) or B.shape[:2] != (b, l) or C.shape != B.shape
            or tuple(A.shape) != (nh,) or tuple(D.shape) != (nh,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if not 0 < B.shape[2] <= MAX_STATE:
        raise ValueError(f"state size {B.shape[2]} outside 1..{MAX_STATE}")
    if b > 65535:
        raise ValueError(f"batch {b} above 65535")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit-stride last dim")
    for name, t in (("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan(
    x: torch.Tensor,   # (b, l, nh, hd)
    dt: torch.Tensor,  # (b, l, nh)
    A: torch.Tensor,   # (nh,)
    B: torch.Tensor,   # (b, l, ds)
    C: torch.Tensor,   # (b, l, ds)
    D: torch.Tensor,   # (nh,)
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors; returns (y (b, l, nh, hd) in
    x's dtype, final state (b, nh, hd, ds) float32)."""
    dev = require_cuda("ssd_scan", x, dt, A, B, C, D)
    _check(x, dt, A, B, C, D)
    b, l, nh, hd = x.shape
    ds = B.shape[2]
    chunk = check_length(l, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} above {MAX_CHUNK}")
    y = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    state = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                   B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
                   state.data_ptr(), b, l, nh, hd, ds, chunk, strides, stream)
    check_launch("ssd_scan", rc)
    launches.add()
    return y, state
