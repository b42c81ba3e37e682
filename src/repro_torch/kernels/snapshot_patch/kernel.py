"""ctypes binding of the CUDA patch-apply kernel (``csrc/snapshot_patch.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.snapshot_patch.patch_apply``.
Replace mode works on raw bytes: the caller may hand any dtype, and the
wrapper moves it as ``uint8`` rows, so the copy is bit-exact for every
dtype (bfloat16 included, with no host-side bf16 type).  Add mode takes
float32 or bfloat16.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .._launch import LaunchCounter, check_launch, require_cuda

#: launches of the CUDA kernel (both modes), counted where it launches
launches = LaunchCounter("snapshot_patch")

_ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("snapshot_patch"), name)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        if name == "snapshot_patch_replace":
            fn.argtypes = [p, p, p, p, i64, i64, p]
        else:
            fn.argtypes = [ctypes.c_int, p, p, p, p, i64, i64, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(base: torch.Tensor, diff: torch.Tensor, sel: torch.Tensor) -> None:
    if base.dim() != 2 or diff.dim() != 2 or sel.dim() != 1:
        raise ValueError("expected base (n, c), diff (k, c), sel (n,)")
    if diff.shape[1] != base.shape[1] or sel.shape[0] != base.shape[0]:
        raise ValueError(
            f"shape mismatch: base {tuple(base.shape)}, diff "
            f"{tuple(diff.shape)}, sel {tuple(sel.shape)}")
    if diff.shape[0] == 0:
        raise ValueError("diff must hold at least one row")
    if sel.dtype != torch.int32:
        raise TypeError(f"sel must be int32, not {sel.dtype}")
    if diff.dtype != base.dtype:
        raise TypeError(f"diff dtype {diff.dtype} != base dtype {base.dtype}")
    for name, t in (("base", base), ("diff", diff), ("sel", sel)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def patch_apply(base: torch.Tensor, diff: torch.Tensor, sel: torch.Tensor, *,
                mode: str = "replace", scale: float = 1.0) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns a new tensor.

    ``base`` is only read (pooled base tensors are shared across
    instances), so the patch is out of place."""
    dev = require_cuda("snapshot_patch", base, diff, sel)
    _check(base, diff, sel)
    n, c = base.shape
    out = torch.empty_like(base)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "replace":
            row_bytes = c * base.element_size()
            rc = _fn("snapshot_patch_replace")(
                base.data_ptr(), diff.data_ptr(), sel.data_ptr(),
                out.data_ptr(), n, row_bytes, stream)
        elif mode == "add":
            code = _ADD_DTYPES.get(base.dtype)
            if code is None:
                raise TypeError(f"add mode takes float32 or bfloat16, not {base.dtype}")
            rc = _fn("snapshot_patch_add")(
                code, base.data_ptr(), diff.data_ptr(), sel.data_ptr(),
                out.data_ptr(), n, c, float(scale), stream)
        else:
            raise ValueError(mode)
    check_launch("snapshot_patch", rc)
    launches.add()
    return out
