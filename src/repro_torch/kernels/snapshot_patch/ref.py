"""Plain PyTorch version of the snapshot patch-apply kernel."""

from __future__ import annotations

import torch


def patch_apply_ref(base: torch.Tensor, diff: torch.Tensor, sel: torch.Tensor,
                    *, mode: str = "replace", scale: float = 1.0) -> torch.Tensor:
    """``base`` (n, c), ``diff`` (k >= 1, c), ``sel`` (n,) int32: row of
    ``diff`` overriding row i, or -1 to keep the base row.

    Add mode computes ``base + scale * [sel >= 0] * diff[max(sel, 0)]`` in
    float32 and rounds once to the base dtype — the arithmetic of the CUDA
    kernel, which matches it bit for bit."""
    if diff.shape[0] == 0:
        raise ValueError("diff must hold at least one row")
    use = sel >= 0
    picked = diff.index_select(0, sel.clamp(min=0).long())
    if mode == "replace":
        return torch.where(use[:, None], picked, base)
    if mode == "add":
        if base.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"add mode takes float32 or bfloat16, not {base.dtype}")
        su = scale * use.to(torch.float32)[:, None]
        return (base.float() + su * picked.float()).to(base.dtype)
    raise ValueError(mode)
