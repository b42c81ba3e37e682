"""Public patch-apply: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors, and nothing else."""

from __future__ import annotations

import torch

from .._launch import all_on_cpu
from .kernel import patch_apply
from .ref import patch_apply_ref


def patch_apply_op(base: torch.Tensor, diff: torch.Tensor, sel: torch.Tensor, *,
                   mode: str = "replace", scale: float = 1.0) -> torch.Tensor:
    if all_on_cpu(base, diff, sel):
        return patch_apply_ref(base, diff, sel, mode=mode, scale=scale)
    return patch_apply(base, diff, sel, mode=mode, scale=scale)
