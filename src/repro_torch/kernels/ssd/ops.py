"""Public SSD scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else."""

from __future__ import annotations

from typing import Tuple

import torch

from .._launch import all_on_cpu
from .kernel import ssd_scan
from .ref import ssd_ref


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, D: torch.Tensor, *,
           chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, l, nh, hd), final state (b, nh, hd, ds))."""
    if all_on_cpu(x, dt, A, B, C, D):
        return ssd_ref(x, dt, A, B, C, D, chunk=chunk)
    return ssd_scan(x, dt, A, B, C, D, chunk=chunk)
