"""Public SSD scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else.

The CUDA kernel has no backward yet (ROADMAP.md Queue 1 item 9b, the
``ssd_scan`` backward): on CUDA with gradients wanted it raises, rather
than hand back an output detached from its inputs.  On the CPU the plain
version trains under autograd."""

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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        raise NotImplementedError(
            "ssd_scan has no CUDA backward yet: training the SSM families on the "
            "card waits for the ssd_scan backward slice (ROADMAP.md Queue 1 item 9b)")
    return ssd_scan(x, dt, A, B, C, D, chunk=chunk)
