"""Public SSD scan: the CUDA kernels for CUDA tensors, the plain version for
CPU tensors, and nothing else.  Meta tensors (the dry run) take the CUDA
branch, where the kernels book their calls instead of launching
(``kernels/_launch.py``).

On CUDA with gradients wanted (grad mode on and any input requiring grad)
the forward and the hand-written backward run as one
``torch.autograd.Function``: the forward keeps its prefix sums and the
states entering each chunk, the backward launches ``ssd_scan_bwd``.
Otherwise the forward alone runs, as in inference.  Nothing on CUDA takes
the plain version or returns an output detached from its inputs.  Under
``torch.utils.checkpoint`` the forward runs again in the backward pass and
counts its launches again.  On the CPU the plain version trains under
autograd."""

from __future__ import annotations

from typing import Tuple

import torch

from .._launch import all_on_cpu
from .kernel import ssd_scan, ssd_scan_bwd, ssd_scan_for_grad
from .ref import ssd_ref


class _SsdScan(torch.autograd.Function):
    """x, B, C may be views into the mixer's xBC: autograd scatters their
    three gradients into xBC's."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        y, state, cs, s_in = ssd_scan_for_grad(x, dt, A, B, C, D, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, D, cs, s_in)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state costs nothing
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, D, cs, s_in = ctx.saved_tensors
        dy = torch.zeros_like(x, memory_format=torch.contiguous_format) if dy is None \
            else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = ssd_scan_bwd(x, dt, A, B, C, D, dy, dstate, cs, s_in, chunk=ctx.chunk)
        return (*grads, None)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, D: torch.Tensor, *,
           chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, l, nh, hd), final state (b, nh, hd, ds))."""
    if all_on_cpu(x, dt, A, B, C, D):
        return ssd_ref(x, dt, A, B, C, D, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        return _SsdScan.apply(x, dt, A, B, C, D, chunk)
    return ssd_scan(x, dt, A, B, C, D, chunk=chunk)
