"""Public flash attention in the model's (b, s, heads, hd) layout: the CUDA
kernels for CUDA tensors, the plain version for CPU tensors.  Meta tensors
(the dry run) take the CUDA branch, where the kernels book their calls
instead of launching (``kernels/_launch.py``).

On CUDA with gradients wanted (grad mode on and any input requiring grad)
the forward and the hand-written backward run as one
``torch.autograd.Function``: the forward also writes each row's
log-sum-exp, the backward launches ``flash_attention_bwd``.  Otherwise the
forward alone runs, as in inference.  Nothing on CUDA takes the plain
version or returns an output detached from its inputs.  Under
``torch.utils.checkpoint`` the forward runs again in the backward pass and
counts its launches again."""

from __future__ import annotations

import torch

from .._launch import all_on_cpu
from .kernel import flash_attention, flash_attention_bwd
from .ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """q, k, v as the kernels' (b, heads, s, hd) views."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, prefix_len):
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
                  prefix_len=prefix_len)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_op(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, sk, nkv, hd)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix_len: int = 0,
) -> torch.Tensor:
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    if all_on_cpu(q, k, v):
        return attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(qt, kt, vt, scale, causal, window, softcap,
                                     prefix_len).transpose(1, 2)
    return flash_attention(qt, kt, vt, **kw).transpose(1, 2)
