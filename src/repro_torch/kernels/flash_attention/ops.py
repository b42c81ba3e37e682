"""Public flash attention in the model's (b, s, heads, hd) layout: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors."""

from __future__ import annotations

import torch

from .._launch import all_on_cpu
from .kernel import flash_attention
from .ref import attention_ref


def flash_attention_op(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, s, nkv, hd)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if all_on_cpu(q, k, v):
        return attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    return flash_attention(qt, kt, vt, **kw).transpose(1, 2)
