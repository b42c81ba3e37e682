"""Public int8-KV decode attention: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, and nothing else."""

from __future__ import annotations

import torch

from .._launch import all_on_cpu
from .kernel import decode_attention_int8
from .ref import decode_attention_int8_ref


def decode_attention_int8_op(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                             v: torch.Tensor, v_scale: torch.Tensor, pos, *,
                             scale: float) -> torch.Tensor:
    """q (b, nh, hd), k / v int8 (b, S, nkv, hd), scales f32 (b, S, nkv),
    ``pos`` an int or a one-element int32 tensor; returns (b, nh, hd)."""
    tensors = [q, k, k_scale, v, v_scale]
    if isinstance(pos, torch.Tensor):
        tensors.append(pos)
    if all_on_cpu(*tensors):
        return decode_attention_int8_ref(q, k, k_scale, v, v_scale, pos, scale=scale)
    return decode_attention_int8(q, k, k_scale, v, v_scale, pos, scale=scale)
