"""Plain PyTorch versions for the int8-KV decode-attention kernel:
``repro.kernels.decode_attention.ref``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so on the same
float32 input the int8 values are those of the JAX package bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, S, nkv, hd) → int8 values + per-(position, head) f32 scales."""
    kf = k.to(torch.float32)
    scale = kf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def decode_attention_int8_ref(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                              v: torch.Tensor, v_scale: torch.Tensor, pos, *,
                              scale: float) -> torch.Tensor:
    """Dequantise, then attend: q (b, nh, hd) against keys ``<= pos``;
    returns (b, nh, hd) in q's dtype.  ``pos`` is an int or a one-element
    integer tensor."""
    b, nh, hd = q.shape
    _, S, nkv, _ = k.shape
    kf = dequantize_kv(k, k_scale)
    vf = dequantize_kv(v, v_scale)
    qr = q.reshape(b, nkv, nh // nkv, hd).to(torch.float32)
    s = torch.einsum("bgrd,bkgd->bgrk", qr, kf) * scale
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(())
    mask = torch.arange(S, device=q.device) <= pos
    s = torch.where(mask[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, vf)
    return o.reshape(b, nh, hd).to(q.dtype)
