"""Plain PyTorch version of the flash-attention kernel (O(S·Sk) memory),
with the masks of the JAX package's attention (``_mask`` in
``repro.models.attention``): causal, the prefix-LM prefix and the window."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (b, nh, S, hd)
    k: torch.Tensor,  # (b, nkv, Sk, hd)
    v: torch.Tensor,  # (b, nkv, Sk, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix_len: int = 0,
) -> torch.Tensor:
    b, nh, S, hd = q.shape
    _, nkv, Sk, _ = k.shape
    rep = nh // nkv
    qr = q.reshape(b, nkv, rep, S, hd).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qr, k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    allowed = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        allowed = allowed & ((kp <= qp) | (kp < prefix_len))
    if window > 0:
        allowed = allowed & (qp - kp < window)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, nh, S, hd).to(q.dtype)
