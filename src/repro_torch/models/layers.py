"""Shared primitive layers as tensor functions: norms, activations, softcap,
RoPE, whisper's sinusoidal positions, the (gated) MLP.  Numerics follow
``repro.models.layers``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..distrib.act import shard


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def apply_norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim // 2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, h, d), positions: (s,) or (b, s).  Rotates split halves."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)
    if cos.dim() == 2:  # (s, d/2) -> broadcast over batch & heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (b, s, d/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings, (seq, d_model)."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / max(1, d_model // 2 - 1)))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


# ----------------------------------------------------------------------- MLP

def mlp(params, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    # weights to their compute (TP) layout before use; shard leaves an x of
    # other than three dims, and so its products, as they are
    w_in = shard(params["w_in"], None, "ffn")
    w_out = shard(params["w_out"], "ffn", None)
    h = shard(x @ w_in, "batch", "seq", "ffn")
    if gated:
        h = activation(x @ shard(params["w_gate"], None, "ffn"), act) * h
    else:
        h = activation(h, act)
    return shard(h @ w_out, "batch", "seq", "embed")
