"""Mamba-2 SSD mixer: port of ``repro.models.ssm``.

``mamba_mixer`` is in_proj → causal conv → SSD scan → gated norm →
out_proj.  Over a full sequence the scan goes through ``ssd_op``: the
hand-written CUDA kernel for CUDA tensors (and under grad its hand-written
backward), its plain version (``ssd_chunked`` as a loop over chunks) for
CPU tensors; its final state is the SSM cache.
One decode token goes through ``conv_step`` and ``ssd_decode_step``, the
float32 recurrence, in plain PyTorch as the JAX package leaves it to XLA.
The projections stay ``torch.einsum``.

Shapes: x (b, l, nh, hd) · dt (b, l, nh) · A (nh,) · B, C (b, l, ds) · D (nh,)
Cache: {"conv": (b, width - 1, ch) pre-conv inputs, "ssm": (b, nh, hd, ds) f32}
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distrib.act import shard
from ..kernels.ssd import ssd_op
from .layers import rmsnorm


def ssd_decode_step(
    state: torch.Tensor,  # (b, nh, hd, ds)
    x: torch.Tensor,      # (b, nh, hd)
    dt: torch.Tensor,     # (b, nh)
    A: torch.Tensor,      # (nh,)
    B: torch.Tensor,      # (b, ds)
    C: torch.Tensor,      # (b, ds)
    D: torch.Tensor,      # (nh,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence in float32; returns (y (b, nh, hd) in x's
    dtype, the new state (b, nh, hd, ds) float32)."""
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    da = torch.exp(dtf * A.to(f32))  # (b, nh)
    upd = torch.einsum("bnp,bs,bn->bnps", xf, B.to(f32), dtf)
    state_new = state.to(f32) * da[:, :, None, None] + upd
    y = torch.einsum("bnps,bs->bnp", state_new, C.to(f32))
    y = y + D.to(f32)[None, :, None] * xf
    return y.to(x.dtype), state_new


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (b, l, ch), w (width, ch), b (ch,).

    JAX's tap loop in float32, cast once to x's dtype (no ``conv1d``: on
    the card that is cuDNN, in TF32 unless switched off)."""
    width = w.shape[0]
    l = x.shape[1]
    padded = F.pad(x, (0, 0, width - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(width):
        y = y + padded[:, k:k + l, :].float() * w[k][None, None, :]
    return (y + b[None, None, :]).to(x.dtype)


def conv_step(
    conv_state: torch.Tensor,  # (b, width - 1, ch): the trailing pre-conv inputs
    x_t: torch.Tensor,         # (b, ch)
    w: torch.Tensor,
    b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal conv at one new token; returns (y (b, ch) in x_t's dtype,
    the new window of trailing inputs)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (b, width, ch)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())
    y = (y + b[None, :]).to(x_t.dtype)
    return y, window[:, 1:, :]


def mamba_mixer(params, h: torch.Tensor, cfg, *, cache: Optional[dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba-2 block.  Returns (out (b, l, D), new cache or None).

    ``decode`` takes one token (l == 1) from ``cache``.  Over a full
    sequence the new cache holds the last ``width - 1`` pre-conv inputs and
    the scan's final state; it is None for a sequence shorter than that, as
    in JAX."""
    b, l, _ = h.shape
    d_in, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w_z = shard(params["w_z"], None, "inner")
    w_xBC = shard(params["w_xBC"], None, None)
    z = shard(torch.einsum("bld,de->ble", h, w_z), "batch", "seq", "inner")
    xBC = shard(torch.einsum("bld,de->ble", h, w_xBC),  # (b, l, d_in + 2 ds)
                "batch", "seq", None)
    dt_raw = torch.einsum("bld,dn->bln", h, params["w_dt"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    if decode:
        if cache is None or l != 1:
            raise ValueError("the decode branch takes one token and a cache")
        xBC_t, conv_state = conv_step(cache["conv"], xBC[:, 0], params["conv_w"],
                                      params["conv_b"])
        xBC_t = F.silu(xBC_t)
        x_t = xBC_t[:, :d_in].reshape(b, nh, hd)
        y, ssm_state = ssd_decode_step(cache["ssm"], x_t, dt[:, 0], A,
                                       xBC_t[:, d_in:d_in + ds], xBC_t[:, d_in + ds:],
                                       params["D"])
        y = y.reshape(b, 1, d_in)
        new_cache = {"conv": conv_state, "ssm": ssm_state}
    else:
        xBC_raw = xBC  # the conv cache holds the *pre-conv* inputs
        xBC = F.silu(causal_conv(xBC_raw, params["conv_w"], params["conv_b"]))
        # strided views into xBC: the kernel reads them in place
        x = xBC[..., :d_in].reshape(b, l, nh, hd)
        B = xBC[..., d_in:d_in + ds]
        C = xBC[..., d_in + ds:]
        y, ssm_state = ssd_op(x, dt, A, B, C, params["D"], chunk=cfg.ssm_chunk)
        y = y.reshape(b, l, d_in)
        width = cfg.ssm_conv
        new_cache = ({"conv": xBC_raw[:, l - (width - 1):, :], "ssm": ssm_state}
                     if l >= width - 1 else None)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, params["gate_norm"])
    return torch.einsum("ble,ed->bld", y, shard(params["w_out"], "inner", None)), new_cache
