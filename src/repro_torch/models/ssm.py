"""Mamba-2 SSD mixer, full sequence: port of ``repro.models.ssm``.

``mamba_mixer`` is in_proj → causal conv → SSD scan → gated norm →
out_proj.  The scan goes through ``ssd_op``: the hand-written CUDA kernel
for CUDA tensors, its plain version (``ssd_chunked`` as a loop over chunks)
for CPU tensors.  The projections stay ``torch.einsum``, as the JAX package
leaves them to XLA.

The decode branch (``ssd_decode_step``, ``conv_step``) belongs to the
prefill-and-decode slice and raises until then.

Shapes: x (b, l, nh, hd) · dt (b, l, nh) · A (nh,) · B, C (b, l, ds) · D (nh,)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_op
from .layers import rmsnorm

_DECODE_ITEM = "Queue 1 item 5, prefill and decode"


def _decode_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md: {_DECODE_ITEM})")


def ssd_decode_step(*args, **kwargs):
    raise _decode_unported("ssd_decode_step")


def conv_step(*args, **kwargs):
    raise _decode_unported("conv_step")


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


def mamba_mixer(params, h: torch.Tensor, cfg, *, decode: bool = False) -> torch.Tensor:
    """Mamba-2 block over the full sequence; returns out (b, l, D).

    The JAX mixer also returns the conv / SSM cache; the port has no cache
    until the decode slice."""
    if decode:
        raise _decode_unported("the mamba mixer's decode branch")
    b, l, _ = h.shape
    d_in, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = torch.einsum("bld,de->ble", h, params["w_z"])
    xBC = torch.einsum("bld,de->ble", h, params["w_xBC"])  # (b, l, d_in + 2 ds)
    dt_raw = torch.einsum("bld,dn->bln", h, params["w_dt"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xBC = F.silu(causal_conv(xBC, params["conv_w"], params["conv_b"]))
    # strided views into xBC: the kernel reads them in place
    x = xBC[..., :d_in].reshape(b, l, nh, hd)
    B = xBC[..., d_in:d_in + ds]
    C = xBC[..., d_in + ds:]
    y, _ = ssd_op(x, dt, A, B, C, params["D"], chunk=cfg.ssm_chunk)
    y = y.reshape(b, l, d_in)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, params["gate_norm"])
    return torch.einsum("ble,ed->bld", y, params["w_out"])
