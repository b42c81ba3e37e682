"""Attention oracles in the model's (b, s, heads, hd) layout.

``blockwise_attention`` (query blocks, an online softmax over KV blocks,
fully masked KV blocks skipped) and ``naive_attention`` (O(s²) memory)
follow ``repro.models.attention``.  They are references for the tests and
for ``chip_smoke.py``; the forward's attention goes through
``repro_torch.kernels.flash_attention.flash_attention_op`` (the CUDA kernel
on the card).
"""

from __future__ import annotations

import torch

from .layers import softcap as _softcap

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, prefix_len: int) -> torch.Tensor:
    """(qb, kb) boolean allowed-mask."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    allowed = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                         device=q_pos.device)
    if causal:
        c = kp <= qp
        if prefix_len > 0:
            c = c | (kp < prefix_len)
        allowed = allowed & c
    if window > 0:
        allowed = allowed & (qp - kp < window)
    return allowed


def blockwise_attention(
    q: torch.Tensor,  # (b, qs, nh, hd)
    k: torch.Tensor,  # (b, ks, nkv, hd)
    v: torch.Tensor,  # (b, ks, nkv, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    b, qs, nh, hd = q.shape
    _, ks, nkv, _ = k.shape
    rep = nh // nkv
    q_block = min(q_block, qs)
    kv_block = min(kv_block, ks)
    assert qs % q_block == 0 and ks % kv_block == 0, (qs, q_block, ks, kv_block)
    dev = q.device
    qr = q.reshape(b, qs, nkv, rep, hd)
    outs = []
    for q_lo in range(0, qs, q_block):
        qi = qr[:, q_lo:q_lo + q_block]
        acc = torch.zeros((b, q_block, nkv, rep, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, q_block, nkv, rep), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, q_block, nkv, rep), dtype=torch.float32, device=dev)
        q_abs = q_offset + q_lo
        q_hi = q_abs + q_block - 1
        for k_lo in range(0, ks, kv_block):
            k_hi = k_lo + kv_block - 1
            # skip fully masked KV blocks, as the JAX path's lax.cond does
            if causal and k_lo > q_hi:
                continue
            if window > 0 and not (k_hi >= q_abs - window + 1
                                   or (prefix_len > 0 and k_lo < prefix_len)):
                continue
            kj = k[:, k_lo:k_lo + kv_block]
            vj = v[:, k_lo:k_lo + kv_block]
            s = torch.einsum("bqgrd,bkgd->bqgrk", qi.float(), kj.float()) * scale
            if logit_softcap > 0.0:
                s = _softcap(s, logit_softcap)
            allowed = _mask(
                q_abs + torch.arange(q_block, device=dev),
                k_lo + torch.arange(kv_block, device=dev),
                causal=causal, window=window, prefix_len=prefix_len)
            s = torch.where(allowed[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqgrk,bkgd->bqgrd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, qs, nh, hd)


def naive_attention(q, k, v, *, scale, causal=True, window=0, prefix_len=0,
                    logit_softcap=0.0, q_offset: int = 0):
    """O(s²)-memory oracle."""
    b, qs, nh, hd = q.shape
    _, ks, nkv, _ = k.shape
    rep = nh // nkv
    qr = q.reshape(b, qs, nkv, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bqgrk", qr.float(), k.float()) * scale
    if logit_softcap > 0.0:
        s = _softcap(s, logit_softcap)
    dev = q.device
    allowed = _mask(q_offset + torch.arange(qs, device=dev),
                    torch.arange(ks, device=dev),
                    causal=causal, window=window, prefix_len=prefix_len)
    s = torch.where(allowed[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqgrk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, qs, nh, hd).to(q.dtype)
