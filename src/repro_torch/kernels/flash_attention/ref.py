"""Plain PyTorch version of the flash-attention kernels (O(S·Sk) memory),
with the masks of the JAX package's attention (``_mask`` in
``repro.models.attention``): causal, the prefix-LM prefix and the window.

``attention_ref`` is the forward (float32 arithmetic, float64 for float64
inputs, so that autograd through it in float64 is the backward's oracle);
``attention_fwd_ref`` adds the forward kernel's row log-sum-exp and
``attention_bwd_ref`` is the backward kernel's explicit formula."""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
#: the lse of a row with no allowed key (kernel.LSE_EMPTY): its P is 0
LSE_EMPTY = 1e30


def _allowed(S: int, Sk: int, device, *, causal: bool, window: int,
             prefix_len: int) -> torch.Tensor:
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    allowed = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        allowed = allowed & ((kp <= qp) | (kp < prefix_len))
    if window > 0:
        allowed = allowed & (qp - kp < window)
    return allowed


def _scores(q, k, *, scale, softcap):
    """(b, nkv, rep, S, Sk) scaled, soft-capped scores in the compute dtype,
    and the softcap's tanh (None without one)."""
    b, nh, S, hd = q.shape
    nkv = k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    qr = q.reshape(b, nkv, nh // nkv, S, hd).to(ct)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qr, k.to(ct)) * scale
    th = None
    if softcap > 0.0:
        th = torch.tanh(s / softcap)
        s = softcap * th
    return s, th


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
    s, _ = _scores(q, k, scale=scale, softcap=softcap)
    allowed = _allowed(S, k.shape[2], q.device, causal=causal, window=window,
                       prefix_len=prefix_len)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.to(s.dtype))
    return o.reshape(b, nh, S, hd).to(q.dtype)


def attention_fwd_ref(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with ``return_lse``: (out, lse (b, nh, S) float32),
    lse the log-sum-exp of each row's allowed scores, ``LSE_EMPTY`` where
    there is none."""
    b, nh, S, hd = q.shape
    o = attention_ref(q, k, v, scale=scale, causal=causal, window=window,
                      softcap=softcap, prefix_len=prefix_len)
    s, _ = _scores(q, k, scale=scale, softcap=softcap)
    allowed = _allowed(S, k.shape[2], q.device, causal=causal, window=window,
                       prefix_len=prefix_len)
    lse = torch.logsumexp(torch.where(allowed, s, torch.full_like(s, float("-inf"))), -1)
    lse = torch.where(allowed.any(-1), lse, torch.full_like(lse, LSE_EMPTY))
    return o, lse.reshape(b, nh, S).float()


def attention_bwd_ref(
    q: torch.Tensor,    # (b, nh, S, hd)
    k: torch.Tensor,    # (b, nkv, Sk, hd)
    v: torch.Tensor,    # (b, nkv, Sk, hd)
    o: torch.Tensor,    # (b, nh, S, hd)
    do: torch.Tensor,   # (b, nh, S, hd)
    lse: torch.Tensor,  # (b, nh, S)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes by the backward kernel's formula,
    in float32: P = exp(s - lse) on allowed entries, D = rowsum(dO * O),
    dS = P (dO V^T - D) (times 1 - tanh^2 under softcap), dq = scale dS K,
    dk = scale dS^T Q and dv = P^T dO, each summed over a kv head's group."""
    b, nh, S, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    rep = nh // nkv
    s, th = _scores(q, k, scale=scale, softcap=softcap)
    ct = s.dtype
    allowed = _allowed(S, Sk, q.device, causal=causal, window=window, prefix_len=prefix_len)
    lr = lse.reshape(b, nkv, rep, S, 1).to(ct)
    p = torch.where(allowed, torch.exp(s - lr), torch.zeros_like(s))
    g = do.reshape(b, nkv, rep, S, hd).to(ct)
    delta = (g * o.reshape(b, nkv, rep, S, hd).to(ct)).sum(-1, keepdim=True)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", g, v.to(ct))
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    qr = q.reshape(b, nkv, rep, S, hd).to(ct)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k.to(ct)) * scale
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qr) * scale
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, g)
    return dq.reshape(b, nh, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
