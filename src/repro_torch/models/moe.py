"""Mixture-of-Experts FFN: port of ``repro.models.moe.moe_ffn``.

GShard-style grouped, index-based dispatch, as plain tensor functions:

* the t tokens split into G groups (G = 1 here: the port binds no mesh);
  routing, capacity and dropping are local to a group;
* the router runs in float32 (its leaf is float32 in any model dtype, and
  x is promoted to it): softmax, top-k, the k gates renormalised;
* each group's capacity is ``Cg = max(1, int(cf * tg * K / E))`` slots per
  expert; a (token, choice) takes the next free slot of its expert, counted
  over the ``tg * K`` choices in token-major, k-minor order, and a choice
  past the capacity is dropped: it goes to a scratch row ``E * Cg`` and its
  gate is zeroed;
* the experts run in x's dtype on their (E, Cg, D) slots (every expert for
  all Cg rows, used or not), then the kept outputs are gathered back and
  combined over k in float32.

Dispatch and combine are an ``index_add_`` and an ``index_select`` with the
kept destinations unique, so nothing here waits on the device: no
``.item()``, ``nonzero`` or boolean-mask indexing.  The expert products are
``torch.einsum`` (cuBLAS on the card), as JAX leaves them to XLA outside
any Pallas kernel.

Returns (y (b, s, D) in x's dtype, the load-balance aux loss
``E * mean_G sum_e me * ce``, a float32 scalar).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

from .layers import activation


def _queue_positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """(G, n) expert ids → each one's position among the earlier entries of
    its row that chose the same expert."""
    oh = (flat_e[..., None] == torch.arange(E, device=flat_e.device)).to(torch.int32)
    pos = torch.cumsum(oh, dim=1) - oh
    return pos.gather(2, flat_e[..., None])[..., 0]


def expert_slots(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each (token, choice) in its expert's queue: idx (G, tg, K)
    expert ids → (G, tg * K) slots, counted over the choices in token-major,
    k-minor order (token t's k-th choice comes after every choice of the
    tokens before t)."""
    return _queue_positions(idx.reshape(idx.shape[0], -1), E)


def k_major_slots(idx: torch.Tensor, E: int) -> torch.Tensor:
    """For checks only: the slots in k-major order, every token's first
    choice before any second choice.  Many MoE codes order them so; JAX does
    not, and a check of the dropped tokens must see the difference."""
    G, tg, K = idx.shape
    pos = _queue_positions(idx.transpose(1, 2).reshape(G, K * tg), E)
    return pos.reshape(G, K, tg).transpose(1, 2).reshape(G, tg * K)


def dispatch(probs: torch.Tensor, K: int,
             Cg: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing and the dispatch bookkeeping of one call: probs
    (G, tg, E) float32 → (gate (G, tg, K) float32, renormalised; idx
    (G, tg, K); keep (G, tg * K) bool; dest (G, tg * K), the slot row
    ``e * Cg + slot`` of each kept choice and ``E * Cg`` for a dropped one)."""
    E = probs.shape[-1]
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    slot = expert_slots(idx, E)
    keep = slot < Cg
    dest = idx.reshape(idx.shape[0], -1) * Cg + slot
    dest = torch.where(keep, dest, torch.full_like(dest, E * Cg))
    return gate, idx, keep, dest


def moe_ffn(params, x: torch.Tensor, cfg, *, capacity_factor: Optional[float] = None,
            groups: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, D) → (y (b, s, D), aux loss).  ``capacity_factor`` defaults
    to the config's; ``groups`` to 1, and falls back to 1 where it does not
    divide the tokens or leaves a group fewer than E // K tokens."""
    b, s, Dm = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    t = b * s
    G = groups if groups is not None else 1
    if t % G != 0 or (t // G) < E // K:
        G = 1
    tg = t // G
    Cg = max(1, int(cf * tg * K / E))
    f32 = torch.float32

    xg = x.reshape(G, tg, Dm)
    logits = xg.to(f32) @ params["router"].to(f32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx, keep, dest = dispatch(probs, K, Cg)

    # load-balance aux loss (per group, then averaged)
    me = probs.mean(dim=1)
    ce = torch.zeros((G, E), dtype=f32, device=x.device).scatter_add_(
        1, idx.reshape(G, -1), torch.ones((G, tg * K), dtype=f32, device=x.device))
    aux = E * torch.mean(torch.sum(me * (ce / (tg * K)), dim=-1))

    # dispatch: each kept choice into its slot row of a flat (G (E Cg + 1), D)
    # buffer; every dropped one adds zeros to its group's scratch row
    rows = E * Cg + 1
    flat_dest = (dest + torch.arange(G, device=x.device)[:, None] * rows).reshape(-1)
    x_rep = xg[:, :, None, :].expand(G, tg, K, Dm).reshape(G * tg * K, Dm)
    kept = keep.reshape(-1, 1).to(x.dtype)
    buf = torch.zeros((G * rows, Dm), dtype=x.dtype, device=x.device)
    buf.index_add_(0, flat_dest, x_rep * kept)
    expert_in = buf.reshape(G, rows, Dm)[:, :E * Cg].reshape(G, E, Cg, Dm)

    hmid = torch.einsum("gecd,edf->gecf", expert_in, params["w_in"])
    if cfg.mlp_gated:
        g = torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"])
        hmid = activation(g, cfg.hidden_act) * hmid
    else:
        hmid = activation(hmid, cfg.hidden_act)
    expert_out = torch.einsum("gecf,efd->gecd", hmid, params["w_out"])

    # combine: gather each choice's output (zeros from the scratch row), then
    # the gate-weighted sum over k in float32
    out_pad = torch.cat([expert_out.reshape(G, E * Cg, Dm),
                         torch.zeros((G, 1, Dm), dtype=expert_out.dtype, device=x.device)],
                        dim=1).reshape(G * rows, Dm)
    gathered = out_pad.index_select(0, flat_dest).reshape(G, tg, K, Dm)
    w = gate.reshape(G, tg, K) * keep.reshape(G, tg, K).to(f32)
    y = (gathered.to(f32) * w[..., None]).sum(dim=2)
    return y.reshape(b, s, Dm).to(x.dtype), aux


@contextlib.contextmanager
def recording(calls: List[dict]) -> Iterator[List[dict]]:
    """For checks only: while open, every :func:`dispatch` appends its
    ``probs``, top-k ``idx``, ``keep`` mask and capacity ``Cg`` to ``calls``
    as device tensors (recording adds no host synchronisation)."""
    global dispatch
    inner = dispatch

    def recorded(probs, K, Cg):
        out = inner(probs, K, Cg)
        calls.append({"probs": probs, "idx": out[1], "keep": out[2], "Cg": Cg})
        return out

    dispatch = recorded
    try:
        yield calls
    finally:
        dispatch = inner


@contextlib.contextmanager
def k_major_priority() -> Iterator[None]:
    """For checks only: while open, :func:`dispatch` takes
    :func:`k_major_slots`, the fault a check of the dropped tokens must
    catch."""
    global expert_slots
    inner = expert_slots
    expert_slots = k_major_slots
    try:
        yield
    finally:
        expert_slots = inner
