"""Mixture-of-Experts FFN: port of ``repro.models.moe.moe_ffn``.

GShard-style grouped, index-based dispatch, as plain tensor functions:

* the t tokens split into G groups (G = the batch-axis shards of the
  active binding, 1 unbound); routing, capacity and dropping are local to
  a group;
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

``moe_ffn_sharded`` is the distributed form under a logical-axis binding
(``distrib.act``): rank-local code with explicit collectives where JAX
has a ``shard_map``.  ``routed`` binds another form in its place (the dry
run's global step, ``launch/specs.py``).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..distrib.act import batch_shards, current_binding
from ..distrib.sharding import mesh_shape
from .layers import activation

_ROUTE: ContextVar[Optional[Callable]] = ContextVar("repro_torch_moe_route", default=None)


@contextlib.contextmanager
def routed(fn: Callable) -> Iterator[None]:
    """While open, a MoE layer under a binding runs ``fn`` (the signature of
    ``moe_ffn_sharded``) in its place."""
    token = _ROUTE.set(fn)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def bound_route() -> Optional[Callable]:
    """The MoE FFN ``routed`` binds, or None."""
    return _ROUTE.get()


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
    to the config's; ``groups`` to the binding's batch shards (1 unbound),
    and falls back to 1 where it does not divide the tokens or leaves a
    group fewer than E // K tokens."""
    b, s, Dm = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    t = b * s
    G = groups if groups is not None else batch_shards()
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


# ---------------------------------------------------------------------------
# expert parallelism across ranks (the distributed hot path)
# ---------------------------------------------------------------------------
#
# Tokens are sharded over the FSDP axes, as JAX's shard_map takes them (a
# rank's batch shard is first gathered over any batch axis that is not an
# FSDP axis: all of them in the serving layout); every rank of one "model"
# group holds the same tokens, so dispatch needs no communication: rank j
# selects the tokens routed to the experts it owns (EP), or computes every
# expert on its slice of the hidden dim (TP, when E does not divide the
# model axis).  The combined output is all-reduced over "model".
# FSDP-sharded expert weights are all-gathered over the batch axes right
# before use.

#: the dtype the combine's all-reduce carries (JAX: bf16 on the wire, after
#: the float32 partial sums)
_COMBINE_DTYPE = torch.bfloat16


def _gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather ``t`` over ``group`` and concatenate the pieces along
    ``dim`` in the group's rank order (JAX's tiled ``all_gather``); over
    one rank, ``t`` itself."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _gather_fsdp(mesh, fsdp: Tuple[str, ...], w: torch.Tensor, dim: int,
                 quant: bool) -> torch.Tensor:
    """The FSDP weight gather over each batch axis, minor axis first, along
    ``dim``; ``quant`` sends int8 with per-row symmetric float32 scales
    (their reduced dim is never the gathered one), dequantized after."""
    if not fsdp:
        return w  # serving (TP-only) layout: nothing to gather
    if not quant:
        for a in reversed(fsdp):
            w = _gather_cat(w, mesh.get_group(a), dim)
        return w
    red = w.dim() - 1 if dim != w.dim() - 1 else w.dim() - 2
    scale = torch.amax(torch.abs(w), dim=red, keepdim=True).to(torch.float32)
    scale = scale / 127.0 + 1e-12
    q = torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127).to(torch.int8)
    for a in reversed(fsdp):
        g = mesh.get_group(a)
        q = _gather_cat(q, g, dim)
        scale = _gather_cat(scale, g, dim)
    return (q.to(torch.float32) * scale).to(w.dtype)


def _model_rank(mesh) -> int:
    return mesh.get_local_rank("model")


def _axes(rules, name: str) -> Tuple[str, ...]:
    axes = rules.get(name) or ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _whole_experts(params, mesh, fsdp: Tuple[str, ...], ep: bool, gated: bool):
    """The expert weights whole on every rank, gathered from their layout
    (``Rules.layer_specs``: E or F on "model", D over the FSDP axes)."""
    model = mesh.get_group("model")
    names = ("w_in", "w_gate", "w_out") if gated else ("w_in", "w_out")
    out = {"router": params["router"]}
    for n in names:
        d_dim = 2 if n == "w_out" else 1
        w = _gather_fsdp(mesh, fsdp, params[n], d_dim, False)
        m_dim = 0 if ep else 3 - d_dim
        out[n] = _gather_cat(w, model, m_dim)
    return out


def _all_reduce(t: torch.Tensor, group) -> int:
    """Sum ``t`` in place over ``group``; over one rank, nothing (as
    ``_gather_cat``).  Returns the group's size."""
    n = dist.get_world_size(group)
    if n > 1:
        dist.all_reduce(t, group=group)
    return n


def _rank_in(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's index over ``axes``, major axis first."""
    shape, r = mesh_shape(mesh), 0
    for a in axes:
        r = r * shape[a] + mesh.get_local_rank(a)
    return r


def moe_ffn_sharded(params, x: torch.Tensor, cfg, *,
                    capacity_factor: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on this rank's shards under the active binding: ``x``
    (b_loc, s, D) is the rank's batch shard over ``rules["batch"]`` (the
    whole batch where that maps no axis), the expert weights the rank's
    shards of ``Rules.layer_specs``' layout, the router whole.  Returns
    (the rank's y (b_loc, s, D), aux averaged over the FSDP axes).

    As in JAX, the tokens are sharded over the FSDP axes
    (``rules["moe_weight_fsdp"]``, a leading part of the batch axes: all
    of them in the training layout, none in the serving one): ``x`` is
    gathered over the other batch axes, routing, capacity and aux are
    those of the gathered tokens, and the rank's rows of y are returned.

    Where the batch maps no axis or the mesh has no "model" axis, the
    weights are gathered whole and ``moe_ffn(groups=1)`` runs on every
    rank, as JAX falls back."""
    bound = current_binding()
    if bound is None:
        raise RuntimeError("moe_ffn_sharded needs a logical_axis_rules binding")
    mesh, rules = bound
    shape = mesh_shape(mesh)
    b, s, Dm = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    gated = cfg.mlp_gated
    fsdp = _axes(rules, "moe_weight_fsdp")
    batch = _axes(rules, "batch")
    if not batch or "model" not in shape:
        if "model" in shape:
            params = _whole_experts(params, mesh, fsdp, E % shape["model"] == 0, gated)
        return moe_ffn(params, x, cfg, capacity_factor=capacity_factor, groups=1)
    if batch[:len(fsdp)] != fsdp:
        raise ValueError(f"moe_weight_fsdp {fsdp} is not a leading part of the batch "
                         f"axes {batch}")
    rest = batch[len(fsdp):]
    for a in reversed(rest):  # to JAX's token shard: the rows of the FSDP shard
        x = _gather_cat(x, mesh.get_group(a), 0)

    msize = shape["model"]
    ep = E % msize == 0
    quant = bool(getattr(cfg, "moe_int8_gather", False)) and bool(fsdp)
    f32 = torch.float32
    t_loc = x.shape[0] * s
    xt = x.reshape(t_loc, Dm)
    probs = torch.softmax(xt.to(f32) @ params["router"].to(f32), dim=-1)
    C = max(1, int(cf * t_loc * K / E))
    gate, idx, keep, dest = (t[0] for t in dispatch(probs[None], K, C))
    x_rep = xt.repeat_interleave(K, dim=0)

    # aux loss (the same on every model rank; mean over the FSDP axes)
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=f32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones((t_loc * K,), dtype=f32, device=x.device))
    aux = E * torch.sum(me * (ce / (t_loc * K)))
    for a in fsdp:
        n = _all_reduce(aux, mesh.get_group(a))
        if n > 1:
            aux = aux / n

    w_in = _gather_fsdp(mesh, fsdp, params["w_in"], 1, quant)
    w_gate = _gather_fsdp(mesh, fsdp, params["w_gate"], 1, quant) if gated else None
    w_out = _gather_fsdp(mesh, fsdp, params["w_out"], 2, quant)
    if ep:
        E_loc = E // msize
        j = _model_rank(mesh)
        # a dropped choice's scratch row E·C gives E // E_loc = msize: no owner
        own = ((dest // C) // E_loc) == j
        dest_loc = torch.where(own, dest - j * (E_loc * C), torch.full_like(dest, E_loc * C))
        wts = keep & own
        n_rows = E_loc * C
    else:  # every expert, on this rank's slice of the hidden dim
        dest_loc, wts, n_rows = dest, keep, E * C
    buf = torch.zeros((n_rows + 1, Dm), dtype=xt.dtype, device=x.device)
    buf.index_add_(0, dest_loc, x_rep * wts[:, None].to(xt.dtype))
    expert_in = buf[:n_rows].reshape(-1, C, Dm)

    hmid = torch.einsum("ecd,edf->ecf", expert_in, w_in)
    if gated:
        g = torch.einsum("ecd,edf->ecf", expert_in, w_gate)
        hmid = activation(g, cfg.hidden_act) * hmid
    else:
        hmid = activation(hmid, cfg.hidden_act)
    out = torch.einsum("ecf,efd->ecd", hmid, w_out)
    out_pad = torch.cat([out.reshape(-1, Dm),
                         torch.zeros((1, Dm), dtype=out.dtype, device=x.device)])
    got = out_pad.index_select(0, dest_loc)  # zeros where not owned or dropped
    w8 = gate.reshape(-1) * wts.to(f32)
    y = (got.to(f32) * w8[:, None]).reshape(t_loc, K, Dm).sum(dim=1)
    # the combine rides the wire in bf16: the float32 partial sums first
    y = y.to(_COMBINE_DTYPE)
    _all_reduce(y, mesh.get_group("model"))
    y = y.reshape(-1, s, Dm)
    if rest:  # this rank's rows of the FSDP shard
        r = _rank_in(mesh, rest)
        y = y[r * b:(r + 1) * b]
    return y.to(x.dtype), aux


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


@contextlib.contextmanager
def ep_owner_shifted() -> Iterator[None]:
    """For checks only: while open, each rank of ``moe_ffn_sharded``'s EP
    path takes the tokens of the experts its next "model" rank owns, the
    fault a check of expert ownership must catch."""
    global _model_rank
    inner = _model_rank
    _model_rank = lambda mesh: (inner(mesh) + 1) % mesh_shape(mesh)["model"]  # noqa: E731
    try:
        yield
    finally:
        _model_rank = inner


@contextlib.contextmanager
def combine_in(dtype: torch.dtype) -> Iterator[None]:
    """For checks only: while open, ``moe_ffn_sharded``'s combine
    all-reduces in ``dtype`` instead of bf16."""
    global _COMBINE_DTYPE
    inner = _COMBINE_DTYPE
    _COMBINE_DTYPE = dtype
    try:
        yield
    finally:
        _COMBINE_DTYPE = inner
