"""Optimizers of the port: AdamW and a factored-second-moment variant
(Adafactor-style), as plain functions over nested dicts of tensors.

Port of ``repro.optim`` with its arithmetic: the schedule and the bias
corrections are float32 tensors, the clip scale is cast to each gradient's
dtype, weight decay falls on leaves of two or more dims only, and a leaf of
three or more dims whose float32 temporaries exceed
``update_chunk_bytes`` is updated slice by slice along axis 0 (JAX's
``lax.map``), which bounds the temporaries and, for Adafactor, makes the
update clipping's RMS one per slice, as JAX's does.  Where axis 0 has
length 1 (one stacked layer, which ``lax.map`` leaves whole and XLA fuses),
Adafactor walks the leaf's matrices in two passes instead, with the whole
leaf's RMS: a single-period jamba's 16 experts would otherwise need about
five float32 copies of a 3.5 GiB leaf at once.

Unlike JAX's immutable arrays, the clip scales the given gradients and the
update writes the new parameters and moments into the given tensors in
place (a 3B model's float32 moments are
not copied each step); the returned state holds the same tensors and a new
step counter.  The state stays on the parameters' device and nothing waits
on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from ..convert import flat_tensors
from ..distrib.sharding import P, map_specs

PyTree = Any


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    accum_dtype: str = "float32"   # grad-accumulation dtype (314B: bfloat16)
    # leaves whose f32 update temporaries exceed this are updated slice by
    # slice along the stacked-layer axis
    update_chunk_bytes: int = 128 * 1024 * 1024


def leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of a nested dict in JAX's leaf order (sorted keys)."""
    return [t for _, t in flat_tensors(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _slice(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def _chunked(cfg: OptimizerConfig, fn: Callable, *args) -> None:
    """Apply an in-place per-leaf update slice by slice along axis 0 when
    the f32 temporaries would be large (stacked weights are GBs a leaf)."""
    p = args[0]
    if p.dim() >= 3 and p.numel() * 4 > cfg.update_chunk_bytes and p.shape[0] > 1:
        for i in range(p.shape[0]):
            fn(*(_slice(a, i) for a in args))
    else:
        fn(*args)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: PyTree) -> torch.Tensor:
    total = None
    for g in leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float, *,
                        prescale: float = 1.0) -> Tuple[PyTree, torch.Tensor]:
    """Clip to ``max_norm``, scaling the given tensors in place (a copy of a
    model's gradients would double their memory) and returning them.
    ``prescale`` folds a pending constant factor (1 / microbatches from
    gradient accumulation) into the one multiply."""
    gnorm = global_norm(grads) * prescale
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0) * prescale
    # the scale in each grad's own dtype: no f32 copy of a bf16 leaf
    tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads)
    return grads, gnorm


# ------------------------------------------------------------------- AdamW

def adamw_init(params: PyTree) -> PyTree:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": step}


def adamw_update(cfg: OptimizerConfig, grads: PyTree, state: PyTree, params: PyTree):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd_inner(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    with torch.no_grad():
        tree_map(lambda g, m, v, p: _chunked(cfg, upd_inner, p, g, m, v),
                 grads, state["m"], state["v"], params)
    return params, {"m": state["m"], "v": state["v"], "step": step}


# --------------------------------------------------------------- Adafactor

def adafactor_init(params: PyTree) -> PyTree:
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"v": tree_map(init, params), "step": step}


def adafactor_update(cfg: OptimizerConfig, grads: PyTree, state: PyTree, params: PyTree):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8

    def upd_inner(p, g, v):
        g = g.to(torch.float32)
        g2 = torch.square(g) + 1e-30
        if p.dim() >= 2:
            vr = decay * v["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * v["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            r = vr / torch.mean(vr, dim=-1, keepdim=True)
            delta = g / (torch.sqrt(r[..., None] * vc[..., None, :]) + cfg.eps)
            new = {"vr": vr, "vc": vc}
        else:
            new = {"v": decay * v["v"] + (1 - decay) * g2}
            delta = g / (torch.sqrt(new["v"]) + cfg.eps)
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta / torch.clamp(rms, min=1.0)  # Adafactor update clipping
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        for k, t in new.items():
            v[k].copy_(t)

    def upd_streamed(p, g, v):
        """``upd_inner`` for a leaf of one stacked layer: its matrices one
        at a time, the sum of squared deltas first, then the update with
        the whole leaf's RMS (the factored statistics are per matrix)."""
        R, C = p.shape[-2:]
        ps, gs = p.view(-1, R, C), g.reshape(-1, R, C)
        vrs, vcs = v["vr"].view(-1, R), v["vc"].view(-1, C)

        def delta_of(i):
            gi = gs[i].to(torch.float32)
            g2 = torch.square(gi) + 1e-30
            vr = decay * vrs[i] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * vcs[i] + (1 - decay) * torch.mean(g2, dim=-2)
            r = vr / torch.mean(vr, dim=-1, keepdim=True)
            return gi / (torch.sqrt(r[:, None] * vc[None, :]) + cfg.eps), vr, vc

        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for i in range(ps.shape[0]):
            sq = sq + torch.sum(torch.square(delta_of(i)[0]))
        rms = torch.sqrt(sq / p.numel() + 1e-30)
        for i in range(ps.shape[0]):
            delta, vr, vc = delta_of(i)
            delta = delta / torch.clamp(rms, min=1.0) + cfg.weight_decay * ps[i].to(torch.float32)
            ps[i].copy_((ps[i].to(torch.float32) - lr * delta).to(p.dtype))
            vrs[i].copy_(vr)
            vcs[i].copy_(vc)

    def per_leaf(g, p, v):
        if p.dim() >= 3 and p.shape[0] == 1 and p.numel() * 4 > cfg.update_chunk_bytes:
            upd_streamed(p, g, v)
        else:
            _chunked(cfg, upd_inner, p, g, v)

    with torch.no_grad():
        _map_params(per_leaf, grads, params, state["v"])
    return params, {"v": state["v"], "step": step}


def _map_params(fn, grads, params, vstate) -> None:
    """fn(g, p, v) over the parameter leaves, ``v`` the leaf's state dict
    (the state tree is the parameter tree with a dict at each leaf)."""
    if isinstance(grads, dict):
        for k in grads:
            _map_params(fn, grads[k], params[k], vstate[k])
    else:
        fn(grads, params, vstate)


# ------------------------------------------------------------------ facade

def make_optimizer(cfg: OptimizerConfig):
    """(init_fn(params) -> state, update_fn(grads, state, params) ->
    (params, state)); the update writes into ``params`` and the moments in
    place."""
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(cfg, g, s, p)
    raise ValueError(cfg.name)


def zero2_specs(param_specs: PyTree, params_shapes: PyTree, batch_axes,
                batch_size: int):
    """ZeRO-2 optimizer-state specs: take the parameter's (TP-only) spec and
    shard its first free, divisible dimension over the batch axes — the
    optimizer state is 2-D sharded even though the weights are TP-only.
    ``params_shapes``: the parameter tree (e.g. ``Model.param_shapes()``)."""
    def per(spec, shape):
        dims = tuple(shape.shape)
        spec = list(spec) + [None] * (len(dims) - len(spec))
        for i, (ax, dim) in enumerate(zip(spec, dims)):
            if ax is None and dim % batch_size == 0 and dim > 1:
                spec[i] = batch_axes
                break
        return P(*spec)

    return map_specs(per, param_specs, params_shapes)


def opt_state_specs(opt_name: str, param_specs: PyTree, params_shapes: PyTree,
                    *, zero2=None):
    """Derive optimizer-state PartitionSpecs from the parameter specs.

    ``zero2=(batch_axes, batch_size)`` re-shards m/v over the batch axes
    (the weights stay TP-only; see Rules.weight_fsdp)."""
    if zero2 is not None:
        param_specs = zero2_specs(param_specs, params_shapes, *zero2)
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    if opt_name == "adafactor":
        def per(spec, shape):
            if len(shape.shape) >= 2:
                return {
                    "vr": P(*tuple(spec)[:-1]),
                    "vc": P(*(tuple(spec)[:-2] + (tuple(spec)[-1],))),
                }
            return {"v": spec}

        return {
            "v": map_specs(per, param_specs, params_shapes),
            "step": P(),
        }
    raise ValueError(opt_name)
