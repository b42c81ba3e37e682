"""Activation sharding by logical axis names: port of ``repro.distrib.act``.

Models annotate activations and weights with *logical* axis names; the
launch layer binds a logical→mesh mapping.  The port's model code is
rank-local: each rank holds plain tensors (its shard, or the whole tensor),
and communication is explicit (``moe_ffn_sharded``).  So ``shard`` changes
only a ``DTensor``, which it redistributes to the mapped placements; a
plain tensor passes through as is, and outside any binding ``shard`` is the
identity.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Dict, Optional, Tuple, Union

import torch

from .sharding import P, Rules, mesh_shape, placements

Axis = Union[None, str, Tuple[str, ...]]

_BINDING: ContextVar[Optional[Tuple[object, Dict[str, Axis]]]] = ContextVar(
    "repro_torch_act_sharding", default=None
)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: Dict[str, Axis]):
    token = _BINDING.set((mesh, rules))
    try:
        yield
    finally:
        _BINDING.reset(token)


def _axes_size(shape: Dict[str, int], axis: Axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def _logical_spec(mesh, rules: Dict[str, Axis], dims, logical) -> P:
    """The mesh spec of a tensor of shape ``dims`` named ``logical``: each
    dim that does not divide its mapped mesh axes degrades to
    replication (batch=1 cells and odd vocab sizes reuse the names)."""
    shape = mesh_shape(mesh)
    spec = []
    for dim, name in zip(dims, logical):
        axis = rules.get(name) if name is not None else None
        if axis is not None:
            size = _axes_size(shape, axis)
            if size == 0 or dim % size != 0:
                axis = None
        spec.append(axis)
    return P(*spec)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out so dim i is sharded per the logical axis name i: a
    ``DTensor`` is redistributed; a rank-local tensor is returned as is."""
    bound = _BINDING.get()
    if bound is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = bound
    if len(logical) != x.ndim:
        return x
    spec = _logical_spec(mesh, rules, x.shape, logical)
    return x.redistribute(mesh, placements(mesh, spec))


def current_binding():
    """(mesh, rules) of the active logical-axis binding, or None."""
    return _BINDING.get()


def batch_shards() -> int:
    """Number of batch-axis shards in the current binding (1 if unbound).
    MoE uses this as the GShard group count G."""
    bound = _BINDING.get()
    if bound is None:
        return 1
    mesh, rules = bound
    axis = rules.get("moe_group") or rules.get("batch")
    if axis is None:
        return 1
    return _axes_size(mesh_shape(mesh), axis)


def default_rules(mesh, cfg, *, batch: int,
                  weight_fsdp: bool = True) -> Dict[str, Axis]:
    """Logical→mesh mapping for a model config on a mesh (see Rules)."""
    r = Rules(mesh, weight_fsdp=weight_fsdp)
    return {
        "moe_weight_fsdp": r.wf,
        "batch": r.batch_if(batch),
        "seq": None,
        "embed": None,
        "heads": r.model_if(cfg.num_heads),
        "kv_heads": r.model_if(cfg.num_kv_heads),
        "head_dim": None,
        # KV caches shard head_dim when kv_heads can't take the model axis
        "cache_hd": (r.model_if(cfg.head_dim)
                     if r.model_if(cfg.num_kv_heads) is None else None),
        "ffn": r.model_if(cfg.d_ff) if cfg.d_ff else None,
        "ffn2": r.model_if(2 * cfg.d_ff) if cfg.d_ff else None,
        "qkv_heads": r.model_if(cfg.num_heads + 2 * cfg.num_kv_heads),
        # experts on "model" when E divides it (EP); otherwise TP the expert
        # hidden dim instead — never both on the same mesh axis.
        "experts": (r.model_if(cfg.num_experts) if cfg.num_experts else None),
        "moe_ffn": (
            r.model_if(cfg.moe_d_ff)
            if cfg.num_experts and r.model_if(cfg.num_experts) is None
            else None
        ),
        "moe_cap": r.ax.batch,
        "moe_group": r.ax.batch,
        "inner": r.model_if(cfg.d_inner) if cfg.ssm_state else None,
        "vocab": r.model_if(cfg.vocab_size),
    }
