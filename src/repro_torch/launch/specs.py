"""Per-(arch × shape) cells: meta-tensor inputs and spec trees.  Port of
``repro.launch.specs``.

``batch_structs`` and ``cache_structs`` build every model input as a tensor
on the meta device (shape and dtype, no allocation), and ``build_cell``
assembles the (fn, args, in / out spec trees, donated args) of one cell,
which the dry run traces (``launch/dryrun.py``) and ``chip_smoke.py`` runs
on the card with real tensors.

Shape semantics per the assignment:
  * train_*   → train_step(state, batch) on (global_batch, seq_len) tokens
  * prefill_* → prefill_step(params, batch) building a seq_len cache
  * decode_*  → serve_step(params, cache, token, pos): ONE new token against
                a seq_len KV cache (SSM archs: constant-size state instead)
  * enc-dec (whisper): frames = seq_len stub embeddings, text = seq_len // 8
  * vlm (paligemma): 256 stub patch embeddings + (seq_len − 256) text tokens
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import opcost
from ..distrib.act import current_binding, default_rules, logical_axis_rules
from ..distrib.sharding import P, Rules, mesh_shape
from ..models import Model, build_model
from ..models.config import ModelConfig, ShapeConfig
from ..models.moe import moe_ffn, routed
from ..models.transformer import torch_dtype
from ..optim import OptimizerConfig, opt_state_specs
from .steps import make_prefill_step, make_serve_step, make_train_step, train_state_shapes

PyTree = Any


def st(shape, dtype) -> torch.Tensor:
    """A meta tensor: JAX's ``ShapeDtypeStruct``."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def dec_len(cfg: ModelConfig, seq: int) -> int:
    """Text length for enc-dec archs (encoder takes the full seq_len)."""
    return max(seq // 8, 64)


def batch_structs(cfg: ModelConfig, batch: int, seq: int, *, labels: bool) -> Dict:
    if cfg.is_encoder_decoder:
        d = dec_len(cfg, seq)
        out = {
            "tokens": st((batch, d), torch.int32),
            "prefix_embeds": st((batch, seq, cfg.d_model), cfg.dtype),
        }
        if labels:
            out["labels"] = st((batch, d), torch.int32)
        return out
    if cfg.num_prefix_tokens:
        text = seq - cfg.num_prefix_tokens
        out = {
            "tokens": st((batch, text), torch.int32),
            "prefix_embeds": st((batch, cfg.num_prefix_tokens, cfg.d_model), cfg.dtype),
        }
        if labels:
            out["labels"] = st((batch, text), torch.int32)
        return out
    out = {"tokens": st((batch, seq), torch.int32)}
    if labels:
        out["labels"] = st((batch, seq), torch.int32)
    return out


def cache_structs(model: Model, batch: int, seq: int) -> PyTree:
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        return model.init_cache(batch, dec_len(cfg, seq), enc_len=seq, device="meta")
    return model.init_cache(batch, seq, device="meta")


def opt_for(cfg: ModelConfig) -> OptimizerConfig:
    """Full f32 Adam except where it cannot fit: grok-314B uses a factored
    second moment and bf16 gradient accumulation (params+grads+opt for 314B
    at full f32 Adam is ~4.4 TB — more than the whole pod's HBM).
    ZeRO-2 archs accumulate grads in bf16 (grads are bf16-valued anyway;
    clipping + Adam absorb the rounding — §Perf log)."""
    if cfg.name.startswith("grok"):
        return OptimizerConfig(name="adafactor", accum_dtype="bfloat16")
    if train_sharding(cfg) == "zero2":
        return OptimizerConfig(name="adamw", accum_dtype="bfloat16")
    return OptimizerConfig(name="adamw")


def train_sharding(cfg: ModelConfig) -> str:
    """fsdp (ZeRO-3-style, default) vs zero2 (TP-only weights + 2-D sharded
    optimizer state).  ZeRO-2 removes the per-microbatch weight re-gathers —
    the dominant collective for big-d_ff dense models — whenever the TP
    weight shard itself fits (§Perf cell A)."""
    # MEASURED on TPU v5e by the JAX package (its EXPERIMENTS.md §Perf cell
    # A, iteration 1): ZeRO-2 was WORSE for gemma2-27b train_4k: at 65k
    # tokens/device the TP activation all-reduces (2·tok·D per layer)
    # outweigh FSDP weight re-gathers (params×microbatches). Kept available
    # via this switch.
    return "fsdp"


def microbatch_seqs(cfg: ModelConfig) -> int:
    """Sequences per device per accumulation slice (the JAX package's
    16 GB v5e budget, kept so the cells compare one for one)."""
    if cfg.name.startswith("grok"):
        return 2
    if train_sharding(cfg) == "zero2":
        return 1   # ZeRO-2 collectives are per-token: more microbatches are
                   # free on the wire and shrink the remat stack
    return 4


def remat_group_for(cfg: ModelConfig) -> int:
    """Two-level remat for deep stacks (the JAX package's v5e budget)."""
    from ..models.blocks import build_plan
    n = build_plan(cfg).n_repeat
    return 8 if (cfg.name.startswith("grok") and n % 8 == 0) else 1


@dataclass
class Cell:
    """One cell: ``fn(*args)`` is its step, ``args`` meta tensors (or real
    ones in their place), ``in_specs`` / ``out_specs`` the spec trees of
    its inputs and outputs, ``donate_argnums`` the inputs its outputs
    replace.  The rest is what the cost model reads: the config and shape,
    the rules, the parameters' meta tensors and specs, the microbatches and
    the remat group."""

    name: str
    fn: Callable
    args: Tuple
    in_specs: Tuple
    out_specs: Any
    donate_argnums: Tuple[int, ...]
    cfg: ModelConfig
    shape: ShapeConfig
    rules: Rules
    param_shapes: PyTree
    param_specs: PyTree
    microbatches: int = 1
    remat_group: int = 1


def _axes(rules, name: str) -> Tuple[str, ...]:
    a = rules.get(name) or ()
    return (a,) if isinstance(a, str) else tuple(a)


def global_moe_ffn(params, x: torch.Tensor, cfg, *,
                   capacity_factor: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of a cell's global step: ``moe_ffn`` over every token in
    the layout ``moe_ffn_sharded`` gives the ranks (as JAX's shard_map).
    The tokens route in one group per FSDP shard, and the expert work is
    counted once for each device that does it: in the serving layout (no
    FSDP axes) every replica over the batch axes routes the whole batch
    (``opcost.repeated``).  Where ``moe_ffn_sharded`` falls back (the batch
    maps no axis, or no "model" axis), one group split over the devices, as
    JAX's fallback leaves it to the partitioner (the port's own fallback
    gathers the experts whole on every rank)."""
    mesh, rules = current_binding()
    sizes = mesh_shape(mesh)
    if not _axes(rules, "batch") or "model" not in sizes:
        return moe_ffn(params, x, cfg, capacity_factor=capacity_factor, groups=1)
    groups = math.prod(sizes[a] for a in _axes(rules, "moe_weight_fsdp"))
    rep = math.prod(sizes.values()) // (groups * sizes["model"])
    if rep > 1 and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in params.values())):
        raise NotImplementedError(
            f"{rep} replicas of the MoE FFN under autograd: its backward would be "
            "counted once")
    with opcost.repeated(rep):
        return moe_ffn(params, x, cfg, capacity_factor=capacity_factor, groups=groups)


def _bind_act_rules(fn: Callable, mesh, cfg: ModelConfig, batch: int,
                    weight_fsdp: bool = True) -> Callable:
    """Wrap a step fn so it runs under the logical-axis binding, its MoE
    layers on ``global_moe_ffn``."""
    rules = default_rules(mesh, cfg, batch=batch, weight_fsdp=weight_fsdp)

    def wrapped(*args):
        with logical_axis_rules(mesh, rules), routed(global_moe_ffn):
            return fn(*args)

    return wrapped


def _serve_at_last_slot(step: Callable, last: int) -> Callable:
    """The serve step with a meta position read as the cache's last slot:
    a meta tensor has no value to read, and the step's work does not depend
    on it (attention reads the whole cache under a mask)."""

    def serve(params, cache, tokens, pos):
        if isinstance(pos, torch.Tensor) and pos.is_meta:
            pos = last
        return step(params, cache, tokens, pos)

    return serve


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    loss_chunk: int = 512,
) -> Cell:
    # serving layout: weights TP-only (no FSDP re-gathers) for non-train
    # cells — IF the TP shard fits the HBM budget (grok-314B: 39 GiB/dev
    # TP-only → keep FSDP and pay the per-step gather); ZeRO-2 train cells
    # are TP-only too (opt state carries the 2-D)
    rules0 = Rules(mesh)
    tp_shard_bytes = 2 * cfg.param_count() / rules0.model_size  # bf16
    serving_tp_ok = tp_shard_bytes <= 6 * 2**30
    if shape.kind == "train":
        weight_fsdp = train_sharding(cfg) == "fsdp"
    else:
        weight_fsdp = not serving_tp_ok
    rules = Rules(mesh, weight_fsdp=weight_fsdp)
    remat_group = remat_group_for(cfg)
    model = build_model(cfg, remat=(shape.kind == "train"), loss_chunk=loss_chunk,
                        remat_group=remat_group)
    pspecs = rules.param_specs(cfg)
    params_shapes = model.param_shapes()
    B, S = shape.global_batch, shape.seq_len
    b_ax = rules.batch_if(B)
    v_m = rules.model_if(cfg.vocab_size)
    common = dict(name=f"{cfg.name}:{shape.name}", cfg=cfg, shape=shape, rules=rules,
                  param_shapes=params_shapes, param_specs=pspecs, remat_group=remat_group)

    if shape.kind == "train":
        opt_cfg = opt_for(cfg)
        # microbatch so each accumulation slice stays in the HBM budget
        b_dev = max(1, B // rules.batch_size)
        microbatches = max(1, b_dev // microbatch_seqs(cfg))
        state_shapes = train_state_shapes(model, opt_cfg)
        z2 = ((rules.ax.batch, rules.batch_size)
              if train_sharding(cfg) == "zero2" else None)
        state_specs = {
            "params": pspecs,
            "opt": opt_state_specs(opt_cfg.name, pspecs, state_shapes["params"],
                                   zero2=z2),
        }
        bstruct = batch_structs(cfg, B, S, labels=True)
        bspecs = {k: (P(b_ax, None) if v.ndim == 2 else P(b_ax, None, None))
                  for k, v in bstruct.items()}
        fn = _bind_act_rules(
            make_train_step(model, opt_cfg, microbatches=microbatches),
            mesh, cfg, B, weight_fsdp=weight_fsdp,
        )
        metrics_specs = {"loss": P(), "grad_norm": P()}
        return Cell(
            fn=fn,
            args=(state_shapes, bstruct),
            in_specs=(state_specs, bspecs),
            out_specs=(state_specs, metrics_specs),
            donate_argnums=(0,),
            microbatches=microbatches,
            **common,
        )

    if shape.kind == "prefill":
        bstruct = batch_structs(cfg, B, S, labels=False)
        bspecs = {k: (P(b_ax, None) if v.ndim == 2 else P(b_ax, None, None))
                  for k, v in bstruct.items()}
        fn = _bind_act_rules(
            make_prefill_step(model, cache_len=S if not cfg.is_encoder_decoder
                              else dec_len(cfg, S)),
            mesh, cfg, B, weight_fsdp=weight_fsdp,
        )
        cspecs = rules.cache_specs(cfg, batch=B)
        logits_spec = P(b_ax, None, v_m)
        return Cell(
            fn=fn,
            args=(params_shapes, bstruct),
            in_specs=(pspecs, bspecs),
            out_specs=(logits_spec, cspecs),
            donate_argnums=(),
            **common,
        )

    # decode
    cstruct = cache_structs(model, B, S)
    cspecs = rules.cache_specs(cfg, batch=B)
    tokens = st((B,), torch.int32)
    pos = st((), torch.int32)
    last = (dec_len(cfg, S) if cfg.is_encoder_decoder else S) - 1
    fn = _bind_act_rules(_serve_at_last_slot(make_serve_step(model), last), mesh, cfg, B,
                         weight_fsdp=weight_fsdp)
    logits_spec = P(b_ax, v_m)
    return Cell(
        fn=fn,
        args=(params_shapes, cstruct, tokens, pos),
        in_specs=(pspecs, cspecs, P(b_ax), P()),
        out_specs=(logits_spec, cspecs),
        donate_argnums=(1,),
        **common,
    )
