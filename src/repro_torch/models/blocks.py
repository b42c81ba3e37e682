"""Macro-block plans: group a model's layer stack into a repeating period so
the whole stack lowers as ONE ``lax.scan`` over homogeneous macro-blocks.

Examples
--------
* dense (stablelm, nemo):        period 1, kinds = [attn+mlp]          × L
* gemma2 (alternating local):    period 2, kinds = [attn(local)+mlp,
                                                    attn(global)+mlp]  × L/2
* olmoe / grok (all-MoE):        period 1, kinds = [attn+moe]          × L
* mamba2:                        period 1, kinds = [mamba]             × L
* jamba (attn 1:7, MoE every 2): period 8, kinds per HF config         × L/8

Scanning over macro-blocks keeps compile time O(period) instead of O(L) and
gives XLA one loop body to schedule collectives in — both matter at 46+
layers on a 256-chip mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .config import LayerKind, ModelConfig


@dataclass(frozen=True)
class BlockPlan:
    period: int
    kinds: tuple  # Tuple[LayerKind, ...] of length `period`
    n_repeat: int

    @property
    def num_layers(self) -> int:
        return self.period * self.n_repeat


def build_plan(cfg: ModelConfig) -> BlockPlan:
    L = cfg.num_layers
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        if cfg.local_global_period > 1:
            p = cfg.local_global_period
            kinds = tuple(
                LayerKind(mixer="attn",
                          ffn="moe" if cfg.num_experts else "mlp",
                          is_local=(i % p == 0) and cfg.sliding_window > 0)
                for i in range(p)
            )
        else:
            p = 1
            kinds = (LayerKind(mixer="attn",
                               ffn="moe" if cfg.num_experts else "mlp"),)
        assert L % p == 0, (cfg.name, L, p)
        return BlockPlan(period=p, kinds=kinds, n_repeat=L // p)

    if cfg.family == "ssm":
        return BlockPlan(period=1,
                         kinds=(LayerKind(mixer="mamba", ffn="none"),),
                         n_repeat=L)

    if cfg.family == "hybrid":
        p = cfg.attn_layer_period
        assert p > 0 and L % p == 0, (cfg.name, L, p)
        kinds = []
        for i in range(p):
            mixer = "attn" if i % p == cfg.attn_layer_offset else "mamba"
            if cfg.num_experts and i % cfg.moe_layer_period == cfg.moe_layer_offset:
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append(LayerKind(mixer=mixer, ffn=ffn))
        return BlockPlan(period=p, kinds=tuple(kinds), n_repeat=L // p)

    raise ValueError(f"unknown family {cfg.family!r}")
