"""Architecture config registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``reduced(cfg)`` derives the same-family small config used by CPU smoke
tests (full configs are exercised only via the dry-run's ShapeDtypeStructs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

# the paper's own workload family lives in faas_bench.py (not an assigned
# arch; used by benchmarks/)
ARCHS: List[str] = [
    "gemma2_27b",
    "stablelm_3b",
    "gemma_2b",
    "mistral_nemo_12b",
    "olmoe_1b_7b",
    "grok_1_314b",
    "whisper_small",
    "paligemma_3b",
    "jamba_v01_52b",
    "mamba2_780m",
]

# CLI ids (--arch) use dashes, matching the assignment text.
ALIASES: Dict[str, str] = {
    "gemma2-27b": "gemma2_27b",
    "stablelm-3b": "stablelm_3b",
    "gemma-2b": "gemma_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "grok-1-314b": "grok_1_314b",
    "whisper-small": "whisper_small",
    "paligemma-3b": "paligemma_3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "jamba-v01-52b": "jamba_v01_52b",
    "mamba2-780m": "mamba2_780m",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCHS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, small: used for CPU smoke tests and serving benches."""
    from repro_torch.models.blocks import build_plan

    period = build_plan(cfg).period
    heads = 4
    kv = 1 if cfg.num_kv_heads == 1 else (2 if cfg.num_kv_heads < cfg.num_heads else heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=period * 2,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2) if cfg.num_experts else 0,
        moe_d_ff=128 if cfg.num_experts else 0,
        capacity_factor=8.0,  # drop-free at smoke scale → decode == forward
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32,
        ssm_chunk=32,
        sliding_window=32 if cfg.sliding_window else 0,
        num_decoder_layers=2 if cfg.is_encoder_decoder else 0,
        num_prefix_tokens=8 if cfg.num_prefix_tokens else 0,
        query_scale=None,
        dtype="float32",
    )
