"""Grok-1 314B [hf:xai-org/grok-1; unverified]: 8-expert top-2 MoE every
layer, GQA kv=8."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    hidden_act="gelu",
    mlp_gated=True,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=32768,
    tie_embeddings=False,
    # 1.57 TB of expert weights re-gathered every microbatch dominate the
    # step's collectives: gather int8-quantized (§Perf cell B).
    moe_int8_gather=True,
)
