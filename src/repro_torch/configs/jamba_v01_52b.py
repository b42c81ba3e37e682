"""Jamba-v0.1 52B [arXiv:2403.19887]: hybrid Mamba+attention 1:7
interleave (attn period 8 offset 4), 16-expert top-2 MoE on every other
layer.  The Mamba-1 mixer is realized through the SSD formulation (see
DESIGN.md §6 hardware-adaptation notes)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    hidden_act="silu",
    mlp_gated=True,
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_period=8,
    attn_layer_offset=4,
    tie_embeddings=False,
)
