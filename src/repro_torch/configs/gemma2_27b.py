"""Gemma-2 27B [arXiv:2408.00118]: local+global alternating attention,
logit soft-capping, GeGLU, tied embeddings, RMSNorm."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    hidden_act="gelu",
    mlp_gated=True,
    embed_scale=True,
    sliding_window=4096,
    local_global_period=2,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d_model/heads
    tie_embeddings=True,
)
