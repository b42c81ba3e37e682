"""Gemma 2B [arXiv:2403.08295]: MQA (kv=1), head_dim=256, GeGLU,
scaled tied embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    hidden_act="gelu",
    mlp_gated=True,
    embed_scale=True,
    tie_embeddings=True,
)
