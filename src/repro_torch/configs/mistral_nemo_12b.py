"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407]: dense GQA kv=8,
head_dim=128, 128k context (large rope theta), untied head."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    hidden_act="silu",
    mlp_gated=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
