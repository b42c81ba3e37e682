"""StableLM-3B [hf:stabilityai/stablelm-2; unverified]: dense, full MHA
(kv=heads), LayerNorm, SwiGLU, untied head."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    hidden_act="silu",
    mlp_gated=True,
    tie_embeddings=False,
)
