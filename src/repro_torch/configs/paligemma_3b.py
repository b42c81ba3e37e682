"""PaliGemma-3B [arXiv:2407.07726]: SigLIP vision frontend STUBBED
(input_specs() provides 256 patch embeddings) + Gemma-2B backbone with
prefix-LM attention over the image tokens."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    hidden_act="gelu",
    mlp_gated=True,
    embed_scale=True,
    frontend="siglip_stub",
    num_prefix_tokens=256,
    tie_embeddings=True,
)
