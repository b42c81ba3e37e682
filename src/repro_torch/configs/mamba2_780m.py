"""Mamba2-780m [arXiv:2405.21060; unverified]: attention-free SSD
(state-space duality), ssm_state=128, 48 layers."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=24,       # unused (attention-free); kept for config uniformity
    num_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)
