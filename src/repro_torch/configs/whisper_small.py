"""Whisper-small [arXiv:2212.04356; unverified]: 12L enc + 12L dec,
LayerNorm, GELU (non-gated), conv frontend STUBBED — input_specs()
provides precomputed frame embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    num_decoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    hidden_act="gelu",
    mlp_gated=False,
    use_rope=False,
    is_encoder_decoder=True,
    frontend="audio_stub",
    tie_embeddings=True,
)
