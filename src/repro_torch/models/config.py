"""Model configuration covering every assigned architecture family."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads

    # norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    hidden_act: str = "silu"       # silu | gelu
    mlp_gated: bool = True         # SwiGLU / GeGLU
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)

    # attention
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0        # window for "local" layers (gemma2: 4096)
    local_global_period: int = 0   # gemma2: 2 → layer i local iff i % 2 == 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0              # expert hidden size (defaults to d_ff)
    moe_layer_period: int = 1      # jamba: 2
    moe_layer_offset: int = 0      # jamba: 1
    capacity_factor: float = 1.25
    moe_int8_gather: bool = False  # int8-on-the-wire FSDP expert gathers

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_layer_period: int = 0     # jamba: 8 → one attn layer per 8
    attn_layer_offset: int = 0     # jamba: 4

    # embeddings / heads
    tie_embeddings: bool = True

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0

    # multimodal frontends are STUBS per the assignment: input_specs() carries
    # precomputed frame/patch embeddings.
    frontend: Optional[str] = None  # siglip_stub | audio_stub
    num_prefix_tokens: int = 0      # vlm: image patch tokens per example

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived ----------------------------------------------------------

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        from . import blocks as _blocks  # late import, avoids cycle

        plan = _blocks.build_plan(self)
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model  # final norm
        for kind in plan.kinds * plan.n_repeat:
            n += _layer_params(self, kind)
        if self.is_encoder_decoder:
            D = self.d_model
            H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
            enc_layer = 2 * D + (H + 2 * KV) * hd * D + H * hd * D + _mlp_params(self, False)
            n += self.num_layers * enc_layer + D
            n += self.num_decoder_layers * ((H + 2 * KV) * hd * D + H * hd * D + 3 * D)  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        from . import blocks as _blocks

        plan = _blocks.build_plan(self)
        total = self.param_count()
        per_expert = _expert_params(self)
        for kind in plan.kinds * plan.n_repeat:
            if kind.ffn == "moe":
                total -= (self.num_experts - self.num_experts_per_tok) * per_expert
        return total


@dataclass(frozen=True)
class LayerKind:
    mixer: str         # "attn" | "mamba"
    ffn: str           # "mlp" | "moe" | "none"
    is_local: bool = False  # sliding-window attention layer


def _mlp_params(cfg: ModelConfig, moe: bool) -> int:
    ff = cfg.moe_d_ff if moe else cfg.d_ff
    k = 3 if cfg.mlp_gated else 2
    return k * cfg.d_model * ff


def _expert_params(cfg: ModelConfig) -> int:
    return _mlp_params(cfg, True)


def _layer_params(cfg: ModelConfig, kind: LayerKind) -> int:
    D = cfg.d_model
    n = 2 * D  # two norms
    if kind.mixer == "attn":
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n += (H + 2 * KV) * hd * D + H * hd * D
    else:
        d_in, S, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        # in_proj: D -> 2*d_in + 2*ngroups*S + nh  (z, x, B, C, dt)
        n += D * (2 * d_in + 2 * S + nh)
        n += cfg.ssm_conv * (d_in + 2 * S)  # conv over x,B,C
        n += nh * 2 + d_in  # A_log, D, gated-norm scale
        n += d_in * D  # out_proj
    if kind.ffn == "mlp":
        n += _mlp_params(cfg, False)
    elif kind.ffn == "moe":
        n += cfg.num_experts * _expert_params(cfg) + D * cfg.num_experts  # + router
    return n


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch pairs with this shape set.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def long_context_ok(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic families (SSM / hybrid)."""
    return cfg.family in ("ssm", "hybrid")


def cells_for(cfg: ModelConfig) -> List[str]:
    """The (arch × shape) cells that are well-defined for this arch."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if long_context_ok(cfg):
        names.append("long_500k")
    return names
