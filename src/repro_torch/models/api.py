"""Public model API of the port: ``Model`` with ``init``, ``param_shapes``,
``forward`` and ``logits`` over a nested dict of tensors (the dense
full-sequence path of ``repro.models.api``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from . import blocks as blocks_mod
from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import apply_norm, softcap
from .transformer import apply_stack, init_params, param_shapes, unsupported

PyTree = Any


@dataclass
class Batch:
    tokens: torch.Tensor                        # (b, s) integer
    labels: Optional[torch.Tensor] = None       # training: a later slice
    prefix_embeds: Optional[torch.Tensor] = None  # VLM prefix: a later slice


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan = blocks_mod.build_plan(cfg)
        self._shapes: Optional[PyTree] = None

    # -- parameters ---------------------------------------------------------

    def init(self, seed: int = 0, *, device: DeviceLike = None) -> PyTree:
        """Random weights on ``device`` (the GPU unless ``"cpu"`` is asked)."""
        return init_params(self.cfg, seed, device=resolve_device(device))

    def param_shapes(self) -> PyTree:
        """Shape/dtype template (``meta`` tensors); built once per model."""
        if self._shapes is None:
            self._shapes = param_shapes(self.cfg)
        return self._shapes

    # -- forward ------------------------------------------------------------

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        h = params["embed"]["table"][tokens.long()]
        if self.cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=h.dtype,
                                 device=h.device)
        return h

    def _logits_head(self, params, h: torch.Tensor) -> torch.Tensor:
        W = (params["embed"]["table"] if self.cfg.tie_embeddings
             else params["lm_head"]["w"])
        h = h.to(W.dtype)  # residual stream may be f32
        # float32 logits from any weight dtype: the products of bf16 values
        # are exact in float32, so this is JAX's preferred_element_type=f32
        if self.cfg.tie_embeddings:
            logits = h.float() @ W.float().t()
        else:
            logits = h.float() @ W.float()
        return softcap(logits, self.cfg.final_logit_softcap)

    def forward(self, params, batch: Batch) -> torch.Tensor:
        """Full-sequence final hidden states (b, s, D)."""
        if self.cfg.is_encoder_decoder:
            raise unsupported("encoder-decoder (whisper)", "enc-dec / VLM / gemma-2 slice")
        if batch.prefix_embeds is not None:
            raise unsupported("the VLM prefix", "enc-dec / VLM / gemma-2 slice")
        h = self._embed(params, batch.tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h = apply_stack(self.cfg, self.plan.kinds, params["blocks"], h,
                        positions=positions)
        return apply_norm(h, params["final_norm"], self.cfg.norm)

    def logits(self, params, batch: Batch) -> torch.Tensor:
        return self._logits_head(params, self.forward(params, batch))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
