"""Public model API of the port: ``Model`` with ``init``, ``param_shapes``,
``forward``, ``logits``, ``init_cache``, ``prefill`` and ``decode_step`` over
nested dicts of tensors (the decoder-only paths of ``repro.models.api``:
dense, MoE, SSM and the hybrid; the encoder-decoder and the VLM prefix
raise)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from . import blocks as blocks_mod
from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import apply_norm, softcap
from .transformer import (
    _check_supported,
    apply_stack,
    init_params,
    param_shapes,
    torch_dtype,
    unsupported,
)

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

    def _check_family(self) -> None:
        """Raise, naming the ROADMAP item, for a family not ported yet."""
        _check_supported(self.cfg)

    def _check_batch(self, batch: Batch) -> None:
        self._check_family()
        if batch.prefix_embeds is not None:
            raise unsupported("the VLM prefix", "enc-dec / VLM / gemma-2 slice")

    def forward(self, params, batch: Batch) -> torch.Tensor:
        """Full-sequence final hidden states (b, s, D)."""
        self._check_batch(batch)
        h = self._embed(params, batch.tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, _ = apply_stack(self.cfg, self.plan.kinds, params["blocks"], h,
                           positions=positions)
        return apply_norm(h, params["final_norm"], self.cfg.norm)

    def logits(self, params, batch: Batch) -> torch.Tensor:
        return self._logits_head(params, self.forward(params, batch))

    # -- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, dtype=None, *,
                   device: DeviceLike = None) -> PyTree:
        """Zeroed cache for ``decode_step`` in JAX's layout, one slot per
        position of the macro-block by its mixer (a hybrid plan mixes
        both): an attention position's ``pos{i}/k`` and ``/v`` shaped
        (n_repeat, b, cache_len, nkv, hd) in ``dtype`` (the model's unless
        given), a mamba position's ``pos{i}/conv`` (n_repeat, b, width - 1,
        ch) and ``/ssm`` (n_repeat, b, nh, hd, ds) float32.  The FFN, MoE
        or not, keeps no cache.  With
        ``device="meta"`` it is the template that carries a JAX cache across
        (``convert.params_from_flat``)."""
        cfg = self.cfg
        self._check_family()
        if dtype is None:
            dtype = cfg.dtype
        dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
        dev = torch.device("meta") if device == "meta" else resolve_device(device)
        n = self.plan.n_repeat
        cache: Dict[str, Any] = {}
        for i, kind in enumerate(self.plan.kinds):
            if kind.mixer == "attn":
                shape = (n, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
                cache[f"pos{i}"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                                    "v": torch.zeros(shape, dtype=dt, device=dev)}
            else:
                ch = cfg.d_inner + 2 * cfg.ssm_state
                cache[f"pos{i}"] = {
                    "conv": torch.zeros((n, batch, cfg.ssm_conv - 1, ch), dtype=dt, device=dev),
                    "ssm": torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                        cfg.ssm_state), dtype=torch.float32, device=dev),
                }
        return cache

    # -- prefill and decode ----------------------------------------------------

    def prefill(self, params, batch: Batch, cache_len: int) -> Tuple[torch.Tensor, PyTree]:
        """Run the full prompt; returns (last-token logits (b, 1, V), cache)."""
        self._check_batch(batch)
        h = self._embed(params, batch.tokens)
        h, caches = apply_stack(self.cfg, self.plan.kinds, params["blocks"], h,
                                positions=torch.arange(h.shape[1], device=h.device),
                                make_cache=True, cache_len=cache_len)
        h = apply_norm(h, params["final_norm"], self.cfg.norm)
        return self._logits_head(params, h[:, -1:, :]), caches

    def decode_step(self, params, cache: PyTree, tokens: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, PyTree]:
        """One decode step: tokens (b,), ``pos`` the position they take (an
        int or a one-element integer tensor), ``0 <= pos < cache_len``.
        Returns (logits (b, V), cache); the cache is updated in place.  The
        step reads ``pos`` on the host: a CUDA tensor costs a sync per step,
        so a decode loop passes an int."""
        self._check_family()
        h = self._embed(params, tokens[:, None])
        h, cache = apply_stack(self.cfg, self.plan.kinds, params["blocks"], h,
                               positions=torch.arange(1, device=h.device), cache=cache,
                               decode=True, pos=int(pos))
        h = apply_norm(h, params["final_norm"], self.cfg.norm)
        return self._logits_head(params, h)[:, 0, :], cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
