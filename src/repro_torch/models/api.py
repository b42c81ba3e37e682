"""Public model API of the port: ``Model`` with ``init``, ``param_shapes``,
``forward``, ``logits``, ``loss``, ``init_cache``, ``prefill`` and
``decode_step`` over
nested dicts of tensors, for every family of ``repro.models.api``: dense,
MoE, SSM, the hybrid, the encoder-decoder (whisper; ``prefix_embeds``
carries the frame embeddings of its stubbed audio frontend) and the VLM
prefix-LM (paligemma; ``prefix_embeds`` carries the patch embeddings)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from . import blocks as blocks_mod
from .. import obs
from ..device import DeviceLike, resolve_device
from ..distrib.act import shard
from .config import ModelConfig
from .layers import apply_norm, sinusoidal_positions, softcap
from .transformer import (
    ENC_DEC_KINDS,
    apply_stack,
    chunked_cross_entropy,
    init_params,
    param_shapes,
    torch_dtype,
)

PyTree = Any


@dataclass
class Batch:
    tokens: torch.Tensor                        # (b, s) integer
    labels: Optional[torch.Tensor] = None       # (b, s) for the loss; -1 ignored
    prefix_embeds: Optional[torch.Tensor] = None  # (b, p, D) frames or patches


class Model:
    """``remat`` recomputes each macro-block in the backward, carrying the
    residual stream in float32 (``remat_group`` > 1: groups of blocks, the
    two-level remat); ``loss_chunk`` is the sequence chunk of the loss."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = False, loss_chunk: int = 1024,
                 remat_group: int = 1):
        self.cfg = cfg
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.remat_group = remat_group
        self.plan = blocks_mod.build_plan(cfg)
        self._shapes: Optional[PyTree] = None
        self._pos_tables: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}

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
        with obs.span("model.embed"):
            h = params["embed"]["table"][tokens.long()]
            if self.cfg.embed_scale:
                h = h * torch.full((), math.sqrt(self.cfg.d_model), dtype=h.dtype,
                                   device=h.device)
            return shard(h, "batch", "seq", "embed")

    def _logits_head(self, params, h: torch.Tensor) -> torch.Tensor:
        with obs.span("model.head"):
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

    # -- whisper's encoder and the stacks' inputs -----------------------------

    def _positions(self, seq: int, like: torch.Tensor) -> torch.Tensor:
        """The first ``seq`` rows of ``sinusoidal_positions`` in ``like``'s
        dtype and on its device.  A row does not depend on the table's
        length, so one table per dtype and device, grown to the longest
        length asked, serves every length (decode adds one row a step)."""
        key = (like.dtype, like.device)
        table = self._pos_tables.get(key)
        if table is None or table.shape[0] < seq:
            table = torch.from_numpy(sinusoidal_positions(seq, self.cfg.d_model)).to(
                device=like.device, dtype=like.dtype)
            self._pos_tables[key] = table
        return table[:seq]

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (b, n_frames, D): sinusoidal
        positions, the bidirectional stack, its final norm."""
        cfg = self.cfg
        table = params["embed"]["table"]
        if frames.dtype != table.dtype:
            raise TypeError(f"frame embeddings of {frames.dtype} for a model of "
                            f"{table.dtype}: the port takes them in the model's dtype")
        h = frames + self._positions(frames.shape[1], frames)
        h, _, _ = apply_stack(cfg, ENC_DEC_KINDS, params["enc"]["blocks"], h,
                              positions=torch.arange(h.shape[1], device=h.device),
                              causal=False, remat=self.remat)
        return apply_norm(h, params["enc"]["final_norm"], cfg.norm)

    def _run(self, params, batch: Batch,
             **kw) -> Tuple[torch.Tensor, PyTree, int, torch.Tensor]:
        """The stack over a full sequence, normed; returns (h, caches or
        None, prefix length, the summed MoE aux loss).  The encoder-decoder runs the encoder and the
        decoder over the text with cross-attention; a ``prefix_embeds`` of
        any other family goes, unscaled, before the scaled text embeddings
        and every query sees it (the prefix-LM)."""
        cfg = self.cfg
        h = self._embed(params, batch.tokens)
        prefix = batch.prefix_embeds
        prefix_len = 0
        if cfg.is_encoder_decoder:
            if prefix is None:
                raise ValueError("the encoder-decoder family needs frame embeddings "
                                 "(Batch.prefix_embeds)")
            enc = self._encode(params, prefix)
            h = h + self._positions(h.shape[1], h)
            h, caches, aux = apply_stack(cfg, ENC_DEC_KINDS, params["blocks"], h,
                                         positions=torch.arange(h.shape[1], device=h.device),
                                         cross=True, cross_states=enc, remat=self.remat,
                                         **kw)
        else:
            if prefix is not None:
                prefix_len = prefix.shape[1]
                h = torch.cat([prefix.to(h.dtype), h], dim=1)
            h, caches, aux = apply_stack(cfg, self.plan.kinds, params["blocks"], h,
                                         positions=torch.arange(h.shape[1], device=h.device),
                                         prefix_len=prefix_len, remat=self.remat,
                                         remat_group=self.remat_group, **kw)
        return apply_norm(h, params["final_norm"], cfg.norm), caches, prefix_len, aux

    def forward(self, params, batch: Batch) -> torch.Tensor:
        """Full-sequence final hidden states of the text (b, s, D)."""
        h, _, prefix_len, _ = self._run(params, batch)
        return h[:, prefix_len:]

    def logits(self, params, batch: Batch) -> torch.Tensor:
        return self._logits_head(params, self.forward(params, batch))

    def loss(self, params, batch: Batch, *, aux_weight: float = 0.01) -> torch.Tensor:
        """Mean next-token cross-entropy over ``batch.labels`` (-1 ignored),
        plus ``aux_weight * aux / num_layers`` for MoE configs: JAX's
        ``Model.loss``, with the aux returned by the stack instead of kept
        on the model."""
        if batch.labels is None:
            raise ValueError("the loss needs Batch.labels")
        cfg = self.cfg
        h, _, prefix_len, aux = self._run(params, batch)
        table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["w"]
        ce = chunked_cross_entropy(h[:, prefix_len:], table, batch.labels,
                                   final_softcap=cfg.final_logit_softcap,
                                   chunk=self.loss_chunk,
                                   transpose_head=not cfg.tie_embeddings)
        if cfg.num_experts:
            ce = ce + aux_weight * aux / max(1, cfg.num_layers)
        return ce

    # -- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, dtype=None, enc_len: int = 0, *,
                   device: DeviceLike = None) -> PyTree:
        """Zeroed cache for ``decode_step`` in JAX's layout, one slot per
        position of the macro-block by its mixer (a hybrid plan mixes
        both): an attention position's ``pos{i}/k`` and ``/v`` shaped
        (n_repeat, b, cache_len, nkv, hd) in ``dtype`` (the model's unless
        given), a mamba position's ``pos{i}/conv`` (n_repeat, b, width - 1,
        ch) and ``/ssm`` (n_repeat, b, nh, hd, ds) float32.  The FFN, MoE
        or not, keeps no cache.  The encoder-decoder has one slot over the
        decoder's layers, whose ``ck`` and ``cv`` (.., enc_len, nkv, hd)
        hold the cross-attention's keys and values.  With
        ``device="meta"`` it is the template that carries a JAX cache across
        (``convert.params_from_flat``)."""
        cfg = self.cfg
        if dtype is None:
            dtype = cfg.dtype
        dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
        dev = resolve_device(device)

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        kv = (cfg.num_kv_heads, cfg.head_dim)
        if cfg.is_encoder_decoder:
            n = cfg.num_decoder_layers
            return {"pos0": {"k": zeros(n, batch, cache_len, *kv),
                             "v": zeros(n, batch, cache_len, *kv),
                             "ck": zeros(n, batch, enc_len, *kv),
                             "cv": zeros(n, batch, enc_len, *kv)}}
        n = self.plan.n_repeat
        cache: Dict[str, Any] = {}
        for i, kind in enumerate(self.plan.kinds):
            if kind.mixer == "attn":
                cache[f"pos{i}"] = {"k": zeros(n, batch, cache_len, *kv),
                                    "v": zeros(n, batch, cache_len, *kv)}
            else:
                ch = cfg.d_inner + 2 * cfg.ssm_state
                cache[f"pos{i}"] = {
                    "conv": zeros(n, batch, cfg.ssm_conv - 1, ch),
                    "ssm": zeros(n, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                 dtype=torch.float32),
                }
        return cache

    # -- prefill and decode ----------------------------------------------------

    def prefill(self, params, batch: Batch, cache_len: int) -> Tuple[torch.Tensor, PyTree]:
        """Run the full prompt (a VLM prefix included); returns (last-token
        logits (b, 1, V), cache)."""
        h, caches, _, _ = self._run(params, batch, make_cache=True, cache_len=cache_len)
        return self._logits_head(params, h[:, -1:, :]), caches

    def decode_step(self, params, cache: PyTree, tokens: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, PyTree]:
        """One decode step: tokens (b,), ``pos`` the position they take (an
        int or a one-element integer tensor), ``0 <= pos < cache_len``; a
        VLM prefix counts, so the first text token after a prefill of p
        patches and s tokens takes ``p + s``.  Returns (logits (b, V),
        cache); the cache is updated in place.  The step reads ``pos`` on
        the host: a CUDA tensor costs a sync per step, so a decode loop
        passes an int."""
        cfg = self.cfg
        pos = int(pos)
        h = self._embed(params, tokens[:, None])
        kinds, cross = self.plan.kinds, False
        if cfg.is_encoder_decoder:
            cache_len = cache["pos0"]["k"].shape[2]
            if not 0 <= pos < cache_len:
                raise ValueError(f"decode position {pos} outside the cache of "
                                 f"{cache_len} positions")
            h = h + self._positions(cache_len, h)[pos]
            kinds, cross = ENC_DEC_KINDS, True
        h, cache, _ = apply_stack(cfg, kinds, params["blocks"], h,
                                  positions=torch.arange(1, device=h.device), cache=cache,
                                  decode=True, pos=pos, cross=cross)
        h = apply_norm(h, params["final_norm"], cfg.norm)
        return self._logits_head(params, h)[:, 0, :], cache


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
