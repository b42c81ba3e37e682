"""The dense decoder-only LM as tensor functions over a nested dict of
parameters.

Port of the dense path of ``repro.models.transformer``: ``init_layer``
(attention + MLP), ``init_params``, the full-sequence ``apply_layer`` and
``apply_stack`` as a loop over the leading ``n_repeat`` axis of the
stacked macro-block parameters.  Parameter paths, shapes and dtypes are the
JAX package's exactly (``blocks/pos{i}/...`` stacked over ``n_repeat``), so
both packages' snapshots share chunk digests.

The models are functional on purpose: the serving worker hands a different
restored tree (zero-copy pool shares plus patched leaves) to every
invocation.  The other families are later slices of the port and raise
:class:`NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from . import blocks as blocks_mod
from ..kernels.flash_attention import flash_attention_op
from .config import LayerKind, ModelConfig
from .layers import apply_norm, apply_rope, mlp

PyTree = Any

#: make(shape, dtype, fill) -> tensor; fill is "normal", "zeros" or "ones"
Maker = Callable[[tuple, torch.dtype, str], torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def unsupported(what: str, roadmap: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md: {roadmap})")


def _check_supported(cfg: ModelConfig, kind: LayerKind) -> None:
    if cfg.is_encoder_decoder:
        raise unsupported("encoder-decoder (whisper)", "enc-dec / VLM / gemma-2 slice")
    if kind.mixer != "attn":
        raise unsupported("the mamba mixer", "SSM slice with ssd_scan")
    if kind.ffn == "moe":
        raise unsupported("the MoE FFN", "MoE slice")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _norm_param(cfg: ModelConfig, make: Maker) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": make((D,), torch.float32, "zeros")}
    return {"scale": make((D,), torch.float32, "ones"),
            "bias": make((D,), torch.float32, "zeros")}


def init_layer(cfg: ModelConfig, kind: LayerKind, make: Maker) -> PyTree:
    _check_supported(cfg, kind)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    p: Dict[str, Any] = {"ln1": _norm_param(cfg, make)}
    p["wq"] = make((D, H, hd), dt, "normal")
    p["wk"] = make((D, KV, hd), dt, "normal")
    p["wv"] = make((D, KV, hd), dt, "normal")
    p["wo"] = make((H, hd, D), dt, "normal")
    if kind.ffn != "none":
        F = cfg.d_ff
        p["ln2"] = _norm_param(cfg, make)
        p["ffn"] = {"w_in": make((D, F), dt, "normal"),
                    "w_out": make((F, D), dt, "normal")}
        if cfg.mlp_gated:
            p["ffn"]["w_gate"] = make((D, F), dt, "normal")
    return p


def _stack(trees) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def build_params(cfg: ModelConfig, make: Maker) -> PyTree:
    plan = blocks_mod.build_plan(cfg)
    for kind in plan.kinds:
        _check_supported(cfg, kind)
    dt = torch_dtype(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": {"table": make((cfg.vocab_size, cfg.d_model), dt, "normal")},
        "final_norm": _norm_param(cfg, make),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": make((cfg.d_model, cfg.vocab_size), dt, "normal")}
    params["blocks"] = {
        f"pos{i}": _stack([init_layer(cfg, kind, make) for _ in range(plan.n_repeat)])
        for i, kind in enumerate(plan.kinds)
    }
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: torch.device = torch.device("cpu")) -> PyTree:
    """Random weights (normal · 0.02, norms at identity) from a seeded
    ``torch.Generator`` on ``device``.  They do not reproduce
    ``jax.random``'s numbers; carry JAX weights with ``convert``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype, fill):
        if fill == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if fill == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * 0.02).to(dtype)

    return build_params(cfg, make)


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (the counterpart of ``jax.eval_shape`` over ``init``)."""
    return build_params(
        cfg, lambda shape, dtype, fill: torch.empty(shape, dtype=dtype, device="meta"))


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else 1.0 / float(np.sqrt(cfg.head_dim)))


def apply_layer(cfg: ModelConfig, kind: LayerKind, p: PyTree, h: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """One full-sequence layer (no cache)."""
    _check_supported(cfg, kind)
    # the residual stream h may be f32 (carry precision); compute in cfg dtype
    cdt = torch_dtype(cfg.dtype) if h.dtype == torch.float32 else h.dtype
    x = apply_norm(h, p["ln1"], cfg.norm).to(cdt)
    window = cfg.sliding_window if kind.is_local else 0
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dgk->blgk", x, p["wk"])
    v = torch.einsum("bld,dgk->blgk", x, p["wv"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    attn = flash_attention_op(q, k, v, scale=_scale(cfg), causal=causal,
                              window=window, softcap=cfg.attn_logit_softcap)
    h = h + torch.einsum("blhk,hkd->bld", attn, p["wo"])
    if kind.ffn != "none":
        x2 = apply_norm(h, p["ln2"], cfg.norm).to(cdt)
        h = h + mlp(p["ffn"], x2, cfg.hidden_act, cfg.mlp_gated)
    return h


def _index(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def apply_stack(cfg: ModelConfig, kinds, blocks_params: PyTree, h: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Loop over the stacked macro-blocks (the JAX ``lax.scan``)."""
    n_repeat = blocks_params["pos0"]["wq"].shape[0]
    for r in range(n_repeat):
        bp = _index(blocks_params, r)
        for i, kind in enumerate(kinds):
            h = apply_layer(cfg, kind, bp[f"pos{i}"], h, positions=positions,
                            causal=causal)
    return h
