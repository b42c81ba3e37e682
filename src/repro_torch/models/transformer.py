"""The LM backbones (dense, MoE, SSM, hybrid, encoder-decoder and the VLM
prefix-LM) as tensor functions over a nested dict of parameters.

Port of ``repro.models.transformer``: ``init_layer`` (attention or the
mamba mixer, whisper's cross-attention block, then an MLP, the MoE FFN or
none), ``init_params``, ``apply_layer`` (full sequence, prefill with
``make_cache``, one decode token with ``decode``) and ``apply_stack`` as a
loop over the leading ``n_repeat`` axis of the stacked macro-block
parameters and caches.  Parameter paths, shapes and dtypes are the JAX
package's exactly (``blocks/pos{i}/...`` stacked over ``n_repeat``; for
the encoder-decoder also ``enc/blocks`` and ``enc/final_norm``), so both
packages' snapshots share chunk digests.

The models are functional on purpose: the serving worker hands a different
restored tree (zero-copy pool shares plus patched leaves) to every
invocation.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn.functional import pad as _pad
from torch.utils.checkpoint import checkpoint

from . import blocks as blocks_mod
from .. import obs
from ..kernels.flash_attention import flash_attention_op
from .attention import decode_attention
from .config import LayerKind, ModelConfig
from ..distrib.act import current_binding, shard
from .layers import apply_norm, apply_rope, mlp, softcap
from .moe import bound_route, moe_ffn, moe_ffn_sharded
from .ssm import mamba_mixer

PyTree = Any

#: make(shape, dtype, fill[, scale]) -> tensor; fill is "normal" (× scale,
#: 0.02 unless given), "zeros", "ones" or "log_arange" (log(1..n), 1-D)
Maker = Callable[..., torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the layer of whisper's encoder and decoder stacks (the decoder's with the
#: cross-attention block)
ENC_DEC_KINDS = (LayerKind("attn", "mlp"),)


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def unsupported(what: str, roadmap: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md: {roadmap})")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _norm_param(cfg: ModelConfig, make: Maker) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": make((D,), torch.float32, "zeros")}
    return {"scale": make((D,), torch.float32, "ones"),
            "bias": make((D,), torch.float32, "zeros")}


def init_layer(cfg: ModelConfig, kind: LayerKind, make: Maker, *,
               cross: bool = False) -> PyTree:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    p: Dict[str, Any] = {"ln1": _norm_param(cfg, make)}
    f32 = torch.float32
    if kind.mixer == "attn":
        p["wq"] = make((D, H, hd), dt, "normal")
        p["wk"] = make((D, KV, hd), dt, "normal")
        p["wv"] = make((D, KV, hd), dt, "normal")
        p["wo"] = make((H, hd, D), dt, "normal")
    else:
        d_in, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        p["w_z"] = make((D, d_in), dt, "normal")
        p["w_xBC"] = make((D, d_in + 2 * ds), dt, "normal")
        p["w_dt"] = make((D, nh), dt, "normal")
        p["dt_bias"] = make((nh,), f32, "zeros")
        p["conv_w"] = make((cfg.ssm_conv, d_in + 2 * ds), f32, "normal", 0.1)
        p["conv_b"] = make((d_in + 2 * ds,), f32, "zeros")
        p["A_log"] = make((nh,), f32, "log_arange")
        p["D"] = make((nh,), f32, "ones")
        p["gate_norm"] = make((d_in,), f32, "zeros")
        p["w_out"] = make((d_in, D), dt, "normal")
    if cross:  # whisper's decoder: attention over the encoder's states
        p["ln_cross"] = _norm_param(cfg, make)
        p["cq"] = make((D, H, hd), dt, "normal")
        p["ck"] = make((D, KV, hd), dt, "normal")
        p["cv"] = make((D, KV, hd), dt, "normal")
        p["co"] = make((H, hd, D), dt, "normal")
    if kind.ffn != "none":
        p["ln2"] = _norm_param(cfg, make)
        if kind.ffn == "moe":  # stacked over the experts; the router float32, as in JAX
            E, F = (cfg.num_experts,), cfg.moe_d_ff
            p["ffn"] = {"router": make((D, cfg.num_experts), f32, "normal")}
        else:
            E, F = (), cfg.d_ff
            p["ffn"] = {}
        p["ffn"]["w_in"] = make(E + (D, F), dt, "normal")
        p["ffn"]["w_out"] = make(E + (F, D), dt, "normal")
        if cfg.mlp_gated:
            p["ffn"]["w_gate"] = make(E + (D, F), dt, "normal")
    return p


def _stack(trees) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:  # no copy: a cut-down model at full width fills the card
        return trees[0].unsqueeze(0)
    return torch.stack(trees)


def _stack_layers(cfg: ModelConfig, kinds, n_repeat: int, make: Maker, *,
                  cross: bool = False) -> PyTree:
    return {f"pos{i}": _stack([init_layer(cfg, kind, make, cross=cross)
                               for _ in range(n_repeat)])
            for i, kind in enumerate(kinds)}


def build_params(cfg: ModelConfig, make: Maker) -> PyTree:
    plan = blocks_mod.build_plan(cfg)
    dt = torch_dtype(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": {"table": make((cfg.vocab_size, cfg.d_model), dt, "normal")},
        "final_norm": _norm_param(cfg, make),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": make((cfg.d_model, cfg.vocab_size), dt, "normal")}
    if cfg.is_encoder_decoder:
        params["enc"] = {"blocks": _stack_layers(cfg, ENC_DEC_KINDS, cfg.num_layers, make),
                         "final_norm": _norm_param(cfg, make)}
        params["blocks"] = _stack_layers(cfg, ENC_DEC_KINDS, cfg.num_decoder_layers, make,
                                         cross=True)
    else:
        params["blocks"] = _stack_layers(cfg, plan.kinds, plan.n_repeat, make)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: torch.device = torch.device("cpu")) -> PyTree:
    """Random weights (normal · 0.02, the SSM conv · 0.1, norms at identity,
    the SSM's A_log, D and dt_bias as JAX sets them) from a seeded
    ``torch.Generator`` on ``device``.  They do not reproduce
    ``jax.random``'s numbers; carry JAX weights with ``convert``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype, fill, scale=0.02):
        if fill == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if fill == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if fill == "log_arange":
            return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                          device=device)).to(dtype)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * scale).to(dtype)

    return build_params(cfg, make)


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (the counterpart of ``jax.eval_shape`` over ``init``)."""
    return build_params(
        cfg, lambda shape, dtype, *fill: torch.empty(shape, dtype=dtype, device="meta"))


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else 1.0 / float(np.sqrt(cfg.head_dim)))


def _attend_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor, cache: PyTree,
                   pos: int, window: int) -> torch.Tensor:
    """One token's attention: q, k, v rotated at ``pos``, k and v written
    into the cache slice at ``pos`` in place, then attention over it."""
    S = cache["k"].shape[1]
    if not 0 <= pos < S:
        # JAX's dynamic_update_slice would clamp the write to the last slot
        raise ValueError(f"decode position {pos} outside the cache of {S} positions")
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dgk->blgk", x, p["wk"])
    v = torch.einsum("bld,dgk->blgk", x, p["wv"])
    if cfg.use_rope:
        posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    k_cache = shard(cache["k"], "batch", None, "kv_heads", "cache_hd")
    v_cache = shard(cache["v"], "batch", None, "kv_heads", "cache_hd")
    return decode_attention(q, k_cache, v_cache, pos, scale=_scale(cfg),
                            window=window, logit_softcap=cfg.attn_logit_softcap)


def apply_layer(cfg: ModelConfig, kind: LayerKind, p: PyTree, h: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True, prefix_len: int = 0,
                cross: bool = False, cross_states: Optional[torch.Tensor] = None,
                cache: Optional[PyTree] = None, decode: bool = False,
                pos: Optional[int] = None, make_cache: bool = False,
                cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    """One layer; returns (h, new cache or None, MoE aux loss: a float32
    scalar, 0 without a MoE FFN).

    ``decode`` runs one token at ``pos`` against ``cache`` (this layer's
    slice), which it updates in place and returns.  ``make_cache`` returns
    the layer's new cache from a full sequence: the rotated k and v padded
    to ``cache_len``, or the mamba mixer's conv and SSM state.  Under
    ``causal`` the first ``prefix_len`` positions are seen by every query
    (the VLM prefix-LM).  ``cross`` adds the cross-attention block after
    the mixer: over ``cross_states`` (the encoder's output) in a full
    sequence, whose k and v ``make_cache`` keeps unpadded as ``ck`` and
    ``cv``; over the cached ``ck`` and ``cv`` in ``decode`` (JAX passes a
    sentinel ``cross_states`` there instead of the flag)."""
    new_cache = None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # the residual stream h may be f32 (carry precision); compute in cfg dtype
    cdt = torch_dtype(cfg.dtype) if h.dtype == torch.float32 else h.dtype
    x = apply_norm(h, p["ln1"], cfg.norm).to(cdt)
    if kind.mixer == "attn":
        window = cfg.sliding_window if kind.is_local else 0
        if decode:
            attn = _attend_decode(cfg, p, x, cache, pos, window)
            new_cache = cache
        else:
            wq = shard(p["wq"], None, "heads", None)
            wk = shard(p["wk"], None, "kv_heads", None)
            wv = shard(p["wv"], None, "kv_heads", None)
            q = shard(torch.einsum("bld,dhk->blhk", x, wq),
                      "batch", "seq", "heads", "head_dim")
            k = shard(torch.einsum("bld,dgk->blgk", x, wk),
                      "batch", "seq", "kv_heads", "head_dim")
            v = shard(torch.einsum("bld,dgk->blgk", x, wv),
                      "batch", "seq", "kv_heads", "head_dim")
            if cfg.use_rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            attn = shard(flash_attention_op(q, k, v, scale=_scale(cfg), causal=causal,
                                            window=window, softcap=cfg.attn_logit_softcap,
                                            prefix_len=prefix_len),
                         "batch", "seq", "heads", "head_dim")
            if make_cache:
                pad = cache_len - k.shape[1]
                if pad < 0:
                    raise ValueError(f"a prompt of {k.shape[1]} tokens does not fit a "
                                     f"cache of {cache_len}")
                new_cache = {"k": _pad(k, (0, 0, 0, 0, 0, pad)),
                             "v": _pad(v, (0, 0, 0, 0, 0, pad))}
        wo = shard(p["wo"], "heads", None, None)
        h = h + shard(torch.einsum("blhk,hkd->bld", attn, wo), "batch", "seq", "embed")
    else:  # mamba
        out, mcache = mamba_mixer(p, x, cfg, cache=cache, decode=decode)
        h = h + shard(out, "batch", "seq", "embed")
        if decode:
            for leaf in ("conv", "ssm"):
                cache[leaf].copy_(mcache[leaf])
            new_cache = cache
        elif make_cache:
            new_cache = mcache
    if cross:
        xc = apply_norm(h, p["ln_cross"], cfg.norm).to(cdt)
        q = torch.einsum("bld,dhk->blhk", xc, p["cq"])
        if decode:  # every encoder position: pos = enc_len - 1
            ck, cv = cache["ck"], cache["cv"]
            attn = decode_attention(q, ck, cv, ck.shape[1] - 1, scale=_scale(cfg))
        else:
            # under remat the encoder's output is float32: as JAX promotes,
            # its keys and values are float32 and so is the attention, whose
            # output takes q's dtype (no cast where the dtypes agree)
            kv_dt = cross_states.dtype
            ck = torch.einsum("bld,dgk->blgk", cross_states, p["ck"].to(kv_dt))
            cv = torch.einsum("bld,dgk->blgk", cross_states, p["cv"].to(kv_dt))
            attn = flash_attention_op(q.to(kv_dt), ck, cv, scale=_scale(cfg),
                                      causal=False).to(q.dtype)
            if make_cache:
                new_cache.update(ck=ck, cv=cv)
        h = h + torch.einsum("blhk,hkd->bld", attn, p["co"])
    if kind.ffn != "none":
        x2 = apply_norm(h, p["ln2"], cfg.norm).to(cdt)
        if kind.ffn == "moe":
            # decode: a handful of tokens, so the drop-free capacity E / K,
            # and decode agrees with the teacher-forced forward; the forward
            # and prefill keep the config's (they may drop), as in JAX.  The
            # aux loss goes to training's loss, summed over the layers.
            # Under a logical-axis binding the experts run across the ranks,
            # or by the form ``moe.routed`` binds.
            cf = float(cfg.num_experts) / cfg.num_experts_per_tok if decode else None
            impl = moe_ffn
            if current_binding() is not None:
                impl = bound_route() or moe_ffn_sharded
            y, aux = impl(p["ffn"], x2, cfg, capacity_factor=cf)
        else:
            y = mlp(p["ffn"], x2, cfg.hidden_act, cfg.mlp_gated)
        h = h + y
    return h, new_cache, aux


def _first_leaf(tree: PyTree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def apply_stack(cfg: ModelConfig, kinds, blocks_params: PyTree, h: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True, prefix_len: int = 0,
                cross: bool = False, cross_states: Optional[torch.Tensor] = None,
                cache: Optional[PyTree] = None, decode: bool = False,
                pos: Optional[int] = None, make_cache: bool = False,
                cache_len: int = 0, remat: bool = False, remat_group: int = 1
                ) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    """Loop over the stacked macro-blocks (the JAX ``lax.scan``); returns
    (h, caches or None, the summed MoE aux loss).

    The cache's leaves carry the leading ``n_repeat`` axis, as the scan
    stacks them.  ``decode`` updates ``cache`` in place, one layer slice at
    a time, and returns it.  ``make_cache`` fills a new cache, one layer
    slice at a time.

    ``remat`` carries the residual stream in float32 and, over a full
    sequence, recomputes each macro-block in the backward
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the scan body);
    ``remat_group > 1`` (dividing ``n_repeat``) checkpoints groups of that
    many checkpointed blocks, JAX's two-level remat.  The blocks draw no
    random numbers, so the checkpoints keep no RNG state."""
    n_repeat = _first_leaf(blocks_params).shape[0]
    caches: Dict[str, Any] = {}

    def block(r: int, hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        bp = _index(blocks_params, r)
        aux = torch.zeros((), dtype=torch.float32, device=hh.device)
        for i, kind in enumerate(kinds):
            c_i = _index(cache[f"pos{i}"], r) if decode else None
            with obs.span("model.layer", layer=r * len(kinds) + i):
                hh, nc, a = apply_layer(cfg, kind, bp[f"pos{i}"], hh, positions=positions,
                                        causal=causal, prefix_len=prefix_len, cross=cross,
                                        cross_states=cross_states, cache=c_i, decode=decode,
                                        pos=pos, make_cache=make_cache, cache_len=cache_len)
            aux = aux + a
            if make_cache and nc is not None:
                slot = caches.setdefault(f"pos{i}", {})
                for leaf, t in nc.items():
                    if leaf not in slot:
                        slot[leaf] = t.new_empty((n_repeat,) + tuple(t.shape))
                    slot[leaf][r] = t
        return hh, aux

    if remat:
        # f32 residual stream: what the checkpoints keep between blocks
        h = h.float()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    recompute = remat and not (decode or make_cache) and torch.is_grad_enabled()
    if recompute and remat_group > 1 and n_repeat % remat_group == 0:
        def group(g: int, hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            a = torch.zeros((), dtype=torch.float32, device=hh.device)
            for r in range(g * remat_group, (g + 1) * remat_group):
                hh, a_r = checkpoint(block, r, hh, use_reentrant=False, preserve_rng_state=False)
                a = a + a_r
            return hh, a

        for g in range(n_repeat // remat_group):
            h, a = checkpoint(group, g, h, use_reentrant=False, preserve_rng_state=False)
            aux = aux + a
        return h, None, aux
    for r in range(n_repeat):
        if recompute:
            h, a = checkpoint(block, r, h, use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = block(r, h)
        aux = aux + a
    if decode:
        return h, cache, aux
    return h, (caches or None), aux


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _ce_chunk(hc: torch.Tensor, lc: torch.Tensor, W: torch.Tensor,
              final_softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed NLL and count of valid labels of one chunk; float32 logits
    from any weight dtype (the products of bf16 values are exact in
    float32: JAX's preferred_element_type=f32)."""
    logits = hc.to(W.dtype).float() @ W.float()
    if final_softcap > 0.0:
        logits = softcap(logits, final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_cross_entropy(h: torch.Tensor, embed_table: torch.Tensor,
                          labels: torch.Tensor, *, final_softcap: float = 0.0,
                          chunk: int = 1024, transpose_head: bool = False) -> torch.Tensor:
    """Mean cross-entropy over labels >= 0 (-1 is ignored) without keeping
    the (b, s, V) logits: chunks of the sequence, each under
    ``torch.utils.checkpoint`` when gradients are wanted, so that one
    chunk's (b, chunk, V) float32 logits are live at a time.  ``h`` (b, s,
    D); ``embed_table`` (V, D) tied, or the head (D, V) with
    ``transpose_head``.  A chunk that does not divide s (VLM text lengths)
    becomes gcd(s, chunk), as in JAX."""
    b, s, D = h.shape
    chunk = min(chunk, s)
    if s % chunk != 0:
        chunk = math.gcd(s, chunk) or s
    W = embed_table if transpose_head else embed_table.t()  # (D, V)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_ce_chunk, hc, lc, W, final_softcap, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, n = _ce_chunk(hc, lc, W, final_softcap)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
