"""Step builders of the port: ``train_step``, ``prefill_step`` and
``serve_step`` as plain functions over (state | params, batch | cache), as
in ``repro.launch.steps``.

The train step is ``torch.autograd`` through ``Model.loss``: on the card,
attention's gradient comes from the hand-written flash backward
(``kernels/flash_attention``) and the SSD scan's from the hand-written
``ssd_scan`` backward (``kernels/ssd``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..convert import flat_tensors
from ..device import DeviceLike
from ..models import Batch, Model
from ..models.transformer import torch_dtype
from ..optim import OptimizerConfig, clip_by_global_norm, make_optimizer

PyTree = Any


def _to_batch(d: Dict[str, torch.Tensor]) -> Batch:
    return Batch(tokens=d["tokens"], labels=d.get("labels"),
                 prefix_embeds=d.get("prefix_embeds"))


def make_train_state(model: Model, opt_cfg: OptimizerConfig, seed: int = 0, *,
                     device: DeviceLike = None) -> PyTree:
    """``{"params", "opt"}`` on ``device`` (the GPU unless ``"cpu"``)."""
    init_fn, _ = make_optimizer(opt_cfg)
    params = model.init(seed, device=device)
    return {"params": params, "opt": init_fn(params)}


def train_state_shapes(model: Model, opt_cfg: OptimizerConfig) -> PyTree:
    """The train state's template as ``meta`` tensors (shapes and dtypes)."""
    init_fn, _ = make_optimizer(opt_cfg)
    params = model.param_shapes()
    return {"params": params, "opt": init_fn(params)}


def _unflatten(pairs: List[Tuple[str, torch.Tensor]]) -> PyTree:
    root: Dict[str, Any] = {}
    for path, t in pairs:
        node = root
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = t
    return root


def value_and_grad(model: Model, params: PyTree,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, PyTree]:
    """(loss, gradients) of ``model.loss`` at ``params``, as JAX's
    ``jax.value_and_grad``: a leaf the loss does not reach gets zeros."""
    pairs = flat_tensors(params)
    req = [t.detach().requires_grad_(True) for _, t in pairs]
    with torch.enable_grad():
        loss = model.loss(_unflatten([(p, t) for (p, _), t in zip(pairs, req)]),
                          _to_batch(batch))
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(req, grads)]
    return loss.detach(), _unflatten([(p, g) for (p, _), g in zip(pairs, grads)])


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1) -> Callable:
    """The train step: (state, batch) -> (state, {"loss", "grad_norm"}).

    ``microbatches > 1`` accumulates the gradients of batch slices in
    ``opt_cfg.accum_dtype`` (JAX's scan over slices), and the 1 /
    microbatches prescale is folded into the clip.  The optimizer updates
    the state's tensors in place and returns the state."""
    _, update_fn = make_optimizer(opt_cfg)

    def train_step(state: PyTree, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            acc_dt = torch_dtype(opt_cfg.accum_dtype)
            n = next(iter(batch.values())).shape[0] // microbatches
            loss, grads = None, None
            for i in range(microbatches):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                l, g = value_and_grad(model, params, mb)
                pairs = flat_tensors(g)
                if grads is None:
                    loss = torch.zeros((), dtype=torch.float32, device=l.device) + l
                    grads = [t.to(acc_dt) for _, t in pairs]
                else:
                    loss = loss + l
                    grads = [a + t.to(a.dtype) for a, (_, t) in zip(grads, pairs)]
            grads = _unflatten([(p, t) for (p, _), t in zip(pairs, grads)])
            loss = loss / microbatches
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip,
                                           prescale=1.0 / microbatches)
        new_params, new_opt = update_fn(grads, state["opt"], params)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, _to_batch(batch), cache_len)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(params: PyTree, cache: PyTree, tokens: torch.Tensor, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
