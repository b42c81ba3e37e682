"""Step builders of the port: ``prefill_step`` and ``serve_step`` as plain
functions over (params, batch | cache), as in ``repro.launch.steps``.

The train step and the train state need the optimizers, which come with
the training slice; until then they raise."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models import Batch, Model
from ..models.transformer import unsupported

PyTree = Any
_TRAINING = "Queue 1 item 9, training"


def _to_batch(d: Dict[str, torch.Tensor]) -> Batch:
    return Batch(tokens=d["tokens"], labels=d.get("labels"),
                 prefix_embeds=d.get("prefix_embeds"))


def make_train_state(*args, **kwargs) -> PyTree:
    raise unsupported("the train state", _TRAINING)


def make_train_step(*args, **kwargs) -> Callable:
    raise unsupported("the train step", _TRAINING)


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, _to_batch(batch), cache_len)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(params: PyTree, cache: PyTree, tokens: torch.Tensor, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
