"""Gradient compression for the slow data-parallel axis: port of
``repro.distrib.compress``.

An int8-with-error-feedback mean cuts the gradient bytes on the wire 4×
against float32 (an int8 payload plus one float32 scale per tensor slice).

* ``quantize_int8`` / ``dequantize_int8`` — symmetric per-slice scaling
* ``ef_compressed_mean`` — the mean over a mesh axis of *partial* grads:
  each rank quantizes (grad + carried error), all-gathers the int8 payload
  and the scales over the axis, dequantizes and averages locally; the
  quantization residual is carried to the next step (error feedback keeps
  the method unbiased in the long run).

JAX's version is a ``shard_map`` over a stacked leading dim; this one is
rank-local: each rank passes its own slice and gets its mean back.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compressed_mean(partial: torch.Tensor, error: torch.Tensor, mesh,
                       axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of this rank's ``partial`` and its peers' over mesh ``axis``,
    sent as int8 with error feedback; ``error`` is the rank's carried
    buffer (same shape).  Returns (the mean, the same on every rank of the
    axis; the new error buffer)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    target = partial + error
    q, s = quantize_int8(target)
    e_new = target - dequantize_int8(q, s)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)             # int8 on the wire
    dist.all_gather(ss, s.reshape(()), group=group)  # one f32 scale each
    mean = torch.tensordot(torch.stack(ss), torch.stack(qs).to(torch.float32),
                           dims=([0], [0])) / n
    return mean, e_new
