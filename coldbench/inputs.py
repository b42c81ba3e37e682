"""The benchmark's inputs, made from the seed: base weights and deltas.

Both sides get the same inputs: the program as its upload format (numpy,
bfloat16 as ``uint16`` bits), the reference as tensors.

Base weights are made on the device in the type they are served in, from
one ``torch.Generator`` in one draw: every "normal" leaf is a slice of one
float32 normal vector, times its scale.  The layout (leaf paths, shapes,
dtypes and fills) is the program's parameter tree, which ``build_params``
describes through the maker it is given.

Each function's delta follows ``serving/trace.py::build_delta_specs``:

* adapter: 16 embedding rows (from row 8 i, i the function's index) plus
  bf16 noise times 0.02, and the first ``ffn/w_in`` leaf shifted (a family
  without an FFN: the first layer of ``w_xBC``);
* head: ``embed/table`` scaled;
* fine-tune: every ``/wq``, ``/w_in`` and ``/w_out`` shifted (without an
  FFN: every ``/w_out`` and ``/w_z``).

The shift of the j-th function of a kind is (j + 1) times the rule's (0.01
for the adapter's leaf, 0.005 for the fine-tune, a scale of 1 + 0.01 (j + 1)
for the head), so no two functions upload the same delta.  Every
operation rounds to the leaf's dtype, as the rule's bfloat16 arithmetic does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Dict[str, Any]


def torch_seed(seed: int, *tag: int) -> int:
    return int(np.random.SeedSequence([int(seed), *tag]).generate_state(1, np.uint64)[0])


def flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def make_base(build_params: Callable[..., Tree], cfg: Any, seed: int,
              device: torch.device) -> Tree:
    """The program's parameter tree with random weights on ``device``."""
    sizes: List[int] = []

    def count(shape, dtype, fill, scale=0.02):
        if fill == "normal":
            sizes.append(math.prod(shape))
        return torch.empty(shape, dtype=dtype, device="meta")

    build_params(cfg, count)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 0))
    noise = torch.randn(sum(sizes), generator=gen, dtype=torch.float32, device=device)
    off = 0

    def make(shape, dtype, fill, scale=0.02):
        nonlocal off
        if fill == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if fill == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if fill == "log_arange":
            return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                          device=device)).to(dtype)
        n = math.prod(shape)
        x = noise[off:off + n].view(shape)
        off += n
        return (x * scale).to(dtype)

    params = build_params(cfg, make)
    del noise
    return params


@dataclass
class Function:
    name: str
    kind: str
    delta: Dict[str, torch.Tensor]                  # path -> device tensor
    rows: List[int] = field(default_factory=list)   # changed embedding rows


def _shifted(x: torch.Tensor, by: float) -> torch.Tensor:
    return (x.float() + by).to(x.dtype)


def make_functions(kinds: List[str], base: Dict[str, torch.Tensor],
                   seed: int) -> List[Function]:
    """One delta per kind in ``kinds`` (function i is ``fn{i}-{kind}``)."""
    table = base["embed/table"]
    ffn_w_in = next((k for k in base if k.endswith("ffn/w_in")), None)
    gen = torch.Generator(device=table.device).manual_seed(torch_seed(seed, 1))
    seen: Dict[str, int] = {}
    out: List[Function] = []
    for i, kind in enumerate(kinds):
        j = seen.get(kind, 0)
        seen[kind] = j + 1
        delta: Dict[str, torch.Tensor] = {}
        rows: List[int] = []
        if kind == "adapter":
            rows = list(range(8 * i, 8 * i + 16))
            noise = torch.randn((len(rows), table.shape[1]), generator=gen,
                                dtype=torch.float32, device=table.device).to(table.dtype)
            step = (noise.float() * 0.02).to(table.dtype)
            t = table.clone()
            t[rows] = (table[rows].float() + step.float()).to(table.dtype)
            delta["embed/table"] = t
            if ffn_w_in is not None:
                delta[ffn_w_in] = _shifted(base[ffn_w_in], 0.01 * (j + 1))
            else:
                key = next(k for k in base if k.endswith("/w_xBC"))
                w = base[key].clone()
                w[0] = _shifted(w[0], 0.01 * (j + 1))  # one layer of the stacked leaf
                delta[key] = w
        elif kind == "head":
            delta["embed/table"] = (table.float() * (1.0 + 0.01 * (j + 1))).to(table.dtype)
        elif kind == "finetune":
            for k, v in base.items():
                hit = (("/wq" in k or "/w_in" in k or "/w_out" in k) if ffn_w_in is not None
                       else (k.endswith("/w_out") or k.endswith("/w_z")))
                if hit:
                    delta[k] = _shifted(v, 0.005 * (j + 1))
        else:
            raise ValueError(f"unknown function kind {kind!r}")
        out.append(Function(f"fn{i}-{kind}", kind, delta, rows))
    return out


def to_upload(t: torch.Tensor) -> np.ndarray:
    """A host copy in the program's upload format (bf16 as uint16 bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
