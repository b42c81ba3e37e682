"""The collectives of one sharded step, by a stated model.

No partitioner inserts collectives into the port's step, so the dry run
(``launch/dryrun.py``) reckons them from the cell's specs
(``launch/specs.py``), per device, by five rules:

1. FSDP gathers: each weight sharded over the FSDP axes is all-gathered
   over them once a microbatch for each forward pass over it; a stacked
   layer weight once per layer and pass, where a training step makes two
   passes (the forward and remat's recompute) and three under two-level
   remat (``remat_group > 1``); embedding, head and final norm one pass;
2. gradient reductions (training): each FSDP-sharded weight's gradient is
   reduce-scattered over its FSDP axes, every other weight's all-reduced
   over the batch axes, once a microbatch;
3. TP all-reduces: after each row-parallel projection whose contracted dim
   is sharded over "model" (attention's ``wo``, cross-attention's ``co``,
   the dense FFN's and the Mamba mixer's ``w_out``), one all-reduce of the
   layer's (tokens, d_model) output in the model dtype per forward pass,
   and one in the backward (the input gradient of the column-parallel
   projections that mirror it);
4. the MoE combine: in place of the FFN's, one all-reduce over "model" of
   the (tokens, d_model) output in bfloat16, as ``moe_ffn_sharded`` does,
   per forward pass and one in the backward;
5. a sequence-sharded cache (a long-context decode whose batch does not
   divide the batch axes): each attention layer combines its partial
   softmax over the batch axes, one all-reduce of (b, heads, hd + 2)
   float32 (the output and the row max and sum).

Each is converted to wire bytes by hlocost's ring factors
(``opcost._wire_bytes``); ``roofline.analyze`` times them at the rate of
their axes.  What the model leaves out: the serving layout's token gathers
in the MoE layers, the vocabulary-sharded loss's small all-reduces, and
XLA's resharding copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from ..distrib.sharding import mesh_shape
from ..models.blocks import build_plan
from ..models.config import LayerKind
from ..models.transformer import torch_dtype
from ..opcost import _wire_bytes
from .specs import dec_len

PyTree = Any

@dataclass(frozen=True)
class Collective:
    """``count`` collectives of one kind, per device: ``nbytes`` as hlocost
    reads them (an all-gather's gathered output, a reduce-scatter's
    scattered output, an all-reduce's tensor) over the mesh axes ``axes``
    (``group`` devices); ``rule`` names the rule, ``what`` the weight or
    layer."""

    rule: str
    what: str
    op: str
    axes: Tuple[str, ...]
    group: int
    nbytes: int
    count: int

    @property
    def wire_bytes(self) -> float:
        return _wire_bytes(self.op, self.nbytes, self.group) * self.count


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _leaves(shapes: PyTree, specs: PyTree, path: str = "") -> List[Tuple[str, Any, Any]]:
    """(path, tensor, spec) of every leaf of two trees of one structure."""
    if isinstance(shapes, dict):
        return [x for k in sorted(shapes)
                for x in _leaves(shapes[k], specs[k], f"{path}/{k}" if path else k)]
    return [(path, shapes, specs)]


def _group(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def fsdp_gathers(param_shapes: PyTree, param_specs: PyTree, mesh, fsdp: Sequence[str], *,
                 block_passes: int, microbatches: int) -> List[Collective]:
    """Rule 1: each FSDP-sharded weight gathered over its FSDP axes once a
    microbatch per forward pass; a stacked layer weight (under ``blocks``)
    once per layer slice and pass (``block_passes``), any other weight one
    pass."""
    sizes = mesh_shape(mesh)
    out = []
    for path, t, spec in _leaves(param_shapes, param_specs):
        axes = [a for e in spec for a in _spec_axes(e)]
        f_axes = tuple(a for a in axes if a in fsdp)
        if not f_axes or _group(sizes, f_axes) == 1:
            continue
        other = _group(sizes, [a for a in axes if a not in fsdp])
        nbytes = t.numel() * t.element_size() // other
        stacked = "blocks" in path.split("/")
        layers = t.shape[0] if stacked else 1
        out.append(Collective("fsdp gather", path, "all-gather", f_axes,
                              _group(sizes, f_axes), nbytes // layers,
                              layers * (block_passes if stacked else 1) * microbatches))
    return out


def grad_reductions(param_shapes: PyTree, param_specs: PyTree, mesh, fsdp: Sequence[str],
                    batch: Sequence[str], *, microbatches: int) -> List[Collective]:
    """Rule 2: once a microbatch, each FSDP-sharded weight's gradient
    reduce-scattered over its FSDP axes (to its shard's bytes), each other
    weight's all-reduced over the batch axes."""
    sizes = mesh_shape(mesh)
    out = []
    for path, t, spec in _leaves(param_shapes, param_specs):
        axes = [a for e in spec for a in _spec_axes(e)]
        local = t.numel() * t.element_size() // _group(sizes, axes)
        f_axes = tuple(a for a in axes if a in fsdp)
        if f_axes:
            op, red = "reduce-scatter", f_axes
        else:
            op, red = "all-reduce", tuple(a for a in batch if a not in axes)
        if _group(sizes, red) > 1:
            out.append(Collective("gradient reduction", path, op, red, _group(sizes, red), local,
                                  microbatches))
    return out


def layer_all_reduces(cfg, rules, *, tokens: int, passes: int, backward: bool,
                      layers: Sequence[Tuple[str, Any]], cross: bool = False,
                      microbatches: int = 1) -> List[Collective]:
    """Rules 3 and 4 for ``layers`` ((name, LayerKind) of every layer the
    stack runs), each over ``tokens`` tokens per device and microbatch: the
    TP all-reduce after each row-parallel projection sharded over "model",
    the MoE combine in place of the FFN's, per forward pass and once in the
    backward, each microbatch."""
    m = rules.ax.model
    msize = rules.model_size
    if msize == 1:
        return []
    count = (passes + (1 if backward else 0)) * microbatches
    e = torch_dtype(cfg.dtype).itemsize
    act = tokens * cfg.d_model * e
    out = []
    for name, kind in layers:
        if kind.mixer == "attn":
            sharded = rules.model_if(cfg.num_heads) is not None
            n = 2 if cross else 1  # self- and cross-attention
        else:
            sharded = rules.model_if(cfg.d_inner) is not None
            n = 1
        if sharded:
            out.append(Collective("tp all-reduce", f"{name} {kind.mixer}", "all-reduce",
                                  (m,), msize, act, n * count))
        if kind.ffn == "moe":
            out.append(Collective("moe combine", name, "all-reduce", (m,), msize,
                                  tokens * cfg.d_model * 2, count))
        elif kind.ffn != "none":
            out.append(Collective("tp all-reduce", f"{name} ffn", "all-reduce", (m,), msize,
                                  act, count))
    return out


def cache_combines(cfg, rules, *, batch: int, layers: Sequence[Tuple[str, Any]]
                   ) -> List[Collective]:
    """Rule 5: over a sequence-sharded cache, each attention layer's
    partial softmax combined over the batch axes."""
    axes = rules.ax.batch
    if rules.batch_if(batch) is not None or rules.batch_size == 1:
        return []
    heads = cfg.num_heads // (rules.model_size if rules.model_if(cfg.num_heads) else 1)
    nbytes = batch * heads * (cfg.head_dim + 2) * 4
    return [Collective("cache combine", name, "all-reduce", axes, rules.batch_size,
                       nbytes, 1)
            for name, kind in layers if kind.mixer == "attn"]


def _first(tree: PyTree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def step_collectives(cell) -> List[Collective]:
    """The collectives of one step of ``cell`` (``launch.specs.Cell``) by the
    five rules above."""
    cfg, shape, rules = cell.cfg, cell.shape, cell.rules
    train = shape.kind == "train"
    params, pspecs = cell.param_shapes, cell.param_specs
    fsdp = tuple(rules.wf or ())
    mb = cell.microbatches
    passes = (3 if cell.remat_group > 1 else 2) if train else 1
    out = fsdp_gathers(params, pspecs, rules.mesh, fsdp, block_passes=passes,
                       microbatches=mb)
    if train:
        out += grad_reductions(params, pspecs, rules.mesh, fsdp, rules.ax.batch,
                               microbatches=mb)
    B, S = shape.global_batch, shape.seq_len
    b_dev = B // rules.batch_size if rules.batch_if(B) is not None else B
    b_mb = max(1, b_dev // mb)
    decode = shape.kind == "decode"
    plan = build_plan(cfg)
    if cfg.is_encoder_decoder:
        enc = LayerKind("attn", "mlp")
        n_enc = _first(params["enc"]["blocks"]).shape[0]
        n_dec = _first(params["blocks"]).shape[0]
        dec_layers = [(f"dec{i}", enc) for i in range(n_dec)]
        if not decode:
            out += layer_all_reduces(cfg, rules, tokens=b_mb * S, passes=passes,
                                     backward=train, microbatches=mb,
                                     layers=[(f"enc{i}", enc) for i in range(n_enc)])
        text = 1 if decode else dec_len(cfg, S)
        out += layer_all_reduces(cfg, rules, tokens=b_mb * text, passes=passes,
                                 backward=train, microbatches=mb, layers=dec_layers,
                                 cross=True)
        layers = dec_layers
    else:
        layers = [(f"layer{r * len(plan.kinds) + i}", kind)
                  for r in range(plan.n_repeat) for i, kind in enumerate(plan.kinds)]
        out += layer_all_reduces(cfg, rules, tokens=b_mb * (1 if decode else S),
                                 passes=passes, backward=train, microbatches=mb, layers=layers)
    if decode:
        out += cache_combines(cfg, rules, batch=B, layers=layers)
    return [c for c in out if c.count > 0 and c.group > 1]


def collective_summary(colls: Sequence[Collective]) -> List[Dict[str, Any]]:
    """The collectives grouped by rule and op, for the artifact."""
    rows: Dict[Tuple[str, str, Tuple[str, ...]], Dict[str, Any]] = {}
    for c in colls:
        row = rows.setdefault((c.rule, c.op, c.axes), {
            "rule": c.rule, "op": c.op, "axes": list(c.axes), "group": c.group,
            "count": 0, "bytes": 0, "wire_bytes": 0.0})
        row["count"] += c.count
        row["bytes"] += c.nbytes * c.count
        row["wire_bytes"] += c.wire_bytes
    return list(rows.values())
