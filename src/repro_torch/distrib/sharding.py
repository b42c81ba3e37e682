"""Sharding rules: map every parameter / batch / cache tensor to a
PartitionSpec over the mesh.  Port of ``repro.distrib.sharding`` on
``torch.distributed``.

Strategy (MaxText-style 2-D sharding):

* weights: FSDP over the batch axes ("pod","data") × TP over "model"
  (heads / ffn / experts / vocab on the model axis)
* activations: batch over ("pod","data")
* MoE experts: expert-parallel over "model" when E divides the axis,
  otherwise TP inside each expert (grok-1: E=8 < 16)
* decode caches: batch over "data" when divisible; long-context batch=1
  cells shard the *sequence* axis instead (ring-style KV sharding)

Every rule degrades to replication when a dimension does not divide the
axis.

A spec is the port's own :class:`PartitionSpec`: per tensor dim ``None``,
a mesh axis name, or a tuple of names (one dim over several mesh axes,
major first), as JAX's.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or an
:class:`AbstractMesh` (names and sizes only) where no process group is
needed.  :meth:`Rules.named` turns specs into DTensor placements, one per
mesh dim: ``Shard(d)`` where tensor dim d maps to that mesh dim,
``Replicate()`` elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # the models import this package: theirs is imported late
    from ..models.config import LayerKind, ModelConfig

PyTree = Any


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, an axis name, or a tuple of axis names.
    A one-name tuple is that name (as JAX's ``PartitionSpec`` prints it)."""

    def __new__(cls, *axes):
        norm = []
        for a in axes:
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                a = a[0] if len(a) == 1 else (a or None)
            norm.append(a)
        return super().__new__(cls, norm)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: enough for the spec rules."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """name → size, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclass(frozen=True)
class MeshAxes:
    batch: Tuple[str, ...]  # ("pod","data") or ("data",)
    model: str = "model"


def mesh_axes(mesh) -> MeshAxes:
    names = axis_names(mesh)
    batch = tuple(n for n in names if n in ("pod", "data"))
    return MeshAxes(batch=batch)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def _batch_size(mesh, axes: MeshAxes) -> int:
    size = 1
    for a in axes.batch:
        size *= _axis_size(mesh, a)
    return size


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def map_specs(fn: Callable, specs: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the spec leaves of a nested dict (``rest``: trees of the
    same structure, e.g. the parameter shapes)."""
    if _is_spec(specs):
        return fn(specs, *rest)
    return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: PartitionSpec) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` on each mesh dim that tensor dim d maps to, else
    ``Replicate()``.  Dims over several mesh axes need them in mesh order
    (major first), as every rule gives them."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_slices(mesh, spec: PartitionSpec, shape: Sequence[int],
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The index of the shard at mesh coordinate ``coord`` of a tensor of
    ``shape`` laid out by ``spec`` (dims that divide their axes)."""
    sizes = mesh_shape(mesh)
    names = axis_names(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _spec_axes(spec[d]) if d < len(spec) else ()
        parts, k = 1, 0
        for a in axes:  # major first
            s = sizes[a]
            parts, k = parts * s, k * s + coord[names.index(a)]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide {axes}")
        step = n // parts
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


class Rules:
    """PartitionSpec factory bound to a mesh.

    ``weight_fsdp=False`` switches to the serving layout: weights are TP-only
    (no per-use all-gather over the batch axes).  Training keeps FSDP.
    """

    def __init__(self, mesh, *, weight_fsdp: bool = True):
        self.mesh = mesh
        self.ax = mesh_axes(mesh)
        self.model_size = _axis_size(mesh, self.ax.model)
        self.batch_size = _batch_size(mesh, self.ax)
        self.weight_fsdp = weight_fsdp
        # the axes weight storage is sharded over (beyond "model")
        self.wf = self.ax.batch if weight_fsdp else None

    # -- helpers -----------------------------------------------------------

    def model_if(self, dim: int) -> Optional[str]:
        return self.ax.model if dim % self.model_size == 0 else None

    def batch_if(self, dim: int):
        return self.ax.batch if dim % self.batch_size == 0 else None

    def spec(self, *axes) -> PartitionSpec:
        return P(*axes)

    # -- parameter specs -----------------------------------------------------

    def layer_specs(self, cfg: ModelConfig, kind: LayerKind, stacked: bool,
                    cross: bool = False) -> Dict[str, Any]:
        L = (None,) if stacked else ()
        fsdp = self.wf
        m = self.ax.model
        out: Dict[str, Any] = {"ln1": {"scale": P(*L)}}
        if cfg.norm == "layernorm":
            out["ln1"]["bias"] = P(*L)
        if kind.mixer == "attn":
            kv_m = self.model_if(cfg.num_kv_heads)
            h_m = self.model_if(cfg.num_heads)  # whisper: 12 heads / 16-way
            out["wq"] = P(*L, fsdp, h_m, None)
            out["wk"] = P(*L, fsdp, kv_m, None)
            out["wv"] = P(*L, fsdp, kv_m, None)
            out["wo"] = P(*L, h_m, None, fsdp)
        else:
            d_in_m = self.model_if(cfg.d_inner)
            out["w_z"] = P(*L, fsdp, d_in_m)
            out["w_xBC"] = P(*L, fsdp, None)
            out["w_dt"] = P(*L, fsdp, None)
            out["dt_bias"] = P(*L)
            out["conv_w"] = P(*L, None, None)
            out["conv_b"] = P(*L)
            out["A_log"] = P(*L)
            out["D"] = P(*L)
            out["gate_norm"] = P(*L)
            out["w_out"] = P(*L, d_in_m, fsdp)
        if cross:
            kv_m = self.model_if(cfg.num_kv_heads)
            h_m = self.model_if(cfg.num_heads)
            out["ln_cross"] = {"scale": P(*L)}
            if cfg.norm == "layernorm":
                out["ln_cross"]["bias"] = P(*L)
            out["cq"] = P(*L, fsdp, h_m, None)
            out["ck"] = P(*L, fsdp, kv_m, None)
            out["cv"] = P(*L, fsdp, kv_m, None)
            out["co"] = P(*L, h_m, None, fsdp)
        if kind.ffn != "none":
            out["ln2"] = {"scale": P(*L)}
            if cfg.norm == "layernorm":
                out["ln2"]["bias"] = P(*L)
            if kind.ffn == "moe":
                E = cfg.num_experts
                # routers are tiny and read by every shard → replicated
                if E % self.model_size == 0:
                    # expert parallelism
                    ffn = {
                        "router": P(*L, None, None),
                        "w_in": P(*L, m, fsdp, None),
                        "w_out": P(*L, m, None, fsdp),
                    }
                    if cfg.mlp_gated:
                        ffn["w_gate"] = P(*L, m, fsdp, None)
                else:
                    # TP inside each expert (grok-1: 8 experts on a 16 axis)
                    ffn = {
                        "router": P(*L, None, None),
                        "w_in": P(*L, None, fsdp, m),
                        "w_out": P(*L, None, m, fsdp),
                    }
                    if cfg.mlp_gated:
                        ffn["w_gate"] = P(*L, None, fsdp, m)
                out["ffn"] = ffn
            else:
                out["ffn"] = {
                    "w_in": P(*L, fsdp, m),
                    "w_out": P(*L, m, fsdp),
                }
                if cfg.mlp_gated:
                    out["ffn"]["w_gate"] = P(*L, fsdp, m)
        return out

    def param_specs(self, cfg: ModelConfig) -> PyTree:
        from ..models.blocks import build_plan
        from ..models.config import LayerKind

        plan = build_plan(cfg)
        fsdp = self.wf
        v_m = self.model_if(cfg.vocab_size)
        specs: Dict[str, Any] = {
            "embed": {"table": P(v_m, fsdp)},
            "final_norm": {"scale": P()},
        }
        if cfg.norm == "layernorm":
            specs["final_norm"]["bias"] = P()
        if not cfg.tie_embeddings:
            specs["lm_head"] = {"w": P(fsdp, v_m)}
        if cfg.is_encoder_decoder:
            enc_kind = LayerKind("attn", "mlp")
            specs["enc"] = {
                "blocks": {"pos0": self.layer_specs(cfg, enc_kind, True)},
                "final_norm": {"scale": P()},
            }
            if cfg.norm == "layernorm":
                specs["enc"]["final_norm"]["bias"] = P()
            specs["blocks"] = {
                "pos0": self.layer_specs(cfg, enc_kind, True, cross=True)
            }
        else:
            specs["blocks"] = {
                f"pos{i}": self.layer_specs(cfg, kind, True)
                for i, kind in enumerate(plan.kinds)
            }
        return specs

    # -- batch / cache specs ----------------------------------------------------

    def batch_specs(self, cfg: ModelConfig, *, batch: int, with_labels: bool,
                    prefix: bool) -> Dict[str, Any]:
        b = self.batch_if(batch)
        out: Dict[str, Any] = {"tokens": P(b, None)}
        if with_labels:
            out["labels"] = P(b, None)
        if prefix:
            out["prefix_embeds"] = P(b, None, None)
        return out

    def cache_specs(self, cfg: ModelConfig, *, batch: int) -> PyTree:
        """Specs matching Model.init_cache structure."""
        from ..models.blocks import build_plan

        plan = build_plan(cfg)
        b = self.batch_if(batch)
        kv_m = self.model_if(cfg.num_kv_heads)
        # kv_heads that don't divide the model axis (GQA kv=8 on a 16-way
        # axis) would replicate a long cache: shard head_dim instead
        hd_m = self.model_if(cfg.head_dim) if kv_m is None else None
        # batch=1 long-context: shard the sequence axis instead of batch
        seq = self.ax.batch if b is None else None
        out: Dict[str, Any] = {}
        if cfg.is_encoder_decoder:
            out["pos0"] = {
                "k": P(None, b, seq, kv_m, hd_m),
                "v": P(None, b, seq, kv_m, hd_m),
                "ck": P(None, b, seq, kv_m, hd_m),
                "cv": P(None, b, seq, kv_m, hd_m),
            }
            return out
        for i, kind in enumerate(plan.kinds):
            if kind.mixer == "attn":
                out[f"pos{i}"] = {
                    "k": P(None, b, seq, kv_m, hd_m),
                    "v": P(None, b, seq, kv_m, hd_m),
                }
            else:
                nh_m = self.model_if(cfg.ssm_heads)
                ch_m = self.model_if(cfg.d_inner + 2 * cfg.ssm_state)
                out[f"pos{i}"] = {
                    "conv": P(None, b, None, ch_m),
                    "ssm": P(None, b, nh_m, None, None),
                }
        return out

    # -- conversions -------------------------------------------------------------

    def named(self, spec_tree: PyTree) -> PyTree:
        """The tree of DTensor placements (JAX: of ``NamedSharding``)."""
        return map_specs(lambda s: placements(self.mesh, s), spec_tree)

    def distribute(self, tree: PyTree, spec_tree: PyTree) -> PyTree:
        """Every tensor of ``tree`` (whole, on every rank) as a DTensor laid
        out by its spec."""
        from torch.distributed.tensor import distribute_tensor

        return map_specs(
            lambda s, t: distribute_tensor(t, self.mesh, placements(self.mesh, s)),
            spec_tree, tree)


def fingerprint(mesh) -> str:
    """Topology fingerprint recorded in snapshots."""
    shape = mesh_shape(mesh)
    return "x".join(f"{n}={shape[n]}" for n in axis_names(mesh))
