"""Roofline terms of a dry-run cell against H100 constants: port of
``repro.roofline``.

Three terms per (arch × shape × mesh), all in seconds, per device:

    compute    = flops_per_device / peak FLOP/s of the model's dtype
    memory     = bytes_per_device / HBM bandwidth
    collective = Σ wire_bytes(op) / the link rate of the op's mesh axes

The totals come from ``repro_torch.opcost`` (the step traced on the meta
device, kernels booked by their own formulas) and the collectives from
``launch/collectives.py`` (the cell's specs), not from compiled HLO: ``parse_collectives`` and
``scan_trip_counts`` of the JAX package read XLA's HLO text, and the port
has no counterpart of either.

Hardware constants: one H100 SXM (NVIDIA data sheet, dense, at the 700 W
limit): 989 TFLOP/s bf16, 67 TFLOP/s float32 (outside the tensor cores),
3.35 TB/s HBM.  The production mesh maps onto a 256-GPU NVLink Switch
domain: "data" and "model" cross NVLink at 450 GB/s a GPU one way, the
multi-pod "pod" axis crosses InfiniBand NDR at 50 GB/s a GPU.  A collective
over several axes runs at the rate of the slowest of them.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # per GPU, dense
HBM_BW = 3.35e12          # bytes/s per GPU
NVLINK_BW = 450e9         # bytes/s per GPU, one way (NVLink Switch domain)
IB_BW = 50e9              # bytes/s per GPU (InfiniBand NDR, 400 Gb/s)
AXIS_BW = {"data": NVLINK_BW, "model": NVLINK_BW, "pod": IB_BW}


def axis_rate(axes: Sequence[str]) -> float:
    """Bytes/s of a collective over ``axes``: the slowest axis's link."""
    return min(AXIS_BW[a] for a in axes)


def collective_seconds(collectives: Sequence) -> float:
    """Seconds on the wire: each collective's wire bytes (``wire_bytes``)
    over the link rate of its mesh axes (``axes``)."""
    return sum(c.wire_bytes / axis_rate(c.axes) for c in collectives)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N·D for a forward-only shape; decode processes D = batch tokens."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.is_encoder_decoder:
            tokens = shape.global_batch * (shape.seq_len + max(shape.seq_len // 8, 64))
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float
    collective_counts: Dict[str, int]
    memory_report: Dict[str, float]

    @property
    def bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def analyze(
    *,
    arch: str,
    shape_name: str,
    mesh_name: str,
    n_devices: int,
    totals,
    dtype: str,
    collectives: Sequence = (),
    cfg=None,
    shape=None,
    memory_report: Optional[Dict[str, float]] = None,
) -> RooflineTerms:
    """The three terms from one cell's per-device cost totals
    (``opcost.CostTotals``: ``flops``, ``bytes``, ``wire_bytes``,
    ``collective_counts``) and its per-device ``collectives``, timed by
    ``collective_seconds``; ``dtype`` picks the compute peak."""
    t_c = totals.flops / PEAK_FLOPS[dtype]
    t_m = totals.bytes / HBM_BW
    t_x = collective_seconds(collectives)
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)), key=lambda kv: kv[1]
    )[0]
    mf = model_flops(cfg, shape) if cfg is not None and shape is not None else 0.0
    ratio = (mf / (totals.flops * n_devices)) if totals.flops > 0 else 0.0
    return RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=totals.flops, bytes_per_device=totals.bytes,
        wire_bytes_per_device=totals.wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dominant,
        model_flops_total=mf, useful_flops_ratio=ratio,
        collective_counts=dict(totals.collective_counts),
        memory_report=memory_report or {},
    )


def to_json(t: RooflineTerms) -> dict:
    return asdict(t)
