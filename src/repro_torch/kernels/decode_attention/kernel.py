"""ctypes binding of the CUDA int8-KV decode-attention kernel
(``csrc/decode_attention_int8.cu``: one launch a call, splits of the cache
combined inside it through a thread-block cluster and, where clusters
cannot cover the card, a ticket).

Replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_int8``.  q (b, nh, hd) is
float32 or bfloat16, k and v int8 (b, S, nkv, hd) with float32 scales
(b, S, nkv), all contiguous; the output comes back in q's dtype.  ``pos``
is a one-element int32 tensor on the same device, which the kernel reads
(a decode loop needs no host sync), or a Python int.  Unlike the TPU kernel
it takes any S (a ragged last slice is masked); hd is a multiple of 16 up
to 256, and rep · hd at most 8192.

``launch_plan`` is the launch plan in plain Python (heads and rows a CTA,
splits, cluster, groups, shared memory), so that the CPU tests reach it; the
launcher refuses a plan it was not compiled for.  Plans and the SM count
are cached per shape and device, so a call allocates only its output.  A
plan with ``groups > 1`` also takes a ticket counter and a scratch for the
clusters' partials: one pair per (device, stream), made once at the size of
the largest plan the card can run (``scratch_elements``) and never freed,
so that a captured CUDA graph keeps valid addresses; each call leaves the
counters at zero.  Calls on one stream share it safely, as a stream runs
its kernels in order.  PyTorch draws its streams from a fixed pool per
device, so the pairs are bounded by the streams in use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Tuple

import torch

from ... import _build
from .._launch import LaunchCounter, check_launch, require_cuda, sm_count

#: launches of the CUDA kernel, counted where it launches
launches = LaunchCounter("decode_attention_int8")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 8192        # rep · hd
KEYS = 32               # keys of a warp's task in a stage, one per lane (kKeys)
WARPS = 4               # kWarps
STAGES = 3              # kStages: the ring of stages
MAX_CLUSTER = 8         # portable cluster size (kMaxCluster)
ROWS = (1, 2, 4, 8)     # query rows a CTA holds: the instantiations
SMEM_PER_BLOCK = 232_448   # H100: the most one block may opt in to
SMEM_PER_SM = 233_472      # H100: shared memory of an SM (1 KiB of it per CTA reserved)
CTAS_PER_SM = 2         # CTAs an SM the split count aims at, where they fit
CLUSTER_FILL = 0.85     # share of the CTAs the SMs hold that clusters of 8 can fill
LONG_SLICES = 8         # slices a warp walks from which a call counts as long
_ERRORS = {10003: "the launch plan matches no instantiation of the kernel"}
_fn_cache = []
_lock = threading.Lock()
_held: Dict[Tuple[int, torch.dtype, "DecodePlan"], int] = {}
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the kernel runs one call."""

    head_dim: int
    heads: int             # adjacent kv heads a CTA takes (H: 1, 2 or 4)
    rows: int              # query rows of each head a CTA holds (R, padded up to ROWS)
    row_blocks: int        # CTAs along the GQA group
    splits: int            # CTAs along the keys per (batch, head group, row block)
    cluster: int           # CTAs of a cluster (a range of splits)
    groups: int            # clusters per (batch, head group, row block)
    stage_keys: int        # keys of a stage: 32 per warp task, 128 / H
    smem: int              # dynamic shared memory of a CTA
    stages_per_cta: int    # stages of the busiest CTA at a full cache
    units: int             # batch x head groups x row blocks
    kernels: int = 1       # CUDA kernels a call enqueues

    @property
    def ctas(self) -> int:
        return self.units * self.splits

    @property
    def tickets(self) -> int:
        """int32 counters the call takes (0 without a second level): one
        per (batch, head group, row block, rank in the cluster)."""
        return self.units * self.cluster if self.groups > 1 else 0

    @property
    def partials(self) -> int:
        """float32 scratch for the clusters' (m, l, acc)."""
        if self.groups == 1:
            return 0
        hr = self.heads * self.rows
        return self.units * self.groups * (hr * self.head_dim + 2 * hr)


def smem_layout(rows: int, head_dim: int, heads: int) -> Dict[str, int]:
    """The kernel's shared memory (``layout`` in the source): q (H R x hd
    floats), the warps' m, l and weights, then a work region that holds
    the ring of stages and later the merges and the region the cluster's
    CTAs push their partials into."""
    nc = head_dim // 16
    hnc = heads * nc
    keys = KEYS * WARPS // heads
    swz = hnc % 8 == 0
    pitch = 16 * (hnc if swz else hnc | 1)
    kg = 32 // nc
    hr = heads * rows
    stage = 2 * keys * pitch + 2 * keys * heads * 4
    fixed = -(-4 * (hr * head_dim + 3 * WARPS * rows + 4) // 128) * 128
    ring = STAGES * stage
    merge = 4 * WARPS * kg * rows * head_dim
    comb = 4 * (MAX_CLUSTER + 2) * hr
    recv = 4 * (hr * head_dim + MAX_CLUSTER + 2 * MAX_CLUSTER * hr)
    yoff = max(merge, comb)
    work = max(ring, yoff + recv)
    return {"keys": keys, "pitch": pitch, "swizzle": swz, "stage": stage, "fixed": fixed,
            "ring": ring, "merge": merge, "yoff": yoff, "work": work, "smem": fixed + work}


def check_shape(dtype: torch.dtype, batch: int, seq: int, heads: int, kv_heads: int,
                head_dim: int) -> None:
    """Raise what the kernel cannot take, naming the reason."""
    if dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, not {dtype}")
    if kv_heads <= 0 or heads % kv_heads:
        raise ValueError(f"{heads} query heads do not group over {kv_heads} kv heads")
    if not (16 <= head_dim <= MAX_HEAD_DIM and head_dim % 16 == 0):
        raise ValueError(f"head dim {head_dim} is not a multiple of 16 in 16..{MAX_HEAD_DIM}: "
                         "rows are staged 16 int8 values at a time")
    if (heads // kv_heads) * head_dim > MAX_GROUP:
        raise ValueError(f"a group of {heads // kv_heads} heads x {head_dim} exceeds {MAX_GROUP}")
    if seq <= 0 or not 0 < batch <= 65535:
        raise ValueError(f"unsupported sizes b {batch}, S {seq}")
    if kv_heads * -(-(heads // kv_heads) // ROWS[-1]) > 65535:
        raise ValueError(f"{kv_heads} kv heads x row blocks exceed the grid's 65535")


def _splits(units: int, cap: int) -> Tuple[int, int]:
    """(splits, cluster) for at most ``cap`` splits per unit: up to
    MAX_CLUSTER splits form one cluster; past it, the cluster size of 4 to
    MAX_CLUSTER that leaves the most splits, in whole clusters."""
    if cap <= MAX_CLUSTER:
        return cap, cap
    c = max(range(MAX_CLUSTER, 3, -1), key=lambda c: (cap // c * c, c))
    return cap // c * c, c


@functools.lru_cache(maxsize=512)
def launch_plan(dtype: torch.dtype, batch: int, seq: int, heads: int, kv_heads: int,
                head_dim: int, sms: int, max_clusters: int = 0) -> DecodePlan:
    """The launch plan on a card of ``sms`` SMs.  Splits: the most CTAs per
    (batch, head group, row block) that still run in one wave, about
    ``CTAS_PER_SM`` an SM (every CTA streams its share of the cache at once,
    and they finish together), with a stage for every CTA at a full cache.
    Up to ``MAX_CLUSTER`` splits form one cluster; more take several
    clusters (``groups``) of 4 to ``MAX_CLUSTER``.  Heads: one
    a CTA where that leaves each warp fewer than ``LONG_SLICES`` 32-key
    slices at a full cache (a latency-bound call: more splits, shorter
    tails); else the most, up to 4, that divide nkv and fit a CTA's shared
    memory (a bandwidth-bound call: key rows of H hd contiguous bytes).
    ``max_clusters``: the clusters the card holds at once, where the
    wrapper has read them (0: not read, as in the CPU tests); the plan keeps
    within them."""
    check_shape(dtype, batch, seq, heads, kv_heads, head_dim)
    rep = heads // kv_heads
    rows = next(r for r in ROWS if r >= min(rep, ROWS[-1]))
    row_blocks = -(-rep // rows)

    def plan(h: int) -> DecodePlan:
        lay = smem_layout(rows, head_dim, h)
        fit = max(1, SMEM_PER_SM // (lay["smem"] + 1024))   # CTAs an SM holds
        slots = sms * min(CTAS_PER_SM, fit)
        # a cluster lies within one GPC (16 to 18 SMs on the H100): where
        # shared memory bounds the CTAs an SM holds, clusters fill only
        # part of the card's slots.  Planning under that share picks
        # cluster sizes that fit; the replan below only cuts splits, which
        # on an H100 ran mistral-nemo's b 8 step 1.65x slower without the
        # share (PERF.md, int8 decode design)
        slots = min(slots, int(sms * fit * CLUSTER_FILL))
        units = batch * (kv_heads // h) * row_blocks
        stages = -(-seq // lay["keys"])
        # the final combine weighs every group's rows in the merge region
        max_groups = lay["yoff"] // (4 * h * rows) - 1
        splits, cluster = _splits(units, max(1, min(slots // units, stages,
                                                    MAX_CLUSTER * max_groups)))
        if cluster > 1 and max_clusters and units * (splits // cluster) > max_clusters:
            # fewer groups, or smaller clusters, so that all are resident
            if max_clusters >= units:
                splits = cluster * (max_clusters // units)
            else:
                splits = cluster = max(1, cluster * max_clusters // units)
        return DecodePlan(head_dim=head_dim, heads=h, rows=rows, row_blocks=row_blocks,
                          splits=splits, cluster=cluster, groups=splits // cluster,
                          stage_keys=lay["keys"], smem=lay["smem"],
                          stages_per_cta=-(-stages // splits), units=units)

    one = plan(1)
    if one.stages_per_cta < LONG_SLICES:  # a stage of H = 1 is a slice a warp
        return one
    return plan(next(h for h in (4, 2, 1) if kv_heads % h == 0 and
                     smem_layout(rows, head_dim, h)["smem"] <= SMEM_PER_BLOCK))


def scratch_elements(sms: int) -> Tuple[int, int]:
    """(tickets, partials) that cover every plan with ``groups > 1`` on a card
    of ``sms`` SMs: such a plan runs its CTAs in one wave (units x splits <=
    CTAS_PER_SM sms, one counter per unit and rank, cluster >= 4) and holds
    at most 4 heads x 8 rows x 256 values and their m and l a cluster."""
    ctas = CTAS_PER_SM * sms
    hr = 4 * ROWS[-1]
    return ctas, ctas // 4 * (hr * MAX_HEAD_DIM + 2 * hr)


def _scratch_for(dev: torch.device, stream: int, plan: DecodePlan) -> Tuple[int, int]:
    """(ticket, partials) addresses of the stream's scratch, zeros when made."""
    key = (dev.index, stream)
    with _lock:
        bufs = _scratch.get(key)
        if bufs is None:
            tickets, partials = scratch_elements(sm_count(dev))
            bufs = _scratch[key] = (torch.zeros(tickets, dtype=torch.int32, device=dev),
                                    torch.zeros(partials, dtype=torch.float32, device=dev))
    if plan.tickets > bufs[0].numel() or plan.partials > bufs[1].numel():
        raise RuntimeError(f"decode_attention_int8: {plan} needs more scratch than "
                           f"{bufs[0].numel()} / {bufs[1].numel()}")
    return bufs[0].data_ptr(), bufs[1].data_ptr()


def plan_for(dev: torch.device, dtype: torch.dtype, batch: int, seq: int, heads: int,
             kv_heads: int, head_dim: int) -> DecodePlan:
    """The plan on ``dev``: ``launch_plan``, redone within the clusters the
    card holds at once (read once per dtype and plan)."""
    plan = launch_plan(dtype, batch, seq, heads, kv_heads, head_dim, sm_count(dev))
    if plan.cluster == 1:
        return plan
    key = (dev.index, dtype, plan)
    held = _held.get(key)
    if held is None:
        held = _held[key] = cluster_slots(dev, dtype, plan)
    if plan.units * plan.groups <= held:
        return plan
    return launch_plan(dtype, batch, seq, heads, kv_heads, head_dim, sm_count(dev), held)


def cluster_slots(dev: torch.device, dtype: torch.dtype, plan: DecodePlan) -> int:
    """The clusters of ``plan`` that the card can hold at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.load("decode_attention_int8")
    fn = lib.decode_attention_int8_max_clusters
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        n = fn(_DTYPES[dtype], plan.rows, plan.head_dim, plan.heads, plan.cluster, plan.smem)
    if n < 0:
        raise RuntimeError(f"decode_attention_int8: occupancy query failed with error {-n}")
    return n


def _fn():
    if not _fn_cache:
        fn = _build.load("decode_attention_int8").decode_attention_int8_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def _check(q, k, k_scale, v, v_scale, k_ptr: int, v_ptr: int) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("expected q (b, nh, hd), k / v (b, S, nkv, hd)")
    b, nh, hd = q.shape
    _, S, nkv, _ = k.shape
    if (v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd
            or k_scale.shape != (b, S, nkv) or v_scale.shape != (b, S, nkv)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"k and v must be int8, not {k.dtype}, {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("the scales must be float32")
    if not (q.is_contiguous() and k.is_contiguous() and k_scale.is_contiguous()
            and v.is_contiguous() and v_scale.is_contiguous()):
        for name, t in (("q", q), ("k", k), ("k_scale", k_scale), ("v", v),
                        ("v_scale", v_scale)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError("k and v must be 16-byte aligned")


def decode_attention_int8(
    q: torch.Tensor,        # (b, nh, hd)
    k: torch.Tensor,        # (b, S, nkv, hd) int8
    k_scale: torch.Tensor,  # (b, S, nkv) f32
    v: torch.Tensor,        # (b, S, nkv, hd) int8
    v_scale: torch.Tensor,  # (b, S, nkv) f32
    pos,                    # one-element int32 CUDA tensor, or int
    *,
    scale: float,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns (b, nh, hd) in q's dtype."""
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1:
            raise TypeError(f"pos must be one int32, got {pos.dtype} x {pos.numel()}")
        dev = require_cuda("decode_attention_int8", q, k, k_scale, v, v_scale, pos)
        pos_ptr, pos_host = pos.data_ptr(), 0
    else:
        dev = require_cuda("decode_attention_int8", q, k, k_scale, v, v_scale)
        pos_ptr, pos_host = None, max(-1, min(int(pos), 2**31 - 1))
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    _check(q, k, k_scale, v, v_scale, k_ptr, v_ptr)
    b, nh, hd = q.shape
    _, S, nkv, _ = k.shape
    plan = plan_for(dev, q.dtype, b, S, nh, nkv, hd)
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=dev)
    here = torch.cuda.current_device() == dev.index
    stream = (torch.cuda.current_stream() if here else torch.cuda.current_stream(dev)).cuda_stream
    ticket, part = _scratch_for(dev, stream, plan) if plan.groups > 1 else (None, None)
    args = (_DTYPES[q.dtype], q.data_ptr(), k_ptr, k_scale.data_ptr(), v_ptr,
            v_scale.data_ptr(), pos_ptr, pos_host, b, S, nh, nkv, hd, plan.heads,
            plan.rows, plan.row_blocks, plan.splits, plan.cluster, plan.smem, float(scale),
            part, ticket, out.data_ptr(), stream)
    if here:
        rc = _fn()(*args)
    else:
        with torch.cuda.device(dev):
            rc = _fn()(*args)
    if rc in _ERRORS:
        raise RuntimeError(f"decode_attention_int8: {_ERRORS[rc]} (error {rc})")
    check_launch("decode_attention_int8", rc)
    launches.add()
    return out
