"""ctypes binding of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``: TMA-fed tensor cores, ``wgmma`` for bf16 and
3xTF32 ``mma.sync`` for float32).

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention``.
Takes the TPU kernel's (b, heads, S, hd) view, with any (batch, head, seq)
strides that are multiples of 16 bytes and a unit-stride head dim, so the
model's (b, S, heads, hd) tensors pass as transposed views with no copy; the
output is allocated in the model's layout and returned as the matching view.
Unlike the TPU kernel it accepts any S (ragged tails are masked), a key
length Sk other than S (cross-attention) and the prefix-LM mask of the JAX
package's attention (``prefix_len``: under ``causal`` a key before it is
seen by every query).

``launch_plan`` is the kernel's launch plan in plain Python (instantiated
width, slabs, tile rows, stages, grid, shared memory), and ``live_tiles`` /
``tile_needs_mask`` its walk over the key tiles of one q tile, so that the
CPU tests reach them; the launcher refuses a plan that differs from its
instantiations.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from ... import _build
from .._launch import LaunchCounter, book, check_launch, launch_device, sm_count

#: launches of the CUDA kernel, counted where it launches
launches = LaunchCounter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TILE_Q = 64                  # q rows per CTA: one consumer warpgroup
THREADS = 160                # the warpgroup and one producer warp
SLAB_BYTES = 128             # the TMA box and wgmma swizzle row
ALIGN = 16                   # TMA: base address and strides in bytes
SMEM_PER_BLOCK = 232_448     # H100: the most one block may opt in to
SMEM_PER_SM = 233_472        # H100: 228 KiB an SM for resident blocks ...
SMEM_RESERVED = 1_024        # ... of which the runtime takes 1 KiB a block
#: head-dim widths the kernel is instantiated for, per element size: the
#: head dim is zero-padded in shared memory up to the next one
WIDTHS = {4: (32, 64, 128, 256), 2: (64, 128, 256)}
#: launcher errors beyond the CUDA runtime's
_ERRORS = {10001: "cuTensorMapEncodeTiled not found in the driver",
           10002: "cuTensorMapEncodeTiled refused a tensor map",
           10003: "the launch plan matches no instantiation of the kernel"}
_fn_cache = []


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the kernel runs one call."""

    head_dim: int
    width: int               # instantiated head-dim width (zero-padded)
    slab: int                # elements of one 128-byte slab
    slabs: int               # slabs across the width
    tile_q: int              # q rows per CTA
    tile_k: int              # keys per K / V tile
    stages: int              # K / V tiles in flight
    smem_bytes: int          # dynamic shared memory of one CTA
    blocks_per_sm: int       # CTAs an SM holds by shared memory
    grid: Tuple[int, int, int]  # (heads, batch, q tiles)
    threads: int = THREADS

    @property
    def padding_waste(self) -> float:
        """Share of the tensor-core work (bf16) or shared memory (float32)
        spent on zero padding of the head dim."""
        return 1.0 - self.head_dim / self.width


def _smem(itemsize: int, width: int, tile_k: int, stages: int) -> int:
    tiles = (TILE_Q + 2 * stages * tile_k) * width * itemsize
    return tiles + 8 * (1 + 2 * stages) + 1024  # mbarriers; 1024-byte alignment


@functools.lru_cache(maxsize=256)
def launch_plan(dtype: torch.dtype, head_dim: int, *, batch: int = 1, heads: int = 1,
                seq: int = 1) -> FlashPlan:
    """The launch plan for ``dtype`` (float32 or bfloat16) at ``head_dim``;
    raises ``ValueError`` naming what the design cannot take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} is not a multiple of 8 in 8..{MAX_HEAD_DIM}: "
                         "the tensor-core tiles take the head dim 8 at a time")
    width = next(w for w in WIDTHS[itemsize] if w >= head_dim)
    tile_k = 32 if itemsize == 4 and width == 256 else 64
    for per_sm in (2, 1):
        for stages in (3, 2):
            smem = _smem(itemsize, width, tile_k, stages)
            if smem <= SMEM_PER_BLOCK and per_sm * (smem + SMEM_RESERVED) <= SMEM_PER_SM:
                slab = SLAB_BYTES // itemsize
                return FlashPlan(head_dim=head_dim, width=width, slab=slab,
                                 slabs=width // slab, tile_q=TILE_Q, tile_k=tile_k,
                                 stages=stages, smem_bytes=smem, blocks_per_sm=per_sm,
                                 grid=(heads, batch, -(-seq // TILE_Q)))
    raise ValueError(f"head dim {head_dim}: no tiling fits {SMEM_PER_BLOCK} bytes")


def live_tiles(q0: int, q_last: int, Sk: int, tile_k: int, *, causal: bool,
               window: int, prefix_len: int) -> range:
    """The key tiles the kernel walks for the q tile of rows ``q0 ..
    q_last``: up to the last row's causal frontier, which the prefix moves
    to at least ``prefix_len - 1``, and from the oldest key the window lets
    the first row see."""
    hi = -(-Sk // tile_k)
    if causal:
        hi = min(hi, max(q_last, prefix_len - 1) // tile_k + 1)
    lo = max(q0 - window + 1, 0) // tile_k if window > 0 else 0
    return range(lo, max(hi, lo))


def tile_needs_mask(k0: int, q0: int, q_last: int, Sk: int, tile_k: int, *,
                    causal: bool, window: int, prefix_len: int) -> bool:
    """Whether the kernel masks the scores of the key tile at ``k0`` element
    by element: it holds a padded key, a key past the first row's causal
    frontier (max(q0, prefix_len - 1)), or a key outside some row's
    window."""
    return (k0 + tile_k > Sk
            or (causal and k0 + tile_k - 1 > max(q0, prefix_len - 1))
            or (window > 0 and q_last - k0 >= window))


def allowed_pairs(S: int, Sk: int, *, causal: bool, window: int, prefix_len: int) -> int:
    """The (query, key) pairs the mask allows, in closed form (no S x Sk
    mask): query q sees keys from ``max(q - window + 1, 0)`` (a window) to
    ``max(q, prefix_len - 1)`` (causal; the prefix is seen by every query)
    or to ``Sk - 1``.  Each count is linear in q between the kinks listed
    below, so every stretch sums as an arithmetic series."""
    def keys(q: int) -> int:
        lo = max(q - window + 1, 0) if window > 0 else 0
        hi = min(max(q, prefix_len - 1), Sk - 1) if causal else Sk - 1
        return max(hi - lo + 1, 0)

    kinks = {0, S}
    for k in (prefix_len - 1, window - 1, Sk - 1, Sk + window - 1):
        kinks.update((k, k + 1))
    edges = sorted(e for e in kinks if 0 <= e <= S)
    total = 0
    for a, e in zip(edges, edges[1:]):
        total += (keys(a) + keys(e - 1)) * (e - a) // 2
    return total


def fwd_cost(b: int, nh: int, nkv: int, S: int, Sk: int, hd: int, itemsize: int, *,
             causal: bool, window: int, prefix_len: int) -> Tuple[float, int]:
    """(operations, bytes) the forward needs: two products over the allowed
    pairs (2 flops a pair a head dim each); q, k, v read and o written
    once.  The bound's formula, and what the meta route books."""
    pairs = allowed_pairs(S, Sk, causal=causal, window=window, prefix_len=prefix_len)
    q_elems, kv_elems = b * nh * S * hd, b * nkv * Sk * hd
    return 4.0 * b * nh * pairs * hd, (q_elems + 2 * kv_elems + q_elems) * itemsize


def bwd_cost(b: int, nh: int, nkv: int, S: int, Sk: int, hd: int, itemsize: int, *,
             causal: bool, window: int, prefix_len: int) -> Tuple[float, int]:
    """(operations, bytes) the backward needs: five products of the allowed
    pairs x hd (2 flops each); q, k, v, o, dO and lse read once, dq, dk and
    dv written once."""
    pairs = allowed_pairs(S, Sk, causal=causal, window=window, prefix_len=prefix_len)
    q_elems, kv_elems = b * nh * S * hd, b * nkv * Sk * hd
    return (10.0 * b * nh * pairs * hd,
            (3 * q_elems + 4 * kv_elems + q_elems) * itemsize + 4 * b * nh * S)


def alignment_problem(name: str, data_ptr: int, shape: Sequence[int],
                      strides: Sequence[int], itemsize: int) -> Optional[str]:
    """Why TMA cannot read a (b, heads, seq, hd) tensor, or None: the head
    dim must have unit stride, and the base address and every (batch, head,
    seq) stride of a dim longer than 1 must be a multiple of 16 bytes."""
    if strides[3] != 1 and shape[3] > 1:
        return f"{name} needs a unit-stride head dim"
    if data_ptr % ALIGN:
        return f"{name}: base address {data_ptr:#x} is not a multiple of {ALIGN} bytes"
    for dim, what in ((2, "row"), (1, "head"), (0, "batch")):
        if shape[dim] > 1 and (strides[dim] * itemsize) % ALIGN:
            return (f"{name}: {what} stride of {strides[dim] * itemsize} bytes is not a "
                    f"multiple of {ALIGN} bytes")
    return None


def _tma_strides(t: torch.Tensor, head_dim: int) -> Tuple[int, int, int]:
    """(batch, head, seq) strides for the tensor map; a dim of size 1 is
    never stepped, so its stride is set to one that TMA accepts."""
    return tuple(s if n > 1 else head_dim for n, s in zip(t.shape[:3], t.stride()[:3]))


def _fn():
    if not _fn_cache:
        fn = _build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, p,
                       ctypes.c_float, i, i, i, ctypes.c_float, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def flash_attention(
    q: torch.Tensor,  # (b, nh, S, hd)
    k: torch.Tensor,  # (b, nkv, Sk, hd)
    v: torch.Tensor,  # (b, nkv, Sk, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix_len: int = 0,
    return_lse: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors; returns (b, nh, S, hd), and
    with ``return_lse`` also each row's log-sum-exp (b, nh, S) float32 for
    the backward (``LSE_EMPTY`` where a row has no allowed key)."""
    dev = launch_device("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, nh, S, hd), k / v (b, nkv, Sk, hd)")
    b, nh, S, hd = q.shape
    _, nkv, Sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} kv heads")
    code = _DTYPES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit-stride head dim")
    out = torch.empty((b, S, nh, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, nh, S), dtype=torch.float32, device=dev) if return_lse else None
    if dev.type == "meta":
        book("flash_attention", *fwd_cost(b, nh, nkv, S, Sk, hd, q.element_size(),
                                          causal=causal, window=window,
                                          prefix_len=prefix_len))
        return (out, lse) if return_lse else out
    plan = launch_plan(q.dtype, hd, batch=b, heads=nh, seq=S)
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = alignment_problem(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why:
            raise ValueError(f"flash_attention: {why}")
    strides = (ctypes.c_int64 * 12)(
        *_tma_strides(q, hd), *_tma_strides(k, hd), *_tma_strides(v, hd),
        *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), lse.data_ptr() if return_lse else None,
                   b, nh, nkv, S, Sk, hd, strides,
                   float(scale), int(causal), int(window), int(prefix_len),
                   float(softcap),
                   plan.width, plan.tile_k, plan.stages, plan.smem_bytes, stream)
    if rc in _ERRORS:
        raise RuntimeError(f"flash_attention: {_ERRORS[rc]} (error {rc})")
    check_launch("flash_attention", rc)
    launches.add()
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------- backward
#
# ``csrc/flash_attention_bwd.cu``: a dQ kernel (which also writes each row's
# lse and D = rowsum(dO * O) for the next), then a dK / dV kernel that sums
# the ``rep`` q heads of a kv head's group in registers, both TMA-fed with
# ``wgmma`` (bf16) or 3xTF32 ``mma.sync`` (float32) products, no atomics; where
# the grid would leave the card's SMs idle, the q heads and q tiles of a key
# tile (or the key tiles of a q tile) are split across CTAs that write
# float32 partials, summed in split order by a third small kernel.  No
# Pallas kernel has a backward: it is the port's counterpart of JAX's
# recompute under ``jax.checkpoint`` in
# ``repro.models.attention.blockwise_attention``.

#: launches of the CUDA backward (one per call: its two or three kernels)
bwd_launches = LaunchCounter("flash_attention_bwd")

#: the forward's lse of a row with no allowed key: its P is exp(s - 1e30) = 0
LSE_EMPTY = 1e30
WARPGROUP = 128
SMS = 132                    # H100 SXM: the plan's default SM count
MAX_SPLIT = 16               # CTAs that may share one tile's work
#: head-dim widths the backward is instantiated for, per element size; 80
#: (stablelm-3b) ends in a 16-column product, so no product multiplies padding
BWD_WIDTHS = {4: (32, 64, 80, 128, 256), 2: (64, 80, 128, 256)}
#: per (element size, width): dK / dV warpgroups (64 keys each), q rows a
#: step, stages, column halves; dQ warpgroups (64 q rows each), keys a step,
#: stages.  ``flash_attention_bwd.cu``'s ``dispatch`` instantiates each.
BWD_TILING = {
    (2, 64): (2, 64, 3, 1, 2, 64, 3),
    (2, 80): (2, 32, 4, 1, 2, 64, 3),
    (2, 128): (1, 64, 2, 1, 2, 64, 3),
    (2, 256): (1, 64, 2, 2, 1, 64, 2),
    (4, 32): (2, 64, 3, 1, 2, 64, 3),
    (4, 64): (2, 64, 2, 1, 2, 64, 2),
    (4, 80): (2, 32, 2, 1, 2, 64, 2),
    (4, 128): (1, 32, 2, 1, 2, 32, 2),
    (4, 256): (1, 16, 2, 2, 1, 16, 2),
}
_bwd_fn_cache = []


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """How the backward runs one call."""

    head_dim: int
    width: int               # instantiated head-dim width (the products' N)
    kv_warpgroups: int       # dK / dV CTA: consumer warpgroups, 64 keys each
    tile_q: int              # dK / dV CTA: q rows a step
    kv_stages: int           # dK / dV CTA: Q / dO tiles in flight
    col_split: int           # CTAs sharing a key tile's dK / dV columns
    q_warpgroups: int        # dQ CTA: consumer warpgroups, 64 q rows each
    tile_k: int              # dQ CTA: keys a step
    q_stages: int            # dQ CTA: K / V tiles in flight
    smem_kv: int             # dynamic shared memory of a dK / dV CTA
    smem_q: int              # dynamic shared memory of a dQ CTA
    split_kv: int            # CTAs sharing a key tile's (q head, q tile) list
    split_q: int             # CTAs sharing a q tile's key tiles
    grid_kv: Tuple[int, int, int]  # (key tiles x split_kv x col_split, kv heads, batch)
    grid_q: Tuple[int, int, int]   # (q tiles x split_q, heads, batch)

    @property
    def tile_kv(self) -> int:
        """keys of a dK / dV CTA"""
        return 64 * self.kv_warpgroups

    @property
    def tile_dq(self) -> int:
        """q rows of a dQ CTA"""
        return 64 * self.q_warpgroups

    @property
    def threads_kv(self) -> int:
        return _threads(self.kv_warpgroups)

    @property
    def threads_q(self) -> int:
        return _threads(self.q_warpgroups)

    def s_pad(self, seq: int) -> int:
        """q rows of the (lse, D) scratch: whole dQ tiles"""
        return -(-seq // self.tile_dq) * self.tile_dq

    def as_ints(self) -> Tuple[int, ...]:
        """the launcher's plan array"""
        return (self.kv_warpgroups, self.tile_q, self.kv_stages, self.col_split,
                self.q_warpgroups, self.tile_k, self.q_stages, self.smem_kv, self.smem_q,
                self.split_kv, self.split_q)


def _threads(warpgroups: int) -> int:
    """Consumer warpgroups and the producer: one warp beside one warpgroup,
    a whole warpgroup beside two (it hands its registers to them)."""
    return warpgroups * WARPGROUP + (WARPGROUP if warpgroups == 2 else 32)


def _smem_width(itemsize: int, width: int) -> int:
    slab = SLAB_BYTES // itemsize
    return -(-width // slab) * slab


def bwd_smem(itemsize: int, width: int, kv_wg: int, tile_q: int, kv_stages: int,
             q_wg: int, tile_k: int, q_stages: int) -> Tuple[int, int]:
    """(dK / dV, dQ) dynamic shared memory: the resident tiles, the stages,
    (lse, D) pairs or D, the mbarriers, 1024 bytes of alignment slack."""
    row = _smem_width(itemsize, width) * itemsize
    kv = (2 * 64 * kv_wg * row + kv_stages * (2 * tile_q * row + 8 * tile_q)
          + 8 * (1 + 2 * kv_stages) + 1024)
    q = (2 * 64 * q_wg * row + q_stages * 2 * tile_k * row + 4 * 64 * q_wg
         + 8 * (1 + 2 * q_stages) + 1024)
    return kv, q


def _split(base: int, most: int, sms: int) -> int:
    """CTAs to cut each of ``base`` units of work into (at most ``most``,
    ``MAX_SPLIT``): none where the units fill the ``sms`` SMs (partials cost
    a write and a read of each gradient per split), else the fewest waves
    for the time a unit takes, ceil(base s / sms) / s, ties to the smaller
    split."""
    if base >= sms:
        return 1
    best, cost = 1, 1.0
    for s in range(2, max(1, min(most, MAX_SPLIT)) + 1):
        c = -(-base * s // sms) / s
        if c < cost - 1e-9:
            best, cost = s, c
    return best


@functools.lru_cache(maxsize=256)
def bwd_launch_plan(dtype: torch.dtype, head_dim: int, *, batch: int = 1, heads: int = 1,
                    kv_heads: int = 1, seq: int = 1, kv_seq: int = 1,
                    sms: int = SMS) -> FlashBwdPlan:
    """The backward's launch plan on a card of ``sms`` SMs; raises
    ``ValueError`` naming what the design cannot take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, got {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} is not a multiple of 8 in 8..{MAX_HEAD_DIM}: "
                         "the tensor-core tiles take the head dim 8 at a time")
    width = next(w for w in BWD_WIDTHS[itemsize] if w >= head_dim)
    kv_wg, tile_q, kv_stages, col_split, q_wg, tile_k, q_stages = BWD_TILING[(itemsize, width)]
    smem_kv, smem_q = bwd_smem(itemsize, width, kv_wg, tile_q, kv_stages, q_wg, tile_k,
                               q_stages)
    if max(smem_kv, smem_q) > SMEM_PER_BLOCK:
        raise ValueError(f"head dim {head_dim}: the backward's tiles need "
                         f"{max(smem_kv, smem_q)} bytes")
    n_kt, n_qt = -(-kv_seq // (64 * kv_wg)), -(-seq // (64 * q_wg))
    base_kv = n_kt * kv_heads * batch * col_split
    split_kv = _split(base_kv, heads // kv_heads * -(-seq // tile_q), sms)
    split_q = _split(n_qt * heads * batch, -(-kv_seq // tile_k), sms)
    return FlashBwdPlan(head_dim=head_dim, width=width, kv_warpgroups=kv_wg, tile_q=tile_q,
                        kv_stages=kv_stages, col_split=col_split, q_warpgroups=q_wg,
                        tile_k=tile_k, q_stages=q_stages, smem_kv=smem_kv, smem_q=smem_q,
                        split_kv=split_kv, split_q=split_q,
                        grid_kv=(n_kt * split_kv * col_split, kv_heads, batch),
                        grid_q=(n_qt * split_q, heads, batch))


def bwd_q_tiles(k0: int, k_last: int, S: int, tile_q: int, *, causal: bool, window: int,
                prefix_len: int) -> range:
    """The q tiles of ``tile_q`` rows that the dK / dV kernel walks for keys
    ``k0 .. k_last``: those with an allowed pair, the forward's walk
    transposed (a row's allowed keys are (q - window, max(q, prefix_len -
    1)], both ends growing with q, so the tiles are a range)."""
    n = -(-S // tile_q)
    lo, hi = 0, n
    if causal and k0 > prefix_len - 1:
        lo = k0 // tile_q if k0 < S else n
    if window > 0:
        hi = min(hi, (k_last + window - 1) // tile_q + 1)
    return range(lo, max(lo, hi))


def _bwd_fn():
    if not _bwd_fn_cache:
        lib = _build.load("flash_attention_bwd")
        fn = lib.flash_attention_bwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p,
                       f, i, i, i, f, i, i, p, p]
        fn.restype = ctypes.c_int
        occ = lib.flash_attention_bwd_occupancy
        occ.argtypes = [i, i, p]
        occ.restype = ctypes.c_int
        _bwd_fn_cache.extend((fn, occ))
    return _bwd_fn_cache[0]


def bwd_occupancy(dtype: torch.dtype, head_dim: int) -> dict:
    """Per kernel of the backward's instantiation for ``head_dim``: CTAs an
    SM, registers a thread and spilled bytes, as the CUDA runtime reports
    them (the card's current device)."""
    plan = bwd_launch_plan(dtype, head_dim)
    _bwd_fn()
    out = (ctypes.c_int * 6)()
    rc = _bwd_fn_cache[1](_DTYPES[dtype], plan.width, out)
    check_launch("flash_attention_bwd_occupancy", rc)
    return {"dq": {"ctas_per_sm": out[0], "registers": out[1], "spill_bytes": out[2]},
            "dkv": {"ctas_per_sm": out[3], "registers": out[4], "spill_bytes": out[5]}}


def flash_attention_bwd(
    q: torch.Tensor,    # (b, nh, S, hd)
    k: torch.Tensor,    # (b, nkv, Sk, hd)
    v: torch.Tensor,    # (b, nkv, Sk, hd)
    o: torch.Tensor,    # (b, nh, S, hd): the forward's output
    do: torch.Tensor,   # (b, nh, S, hd): its gradient
    lse: torch.Tensor,  # (b, nh, S) float32: the forward's row log-sum-exp
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward on CUDA tensors; returns (dq, dk, dv) shaped
    like q, k, v (views of the model's (b, s, heads, hd) layout), in their
    dtype.  q, k, v and dO are read by TMA and o by 16-byte loads: any
    (batch, head, seq) strides that are multiples of 16 bytes with a
    unit-stride head dim."""
    dev = launch_device("flash_attention_bwd", q, k, v, o, do, lse)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, nh, S, hd), k / v (b, nkv, Sk, hd)")
    b, nh, S, hd = q.shape
    _, nkv, Sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must be shaped "
                         f"like q {tuple(q.shape)}")
    if tuple(lse.shape) != (b, nh, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 (b, nh, S) = {(b, nh, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} kv heads")
    code = _DTYPES.get(q.dtype)
    if code is None or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"q, k, v, o, dO must share float32 or bfloat16, got "
                        f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    dq = torch.empty((b, S, nh, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, Sk, nkv, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((b, Sk, nkv, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    if dev.type == "meta":
        book("flash_attention_bwd", *bwd_cost(b, nh, nkv, S, Sk, hd, q.element_size(),
                                              causal=causal, window=window,
                                              prefix_len=prefix_len))
        return dq, dk, dv
    plan = bwd_launch_plan(q.dtype, hd, batch=b, heads=nh, kv_heads=nkv, seq=S, kv_seq=Sk,
                           sms=sm_count(dev))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do)):
        why = alignment_problem(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why:
            raise ValueError(f"flash_attention_bwd: {why}")
    s_pad = plan.s_pad(S)
    ld = torch.empty((b, nh, s_pad, 2), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq_part = torch.empty((plan.split_q, b, nh, S, hd), **f32) if plan.split_q > 1 else None
    dk_part, dv_part = ((torch.empty((plan.split_kv, b, nkv, Sk, hd), **f32) for _ in "kv")
                        if plan.split_kv > 1 else (None, None))
    ptr = [t.data_ptr() if t is not None else None for t in (dq_part, dk_part, dv_part)]
    strides = (ctypes.c_int64 * 24)(
        *(s for t in (q, k, v) for s in _tma_strides(t, hd)), *o.stride()[:3],
        *_tma_strides(do, hd), *(s for t in (dq, dk, dv) for s in t.stride()[:3]))
    plan_ints = (ctypes.c_int * 11)(*plan.as_ints())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       lse.data_ptr(), ld.data_ptr(), *ptr, b, nh, nkv, S, Sk, hd, strides,
                       float(scale), int(causal), int(window), int(prefix_len),
                       float(softcap), plan.width, s_pad, plan_ints, stream)
    if rc in _ERRORS:
        raise RuntimeError(f"flash_attention_bwd: {_ERRORS[rc]} (error {rc})")
    check_launch("flash_attention_bwd", rc)
    bwd_launches.add()
    return dq, dk, dv
