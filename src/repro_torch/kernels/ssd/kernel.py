"""ctypes binding of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``: chunks
in parallel, ``wgmma`` for bf16 and 3xTF32 ``mma.sync`` for float32).

Replaces the Pallas TPU kernel ``repro.kernels.ssd.ssd_scan``.  x, B and C
may be strided views (the mixer slices them out of one ``xBC`` activation)
as long as their last dim has unit stride and their base and strides are
multiples of 16 bytes; nothing is copied.  x, B and C are float32 or
bfloat16 alike, dt, A and D float32; y comes back in x's dtype, the final
state in float32.

One call enqueues three CUDA kernels (chunk states, state passing, chunk
scan), float32 a fourth before them (C.B^T once per chunk); ``launches``
counts calls.  ``launch_plan`` is the launch plan in plain Python (padded
widths, row tiles, grids, shared memory), so that the CPU tests reach it;
the launcher refuses a plan that differs from its instantiations.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from ... import _build
from .._launch import LaunchCounter, check_launch, require_cuda
from .ref import check_length

#: launches of the op, counted where it launches its kernels
launches = LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 4096
SCAN_TOTALS = MAX_CHUNK // 16 + 16   # the prefix sum's block totals (kScanTotals)
TILE = 64                    # rows of a tile; the head dim is padded to it
THREADS = 128                # one warpgroup
PASS_THREADS = 256           # the state-passing kernel
ALIGN = 16                   # cp.async: 16-byte copies
SMEM_PER_BLOCK = 232_448     # H100: the most one block may opt in to
STATE_PADS = (64, 128)       # instantiated widths of ds
KERNELS_PER_CALL = {torch.bfloat16: 3, torch.float32: 4}
_ERRORS = {10003: "the launch plan matches no instantiation of the kernel"}
_fn_cache = []


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """How the kernels run one call."""

    head_dim: int
    state: int
    chunk: int
    head_pad: int            # head dim zero-padded in shared memory
    state_pad: int           # ds zero-padded (the instantiated width)
    row_tiles: int           # 64-row tiles of a chunk
    chunk_pad: int           # row_tiles x 64
    chunks: int
    smem_state: int          # dynamic shared memory of a chunk-state CTA
    smem_scan: int           # ... of a chunk-scan CTA
    smem_cb: int             # ... of a float32 C.B^T CTA (0 for bf16)
    kernels: int             # CUDA kernels a call enqueues
    grid_cb: Tuple[int, int]             # float32: (batch x chunks, tile pairs)
    grid_state: Tuple[int, int, int]     # (batch x chunks, heads, ds splits)
    grid_pass: Tuple[int, int, int]      # (hd ds / 1024, heads, batch)
    grid_scan: Tuple[int, int, int]      # (batch x chunks, heads, row tiles)
    threads: int = THREADS

    @property
    def ctas(self) -> int:
        """CTAs of the largest kernel, the chunk scan."""
        x, y, z = self.grid_scan
        return x * y * z


def _tile_bytes(itemsize: int, width: int) -> int:
    return TILE * width * itemsize   # a 64-row tile of 128-byte slabs


def _smem(itemsize: int, state_pad: int, chunk: int) -> Tuple[int, int, int]:
    """Shared memory of a chunk-state, chunk-scan and float32 C.B^T CTA."""
    x = _tile_bytes(itemsize, TILE)
    bt = _tile_bytes(itemsize, state_pad)
    # the chunk-state kernel's ring of x and B tiles (a float32 CTA takes 64
    # of the ds columns), dt and cs of the chunk, the prefix sum's totals
    stages, state_b = (4, bt) if itemsize == 2 else (2, _tile_bytes(itemsize, TILE))
    state = stages * (x + state_b) + 8 * chunk + 4 * SCAN_TOTALS + 1024
    # C_i, stage 0 (B_j for bf16, x_j), then a region that holds the
    # entering state (bf16: hi and lo tiles) before it holds stage 1
    s_tiles, stage = (2, bt + x) if itemsize == 2 else (1, x)
    scan = bt + stage + max(s_tiles * bt, stage) + 7 * TILE * 4 + 1024
    cb = 0 if itemsize == 2 else 2 * bt + 1024
    return state, scan, cb


@functools.lru_cache(maxsize=256)
def launch_plan(dtype: torch.dtype, head_dim: int, state: int, chunk: int, *,
                batch: int = 1, heads: int = 1, seq: Optional[int] = None) -> SsdPlan:
    """The launch plan for ``dtype`` (float32 or bfloat16) at head dim
    ``head_dim``, state size ``state`` and ``chunk`` rows (``seq`` defaults
    to one chunk); raises ``ValueError`` naming what the design cannot take."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} is not a multiple of 8 in 8..{MAX_HEAD_DIM}: "
                         "x is staged 16 bytes at a time into a 64-wide tile")
    if state % 8 or not 8 <= state <= MAX_STATE:
        raise ValueError(f"state size {state} is not a multiple of 8 in 8..{MAX_STATE}: "
                         "B and C are staged 16 bytes at a time into a 64- or 128-wide tile")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    seq = chunk if seq is None else seq
    if seq % chunk:
        raise ValueError(f"sequence length {seq} is not a multiple of the SSD chunk {chunk}")
    if not 0 < batch <= 65535 or not 0 < heads <= 65535:
        raise ValueError(f"batch {batch} or heads {heads} outside 1..65535 (grid limits)")
    itemsize = torch.empty((), dtype=dtype).element_size()
    state_pad = next(w for w in STATE_PADS if w >= state)
    smem_state, smem_scan, smem_cb = _smem(itemsize, state_pad, chunk)
    if max(smem_state, smem_scan, smem_cb) > SMEM_PER_BLOCK:  # not reached by the sizes above
        raise ValueError(f"no tiling fits {SMEM_PER_BLOCK} bytes of shared memory")
    chunks = seq // chunk
    row_tiles = -(-chunk // TILE)
    return SsdPlan(head_dim=head_dim, state=state, chunk=chunk, head_pad=TILE,
                   state_pad=state_pad, row_tiles=row_tiles, chunk_pad=row_tiles * TILE,
                   chunks=chunks, smem_state=smem_state, smem_scan=smem_scan,
                   smem_cb=smem_cb, kernels=KERNELS_PER_CALL[dtype],
                   grid_cb=(batch * chunks, row_tiles * (row_tiles + 1) // 2 if smem_cb else 0),
                   grid_state=(batch * chunks, heads, 1 if itemsize == 2 else state_pad // TILE),
                   grid_pass=(-(-head_dim * state // (4 * PASS_THREADS)), heads, batch),
                   grid_scan=(batch * chunks, heads, row_tiles))


def alignment_problem(name: str, data_ptr: int, shape: Sequence[int],
                      strides: Sequence[int], itemsize: int) -> Optional[str]:
    """Why the 16-byte copies cannot read x (b, l, nh, hd) or B / C (b, l,
    ds), or None: the last dim must have unit stride, and the base address
    and every other stride of a dim longer than 1 must be a multiple of 16
    bytes."""
    if strides[-1] != 1 and shape[-1] > 1:
        return f"{name} needs a unit-stride last dim"
    if data_ptr % ALIGN:
        return f"{name}: base address {data_ptr:#x} is not a multiple of {ALIGN} bytes"
    for dim in range(len(shape) - 1):
        if shape[dim] > 1 and (strides[dim] * itemsize) % ALIGN:
            return (f"{name}: stride of dim {dim}, {strides[dim] * itemsize} bytes, is not "
                    f"a multiple of {ALIGN} bytes")
    return None


def _fn():
    if not _fn_cache:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 13 + [i] * 6 + [p, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def _check(x, dt, A, B, C, D) -> None:
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("expected x (b, l, nh, hd), dt (b, l, nh), B / C (b, l, ds)")
    b, l, nh, hd = x.shape
    if (tuple(dt.shape) != (b, l, nh) or B.shape[:2] != (b, l) or C.shape != B.shape
            or tuple(A.shape) != (nh,) or tuple(D.shape) != (nh,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit-stride last dim")
    for name, t in (("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan(
    x: torch.Tensor,   # (b, l, nh, hd)
    dt: torch.Tensor,  # (b, l, nh)
    A: torch.Tensor,   # (nh,)
    B: torch.Tensor,   # (b, l, ds)
    C: torch.Tensor,   # (b, l, ds)
    D: torch.Tensor,   # (nh,)
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernels on CUDA tensors; returns (y (b, l, nh, hd) in
    x's dtype, final state (b, nh, hd, ds) float32)."""
    y, state, _ = ssd_scan_with_prefix_sums(x, dt, A, B, C, D, chunk=chunk)
    return y, state


def ssd_scan_with_prefix_sums(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    D: torch.Tensor, *, chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_scan``, and the chunk prefix sums cs (b, chunks, nh, chunk) float32
    that its chunk-state kernel computed, to hold their order to the plain
    version's ``prefix_sum`` bit for bit."""
    dev = require_cuda("ssd_scan", x, dt, A, B, C, D)
    _check(x, dt, A, B, C, D)
    b, l, nh, hd = x.shape
    ds = B.shape[2]
    chunk = check_length(l, chunk)
    plan = launch_plan(x.dtype, hd, ds, chunk, batch=b, heads=nh, seq=l)
    for name, t in (("x", x), ("B", B), ("C", C)):
        why = alignment_problem(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why:
            raise ValueError(f"ssd_scan: {why}")
    nc = plan.chunks
    y = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    state = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=dev)
    # scratch: cs and v per chunk row; the chunk states and the states
    # entering each chunk (float32, or bf16 hi and lo planes)
    cs, v = torch.empty((2, b, nc, nh, chunk), dtype=torch.float32, device=dev)
    states, s_in = torch.empty((2, b, nc, nh, hd, ds), dtype=torch.float32, device=dev)
    # float32: C.B^T per (batch x chunk, tile pair), 64 x 64
    cbt = (torch.empty((b * nc, plan.grid_cb[1], TILE * TILE), dtype=torch.float32,
                       device=dev) if plan.smem_cb else None)
    strides = (ctypes.c_int64 * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                   B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
                   state.data_ptr(), cs.data_ptr(), v.data_ptr(), states.data_ptr(),
                   s_in.data_ptr(), cbt.data_ptr() if cbt is not None else None,
                   b, l, nh, hd, ds, chunk, strides, plan.state_pad,
                   plan.smem_state, plan.smem_scan, stream)
    if rc in _ERRORS:
        raise RuntimeError(f"ssd_scan: {_ERRORS[rc]} (error {rc})")
    check_launch("ssd_scan", rc)
    launches.add()
    return y, state, cs
