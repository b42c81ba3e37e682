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

The backward (``csrc/ssd_scan_bwd.cu``, ``ssd_scan_bwd``) takes the
forward's prefix sums and entering states (``ssd_scan_for_grad``) and
enqueues five kernels a call, float32 six (each chunk's own state
gradient, the reverse state pass, float32's C.B^T once per chunk, the chunk
gradients per 64-row tile and group of heads on the tensor cores, dL/da and
ddt per chunk, the ordered sums over head groups, batch and chunks);
``bwd_launches`` counts its calls, ``bwd_launch_plan`` is its plan and
``bwd_occupancy`` reads its chunk kernel's occupancy from the runtime.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from ... import _build
from .._launch import LaunchCounter, book, check_launch, launch_device
from .ref import check_length

#: launches of the op, counted where it launches its kernels
launches = LaunchCounter("ssd_scan")
#: launches of the backward
bwd_launches = LaunchCounter("ssd_scan_bwd")

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
_bwd_fn_cache = []


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


def scan_cost(b: int, l: int, nh: int, hd: int, ds: int, chunk: int,
              itemsize: int) -> Tuple[float, int]:
    """(operations, bytes) the scan needs: the causal half of C.B^T once
    per (batch, chunk), as every head shares B and C; per (batch, head,
    chunk) the causal half of the scores x dt.x product, and the C.state
    and state update products (the kernel recomputes C.B^T for every head);
    x, B, C, dt, A, D read and y and the final state written once.  The
    bound's formula, and what the meta route books."""
    c = min(chunk, l)
    ops = (float(b * (l // c)) * c * (c + 1) * ds
           + float(b * nh * (l // c)) * (c * (c + 1) * hd + 4 * c * hd * ds))
    d_in, e = nh * hd, itemsize
    return ops, (2 * b * l * d_in * e + 2 * b * l * ds * e + 4 * b * l * nh
                 + 2 * 4 * nh + 4 * b * nh * hd * ds)


def bwd_cost(b: int, l: int, nh: int, hd: int, ds: int, chunk: int,
             itemsize: int) -> Tuple[float, int]:
    """(operations, bytes) the backward needs: the causal half of C.B^T once
    per (batch, chunk); per (batch, chunk, head) the causal half of dy.x^T,
    M^T dy, N^T C and N B and four (c x hd x ds) state products; each input
    read once (x, dy, B, C, dt, A, D, the state's gradient), each gradient
    written once."""
    c = min(chunk, l)
    pairs = c * (c + 1) / 2
    ops = (float(b * (l // c)) * 2 * pairs * ds
           + float(b * (l // c) * nh) * (2 * pairs * (2 * hd + 2 * ds) + 8 * c * hd * ds))
    d_in, e = nh * hd, itemsize
    return ops, (3 * b * l * d_in * e + 4 * b * l * ds * e + 2 * 4 * b * l * nh + 4 * 4 * nh
                 + 4 * b * nh * hd * ds)


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
    y, state, _, _ = ssd_scan_for_grad(x, dt, A, B, C, D, chunk=chunk)
    return y, state


def ssd_scan_for_grad(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    D: torch.Tensor, *, chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_scan``, and what the backward takes from it: the chunk prefix
    sums cs (b, chunks, nh, chunk) float32 that its chunk-state kernel
    computed (in the plain version's ``prefix_sum`` order, bit for bit), and
    the states entering each chunk as the chunk scan read them, a (b,
    chunks, nh, hd, ds) float32 buffer holding float32 states or, for
    bfloat16 inputs, their hi and lo bf16 planes (b, chunks, nh, 2, hd, ds)."""
    dev = launch_device("ssd_scan", x, dt, A, B, C, D)
    _check(x, dt, A, B, C, D)
    b, l, nh, hd = x.shape
    ds = B.shape[2]
    chunk = check_length(l, chunk)
    nc = l // chunk
    y = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    state = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=dev)
    # scratch: cs and v per chunk row; the chunk states and the states
    # entering each chunk (float32, or bf16 hi and lo planes).  Each its own
    # allocation: the backward keeps cs and s_in alive, not the rest
    cs = torch.empty((b, nc, nh, chunk), dtype=torch.float32, device=dev)
    states = torch.empty((b, nc, nh, hd, ds), dtype=torch.float32, device=dev)
    s_in = torch.empty_like(states)
    if dev.type == "meta":
        book("ssd_scan", *scan_cost(b, l, nh, hd, ds, chunk, x.element_size()))
        return y, state, cs, s_in
    plan = launch_plan(x.dtype, hd, ds, chunk, batch=b, heads=nh, seq=l)
    for name, t in (("x", x), ("B", B), ("C", C)):
        why = alignment_problem(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why:
            raise ValueError(f"ssd_scan: {why}")
    v = torch.empty_like(cs)
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
    return y, state, cs, s_in


# ------------------------------------------------------------------ backward

BWD_MAX_CHUNK = 1024                 # the finish kernel's scans: 8 rows a thread
BWD_STATE_PADS = STATE_PADS          # instantiated widths of ds
BWD_KERNELS_PER_CALL = {torch.bfloat16: 5, torch.float32: 6}
BWD_PASS_THREADS = 256               # the pass (4 state elements a thread) and the reduce
BWD_MAX_GROUP = 4                    # heads a chunk-gradient CTA takes at most
SMS = 132                            # H100 SXM
SMEM_PER_SM = 233_472                # the SM's 228 KB, 1 KB of it reserved per CTA
#: chunk-gradient CTAs an SM: __launch_bounds__(128, 2) caps the registers
#: at 255 a thread, and ``bwd_smem`` keeps the shared memory under half
BWD_CTAS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    """How the backward's kernels run one call."""

    head_dim: int
    state: int
    chunk: int
    state_pad: int           # ds zero-padded (the instantiated width)
    row_tiles: int           # 64-row tiles of a chunk
    chunks: int
    head_group: int          # heads a chunk-gradient CTA takes, one after another
    groups: int              # head groups: the dB / dC partials summed by the reduce
    smem_chunk: int          # dynamic shared memory of a chunk-gradient CTA
    smem_local: int          # ... of a local-state CTA
    ctas_per_sm: int         # chunk-gradient CTAs an SM
    grid_local: Tuple[int, int]          # (batch x chunks, heads)
    grid_pass: Tuple[int, int, int]      # (hd ds / 1024, heads, batch)
    grid_cb: Tuple[int, int, int]        # float32: (batch x chunks, tile pairs, 2)
    grid_chunk: Tuple[int, int, int]     # (batch x chunks, head groups, row tiles)
    grid_finish: Tuple[int, int]         # (batch x chunks, heads)
    grid_reduce: Tuple[int]              # (batch x seq x ds / 256,)
    scratch_bytes: int       # every scratch buffer of a call (``bwd_scratch``)
    products: float          # tensor-core operations the kernels issue a call
    kernels: int             # CUDA kernels a call enqueues
    threads: int = THREADS

    @property
    def ctas(self) -> int:
        """CTAs of the largest kernel, the chunk gradients."""
        x, y, z = self.grid_chunk
        return x * y * z

    @property
    def waves(self) -> float:
        """Chunk-gradient CTAs over the card's slots for them."""
        return self.ctas / (SMS * self.ctas_per_sm)


def bwd_smem(itemsize: int, state_pad: int) -> Tuple[int, int]:
    """Shared memory of a chunk-gradient and a local-state CTA (the source's
    ``BwdTiles``): 64-row tiles in the input's dtype, 128-byte slabs.  The
    chunk CTA: the fixed pair (x or dy, B or C), a ring of such pairs (bf16
    two stages, float32 one), bf16's two state planes (float32's state lies
    over stage 0), cs and dt of the fixed tile and of each stage, the 4
    warps' column sums and a block-sum scratch, 1 KiB of alignment.  The
    local CTA: a ring of (dy, C) pairs (bf16 three, float32 two) with their
    cs."""
    h, sb = _tile_bytes(itemsize, TILE), _tile_bytes(itemsize, state_pad)
    pair = h + sb
    bf = itemsize == 2
    stages = 2 if bf else 1
    tiles = (1 + stages) * pair + (2 * sb if bf else 0)
    row_floats = 2 * TILE + 2 * stages * TILE + 4 * TILE + 32
    local_stages = 3 if bf else 2
    return tiles + 4 * row_floats + 1024, local_stages * (pair + 4 * TILE) + 1024


def bwd_scratch(batch: int, chunks: int, heads: int, head_dim: int, state: int, chunk: int,
                groups: int, itemsize: int) -> Dict[str, int]:
    """float32 elements of each scratch buffer, in the order they are cut
    from one allocation (each rounded up to 16 bytes): each chunk's own
    state gradient, the gradient of the state leaving it (bf16: its hi and
    lo planes, the same bytes), the pass blocks' parts of <dS_out, S_in>,
    U, V and each row tile's straddle sums per row, each column tile's dy.x,
    the head groups' dB and dC partials, the per-chunk dA and dD terms, and
    for float32 C.B^T and its transpose per tile pair."""
    n = batch * chunks * heads
    tiles = -(-chunk // TILE)
    npass = -(-head_dim * state // (4 * BWD_PASS_THREADS))
    sizes = {"local": n * head_dim * state, "dsout": n * head_dim * state,
             "pE": n * npass, "rows": n * (2 + tiles) * chunk, "pDt": n * tiles,
             "pB": batch * chunks * groups * chunk * state,
             "pC": batch * chunks * groups * chunk * state, "pA": n, "pD": n,
             "cbt": 0 if itemsize == 2 else batch * chunks * tiles * (tiles + 1) * TILE * TILE}
    return {k: -(-v // 4) * 4 for k, v in sizes.items()}


def bwd_products(itemsize: int, batch: int, chunks: int, heads: int, state_pad: int,
                 chunk: int) -> float:
    """Tensor-core operations (2 per multiply-add) the kernels issue a call,
    at the padded widths (hd 64, ds ``state_pad``) and whole 64-row tiles:
    per head and causal tile pair dy.x^T twice (its column and its row
    tile's CTA), M^T dy, N^T C and N B once, and C.B^T twice (bf16: per head;
    float32: per chunk, in both orientations); per head and tile the
    outgoing state's two products and the incoming state's one; the local
    state per chunk but the first.  bf16 counts each split operand's two
    products and S_in's two planes; float32 each 3xTF32 product three times."""
    t = -(-chunk // TILE)
    pairs = t * (t + 1) // 2
    mm = 2 * TILE * TILE                 # a 64 x 64 output, per unit of K
    cb, dx = mm * state_pad, mm * TILE
    per_pair = 2 * dx + dx + 2 * mm * state_pad
    if itemsize == 2:
        per_pair += 2 * cb
        per_tile, local, scale, per_chunk = 2 * (cb + mm * state_pad) + 2 * mm * state_pad, 2, 1, 0
    else:
        per_tile, local, scale, per_chunk = cb + 2 * mm * state_pad, 1, 3, 2 * pairs * cb
    local_ops = local * 2 * TILE * state_pad * t * TILE
    per_head = pairs * per_pair + t * per_tile
    return float(scale * batch * (heads * (chunks * per_head + (chunks - 1) * local_ops)
                                  + chunks * per_chunk))


def _head_group(tile_ctas: int, heads: int) -> int:
    """The largest group of heads (4, 2, 1) that still leaves two full waves
    of chunk-gradient CTAs; 1 where none does."""
    for g in (BWD_MAX_GROUP, 2):
        if tile_ctas * -(-heads // g) >= 2 * SMS * BWD_CTAS_PER_SM:
            return g
    return 1


@functools.lru_cache(maxsize=256)
def bwd_launch_plan(dtype: torch.dtype, head_dim: int, state: int, chunk: int, *,
                    batch: int = 1, heads: int = 1, seq: Optional[int] = None) -> SsdBwdPlan:
    """The backward's launch plan; raises ``ValueError`` naming what the
    design cannot take (the forward's widths, chunks up to
    ``BWD_MAX_CHUNK``)."""
    if not 0 < chunk <= BWD_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{BWD_MAX_CHUNK} for the backward: its "
                         "finish kernel scans the chunk's rows 8 a thread")
    fwd = launch_plan(dtype, head_dim, state, chunk, batch=batch, heads=heads, seq=seq)
    itemsize = torch.empty((), dtype=dtype).element_size()
    state_pad = next(w for w in BWD_STATE_PADS if w >= state)
    smem_chunk, smem_local = bwd_smem(itemsize, state_pad)
    if BWD_CTAS_PER_SM * (smem_chunk + 1024) > SMEM_PER_SM:  # not reached by the sizes above
        raise ValueError(f"the chunk CTA's {smem_chunk} bytes leave no two CTAs an SM")
    chunks, tiles = fwd.chunks, fwd.row_tiles
    group = _head_group(batch * chunks * tiles, heads)
    groups = -(-heads // group)
    scratch = bwd_scratch(batch, chunks, heads, head_dim, state, chunk, groups, itemsize)
    return SsdBwdPlan(head_dim=head_dim, state=state, chunk=chunk, state_pad=state_pad,
                      row_tiles=tiles, chunks=chunks, head_group=group, groups=groups,
                      smem_chunk=smem_chunk, smem_local=smem_local,
                      ctas_per_sm=BWD_CTAS_PER_SM, grid_local=(batch * chunks, heads),
                      grid_pass=(-(-head_dim * state // (4 * BWD_PASS_THREADS)), heads, batch),
                      grid_cb=(batch * chunks, tiles * (tiles + 1) // 2 if itemsize == 4 else 0, 2),
                      grid_chunk=(batch * chunks, groups, tiles),
                      grid_finish=(batch * chunks, heads),
                      grid_reduce=(-(-batch * chunks * chunk * state // BWD_PASS_THREADS),),
                      scratch_bytes=4 * sum(scratch.values()),
                      products=bwd_products(itemsize, batch, chunks, heads, state_pad, chunk),
                      kernels=BWD_KERNELS_PER_CALL[dtype])


def _bwd_fn():
    if not _bwd_fn_cache:
        lib = _build.load("ssd_scan_bwd")
        fn, occ = lib.ssd_scan_bwd, lib.ssd_scan_bwd_occupancy
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 26 + [i] * 6 + [p, i, i, i, i, p]
        occ.argtypes = [i, i, p]
        fn.restype = occ.restype = ctypes.c_int
        _bwd_fn_cache.extend((fn, occ))
    return _bwd_fn_cache[0]


def bwd_occupancy(dtype: torch.dtype, state: int) -> dict:
    """The chunk-gradient kernel of the instantiation for ``state``: CTAs an
    SM, registers a thread and spilled bytes, as the CUDA runtime reports
    them (the card's current device)."""
    plan = bwd_launch_plan(dtype, 64, state, 256)
    _bwd_fn()
    out = (ctypes.c_int * 3)()
    rc = _bwd_fn_cache[1](_DTYPES[dtype], plan.state_pad, out)
    check_launch("ssd_scan_bwd_occupancy", rc)
    return {"ctas_per_sm": out[0], "registers": out[1], "spill_bytes": out[2]}


def ssd_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    D: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor], cs: torch.Tensor,
    s_in: torch.Tensor, *, chunk: int = 256,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward on CUDA tensors: (dx, ddt, dA, dB, dC, dD) of
    ``ssd_scan`` at (x, dt, A, B, C, D) given dy (b, l, nh, hd) contiguous in
    x's dtype and the final state's gradient ``dstate`` (b, nh, hd, ds)
    float32 or None (zero), with ``cs`` and ``s_in`` from
    ``ssd_scan_for_grad``.  dx, dB and dC come back in x's dtype as views of
    one (b, l, nh hd + 2 ds) buffer, laid out as the mixer's xBC; ddt, dA and
    dD in float32."""
    extra = () if dstate is None else (dstate,)
    dev = launch_device("ssd_scan_bwd", x, dt, A, B, C, D, dy, cs, s_in, *extra)
    _check(x, dt, A, B, C, D)
    b, l, nh, hd = x.shape
    ds = B.shape[2]
    chunk = check_length(l, chunk)
    nc = l // chunk
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dstate is not None and (tuple(dstate.shape) != (b, nh, hd, ds)
                               or dstate.dtype != torch.float32 or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be contiguous float32 {(b, nh, hd, ds)}")
    for name, t, shape in (("cs", cs, (b, nc, nh, chunk)), ("s_in", s_in, (b, nc, nh, hd, ds))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be the forward's contiguous float32 {shape}")
    d_in = nh * hd
    grads = torch.empty((b, l, d_in + 2 * ds), dtype=x.dtype, device=dev)
    dx = grads[..., :d_in].view(b, l, nh, hd)
    dB, dC = grads[..., d_in:d_in + ds], grads[..., d_in + ds:]
    ddt = torch.empty((b, l, nh), dtype=torch.float32, device=dev)
    dA = torch.empty((nh,), dtype=torch.float32, device=dev)
    dD = torch.empty_like(dA)
    if dev.type == "meta":
        book("ssd_scan_bwd", *bwd_cost(b, l, nh, hd, ds, chunk, x.element_size()))
        return dx, ddt, dA, dB, dC, dD
    plan = bwd_launch_plan(x.dtype, hd, ds, chunk, batch=b, heads=nh, seq=l)
    for name, t in (("x", x), ("B", B), ("C", C)):
        why = alignment_problem(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why:
            raise ValueError(f"ssd_scan_bwd: {why}")
    sizes = bwd_scratch(b, nc, nh, hd, ds, chunk, plan.groups, x.element_size())
    scratch = torch.empty((sum(sizes.values()),), dtype=torch.float32, device=dev)
    parts = dict(zip(sizes, scratch.split(list(sizes.values()))))
    strides = (ctypes.c_int64 * 17)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2], *dx.stride()[:3],
        *dB.stride()[:2], *dC.stride()[:2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_fn()(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), D.data_ptr(), dy.data_ptr(),
                       dstate.data_ptr() if dstate is not None else None, cs.data_ptr(),
                       s_in.data_ptr(), *(parts[k].data_ptr() for k in ("local", "dsout", "pE",
                                                                        "rows", "pDt")),
                       dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                       dC.data_ptr(), dD.data_ptr(),
                       *(parts[k].data_ptr() for k in ("pB", "pC", "pA", "pD")),
                       parts["cbt"].data_ptr() if sizes["cbt"] else None,
                       b, l, nh, hd, ds, chunk, strides, plan.state_pad, plan.head_group,
                       plan.smem_chunk, plan.smem_local, stream)
    if rc in _ERRORS:
        raise RuntimeError(f"ssd_scan_bwd: {_ERRORS[rc]} (error {rc})")
    check_launch("ssd_scan_bwd", rc)
    bwd_launches.add()
    return dx, ddt, dA, dB, dC, dD
