"""The Hopper SSD backward's arithmetic, emulated on the CPU.

The kernel (``src/repro_torch/csrc/ssd_scan_bwd.cu``) runs only on the card.
``emulate`` computes what its kernels compute, tile by tile and in their
partial-sum order, with every tensor-core operand rounded as the kernel
rounds it:

- ``local``: each chunk's sum_i e^{cs_i} dy_i C_i^T, 64-row tiles summed in
  order;
- ``pass``: the state gradients over the chunks in reverse (multiply then
  add), and E = e^{cs_last} <dS_out, S_in>;
- ``chunk``, a CTA per (batch x chunk, group of heads, 64-row tile t): as
  column tile t (the i tiles >= t in order) dx_t, the group's dB_t and ddt's
  direct terms, from C.B^T and dy.x^T formed transposed (rows j); as row
  tile t (the j tiles <= t in order) the group's dC_t and the straddling
  prefix of W = C.B^T o dy.x^T o L o dt_j along each row (pair sums, a scan
  over the four lanes of a quad, the 8-column blocks in order), its column
  sums over the tile's rows i >= k (a butterfly over the 8 rows of a warp,
  then the 4 warps in order); the heads of a group summed into one dB / dC
  partial in order; the decay exp(cs_i - cs_j) on the diagonal tile pair,
  exp(cs_i - cs_e) exp(cs_e - cs_j) below it (e the j tile's last row);
- ``finish``: dL/da_k = straddle_k + sum_{i>=k} V_i + E + sum_{j<k} U_j
  (the row tiles' column sums in order; the suffix and prefix by the
  kernel's three-level scan), ddt and the per-chunk dA and dD terms;
- ``reduce``: dB / dC over the head groups, dA / dD over batch and chunks,
  in order.

bfloat16: x, B, C and dy are exact bf16 operands; C.B^T and dy.x^T are one
exact product each; S_in^T.dy_i reads the forward's hi and lo planes.  Of
the float32 operands, M (in M^T.dy) and N (in N^T.C and N.B) feed only dx,
dB and dC, which the kernel writes in bf16: each is rounded once to bf16
(``ROUNDED``).  e^{cs} o dy (the local state) and dS_out (in dS_out.B_j and
dS_out^T.x_j) feed ddt and dA, float32 outputs: each is split into bf16 hi
+ lo and multiplied twice against the exact operand.  float32: 3xTF32
(hi.hi + hi.lo + lo.hi, hi and lo rounded to nearest); C.B^T is the same
product whether a kernel forms it per chunk or per head.  Not emulated:
the order inside one tensor-core product (the hardware's), the 3xTF32
8-deep steps summed from zero, the kernels' fused multiply-adds, and the
pass kernel's block order of E's sum.

Tolerances, against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` and
against float64 autograd through ``ssd_ref``, each of a gradient's largest
entry: float32 5e-5 (dA 1e-4: one signed sum per head over every row, whose
terms sum in absolute value to several times the result), bfloat16 2e-2
(chip_smoke's and the CUDA tests' tolerances of the kernel), with dx, dB and
dC rounded to bf16 as the kernel writes them.  At mamba2-780m's heads 8-15
dA is held per head to 1e-5 of the absolute sum of its terms, as the plain
version is in ``tests/test_torch_ssd_bwd.py``.

Controls that must miss a tolerance: one TF32 product in place of 3xTF32
(every gradient misses 5e-5); in bf16, dS_out or e^{cs} o dy rounded once
instead of split (ddt or dA then misses float32's tolerance, which the
split holds); the state gradient passed between chunks dropped.  M and N
rounded once are held to 0.3 of the bf16 tolerance and to 2.5e-3 of a
split: the measured reason the kernel takes one product for each."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref_module  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd.kernel import bwd_launch_plan  # noqa: E402

TILE = 64
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
TOL = {"float32": 5e-5, "bfloat16": 2e-2}
DA_TOL = 1e-4


# ------------------------------------------------------------ operand rounding

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 (the kernel's ``tf32_rn``)."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """a @ b as the tensor cores compute it.  ``exact``: both exact in bf16;
    ``split_a`` / ``split_b``: that float32 operand as bf16 hi + lo, two
    products; ``round_a`` / ``round_b``: that operand rounded once (the
    controls); ``3xtf32`` / ``tf32``: float32."""
    if how == "3xtf32":
        ahi, bhi = _tf32_rn(a), _tf32_rn(b)
        return _tf32_rn(a - ahi) @ bhi + ahi @ _tf32_rn(b - bhi) + ahi @ bhi
    if how == "tf32":
        return _tf32_rn(a) @ _tf32_rn(b)
    if how == "split_a":
        hi = _bf16(a)
        return hi @ b + _bf16(a - hi) @ b
    if how == "split_b":
        hi = _bf16(b)
        return a @ hi + a @ _bf16(b - hi)
    if how == "round_a":
        return _bf16(a) @ b
    if how == "round_b":
        return a @ _bf16(b)
    assert how == "exact"
    return a @ b


def _planes(s: torch.Tensor):
    """A float32 state as the bf16 hi and lo planes the kernels store."""
    hi = _bf16(s)
    return hi, _bf16(s - hi)


# ------------------------------------------------------------ the kernel's sums

def _quad_prefix(w: torch.Tensor, carry: torch.Tensor):
    """The exclusive prefix of w (..., 64) along its last dim, starting from
    ``carry`` (...), in the chunk kernel's order: each lane t of a quad holds
    columns 2t, 2t + 1 of every 8-column block; pair sums, an inclusive scan
    over the quad (shuffles up by 1, then 2), the block's total from lane 3,
    the blocks in order.  Returns (prefix, carry + the row's total)."""
    v = w.unflatten(-1, (8, 4, 2))                  # (..., block, lane, pair)
    p = v[..., 0] + v[..., 1]
    s1 = p.clone()
    s1[..., 1:] = p[..., 1:] + p[..., :-1]
    incl = s1.clone()
    incl[..., 2:] = s1[..., 2:] + s1[..., :-2]
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    out = torch.empty_like(v)
    run = carry.clone()
    for jb in range(8):
        q0 = run[..., None] + excl[..., jb, :]
        out[..., jb, :, 0] = q0
        out[..., jb, :, 1] = q0 + v[..., jb, :, 0]
        run = run + incl[..., jb, 3]
    return out.flatten(-3), run


def _column_sums(q: torch.Tensor) -> torch.Tensor:
    """Sums over the 64 rows (dim -2) of q (..., 64, n) in the kernel's
    order: rows r and r + 8 of a warp's 16 (one lane), a butterfly over the
    warp's 8 lane rows (xor 1, 2, 4), then the 4 warps in order."""
    q = q.unflatten(-2, (4, 2, 8))                  # (..., warp, half, g, n)
    s = q[..., 0, :, :] + q[..., 1, :, :]            # (..., warp, g, n)
    for d in (1, 2, 4):
        idx = torch.arange(8) ^ d
        s = s + s[..., idx, :]
    tot = s[..., 0, 0, :]
    for w in range(1, 4):
        tot = tot + s[..., w, 0, :]
    return tot


def _block_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the last dim (length c) in the
    finish kernel's order: 128 threads each take ceil(c / 128) consecutive
    elements in order; the thread totals are scanned in each warp by
    shuffles up by 1, 2, 4, 8 and 16; the 4 warp totals in order."""
    c = v.shape[-1]
    per = -(-c // 128)
    pad = torch.nn.functional.pad(v, (0, 128 * per - c)).unflatten(-1, (128, per))
    own = pad.clone()
    for e in range(1, per):
        own[..., e] = own[..., e - 1] + pad[..., e]
    tot = own[..., -1].unflatten(-1, (4, 32))
    for d in (1, 2, 4, 8, 16):
        nxt = tot.clone()
        nxt[..., d:] = tot[..., d:] + tot[..., :-d]
        tot = nxt
    warp = tot[..., -1]
    base = torch.zeros_like(warp)
    for w in range(1, 4):
        base[..., w] = base[..., w - 1] + warp[..., w - 1]
    excl_t = torch.zeros_like(tot)
    excl_t[..., 1:] = tot[..., :-1]
    excl_t = (excl_t + base[..., None]).flatten(-2)   # before each thread's run
    out = own + excl_t[..., None]
    # a thread's first element is its own run plus what came before
    return out.flatten(-2)[..., :c]


def _quad_row_sums(v: torch.Tensor) -> torch.Tensor:
    """Sums along the last dim (a multiple of 8 wide) in the kernel's order:
    lane t of a quad adds its columns 8 jb + 2t, 8 jb + 2t + 1 in order of jb,
    then a butterfly over the quad's lanes (xor 1, then 2)."""
    v = v.unflatten(-1, (-1, 4, 2))                 # (..., block, lane, pair)
    own = v[..., 0, :, 0]
    for jb in range(v.shape[-3]):
        for e in range(2):
            if jb or e:
                own = own + v[..., jb, :, e]
    s = own + own[..., [1, 0, 3, 2]]
    return (s + s[..., [2, 3, 0, 1]])[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum along the last dim in the finish kernel's order: each of 128
    threads its ceil(c / 128) consecutive elements in order, a butterfly
    over each warp (xor 16, 8, 4, 2, 1), the 4 warps in order."""
    c = v.shape[-1]
    per = -(-c // 128)
    pad = torch.nn.functional.pad(v, (0, 128 * per - c)).unflatten(-1, (4, 32, per))
    own = pad[..., 0]
    for e in range(1, per):
        own = own + pad[..., e]
    for d in (16, 8, 4, 2, 1):
        own = own + own[..., torch.arange(32) ^ d]
    return _in_order(own[..., 0].movedim(-1, 0))


def _suffix_and_prefix(V: torch.Tensor, U: torch.Tensor):
    """sum_{i>=k} V_i (a scan of the reversed rows) and sum_{j<k} U_j."""
    suf = torch.flip(_block_scan(torch.flip(V, [-1])), [-1])
    inc = _block_scan(U)
    pre = torch.zeros_like(inc)
    pre[..., 1:] = inc[..., :-1]
    return suf, pre


# ------------------------------------------------------------ the emulation

ROUNDED = ("M", "N")          # bf16: rounded once; "dS_out" and "dy_e" split


def emulate(x, dt, A, B, C, D, dy, dS, *, chunk, dtype, group=None, f32="3xtf32",
            rounded=ROUNDED, carry=True):
    """The backward's kernels on CPU tensors (float32 holding the kernel's
    operands: bf16 values for ``dtype="bfloat16"``).  ``rounded`` names the
    float32 operands rounded once to bf16 ("M", "N", "dS_out", "dy_e"); the
    others are split into hi + lo; ``f32`` the float32 arithmetic;
    ``carry=False``: the control that drops the state gradient passed
    between chunks.  Returns (dx, ddt, dA, dB, dC, dD) in float32."""
    b, l, nh, hd = x.shape
    ds = B.shape[-1]
    c = chunk
    nc = l // c
    nt = -(-c // TILE)
    cp = nt * TILE
    G = group or bwd_launch_plan(torch.float32, hd, ds, c, batch=b, heads=nh, seq=l).head_group
    ng = -(-nh // G)
    nhp = ng * G
    bf = dtype == "bfloat16"
    prod = {"exact": "exact" if bf else f32}
    for name in ("M", "N", "dS_out", "dy_e"):
        prod[name] = ("round" if name in rounded else "split") if bf else f32

    def how(name, side):
        p = prod[name]
        return p if p in ("exact", "3xtf32", "tf32") else f"{p}_{side}"

    def rows(t, per_head):
        """(b, l, [nh,] w) -> (b, nc, [nhp,] cp, w), rows past c and heads
        past nh zero."""
        t = t.reshape(b, nc, c, *t.shape[2:])
        if per_head:
            t = t.movedim(3, 2)                      # (b, nc, nh, c, w)
            t = torch.nn.functional.pad(t, (0, 0, 0, cp - c, 0, nhp - nh))
        else:
            t = torch.nn.functional.pad(t, (0, 0, 0, cp - c))[:, :, None]
        return t

    xc, dyc = rows(x, True), rows(dy, True)
    Bc, Cc = rows(B, False), rows(C, False)
    dtc = torch.nn.functional.pad(dt.reshape(b, nc, c, nh).movedim(3, 2),
                                  (0, cp - c, 0, nhp - nh))
    Ap = torch.nn.functional.pad(A, (0, nhp - nh))
    Dp = torch.nn.functional.pad(D, (0, nhp - nh))
    # the forward's prefix sums, and the states entering each chunk as the
    # forward's kernels leave them (bf16: the hi and lo planes)
    cs = ssd_ref_module.prefix_sum(dt.reshape(b, nc, c, nh) * A, 2).movedim(3, 2)
    cs = torch.nn.functional.pad(cs, (0, cp - c, 0, nhp - nh))
    live = torch.arange(cp) < c
    last = cs[..., c - 1]                                   # (b, nc, nhp)
    wl = torch.where(live, torch.exp(last[..., None] - cs), torch.zeros(()))
    w = dtc * wl                                            # dt_j e^{cs_last - cs_j}
    e = torch.where(live, torch.exp(cs), torch.zeros(()))
    chunk_state = _mm((xc * w[..., None]).transpose(-1, -2), Bc,
                      "split_a" if bf else f32)             # (b, nc, nhp, hd, ds)
    s_in = torch.zeros_like(chunk_state)
    run = torch.zeros_like(chunk_state[:, 0])
    for k in range(nc):
        s_in[:, k] = run
        run = run * torch.exp(last[:, k])[..., None, None] + chunk_state[:, k]
    sin_ops = _planes(s_in) if bf else (s_in,)

    def tiles(t, i):
        return t[..., i * TILE:(i + 1) * TILE, :]

    # ---- local: sum_i e^{cs_i} dy_i C_i^T over the row tiles in order
    dye = dyc * e[..., None]
    local = torch.zeros_like(chunk_state)
    for it in range(nt):
        local = local + _mm(tiles(dye, it).transpose(-1, -2), tiles(Cc, it), how("dy_e", "a"))
    # ---- pass: dS_out[k] = e^{cs_last[k+1]} dS_out[k+1] + local[k+1]
    dso = torch.empty_like(local)
    run = torch.zeros_like(local[:, 0]) if dS is None else \
        torch.nn.functional.pad(dS, (0, 0, 0, 0, 0, nhp - nh))
    for k in range(nc - 1, -1, -1):
        dso[:, k] = run
        run = run * torch.exp(last[:, k])[..., None, None] + local[:, k]
        if not carry:
            run = torch.zeros_like(run)
    s_in_f = sum(sin_ops[1:], sin_ops[0])
    E = torch.exp(last) * (dso * s_in_f).sum((-1, -2))
    dso_ops = _planes(dso) if bf and "dS_out" not in rounded else (dso,)

    def state_mm(a, ops, transpose):
        """a . S^T (transpose) or a . S over the planes of S, in order."""
        out = None
        for s in ops:
            s = s.transpose(-1, -2) if transpose else s
            p = _mm(a, s, "exact" if bf and len(ops) == 2 else how("dS_out", "b"))
            out = p if out is None else out + p
        return out

    ii = torch.arange(TILE)
    # ---- chunk: column tiles (dx, dB, ddt's direct terms)
    dx = torch.zeros_like(xc)
    ddt = torch.zeros_like(dtc)
    U = torch.zeros_like(dtc)
    V = torch.zeros_like(dtc)
    dsum = torch.zeros((b, nc, nhp, nt))
    pB = torch.zeros((b, nc, ng, cp, ds))
    pC = torch.zeros_like(pB)
    P = torch.zeros((b, nc, nhp, nt, cp))                  # straddle partials by row tile
    for jt in range(nt):
        j0 = jt * TILE
        jsl = slice(j0, j0 + TILE)
        accB = torch.zeros((b, nc, ng, TILE, ds))
        for g in range(G):
            hs = slice(g, nhp, G)                           # head g of every group
            x_j, B_j = tiles(xc[:, :, hs], jt), tiles(Bc, jt)
            acc = Dp[hs][:, None, None] * tiles(dyc[:, :, hs], jt)
            gd = torch.zeros((b, nc, ng, TILE))
            for it in range(jt, nt):
                i0 = it * TILE
                dy_i, C_i = tiles(dyc[:, :, hs], it), tiles(Cc, it)
                Tt = _mm(B_j, C_i.transpose(-1, -2), how("exact", "a"))   # rows j, cols i
                Ut = _mm(x_j, dy_i.transpose(-1, -2), how("exact", "a"))
                lt = _decay(cs[:, :, hs, i0:i0 + TILE], cs[:, :, hs, jsl], i0, j0, c).transpose(-1, -2)
                dtj = dtc[:, :, hs, jsl][..., :, None]
                Mt = Tt * lt * dtj
                Nt = Ut * lt * dtj
                gd = gd + _quad_row_sums(Tt * Ut * lt)
                acc = acc + _mm(Mt, dy_i, how("M", "a"))
                accB = accB + _mm(Nt, C_i, how("N", "a"))
                if it == jt:
                    dsum[:, :, hs, jt] = _column_sums(torch.diagonal(Ut, dim1=-2, dim2=-1)[..., None])[..., 0]
            sx = state_mm(B_j, [o[:, :, hs] for o in dso_ops], True)     # rows j, cols p
            sb = state_mm(x_j, [o[:, :, hs] for o in dso_ops], False)    # rows j, cols s
            wj = w[:, :, hs, jsl][..., None]
            dx[:, :, hs, jsl] = acc + wj * sx
            H = _quad_row_sums(x_j * sx)
            ddt[:, :, hs, jsl] = gd + wl[:, :, hs, jsl] * H
            U[:, :, hs, jsl] = w[:, :, hs, jsl] * H
            accB = accB + wj * sb
        pB[:, :, :, jsl] = accB
    # ---- chunk: row tiles (dC, the straddling sums, the incoming state's terms)
    for it in range(nt):
        i0 = it * TILE
        isl = slice(i0, i0 + TILE)
        accC = torch.zeros((b, nc, ng, TILE, ds))
        for g in range(G):
            hs = slice(g, nhp, G)
            dy_i, C_i = tiles(dyc[:, :, hs], it), tiles(Cc, it)
            R = torch.zeros((b, nc, ng, TILE))
            for jt in range(it + 1):
                j0 = jt * TILE
                x_j, B_j = tiles(xc[:, :, hs], jt), tiles(Bc, jt)
                S = _mm(C_i, B_j.transpose(-1, -2), how("exact", "a"))      # rows i, cols j
                X = _mm(dy_i, x_j.transpose(-1, -2), how("exact", "a"))
                lt = _decay(cs[:, :, hs, isl], cs[:, :, hs, j0:j0 + TILE], i0, j0, c)
                N = X * lt * dtc[:, :, hs, j0:j0 + TILE][..., None, :]
                W = S * N
                accC = accC + _mm(N, B_j, how("N", "a"))
                Q, R = _quad_prefix(W, R)
                if jt == it:
                    Q = torch.where(ii[:, None] >= ii[None, :], Q, torch.zeros(()))
                P[:, :, hs, it, j0:j0 + TILE] = _column_sums(Q)
            st = None
            for s in sin_ops:
                p = _mm(dy_i, s[:, :, hs], "exact" if bf else f32)         # rows i, cols s
                st = p if st is None else st + p
            ei = e[:, :, hs, isl][..., None]
            accC = accC + ei * st
            V[:, :, hs, isl] = e[:, :, hs, isl] * _quad_row_sums(C_i * st)
        pC[:, :, :, isl] = accC
    # ---- finish
    kt = torch.arange(cp) // TILE
    strad = torch.zeros_like(dtc)
    for it in range(nt):  # the row tiles it >= k's, in order
        strad = torch.where(kt == it, P[:, :, :, it], torch.where(kt < it, strad + P[:, :, :, it],
                                                                strad))
    suf, pre = _suffix_and_prefix(V[..., :c], U[..., :c])
    da = ((strad[..., :c] + suf) + E[..., None]) + pre
    ddt = ddt[..., :c] + Ap[:, None] * da
    pA = _block_sum(dtc[..., :c] * da)
    pD = _in_order(dsum.movedim(-1, 0))
    # ---- reduce: the group partials, and batch x chunks, in order
    dA = _in_order(pA.reshape(b * nc, nhp))
    dD = _in_order(pD.reshape(b * nc, nhp))
    dB = _in_order(pB.movedim(2, 0))
    dC = _in_order(pC.movedim(2, 0))
    un = lambda t: t[:, :, :nh, :c].movedim(2, 3).reshape(b, l, nh, -1)  # noqa: E731
    return (un(dx), un(ddt[..., None])[..., 0], dA[:nh],
            dB[:, :, :c].reshape(b, l, ds), dC[:, :, :c].reshape(b, l, ds), dD[:nh])


def _decay(cs_i, cs_j, i0, j0, c):
    """L_ij (rows i, columns j) of a 64 x 64 tile pair as the chunk kernel
    forms it: exp(cs_i - cs_j) on the diagonal pair (masked to j <= i < c
    before exp); below it exp(cs_i - cs_e) exp(cs_e - cs_j), e the j tile's
    last row."""
    ii = torch.arange(TILE)
    ninf = torch.tensor(float("-inf"))
    live = (i0 + ii < c)[:, None]
    if i0 == j0:
        ok = (ii[None, :] <= ii[:, None]) & live
        return torch.exp(torch.where(ok, cs_i[..., :, None] - cs_j[..., None, :], ninf))
    ce = cs_j[..., -1:]
    u = torch.exp(torch.where(live, (cs_i - ce)[..., :, None], ninf))
    return torch.exp(ce - cs_j)[..., None, :] * u


def _in_order(t: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0, the entries added in order."""
    out = t[0].clone()
    for i in range(1, t.shape[0]):
        out = out + t[i]
    return out


# ------------------------------------------------------------ the tests

# (b, l, nh, hd, ds, chunk), heads a CTA takes: reduced mamba2, ragged tiles
# and a group past the last head, mamba2-780m's width over two chunks,
# jamba's ds 16 over two chunks
CASES = {
    "reduced_mamba2": ((2, 64, 8, 32, 16, 32), 2),
    "ragged_tiles": ((1, 192, 3, 32, 16, 96), 2),
    "mamba2_width": ((1, 512, 4, 64, 128, 256), 4),
    "jamba_width": ((1, 512, 4, 64, 16, 256), 4),
}
MAMBA2_WIDTH = CASES["mamba2_width"][0]
BF16_OUT = ("dx", "dB", "dC")   # written in bf16 by the kernel


def _inputs(case, dtype, seed=0, mamba2_decays=False):
    """x, dt, A, B, C, D, dy, dS as float32 tensors; x, B, C, dy hold bf16
    values for bf16 (the kernel's exact operands).  ``mamba2_decays``:
    mamba2-780m's A at heads 8-15 and dt = softplus(0.1 N(0, 1))."""
    b, l, nh, hd, ds = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, l, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    if mamba2_decays:
        A = -np.arange(8, 8 + nh, dtype=np.float32)
        dt = np.log1p(np.exp(0.1 * rng.standard_normal((b, l, nh)))).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32)
    C = rng.standard_normal((b, l, ds)).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    dy = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    dS = rng.standard_normal((b, nh, hd, ds)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, D, dy, dS)]
    if dtype == "bfloat16":
        for i in (0, 3, 4, 6):
            t[i] = _bf16(t[i])
    return t


def _float64(t, chunk):
    """Autograd through the plain forward in float64."""
    x, dt, A, B, C, D, dy, dS = t
    leaves = [a.double().requires_grad_(True) for a in (x, dt, A, B, C, D)]
    y, st = ssd_ref(*leaves, chunk=chunk)
    return torch.autograd.grad((y * dy.double()).sum() + (st * dS.double()).sum(), leaves)


def _jax_vjp(t, chunk):
    x, dt, A, B, C, D, dy, dS = (jnp.asarray(a.numpy()) for a in t)
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk), x, dt, A, B, C, D)
    return vjp((dy, dS))


def _rel(got, want) -> float:
    """max |got - want| / max |want|"""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(t, chunk, dtype, **kw):
    """The emulation, with dx, dB, dC rounded to bf16 as the bf16 kernel
    writes them."""
    out = emulate(*t, chunk=chunk, dtype=dtype, **kw)
    if dtype == "bfloat16":
        out = tuple(_bf16(g) if n in BF16_OUT else g for n, g in zip(NAMES, out))
    return out


def _errs(got, want):
    return {n: _rel(g, w) for n, g, w in zip(NAMES, got, want)}


def _tol(dtype, name):
    return DA_TOL if dtype == "float32" and name == "dA" else TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_bwd_matches_jax_vjp_and_float64_autograd(name, dtype):
    case, group = CASES[name]
    t = _inputs(case, dtype)
    got = _run(t, case[5], dtype, group=group)
    for want in (_jax_vjp(t, case[5]), _float64(t, case[5])):
        errs = _errs(got, want)
        assert all(errs[n] <= _tol(dtype, n) for n in NAMES), errs


def test_emulation_takes_the_plans_head_group():
    """Without ``group`` the emulation takes the plan's: at mamba2-780m's
    train shape 4 heads a CTA, 12 partials of dB and dC."""
    plan = bwd_launch_plan(torch.bfloat16, 64, 128, 256, batch=4, heads=48, seq=1024)
    assert (plan.head_group, plan.groups) == (4, 12)
    case, _ = CASES["reduced_mamba2"]
    t = _inputs(case, "float32", seed=1)
    ref = ssd_bwd_ref(*t[:7], t[7], chunk=case[5])
    assert all(e <= _tol("float32", n) for n, e in _errs(_run(t, case[5], "float32"), ref).items())


def _da_term_scale(t, chunk, monkeypatch):
    """Per head, the absolute sum of dA's terms dt_k dL/da_k in float64."""
    seen = {}
    decay_grad = ssd_ref_module.decay_grad

    def keep(W, V, E, U):
        seen["da"] = decay_grad(W, V, E, U)
        return seen["da"]

    with monkeypatch.context() as m:
        m.setattr(ssd_ref_module, "decay_grad", keep)
        ssd_bwd_ref(*(a.double() for a in t[:7]), t[7].double(), chunk=chunk)
    b, l, nh = t[1].shape
    return (t[1].double().reshape(b, l // chunk, chunk, nh) * seen["da"]).abs().sum((0, 1, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straddling_form_holds_da_at_mamba2_decays(monkeypatch, seed):
    """mamba2-780m's heads 8-15, float32: the kernel's straddling sums (the
    quad scan along each row, the butterfly down each column, the row tiles'
    partials in order) hold dA per head to 1e-5 of the absolute sum of its
    terms, as the plain version does, and every other gradient to 5e-5."""
    case = (2, 512, 8, 64, 128, 256)
    t = _inputs(case, "float32", seed=seed, mamba2_decays=True)
    want = _float64(t, case[5])
    got = _run(t, case[5], "float32", group=4)
    errs = _errs(got, want)
    assert all(errs[n] <= TOL["float32"] for n in NAMES if n != "dA"), errs
    scale = _da_term_scale(t, case[5], monkeypatch)
    assert float(((got[2].double() - want[2]).abs() / scale).max()) <= 1e-5


def test_single_tf32_misses_the_float32_tolerance():
    """One TF32 product in place of 3xTF32 keeps about three decimal
    digits: every gradient misses 5e-5, where 3xTF32 holds it."""
    case = MAMBA2_WIDTH
    t = _inputs(case, "float32")
    want = _float64(t, case[5])
    assert all(e <= _tol("float32", n)
               for n, e in _errs(_run(t, case[5], "float32"), want).items())
    bad = _errs(_run(t, case[5], "float32", f32="tf32"), want)
    assert all(e > 5 * TOL["float32"] for e in bad.values()), bad


@pytest.mark.parametrize("operand", ["dS_out", "dy_e"])
def test_split_operands_keep_ddt_and_da_at_float32_accuracy(operand):
    """bf16: ddt and dA are float32 outputs, fed by dS_out (U, H) and e o dy
    (through dS_out), and the design splits both: ddt and dA stay within
    float32's tolerance (5e-5, dA 1e-4) of float64 autograd at mamba2-780m's
    width.  The control, that operand rounded once to bf16, misses it."""
    case = MAMBA2_WIDTH
    t = _inputs(case, "bfloat16")
    want = _float64(t, case[5])
    good = _errs(_run(t, case[5], "bfloat16"), want)
    assert good["ddt"] <= TOL["float32"] and good["dA"] <= DA_TOL, good
    bad = _errs(_run(t, case[5], "bfloat16", rounded=ROUNDED + (operand,)), want)
    assert bad["ddt"] > TOL["float32"] or bad["dA"] > DA_TOL, bad


def test_m_and_n_rounded_once_hold_the_bf16_tolerance():
    """M and N feed only dx, dB and dC, which the kernel writes in bf16: each
    rounded once (one product, not two) keeps those within 0.3 of the 2e-2
    tolerance at mamba2-780m's width, and no more than 2.5e-3 beyond M and N
    split into hi + lo; ddt and dA do not move (W is formed before N is
    rounded)."""
    case = MAMBA2_WIDTH
    t = _inputs(case, "bfloat16")
    want = _float64(t, case[5])
    design = _errs(_run(t, case[5], "bfloat16"), want)
    split = _errs(_run(t, case[5], "bfloat16", rounded=()), want)
    for n in BF16_OUT:
        assert design[n] <= 0.3 * TOL["bfloat16"], design
        assert design[n] - split[n] <= 2.5e-3, (design, split)
    assert design["ddt"] == split["ddt"] and design["dA"] == split["dA"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inter_chunk_control_misses_the_tolerance(dtype):
    """The state gradient passed between chunks dropped: dx, ddt and dB miss
    the tolerance at mamba2-780m's width (two chunks) by far."""
    case = MAMBA2_WIDTH
    t = _inputs(case, dtype, seed=3)
    want = _float64(t, case[5])
    bad = _errs(_run(t, case[5], dtype, carry=False), want)
    assert all(bad[n] > 10 * TOL[dtype] for n in ("dx", "ddt", "dB")), bad
