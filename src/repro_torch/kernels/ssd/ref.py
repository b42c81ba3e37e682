"""Plain PyTorch version of the SSD scan kernel: ``repro.models.ssm.ssd_chunked``
as a Python loop over chunks that carries the float32 (b, nh, hd, ds) state.

Shapes: x (b, l, nh, hd) · dt (b, l, nh) · A (nh,) · B, C (b, l, ds) · D (nh,).
Everything is computed in float32 (float64 for float64 inputs, an oracle);
each chunk's ``y`` is cast to x's dtype.  ``ssd_bwd_ref`` is the plain version
of the backward kernel, in its decomposition.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


#: block of XLA's two-level prefix sum (``prefix_sum``)
SCAN_BLOCK = 16


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum of ``x`` along ``dim``, in the order of
    the reference's ``jnp.cumsum`` on the CPU: XLA rewrites it into a scan
    over blocks of 16.  Each block is summed in order; the block totals are
    scanned by the same rule (in order once there are at most 16); each
    element then adds the previous block's prefix.  Every add is a float32
    add (``torch.cumsum`` on the CPU accumulates float32 in double)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // SCAN_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n)).unflatten(-1, (nb, SCAN_BLOCK))
    part = xb.clone()
    for i in range(1, SCAN_BLOCK):
        part[..., i] = part[..., i - 1] + xb[..., i]
    if nb > 1:
        prev = prefix_sum(part[..., :-1, -1], -1)  # totals of every block but the last
        part[..., 1:, :] = part[..., 1:, :] + prev[..., None]
    return part.flatten(-2)[..., :n].movedim(-1, dim)


def check_length(l: int, chunk: int) -> int:
    """JAX's length rule: ``chunk = min(chunk, l)`` and ``l % chunk == 0``
    (a 300-token request at chunk 256 is refused, as by the reference)."""
    chunk = min(chunk, l)
    if chunk <= 0 or l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD chunk {chunk}")
    return chunk


def ssd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, l, nh, hd) in x's dtype, final state (b, nh, hd, ds) in
    the type every step is computed in: float32 as the kernel, float64 for
    float64 inputs (an oracle of the backward))."""
    b, l, nh, hd = x.shape
    ds = B.shape[-1]
    chunk = check_length(l, chunk)
    ct = torch.promote_types(x.dtype, torch.float32)
    A = A.to(ct)
    D = D.to(ct)
    state = torch.zeros((b, nh, hd, ds), dtype=ct, device=x.device)
    i = torch.arange(chunk, device=x.device)
    tri = (i[:, None] >= i[None, :])[None, :, :, None]
    ys = []
    for t0 in range(0, l, chunk):
        xc = x[:, t0:t0 + chunk].to(ct)    # (b, c, nh, hd)
        dtc = dt[:, t0:t0 + chunk].to(ct)  # (b, c, nh)
        Bc = B[:, t0:t0 + chunk].to(ct)    # (b, c, ds)
        Cc = C[:, t0:t0 + chunk].to(ct)
        cs = prefix_sum(dtc * A, dim=1)     # inclusive, ≤ 0
        # intra-chunk (the "dual" quadratic form); the exponent is masked
        # BEFORE exp: upper-triangle exponents are positive and overflow to
        # inf (inf · 0 = NaN after masking)
        CB = torch.einsum("bis,bjs->bij", Cc, Bc)
        expnt = cs[:, :, None, :] - cs[:, None, :, :]  # (b, c, c, nh)
        decay = torch.exp(torch.where(tri, expnt, float("-inf")))
        M = CB[..., None] * decay * dtc[:, None, :, :]
        y = torch.einsum("bijn,bjnp->binp", M, xc)
        # inter-chunk: contribution of the incoming state
        y = y + torch.einsum("bis,bnps->binp", Cc, state) * torch.exp(cs)[..., None]
        # state passing
        total = cs[:, -1, :]  # (b, nh)
        w = dtc * torch.exp(total[:, None, :] - cs)
        state_chunk = torch.einsum("bjnp,bjs,bjn->bnps", xc, Bc, w)
        state = state * torch.exp(total)[:, :, None, None] + state_chunk
        y = y + D[None, None, :, None] * xc
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, ...]:
    """Gradients (dx, ddt, dA, dB, dC, dD) of ``ssd_ref`` given dy (b, l, nh,
    hd) and the final state's gradient ``dstate`` (b, nh, hd, ds; zero when
    None), computed in float32 as the kernel (float64 for float64 inputs),
    each returned in its input's dtype.

    Written in the decomposition the CUDA backward takes.  Per chunk, with
    cs the forward's prefix sum, L_ij = exp(cs_i - cs_j) for j <= i, S_in the
    state entering the chunk and dS_out the gradient of the state leaving
    it (a pass over the chunks in reverse from ``dstate``: dS_in =
    exp(cs_last) dS_out + sum_i exp(cs_i) dy_i C_i^T):

        dx_j = sum_{i>=j} (C_i.B_j) L_ij dt_j dy_i + dt_j e^{cs_last-cs_j} dS_out B_j + D dy_j
        dC_i = sum_{j<=i} (dy_i.x_j) L_ij dt_j B_j + e^{cs_i} S_in^T dy_i
        dB_j = sum_{i>=j} (dy_i.x_j) L_ij dt_j C_i + dt_j e^{cs_last-cs_j} dS_out^T x_j

    and dt through its direct terms plus A times dL/da_k, a_k = dt_k A.
    That is taken in its straddling form: the pairs i >= k > j of the
    intra-chunk weights W_ij (an exclusive prefix along each row j < k,
    then a sum down the column i >= k), the incoming-state terms V_i of the
    rows i >= k, the state-decay term E of every row, and the outgoing-state
    terms U_j of the rows j < k.  Each partial sum holds terms of the sum it
    ends in; per-row dcs_i summed in reverse would cancel terms of about the
    whole chunk's size (cs reaches about -80 within a mamba2 chunk)."""
    b, l, nh, hd = x.shape
    ds = B.shape[-1]
    chunk = check_length(l, chunk)
    nc = l // chunk
    ct = torch.promote_types(x.dtype, torch.float32)
    a_dtype, d_dtype = A.dtype, D.dtype
    xc = x.to(ct).reshape(b, nc, chunk, nh, hd)
    dyc = dy.to(ct).reshape(b, nc, chunk, nh, hd)
    dtc = dt.to(ct).reshape(b, nc, chunk, nh)
    Bc = B.to(ct).reshape(b, nc, chunk, ds)
    Cc = C.to(ct).reshape(b, nc, chunk, ds)
    A = A.to(ct)
    D = D.to(ct)
    cs = prefix_sum(dtc * A, dim=2)          # (b, nc, c, nh), the forward's order
    last = cs[:, :, -1]                      # (b, nc, nh)
    wl = torch.exp(last[:, :, None] - cs)    # e^{cs_last - cs_j}
    ecs = torch.exp(cs)
    # the states entering each chunk, as the forward carries them
    chunk_state = torch.einsum("bkjnp,bkjs,bkjn->bknps", xc, Bc, dtc * wl)
    s_in = torch.empty_like(chunk_state)
    run = torch.zeros_like(chunk_state[:, 0])
    for k in range(nc):
        s_in[:, k] = run
        run = run * torch.exp(last[:, k])[..., None, None] + chunk_state[:, k]
    # their gradients, in reverse: dS_out[k] = e^{cs_last[k+1]} dS_out[k+1] + local[k+1]
    local = torch.einsum("bkin,bkinp,bkis->bknps", ecs, dyc, Cc)
    ds_out = reverse_state_pass(local, last, dstate)

    # intra-chunk: the exponent masked before exp, as in the forward
    i = torch.arange(chunk, device=x.device)
    tri = (i[:, None] >= i[None, :])[:, :, None]                # (c_i, c_j, 1)
    expnt = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (b, nc, c_i, c_j, nh)
    L = torch.exp(torch.where(tri, expnt, float("-inf")))
    CB = torch.einsum("bkis,bkjs->bkij", Cc, Bc)[..., None]
    DX = torch.einsum("bkinp,bkjnp->bkijn", dyc, xc)
    dtj = dtc[:, :, None, :, :]
    M = CB * L * dtj
    N = DX * L * dtj
    GL = CB * DX * L
    dx = torch.einsum("bkijn,bkinp->bkjnp", M, dyc)
    dB = torch.einsum("bkijn,bkis->bkjs", N, Cc)
    dC = torch.einsum("bkijn,bkjs->bkis", N, Bc)
    # the states' terms
    sx = torch.einsum("bkjs,bknps->bkjnp", Bc, ds_out)       # dS_out B_j
    sb = torch.einsum("bkjnp,bknps->bkjns", xc, ds_out)      # dS_out^T x_j
    sc = torch.einsum("bkinp,bknps->bkins", dyc, s_in)       # S_in^T dy_i
    w = (dtc * wl)[..., None]
    dx = dx + w * sx + D[:, None] * dyc
    dB = dB + (w * sb).sum(3)
    dC = dC + (ecs[..., None] * sc).sum(3)
    dD = (dyc * xc).sum((0, 1, 2, 4))
    # dt: direct terms, then A dL/da in the straddling form
    H = (xc * sx).sum(-1)                                    # x_j . dS_out B_j
    V = ecs * (sc * Cc[:, :, :, None, :]).sum(-1)            # e^{cs_i} C_i . S_in^T dy_i
    E = torch.exp(last) * (ds_out * s_in).sum((-1, -2))      # e^{cs_last} <dS_out, S_in>
    U = dtc * wl * H
    W = GL * dtj
    da = decay_grad(W, V, E, U)
    ddt = GL.sum(2) + wl * H + A * da
    dA = (dtc * da).sum((0, 1, 2))
    return (dx.reshape(b, l, nh, hd).to(x.dtype), ddt.reshape(b, l, nh).to(dt.dtype),
            dA.to(a_dtype), dB.reshape(b, l, ds).to(B.dtype),
            dC.reshape(b, l, ds).to(C.dtype), dD.to(d_dtype))


def reverse_state_pass(local: torch.Tensor, last: torch.Tensor,
                       dstate: Optional[torch.Tensor]) -> torch.Tensor:
    """dS_out per chunk (b, nc, nh, hd, ds) from ``local`` = sum_i e^{cs_i}
    dy_i C_i^T per chunk and the chunks' last prefix sums (b, nc, nh), in
    reverse from ``dstate``: dS_out[k] = e^{cs_last[k+1]} dS_out[k+1] +
    local[k+1]."""
    nc = local.shape[1]
    out = torch.empty_like(local)
    run = torch.zeros_like(local[:, 0]) if dstate is None else dstate.to(local.dtype)
    for k in range(nc - 1, -1, -1):
        out[:, k] = run
        run = run * torch.exp(last[:, k])[..., None, None] + local[:, k]
    return out


def decay_grad(W: torch.Tensor, V: torch.Tensor, E: torch.Tensor,
               U: torch.Tensor) -> torch.Tensor:
    """dL/da_k (b, nc, c, nh), a_k = dt_k A, in the straddling form: W (b,
    nc, c_i, c_j, nh) the intra-chunk weights (pairs i >= k > j: an
    exclusive prefix along each row, then the sum down the column i >= k),
    V (b, nc, c, nh) the incoming-state terms (rows i >= k), E (b, nc, nh)
    the state decay's (every row), U (b, nc, c, nh) the outgoing state's
    (rows j < k)."""
    c = W.shape[2]
    i = torch.arange(c, device=W.device)
    tri = (i[:, None] >= i[None, :])[:, :, None]
    Q = torch.cumsum(W, dim=3)
    Q = torch.cat([torch.zeros_like(Q[:, :, :, :1]), Q[:, :, :, :-1]], dim=3)
    straddle = (Q * tri).sum(2)
    suffix_v = torch.flip(torch.cumsum(torch.flip(V, [2]), 2), [2])
    prefix_u = torch.cat([torch.zeros_like(U[:, :, :1]), torch.cumsum(U, 2)[:, :, :-1]], 2)
    return straddle + suffix_v + E[:, :, None] + prefix_u
