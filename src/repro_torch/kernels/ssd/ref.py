"""Plain PyTorch version of the SSD scan kernel: ``repro.models.ssm.ssd_chunked``
as a Python loop over chunks that carries the float32 (b, nh, hd, ds) state.

Shapes: x (b, l, nh, hd) · dt (b, l, nh) · A (nh,) · B, C (b, l, ds) · D (nh,).
Everything is computed in float32; each chunk's ``y`` is cast to x's dtype.
"""

from __future__ import annotations

from typing import Tuple

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
    """Returns (y (b, l, nh, hd) in x's dtype, final state (b, nh, hd, ds) f32)."""
    b, l, nh, hd = x.shape
    ds = B.shape[-1]
    chunk = check_length(l, chunk)
    f32 = torch.float32
    A = A.to(f32)
    D = D.to(f32)
    state = torch.zeros((b, nh, hd, ds), dtype=f32, device=x.device)
    i = torch.arange(chunk, device=x.device)
    tri = (i[:, None] >= i[None, :])[None, :, :, None]
    ys = []
    for t0 in range(0, l, chunk):
        xc = x[:, t0:t0 + chunk].to(f32)    # (b, c, nh, hd)
        dtc = dt[:, t0:t0 + chunk].to(f32)  # (b, c, nh)
        Bc = B[:, t0:t0 + chunk].to(f32)    # (b, c, ds)
        Cc = C[:, t0:t0 + chunk].to(f32)
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
