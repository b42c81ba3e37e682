# A verbatim copy of coldbench/reference.py as it stood before each configuration brought
# its own module; tests/test_coldbench_pins.py holds the new path to it exactly.
"""Plain PyTorch reference of the served models, in float32.

It imports nothing of the program.  It takes the benchmark's own weights
(the base with a function's delta laid over it, leaves named by the
program's parameter paths, stacked over the layers) and token ids, and
returns the float32 logits of every row's last position: what
``InvocationResult.output`` holds the first 8 of.

* dense (StableLM): embedding, per layer LayerNorm (eps 1e-5), q / k / v,
  rotary embedding over the whole head (split halves, theta from the
  configuration), causal softmax attention, output projection, residual,
  LayerNorm, gated SiLU MLP, residual; final LayerNorm; the untied head;
* ssm (Mamba-2): embedding, per layer RMSNorm (eps 1e-6, x (1 + scale)),
  z / xBC / dt projections, dt = softplus(. + dt_bias), A = -exp(A_log),
  causal depthwise conv and SiLU over xBC, the SSD scan in its chunked
  form (exact in exact arithmetic for any chunk), y + D x, gating by
  SiLU(z), the gated RMSNorm, output projection, residual; final RMSNorm;
  the tied head.

``quant="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 with a per-tensor scale (accumulation stays float32), the
step below the configuration's bfloat16 that a faster path would take.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _q8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: Dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.c = cfg
        self.quant = quant

    # -- pieces -----------------------------------------------------------

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        a, w = a.float(), w.float()
        if self.quant == "fp8":
            a, w = _q8(a), _q8(w)
        return a @ w

    @staticmethod
    def layernorm(x, scale, bias, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()

    @staticmethod
    def rmsnorm(x, scale, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())

    def norm(self, x, P, prefix):
        if self.c["norm"] == "layernorm":
            return self.layernorm(x, P[prefix + "/scale"], P[prefix + "/bias"])
        return self.rmsnorm(x, P[prefix + "/scale"])

    # -- dense ------------------------------------------------------------

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, s, h, d): rotate split halves by position."""
        s, d = x.shape[1], x.shape[-1]
        inv = 1.0 / (float(self.c.get("rope_theta", 10000.0))
                     ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
        ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
        cos = torch.cos(ang).float()[None, :, None, :]
        sin = torch.sin(ang).float()[None, :, None, :]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal softmax attention, one batch row at a time; (b, s, h, d)."""
        b, s, h, d = q.shape
        rep = h // k.shape[2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu_(1)
        out = torch.empty_like(q)
        for r in range(b):
            qr = q[r].transpose(0, 1)                                   # (h, s, d)
            kr = k[r].transpose(0, 1).repeat_interleave(rep, 0)
            vr = v[r].transpose(0, 1).repeat_interleave(rep, 0)
            if self.quant == "fp8":
                qr, kr, vr = _q8(qr), _q8(kr), _q8(vr)
            sc = (qr @ kr.transpose(1, 2)) / math.sqrt(d)
            sc.masked_fill_(mask, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            del sc
            if self.quant == "fp8":
                p = _q8(p)
            out[r] = (p @ vr).transpose(0, 1)
            del p
        return out

    def _dense_layer(self, x, p):
        c = self.c
        g = p.__getitem__
        b, s, D = x.shape
        H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        h = self.norm(x, p, "ln1")
        q = self.mm(h, g("wq").reshape(D, H * hd)).view(b, s, H, hd)
        k = self.mm(h, g("wk").reshape(D, KV * hd)).view(b, s, KV, hd)
        v = self.mm(h, g("wv").reshape(D, KV * hd)).view(b, s, KV, hd)
        if c.get("use_rope", True):
            q, k = self._rope(q), self._rope(k)
        o = self._attention(q, k, v).reshape(b, s, H * hd)
        x = x + self.mm(o, g("wo").reshape(H * hd, D))
        h = self.norm(x, p, "ln2")
        up = self.mm(h, g("ffn/w_in"))
        if c.get("mlp_gated", True):
            up = F.silu(self.mm(h, g("ffn/w_gate"))) * up
        else:
            up = F.silu(up)
        return x + self.mm(up, g("ffn/w_out"))

    # -- ssm --------------------------------------------------------------

    def _ssd(self, x, dt, A, B, C) -> torch.Tensor:
        """y_t = sum_{u<=t} (C_t . B_u) exp(sum_{u<r<=t} dt_r A) dt_u x_u,
        chunk by chunk: x (s, nh, hd), dt (s, nh), A (nh,), B / C (s, ds)."""
        s, nh, hd = x.shape
        Q = min(int(self.c.get("ssm_chunk", 256)), s)
        if s % Q:
            Q = math.gcd(s, Q)
        nc = s // Q
        xc = (x * dt[..., None]).view(nc, Q, nh, hd)
        a = (dt * A).view(nc, Q, nh)
        cs = torch.cumsum(a, dim=1)                                     # (nc, Q, nh)
        Bc, Cc = B.view(nc, Q, -1), C.view(nc, Q, -1)
        CB = torch.einsum("ctn,cun->ctu", Cc, Bc)                       # (nc, Q, Q)
        if self.quant == "fp8":
            CB = _q8(CB)
        diff = cs[:, :, None, :] - cs[:, None, :, :]                    # (nc, t, u, nh)
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril_()
        L = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
        del diff
        y = torch.einsum("ctuh,cuhp->cthp", L * CB[..., None], xc)
        del L
        # the state entering each chunk, then its share of every output
        decay_out = torch.exp(cs[:, -1:, :] - cs)                       # (nc, Q, nh)
        chunk_state = torch.einsum("cuh,cun,cuhp->chpn", decay_out, Bc, xc)
        state = torch.zeros(nh, hd, Bc.shape[-1], dtype=torch.float32, device=x.device)
        entering = torch.empty(nc, nh, hd, Bc.shape[-1], dtype=torch.float32, device=x.device)
        total = torch.exp(cs[:, -1, :])                                 # (nc, nh)
        for ci in range(nc):
            entering[ci] = state
            state = state * total[ci][:, None, None] + chunk_state[ci]
        y = y + torch.einsum("cth,ctn,chpn->cthp", torch.exp(cs), Cc, entering)
        return y.reshape(s, nh, hd)

    def _ssm_layer(self, x, p):
        c = self.c
        g = lambda n: p[n].float()  # noqa: E731
        b, s, D = x.shape
        d_in = c["ssm_expand"] * c["d_model"]
        ds, hd = c["ssm_state"], c["ssm_head_dim"]
        nh = d_in // hd
        h = self.rmsnorm(x, g("ln1/scale"))
        z = self.mm(h, g("w_z"))
        xBC = self.mm(h, g("w_xBC"))
        dt = F.softplus(self.mm(h, g("w_dt")) + g("dt_bias"))
        A = -torch.exp(g("A_log"))
        w, cb = g("conv_w"), g("conv_b")
        width = w.shape[0]
        pad = F.pad(xBC, (0, 0, width - 1, 0))
        conv = sum(pad[:, k:k + s, :] * w[k] for k in range(width)) + cb
        xBC = F.silu(conv)
        xs, B, C = xBC[..., :d_in], xBC[..., d_in:d_in + ds], xBC[..., d_in + ds:]
        y = torch.stack([self._ssd(xs[r].reshape(s, nh, hd), dt[r], A, B[r], C[r])
                         for r in range(b)])
        y = y + g("D")[None, None, :, None] * xs.reshape(b, s, nh, hd)
        y = y.reshape(b, s, d_in) * F.silu(z)
        y = self.rmsnorm(y, g("gate_norm"))
        return x + self.mm(y, g("w_out"))

    # -- the model -----------------------------------------------------------

    @torch.no_grad()
    def last_logits(self, P: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
        """(b, V) float32 logits of every row's last position."""
        c = self.c
        x = P["embed/table"].float()[tokens.long()]
        layer = self._ssm_layer if c["family"] == "ssm" else self._dense_layer
        stacked = {k[len("blocks/pos0/"):]: v for k, v in P.items()
                   if k.startswith("blocks/pos0/")}
        for l in range(c["num_layers"]):
            x = layer(x, {k: v[l] for k, v in stacked.items()})
        h = self.norm(x[:, -1], P, "final_norm")
        W = P["embed/table"].t() if c["tie_embeddings"] else P["lm_head/w"]
        return self.mm(h, W)


def logit_gap(output: np.ndarray, ref: torch.Tensor) -> float:
    """The widest gap between a served output (b, k) and the reference's
    first k logits, in units of the reference row's RMS over the whole
    vocabulary; infinite for an output of the wrong shape or not finite."""
    ref = ref.detach().double().cpu()
    out = np.asarray(output, dtype=np.float64)
    if out.ndim != 2 or out.shape[0] != ref.shape[0] or out.shape[1] > ref.shape[1]:
        return math.inf
    if not np.isfinite(out).all():
        return math.inf
    k = out.shape[1]
    rms = ref.square().mean(dim=1).sqrt().clamp(min=1e-30)
    gap = (torch.from_numpy(out) - ref[:, :k]).abs().amax(dim=1) / rms
    return float(gap.max())
