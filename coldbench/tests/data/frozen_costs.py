# A verbatim copy of coldbench/costs.py as it stood before each configuration brought
# its own module; tests/test_coldbench_pins.py holds the new path to it exactly.
"""The yardstick: peaks of the card and what a call needs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at the 700 W
limit).  The kernel formulas are frozen copies of the program's bound
column: ``fwd_cost`` and ``allowed_pairs`` of
``kernels/flash_attention/kernel.py``, ``scan_cost`` of
``kernels/ssd/kernel.py``, and the patch's byte count of ``chip_smoke.py``
(every input byte read once, every output byte written once).
``forward_flops`` counts the model FLOPs a request's output needs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take: operations or bytes."""
    return max(ops / peak_flops, nbytes / HBM_BYTES_PER_S)


def allowed_pairs(S: int, Sk: int, *, causal: bool, window: int, prefix_len: int) -> int:
    """The (query, key) pairs the mask allows, in closed form."""
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
    """(operations, bytes) of a flash-attention forward: two products over
    the allowed pairs; q, k, v read and o written once."""
    pairs = allowed_pairs(S, Sk, causal=causal, window=window, prefix_len=prefix_len)
    q_elems, kv_elems = b * nh * S * hd, b * nkv * Sk * hd
    return 4.0 * b * nh * pairs * hd, (q_elems + 2 * kv_elems + q_elems) * itemsize


def scan_cost(b: int, l: int, nh: int, hd: int, ds: int, chunk: int,
              itemsize: int) -> Tuple[float, int]:
    """(operations, bytes) of an SSD scan: the causal half of C.B^T once
    per (batch, chunk); per (batch, head, chunk) the causal half of the
    scores x dt.x product and the C.state and state update products; x, B,
    C, dt, A, D read and y and the final state written once."""
    c = min(chunk, l)
    ops = (float(b * (l // c)) * c * (c + 1) * ds
           + float(b * nh * (l // c)) * (c * (c + 1) * hd + 4 * c * hd * ds))
    d_in, e = nh * hd, itemsize
    return ops, (2 * b * l * d_in * e + 2 * b * l * ds * e + 4 * b * l * nh
                 + 2 * 4 * nh + 4 * b * nh * hd * ds)


def patch_bytes(n_rows: int, row_bytes: int) -> int:
    """A ``replace`` patch of ``n_rows`` chunks: each chunk read once (base
    or diff), written once, and its selector read."""
    return 2 * n_rows * row_bytes + 4 * n_rows


def _itemsize(cfg: Dict) -> int:
    return 2 if cfg.get("dtype", "bfloat16") == "bfloat16" else 4


def flash_calls(cfg: Dict, b: int, s: int):
    """(operations, bytes) of each flash call of one forward."""
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]
    one = fwd_cost(b, cfg["num_heads"], cfg["num_kv_heads"], s, s, hd, _itemsize(cfg),
                   causal=True, window=0, prefix_len=0)
    return [one] * cfg["num_layers"]


def scan_calls(cfg: Dict, b: int, s: int):
    """(operations, bytes) of each ``ssd_scan`` call of one forward."""
    d_in = cfg.get("ssm_expand", 2) * cfg["d_model"]
    hd = cfg.get("ssm_head_dim", 64)
    one = scan_cost(b, s, d_in // hd, hd, cfg["ssm_state"], cfg.get("ssm_chunk", 256),
                    _itemsize(cfg))
    return [one] * cfg["num_layers"]


def forward_flops(cfg: Dict, b: int, s: int) -> float:
    """Model FLOPs the output of one request needs: every layer over every
    position (projections, attention over the causal pairs or the SSD
    scan, the conv), and the head at each row's last position."""
    D, L = cfg["d_model"], cfg["num_layers"]
    tokens = b * s
    if cfg["family"] == "ssm":
        d_in = cfg.get("ssm_expand", 2) * D
        ds, hd = cfg["ssm_state"], cfg.get("ssm_head_dim", 64)
        nh = d_in // hd
        proj = 2.0 * D * (2 * d_in + 2 * ds + nh) + 2.0 * d_in * D
        conv = 2.0 * cfg.get("ssm_conv", 4) * (d_in + 2 * ds)
        per_layer = tokens * (proj + conv) + sum(o for o, _ in scan_calls(cfg, b, s)) / L
    else:
        H, KV = cfg["num_heads"], cfg["num_kv_heads"]
        hd = cfg.get("head_dim") or D // H
        ffn = (3 if cfg.get("mlp_gated", True) else 2) * 2.0 * D * cfg["d_ff"]
        proj = 2.0 * D * (H + 2 * KV) * hd + 2.0 * H * hd * D
        per_layer = tokens * (proj + ffn) + flash_calls(cfg, b, s)[0][0]
    head = 2.0 * b * D * cfg["vocab_size"]
    return L * per_layer + head


def leaf_patch_rows(nbytes: int, chunk_bytes: int) -> int:
    return math.ceil(nbytes / chunk_bytes)
