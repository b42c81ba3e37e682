#!/usr/bin/env python3
"""Device time of the port's int8 decode-attention kernel, for one or more
checkouts in turns on one GPU (compare versions only within one run).

    python3 scripts/bench_decode_int8.py SRC [SRC ...] [--json OUT]

Each SRC is a checkout's ``src`` directory; the sources run in the order
given, each in its own process (their packages share a name), so
``A B B A`` gives the turns of an A/B comparison.  Each process builds that
checkout's kernel, checks it against its plain version at chip_smoke.py's
tolerance, and times it at the cases below: the median device time of one
call over CUDA-graph replays of calls cycling through input sets larger
than L2 (``chip_smoke.device_ms``), the eager time of one call, and the
HBM bound.  Prints one JSON line per (source, case) and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, b, nh, nkv, S, hd, pos, dtype): chip_smoke.py phase 3's int8 cases
CASES = (
    ("stablelm-3b S=2048 pos=1039", 1, 32, 32, 2048, 80, 1039, "bfloat16"),
    ("stablelm-3b S=2048 pos=1039", 1, 32, 32, 2048, 80, 1039, "float32"),
    ("stablelm-3b S=32768 b=1", 1, 32, 32, 32768, 80, 32767, "bfloat16"),
    ("stablelm-3b S=32768 b=8", 8, 32, 32, 32768, 80, 32767, "bfloat16"),
    ("mistral-nemo GQA 32:8 S=32768 b=1", 1, 32, 8, 32768, 128, 32767, "bfloat16"),
    ("mistral-nemo GQA 32:8 S=32768 b=8", 8, 32, 8, 32768, 128, 32767, "bfloat16"),
    ("MQA 8:1 hd 256 S=32768 b=1", 1, 8, 1, 32768, 256, 32767, "bfloat16"),
)


def child(src: str) -> None:
    """Time every case with the package under ``src``."""
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import (decode_attention_int8,
                                                      decode_attention_int8_ref, quantize_kv)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, nh, nkv, S, hd, pos, dname in CASES:
        dtype = getattr(torch, dname)
        live = min(pos + 1, S)
        e = torch.empty((), dtype=dtype).element_size()
        nbytes = 2 * b * live * nkv * hd + 2 * 4 * b * live * nkv + 2 * b * nh * hd * e + 4

        def make():
            q = torch.randn((b, nh, hd), generator=gen, device=dev).to(dtype)
            k = quantize_kv(torch.randn((b, S, nkv, hd), generator=gen, device=dev))
            v = quantize_kv(torch.randn((b, S, nkv, hd), generator=gen, device=dev))
            return q, *k, *v

        sets = [make() for _ in range(min(32, -(-cs.L2_ROTATE_BYTES // nbytes)))]
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        scale = hd ** -0.5
        q, k, ks, v, vs = sets[0]
        out = decode_attention_int8(q, k, ks, v, vs, pos_t, scale=scale)
        ref = decode_attention_int8_ref(q, k, ks, v, vs, pos, scale=scale)
        tol = cs.int8_tol(dname, ref)
        diff = (out.float() - ref.float()).abs()
        ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
        ms = cs.device_ms(torch, [lambda s=s: decode_attention_int8(*s, pos_t, scale=scale)
                                  for s in sets])
        cs.emit({"src": src, "case": label, "dtype": dname, "kernel_ms": ms,
                 "eager_ms": cs.eager_ms(torch, lambda: decode_attention_int8(
                     q, k, ks, v, vs, pos_t, scale=scale)),
                 "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                 "max_abs_err": float(diff.max()), "within_tolerance": ok,
                 "input_sets": len(sets)})
        del sets
        torch.cuda.empty_cache()
        if not ok:
            sys.exit(f"{src} {label} {dname}: outside {tol}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("srcs", nargs="+", help="checkouts' src directories, in turn order")
    ap.add_argument("--json", help="write every line to this file as well")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.srcs[0])
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_decode_int8: needs a GPU")
    rows = []
    for src in a.srcs:
        r = subprocess.run([sys.executable, __file__, "--child", os.path.abspath(src)],
                           capture_output=True, text=True)
        sys.stderr.write(r.stderr[-4000:])
        lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
        for ln in lines:
            print(json.dumps(ln), flush=True)
        rows += lines
        if r.returncode != 0:
            sys.exit(f"bench_decode_int8: {src} failed (exit {r.returncode})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card.stdout.strip(), "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
