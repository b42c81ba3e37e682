#!/usr/bin/env python3
"""Device time of the port's SSD scan backward (``ssd_scan_bwd``), for one or
more checkouts in turns on one GPU (compare versions only within one run).

    python3 scripts/bench_ssd_bwd.py SRC [SRC ...] [--json OUT]

Each SRC is a checkout's ``src`` directory; the sources run in the order
given, each in its own process (their packages share a name), so
``A B B A`` gives the turns of an A/B comparison.  Each process builds that
checkout's kernels, checks the backward against its plain version
``ssd_bwd_ref`` at chip_smoke.py's tolerances (of each gradient's largest
entry: float32 5e-5, dA 1e-4, bf16 2e-2) and times it at chip_smoke.py's SSD
backward cases: the median device time of one call over CUDA-graph
replays (``chip_smoke.device_ms``) and the eager time of one call.  Prints
one JSON line per (source, case) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, b, l, nh, hd, ds, chunk, dtype): chip_smoke.py's ssd_bwd_cases
CASES = (
    ("mamba2-780m train b=4 l=1024", 4, 1024, 48, 64, 128, 256, "bfloat16"),
    ("mamba2-780m train b=4 l=1024", 4, 1024, 48, 64, 128, 256, "float32"),
    ("mamba2-780m f32 step b=2 l=512", 2, 512, 48, 64, 128, 256, "float32"),
    ("jamba-v0.1-52b train l=1024", 1, 1024, 128, 64, 16, 256, "bfloat16"),
    ("jamba-v0.1-52b train l=1024", 1, 1024, 128, 64, 16, 256, "float32"),
    ("mamba2-780m l=8192 (32 chunks)", 1, 8192, 48, 64, 128, 256, "bfloat16"),
)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def child(src: str) -> None:
    """Check and time every case with the package under ``src``."""
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_scan_bwd
    from repro_torch.kernels.ssd.kernel import ssd_scan_for_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    for label, b, l, nh, hd, ds, chunk, dname in CASES:
        dtype = getattr(torch, dname)
        d_in = nh * hd
        xbc = torch.randn((b, l, d_in + 2 * ds), generator=gen, device=dev).to(dtype)
        args = (xbc[..., :d_in].reshape(b, l, nh, hd),
                torch.rand((b, l, nh), generator=gen, device=dev) * 0.49 + 0.01,
                -(torch.rand((nh,), generator=gen, device=dev) * 1.5 + 0.5),
                xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:],
                torch.randn((nh,), generator=gen, device=dev))
        dy = torch.randn((b, l, nh, hd), generator=gen, device=dev).to(dtype)
        dS = torch.randn((b, nh, hd, ds), generator=gen, device=dev)
        _, _, cs_, s_in = ssd_scan_for_grad(*args, chunk=chunk)

        def call():
            return ssd_scan_bwd(*args, dy, dS, cs_, s_in, chunk=chunk)

        got = call()
        plain = ssd_bwd_ref(*args, dy, dS, chunk=chunk)
        errs = {n: float((g.double() - r.double()).abs().max() / r.double().abs().max())
                for n, g, r in zip(NAMES, got, plain)}
        tol = {n: 2e-2 if dname == "bfloat16" else (1e-4 if n == "dA" else 5e-5)
               for n in NAMES}
        ok = all(errs[n] <= tol[n] for n in NAMES)
        cs.emit({"src": src, "case": label, "dtype": dname,
                 "kernel_ms": cs.device_ms(torch, [call], reps=10, per_graph=2),
                 "eager_ms": cs.eager_ms(torch, call, reps=10, warmup=2),
                 "rel_err_plain": errs, "within_tolerance": ok})
        del got, plain, xbc, args, dy, dS, cs_, s_in
        torch.cuda.empty_cache()
        if not ok:
            sys.exit(f"{src} {label} {dname}: relative errors {errs} outside {tol}")


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
        sys.exit("bench_ssd_bwd: needs a GPU")
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
            sys.exit(f"bench_ssd_bwd: {src} failed (exit {r.returncode})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card.stdout.strip(), "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
