#!/usr/bin/env python3
"""Device time of the port's flash-attention kernel, for one or more
checkouts in turns on one GPU (compare versions only within one run).

    python3 scripts/bench_flash.py SRC [SRC ...] [--json OUT]

Each SRC is a checkout's ``src`` directory; the sources run in the order
given, each in its own process (their packages share a name), so
``A B B A`` gives the turns of an A/B comparison.  Each process builds that
checkout's kernel, checks it against its plain version at chip_smoke.py's
tolerance, and times it at the cases below (chip_smoke.py phase 3's shapes
of the paths that launch it): the median device time of one call over
CUDA-graph replays (``chip_smoke.device_ms``).  The cases take no key
length or prefix other than the defaults, so a checkout from before
either was added runs them too.  Prints one JSON line per (source, case)
and the card's name and power limit; a process that builds the kernel
also prints the registers and spills ``ptxas`` gave each instantiation.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, b, nh, nkv, S, hd, causal, dtype)
CASES = (
    ("faas-bench S=256", 1, 6, 6, 256, 64, True, "float32"),
    ("olmoe-1b-7b S=256", 1, 16, 16, 256, 128, True, "bfloat16"),
    ("grok-1-314b GQA 48:8 S=256", 1, 48, 8, 256, 128, True, "bfloat16"),
    ("jamba-v0.1-52b GQA 32:8 S=1024", 1, 32, 8, 1024, 128, True, "bfloat16"),
    ("whisper-small encoder S=1500", 1, 12, 12, 1500, 64, False, "bfloat16"),
    ("mistral-nemo GQA 32:8 S=4096", 1, 32, 8, 4096, 128, True, "bfloat16"),
)


def child(src: str) -> None:
    """Time every case with the package under ``src``."""
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    _build.load("flash_attention")
    log = _build.build_log.get("flash_attention", "")
    cs.emit({"src": src, "ptxas": [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln]})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, nh, nkv, S, hd, causal, dname in CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((b, h, S, hd), generator=gen, device=dev).to(dtype)
                   for h in (nh, nkv, nkv))
        kw = dict(scale=hd ** -0.5, causal=causal)
        out = flash_attention(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        tol = cs.TOL[dname]
        diff = (out.float() - ref.float()).abs()
        ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
        del ref
        cs.emit({"src": src, "case": label, "dtype": dname,
                 "kernel_ms": cs.device_ms(torch, [lambda: flash_attention(q, k, v, **kw)]),
                 "max_abs_err": float(diff.max()), "within_tolerance": ok})
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
        sys.exit("bench_flash: needs a GPU")
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
            sys.exit(f"bench_flash: {src} failed (exit {r.returncode})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card.stdout.strip(), "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
