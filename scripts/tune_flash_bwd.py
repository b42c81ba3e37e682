#!/usr/bin/env python3
"""Time tiling variants of the port's flash-attention backward side by side
on one GPU (compare variants only within one run).

    python3 scripts/tune_flash_bwd.py [VARIANT ...]

A VARIANT is ``dtype:width:kwg,bq,kv_stages,cs,qwg,bk,q_stages`` (dtype bf16
or f32): the instantiation of that (dtype, width) in
``csrc/flash_attention_bwd.cu`` is replaced by the given dK / dV warpgroups,
q rows a step, stages, column halves and dQ warpgroups, keys a step,
stages (``BWD_TILING`` in ``kernels/flash_attention/kernel.py``).  The
source as it stands runs first, as ``base``.  Each variant is built into its
own library under ``build/tune/`` (all builds at once), its SASS is counted
per kernel (HGMMA; DEPBAR, the waits: one per HGMMA means ptxas serialised
the products; STL, register spills), and the backward is timed at the
widths it changes (all widths for ``base``): the median device time of one
call over CUDA-graph replays (``chip_smoke.device_ms``), with its error
against the plain version.  Prints one line per variant and the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402

SOURCE = os.path.join(HERE, "src", "repro_torch", "csrc", "flash_attention_bwd.cu")
OUT = os.path.join(HERE, "build", "tune")
# (label, b, nh, nkv, S, hd, dtype, mask): chip_smoke.py phase 11's shapes
SHAPES = [("stablelm-3b train", 4, 32, 32, 1024, 80, torch.bfloat16, dict(causal=True)),
          ("GQA 32:8", 1, 32, 8, 1024, 128, torch.bfloat16, dict(causal=True)),
          ("paligemma-3b", 1, 8, 1, 512, 256, torch.bfloat16,
           dict(causal=True, prefix_len=256)),
          ("whisper-small encoder", 1, 12, 12, 1500, 64, torch.bfloat16,
           dict(causal=False)),
          ("stablelm-3b f32", 1, 32, 32, 1024, 80, torch.float32, dict(causal=True)),
          ("paligemma-3b f32", 1, 8, 1, 512, 256, torch.float32,
           dict(causal=True, prefix_len=256))]


def variants(specs):
    src = open(SOURCE).read()
    out = [("base", src, {})]
    for spec in specs:
        dt, width, tiling = spec.split(":")
        tup = tuple(int(x) for x in tiling.split(","))
        ctype = "__nv_bfloat16" if dt == "bf16" else "float"
        pat = re.compile(r"Instance<%s, %s, [\d, ]+>" % (ctype, width))
        if not pat.search(src):
            raise SystemExit(f"{spec}: no instantiation of {ctype} at width {width}")
        text = pat.sub(f"Instance<{ctype}, {width}, {', '.join(map(str, tup))}>", src)
        out.append((spec, text, {(2 if dt == "bf16" else 4, int(width)): tup}))
    return out


def build(i, text):
    """Library path and per-kernel SASS counts, or None and the error."""
    cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"libv{i}.so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        return None, r.stderr[-2000:]
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        k = re.search(r"flash_bwd_(dq|dkv)I(13__nv_bfloat16|f)Li(\d+)", fn.split("\n", 1)[0])
        if k:
            ops = [ln for ln in fn.split("\n") if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            counts[f"{k.group(1)} {'bf16' if 'bf' in k.group(2) else 'f32'} {k.group(3)}"] = {
                op: sum(op in ln for ln in ops) for op in ("HGMMA", "DEPBAR", " STL")}
    return so, counts


def bind(so):
    lib = ctypes.CDLL(so)
    fn, occ = lib.flash_attention_bwd, lib.flash_attention_bwd_occupancy
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i] + [p] * 13 + [i] * 6 + [p, f, i, i, i, f, i, i, p, p]
    fn.restype = ctypes.c_int
    occ.argtypes, occ.restype = [i, i, p], ctypes.c_int
    return fn, occ


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_bwd.py needs a GPU")
    os.makedirs(OUT, exist_ok=True)
    vs = variants(sys.argv[1:])
    with ThreadPoolExecutor(len(vs)) as ex:
        built = list(ex.map(lambda iv: build(iv[0], iv[1][1]), enumerate(vs)))
    base_tiling = dict(K.BWD_TILING)
    for (name, _, tiling), (so, counts) in zip(vs, built):
        if so is None:
            print(f"{name}: build failed\n{counts}", flush=True)
            continue
        K._bwd_fn_cache[:] = bind(so)
        K.BWD_TILING.clear()
        K.BWD_TILING.update(base_tiling)
        K.BWD_TILING.update(tiling)
        K.bwd_launch_plan.cache_clear()
        times = {}
        for label, b, nh, nkv, S, hd, dt, mask in SHAPES:
            key = (dt.itemsize, K.bwd_launch_plan(dt, hd).width)
            if tiling and key not in tiling:
                continue
            g = torch.Generator(device="cuda").manual_seed(0)
            q, do = (torch.randn((b, nh, S, hd), generator=g, device="cuda").to(dt)
                     for _ in "qo")
            k, v = (torch.randn((b, nkv, S, hd), generator=g, device="cuda").to(dt)
                    for _ in "kv")
            kw = dict(scale=hd ** -0.5, **mask)
            o, lse = K.flash_attention(q, k, v, return_lse=True, **kw)
            got = K.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
            err = max(float((a.float() - c.float()).abs().max() / c.float().abs().max())
                      for a, c in zip(got, want))
            ms = cs.device_ms(torch, [lambda: K.flash_attention_bwd(q, k, v, o, do, lse, **kw)],
                              reps=10, per_graph=4)
            times[label] = {"ms": ms, "rel_err": err}
        changed = {k: c for k, c in counts.items()
                   if not tiling or any(k.endswith(f" {w}") and k.split()[1] ==
                                        ("bf16" if isz == 2 else "f32") for isz, w in tiling)}
        print({"variant": name, "times": times, "sass": changed}, flush=True)
    print(cs.smi("name,power.limit"), flush=True)


if __name__ == "__main__":
    main()
