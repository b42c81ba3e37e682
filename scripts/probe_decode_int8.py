#!/usr/bin/env python3
"""Where the int8 decode kernel's time goes, on one GPU: the experiments
behind its design notes in PERF.md.

    python3 scripts/probe_decode_int8.py [--json OUT]

Three probes, each printed as JSON lines, then the card's name and power
limit:

- ``timeline``: the kernel rebuilt with ``%globaltimer`` stamps per CTA
  (start, q and first loads issued, key loop done, merge done, each
  cluster barrier passed, end), for one call with L2 flushed, as
  percentiles over the CTAs, beside the device time of an empty kernel of
  the same launch in a CUDA graph;
- ``plans``: device time of the same call under other launch plans: the
  decode path's shape with its clusters of 8, with the ticket alone
  (clusters of 1), and with clusters of 4 in 2 groups; one head a CTA
  against the planned four at S 32768;
- ``parts``: the kernel rebuilt without its arithmetic (loads only) and
  without its loads (arithmetic only), at long caches.

Times are medians of CUDA-graph replays between CUDA events, inputs
cycling through more than L2 (``chip_smoke.device_ms``).  The variant
builds are copies of ``csrc/decode_attention_int8.cu`` with text swapped
in, compiled by ``nvcc`` into ``build/probe_decode_int8/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "build", "probe_decode_int8")
SRC = os.path.join(HERE, "src", "repro_torch", "csrc", "decode_attention_int8.cu")

# (label, b, nh, nkv, S, hd, pos)
PATH = ("stablelm-3b S=2048 pos=1039", 1, 32, 32, 2048, 80, 1039)
LONG = (("stablelm-3b S=32768 b=1", 1, 32, 32, 32768, 80, 32767),
        ("stablelm-3b S=32768 b=8", 8, 32, 32, 32768, 80, 32767),
        ("mistral-nemo GQA 32:8 S=32768 b=8", 8, 32, 8, 32768, 128, 32767))


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"probe_decode_int8: the source no longer holds {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """Sources of the probe builds (name -> text)."""
    stamp = ("  if (tid == 0) {{ unsigned long long* d = g_stamps + 8 * cta; "
             "d[{i}] = stamp(); }}\n")
    t = _sub(src, "namespace {\n", "namespace {\n__device__ unsigned long long g_stamps[8 << 16];\n"
             "__device__ __forceinline__ unsigned long long stamp() {\n"
             "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
             "  return t;\n}\n")
    t = _sub(t, "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
             "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
             "  const size_t cta = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + "
             "(size_t)gridDim.y * blockIdx.z);\n" + stamp.format(i=0))
    t = _sub(t, "  // this warp's task in every stage: 32 keys of head h_w\n",
             stamp.format(i=1) + "  // this warp's task in every stage: 32 keys of head h_w\n")
    t = _sub(t, "  __syncthreads();  // q visible where no stage was waited on; the ring is free\n",
             "  __syncthreads();  // q visible where no stage was waited on; the ring is free\n"
             + stamp.format(i=2))
    t = _sub(t, "  // every CTA of the cluster is past its ring: peers may now write into the\n",
             stamp.format(i=3) + "  // every CTA of the cluster is past its ring: peers may now write "
             "into the\n")
    t = _sub(t, "  cluster.sync();\n\n  // the CTA's partial per head",
             "  cluster.sync();\n" + stamp.format(i=4) + "\n  // the CTA's partial per head")
    t = _sub(t, "  cluster.sync();  // every push has landed; no shared memory is read remotely "
             "after this\n", stamp.format(i=5) + "  cluster.sync();  // every push has landed; no "
             "shared memory is read remotely after this\n" + stamp.format(i=6))
    t = _sub(t, "  if (!my_part) return;\n", stamp.format(i=7) + "  if (!my_part) return;\n")
    t += ('\nextern "C" int probe_stamps(void* dst, int n) {\n'
          "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n")
    empty = _sub(src, "  extern __shared__ __align__(128) unsigned char smem[];\n",
                 "  extern __shared__ __align__(128) unsigned char smem[];\n"
                 "  if (p.nsplit > 0) return;\n")
    i0 = src.index("      // q . k: lane = key\n")
    i1 = src.index("    __syncthreads();  // the stage is consumed before it is loaded again\n")
    loads_only = (src[:i0] + "      m[0] = fmaxf(m[0], (float)sk[lane] + sks[lane]);\n    }\n"
                  + src[i1:])
    no_loads = _sub(_sub(src, "        cp_async16(sk + dst, kp + off, ok);\n"
                         "        cp_async16(sv + dst, vp + off, ok);\n", ""),
                    "      cp_async4(ss, p.ks + so, ok);\n"
                    "      cp_async4(ss + 4 * L.keys * H, p.vs + so, ok);\n", "")
    return {"stamped": t, "empty": empty, "loads_only": loads_only, "no_loads": no_loads}


def build(names_texts: dict) -> dict:
    """Compile each source with the port's flags, all at once; name -> CDLL."""
    from repro_torch import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in names_texts.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, pr in procs.items():
        log = pr.communicate()[0]
        if pr.returncode:
            raise SystemExit(f"probe_decode_int8: nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    return libs


def entry(lib):
    fn = lib.decode_attention_int8_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, p, p] + [i] * 12 + [ctypes.c_float, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every line to this file")
    a = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import decode_attention_int8, quantize_kv
    from repro_torch.kernels.decode_attention import kernel as km

    if not torch.cuda.is_available():
        sys.exit("probe_decode_int8: needs a GPU")
    with open(SRC) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def out(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def inputs(case, sets=1):
        _, b, nh, nkv, S, hd, pos = case
        made = []
        for _ in range(sets):
            q = torch.randn((b, nh, hd), generator=gen, device=dev).bfloat16()
            k = quantize_kv(torch.randn((b, S, nkv, hd), generator=gen, device=dev))
            v = quantize_kv(torch.randn((b, S, nkv, hd), generator=gen, device=dev))
            made.append((q, *k, *v))
        return made, torch.tensor([pos], dtype=torch.int32, device=dev)

    def timed(sets, pos_t, hd):
        return cs.device_ms(torch, [lambda s=s: decode_attention_int8(*s, pos_t, scale=hd ** -0.5)
                                    for s in sets])

    built = list(km._fn_cache)
    try:
        # timeline at the path shape and the long caches
        for case in (PATH,) + LONG:
            label, b, nh, nkv, S, hd, pos = case
            (s0,), pos_t = inputs(case)
            plan = km.plan_for(dev, torch.bfloat16, b, S, nh, nkv, hd)
            km._fn_cache[:] = [entry(libs["empty"])]
            empty = timed([s0], pos_t, hd)
            km._fn_cache[:] = [entry(libs["stamped"])]
            for _ in range(3):
                decode_attention_int8(*s0, pos_t, scale=hd ** -0.5)
            flush = torch.empty(cs.L2_ROTATE_BYTES // 4, device=dev)
            flush.fill_(1.0)
            torch.cuda.synchronize()
            decode_attention_int8(*s0, pos_t, scale=hd ** -0.5)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (8 * plan.ctas))()
            if libs["stamped"].probe_stamps(buf, 8 * 8 * plan.ctas) != 0:
                raise SystemExit("probe_decode_int8: reading the stamps failed")
            t = np.frombuffer(buf, dtype=np.uint64).reshape(plan.ctas, 8).astype(np.int64)
            us = (t - t[:, :1].min()) / 1000.0

            def pct(x):
                return [round(float(np.percentile(x, q)), 2) for q in (0, 50, 90, 100)]

            out({"probe": "timeline", "case": label, "ctas": plan.ctas,
                 "empty_kernel_in_graph_ms": empty, "us_percentiles": "0 50 90 100",
                 "start": pct(us[:, 0]), "issue_and_q": pct(us[:, 1] - us[:, 0]),
                 "loop": pct(us[:, 2] - us[:, 1]), "merge": pct(us[:, 3] - us[:, 2]),
                 "barrier_1": pct(us[:, 4] - us[:, 3]), "push": pct(us[:, 5] - us[:, 4]),
                 "barrier_2": pct(us[:, 6] - us[:, 5]), "combine": pct(us[:, 7] - us[:, 6]),
                 "end": pct(us[:, 7])})
            del s0, flush
        km._fn_cache[:] = built

        # other launch plans
        splits, long_slices = km._splits, km.LONG_SLICES
        nsets = 27
        sets, pos_t = inputs(PATH, nsets)
        hd = PATH[5]
        for name, fn in (("planned", splits), ("ticket alone", lambda u, c: (min(c, 8), 1)),
                         ("clusters of 4 x 2", lambda u, c: (8, 4))):
            km._splits = fn
            km.launch_plan.cache_clear()
            plan = km.launch_plan(torch.bfloat16, PATH[1], PATH[4], PATH[2], PATH[3], hd,
                                  km.sm_count(dev))
            out({"probe": "plans", "case": PATH[0], "plan": name, "splits": plan.splits,
                 "cluster": plan.cluster, "groups": plan.groups, "ms": timed(sets, pos_t, hd)})
        km._splits = splits
        del sets
        for case in LONG[1:2]:
            label, b, nh, nkv, S, hd, pos = case
            sets, pos_t = inputs(case)
            for name, ls in (("planned", long_slices), ("one head a CTA", 10**9)):
                km.LONG_SLICES = ls
                km.launch_plan.cache_clear()
                plan = km.launch_plan(torch.bfloat16, b, S, nh, nkv, hd, km.sm_count(dev))
                out({"probe": "plans", "case": label, "plan": name, "heads": plan.heads,
                     "splits": plan.splits, "ms": timed(sets, pos_t, hd)})
            del sets
        km.LONG_SLICES = long_slices
        km.launch_plan.cache_clear()

        # loads only, arithmetic only
        for case in LONG[1:]:
            label, b, nh, nkv, S, hd, pos = case
            sets, pos_t = inputs(case)
            row = {"probe": "parts", "case": label}
            for name, lib in (("full", None), ("loads only", libs["loads_only"]),
                              ("arithmetic only", libs["no_loads"])):
                km._fn_cache[:] = built if lib is None else [entry(lib)]
                row[name] = timed(sets, pos_t, hd)
            out(row)
            del sets
    finally:
        km._fn_cache[:] = built
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
