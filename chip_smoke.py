#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; exits 0 only if all pass

Phases, each of which passes or makes the script exit non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit, the TF32 flags (set off: float32 matmuls in full float32);
2. build: ``nvcc`` builds every kernel under ``src/repro_torch/csrc``;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: error; device times of kernel, plain version and, for
   attention, PyTorch's ``scaled_dot_product_attention`` as a yardstick
   (never used by the port), each the median of 30 replays of a CUDA graph
   of the calls between CUDA events; the bound; and the kernel's time per
   eager call, host dispatch included;
4. the main path: faas-bench at full width served through ``Worker.invoke``
   on the card, forced-cold under every strategy plus a warm hit, checked
   against a CPU worker; the kernel launch counters are zeroed just before
   and read just after, and must show both kernels on the path;
5. stablelm-3b at full width (depth cut to 4 layers), bfloat16, served
   through ``Worker.invoke``;
6. the ``repro_torch.launch.serve`` entry point: the cluster on threads;
7. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX and nothing of the JAX package.  Without a GPU,
or without the repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
L2_ROTATE_BYTES = 150 * 10**6   # 3x the H100's 50 MB L2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


class Ctx:
    """What later phases and the summary need from earlier ones."""

    def __init__(self):
        self.cases = []           # one dict per kernel x shape
        self.launches = {}        # main-path launch counts
        self.card = ""


# --------------------------------------------------------------------- timing

def eager_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median time of one eager call between CUDA events: the device time,
    or the host's time to dispatch the call where that is longer (small
    kernels behind a Python wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fns, reps: int = 30, per_graph: int = 12) -> float:
    """Median device time of one call, with the host out of the way: the
    calls are captured into a CUDA graph (cycling through ``fns``, whose
    inputs differ so that a working set larger than L2 is not re-read from
    cache), and CUDA events around each replay are divided by the calls
    in it.  Median over ``reps`` replays, after a warm-up."""
    per_graph = max(per_graph, len(fns)) // len(fns) * len(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns * 2:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fns[i % len(fns)]()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    del graph
    return statistics.median(times)


# ------------------------------------------------------------------- phase 1

def phase_env(ctx, torch, rt):
    from repro_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"nvcc --version failed: {r.stderr.strip()}")
    ctx.card = smi("name,power.limit")
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": r.stdout.strip().splitlines()[-1],
          "nvidia_smi": ctx.card, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})


# ------------------------------------------------------------------- phase 2

def phase_build(ctx, torch, rt):
    from repro_torch import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in secs.items()}})
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)


# ------------------------------------------------------------------- phase 3

def _patch_inputs(torch, gen, n, c, dtype, dev):
    if dtype in (torch.float32, torch.bfloat16):
        base = torch.randn((n, c), generator=gen, device=dev).to(dtype)
        k = max(1, n // 2)
        diff = torch.randn((k, c), generator=gen, device=dev).to(dtype)
    else:
        hi = 256 if dtype == torch.uint8 else 1 << 30
        lo = 0 if dtype == torch.uint8 else -hi
        base = torch.randint(lo, hi, (n, c), generator=gen, device=dev).to(dtype)
        k = max(1, n // 2)
        diff = torch.randint(lo, hi, (k, c), generator=gen, device=dev).to(dtype)
    # about half the rows take a diff row, as a partly dirty leaf does
    pick = torch.rand((n,), generator=gen, device=dev) < 0.5
    rows = torch.randint(0, k, (n,), generator=gen, device=dev)
    sel = torch.where(pick, rows, torch.full_like(rows, -1)).to(torch.int32)
    return base, diff, sel


def _bits(torch, t):
    return t.contiguous().view(torch.uint8)


def patch_case(ctx, torch, gen, label, n, row_bytes, dtype, mode="replace", scale=1.0):
    from repro_torch.kernels.snapshot_patch import patch_apply, patch_apply_ref

    dev = torch.device("cuda")
    itemsize = torch.empty((), dtype=dtype).element_size()
    c = row_bytes // itemsize
    base, diff, sel = _patch_inputs(torch, gen, n, c, dtype, dev)
    out = patch_apply(base, diff, sel, mode=mode, scale=scale)
    ref = patch_apply_ref(base, diff, sel, mode=mode, scale=scale)
    torch.cuda.synchronize()
    exact = torch.equal(_bits(torch, out), _bits(torch, ref))
    err = float((out.double() - ref.double()).abs().max())
    if not exact:
        fail(f"snapshot_patch {label} {mode} {dtype}: not bit-exact (max err {err})")
    nbytes = 2 * n * row_bytes + 4 * n
    # the pooled base the worker patches lies in HBM, not in L2: cycle
    # through enough input sets that a replay cannot serve them from cache
    sets = [(base, diff, sel)] + [_patch_inputs(torch, gen, n, c, dtype, dev)
                                  for _ in range(-(-L2_ROTATE_BYTES // nbytes) - 1)]
    kw = dict(mode=mode, scale=scale)
    kernel_ms = device_ms(torch, [lambda s=s: patch_apply(*s, **kw) for s in sets])
    plain_ms = device_ms(torch, [lambda s=s: patch_apply_ref(*s, **kw) for s in sets])
    case = {"kernel": "snapshot_patch", "case": label, "mode": mode,
            "dtype": str(dtype).replace("torch.", ""), "n": n, "row_bytes": row_bytes,
            "bit_exact": exact, "max_abs_err": err, "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: patch_apply(base, diff, sel, **kw)),
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}
    ctx.cases.append(case)
    emit(case)


def device_patch_tail_case(torch, gen):
    """The worker's own route, ragged tail chunk padded, against the CPU."""
    import numpy as np
    from repro_torch.serving.worker import device_patch

    cb = 64 * 1024
    base = torch.randn((1000, 37), generator=gen, device="cuda")
    n = -(-base.numel() * 4 // cb)
    rng = np.random.default_rng(0)
    sel = np.where(rng.random(n) < 0.5, rng.integers(0, 2, n), -1).astype(np.int32)
    rows = rng.integers(0, 256, (2, cb), dtype=np.uint8)
    out = device_patch(base, rows, sel, cb)
    ref = device_patch(base.cpu(), rows, sel, cb)
    if not torch.equal(_bits(torch, out.cpu()), _bits(torch, ref)):
        fail("worker device_patch with a padded tail chunk differs from the CPU")
    emit({"kernel": "snapshot_patch", "case": "worker device_patch, padded tail",
          "shape": list(base.shape), "chunks": n, "bit_exact": True})


def flash_case(ctx, torch, gen, label, b, nh, nkv, S, hd, dtype, *, causal=True,
               window=0, softcap=0.0):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, S, h, hd), generator=gen, device=dev).to(dtype)
               for h in (nh, nkv, nkv))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # the op's views
    scale = hd ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    out = flash_attention(qt, kt, vt, **kw)
    ref = attention_ref(qt, kt, vt, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if not bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all()):
        fail(f"flash_attention {label}: max abs err {err} outside {tol}")
    # q, k, v were just written by the projections: L2-resident is the
    # main path's case, so one input set is replayed
    kernel_ms = device_ms(torch, [lambda: flash_attention(qt, kt, vt, **kw)])
    plain_ms = device_ms(torch, [lambda: attention_ref(qt, kt, vt, **kw)])
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    allowed = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        allowed &= kp <= qp
    if window > 0:
        allowed &= qp - kp < window
    pairs = int(allowed.sum())
    ops = 4.0 * b * nh * pairs * hd
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    t_ops = ops / PEAK_OPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    library_ms = None
    if softcap == 0.0:
        rep = nh // nkv
        ke, ve = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        mask = None if (causal and window == 0) else allowed
        library_ms = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask, is_causal=mask is None and causal, scale=scale)])
    case = {"kernel": "flash_attention", "case": label, "dtype": dname,
            "b": b, "nh": nh, "nkv": nkv, "S": S, "hd": hd, "causal": causal,
            "window": window, "softcap": softcap, "max_abs_err": err,
            "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: flash_attention(qt, kt, vt, **kw)),
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}
    ctx.cases.append(case)
    emit(case)


def phase_kernels(ctx, torch, rt):
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16, i32, u8 = torch.float32, torch.bfloat16, torch.int32, torch.uint8
    faas_embed = 16384 * 384 * 4                  # faas-bench embed/table bytes
    stablelm_embed = 50304 * 2560 * 2             # stablelm-3b embed/table bytes
    # the main path's case first: faas-bench embed/table, worker default chunks
    patch_case(ctx, torch, gen, "faas-bench embed/table, 64 KiB chunks",
               faas_embed // 65536, 65536, u8)
    for dt in (f32, bf16, i32):
        patch_case(ctx, torch, gen, "faas-bench embed/table, 64 KiB chunks",
                   faas_embed // 65536, 65536, dt)
    patch_case(ctx, torch, gen, "faas-bench embed/table, 256 KiB chunks",
               faas_embed // 262144, 262144, f32)
    patch_case(ctx, torch, gen, "stablelm-3b embed/table, 64 KiB chunks",
               stablelm_embed // 65536, 65536, bf16)
    patch_case(ctx, torch, gen, "row width not a multiple of 16 bytes", 300, 1000, u8)
    for dt in (f32, bf16):
        patch_case(ctx, torch, gen, "faas-bench embed/table, 64 KiB chunks",
                   faas_embed // 65536, 65536, dt, mode="add", scale=0.5)
    device_patch_tail_case(torch, gen)

    # the main path's case first: faas-bench, S 256
    for S in (256, 4, 16, 100):
        flash_case(ctx, torch, gen, f"faas-bench S={S}", 1, 6, 6, S, 64, f32)
    flash_case(ctx, torch, gen, "stablelm-3b S=256", 1, 32, 32, 256, 80, bf16)
    for dt in (f32, bf16):
        flash_case(ctx, torch, gen, "GQA 4:1", 1, 8, 2, 256, 64, dt)
        flash_case(ctx, torch, gen, "MQA (reduced gemma-2b)", 1, 4, 1, 100, 32, dt)
        flash_case(ctx, torch, gen, "window 16", 1, 6, 6, 256, 64, dt, window=16)
        flash_case(ctx, torch, gen, "window 64", 1, 6, 6, 256, 64, dt, window=64)
        flash_case(ctx, torch, gen, "softcap 20", 1, 6, 6, 256, 64, dt, softcap=20.0)
    flash_case(ctx, torch, gen, "bidirectional, ragged", 2, 4, 2, 77, 80, f32, causal=False)


# --------------------------------------------------------------- phases 4-6

def _counters():
    from repro_torch.kernels import flash_attention, snapshot_patch

    return {"snapshot_patch": snapshot_patch.launches,
            "flash_attention": flash_attention.launches}


def _reset():
    for c in _counters().values():
        c.reset()


def _read():
    return {k: c.value for k, c in _counters().items()}


def _invoke(worker, fn, tokens, strategy, force_cold):
    from repro_torch.serving import ColdStartOptions, InvocationRequest

    return worker.invoke(InvocationRequest(
        function=fn, tokens=tokens,
        options=ColdStartOptions(strategy=strategy, force_cold=force_cold)))


STRATEGIES = ("regular", "reap", "seuss", "snapfaas-", "snapfaas", "auto")


def phase_faas(ctx, torch, rt):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_flat, params_to_flat
    from repro_torch.models import build_model
    from repro_torch.serving.trace import build_functions, request_tokens

    cfg = get_config("faas-bench")
    model = build_model(cfg)
    base = model.init(0, device="cuda")
    base_cpu = params_from_flat(params_to_flat(base), "cpu", template=model.param_shapes())
    gpu, specs = build_functions(os.path.join(rt, "faas-gpu"), cfg, model, n_functions=3,
                                 device="cuda", base_params=base)
    cpu, _ = build_functions(os.path.join(rt, "faas-cpu"), cfg, model, n_functions=3,
                             device="cpu", base_params=base_cpu)
    toks = {s.name: request_tokens(s, np.random.default_rng(7), cfg.vocab_size, seq=256)
            for s in specs}
    cpu_out = {s.name: _invoke(cpu, s.name, toks[s.name], "regular", True).output
               for s in specs}
    forwards = 0
    patch_in_snapfaas = 0
    _reset()                                        # main path starts here
    for s in specs:
        outs = {}
        for strat in STRATEGIES:
            before = _counters()["snapshot_patch"].value
            r = _invoke(gpu, s.name, toks[s.name], strat, True)
            forwards += 1
            if strat == "snapfaas":
                patch_in_snapfaas += _counters()["snapshot_patch"].value - before
            outs[strat] = r.output
            emit({"phase": "faas", "function": s.name, "strategy": strat,
                  "resolved": str(r.strategy), "cold": r.cold,
                  "boot_s": r.boot_s, "exec_s": r.exec_s})
        w = _invoke(gpu, s.name, toks[s.name], "snapfaas", False)
        forwards += 1
        if w.cold:
            fail(f"faas-bench {s.name}: the warm hit was cold")
        emit({"phase": "faas", "function": s.name, "strategy": "warm",
              "cold": False, "exec_s": w.exec_s})
        for strat, o in outs.items():
            if not np.isfinite(o).all() or o.shape != (1, 8):
                fail(f"faas-bench {s.name} {strat}: output {o.shape} not finite")
            if not np.allclose(o, outs["regular"], rtol=1e-5, atol=1e-6):
                fail(f"faas-bench {s.name}: {strat} differs from regular")
        err = float(np.abs(outs["regular"] - cpu_out[s.name]).max())
        if not np.allclose(outs["regular"], cpu_out[s.name], rtol=1e-4, atol=1e-4):
            fail(f"faas-bench {s.name}: GPU vs CPU worker differ by {err}")
        emit({"phase": "faas", "function": s.name, "gpu_vs_cpu_max_abs_err": err,
              "tolerance": "rtol 1e-4, atol 1e-4"})
    counts = _read()                                # main path ends here
    ctx.launches = counts
    emit({"phase": "faas", "launches": counts, "forwards": forwards,
          "patch_launches_in_snapfaas_cold_starts": patch_in_snapfaas})
    if patch_in_snapfaas <= 0:
        fail("the patch kernel never launched during the snapfaas cold starts")
    if counts["flash_attention"] != cfg.num_layers * forwards:
        fail(f"flash launches {counts['flash_attention']} != layers x forwards "
             f"{cfg.num_layers * forwards}")


def phase_stablelm(ctx, torch, rt):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.trace import build_functions, request_tokens

    full = get_config("stablelm-3b")
    cfg = dataclasses.replace(full, num_layers=4)
    emit({"phase": "stablelm", "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
          "d_model": cfg.d_model, "heads": cfg.num_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype})
    model = build_model(cfg)
    t0 = time.perf_counter()
    worker, specs = build_functions(os.path.join(rt, "stablelm"), cfg, model,
                                    n_functions=3, device="cuda")
    emit({"phase": "stablelm", "setup_s": time.perf_counter() - t0})
    _reset()
    forwards = 0
    for s in specs:
        toks = request_tokens(s, np.random.default_rng(3), cfg.vocab_size, seq=256)
        outs = {}
        for strat in ("regular", "snapfaas"):
            r = _invoke(worker, s.name, toks, strat, True)
            forwards += 1
            outs[strat] = r.output
            emit({"phase": "stablelm", "function": s.name, "strategy": strat,
                  "boot_s": r.boot_s, "exec_s": r.exec_s})
        w = _invoke(worker, s.name, toks, "snapfaas", False)
        forwards += 1
        outs["warm"] = w.output
        for k, o in outs.items():
            if not np.isfinite(o).all():
                fail(f"stablelm-3b {s.name} {k}: non-finite output")
            if not np.allclose(o, outs["regular"], rtol=1e-3, atol=1e-3):
                fail(f"stablelm-3b {s.name}: {k} differs from regular")
    counts = _read()
    emit({"phase": "stablelm", "launches": counts, "forwards": forwards})
    if counts["snapshot_patch"] <= 0:
        fail("stablelm-3b: the patch kernel never ran on the bf16 leaves")
    if counts["flash_attention"] != cfg.num_layers * forwards:
        fail("stablelm-3b: flash launches != layers x forwards")


def phase_serve(ctx, torch, rt):
    from repro_torch.launch import serve

    _reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(["--workers", "2", "--functions", "3", "--requests", "8",
                    "--strategies", "snapfaas", "auto", "--device", "cuda",
                    "--root", os.path.join(rt, "serve")])
    counts = _read()
    text = buf.getvalue()
    start = text.index("\n[") + 1
    rows, _ = json.JSONDecoder().raw_decode(text[start:])
    emit({"phase": "serve", "seconds": time.perf_counter() - t0, "launches": counts,
          "rows": rows})
    if counts["flash_attention"] <= 0:
        fail("launch.serve: no flash launches")
    if sorted(r["strategy"] for r in rows) != ["auto", "snapfaas"]:
        fail(f"launch.serve: unexpected rows {rows}")


# ------------------------------------------------------------------- summary

KERNELS = {
    "snapshot_patch": ("src/repro_torch/csrc/snapshot_patch.cu",
                       "src/repro/kernels/snapshot_patch/kernel.py:41"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:101"),
}


def summary(ctx):
    out = []
    for name, (source, replaces) in KERNELS.items():
        cases = [c for c in ctx.cases if c["kernel"] == name and "kernel_ms" in c]
        main = cases[0]                  # the main path's shape (listed first)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": ctx.launches[name],
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ms": main["kernel_ms"], "eager_ms": main["eager_ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "at": main["case"]})
    emit({"kernels": out})


PHASES = (("env", phase_env), ("build", phase_build), ("kernels", phase_kernels),
          ("faas", phase_faas), ("stablelm", phase_stablelm), ("serve", phase_serve))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")

    ctx = Ctx()
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as rt:
        for name, run in PHASES:
            t0 = time.perf_counter()
            run(ctx, torch, rt)
            emit({"phase_done": name, "seconds": time.perf_counter() - t0})
    if set(ctx.launches) != set(KERNELS):
        fail("the main path's launch counts were not read")
    for name in KERNELS:
        if ctx.launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    summary(ctx)
    emit({"total_s": time.perf_counter() - t_all})
    print(ctx.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
