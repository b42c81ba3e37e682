#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; exits 0 only if all pass

Phases, each of which passes or makes the script exit non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit, the TF32 flags (set off: float32 matmuls in full float32);
2. build: ``nvcc`` builds every kernel under ``src/repro_torch/csrc``; the
   count of HGMMA and HMMA instructions in the flash (forward and
   backward) and ssd_scan (forward and backward) libraries' SASS, which
   must show both in each (wgmma for bf16, mma.sync for the 3xTF32 float32
   path), and the SSD backward's FFMA count beside them; for the int8
   library the I2F count (and each I2F variant apart: integer
   division emits them too), PRMT and HMMA; ptxas's registers and spills
   of every kernel;
3. the four kernels (snapshot_patch, flash_attention, ssd_scan,
   decode_attention_int8) against their plain PyTorch versions on the card,
   at their paths' shapes (patch also at olmoe-1b-7b's embed/table and
   expert leaves; flash also at olmoe-1b-7b's S 256, jamba-v0.1-52b's
   GQA 32:8 S 1024 and grok-1-314b's GQA 48:8 S 256, at whisper-small's
   encoder (S 1500, bidirectional) and cross-attention (S 64 and 448 over
   Sk 1500), at paligemma-3b's prefix-LM mask (MQA 8:1 x 256, S 512,
   prefix 256), and at bf16 prefill lengths, S 1024 to 4096; ssd_scan
   also at jamba's prefill shape and over 32 chunks, with the CUDA kernels
   it enqueues per call; int8 decode also at mistral-nemo and MQA S 32768,
   and the CUDA kernels one call enqueues, which must be one): error; device
   times of kernel, plain version and, for attention, PyTorch's
   ``scaled_dot_product_attention`` as a yardstick (never used by the
   port) and, for int8 decode, the model-dtype ``decode_attention`` on the
   unquantised cache, each the median of 30 replays of a CUDA graph of the
   calls between CUDA events; the bound (float32 flash and ssd_scan against
   3xTF32's 495 / 3 TFLOP/s); and the kernel's time per eager call, host dispatch
   included;
4. the dense path: faas-bench at full width served through
   ``Worker.invoke`` on the card, forced-cold under every strategy plus a
   warm hit, checked against a CPU worker; the kernel launch counters are
   zeroed just before and read just after, and must show patch and flash
   on the path;
5. stablelm-3b at full width (depth cut to 2 layers), bfloat16, served
   through ``Worker.invoke``;
6. the SSM path: mamba2-780m at full width (depth cut to 8 layers),
   bfloat16, three delta-uploaded functions served through
   ``Worker.invoke`` with 1024-token requests (4 SSD chunks), forced-cold
   ``regular`` and ``snapfaas`` plus a warm hit; counters zeroed just
   before and read just after must show ``ssd_scan`` once per layer per
   forward, no flash, and patch launches; one function checked against a
   CPU worker; then the same model in float32, every logits row of a
   1024-token forward against the CPU, where a forward without the
   carried state must fail;
7. the MoE path, the main path of the MoE slice: olmoe-1b-7b at full width
   (depth cut to 2 layers), bfloat16, three delta-uploaded functions served
   through ``Worker.invoke`` with 256-token requests, forced-cold
   ``regular`` and ``snapfaas`` plus a warm hit; counters zeroed just before
   and read just after must show flash once per layer per forward and
   patch launches; the tokens dropped per layer (adapter requests must
   drop some); one ``moe_ffn`` at the path's shape under
   ``torch.cuda.set_sync_debug_mode("error")``; then float32 logits of
   every row of a 256-token forward against the CPU, the routing (chosen
   and kept experts per token and layer) compared first, where k-major
   slot priority must fail;
8. prefill and decode through ``make_prefill_step`` / ``make_serve_step``:
   stablelm-3b (2 layers, bf16) prefills 1024 tokens into a 2048 cache
   (one flash launch per layer, timed between CUDA events in two further
   prefills: as it runs, and with the card held busy so that the events
   bracket device time alone) and decodes 32 teacher-forced tokens, each
   step's logits against one forward over the 1056 tokens; beside every
   decode step's attention the int8 kernel runs on that step's quantised
   cache (its own path: layers x steps launches), held to its plain
   version and within 2% of the model-dtype result; the same model in
   float32 holds every step to the forward at 1e-4, where a decode rotated
   one position off must fail; then mamba2-780m
   (8 layers, float32) prefills 768 tokens (one ``ssd_scan`` per layer,
   whose final state seeds the cache) and decodes 256, every step against
   a 1024-token forward, where a decode from a zeroed SSM state must fail;
   then olmoe-1b-7b (2 layers) prefills 512 into a 1024 cache and decodes
   32, timed in bf16, and in float32 at the drop-free capacity E / K
   holds every step at 1e-4 (a one-position RoPE fault must fail); then
   jamba-v0.1-52b at full width (one period of 8 layers, 13.3 B
   parameters) prefills 1024 into a 2048 cache (1 flash and 7 ssd_scan
   launches) and decodes 32, timed in bf16, and in float32 (53 GB),
   drop-free, holds every step at 1e-4, where a zeroed SSM state must fail;
9. the encoder-decoder and the VLM prefix-LM through the step builders,
   both whole (full width and depth), bf16: whisper-small (12 encoder +
   12 decoder layers) over 1500 stub frame embeddings with a 64-token
   prompt into its 448-token text context, then 32 decode steps (36 flash
   launches a prefill: encoder, decoder self- and cross-attention);
   paligemma-3b (18 layers) with 256 stub patch embeddings and 256 text
   tokens into a 1024 cache, then 32 steps (18 flash launches with the
   prefix mask); prefill s, decode ms per token, peak GiB; then each in
   float32, every text row of a forward on the card against the CPU at
   1e-4, where whisper's encoder run causal and paligemma's prefix dropped
   must fail, and prefill + 32 decode steps against that forward at 1e-4,
   where whisper's decode from zeroed cross keys and values must fail;
10. grok-1-314b at full width (depth cut to 1 layer), bf16: a 256-token
   forward, finite logits, one flash launch per forward; then float32
   logits of every row against the CPU, routing compared first, where the
   experts' tanh gelu swapped for the exact one must fail;
11. the fault and record paths: a two-worker faas-bench cluster on the
   card whose first invocation crashes its worker (``FaultMatrix(
   crash_after=1)``), its outputs bit-equal to a clean worker's, one crash,
   the request recovered and the crashed worker's functions served by the
   survivor from its device copies (patch launches in the failover); REAP
   record mode (``Worker.record_function``) then two forced demand-paged
   replays with 0 demand faults and equal outputs; the chaos replay CLI
   ``repro_torch.launch.replay --chaos remote-outage`` on the card, with
   conservation, the four typed failure keys, fatal faults inside the
   outage, completions after it and fail-fast reads; the phase's patch
   and flash launches;
12. distribution, one rank through NCCL on a (1, 1) ("data", "model")
   mesh: ``moe_ffn_sharded`` at olmoe-1b-7b's full width (64 experts, top
   8, bf16, b 2 x S 256) against ``moe_ffn``, bit-equal on one rank, both
   timed (median of 30 eager calls between CUDA events) and one call of
   each profiled; a 2-layer olmoe-1b-7b forward under
   ``logical_axis_rules`` against the same forward unbound, bit-equal (the
   MoE layers must take ``moe_ffn_sharded``);
   ``ef_compressed_mean`` of a (2560, 2560) CUDA tensor (one shot within
   0.05, the 20-step error-feedback average within 0.01, a carried error);
   stablelm-3b's ``Rules.param_specs`` distributed as DTensors;
13. training: the flash backward kernel (``flash_attention_bwd``) against
   its plain version and against autograd through the plain forward in
   float64 at faas-bench, stablelm-3b (bf16 at the train run's b 4 x S
   1024, and f32), GQA 32:8, a gemma-2-style window 256 with softcap 50,
   paligemma's prefix (bf16 and f32), whisper's encoder and its
   cross-attention (f32 5e-5, bf16 2e-2 of each gradient's largest entry),
   with controls that must fail (the causal mask dropped, the softcap's
   1 - tanh^2 dropped, GQA without the sum over the group), two calls
   bit-equal, device times beside the bound, the forward with and without
   lse, and SDPA's backward by autograd; one float32 train step of
   stablelm-3b at full width (2 layers, b 2 x S 256) against the CPU, where
   attention's output detached must fail; 10 bf16 steps of it at b 4 x S
   1024 through the ``Trainer`` with async checkpoints every 5 (counters
   zeroed just before and read just after: 2 flash forwards and 2
   backwards a step), and 10 float32 steps of faas-bench whole; crash at
   step 17 and resume through ``python -m repro_torch.launch.train``, whose
   resumed losses must equal an uninterrupted run's at rtol 1e-4; then the
   SSM families: the ``ssd_scan`` backward (``ssd_scan_bwd``) against its
   plain version and float64 autograd through the plain forward at
   mamba2-780m's train shape (b 4 x l 1024, bf16 and f32), at its float32
   step's shape (where the kernel called on each chunk alone, the
   inter-chunk state gradient dropped, must fail), at jamba-v0.1-52b's
   width (bf16 and f32) and over 32 chunks (f32 5e-5, dA 1e-4, bf16 2e-2
   of each gradient's largest entry), two calls bit-equal, each case
   printing the plan's head group, grid and waves, the chunk kernel's CTAs
   an SM (the plan's, and the runtime's: fewer fails), registers and
   spills, the scratch bytes and the tensor-core operations a call issues
   beside the bound's; one
   float32 mamba2-780m step at full width (2 layers, b 2 x S 512: two
   chunks) against a CPU step whose SSD scan runs in float64, where that
   chunkwise backward must fail; mamba2-780m whole (48 layers, bf16, b 4
   x S 1024, 10 steps, AdamW, no checkpoints: 48 ``ssd_scan_bwd`` launches
   a step); one jamba-v0.1-52b period (8 layers, bf16, b 1 x S 1024, 3
   steps, Adafactor accumulating in bf16: 1 flash forward and backward, 7
   ``ssd_scan`` forwards and backwards a step); each of the two with one
   more step profiled (device busy time, idle share, the kernels that
   hold it, each SSD kernel's launches and time: the backward's five CUDA
   kernels once per mamba layer);
14. the ``repro_torch.launch.serve`` entry point: the cluster on threads;
15. the dry run held to the card: stablelm-3b (2 layers at full width)
   train b 4 x S 1024 with AdamW and mamba2-780m (whole) prefill b 1 x S
   4096, each built by ``launch.specs.build_cell`` on a (1, 1) mesh,
   traced on meta under ``opcost`` and then run with real tensors from a
   seed: the kernel calls the trace booked must equal the launches the
   counters read, kernel by kernel; the median of 5 steps beside the
   trace's ``t_compute``, ``t_memory`` and the MFU; one profiled step's
   busy ms beside the booked kernels' share; then
   ``python -m repro_torch.launch.dryrun`` on olmoe-1b-7b ``train_4k``,
   both production meshes, its summary lines printed.

Then the ``{"kernels": [...]}`` summary (each kernel with its launches on
the path named, and on every path), the ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line.

About 10.5 minutes on one H100, the kernels' build included.

It imports nothing of JAX and nothing of the JAX package.  Without a GPU,
or without the repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
# the float32 flash kernel runs 3xTF32 on the tensor cores: three TF32
# products (495 TFLOP/s) for each float32 one
PEAK_OPS_3XTF32 = 495e12 / 3

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
L2_ROTATE_BYTES = 150 * 10**6   # 3x the H100's 50 MB L2

OLMOE_EMBED = 50304 * 2048 * 2            # olmoe-1b-7b embed/table bytes (bf16)
OLMOE_W_IN = 2 * 64 * 2048 * 1024 * 2     # its ffn/w_in at 2 layers (bf16)


def int8_tol(dname: str, ref) -> dict:
    """The int8 decode kernel's tolerance against its plain version: TOL,
    with the bf16 absolute term cut to 1e-2 of max|ref|.  Attention over a
    long random cache averages its values down (|out| about 0.01 at S 32768),
    so a flat 2e-2 would exceed the output itself; 1e-2 of the largest
    output is about one bf16 ulp of it, and the 2e-2 relative term allows
    two to three ulps of each element."""
    tol = dict(TOL[dname])
    if dname == "bfloat16":
        tol["atol"] = min(tol["atol"], 1e-2 * float(ref.float().abs().max()))
    return tol


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
        self.paths = {}           # per path: every kernel's launches in its run
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
            if ("Used" in line and "registers" in line) or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
    # wgmma (bf16) and mma.sync (3xTF32) in each; the SSD backward's FFMA
    # count beside them (its elementwise steps and sums)
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"):
        sass = sass_counts(_build, name, ("HGMMA", "HMMA", "FFMA") if name == "ssd_scan_bwd"
                           else ("HGMMA", "HMMA"))
        emit({"phase": "build", f"{name}_sass": sass})
        if sass != "not measured" and (sass["HGMMA"] == 0 or sass["HMMA"] == 0):
            fail(f"{name}'s SASS lacks tensor-core instructions: {sass}")
    # the int8 kernel converts int8 to float by a byte permute; integer
    # division emits I2F too, so each I2F variant is counted apart
    emit({"phase": "build", "decode_attention_int8_sass": sass_counts(
        _build, "decode_attention_int8", ("I2F", "PRMT", "HMMA"), variants="I2F")})


def sass_counts(_build, name, opcodes=("HGMMA", "HMMA"), variants=None):
    """Instructions of each opcode in a built library, by the cuobjdump
    beside nvcc: by default HGMMA (wgmma: the bf16 path) and HMMA
    (mma.sync: the 3xTF32 path); ``variants``: also each full opcode that
    starts with it (I2F.U32.RP, I2F.F64.U64, ...)."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return "not measured"
    r = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                       capture_output=True, text=True)
    if r.returncode != 0:
        return "not measured"
    ops = []
    for ln in r.stdout.splitlines():
        words = ln.split()
        if len(words) > 2 and words[0].startswith("/*") and words[0].endswith("*/"):
            ops.append(words[2] if words[1].startswith("@") else words[1])
    counts = {name: sum(op.startswith(name) for op in ops) for name in opcodes}
    if variants:
        for op in sorted({op for op in ops if op.startswith(variants)}):
            counts[op] = ops.count(op)
    return counts


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


def _allowed(torch, S, Sk, causal, window, prefix_len):
    """The (S, Sk) boolean mask of the allowed (query, key) pairs, on the card."""
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    allowed = torch.ones((S, Sk), dtype=torch.bool, device="cuda")
    if causal:
        allowed &= (kp <= qp) | (kp < prefix_len)
    if window > 0:
        allowed &= qp - kp < window
    return allowed


def flash_case(ctx, torch, gen, label, b, nh, nkv, S, hd, dtype, *, Sk=None, causal=True,
               window=0, softcap=0.0, prefix_len=0, quick=False):
    """The kernel against its plain version; ``Sk`` keys (S unless given);
    ``quick``: fewer replays of the plain version and SDPA (their S x Sk
    scores are GBs at prefill lengths)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.kernel import fwd_cost

    dev = torch.device("cuda")
    Sk = S if Sk is None else Sk
    q, k, v = (torch.randn((b, n, h, hd), generator=gen, device=dev).to(dtype)
               for n, h in ((S, nh), (Sk, nkv), (Sk, nkv)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # the op's views
    scale = hd ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
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
    reps = dict(reps=10, per_graph=2) if quick else {}
    kernel_ms = device_ms(torch, [lambda: flash_attention(qt, kt, vt, **kw)])
    plain_ms = device_ms(torch, [lambda: attention_ref(qt, kt, vt, **kw)], **reps)
    # the bound: the formula the dry run books (kernel.fwd_cost)
    ops, nbytes = fwd_cost(b, nh, nkv, S, Sk, hd, q.element_size(), causal=causal,
                           window=window, prefix_len=prefix_len)
    peak = PEAK_OPS_3XTF32 if dname == "float32" else PEAK_OPS[dname]
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    library_ms = None
    if softcap == 0.0:
        rep = nh // nkv
        ke, ve = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        # no mask where SDPA's own causal or full attention is the same
        plain_causal = causal and prefix_len == 0 and Sk == S
        mask = (None if window == 0 and (plain_causal or not causal)
                else _allowed(torch, S, Sk, causal, window, prefix_len))
        library_ms = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask, is_causal=mask is None and causal, scale=scale)],
            **reps)
    case = {"kernel": "flash_attention", "case": label, "dtype": dname,
            "b": b, "nh": nh, "nkv": nkv, "S": S, "Sk": Sk, "hd": hd, "causal": causal,
            "window": window, "softcap": softcap, "prefix_len": prefix_len,
            "max_abs_err": err,
            "ops": ops, "bytes": nbytes,
            "ops_peak": "3xTF32, 495/3 TFLOP/s" if dname == "float32" else "bf16, 989 TFLOP/s",
            "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: flash_attention(qt, kt, vt, **kw)),
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}
    ctx.cases.append(case)
    emit(case)


def ssd_case(ctx, torch, gen, label, b, l, nh, hd, ds, chunk, dtype, *, quick=False):
    """The kernel against its plain version; ``quick``: fewer replays of the
    plain version (a Python loop over many chunks)."""
    from repro_torch.kernels.ssd import ssd_ref, ssd_scan
    from repro_torch.kernels.ssd.kernel import launch_plan, scan_cost

    dev = torch.device("cuda")
    # x, B, C as the mixer hands them over: strided views into one xBC
    d_in = nh * hd
    xbc = torch.randn((b, l, d_in + 2 * ds), generator=gen, device=dev).to(dtype)
    x = xbc[..., :d_in].reshape(b, l, nh, hd)
    B, C = xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:]
    dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.49 + 0.01
    A = -(torch.rand((nh,), generator=gen, device=dev) * 1.5 + 0.5)
    D = torch.randn((nh,), generator=gen, device=dev)
    args = (x, dt, A, B, C, D)
    y, st = ssd_scan(*args, chunk=chunk)
    y_ref, st_ref = ssd_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    dy = (y.float() - y_ref.float()).abs()
    dst = (st - st_ref).abs()
    err, err_state = float(dy.max()), float(dst.max())
    if not bool((dy <= tol["atol"] + tol["rtol"] * y_ref.float().abs()).all()):
        fail(f"ssd_scan {label}: y max abs err {err} outside {tol}")
    if not bool((dst <= 1e-3 + 1e-3 * st_ref.abs()).all()):
        fail(f"ssd_scan {label}: state max abs err {err_state} outside 1e-3")
    # x was just written by the conv: L2-resident, one input set replayed
    kernel_ms = device_ms(torch, [lambda: ssd_scan(*args, chunk=chunk)])
    reps = dict(reps=10, per_graph=2) if quick else {}
    plain_ms = device_ms(torch, [lambda: ssd_ref(*args, chunk=chunk)], **reps)
    c = min(chunk, l)
    plan = launch_plan(dtype, hd, ds, c, batch=b, heads=nh, seq=l)
    # what the function needs: the formula the dry run books
    # (kernel.scan_cost; the kernel recomputes C.B^T for every head)
    ops, nbytes = scan_cost(b, l, nh, hd, ds, chunk, x.element_size())
    # the float32 path runs 3xTF32 on the tensor cores
    peak = PEAK_OPS_3XTF32 if dname == "float32" else PEAK_OPS[dname]
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"kernel": "ssd_scan", "case": label, "dtype": dname, "b": b, "l": l,
            "nh": nh, "hd": hd, "ds": ds, "chunk": chunk, "max_abs_err": err,
            "state_max_abs_err": err_state,
            "cuda_kernels_per_call": plan.kernels, "ctas": plan.ctas,
            "ops_peak": "3xTF32, 495/3 TFLOP/s" if dname == "float32" else "bf16, 989 TFLOP/s",
            "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: ssd_scan(*args, chunk=chunk)),
            "plain_ms": plain_ms, "ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
    ctx.cases.append(case)
    emit(case)


def graph_kernels(torch, fn):
    """Kernel nodes of a CUDA graph captured around one call of ``fn``
    (a second reading of the kernels a call enqueues, beside the profile)."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        rt = ctypes.CDLL("libcudart.so.12")
    except (TypeError, OSError):
        return "not measured"
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        return "not measured"
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        return "not measured"
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    return kinds.count(0)  # cudaGraphNodeTypeKernel


def kernels_per_call(torch, gen):
    """The CUDA kernels one call enqueues, read from one profile: ``ssd_scan``
    at mamba2-780m's shape (the plan's count), ``decode_attention_int8`` at
    the decode path's shape and at an MQA shape whose clusters combine
    through the ticket (one each; also counted in a captured CUDA graph)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import decode_attention_int8, quantize_kv
    from repro_torch.kernels.decode_attention.kernel import plan_for
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd.kernel import launch_plan

    dev = torch.device("cuda")
    b, l, nh, hd, ds, chunk = 1, 1024, 48, 64, 128, 256
    x = torch.randn((b, l, nh, hd), generator=gen, device=dev).bfloat16()
    B, C = (torch.randn((b, l, ds), generator=gen, device=dev).bfloat16() for _ in range(2))
    dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.49 + 0.01
    A = -(torch.rand((nh,), generator=gen, device=dev) * 1.5 + 0.5)
    D = torch.randn((nh,), generator=gen, device=dev)
    calls = {"ssd": lambda: ssd_scan(x, dt, A, B, C, D, chunk=chunk)}
    shapes = ((1, 32, 32, 2048, 80, 1039), (1, 8, 1, 32768, 64, 32767))
    for shape in shapes:
        ib, inh, inkv, S, ihd, pos = shape
        q = torch.randn((ib, inh, ihd), generator=gen, device=dev).bfloat16()
        k = quantize_kv(torch.randn((ib, S, inkv, ihd), generator=gen, device=dev))
        v = quantize_kv(torch.randn((ib, S, inkv, ihd), generator=gen, device=dev))
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        calls[shape] = (lambda q=q, k=k, v=v, pos_t=pos_t, ihd=ihd:
                        decode_attention_int8(q, *k, *v, pos_t, scale=ihd ** -0.5))
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ssd_names = [n for n in kernels if "ssd_" in n]
    plan = launch_plan(torch.bfloat16, hd, ds, chunk, batch=b, heads=nh, seq=l)
    emit({"kernel": "ssd_scan", "cuda_kernels_per_call": len(ssd_names) if ssd_names else
          "not measured", "plan_kernels": plan.kernels,
          "names": [re.search(r"ssd_\w+", n).group(0) for n in ssd_names],
          "grids": {"chunk_state": plan.grid_state, "state_pass": plan.grid_pass,
                    "chunk_scan": plan.grid_scan}})
    if ssd_names and len(ssd_names) != plan.kernels:
        fail(f"ssd_scan enqueued {len(ssd_names)} CUDA kernels, the plan {plan.kernels}")
    int8_names = [n for n in kernels if "decode_int8_kernel" in n]
    profiled = len(int8_names) / len(shapes) if int8_names else "not measured"
    for shape in shapes:
        ib, inh, inkv, S, ihd, pos = shape
        plan = plan_for(dev, torch.bfloat16, ib, S, inh, inkv, ihd)
        in_graph = graph_kernels(torch, calls[shape])
        emit({"kernel": "decode_attention_int8", "shape": list(shape),
              "cuda_kernels_per_call": profiled, "kernels_in_a_captured_graph": in_graph,
              "plan_kernels": plan.kernels, "names": sorted(set(int8_names)),
              "splits": plan.splits, "cluster": plan.cluster, "groups": plan.groups})
        counts = [c for c in (profiled, in_graph) if c != "not measured"]
        if not counts:
            fail("decode_attention_int8: the kernels a call enqueues were not measured")
        if any(c != 1 for c in counts):
            fail(f"decode_attention_int8 enqueued {counts} CUDA kernels a call, not 1")


def decode_case(ctx, torch, gen, label, b, nh, nkv, S, hd, pos, dtype, *, quick=False):
    """The int8 kernel against its plain version, on a cache quantised from
    random values in the model's dtype; beside it the model-dtype
    ``decode_attention`` on the unquantised cache, the traffic the int8
    cache is meant to halve.  ``quick``: fewer replays (caches of GBs)."""
    from repro_torch.kernels.decode_attention import (decode_attention_int8,
                                                      decode_attention_int8_ref,
                                                      quantize_kv)
    from repro_torch.kernels.decode_attention.kernel import cluster_slots, plan_for
    from repro_torch.models.attention import decode_attention

    dev = torch.device("cuda")
    dname = str(dtype).replace("torch.", "")
    scale = hd ** -0.5
    live = min(pos + 1, S)
    # the kernel's split layout: each warp of a split walks one 32-key slice
    # of each of its CTA's stages, rescaling its running (m, l, acc) from one
    # slice to the next
    plan = plan_for(dev, dtype, b, S, nh, nkv, hd)
    slices_per_warp = -(-(-(-live // plan.stage_keys)) // plan.splits)
    e = torch.empty((), dtype=dtype).element_size()
    # each input read once up to pos, the output written once
    nbytes = (2 * b * live * nkv * hd + 2 * 4 * b * live * nkv + 2 * b * nh * hd * e + 4)
    model_bytes = 2 * b * live * nkv * hd * e + 2 * b * nh * hd * e

    def make():
        q = torch.randn((b, nh, hd), generator=gen, device=dev).to(dtype)
        kf, vf = (torch.randn((b, S, nkv, hd), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        return q, kf, vf, (*quantize_kv(kf), *quantize_kv(vf))

    # a decode step reads a cache that lies in HBM, not in L2: cycle through
    # enough input sets that a replay cannot serve them from cache
    nsets = 1 if quick else min(32, -(-L2_ROTATE_BYTES // nbytes))
    sets = [make() for _ in range(nsets)]
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    q, kf, vf, (k, ks, v, vs) = sets[0]
    out = decode_attention_int8(q, k, ks, v, vs, pos_t, scale=scale)
    ref = decode_attention_int8_ref(q, k, ks, v, vs, pos, scale=scale)
    full = decode_attention(q[:, None], kf, vf, pos, scale=scale)[:, 0]
    torch.cuda.synchronize()
    tol = int8_tol(dname, ref)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if not bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all()):
        fail(f"decode_attention_int8 {label}: max abs err {err} outside {tol}")
    rel = float((out.float() - full.float()).abs().max() / full.float().abs().max())
    reps = dict(reps=10, per_graph=2) if quick else {}
    kernel_ms = device_ms(torch, [lambda s=s: decode_attention_int8(
        s[0], *s[3], pos_t, scale=scale) for s in sets], **reps)
    plain_ms = device_ms(torch, [lambda s=s: decode_attention_int8_ref(
        s[0], *s[3], pos_t, scale=scale) for s in sets], **reps)
    model_ms = device_ms(torch, [lambda s=s: decode_attention(
        s[0][:, None], s[1], s[2], pos_t, scale=scale) for s in sets], **reps)
    ops = 4.0 * b * nh * live * hd   # dequantised values: float32 on the CUDA cores
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"kernel": "decode_attention_int8", "case": label, "dtype": dname, "b": b,
            "nh": nh, "nkv": nkv, "S": S, "hd": hd, "pos": pos, "splits": plan.splits,
            "cluster": plan.cluster, "groups": plan.groups, "heads_a_cta": plan.heads,
            "rows": plan.rows,
            "slices_per_warp": slices_per_warp, "cuda_kernels_per_call": plan.kernels,
            # the plan's clusters against those the card holds at once
            "clusters": plan.units * plan.groups,
            "clusters_resident": cluster_slots(dev, dtype, plan),
            "max_abs_err": err, "tolerance": tol,
            "ref_max_abs": float(ref.float().abs().max()),
            "err_vs_model_dtype_rel": rel, "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: decode_attention_int8(
                q, k, ks, v, vs, pos_t, scale=scale)),
            "plain_ms": plain_ms, "model_dtype_decode_attention_ms": model_ms,
            "model_dtype_bound_ms": model_bytes / HBM_BYTES_PER_S * 1e3,
            "input_sets": nsets, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
    ctx.cases.append(case)
    emit(case)
    del sets
    torch.cuda.empty_cache()


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
    # the olmoe path's leaves, as the worker hands them over: bytes
    patch_case(ctx, torch, gen, "olmoe-1b-7b embed/table, 64 KiB chunks",
               OLMOE_EMBED // 65536, 65536, u8)
    patch_case(ctx, torch, gen, "olmoe-1b-7b ffn/w_in (2 layers), 64 KiB chunks",
               OLMOE_W_IN // 65536, 65536, u8)
    patch_case(ctx, torch, gen, "row width not a multiple of 16 bytes", 300, 1000, u8)
    for dt in (f32, bf16):
        patch_case(ctx, torch, gen, "faas-bench embed/table, 64 KiB chunks",
                   faas_embed // 65536, 65536, dt, mode="add", scale=0.5)
    device_patch_tail_case(torch, gen)

    # the main path's case first: faas-bench, S 256
    for S in (256, 4, 16, 100):
        flash_case(ctx, torch, gen, f"faas-bench S={S}", 1, 6, 6, S, 64, f32)
    flash_case(ctx, torch, gen, "stablelm-3b S=256", 1, 32, 32, 256, 80, bf16)
    flash_case(ctx, torch, gen, "olmoe-1b-7b S=256", 1, 16, 16, 256, 128, bf16)
    flash_case(ctx, torch, gen, "jamba-v0.1-52b GQA 32:8 S=1024", 1, 32, 8, 1024, 128, bf16,
               quick=True)
    for dt in (bf16, f32):  # grok's forward runs both: bf16, then float32 against the CPU
        flash_case(ctx, torch, gen, "grok-1-314b GQA 48:8 S=256", 1, 48, 8, 256, 128, dt)
    for dt in (f32, bf16):
        flash_case(ctx, torch, gen, "GQA 4:1", 1, 8, 2, 256, 64, dt)
        flash_case(ctx, torch, gen, "MQA (reduced gemma-2b)", 1, 4, 1, 100, 32, dt)
        flash_case(ctx, torch, gen, "window 16", 1, 6, 6, 256, 64, dt, window=16)
        flash_case(ctx, torch, gen, "window 64", 1, 6, 6, 256, 64, dt, window=64)
        flash_case(ctx, torch, gen, "softcap 20", 1, 6, 6, 256, 64, dt, softcap=20.0)
    flash_case(ctx, torch, gen, "bidirectional, ragged", 2, 4, 2, 77, 80, f32, causal=False)
    # the encdec phase's shapes: whisper-small's encoder over 1500 frames
    # (ragged: 23 tiles of 64 and 28 rows), its decoder's cross-attention of
    # a 64-token prompt and of its 448-token text context over those
    # frames, and paligemma-3b's prefix-LM mask over 256 patches; bf16, and
    # float32 where the phase's float32 forward runs them
    for dt in (bf16, f32):
        flash_case(ctx, torch, gen, "whisper-small encoder S=1500", 1, 12, 12, 1500, 64, dt,
                   causal=False, quick=True)
        flash_case(ctx, torch, gen, "whisper-small cross S=64 Sk=1500", 1, 12, 12, 64, 64, dt,
                   Sk=1500, causal=False)
        flash_case(ctx, torch, gen, "paligemma-3b MQA 8:1 S=512 prefix=256", 1, 8, 1, 512,
                   256, dt, prefix_len=256, quick=True)
    flash_case(ctx, torch, gen, "whisper-small cross S=448 Sk=1500", 1, 12, 12, 448, 64, bf16,
               Sk=1500, causal=False, quick=True)
    flash_case(ctx, torch, gen, "prefix ends mid-tile, GQA 4:2 S=200 prefix=77", 1, 4, 2, 200,
               64, f32, prefix_len=77)
    # prefill lengths, bf16: the issue's long-sequence configurations
    flash_case(ctx, torch, gen, "stablelm-3b prefill S=1024", 1, 32, 32, 1024, 80, bf16,
               quick=True)
    flash_case(ctx, torch, gen, "mistral-nemo GQA 32:8 S=4096", 1, 32, 8, 4096, 128, bf16,
               quick=True)
    flash_case(ctx, torch, gen, "gemma-2b MQA 8:1 S=1024", 1, 8, 1, 1024, 256, bf16,
               quick=True)
    flash_case(ctx, torch, gen, "gemma2-27b heads 32:16, softcap 50, S=4096", 1, 32, 16,
               4096, 128, bf16, softcap=50.0, quick=True)
    flash_case(ctx, torch, gen, "window 256, 32:16, S=2048", 1, 32, 16, 2048, 128, bf16,
               window=256, quick=True)
    torch.cuda.empty_cache()

    # the SSM path's case first: mamba2-780m, 1024-token request, 4 chunks
    m2 = dict(nh=48, hd=64, ds=128, chunk=256)
    ssd_case(ctx, torch, gen, "mamba2-780m l=1024", 1, 1024, dtype=bf16, **m2)
    ssd_case(ctx, torch, gen, "mamba2-780m l=256 (one chunk)", 1, 256, dtype=bf16, **m2)
    ssd_case(ctx, torch, gen, "mamba2-780m l=1024", 1, 1024, dtype=f32, **m2)
    ssd_case(ctx, torch, gen, "mamba2-780m l=1024 b=2", 2, 1024, dtype=bf16, **m2)
    for dt in (f32, bf16):  # tests/test_kernels.py's mamba2-like tile
        ssd_case(ctx, torch, gen, "b=2 l=64 nh=4 chunk=64", 2, 64, 4, 64, 128, 64, dt)
    # jamba-v0.1-52b's mixer as its prefill runs it (128 heads x 64, ds 16,
    # chunk 256, 1024 tokens); a long sequence, 32 chunks, where the state
    # passing walks its longest chain
    ssd_case(ctx, torch, gen, "jamba-v0.1-52b width l=1024", 1, 1024, 128, 64, 16, 256, bf16)
    ssd_case(ctx, torch, gen, "mamba2-780m l=8192 (32 chunks)", 1, 8192, dtype=bf16,
             quick=True, **m2)

    # the decode path's case first: stablelm-3b, b 1, cache 2048, the
    # decode phase's middle step (prefill 1024 + 32 steps)
    sl = dict(nh=32, nkv=32, hd=80)
    decode_case(ctx, torch, gen, "stablelm-3b S=2048 pos=1039", 1, S=2048, pos=1039,
                dtype=bf16, **sl)
    decode_case(ctx, torch, gen, "stablelm-3b S=2048 pos=1039", 1, S=2048, pos=1039,
                dtype=f32, **sl)
    nemo = dict(nh=32, nkv=8, hd=128)
    for b in (1, 8):  # the repo's decode_32k length
        decode_case(ctx, torch, gen, f"stablelm-3b S=32768 b={b}", b, S=32768,
                    pos=32767, dtype=bf16, quick=b > 1, **sl)
        decode_case(ctx, torch, gen, f"mistral-nemo GQA 32:8 S=32768 b={b}", b,
                    S=32768, pos=32767, dtype=bf16, quick=b > 1, **nemo)
    # float32 q where each split spans several tiles, so that 2e-5 holds the
    # cross-tile rescale; the last one ends mid-tile with splits past pos
    decode_case(ctx, torch, gen, "stablelm-3b S=32768 b=1", 1, S=32768, pos=32767,
                dtype=f32, **sl)
    decode_case(ctx, torch, gen, "mistral-nemo GQA 32:8 S=32768 b=1", 1, S=32768,
                pos=32767, dtype=f32, **nemo)
    decode_case(ctx, torch, gen, "mistral-nemo GQA 32:8 S=32768 b=8 pos=20000", 8,
                S=32768, pos=20000, dtype=f32, quick=True, **nemo)
    for pos in (76, 255):  # tests/test_kernels.py's MQA shape, pos_frac 0.3 and 1
        decode_case(ctx, torch, gen, f"MQA 8:1 S=256 pos={pos}", 1, 8, 1, 256, 64, pos, f32)
    decode_case(ctx, torch, gen, "ragged S=1000 GQA 2:1", 2, 4, 2, 1000, 32, 999, f32)
    # MQA at b 1 (gemma-2b's heads, and hd 64): the clusters of one kv head
    # combine through the ticket
    decode_case(ctx, torch, gen, "MQA 8:1 hd 256 S=32768 b=1", 1, 8, 1, 32768, 256, 32767,
                bf16)
    decode_case(ctx, torch, gen, "MQA 8:1 hd 64 S=32768 b=1", 1, 8, 1, 32768, 64, 32767, f32)
    if not any(c["kernel"] == "decode_attention_int8" and c["dtype"] == "float32"
               and c["slices_per_warp"] > 1 for c in ctx.cases):
        fail("no float32 int8 decode case has a warp walking several slices")
    if not any(c["kernel"] == "decode_attention_int8" and c["groups"] > 1
               for c in ctx.cases):
        fail("no int8 decode case combines clusters through the ticket")
    kernels_per_call(torch, gen)


# --------------------------------------------------------------- phases 4-6

def _counters():
    from repro_torch.kernels import decode_attention, flash_attention, snapshot_patch, ssd

    return {"snapshot_patch": snapshot_patch.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "ssd_scan": ssd.launches,
            "ssd_scan_bwd": ssd.bwd_launches,
            "decode_attention_int8": decode_attention.launches}


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
    ctx.paths["faas-bench served"] = counts
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
    cfg = dataclasses.replace(full, num_layers=2)
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
    ctx.paths["stablelm-3b served"] = counts
    emit({"phase": "stablelm", "launches": counts, "forwards": forwards})
    if counts["snapshot_patch"] <= 0:
        fail("stablelm-3b: the patch kernel never ran on the bf16 leaves")
    if counts["flash_attention"] != cfg.num_layers * forwards:
        fail("stablelm-3b: flash launches != layers x forwards")


def phase_mamba2(ctx, torch, rt):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_flat, params_to_flat
    from repro_torch.models import Batch, build_model
    from repro_torch.serving import Worker
    from repro_torch.serving.trace import build_delta_specs, request_tokens

    full = get_config("mamba2-780m")
    cfg = dataclasses.replace(full, num_layers=8)
    seq = 1024                      # 4 chunks of 256: the state carry runs
    emit({"phase": "mamba2", "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
          "d_model": cfg.d_model, "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "ssm_conv": cfg.ssm_conv, "ssm_chunk": cfg.ssm_chunk, "vocab": cfg.vocab_size,
          "tied": cfg.tie_embeddings, "dtype": cfg.dtype, "params": cfg.param_count(),
          "request_tokens": seq})
    model = build_model(cfg)
    t0 = time.perf_counter()
    worker = Worker(os.path.join(rt, "mamba2", "worker"), device="cuda")
    base = model.init(0, device="cuda")
    worker.register_runtime(cfg.name, model, base)
    specs = build_delta_specs(os.path.join(rt, "mamba2"), cfg, params_to_flat(base))
    for spec in specs:
        worker.register_function(spec)
    emit({"phase": "mamba2", "setup_s": time.perf_counter() - t0})
    toks = {s.name: request_tokens(s, np.random.default_rng(5), cfg.vocab_size, seq=seq)
            for s in specs}
    forwards = 0
    regular = {}
    _reset()                                        # SSM path starts here
    for s in specs:
        outs = {}
        for strat in ("regular", "snapfaas"):
            r = _invoke(worker, s.name, toks[s.name], strat, True)
            forwards += 1
            outs[strat] = r.output
            emit({"phase": "mamba2", "function": s.name, "strategy": strat,
                  "resolved": str(r.strategy), "cold": r.cold,
                  "boot_s": r.boot_s, "exec_s": r.exec_s})
        w = _invoke(worker, s.name, toks[s.name], "snapfaas", False)
        forwards += 1
        if w.cold:
            fail(f"mamba2-780m {s.name}: the warm hit was cold")
        emit({"phase": "mamba2", "function": s.name, "strategy": "warm",
              "cold": False, "exec_s": w.exec_s})
        outs["warm"] = w.output
        for k, o in outs.items():
            if o.shape != (1, 8) or not np.isfinite(o).all():
                fail(f"mamba2-780m {s.name} {k}: output {o.shape} not finite")
            if not np.array_equal(o, outs["regular"]):
                fail(f"mamba2-780m {s.name}: {k} differs from regular by "
                     f"{float(np.abs(o - outs['regular']).max())}")
        regular[s.name] = outs["regular"]
    counts = _read()                                # SSM path ends here
    ctx.paths["mamba2-780m served"] = counts
    emit({"phase": "mamba2", "launches": counts, "forwards": forwards})
    if counts["ssd_scan"] != cfg.num_layers * forwards:
        fail(f"mamba2-780m: ssd_scan launches {counts['ssd_scan']} != layers x "
             f"forwards {cfg.num_layers * forwards}")
    if counts["flash_attention"] != 0:
        fail("mamba2-780m: flash_attention launched on an attention-free model")
    if counts["snapshot_patch"] <= 0:
        fail("mamba2-780m: the patch kernel never ran on the bf16 leaves")

    # one function against a CPU worker (plain ssd_ref) on the same bytes
    tol = dict(rtol=5e-2, atol=5e-2)   # bf16 rounds at other places on the CPU
    t0 = time.perf_counter()
    spec = specs[0]
    base_cpu = params_from_flat(params_to_flat(base), "cpu", template=model.param_shapes())
    cpu = Worker(os.path.join(rt, "mamba2-cpu"), device="cpu")
    cpu.register_runtime(cfg.name, model, base_cpu)
    cpu.register_function(dataclasses.replace(spec, resolver=None))
    got = _invoke(cpu, spec.name, toks[spec.name], "regular", True).output
    err = float(np.abs(regular[spec.name] - got).max())
    emit({"phase": "mamba2", "function": spec.name, "gpu_vs_cpu_max_abs_err": err,
          "tolerance": tol, "cpu_check_s": time.perf_counter() - t0})
    if not np.allclose(regular[spec.name], got, **tol):
        fail(f"mamba2-780m {spec.name}: GPU vs CPU worker differ by {err}")

    # The worker's output is the last row, where exp(cs) has decayed the
    # carried state to nothing, so it cannot see the carry; in bf16 the
    # carry moves a chunk's first logits rows by less than the card and the
    # CPU round apart.  So the same model in float32: every logits row of a
    # 1024-token forward against the CPU, and a forward that drops the carry
    # (the scan restarted from a zero state at each chunk) must fail there.
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    p32 = m32.init(0, device="cuda")
    p32_cpu = params_from_flat(params_to_flat(p32), "cpu", template=m32.param_shapes())
    tok = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (1, seq), dtype=np.int32))
    with torch.no_grad():
        gpu_l = m32.logits(p32, Batch(tokens=tok.cuda()))[0].cpu().numpy()
        cpu_l = m32.logits(p32_cpu, Batch(tokens=tok))[0].numpy()
        with _ssd_without_carry():
            no_carry = m32.logits(p32, Batch(tokens=tok.cuda()))[0].cpu().numpy()
    tol32 = dict(rtol=1e-4, atol=1e-4)
    c = cfg.ssm_chunk
    starts = np.concatenate([np.arange(s, s + 16) for s in range(c, seq, c)])
    err = float(np.abs(gpu_l - cpu_l).max())
    emit({"phase": "mamba2", "check": "float32 logits, all rows, GPU vs CPU",
          "max_abs_err": err, "tolerance": tol32,
          "at_chunk_starts_max_abs_err": float(np.abs(gpu_l - cpu_l)[starts].max()),
          "no_carry_at_chunk_starts_max_abs_err":
              float(np.abs(no_carry - cpu_l)[starts].max()),
          "chunk_starts": f"[s, s + 16) for s = {c}, {2 * c}, {3 * c}",
          "seconds": time.perf_counter() - t0})
    if not np.isfinite(gpu_l).all() or not np.allclose(gpu_l, cpu_l, **tol32):
        fail(f"mamba2-780m float32: logits differ from the CPU by {err}")
    if np.allclose(no_carry, cpu_l, **tol32):
        fail("mamba2-780m float32: a forward without the carried state passes the "
             "check: it cannot see the carry")


def _decode_timed(torch, serve, params, cache, tokens, start, steps, offset=0):
    """``steps`` teacher-forced decode steps from token ``start``, at
    position ``offset`` on (a VLM prefix's length); returns the per-step
    logits (on the host) and the milliseconds per token."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for pos in range(start, start + steps):
        logits, cache = serve(params, cache, tokens[:, pos], pos + offset)
        outs.append(logits)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(outs, 1)[0].float().cpu().numpy(), ms


def _prefill_timed(torch, prefill, params, tokens, prefix=None):
    batch = {"tokens": tokens}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    return logits[0].float().cpu().numpy(), cache, time.perf_counter() - t0


def phase_decode(ctx, torch, rt):
    """Prefill and decode through the step builders: stablelm-3b with the
    int8 kernel run on every decode step's real cache, then mamba2-780m,
    whose prefill hands the SSD scan's final state to the decode."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Batch, build_model

    # -- stablelm-3b: prefill 1024 into a 2048 cache, decode 32 tokens
    full = get_config("stablelm-3b")
    cfg = dataclasses.replace(full, num_layers=2)
    prompt, steps, cache_len = 1024, 32, 2048
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, prompt + steps), dtype=np.int32)).cuda()
    prefill, serve = make_prefill_step(model, cache_len), make_serve_step(model)
    with torch.no_grad():
        forward = model.logits(params, Batch(tokens=tok))[0].float().cpu().numpy()
        checks = []
        _reset()                                    # the int8 kernel's path starts here
        with _int8_beside_decode(checks):
            first, cache, prefill_first_s = _prefill_timed(torch, prefill, params,
                                                           tok[:, :prompt])
            rows, ms_checked = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
        counts = _read()                            # and ends here
        # the same again without the int8 check beside it, for the times
        _, cache, prefill_s = _prefill_timed(torch, prefill, params, tok[:, :prompt])
        # twice more with CUDA events around each flash launch: as the
        # prefill runs (host dispatch included where the card waits for it),
        # and with the card held busy before each launch, so that the
        # events bracket the kernel's device time alone
        flash_events, flash_held = [], []
        with _flash_timed(torch, flash_events):
            _, _, prefill_events_s = _prefill_timed(torch, prefill, params, tok[:, :prompt])
        with _flash_timed(torch, flash_held, hold=True):
            _prefill_timed(torch, prefill, params, tok[:, :prompt])
        flash_ms = [a.elapsed_time(b) for a, b in flash_held]
        flash_stream_ms = [a.elapsed_time(b) for a, b in flash_events]
        shifted = _clone_cache(cache)
        _, decode_ms = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
        with _rope_off_by_one():
            bad_rows, _ = _decode_timed(torch, serve, params, shifted, tok, prompt, 8)
    ctx.paths["stablelm-3b prefill + decode"] = counts
    # bf16 weights and activations: the decode path rounds q, k, v and the
    # softmax weights (cast to bf16 before P.V, as JAX does) where the
    # forward's flash kernel keeps them in f32, and its GEMMs have other
    # shapes; logits of magnitude up to about 5 then differ by a few bf16
    # ulps.  At that tolerance a fault in the decode's positions need not
    # show (the off-by-one control's error is printed, not held): the
    # float32 run below is the check that sees it.
    tol = dict(rtol=2e-2, atol=1e-1)
    want = forward[prompt - 1:prompt + steps]
    got = np.concatenate([first, rows], 0)
    err = float(np.abs(got - want).max())
    int8_err = max(c["max_abs_err"] for c in checks)
    int8_rel = max(c["rel"] for c in checks)
    emit({"phase": "decode", "model": "stablelm-3b",
          "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}", "dtype": cfg.dtype,
          "prompt": prompt, "decode_steps": steps, "cache_len": cache_len,
          "launches": counts, "logits_vs_forward_max_abs_err": err,
          "tolerance": tol, "logits_max_abs": float(np.abs(want).max()),
          "rope_off_by_one_max_abs_err": float(np.abs(bad_rows - want[1:9]).max()),
          "int8_vs_plain_max_abs_err": int8_err,
          "int8_vs_model_dtype_rel_max": int8_rel,
          "int8_vs_model_dtype_rel_per_step": [round(c["rel"], 6) for c in checks],
          "prefill_s": prefill_s, "prefill_first_s": prefill_first_s,
          "flash_device_ms_in_prefill": sum(flash_ms), "flash_device_ms_per_layer": flash_ms,
          "flash_stream_ms_per_layer": flash_stream_ms,
          "prefill_s_with_flash_events": prefill_events_s,
          "flash_device_share_of_prefill": sum(flash_ms) / (prefill_events_s * 1e3),
          "flash_stream_share_of_prefill": sum(flash_stream_ms) / (prefill_events_s * 1e3),
          "decode_ms_per_token": decode_ms, "decode_ms_per_token_with_int8_check": ms_checked})
    if not np.isfinite(got).all() or not np.allclose(got, want, **tol):
        fail(f"stablelm-3b decode: logits differ from the forward's rows by {err}")
    if counts["flash_attention"] != cfg.num_layers or len(flash_held) != cfg.num_layers:
        fail(f"stablelm-3b prefill: flash launches {counts['flash_attention']} != layers")
    if counts["decode_attention_int8"] != cfg.num_layers * steps:
        fail(f"decode_attention_int8 launches {counts['decode_attention_int8']} != layers x "
             f"steps {cfg.num_layers * steps}")
    if int8_rel >= 0.02:
        fail(f"int8 decode attention is {int8_rel:.4f} of max|ref| from the model-dtype "
             "result on the stablelm-3b cache (bound 0.02)")
    del params, cache, shifted, forward
    torch.cuda.empty_cache()

    # -- stablelm-3b, float32: the same model and tokens; every step's logits
    # against the forward at 1e-4 (summation order only), where a decode that
    # rotates the new token's q and k one position off must fail
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = m32.init(0, device="cuda")
    prefill, serve = make_prefill_step(m32, cache_len), make_serve_step(m32)
    with torch.no_grad():
        forward = m32.logits(p32, Batch(tokens=tok))[0].cpu().numpy()
        first, cache, _ = _prefill_timed(torch, prefill, p32, tok[:, :prompt])
        shifted = _clone_cache(cache)
        rows, _ = _decode_timed(torch, serve, p32, cache, tok, prompt, steps)
        with _rope_off_by_one():
            bad_rows, _ = _decode_timed(torch, serve, p32, shifted, tok, prompt, 8)
    tol32 = dict(rtol=1e-4, atol=1e-4)
    want = forward[prompt - 1:prompt + steps]
    got = np.concatenate([first, rows], 0)
    err = float(np.abs(got - want).max())
    bad_err = float(np.abs(bad_rows - want[1:9]).max())
    emit({"phase": "decode", "model": "stablelm-3b", "dtype": "float32",
          "logits_vs_forward_max_abs_err": err, "tolerance": tol32,
          "rope_off_by_one_steps": 8, "rope_off_by_one_max_abs_err": bad_err})
    if not np.isfinite(got).all() or not np.allclose(got, want, **tol32):
        fail(f"stablelm-3b float32 decode: logits differ from the forward's rows by {err}")
    if np.allclose(bad_rows, want[1:9], **tol32):
        fail("stablelm-3b float32: a decode rotated one position off passes the check: "
             "it cannot see the decode's positions")
    del p32, cache, shifted, forward
    torch.cuda.empty_cache()

    # -- mamba2-780m, float32: prefill 768 (3 chunks), decode 256
    m_full = get_config("mamba2-780m")
    mcfg = dataclasses.replace(m_full, num_layers=8, dtype="float32")
    prompt, steps = 768, 256
    model = build_model(mcfg)
    params = model.init(0, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(17).integers(
        0, mcfg.vocab_size, (1, prompt + steps), dtype=np.int32)).cuda()
    prefill, serve = make_prefill_step(model, prompt + steps), make_serve_step(model)
    with torch.no_grad():
        forward = model.logits(params, Batch(tokens=tok))[0].cpu().numpy()
        _reset()
        first, cache, prefill_s = _prefill_timed(torch, prefill, params, tok[:, :prompt])
        ctx.paths["mamba2-780m prefill"] = _read()
        scans = ctx.paths["mamba2-780m prefill"]["ssd_scan"]
        zeroed = _clone_cache(cache)
        for d in zeroed.values():
            d["ssm"].zero_()
        rows, decode_ms = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
        zero_steps = 32
        zero_rows, _ = _decode_timed(torch, serve, params, zeroed, tok, prompt, zero_steps)
    tol32 = dict(rtol=1e-4, atol=1e-4)   # float32; summation order only
    want = forward[prompt - 1:prompt + steps]
    got = np.concatenate([first, rows], 0)
    err = float(np.abs(got - want).max())
    zero_err = float(np.abs(zero_rows - want[1:1 + zero_steps]).max())
    emit({"phase": "decode", "model": "mamba2-780m",
          "cut": f"num_layers {m_full.num_layers} -> {mcfg.num_layers}", "dtype": mcfg.dtype,
          "prompt": prompt, "decode_steps": steps, "ssd_scan_launches_in_prefill": scans,
          "logits_vs_forward_max_abs_err": err, "tolerance": tol32,
          "zeroed_state_steps": zero_steps, "zeroed_state_max_abs_err": zero_err,
          "prefill_s": prefill_s, "decode_ms_per_token": decode_ms})
    if scans != mcfg.num_layers:
        fail(f"mamba2-780m prefill: ssd_scan launches {scans} != layers")
    if not np.isfinite(got).all() or not np.allclose(got, want, **tol32):
        fail(f"mamba2-780m decode: logits differ from the forward's rows by {err}")
    if np.allclose(zero_rows, want[1:1 + zero_steps], **tol32):
        fail("mamba2-780m: a decode from a zeroed SSM state passes the check: it cannot "
             "see the state prefill carried")
    del params, cache, zeroed, forward
    _free(torch)

    _decode_olmoe(ctx, torch)
    _decode_jamba(ctx, torch)


def _clone_cache(cache):
    return {k: {leaf: t.clone() for leaf, t in d.items()} for k, d in cache.items()}


@contextlib.contextmanager
def _rope_off_by_one():
    """RoPE at position - 1: inside decode steps, the new token's q and k
    rotated one position off (written into the cache so), the fault a check
    of the decode's positions must see."""
    from repro_torch.models import transformer

    rope = transformer.apply_rope
    transformer.apply_rope = lambda x, positions, theta: rope(x, positions - 1, theta)
    try:
        yield
    finally:
        transformer.apply_rope = rope


@contextlib.contextmanager
def _flash_timed(torch, events, hold=False):
    """CUDA events before and after every flash launch of the model, into
    ``events`` as (start, end) pairs.  ``hold``: a spin kernel of about 2 ms
    runs first, so that the host has queued the launch before the card
    reaches the start event."""
    from repro_torch.models import transformer

    op = transformer.flash_attention_op

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(4_000_000)
        start.record()
        out = op(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    transformer.flash_attention_op = timed
    try:
        yield
    finally:
        transformer.flash_attention_op = op


@contextlib.contextmanager
def _int8_beside_decode(checks):
    """Beside every call of the model's ``decode_attention`` (whose result
    the model keeps), quantise that step's K and V cache and run the int8
    op on the same q and pos: held to the plain int8 version and to the
    model-dtype result."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_int8_op,
                                                      decode_attention_int8_ref,
                                                      quantize_kv)
    from repro_torch.models import transformer

    attend = transformer.decode_attention

    def beside(q, k_cache, v_cache, pos, *, scale, window=0, logit_softcap=0.0):
        out = attend(q, k_cache, v_cache, pos, scale=scale, window=window,
                     logit_softcap=logit_softcap)
        if window or logit_softcap:
            fail("the int8 kernel has no window or softcap")
        k8, ks = quantize_kv(k_cache)
        v8, vs = quantize_kv(v_cache)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=q.device)
        got = decode_attention_int8_op(q[:, 0], k8, ks, v8, vs, pos_t, scale=scale)
        plain = decode_attention_int8_ref(q[:, 0], k8, ks, v8, vs, pos, scale=scale)
        diff = (got.float() - plain.float()).abs()
        tol = int8_tol(str(q.dtype).replace("torch.", ""), plain)
        if not bool((diff <= tol["atol"] + tol["rtol"] * plain.float().abs()).all()):
            fail(f"int8 decode at pos {pos}: {float(diff.max())} from its plain version")
        ref = out[:, 0].float()
        checks.append({"pos": pos, "max_abs_err": float(diff.max()),
                       "rel": float((got.float() - ref).abs().max() / ref.abs().max())})
        return out

    transformer.decode_attention = beside
    try:
        yield
    finally:
        transformer.decode_attention = attend


@contextlib.contextmanager
def _ssd_without_carry():
    """The mixer's scan run chunk by chunk from a zero state (the carry
    dropped): what a kernel that loses the state would compute."""
    import torch
    from repro_torch.models import ssm

    op = ssm.ssd_op

    def chunkwise(x, dt, A, B, C, D, *, chunk):
        ys = [op(x[:, s:s + chunk], dt[:, s:s + chunk], A, B[:, s:s + chunk],
                 C[:, s:s + chunk], D, chunk=chunk)[0] for s in range(0, x.shape[1], chunk)]
        return torch.cat(ys, 1), None

    ssm.ssd_op = chunkwise
    try:
        yield
    finally:
        ssm.ssd_op = op


# ------------------------------------------------------------- the MoE paths

def _gb(nbytes) -> float:
    return nbytes / 2**30


def _peak_gb(torch) -> float:
    return _gb(torch.cuda.max_memory_allocated())


def _free(torch) -> None:
    """After ``del`` of a model's tensors: return them to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _expert_bytes(cfg) -> int:
    """The expert weights of every MoE layer: what each decode step reads,
    as JAX's formulation computes every expert for its Cg >= 1 rows."""
    from repro_torch.models.blocks import build_plan

    plan = build_plan(cfg)
    per_layer = (3 if cfg.mlp_gated else 2) * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
    n = sum(k.ffn == "moe" for k in plan.kinds) * plan.n_repeat
    item = 4 if cfg.dtype == "float32" else 2
    return n * per_layer * item


def _dropped(calls, layers):
    """Dropped (token, choice) pairs per layer of each forward in ``calls``."""
    per_call = [int((~c["keep"]).sum()) for c in calls]
    return [per_call[i:i + layers] for i in range(0, len(per_call), layers)]


def _assignment(torch, call, E):
    """(tokens, E) int8: 0 not chosen, 1 chosen and dropped, 2 kept."""
    K = call["idx"].shape[-1]
    idx = call["idx"].reshape(-1, K).cpu()
    keep = call["keep"].reshape(-1, K).cpu()
    out = torch.zeros((idx.shape[0], E), dtype=torch.int8)
    return out.scatter_(1, idx, 1 + keep.to(torch.int8))


def _row_check(torch, np, got_l, got_calls, want_l, want_calls, tol, min_margin=1e-5):
    """Routing first, then logits: per layer, the tokens whose chosen or
    kept experts differ from ``want``'s, each with its router margin p_K -
    p_{K+1} in ``want``.  A row is left out of the logits comparison only
    where its routing differs at a margin below ``min_margin``; a routing
    difference at a larger margin fails the check."""
    differ, excluded, wide = [], set(), []
    for layer, (g, w) in enumerate(zip(got_calls, want_calls)):
        E = w["probs"].shape[-1]
        K = w["idx"].shape[-1]
        rows = (_assignment(torch, g, E) != _assignment(torch, w, E)).any(1)
        top = w["probs"].reshape(-1, E).float().cpu().topk(K + 1, dim=-1).values
        margin = top[:, K - 1] - top[:, K]
        for r in rows.nonzero()[:, 0].tolist():
            differ.append({"layer": layer, "row": r, "margin": float(margin[r])})
            if margin[r] < min_margin:
                excluded.add(r)
            else:
                wide.append(r)
    keep = np.array([r not in excluded for r in range(want_l.shape[0])])
    diff = np.abs(got_l - want_l)[keep]
    ok_rows = bool(np.isfinite(got_l).all() and np.allclose(got_l[keep], want_l[keep], **tol))
    return {"routing_differs": differ[:16], "routing_differs_rows": len(differ),
            "excluded_rows": sorted(excluded), "max_abs_err": float(diff.max()),
            "ok": ok_rows and not wide and len(got_calls) == len(want_calls),
            "logits_ok": ok_rows}


def phase_olmoe(ctx, torch, rt):
    """olmoe-1b-7b at full width (2 layers), bf16, served: three delta
    uploads through ``Worker.invoke`` with 256-token requests, forced-cold
    ``regular`` and ``snapfaas`` plus a warm hit; the tokens dropped per
    layer; one ``moe_ffn`` under the sync debug mode; then float32 logits
    of every row on the card against the CPU, routing compared first, where
    k-major slot priority must fail."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_flat, params_to_flat
    from repro_torch.models import Batch, build_model, moe
    from repro_torch.serving import Worker
    from repro_torch.serving.trace import build_delta_specs, request_tokens

    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, num_layers=2)
    seq = 256
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    emit({"phase": "olmoe", "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
          "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "experts": E, "top_k": K, "moe_d_ff": cfg.moe_d_ff,
          "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings, "dtype": cfg.dtype,
          "capacity_factor": cfg.capacity_factor, "params": cfg.param_count(),
          "capacity_per_expert": max(1, int(cfg.capacity_factor * seq * K / E)),
          "request_tokens": seq})
    _free(torch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    # a pooled instance is charged all its bytes: 2 GB each, three functions
    worker = Worker(os.path.join(rt, "olmoe", "worker"), device="cuda",
                    pool_budget_bytes=16 << 30)
    base = model.init(0, device="cuda")
    worker.register_runtime(cfg.name, model, base)
    specs = build_delta_specs(os.path.join(rt, "olmoe"), cfg, params_to_flat(base))
    for spec in specs:
        worker.register_function(spec)
    emit({"phase": "olmoe", "setup_s": time.perf_counter() - t0,
          "delta_mb": {s.name: sum(v.nbytes for v in s.delta.values()) / 2**20
                       for s in specs}})
    toks = {s.name: request_tokens(s, np.random.default_rng(5), cfg.vocab_size, seq=seq)
            for s in specs}
    forwards = 0
    calls = []
    _reset()                                        # this slice's main path starts here
    with moe.recording(calls):
        for s in specs:
            outs = {}
            for strat, cold in (("regular", True), ("snapfaas", True), ("warm", False)):
                r = _invoke(worker, s.name, toks[s.name],
                            "snapfaas" if strat == "warm" else strat, cold)
                forwards += 1
                if r.cold != cold:
                    fail(f"olmoe-1b-7b {s.name} {strat}: cold is {r.cold}")
                outs[strat] = r.output
                emit({"phase": "olmoe", "function": s.name, "strategy": strat,
                      "resolved": str(r.strategy), "cold": r.cold, "boot_s": r.boot_s,
                      "exec_s": r.exec_s,
                      "dropped_per_layer": _dropped(calls, cfg.num_layers)[-1]})
            for k, o in outs.items():
                if o.shape != (1, 8) or not np.isfinite(o).all():
                    fail(f"olmoe-1b-7b {s.name} {k}: output {o.shape} not finite")
                if not np.allclose(o, outs["regular"], rtol=1e-3, atol=1e-3):
                    fail(f"olmoe-1b-7b {s.name}: {k} differs from regular by "
                         f"{float(np.abs(o - outs['regular']).max())}")
    counts = _read()                                # and ends here
    ctx.paths["olmoe-1b-7b served"] = counts
    drops = _dropped(calls, cfg.num_layers)
    adapter_drops = sum(sum(d) for d in drops[:3])
    emit({"phase": "olmoe", "launches": counts, "forwards": forwards,
          "dropped_per_layer_per_forward": drops, "adapter_dropped": adapter_drops,
          "peak_gb": _peak_gb(torch)})
    if counts["flash_attention"] != cfg.num_layers * forwards:
        fail(f"olmoe-1b-7b: flash launches {counts['flash_attention']} != layers x "
             f"forwards {cfg.num_layers * forwards}")
    if counts["snapshot_patch"] <= 0:
        fail("olmoe-1b-7b: the patch kernel never ran on the bf16 leaves")
    if adapter_drops <= 0:
        fail("olmoe-1b-7b: adapter requests (16 token ids) dropped no tokens")

    # one bf16 moe_ffn at the path's shape: nothing in it may wait on the card
    ffn = {k: v[0] for k, v in base["blocks"]["pos0"]["ffn"].items()}
    x = torch.randn((1, seq, cfg.d_model), device="cuda").bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(ffn, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit({"phase": "olmoe", "check": "moe_ffn under set_sync_debug_mode('error')",
          "shape": list(x.shape), "finite": bool(torch.isfinite(y.float()).all())})
    if not bool(torch.isfinite(y.float()).all()) or not bool(torch.isfinite(aux)):
        fail("olmoe-1b-7b: the sync-free moe_ffn gave non-finite values")
    del worker, base, ffn, x, y
    _free(torch)

    # float32: every logits row of a 256-token forward against the CPU, the
    # routing (chosen and kept experts per token and layer) compared first;
    # k-major slot priority moves which tokens drop and must fail
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    p32 = m32.init(0, device="cuda")
    p32_cpu = params_from_flat(params_to_flat(p32), "cpu", template=m32.param_shapes())
    tok = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (1, seq), dtype=np.int32))
    gpu_calls, cpu_calls, bad_calls = [], [], []
    with torch.no_grad():
        with moe.recording(gpu_calls):
            gpu_l = m32.logits(p32, Batch(tokens=tok.cuda()))[0].cpu().numpy()
        with moe.recording(cpu_calls):
            cpu_l = m32.logits(p32_cpu, Batch(tokens=tok))[0].numpy()
        with moe.recording(bad_calls), moe.k_major_priority():
            bad_l = m32.logits(p32, Batch(tokens=tok.cuda()))[0].cpu().numpy()
    tol32 = dict(rtol=1e-4, atol=1e-4)
    check = _row_check(torch, np, gpu_l, gpu_calls, cpu_l, cpu_calls, tol32)
    control = _row_check(torch, np, bad_l, bad_calls, cpu_l, cpu_calls, tol32)
    emit({"phase": "olmoe", "check": "float32 logits, all rows, GPU vs CPU",
          "tolerance": tol32, "excluded_if_margin_below": 1e-5,
          "dropped_per_layer": _dropped(cpu_calls, cfg.num_layers)[0],
          "result": check, "k_major_control": control, "peak_gb": _peak_gb(torch),
          "seconds": time.perf_counter() - t0})
    if not check["ok"]:
        fail(f"olmoe-1b-7b float32: GPU vs CPU fails: {check}")
    if control["logits_ok"] or control["ok"]:
        fail("olmoe-1b-7b float32: k-major slot priority passes the check: it cannot "
             "see which tokens drop")
    del p32, p32_cpu
    _free(torch)


def _decode_olmoe(ctx, torch):
    """olmoe-1b-7b (2 layers): bf16 prefill 512 into a 1024 cache and 32
    decode steps, timed; then float32, drop-free, every step at 1e-4."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Batch, build_model

    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, num_layers=2)
    prompt, steps, cache_len = 512, 32, 1024
    _free(torch)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (1, prompt + steps), dtype=np.int32)).cuda()
    prefill, serve = make_prefill_step(model, cache_len), make_serve_step(model)
    with torch.no_grad():
        _reset()
        first, cache, prefill_first_s = _prefill_timed(torch, prefill, params,
                                                       tok[:, :prompt])
        rows, decode_ms = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
        counts = _read()
        _, cache, prefill_s = _prefill_timed(torch, prefill, params, tok[:, :prompt])
        _, decode_ms_again = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
    ctx.paths["olmoe-1b-7b prefill + decode"] = counts
    nbytes = _expert_bytes(cfg)
    emit({"phase": "decode", "model": "olmoe-1b-7b",
          "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}", "dtype": cfg.dtype,
          "prompt": prompt, "decode_steps": steps, "cache_len": cache_len,
          "capacity_factor": {"prefill": cfg.capacity_factor,
                              "decode": cfg.num_experts / cfg.num_experts_per_tok},
          "launches": counts, "prefill_s": prefill_s, "prefill_first_s": prefill_first_s,
          "decode_ms_per_token": decode_ms_again, "decode_ms_per_token_first": decode_ms,
          "expert_gb_read_per_decode_step": _gb(nbytes),
          "expert_bytes_bound_ms_per_step": nbytes / HBM_BYTES_PER_S * 1e3,
          "peak_gb": _peak_gb(torch)})
    if not (np.isfinite(first).all() and np.isfinite(rows).all()):
        fail("olmoe-1b-7b bf16 decode: non-finite logits")
    if counts["flash_attention"] != cfg.num_layers:
        fail(f"olmoe-1b-7b prefill: flash launches {counts['flash_attention']} != layers")
    del params, cache
    _free(torch)

    # float32 at the drop-free capacity E / K in the forward and the prefill
    # too: with the published 1.25 the forward drops tokens the decode keeps,
    # and the two differ by design
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    m32 = build_model(cfg32)
    p32 = m32.init(0, device="cuda")
    prefill, serve = make_prefill_step(m32, cache_len), make_serve_step(m32)
    with torch.no_grad():
        forward = m32.logits(p32, Batch(tokens=tok))[0].cpu().numpy()
        first, cache, _ = _prefill_timed(torch, prefill, p32, tok[:, :prompt])
        shifted = _clone_cache(cache)
        rows, _ = _decode_timed(torch, serve, p32, cache, tok, prompt, steps)
        with _rope_off_by_one():
            bad_rows, _ = _decode_timed(torch, serve, p32, shifted, tok, prompt, 8)
    tol32 = dict(rtol=1e-4, atol=1e-4)
    want = forward[prompt - 1:prompt + steps]
    got = np.concatenate([first, rows], 0)
    err = float(np.abs(got - want).max())
    bad_err = float(np.abs(bad_rows - want[1:9]).max())
    emit({"phase": "decode", "model": "olmoe-1b-7b", "dtype": "float32",
          "capacity_factor": cfg32.capacity_factor,
          "note": "forward and prefill at the drop-free E/K that decode uses",
          "logits_vs_forward_max_abs_err": err, "tolerance": tol32,
          "rope_off_by_one_steps": 8, "rope_off_by_one_max_abs_err": bad_err,
          "peak_gb": _peak_gb(torch)})
    if not np.isfinite(got).all() or not np.allclose(got, want, **tol32):
        fail(f"olmoe-1b-7b float32 decode: logits differ from the forward's rows by {err}")
    if np.allclose(bad_rows, want[1:9], **tol32):
        fail("olmoe-1b-7b float32: a decode rotated one position off passes the check")
    del p32, cache, shifted
    _free(torch)


def _decode_jamba(ctx, torch):
    """jamba-v0.1-52b at full width, one period of 8 layers: bf16 prefill
    1024 into a 2048 cache (1 flash and 7 ssd_scan launches) and 32 decode
    steps, timed; then float32, drop-free, every step at 1e-4 against a
    forward, where a decode from a zeroed SSM state must fail."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Batch, build_model
    from repro_torch.models.blocks import build_plan

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, num_layers=8)
    plan = build_plan(cfg)
    prompt, steps, cache_len = 1024, 32, 2048
    n_attn = sum(k.mixer == "attn" for k in plan.kinds) * plan.n_repeat
    n_mamba = cfg.num_layers - n_attn
    emit({"phase": "decode", "model": "jamba-v0.1-52b",
          "cut": f"num_layers {full.num_layers} -> {cfg.num_layers} (one period)",
          "kinds": [f"{k.mixer}+{k.ffn}" for k in plan.kinds], "d_model": cfg.d_model,
          "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
          "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "experts": cfg.num_experts,
          "top_k": cfg.num_experts_per_tok, "moe_d_ff": cfg.moe_d_ff,
          "vocab": cfg.vocab_size, "params": cfg.param_count(), "dtype": cfg.dtype})
    _free(torch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, prompt + 256), dtype=np.int32)).cuda()
    prefill, serve = make_prefill_step(model, cache_len), make_serve_step(model)
    with torch.no_grad():
        _reset()
        first, cache, prefill_first_s = _prefill_timed(torch, prefill, params,
                                                       tok[:, :prompt])
        counts = _read()
        rows, decode_ms_first = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
        _, cache, prefill_s = _prefill_timed(torch, prefill, params, tok[:, :prompt])
        _, decode_ms = _decode_timed(torch, serve, params, cache, tok, prompt, steps)
    ctx.paths["jamba-v0.1-52b prefill"] = counts
    nbytes = _expert_bytes(cfg)
    emit({"phase": "decode", "model": "jamba-v0.1-52b", "dtype": cfg.dtype,
          "prompt": prompt, "decode_steps": steps, "cache_len": cache_len,
          "init_s": init_s, "launches_in_prefill": counts,
          "prefill_s": prefill_s, "prefill_first_s": prefill_first_s,
          "decode_ms_per_token": decode_ms, "decode_ms_per_token_first": decode_ms_first,
          "expert_gb_read_per_decode_step": _gb(nbytes),
          "expert_bytes_bound_ms_per_step": nbytes / HBM_BYTES_PER_S * 1e3,
          "peak_gb": _peak_gb(torch)})
    if not (np.isfinite(first).all() and np.isfinite(rows).all()):
        fail("jamba-v0.1-52b bf16: non-finite logits")
    if counts["flash_attention"] != n_attn or counts["ssd_scan"] != n_mamba:
        fail(f"jamba-v0.1-52b prefill launches {counts}: want {n_attn} flash and "
             f"{n_mamba} ssd_scan")
    del params, cache
    _free(torch)

    # float32 (about 53 GB): drop-free, as for olmoe; the forward runs 1280
    # tokens (whole SSD chunks of 256) and its rows are causal, so rows
    # prompt - 1 .. prompt + steps - 1 are the decode's
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    m32 = build_model(cfg32)
    p32 = m32.init(0, device="cuda")
    prefill, serve = make_prefill_step(m32, cache_len), make_serve_step(m32)
    zero_steps = 16
    with torch.no_grad():
        forward = m32.logits(p32, Batch(tokens=tok))[0].cpu().numpy()
        first, cache, _ = _prefill_timed(torch, prefill, p32, tok[:, :prompt])
        zeroed = _clone_cache(cache)
        for d in zeroed.values():
            if "ssm" in d:
                d["ssm"].zero_()
        rows, decode_ms = _decode_timed(torch, serve, p32, cache, tok, prompt, steps)
        zero_rows, _ = _decode_timed(torch, serve, p32, zeroed, tok, prompt, zero_steps)
    tol32 = dict(rtol=1e-4, atol=1e-4)
    want = forward[prompt - 1:prompt + steps]
    got = np.concatenate([first, rows], 0)
    err = float(np.abs(got - want).max())
    zero_err = float(np.abs(zero_rows - want[1:1 + zero_steps]).max())
    emit({"phase": "decode", "model": "jamba-v0.1-52b", "dtype": "float32",
          "capacity_factor": cfg32.capacity_factor,
          "note": "forward (1280 tokens) and prefill at the drop-free E/K that decode uses",
          "logits_vs_forward_max_abs_err": err, "tolerance": tol32,
          "zeroed_state_steps": zero_steps, "zeroed_state_max_abs_err": zero_err,
          "decode_ms_per_token": decode_ms, "peak_gb": _peak_gb(torch)})
    if not np.isfinite(got).all() or not np.allclose(got, want, **tol32):
        fail(f"jamba-v0.1-52b float32 decode: logits differ from the forward's rows by {err}")
    if np.allclose(zero_rows, want[1:1 + zero_steps], **tol32):
        fail("jamba-v0.1-52b: a decode from a zeroed SSM state passes the check: it "
             "cannot see the state prefill carried")
    del p32, cache, zeroed
    _free(torch)


def _cpu_tree(tree):
    return {k: _cpu_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()


@contextlib.contextmanager
def _erf_gelu():
    """The experts' gelu exact (erf), not the tanh form JAX uses: a fault
    the grok check must see."""
    import torch.nn.functional as F
    from repro_torch.models import moe

    inner = moe.activation
    moe.activation = lambda x, kind: F.gelu(x) if kind == "gelu" else inner(x, kind)
    try:
        yield
    finally:
        moe.activation = inner


def phase_grok(ctx, torch, rt):
    """grok-1-314b at full width, one layer: a 256-token bf16 forward, then
    the float32 forward's logits, every row, on the card against the CPU
    (routing first), where the exact-gelu control must fail."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Batch, build_model, moe

    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, num_layers=1)
    seq = 256
    _free(torch)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (1, seq), dtype=np.int32)).cuda()
    times = []
    with torch.no_grad():
        _reset()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model.logits(params, Batch(tokens=tok))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = _read()
    ctx.paths["grok-1-314b forward"] = counts
    finite = bool(torch.isfinite(logits).all())
    emit({"phase": "grok", "cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
          "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
          "moe_d_ff": cfg.moe_d_ff, "act": cfg.hidden_act, "vocab": cfg.vocab_size,
          "params": cfg.param_count(), "dtype": cfg.dtype, "tokens": seq,
          "logits_shape": list(logits.shape), "finite": finite, "launches": counts,
          "forward_s": times[1], "forward_first_s": times[0], "peak_gb": _peak_gb(torch)})
    if not finite or tuple(logits.shape) != (1, seq, cfg.vocab_size):
        fail(f"grok-1-314b: logits {tuple(logits.shape)} finite={finite}")
    if counts["flash_attention"] != 2 * cfg.num_layers:
        fail(f"grok-1-314b: flash launches {counts['flash_attention']} != layers x forwards")
    del params, logits
    _free(torch)

    # float32 (26 GB): 48:8 attention and the tanh-gelu experts held to the CPU
    t0 = time.perf_counter()
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = m32.init(0, device="cuda")
    p32_cpu = _cpu_tree(p32)
    gpu_calls, cpu_calls, bad_calls = [], [], []
    with torch.no_grad():
        with moe.recording(gpu_calls):
            gpu_l = m32.logits(p32, Batch(tokens=tok))[0].cpu().numpy()
        with moe.recording(cpu_calls):
            cpu_l = m32.logits(p32_cpu, Batch(tokens=tok.cpu()))[0].numpy()
        with moe.recording(bad_calls), _erf_gelu():
            bad_l = m32.logits(p32, Batch(tokens=tok))[0].cpu().numpy()
    tol32 = dict(rtol=1e-4, atol=1e-4)
    check = _row_check(torch, np, gpu_l, gpu_calls, cpu_l, cpu_calls, tol32)
    control = _row_check(torch, np, bad_l, bad_calls, cpu_l, cpu_calls, tol32)
    emit({"phase": "grok", "check": "float32 logits, all rows, GPU vs CPU",
          "tolerance": tol32, "excluded_if_margin_below": 1e-5,
          "dropped_per_layer": _dropped(cpu_calls, cfg.num_layers)[0],
          "result": check, "erf_gelu_control": control, "peak_gb": _peak_gb(torch),
          "seconds": time.perf_counter() - t0})
    if not check["ok"]:
        fail(f"grok-1-314b float32: GPU vs CPU fails: {check}")
    if control["logits_ok"] or control["ok"]:
        fail("grok-1-314b float32: exact gelu in the experts passes the check: it cannot "
             "see the activation")
    del p32, p32_cpu
    _free(torch)


# ------------------------------------------- encoder-decoder and VLM prefix

@contextlib.contextmanager
def _causal_encoder():
    """whisper's encoder run causal: the fault a check of its bidirectional
    attention must see."""
    from repro_torch.models import api

    stack = api.apply_stack
    api.apply_stack = lambda *a, causal=True, **kw: stack(*a, causal=True, **kw)
    try:
        yield
    finally:
        api.apply_stack = stack


@contextlib.contextmanager
def _no_prefix():
    """Every attention with ``prefix_len`` 0: plain causal attention over
    the patches, the fault a check of the prefix-LM mask must see."""
    from repro_torch.models import transformer

    op = transformer.flash_attention_op
    transformer.flash_attention_op = lambda *a, prefix_len=0, **kw: op(*a, **kw)
    try:
        yield
    finally:
        transformer.flash_attention_op = op


def _close_rows(np, got, want, tol):
    err = float(np.abs(got - want).max())
    return {"ok": bool(np.isfinite(got).all() and np.allclose(got, want, **tol)),
            "max_abs_err": err}


def _encdec_run(ctx, torch, name, prompt, cache_len, prefix_len, per_forward, seed, *,
                layers_note, control, cache_control=None):
    """One model of the encdec phase at full size: a bf16 prefill of
    ``prompt`` tokens after ``prefix_len`` stub embeddings (frames or
    patches, normal x 0.02 from a seeded generator) into ``cache_len``,
    and 32 decode steps, timed, with flash launches counted; then float32:
    the forward's text rows on the card against the CPU at 1e-4, where
    ``control`` must fail, and prefill + 32 decode steps against the
    card's forward at 1e-4, where a decode from the cache as
    ``cache_control`` leaves it (if given) must fail."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Batch, build_model

    cfg = get_config(name)
    steps = 32
    encdec = cfg.is_encoder_decoder
    offset = 0 if encdec else prefix_len     # decode position of text token 0
    _free(torch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pre32 = torch.randn((1, prefix_len, cfg.d_model), generator=gen, device="cuda") * 0.02
    pre = pre32.to(params["embed"]["table"].dtype)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt + steps), dtype=np.int32)).cuda()
    prefill, serve = make_prefill_step(model, cache_len), make_serve_step(model)

    def decode(p, cache, n):
        return _decode_timed(torch, serve, p, cache, tok, prompt, n, offset)

    with torch.no_grad():
        _reset()
        first, cache, prefill_first_s = _prefill_timed(torch, prefill, params,
                                                       tok[:, :prompt], pre)
        counts = _read()
        rows, decode_ms_first = decode(params, cache, steps)
        _, cache, prefill_s = _prefill_timed(torch, prefill, params, tok[:, :prompt], pre)
        _, decode_ms = decode(params, cache, steps)
    ctx.paths[f"{name} prefill"] = counts
    emit({"phase": "encdec", "model": name, "layers": layers_note, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": cfg.param_count(),
          "dtype": cfg.dtype, "prefix": prefix_len, "prompt": prompt,
          "cache_len": cache_len, "decode_steps": steps, "init_s": init_s,
          "launches_in_prefill": counts, "prefill_s": prefill_s,
          "prefill_first_s": prefill_first_s, "decode_ms_per_token": decode_ms,
          "decode_ms_per_token_first": decode_ms_first, "peak_gb": _peak_gb(torch)})
    if not (np.isfinite(first).all() and np.isfinite(rows).all()):
        fail(f"{name} bf16: non-finite logits")
    if counts["flash_attention"] != per_forward or sum(counts.values()) != per_forward:
        fail(f"{name} prefill launches {counts}: want {per_forward} flash and no other kernel")
    del params, cache
    _free(torch)

    # float32: the card's forward against the CPU's, then decode against it
    t0 = time.perf_counter()
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = m32.init(0, device="cuda")
    prefill, serve = make_prefill_step(m32, cache_len), make_serve_step(m32)
    tol32 = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        _reset()
        forward = m32.logits(p32, Batch(tokens=tok, prefix_embeds=pre32))[0].cpu().numpy()
        forward_launches = _read()["flash_attention"]
        with control[1]():
            bad = m32.logits(p32, Batch(tokens=tok, prefix_embeds=pre32))[0].cpu().numpy()
        first, cache, _ = _prefill_timed(torch, prefill, p32, tok[:, :prompt], pre32)
        broken = None
        if cache_control is not None:
            broken = _clone_cache(cache)
            cache_control[1](broken)
        rows, decode_ms = decode(p32, cache, steps)
        if broken is not None:
            bad_rows, _ = decode(p32, broken, 8)
        p32_cpu = _cpu_tree(p32)
        del p32, cache, broken
        _free(torch)
        t1 = time.perf_counter()
        cpu = m32.logits(p32_cpu, Batch(tokens=tok.cpu(), prefix_embeds=pre32.cpu()))[0].numpy()
        cpu_s = time.perf_counter() - t1
        del p32_cpu
    check = _close_rows(np, forward, cpu, tol32)
    ctrl = _close_rows(np, bad, cpu, tol32)
    want = forward[prompt - 1:prompt + steps]
    dec = _close_rows(np, np.concatenate([first, rows], 0), want, tol32)
    out = {"phase": "encdec", "model": name, "dtype": "float32",
           "rows": int(forward.shape[0]), "flash_launches_in_forward": forward_launches,
           "card_vs_cpu": check, f"{control[0]}_control": ctrl,
           "decode_vs_forward": dec, "tolerance": tol32, "decode_ms_per_token": decode_ms,
           "cpu_forward_s": cpu_s, "seconds": time.perf_counter() - t0}
    if cache_control is not None:
        out[f"{cache_control[0]}_control"] = _close_rows(np, bad_rows, want[1:9], tol32)
    emit(out)
    if forward.shape != (prompt + steps, cfg.vocab_size) or forward_launches != per_forward:
        fail(f"{name} float32: logits {forward.shape}, {forward_launches} flash launches")
    if not check["ok"]:
        fail(f"{name} float32: card vs CPU fails: {check}")
    if ctrl["ok"]:
        fail(f"{name} float32: the {control[0]} control passes the check: it cannot see it")
    if not dec["ok"]:
        fail(f"{name} float32 decode: logits differ from the forward's rows: {dec}")
    if cache_control is not None and out[f"{cache_control[0]}_control"]["ok"]:
        fail(f"{name} float32: a decode from a cache with {cache_control[0]} passes the "
             "check: it cannot see the cache")
    _free(torch)


def _zero_cross(cache):
    for d in cache.values():
        d["ck"].zero_()
        d["cv"].zero_()


def phase_encdec(ctx, torch, rt):
    """whisper-small (12 + 12 layers) over 1500 frames with a 64-token
    prompt into its 448-token text context, and paligemma-3b (18 layers)
    with 256 patches and 256 text tokens into a 1024 cache, both whole:
    every attention through flash (whisper 12 encoder + 12 self + 12 cross
    a forward, paligemma 18 with the prefix mask)."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-small")
    _encdec_run(ctx, torch, "whisper-small", prompt=64, cache_len=448, prefix_len=1500,
                per_forward=cfg.num_layers + 2 * cfg.num_decoder_layers, seed=31,
                layers_note=f"{cfg.num_layers} encoder + {cfg.num_decoder_layers} decoder",
                control=("causal_encoder", _causal_encoder),
                cache_control=("zeroed_ck_cv", _zero_cross))
    cfg = get_config("paligemma-3b")
    _encdec_run(ctx, torch, "paligemma-3b", prompt=256, cache_len=1024,
                prefix_len=cfg.num_prefix_tokens, per_forward=cfg.num_layers, seed=37,
                layers_note=f"{cfg.num_layers}", control=("prefix_0", _no_prefix))


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
    ctx.paths["launch.serve"] = counts
    text = buf.getvalue()
    start = text.index("\n[") + 1
    rows, _ = json.JSONDecoder().raw_decode(text[start:])
    emit({"phase": "serve", "seconds": time.perf_counter() - t0, "launches": counts,
          "rows": rows})
    if counts["flash_attention"] <= 0:
        fail("launch.serve: no flash launches")
    if sorted(r["strategy"] for r in rows) != ["auto", "snapfaas"]:
        fail(f"launch.serve: unexpected rows {rows}")


# ------------------------------------------------------- phases: faults, distrib

def phase_faults(ctx, torch, rt):
    """The worker's fault and record paths on the card: a two-worker
    faas-bench cluster whose first invocation crashes its worker, against
    a clean worker bit for bit; REAP record mode on that clean worker then
    a forced demand-paged replay; the chaos replay CLI under
    ``remote-outage``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import FaultInjector, FaultMatrix, TierSpec
    from repro_torch.launch import replay
    from repro_torch.models import build_model
    from repro_torch.serving import ColdStartOptions, InvocationRequest
    from repro_torch.serving.trace import build_cluster, build_functions, request_tokens

    cfg = get_config("faas-bench")
    model = build_model(cfg)
    fast = dict(remote_bw=10e9, remote_lat=0.0)
    _reset()                                        # the phase's path starts here
    t0 = time.perf_counter()
    inj = FaultInjector(FaultMatrix(crash_after=1))
    worker, specs = build_functions(os.path.join(rt, "faults", "clean"), cfg, model,
                                    n_functions=2, device="cuda")
    chaos, _ = build_cluster(os.path.join(rt, "faults", "chaos"), cfg, model,
                             n_workers=2, n_functions=2, device="cuda",
                             tiers=TierSpec(ram_bytes=64 << 20, faults=inj, **fast))
    toks = {s.name: request_tokens(s, np.random.default_rng(3), cfg.vocab_size, seq=256)
            for s in specs}

    def req(s):
        return InvocationRequest(function=s.name, tokens=toks[s.name],
                                 options=ColdStartOptions(force_cold=True))

    with chaos:
        want = {s.name: worker.invoke(req(s)).output for s in specs}
        patch_before = _counters()["snapshot_patch"].value
        got = {s.name: chaos.invoke(req(s)) for s in specs}
        patch_failover = _counters()["snapshot_patch"].value - patch_before
        m = chaos.metrics()
        dead = m["serving"]["dead_workers"]
        survivor = next(w for w in chaos.workers if w.worker_id not in dead)
        fam = survivor._pool_dev.get(cfg.name, {})
        row = {"phase": "faults", "check": "failover", "seconds": time.perf_counter() - t0,
               "n_worker_crashes":
               m["serving"]["n_worker_crashes"], "dead_workers": dead,
               "failures": m["serving"]["failures"],
               "served_by": {n: r.worker_id for n, r in got.items()},
               "survivor_device_leaves": len(fam),
               "survivor_device": str(next(iter(fam.values())).device) if fam else None,
               "patch_launches_in_failover": patch_failover,
               "bit_equal": {n: bool(np.array_equal(r.output, want[n])) for n, r in got.items()}}
        emit(row)
    if m["serving"]["n_worker_crashes"] != 1 or len(dead) != 1:
        fail(f"failover: {m['serving']['n_worker_crashes']} crashes, dead {dead}")
    if m["serving"]["failures"]["fault_recovered"] < 1 or m["serving"]["failures"]["fault_fatal"]:
        fail(f"failover: failures {m['serving']['failures']}")
    if not all(row["bit_equal"].values()):
        fail("failover: the chaos fleet's outputs differ from the clean worker's")
    if any(w in dead for w in row["served_by"].values()):
        fail(f"failover: a dead worker served {row['served_by']}")
    if not fam or row["survivor_device"] != "cuda:0" or patch_failover <= 0:
        fail("failover: the survivor did not serve from its device copies")

    t0 = time.perf_counter()
    fn = specs[0].name
    rtoks = request_tokens(specs[0], np.random.default_rng(4), cfg.vocab_size, seq=256)

    def cold(**opts):
        return worker.invoke(InvocationRequest(
            function=fn, tokens=rtoks,
            options=ColdStartOptions(force_cold=True, **opts)))

    baseline = cold()
    recorded = worker.record_function(fn, rtoks, n_profiles=2)
    first, second = cold(demand_paging=True), cold(demand_paging=True)
    eager = cold(demand_paging=False)
    rec = worker.registry.functions[fn].recording
    emit({"phase": "faults", "check": "record_replay", "seconds": time.perf_counter() - t0,
          "recording_profiles": rec.n_profiles if rec else 0,
          "demand_paged": [first.metrics.demand_paged, second.metrics.demand_paged],
          "demand_faults": [first.metrics.demand_faults, second.metrics.demand_faults],
          "boot_s": {"baseline": baseline.boot_s, "demand": second.boot_s,
                     "eager": eager.boot_s}})
    if rec is None or rec.n_profiles < 2:
        fail("record mode kept no recording")
    if not (first.metrics.demand_paged and second.metrics.demand_paged) or eager.metrics.demand_paged:
        fail("record/replay: demand paging was not taken as asked")
    if second.metrics.demand_faults != 0:
        fail(f"record/replay: {second.metrics.demand_faults} demand faults on the replay")
    for name, r in (("record", recorded), ("first", first), ("second", second), ("eager", eager)):
        if not np.array_equal(r.output, baseline.output):
            fail(f"record/replay: the {name} output differs from the baseline")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        replay.main(["--chaos", "remote-outage", "--rps", "40", "--duration", "2.0",
                     "--functions", "2", "--device", "cuda",
                     "--root", os.path.join(rt, "faults", "replay")])
    d = json.loads(buf.getvalue())
    f = d["serving"]["failures"]
    counts = _read()                                # the phase's path ends here
    ctx.paths["faults"] = counts
    emit({"phase": "faults", "check": "replay_cli", "seconds": time.perf_counter() - t0,
          "device": d["device"], "conservation_holds": d["conservation_holds"],
          "failures": f, "summary": {k: d["summary"][k] for k in ("n_submitted", "n_completed")},
          "fail_fast_reads": d["tier_health"].get("fail_fast_reads"),
          "chaos": d["chaos"]})
    emit({"phase": "faults", "launches": counts})
    if not d["conservation_holds"] or set(f) != {"shed", "timeout", "fault_recovered",
                                                  "fault_fatal"}:
        fail(f"replay CLI: conservation {d['conservation_holds']}, failures {f}")
    if f["fault_fatal"] <= 0 or d["summary"]["n_completed"] <= 0:
        fail(f"replay CLI: outage not seen or nothing completed: {f}, {d['summary']}")
    if d["tier_health"].get("fail_fast_reads", 0) <= 0:
        fail(f"replay CLI: no fail-fast reads in {d['tier_health']}")
    if counts["snapshot_patch"] <= 0 or counts["flash_attention"] <= 0:
        fail(f"faults: patch / flash not on the path: {counts}")


def _profile_call(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device time of its
    kernels (one stream, so their sum is the busy time), their number, the
    kernels that hold most of it, and each kernel's launches and
    microseconds (``by_name``); ``{}`` where the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"device_busy_ms": sum(us for _, us in by_name.values()) / 1e3,
            "kernels": sum(n for n, _ in by_name.values()),
            "top_kernels": [{"name": k[:70], "launches": n, "ms": us / 1e3}
                            for k, (n, us) in top],
            "by_name": by_name}


def phase_distrib(ctx, torch, rt):
    """The distribution layer on the card, one rank through NCCL on a (1, 1)
    ("data", "model") mesh: ``moe_ffn_sharded`` at olmoe-1b-7b's full width
    against ``moe_ffn``, a 2-layer olmoe forward under the binding against
    the same forward unbound, ``ef_compressed_mean`` of a CUDA tensor, and
    stablelm-3b's parameter specs distributed as DTensors."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.distrib import Rules, default_rules, fingerprint, logical_axis_rules
    from repro_torch.distrib.compress import ef_compressed_mean
    from repro_torch.models import Batch, build_model, moe, transformer
    from repro_torch.models.config import LayerKind
    from repro_torch.models.transformer import init_layer, torch_dtype

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        full = get_config("olmoe-1b-7b")
        cfg = dataclasses.replace(full, num_layers=2)
        b, s = 2, 256
        rules = default_rules(mesh, cfg, batch=b)
        emit({"phase": "distrib", "mesh": fingerprint(mesh), "backend": dist.get_backend(),
              "rules": {k: v for k, v in rules.items() if v}})
        gen = torch.Generator(device="cuda").manual_seed(11)

        def make(shape, dtype, fill, scale=0.02):
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device="cuda")
            return (x * scale).to(dtype)

        ffn = init_layer(cfg, LayerKind("attn", "moe"), make)["ffn"]
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
            torch_dtype(cfg.dtype))
        _reset()                                    # the phase's path starts here
        with logical_axis_rules(mesh, rules):
            y_sh, aux_sh = moe.moe_ffn_sharded(ffn, x, cfg)
        y, aux = moe.moe_ffn(ffn, x, cfg)
        ys, yr = y_sh.float(), y.float()
        err = float((ys - yr).abs().max())
        scale = float(yr.abs().max())
        bit_equal = float((y_sh == y).float().mean())
        with logical_axis_rules(mesh, rules):
            sh_ms = eager_ms(torch, lambda: moe.moe_ffn_sharded(ffn, x, cfg))
            sh_prof = _profile_call(torch, lambda: moe.moe_ffn_sharded(ffn, x, cfg))
        plain_ms = eager_ms(torch, lambda: moe.moe_ffn(ffn, x, cfg))
        plain_prof = _profile_call(torch, lambda: moe.moe_ffn(ffn, x, cfg))
        emit({"phase": "distrib", "check": "moe_ffn_sharded", "shape": [b, s, cfg.d_model],
              "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok, "dtype": cfg.dtype,
              "max_abs_err": err, "max_abs_y": scale, "bit_equal_fraction": bit_equal,
              "aux": [float(aux_sh), float(aux)], "tolerance": "bit-equal on one rank",
              "moe_ffn_sharded_ms": sh_ms, "moe_ffn_ms": plain_ms,
              "timing": "median of 30 eager calls between CUDA events", "card": ctx.card,
              "profiled_call": {"moe_ffn_sharded": sh_prof, "moe_ffn": plain_prof}})
        # one rank: no token is gathered, no sum has a second term, and the
        # routing, capacity and expert products are moe_ffn's own
        if not torch.isfinite(ys).all() or not torch.equal(y_sh, y):
            fail(f"moe_ffn_sharded differs from moe_ffn by {err} (max |y| {scale})")
        if float(aux_sh) != float(aux):
            fail(f"moe_ffn_sharded aux {float(aux_sh)} != {float(aux)}")
        del ffn, x, y, y_sh

        model = build_model(cfg)
        params = model.init(0, device="cuda")
        tokens = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, size=(b, s)).astype(np.int64)).cuda()
        calls = []
        inner = transformer.moe_ffn_sharded
        transformer.moe_ffn_sharded = lambda *a, **k: calls.append(1) or inner(*a, **k)
        try:
            with torch.no_grad():
                with logical_axis_rules(mesh, rules):
                    bound = model.logits(params, Batch(tokens=tokens))
                unbound = model.logits(params, Batch(tokens=tokens))
        finally:
            transformer.moe_ffn_sharded = inner
        ferr = float((bound - unbound).abs().max())
        fscale = float(unbound.abs().max())
        emit({"phase": "distrib", "check": "olmoe forward under the binding",
              "layers": cfg.num_layers, "tokens": [b, s], "moe_ffn_sharded_calls": len(calls),
              "max_abs_err": ferr, "max_abs_logit": fscale, "tolerance": "bit-equal on one rank"})
        if len(calls) != cfg.num_layers:
            fail(f"the bound forward called moe_ffn_sharded {len(calls)} times")
        if not torch.isfinite(bound).all() or not torch.equal(bound, unbound):
            fail(f"the bound olmoe forward differs from the unbound one by {ferr}")
        del params, bound, unbound
        _free(torch)

        part = torch.randn((2560, 2560), generator=gen, device="cuda")
        mean, e = ef_compressed_mean(part, torch.zeros_like(part), mesh, "data")
        one_shot = float((mean - part).abs().max())
        carried = float(e.abs().sum())
        acc, e = torch.zeros_like(part), torch.zeros_like(part)
        for _ in range(20):
            m, e = ef_compressed_mean(part, e, mesh, "data")
            acc += m
        avg_err = float((acc / 20 - part).abs().max())
        ef_ms = eager_ms(torch, lambda: ef_compressed_mean(part, e, mesh, "data"))
        emit({"phase": "distrib", "check": "ef_compressed_mean", "shape": list(part.shape),
              "one_shot_max_err": one_shot, "avg20_max_err": avg_err, "carried_error": carried,
              "ms": ef_ms, "tolerance": "one shot 0.05, 20-step average 0.01"})
        if one_shot >= 0.05 or avg_err >= 0.01 or carried <= 0:
            fail(f"ef_compressed_mean: one shot {one_shot}, 20 steps {avg_err}, "
                 f"carried {carried}")
        del part, mean, e, acc

        scfg = dataclasses.replace(get_config("stablelm-3b"), num_layers=2)
        smodel = build_model(scfg)
        sparams = smodel.init(0, device="cuda")
        r = Rules(mesh)
        dparams = r.distribute(sparams, r.param_specs(scfg))
        leaves = []

        def walk(a, d):
            if isinstance(a, dict):
                for k in a:
                    walk(a[k], d[k])
            else:
                leaves.append((a, d))

        walk(sparams, dparams)
        ok = all(isinstance(d, DTensor) and torch.equal(d.to_local(), a) for a, d in leaves)
        emit({"phase": "distrib", "check": "stablelm-3b params as DTensors",
              "leaves": len(leaves), "all_dtensor_and_equal": ok,
              "placements": str(dparams["blocks"]["pos0"]["wq"].placements)})
        if not ok:
            fail("stablelm-3b: a distributed leaf is not a DTensor equal to its tensor")
        counts = _read()                            # the phase's path ends here
        ctx.paths["distrib"] = counts
        emit({"phase": "distrib", "launches": counts})
        if counts["flash_attention"] != 2 * cfg.num_layers:
            fail(f"distrib: flash launches {counts['flash_attention']} != 2 forwards x layers")
        del sparams, dparams, leaves
        _free(torch)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ phase 11

def flash_bwd_case(ctx, torch, gen, label, b, nh, nkv, S, hd, dtype, *, Sk=None,
                   causal=True, window=0, softcap=0.0, prefix_len=0, controls=(),
                   q_scale=1.0):
    """The backward kernel against its plain version and against autograd
    through the plain forward in float64, from one seeded set of inputs;
    two calls bit-equal; each named control (the plain formula with a fault)
    must fail the same tolerance; ``q_scale`` scales q (scores of the
    softcap's size, where it bends them).  Times: the kernel (CUDA graph), the
    forward with and without lse, the plain backward, and SDPA's backward
    by autograd, as device time (a CUDA graph of SDPA's forward and backward
    less one of its forward) and eager (events around one call).  Prints
    each kernel's grid, splits and CTAs an SM."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_bwd_ref, attention_ref,
                                                     flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.kernel import bwd_cost as flash_bwd_cost
    from repro_torch.kernels.flash_attention.kernel import bwd_launch_plan, bwd_occupancy

    dev = torch.device("cuda")
    Sk = S if Sk is None else Sk
    q, k, v = (torch.randn((b, n, h, hd), generator=gen, device=dev)
               for n, h in ((S, nh), (Sk, nkv), (Sk, nkv)))
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
    do = torch.randn((b, S, nh, hd), generator=gen, device=dev).to(dtype)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))  # the op's views
    dot_c = dot.contiguous()
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    o, lse = flash_attention(qt, kt, vt, return_lse=True, **kw)
    got = flash_attention_bwd(qt, kt, vt, o, dot_c, lse, **kw)
    again = flash_attention_bwd(qt, kt, vt, o, dot_c, lse, **kw)
    plain = attention_bwd_ref(qt, kt, vt, o, dot_c, lse, **kw)
    x64 = [x.detach().double().requires_grad_(True) for x in (qt, kt, vt)]
    oracle = torch.autograd.grad(attention_ref(*x64, **kw), x64, dot.double())
    del x64
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"flash_attention_bwd {label}: two calls differ")
    dname = str(dtype).replace("torch.", "")
    rel = 5e-5 if dname == "float32" else 2e-2

    def worst(xs, refs):
        """max over dq, dk, dv of max|x - ref| / max|ref|"""
        return max(float((x.double() - r.double()).abs().max() / r.double().abs().max())
                   for x, r in zip(xs, refs))

    err_plain, err_oracle = worst(got, plain), worst(got, oracle)
    if err_plain > rel or err_oracle > rel:
        fail(f"flash_attention_bwd {label}: relative errors {err_plain} (plain) and "
             f"{err_oracle} (float64 autograd) outside {rel}")
    ctl = {}
    for name in controls:
        if name == "causal mask dropped":
            bad = attention_bwd_ref(qt, kt, vt, o, dot_c, lse, **dict(kw, causal=False))
        elif name == "softcap 1 - tanh^2 dropped":
            bad = _bwd_without_softcap_factor(torch, qt, kt, vt, o, dot_c, lse, **kw)
        elif name == "GQA without the sum over rep":
            rep = nh // nkv
            one = attention_bwd_ref(qt[:, ::rep], kt, vt, o[:, ::rep], dot_c[:, ::rep],
                                    lse[:, ::rep].contiguous(), **kw)
            bad = (plain[0], one[1], one[2])
        ctl[name] = worst(bad, got)
        if ctl[name] <= rel:
            fail(f"flash_attention_bwd {label}: control '{name}' passed ({ctl[name]})")
    # the bound: 5 products of the allowed pairs x hd (2 flops each) against
    # the forward's 2; each input read once, each gradient written once (the
    # formula the dry run books, kernel.bwd_cost)
    ops, nbytes = flash_bwd_cost(b, nh, nkv, S, Sk, hd, q.element_size(), causal=causal,
                                 window=window, prefix_len=prefix_len)
    peak = PEAK_OPS_3XTF32 if dname == "float32" else PEAK_OPS[dname]
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    kernel_ms = device_ms(torch, [lambda: flash_attention_bwd(qt, kt, vt, o, dot_c, lse, **kw)],
                          reps=10, per_graph=2)
    fwd_ms = device_ms(torch, [lambda: flash_attention(qt, kt, vt, **kw)])
    fwd_lse_ms = device_ms(torch, [lambda: flash_attention(qt, kt, vt, return_lse=True, **kw)])
    plain_ms = device_ms(torch, [lambda: attention_bwd_ref(qt, kt, vt, o, dot_c, lse, **kw)],
                         reps=5, per_graph=1)
    library_ms = library_eager_ms = None
    if softcap == 0.0:
        rep = nh // nkv
        ql, ke, ve = (x.detach().clone().requires_grad_(True) for x in
                      (qt, kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1)))
        plain_causal = causal and prefix_len == 0 and Sk == S
        mask = (None if window == 0 and (plain_causal or not causal)
                else _allowed(torch, S, Sk, causal, window, prefix_len))

        def sdpa():
            return F.scaled_dot_product_attention(ql, ke, ve, attn_mask=mask,
                                                  is_causal=mask is None and causal,
                                                  scale=kw["scale"])

        out = sdpa()
        library_eager_ms = eager_ms(torch, lambda: torch.autograd.grad(
            out, (ql, ke, ve), dot, retain_graph=True), reps=10, warmup=2)
        del out
        try:
            both = device_ms(torch, [lambda: torch.autograd.grad(sdpa(), (ql, ke, ve), dot)],
                             reps=10, per_graph=2)
            with torch.no_grad():
                fwd_only = device_ms(torch, [sdpa], reps=10, per_graph=2)
            library_ms = both - fwd_only
        except RuntimeError as e:  # a backend that refuses graph capture
            library_ms = f"not measured: {str(e).splitlines()[0][:200]}"
    plan = bwd_launch_plan(dtype, hd, batch=b, heads=nh, kv_heads=nkv, seq=S, kv_seq=Sk,
                           sms=torch.cuda.get_device_properties(0).multi_processor_count)
    grid = {"width": plan.width, "dq": {"grid": plan.grid_q, "threads": plan.threads_q,
                                        "split": plan.split_q, "smem": plan.smem_q},
            "dkv": {"grid": plan.grid_kv, "threads": plan.threads_kv,
                    "split": plan.split_kv, "col_split": plan.col_split,
                    "smem": plan.smem_kv}}
    for kern, occ in bwd_occupancy(dtype, hd).items():
        grid[kern].update(occ)
    print(f"flash_attention_bwd {label} ({dname}): dQ grid {plan.grid_q} split "
          f"{plan.split_q}, {grid['dq']['ctas_per_sm']} CTA/SM, {grid['dq']['registers']} regs; "
          f"dK/dV grid {plan.grid_kv} split {plan.split_kv} x {plan.col_split} columns, "
          f"{grid['dkv']['ctas_per_sm']} CTA/SM, {grid['dkv']['registers']} regs", flush=True)
    case = {"kernel": "flash_attention_bwd", "case": label, "dtype": dname,
            "b": b, "nh": nh, "nkv": nkv, "S": S, "Sk": Sk, "hd": hd, "causal": causal,
            "window": window, "softcap": softcap, "prefix_len": prefix_len,
            "max_abs_err": max(float((x.double() - r).abs().max())
                               for x, r in zip(got, oracle)),
            "rel_err_plain": err_plain, "rel_err_float64_autograd": err_oracle, "tol": rel,
            "controls": ctl, "deterministic": True,
            "ops": ops, "bytes": nbytes,
            "ops_peak": "3xTF32, 495/3 TFLOP/s" if dname == "float32" else "bf16, 989 TFLOP/s",
            "kernel_ms": kernel_ms,
            "eager_ms": eager_ms(torch, lambda: flash_attention_bwd(qt, kt, vt, o, dot_c, lse,
                                                                    **kw), reps=10, warmup=2),
            "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "library_eager_ms": library_eager_ms,
            "library": "SDPA backward (device: graph of forward + backward less forward)",
            "plan": grid}
    ctx.cases.append(case)
    emit(case)


def _bwd_without_softcap_factor(torch, q, k, v, o, do, lse, *, scale, causal, window,
                                softcap, prefix_len):
    """``attention_bwd_ref`` with the softcap's 1 - tanh^2 left out of dS
    (MHA or GQA; P from the capped scores, as the forward's lse has it):
    the control that must fail."""
    b, nh, S, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    rep = nh // nkv
    f = torch.float32
    qr, g, orr = (x.reshape(b, nkv, rep, S, hd).to(f) for x in (q, do, o))
    s = softcap * torch.tanh(torch.einsum("bgrqd,bgkd->bgrqk", qr, k.to(f)) * scale / softcap)
    allowed = _allowed(torch, S, Sk, causal, window, prefix_len)
    p = torch.where(allowed, torch.exp(s - lse.reshape(b, nkv, rep, S, 1)), 0.0)
    ds = p * (torch.einsum("bgrqd,bgkd->bgrqk", g, v.to(f)) - (g * orr).sum(-1, keepdim=True))
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k.to(f)) * scale
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qr) * scale
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, g)
    return dq.reshape(b, nh, S, hd), dk, dv


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _leaf_errs(np, got, want):
    """per flat path: max|got - want| / max|want|"""
    from repro_torch.convert import params_to_flat

    g, w = params_to_flat(got), params_to_flat(want)
    out = {}
    for path, ref in w.items():
        a, r = g[path].astype(np.float64), ref.astype(np.float64)
        out[path] = float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-30))
    return out


@contextlib.contextmanager
def _attention_detached():
    """Attention's output detached from q, k, v: the route before the flash
    backward existed."""
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.models import transformer

    orig = transformer.flash_attention_op
    transformer.flash_attention_op = lambda q, k, v, **kw: flash_attention_op(
        q.detach(), k.detach(), v.detach(), **kw)
    try:
        yield
    finally:
        transformer.flash_attention_op = orig


def _ssd_bwd_chunkwise(x, dt, A, B, C, D, dy, dstate, cs, s_in, *, chunk):
    """The backward kernel called on each chunk alone: every chunk keeps its
    entering state, and the gradient of the state it passes on is dropped
    (only the last chunk sees ``dstate``)."""
    import torch
    from repro_torch.kernels.ssd import ssd_scan_bwd

    l = x.shape[1]
    c = min(chunk, l)
    nc = l // c
    parts = []
    for k in range(nc):
        t = slice(k * c, (k + 1) * c)
        parts.append(ssd_scan_bwd(x[:, t], dt[:, t], A, B[:, t], C[:, t], D,
                                  dy[:, t].contiguous(), dstate if k == nc - 1 else None,
                                  cs[:, k:k + 1].contiguous(), s_in[:, k:k + 1].contiguous(),
                                  chunk=c))
    return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
            sum(p[2] for p in parts), torch.cat([p[3] for p in parts], 1),
            torch.cat([p[4] for p in parts], 1), sum(p[5] for p in parts))


@contextlib.contextmanager
def _ssd_carry_dropped():
    """``_SsdScan``'s backward chunk by chunk (``_ssd_bwd_chunkwise``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    orig = ssd_ops.ssd_scan_bwd
    ssd_ops.ssd_scan_bwd = _ssd_bwd_chunkwise
    try:
        yield
    finally:
        ssd_ops.ssd_scan_bwd = orig


@contextlib.contextmanager
def _ssd_float64_on_cpu():
    """The SSD scan of CPU tensors through ``_SsdScan`` with the plain
    forward and backward computed in float64.  The CPU's own route, float32
    autograd through the plain forward, sums dL/da per row and in reverse:
    at mamba2-780m's width its A_log gradient lies 3.3e-4 of the leaf's
    largest entry from this one, the kernel's decomposition in float32
    2.9e-5 (tests/test_torch_ssd_bwd.py measures the op)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_ref

    def forward(x, dt, A, B, C, D, *, chunk):
        y, state = ssd_ref(*(t.double() for t in (x, dt, A, B, C, D)), chunk=chunk)
        return y.to(x.dtype), state.float(), None, None

    def backward(x, dt, A, B, C, D, dy, dstate, cs, s_in, *, chunk):
        ins = (x, dt, A, B, C, D)
        grads = ssd_bwd_ref(*(t.double() for t in ins + (dy,)),
                            None if dstate is None else dstate.double(), chunk=chunk)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))

    saved = (ssd_ops.all_on_cpu, ssd_ops.ssd_scan_for_grad, ssd_ops.ssd_scan_bwd)
    ssd_ops.all_on_cpu = lambda *t: False
    ssd_ops.ssd_scan_for_grad, ssd_ops.ssd_scan_bwd = forward, backward
    try:
        yield
    finally:
        ssd_ops.all_on_cpu, ssd_ops.ssd_scan_for_grad, ssd_ops.ssd_scan_bwd = saved


def _train_parity(ctx, torch, cfg, batch, seq, control, control_name, control_leaves,
                  cpu_route=contextlib.nullcontext):
    """One float32 train step at full width on the card and on the CPU from
    the same state and batch (b ``batch`` x S ``seq``); the CPU runs under
    ``cpu_route`` (the mamba2 step's: its SSD scan in float64, where the
    CPU's own float32 route is reported beside it); under ``control`` (a
    context manager, a fault in the card's backward) the gradient of every
    leaf whose last path part is in ``control_leaves`` must miss the
    tolerance.  Returns the emitted row."""
    import numpy as np
    from repro_torch.launch.steps import make_train_state, make_train_step, value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig

    model = build_model(cfg)
    # eps 1: the update is about lr * g, so updated parameters compare the
    # step's arithmetic and not AdamW's sign-like first update of entries
    # whose gradient is at float32 sum-order noise
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10, eps=1.0)
    cpu = make_train_state(model, opt, 0, device="cpu")
    gpu = _to_device(cpu, "cuda")
    rng = np.random.default_rng(21)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]), "labels": torch.from_numpy(tok[:, 1:])}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    t0 = time.perf_counter()
    with cpu_route():
        _, g_cpu = value_and_grad(model, cpu["params"], batch)
    _, g_gpu = value_and_grad(model, gpu["params"], gbatch)
    grad_errs = _leaf_errs(np, g_gpu, g_cpu)
    cpu_own = None
    if cpu_route is not contextlib.nullcontext:
        _, g_own = value_and_grad(model, cpu["params"], batch)
        cpu_own = max(_leaf_errs(np, g_own, g_cpu).items(), key=lambda t: t[1])
        del g_own
    with control():
        _, g_bad = value_and_grad(model, gpu["params"], gbatch)
    bad = {p: e for p, e in _leaf_errs(np, g_bad, g_cpu).items()
           if p.split("/")[-1] in control_leaves}
    step = make_train_step(model, opt)
    with cpu_route():
        cpu, m_cpu = step(cpu, batch)
    gpu, m_gpu = step(gpu, gbatch)
    torch.cuda.synchronize()
    loss_rel = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    gn_rel = abs(float(m_gpu["grad_norm"]) - float(m_cpu["grad_norm"])) / float(m_cpu["grad_norm"])
    param_errs = _leaf_errs(np, gpu["params"], cpu["params"])
    out = {"phase": "train", "check": f"float32 train step, {cfg.name} {cfg.num_layers} layers, "
           f"b {batch['tokens'].shape[0]} x S {seq}, card vs CPU",
           "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
           "grad_norm_rel_err": gn_rel, "worst_grad_leaf": max(grad_errs.items(),
                                                               key=lambda t: t[1]),
           "worst_param_leaf": max(param_errs.items(), key=lambda t: t[1]),
           "control": control_name, "control_worst_leaf": max(bad.items(), key=lambda t: t[1]),
           "control_best_leaf": min(bad.items(), key=lambda t: t[1]),
           "cpu_float32_route_worst_leaf": cpu_own,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if loss_rel > 1e-5:
        fail(f"train step {cfg.name}: loss {loss_rel} from the CPU's")
    if max(grad_errs.values()) > 1e-4:
        fail(f"train step {cfg.name}: gradient leaf {out['worst_grad_leaf']} outside 1e-4")
    if gn_rel > 1e-5 or max(param_errs.values()) > 1e-5:
        fail(f"train step {cfg.name}: grad norm {gn_rel} or params {out['worst_param_leaf']} "
             "outside 1e-5")
    if min(bad.values()) <= 1e-4:
        fail(f"train step {cfg.name}: the control '{control_name}' passed ({bad})")
    del cpu, gpu, g_cpu, g_gpu, g_bad
    _free(torch)
    return out


def _profile_step(torch, tr, name, step_ms, bwd_launches):
    """One more step of a trainer under ``torch.profiler``: the device time
    of its kernels (one stream, so their sum is the busy time), the idle
    share of the median unprofiled step ``step_ms``, the kernels that hold
    most of the time, and each SSD kernel's launches and time; each of the
    ``ssd_scan`` backward's CUDA kernels must run ``bwd_launches`` times
    (once per mamba layer)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd.kernel import BWD_KERNELS_PER_CALL

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train(1)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ssd = {}
    for k, (n, us) in by_name.items():
        short = re.search(r"ssd_\w+", k)
        if short:
            n0, us0 = ssd.get(short.group(0), (0, 0.0))
            ssd[short.group(0)] = (n0 + n, us0 + us)
    emit({"phase": "train", "model": name, "profiled_step": {
        "device_busy_ms": busy_ms, "step_ms": step_ms,
        "idle_share": 1 - busy_ms / step_ms if by_name else "not measured",
        "top_kernels": [{"name": k[:90], "launches": n, "ms": us / 1e3}
                        for k, (n, us) in top],
        "ssd_kernels": {k: {"launches": n, "ms": us / 1e3} for k, (n, us) in sorted(ssd.items())}}})
    bwd = {k: n for k, (n, _) in ssd.items() if k.startswith("ssd_bwd_")}
    want = BWD_KERNELS_PER_CALL[torch.bfloat16]  # the train runs are bf16
    if by_name and (len(bwd) != want or set(bwd.values()) != {bwd_launches}):
        fail(f"train {name}: the profiled step ran the ssd_scan backward's kernels {bwd}, "
             f"want {want} kernels {bwd_launches} times each")


def _train_run(ctx, torch, rt, name, cfg, batch, seq, steps=10, *, opt=None,
               checkpoint_every=5, falling=True, profile_bwd_launches=None):
    """``steps`` steps through ``Trainer`` on the card (AdamW unless ``opt``),
    checkpoints every ``checkpoint_every`` submitted to its async writer
    (the caller drains it: the writes overlap what runs next); the losses
    must be finite and, where ``falling``, end below where they began;
    ``profile_bwd_launches``: one more step after them under the profiler
    (``_profile_step``, which expects that many launches of each of the
    ``ssd_scan`` backward's kernels); returns (trainer, losses, step times s, peak GiB,
    counts, train s)."""
    import numpy as np
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = build_model(cfg)
    opt = opt or OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    shards = 2 if batch % 2 == 0 else 1
    loader = ShardedLoader(seed=0, vocab=cfg.vocab_size, seq_len=seq,
                           batch_per_shard=batch // shards, num_shards=shards,
                           owned=list(range(shards)))
    tr = Trainer(model, opt, loader,
                 TrainerConfig(workdir=os.path.join(rt, name), checkpoint_every=checkpoint_every),
                 device="cuda")
    tr.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset()
    t0 = time.perf_counter()
    tr.train(steps)
    torch.cuda.synchronize()
    counts = _read()
    t_train = time.perf_counter() - t0
    losses = [m["loss"] for m in tr.metrics_log]
    times = [m["step_time"] for m in tr.metrics_log]
    peak = _peak_gb(torch)
    if not all(np.isfinite(x) for x in losses) or (falling and not losses[-1] < losses[0]):
        fail(f"train {name}: losses {losses} not finite{' and falling' if falling else ''}")
    if profile_bwd_launches is not None:
        _profile_step(torch, tr, name, statistics.median(times[1:]) * 1e3, profile_bwd_launches)
    tr.state = None  # the writer holds its host copies
    _free(torch)
    return tr, losses, times, peak, counts, t_train


def _drain(tr, name, steps=10):
    """Wait for a trainer's async checkpoints; seconds waited."""
    t0 = time.perf_counter()
    tr.writer.drain()
    tr.close()
    if len(tr.writer.written) != steps // 5:
        fail(f"train {name}: {len(tr.writer.written)} checkpoints written, not {steps // 5}")
    return time.perf_counter() - t0


def _train_cli(ctx, torch, rt):
    """Crash and resume through ``python -m repro_torch.launch.train``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
            "--arch", "stablelm-3b", "--steps", "30", "--batch", "4", "--seq", "64",
            "--checkpoint-every", "10"]

    def run(workdir, *extra):
        r = subprocess.run(base + ["--workdir", workdir, *extra], capture_output=True,
                           text=True, env=env, cwd=HERE, timeout=300)
        return r

    def losses(workdir):
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            return {m["step"]: m["loss"] for m in map(json.loads, f)}

    t0 = time.perf_counter()
    a, b = os.path.join(rt, "cli_whole"), os.path.join(rt, "cli_crash")
    # the uninterrupted run in its own process beside the crash and resume
    with subprocess.Popen(base + ["--workdir", a], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, env=env, cwd=HERE) as p:
        crash = run(b, "--simulate-failure", "17")
        resumed = run(b, "--resume")
        out, err = p.communicate(timeout=300)
    whole = subprocess.CompletedProcess(p.args, p.returncode, out, err)
    codes = (whole.returncode, crash.returncode, resumed.returncode)
    if codes != (0, 17, 0):
        fail(f"train CLI: exit codes {codes} (want 0, 17, 0): "
             f"{(whole.stderr + crash.stderr + resumed.stderr)[-3000:]}")
    want, got = losses(a), losses(b)
    if sorted(got) != list(range(17, 30)):
        fail(f"train CLI: resumed steps {sorted(got)}")
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
    emit({"phase": "train", "check": "CLI crash at 17 and resume, stablelm-3b reduced, "
          "f32, 30 steps", "exit_codes": list(codes), "resumed_max_rel_err": rel,
          "resumed_line": resumed.stdout.splitlines()[0], "seconds": time.perf_counter() - t0})
    if rel > 1e-4:
        fail(f"train CLI: resumed losses {rel} from the uninterrupted run's")


def bwd_cases(ctx, torch):
    """The flash backward against its plain version at the train shapes and
    at the other paths' shapes: the first part of phase 11."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    bf16, f32 = torch.bfloat16, torch.float32
    flash_bwd_case(ctx, torch, gen, "faas-bench S=256", 1, 6, 6, 256, 64, f32)
    flash_bwd_case(ctx, torch, gen, "stablelm-3b train b=4 S=1024", 4, 32, 32, 1024, 80, bf16,
                   controls=("causal mask dropped",))
    flash_bwd_case(ctx, torch, gen, "stablelm-3b S=1024", 1, 32, 32, 1024, 80, f32)
    flash_bwd_case(ctx, torch, gen, "GQA 32:8 S=1024", 1, 32, 8, 1024, 128, bf16,
                   controls=("GQA without the sum over rep",))
    # scores of std 30: the cap of 50 bends them (unit scores would leave
    # 1 - tanh^2 within 1e-3 of 1)
    flash_bwd_case(ctx, torch, gen, "gemma-2 window 256 softcap 50 S=1024", 1, 32, 16, 1024,
                   128, bf16, window=256, softcap=50.0, q_scale=30.0,
                   controls=("softcap 1 - tanh^2 dropped",))
    for dt in (bf16, f32):
        flash_bwd_case(ctx, torch, gen, "paligemma-3b prefix 256 S=512", 1, 8, 1, 512, 256,
                       dt, prefix_len=256)
    flash_bwd_case(ctx, torch, gen, "whisper-small encoder S=1500", 1, 12, 12, 1500, 64, bf16,
                   causal=False)
    flash_bwd_case(ctx, torch, gen, "whisper-small cross S=64 Sk=1500", 1, 12, 12, 64, 64, bf16,
                   Sk=1500, causal=False)
    _free(torch)


def ssd_bwd_case(ctx, torch, gen, label, b, l, nh, hd, ds, chunk, dtype, *, control=False):
    """The SSD backward kernel against its plain version and against float64
    autograd through the plain forward, from one seeded set of inputs (x, B
    and C as views of one xBC, dy, a final state's gradient); two calls
    bit-equal; ``control``: the kernel on each chunk alone (the inter-chunk
    state gradient dropped) must miss the same tolerance.  Times: the kernel
    (CUDA graph, and eager), the plain backward.  Tolerances of each
    gradient's largest entry: float32 5e-5 (dA 1e-4: one signed sum per head
    over the batch's rows), bf16 2e-2.  The plan's head group, grid, CTAs an
    SM (designed, and as the runtime reports them: fewer fails), the chunk
    kernel's registers and spills, scratch bytes and the tensor-core
    operations a call issues beside the bound's."""
    from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_ref, ssd_scan_bwd
    from repro_torch.kernels.ssd.kernel import bwd_cost as ssd_bwd_cost
    from repro_torch.kernels.ssd.kernel import (bwd_launch_plan, bwd_occupancy,
                                                ssd_scan_for_grad)

    dev = torch.device("cuda")
    d_in = nh * hd
    xbc = torch.randn((b, l, d_in + 2 * ds), generator=gen, device=dev).to(dtype)
    x = xbc[..., :d_in].reshape(b, l, nh, hd)
    B, C = xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:]
    dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.49 + 0.01
    A = -(torch.rand((nh,), generator=gen, device=dev) * 1.5 + 0.5)
    D = torch.randn((nh,), generator=gen, device=dev)
    dy = torch.randn((b, l, nh, hd), generator=gen, device=dev).to(dtype)
    dS = torch.randn((b, nh, hd, ds), generator=gen, device=dev)
    args = (x, dt, A, B, C, D)
    _, _, cs, s_in = ssd_scan_for_grad(*args, chunk=chunk)

    def call():
        return ssd_scan_bwd(*args, dy, dS, cs, s_in, chunk=chunk)

    got, again = call(), call()
    plain = ssd_bwd_ref(*args, dy, dS, chunk=chunk)
    leaves = [t.detach().double().requires_grad_(True) for t in args]
    y64, st64 = ssd_ref(*leaves, chunk=chunk)
    oracle = torch.autograd.grad((y64 * dy.double()).sum() + (st64 * dS.double()).sum(), leaves)
    del leaves, y64, st64
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        fail(f"ssd_scan_bwd {label}: two calls differ")
    dname = str(dtype).replace("torch.", "")
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")

    def tol(n):
        return 2e-2 if dname == "bfloat16" else (1e-4 if n == "dA" else 5e-5)

    def errs(xs, refs):
        """per gradient: max|x - ref| / max|ref|"""
        return {n: float((x.double() - r.double()).abs().max() / r.double().abs().max())
                for n, x, r in zip(names, xs, refs)}

    e_plain, e_oracle = errs(got, plain), errs(got, oracle)
    if any(max(e_plain[n], e_oracle[n]) > tol(n) for n in names):
        fail(f"ssd_scan_bwd {label} ({dname}): relative errors {e_plain} (plain) and "
             f"{e_oracle} (float64 autograd) outside their tolerances")
    ctl = None
    if control:
        ctl = errs(_ssd_bwd_chunkwise(*args, dy, dS, cs, s_in, chunk=chunk), oracle)
        if not all(ctl[n] > tol(n) for n in ("dx", "ddt", "dB")):
            fail(f"ssd_scan_bwd {label}: the control 'inter-chunk dS dropped' passed ({ctl})")
    # the bound: the causal half of C.B^T once per (batch, chunk); per
    # (batch, chunk, head) the causal half of dy.x^T, M^T dy, N^T C and N B
    # and four (c x hd x ds) state products; each input read once (x, dy, B,
    # C, dt, A, D, the state's gradient), each gradient written once (the
    # formula the dry run books, kernel.bwd_cost)
    c = min(chunk, l)
    ops, nbytes = ssd_bwd_cost(b, l, nh, hd, ds, chunk, x.element_size())
    peak = PEAK_OPS_3XTF32 if dname == "float32" else PEAK_OPS[dname]
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    plan = bwd_launch_plan(dtype, hd, ds, c, batch=b, heads=nh, seq=l)
    occ = bwd_occupancy(dtype, ds)
    if occ["ctas_per_sm"] < plan.ctas_per_sm:
        fail(f"ssd_scan_bwd {label} ({dname}): {occ['ctas_per_sm']} chunk CTAs an SM, the plan "
             f"counts on {plan.ctas_per_sm} ({occ})")
    case = {"kernel": "ssd_scan_bwd", "case": label, "dtype": dname, "b": b, "l": l,
            "nh": nh, "hd": hd, "ds": ds, "chunk": chunk,
            "max_abs_err": max(float((x.double() - r).abs().max()) for x, r in zip(got, oracle)),
            "rel_err_plain": e_plain, "rel_err_float64_autograd": e_oracle,
            "tol": {n: tol(n) for n in names}, "control_inter_chunk_dS_dropped": ctl,
            "deterministic": True, "ops": ops, "bytes": nbytes,
            "ops_peak": "3xTF32, 495/3 TFLOP/s" if dname == "float32" else "bf16, 989 TFLOP/s",
            "kernel_ms": device_ms(torch, [call], reps=10, per_graph=2),
            "eager_ms": eager_ms(torch, call, reps=10, warmup=2),
            "plain_ms": device_ms(torch, [lambda: ssd_bwd_ref(*args, dy, dS, chunk=chunk)],
                                  reps=5, per_graph=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "library": "none (no single call)",
            "plan": {"head_group": plan.head_group, "grid_chunk": plan.grid_chunk,
                     "waves": plan.waves, "grid_pass": plan.grid_pass,
                     "smem_chunk": plan.smem_chunk, "ctas_per_sm": plan.ctas_per_sm,
                     "ctas_per_sm_runtime": occ["ctas_per_sm"],
                     "registers": occ["registers"], "spill_bytes": occ["spill_bytes"],
                     "scratch_bytes": plan.scratch_bytes, "products": plan.products,
                     "products_over_bound_ops": plan.products / ops,
                     "cuda_kernels_per_call": plan.kernels}}
    ctx.cases.append(case)
    emit(case)


def ssd_bwd_cases(ctx, torch):
    """The SSD backward at mamba2-780m's train shapes (bf16 and f32), at its
    float32 step's shape with the control, at jamba's width (bf16 and f32)
    and over 32 chunks."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    bf16, f32 = torch.bfloat16, torch.float32
    m2 = (48, 64, 128, 256)
    for dt in (bf16, f32):
        ssd_bwd_case(ctx, torch, gen, "mamba2-780m train b=4 l=1024", 4, 1024, *m2, dt)
    ssd_bwd_case(ctx, torch, gen, "mamba2-780m f32 step b=2 l=512", 2, 512, *m2, f32,
                 control=True)
    for dt in (bf16, f32):
        ssd_bwd_case(ctx, torch, gen, "jamba-v0.1-52b train l=1024", 1, 1024, 128, 64, 16, 256,
                     dt)
    ssd_bwd_case(ctx, torch, gen, "mamba2-780m l=8192 (32 chunks)", 1, 8192, *m2, bf16)
    _free(torch)


def _ssd_train_row(ctx, name, cfg, cut, batch, seq, optimizer, losses, times, peak, counts,
                   t_train, at):
    """The train row of an SSM model, its launches a step checked: one
    ``ssd_scan`` backward per mamba layer, a forward per mamba layer (two
    under remat), and for an attention layer one flash forward and backward."""
    from repro_torch.models.blocks import build_plan

    steps = len(losses)
    plan = build_plan(cfg)
    n_attn = sum(k.mixer == "attn" for k in plan.kinds) * plan.n_repeat
    n_mamba = cfg.num_layers - n_attn
    per_step = {k: counts[k] / steps for k in
                ("ssd_scan", "ssd_scan_bwd", "flash_attention", "flash_attention_bwd")}
    if per_step["ssd_scan_bwd"] != n_mamba or per_step["ssd_scan"] not in (n_mamba, 2 * n_mamba):
        fail(f"train {name}: ssd_scan launches a step {per_step}, want {n_mamba} backward")
    if (per_step["flash_attention_bwd"] != n_attn
            or per_step["flash_attention"] not in (n_attn, 2 * n_attn)):
        fail(f"train {name}: flash launches a step {per_step}, want {n_attn} backward")
    step_ms = statistics.median(times[1:]) * 1e3
    main = next(c for c in ctx.cases if c["case"] == at and c["dtype"] == "bfloat16")
    row = {"phase": "train", "model": name, "cut": cut, "dtype": "bfloat16",
           "optimizer": optimizer, "batch": [batch, seq], "losses": losses,
           "ms_per_step": step_ms, "first_step_ms": times[0] * 1e3,
           "tokens_per_s": batch * seq / (step_ms / 1e3), "peak_gib": peak,
           "launches_per_step": per_step,
           "ssd_bwd_share_of_step": per_step["ssd_scan_bwd"] * main["kernel_ms"] / step_ms,
           "train_s": t_train, "launches": counts}
    emit(row)
    return row


def phase_train(ctx, torch, rt):
    """Training: the flash backward kernel against its plain version at
    the train shapes, a float32 train step against the CPU, bf16 training
    at full width through the Trainer, the CLI's crash and resume; then the
    SSD backward against its plain version, a float32 mamba2-780m step
    against the CPU, mamba2-780m whole and a jamba-v0.1-52b period in bf16."""
    from repro_torch.configs import get_config

    bwd_cases(ctx, torch)
    _train_parity(ctx, torch, dataclasses.replace(get_config("stablelm-3b"), num_layers=2,
                                                  dtype="float32"), 2, 256,
                  _attention_detached, "attention detached", ("wq", "wk", "wv"))

    # bf16 at full width through the Trainer: 2 + 2 flash launches a step
    full = get_config("stablelm-3b")
    cfg = dataclasses.replace(full, num_layers=2)
    tr_lm, losses, times, peak, counts, t_train = _train_run(ctx, torch, rt, "stablelm",
                                                             cfg, 4, 1024)
    ctx.paths["stablelm-3b train (bf16)"] = counts
    steps = len(losses)
    per_step = (counts["flash_attention"] / steps, counts["flash_attention_bwd"] / steps)
    if per_step != (cfg.num_layers, cfg.num_layers):
        fail(f"train stablelm-3b: flash launches a step {per_step}, want 2 + 2")
    step_ms = statistics.median(times[1:]) * 1e3
    main = next(c for c in ctx.cases if c["case"] == "stablelm-3b train b=4 S=1024")
    flash_ms = per_step[0] * main["fwd_lse_ms"] + per_step[1] * main["kernel_ms"]
    lm = {"phase": "train", "model": "stablelm-3b", "cut": f"num_layers {full.num_layers} -> 2",
          "dtype": "bfloat16", "optimizer": "adamw (f32 m, v)", "batch": [4, 1024],
          "losses": losses, "ms_per_step": step_ms, "first_step_ms": times[0] * 1e3,
          "tokens_per_s": 4 * 1024 / (step_ms / 1e3), "peak_gib": peak,
          "flash_fwd_bwd_per_step": per_step, "flash_share_of_step": flash_ms / step_ms,
          "train_s": t_train, "launches": counts}
    emit(lm)
    fb = get_config("faas-bench")
    tr_fb, losses, times, peak, counts, t_train = _train_run(ctx, torch, rt, "faas", fb, 4,
                                                             256)
    ctx.paths["faas-bench train (f32)"] = counts
    emit({"phase": "train", "model": "faas-bench", "dtype": "float32", "batch": [4, 256],
          "losses": losses, "ms_per_step": statistics.median(times[1:]) * 1e3,
          "peak_gib": peak, "launches": counts})
    if counts["flash_attention_bwd"] != 10 * fb.num_layers:
        fail(f"train faas-bench: {counts['flash_attention_bwd']} backward launches")

    _train_cli(ctx, torch, rt)
    emit({"phase": "train", "check": "async checkpoints drained (2 each; the stablelm-3b "
          "writes ran beside faas-bench and the CLI)",
          "stablelm_drain_s": _drain(tr_lm, "stablelm"), "faas_drain_s": _drain(tr_fb, "faas")})

    _ssm_training(ctx, torch, rt)


def _ssm_training(ctx, torch, rt):
    """The SSM families on the card: the ssd_scan backward at the train
    shapes, a float32 mamba2-780m step against the CPU (2 layers, b 2 x S
    512: two chunks), mamba2-780m whole (bf16, b 4 x S 1024, 10 steps) and a
    jamba-v0.1-52b period (bf16, b 1 x S 1024, 3 steps)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptimizerConfig

    ssd_bwd_cases(ctx, torch)
    m_full = get_config("mamba2-780m")
    _train_parity(ctx, torch, dataclasses.replace(m_full, num_layers=2, dtype="float32"), 2,
                  512, _ssd_carry_dropped, "inter-chunk dS dropped",
                  ("w_xBC", "w_dt", "A_log", "conv_w"), cpu_route=_ssd_float64_on_cpu)
    # mamba2-780m whole, bf16, AdamW f32 m / v, no checkpoints (an 11 GB
    # state would cost about a minute of host time; stablelm-3b's run
    # drives the async writer)
    tr, losses, times, peak, counts, t_train = _train_run(ctx, torch, rt, "mamba2", m_full, 4,
                                                          1024, checkpoint_every=12,
                                                          profile_bwd_launches=48)
    tr.close()
    ctx.paths["mamba2-780m train (bf16)"] = counts
    _ssd_train_row(ctx, "mamba2-780m", m_full, "none (48 layers)", 4, 1024, "adamw (f32 m, v)",
                   losses, times, peak, counts, t_train, "mamba2-780m train b=4 l=1024")
    # one jamba-v0.1-52b period: 1 attention and 7 mamba layers, 4 MoE
    # layers of 16 experts; Adafactor accumulating in bf16, so that it fits
    j_full = get_config("jamba-v0.1-52b")
    j_cfg = dataclasses.replace(j_full, num_layers=j_full.attn_layer_period)
    opt = OptimizerConfig(name="adafactor", accum_dtype="bfloat16", lr=1e-3, warmup_steps=1,
                          total_steps=3)
    tr, losses, times, peak, counts, t_train = _train_run(ctx, torch, rt, "jamba", j_cfg, 1,
                                                          1024, 3, opt=opt, checkpoint_every=5,
                                                          falling=False, profile_bwd_launches=7)
    tr.close()
    ctx.paths["jamba-v0.1-52b train (bf16)"] = counts
    _ssd_train_row(ctx, "jamba-v0.1-52b", j_cfg,
                   f"num_layers {j_full.num_layers} -> {j_cfg.num_layers} (one period)", 1, 1024,
                   "adafactor (bf16 accumulation)", losses, times, peak, counts, t_train,
                   "jamba-v0.1-52b train l=1024")


# ------------------------------------------------------------------ phase 15

def _real_args(torch, cell, seed):
    """The cell's arguments as tensors on the card: weights from ``seed``
    (``Model.init``), optimizer state from them, token ids below the
    vocabulary and N(0, 1) embeddings in the meta tensors' shapes."""
    from repro_torch.launch.specs import opt_for
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer

    cfg = cell.cfg
    params = build_model(cfg).init(seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device="cuda",
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)

    batch = {k: fill(v) for k, v in cell.args[1].items()}
    if cell.shape.kind == "train":
        return {"params": params, "opt": make_optimizer(opt_for(cfg))[0](params)}, batch
    return params, batch


def _dryrun_cell(ctx, torch, label, cfg, shape, seed):
    """One cell of the dry run against the card: traced on meta under
    ``opcost``, then the same step with real tensors, its launches held to
    the booked calls kernel by kernel, timed and profiled."""
    from repro_torch import opcost
    from repro_torch import roofline as rl
    from repro_torch.distrib.sharding import AbstractMesh
    from repro_torch.launch.specs import build_cell

    cell = build_cell(cfg, shape, AbstractMesh(("data", "model"), (1, 1)))
    t0 = time.perf_counter()
    _, totals, _ = opcost.trace(cell.fn, *cell.args)
    t_trace = time.perf_counter() - t0
    if set(totals.devices) != {"meta"}:
        fail(f"dryrun {label}: the trace wrote outside meta (device: first op) {totals.devices}")
    args = _real_args(torch, cell, seed)
    torch.cuda.synchronize()
    _reset()                                        # main path starts here
    out = cell.fn(*args)
    torch.cuda.synchronize()
    counts = _read()                                # main path ends here
    ctx.paths[f"dryrun {label}"] = counts
    booked = totals.kernel_calls
    for k in set(booked) | {k for k, v in counts.items() if v}:
        if booked.get(k, 0) != counts[k]:
            fail(f"dryrun {label}: booked {booked} kernel calls, the card launched {counts}")
    if shape.kind == "train":
        _, metrics = out
        vals = [float(metrics["loss"]), float(metrics["grad_norm"])]
    else:
        logits, cache = out
        vals = [float(logits.float().abs().max())] + [
            float(t.float().abs().max()) for c in cache.values() for t in c.values()]
        if tuple(logits.shape) != (shape.global_batch, 1, cfg.vocab_size):
            fail(f"dryrun {label}: logits {tuple(logits.shape)}")
    if not all(v == v and abs(v) != float("inf") for v in vals):
        fail(f"dryrun {label}: non-finite outputs {vals}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cell.fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    t_compute = totals.flops / rl.PEAK_FLOPS[cfg.dtype] * 1e3
    t_memory = totals.bytes / rl.HBM_BW * 1e3
    mflops = rl.model_flops(cfg, shape)
    prof = _profile_call(torch, lambda: cell.fn(*args))
    ours = {k: v for k, v in prof.get("by_name", {}).items()
            if re.search(r"\b(flash_|ssd_)\w+", k)}
    ours_ms = sum(us for _, us in ours.values()) / 1e3
    busy = prof.get("device_busy_ms")
    emit({"phase": "dryrun", "cell": label, "trace_s": t_trace,
          "booked_kernel_calls": booked, "launches": counts,
          "flops": totals.flops, "bytes": totals.bytes, "model_flops": mflops,
          "t_compute_ms": t_compute, "t_memory_ms": t_memory,
          "roofline_bound_ms": max(t_compute, t_memory),
          "step_ms_median_of_5": step_ms, "step_ms": [t * 1e3 for t in times],
          "mfu": mflops / (step_ms / 1e3 * rl.PEAK_FLOPS["bfloat16"]),
          "booked_kernel_flops_share": sum(totals.kernel_flops.values()) / totals.flops,
          "booked_kernel_bytes_share": sum(totals.kernel_bytes.values()) / totals.bytes,
          "device_busy_ms": busy if busy is not None else "not measured",
          "kernels_busy_ms": ours_ms if busy is not None else "not measured",
          "kernels_busy_share": ours_ms / busy if busy else "not measured",
          "top_kernels": prof.get("top_kernels", "not measured"),
          "outputs": vals[:4]})
    del out, args
    _free(torch)


def phase_dryrun(ctx, torch, rt):
    """The dry run and cost model held to the card: stablelm-3b (2 layers)
    train b 4 x S 1024 and mamba2-780m (whole) prefill b 1 x S 4096, each
    traced on meta and run on the card; then the dry-run CLI on olmoe-1b-7b
    train_4k, both production meshes."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig

    full = get_config("stablelm-3b")
    _dryrun_cell(ctx, torch, "stablelm-3b train", dataclasses.replace(full, num_layers=2),
                 ShapeConfig("train_1k", 1024, 4, "train"), seed=41)
    _dryrun_cell(ctx, torch, "mamba2-780m prefill", get_config("mamba2-780m"),
                 ShapeConfig("prefill_4k", 4096, 1, "prefill"), seed=43)
    out = os.path.join(rt, "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "olmoe-1b-7b", "--shape", "train_4k", "--both-meshes", "--out", out],
                       capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
    if r.returncode != 0:
        fail(f"the dry-run CLI failed: {r.stderr[-2000:]}")
    for line in r.stdout.splitlines():
        if line.startswith("[dryrun]"):
            print(line, flush=True)
    files = sorted(os.listdir(out))
    for f in files:
        with open(os.path.join(out, f)) as fh:
            d = json.load(fh)
        if set(d["opcost"]["devices"]) != {"meta"} or d["roofline"]["flops_per_device"] <= 0:
            fail(f"dry-run artifact {f}: {d['opcost']['devices']}, "
                 f"{d['roofline']['flops_per_device']} FLOPs")
    emit({"phase": "dryrun", "cli_s": time.perf_counter() - t0, "artifacts": files})
    if len(files) != 2:
        fail(f"the dry-run CLI wrote {files}")


# ------------------------------------------------------------------- summary

KERNELS = {  # source, the TPU kernel it replaces, the path its launches are read on,
    # and the phase-3 case at that path's shape
    "snapshot_patch": ("src/repro_torch/csrc/snapshot_patch.cu",
                       "src/repro/kernels/snapshot_patch/kernel.py:41", "olmoe-1b-7b served",
                       "olmoe-1b-7b embed/table, 64 KiB chunks"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:101",
                        "olmoe-1b-7b served", "olmoe-1b-7b S=256"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:136 (no Pallas kernel: JAX "
                            "differentiates blockwise_attention)",
                            "stablelm-3b train (bf16)", "stablelm-3b train b=4 S=1024"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd/kernel.py:80", "jamba-v0.1-52b prefill",
                 "jamba-v0.1-52b width l=1024"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/models/ssm.py:25 (no Pallas kernel: JAX differentiates "
                     "ssd_chunked)", "mamba2-780m train (bf16)", "mamba2-780m train b=4 l=1024"),
    "decode_attention_int8": ("src/repro_torch/csrc/decode_attention_int8.cu",
                              "src/repro/kernels/decode_attention/kernel.py:77",
                              "stablelm-3b prefill + decode", "stablelm-3b S=2048 pos=1039"),
}


def summary(ctx):
    out = []
    for name, (source, replaces, path, at) in KERNELS.items():
        cases = [c for c in ctx.cases if c["kernel"] == name and "kernel_ms" in c]
        main = next(c for c in cases if c["case"] == at)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": ctx.paths[path][name],
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ms": main["kernel_ms"], "eager_ms": main["eager_ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "at": at, "dtype": main["dtype"],
                    "path": path,
                    "launches_by_path": {p: c[name] for p, c in ctx.paths.items()}})
    emit({"kernels": out})


PHASES = (("env", phase_env), ("build", phase_build), ("kernels", phase_kernels),
          ("faas", phase_faas), ("stablelm", phase_stablelm), ("mamba2", phase_mamba2),
          ("olmoe", phase_olmoe), ("decode", phase_decode), ("encdec", phase_encdec),
          ("grok", phase_grok), ("faults", phase_faults), ("distrib", phase_distrib),
          ("train", phase_train),
          ("serve", phase_serve), ("dryrun", phase_dryrun))


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
    for name, (_, _, path, _) in KERNELS.items():
        if path not in ctx.paths:
            fail(f"the launch counts of {path} were not read")
        if ctx.paths[path][name] <= 0:
            fail(f"{name} was never launched on {path}")
    summary(ctx)
    emit({"total_s": time.perf_counter() - t_all})
    print(ctx.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
