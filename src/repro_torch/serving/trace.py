"""Serving harness of the port: build a function suite, replay traces.

``repro.serving.trace`` with a ``device`` argument.  The suite mirrors the
paper's Table 1: *adapter* functions touch a few embedding rows and one
layer, *head* functions replace the whole embedding table, *fine-tune*
functions modify every block.  bfloat16 leaves travel as ``uint16`` bit
patterns; their variants are computed on the values, rounded to bfloat16
after every operation as ``ml_dtypes`` arithmetic rounds.

``build_specs`` is the JAX package's, and like it needs an FFN weight for
the adapter's "imported library"; ``build_delta_specs`` builds the same
three kinds as deltas, which hold only the leaves that change: by
``build_specs``' rules where the blocks have an FFN (dense, MoE, hybrid),
and on the mixer's weights where they have none (mamba2).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..convert import bf16_bits_to_f32, f32_to_bf16_bits, params_to_flat
from ..device import DeviceLike
from ..models import Model
from .api import ColdStartOptions, InvocationRequest, InvocationResult, Strategy
from .cluster import Cluster
from .worker import FunctionSpec, Worker

PyTree = object


def _values(arr: np.ndarray) -> Tuple[np.ndarray, Callable[[np.ndarray], np.ndarray]]:
    """(float values, per-operation rounding) of a leaf: bfloat16 bit
    patterns (``uint16``) are decoded and rounded back after each step."""
    if arr.dtype == np.uint16:
        return bf16_bits_to_f32(arr), lambda x: bf16_bits_to_f32(f32_to_bf16_bits(x))
    return arr, lambda x: x


def _encoded(vals: np.ndarray, like: np.ndarray) -> np.ndarray:
    return f32_to_bf16_bits(vals) if like.dtype == np.uint16 else vals


def build_specs(
    root: str, cfg, base_flat: Dict[str, np.ndarray], *,
    n_functions: int = 4, seed: int = 0,
) -> List[FunctionSpec]:
    """Paper-style function variants over a family base (not yet registered)."""
    rng = np.random.default_rng(seed + 1)
    specs: List[FunctionSpec] = []
    kinds = ["adapter", "head", "finetune"]
    src_dir = os.path.join(root, "sources")
    os.makedirs(src_dir, exist_ok=True)
    for i in range(n_functions):
        kind = kinds[i % len(kinds)]
        variant = {k: np.array(v) for k, v in base_flat.items()}
        touched_rows: Dict[str, List[int]] = {}
        if kind == "adapter":
            rows = list(range(8 * i, 8 * i + 16))
            table = variant["embed/table"]
            vals, rnd = _values(table)
            vals = np.array(vals)
            dtype = np.float32 if table.dtype == np.uint16 else table.dtype
            noise = rnd(rng.standard_normal((len(rows), table.shape[1])).astype(dtype))
            vals[rows] = rnd(vals[rows] + rnd(noise * 0.02))
            variant["embed/table"] = _encoded(vals, table)
            touched_rows["embed/table"] = rows
            # one block's w_in as the "imported library"
            key = next(k for k in variant if k.endswith("ffn/w_in"))
            vals, rnd = _values(variant[key])
            variant[key] = _encoded(rnd(vals + 0.01), variant[key])
        elif kind == "head":
            vals, rnd = _values(variant["embed/table"])
            variant["embed/table"] = _encoded(rnd(vals * 1.01), variant["embed/table"])
        else:  # finetune
            for k in variant:
                if "/wq" in k or "/w_in" in k or "/w_out" in k:
                    vals, rnd = _values(variant[k])
                    variant[k] = _encoded(rnd(vals + 0.005), variant[k])
        src = os.path.join(src_dir, f"fn{i}.npz")
        np.savez(src, **{k: v for k, v in variant.items()
                         if not np.array_equal(v, base_flat[k])})
        specs.append(FunctionSpec(
            name=f"fn{i}-{kind}", family=cfg.name, variant=variant,
            touched=None, touched_rows=touched_rows, source_path=src,
        ))
    return specs


def build_delta_specs(
    root: str, cfg, base_flat: Dict[str, np.ndarray], *,
    n_functions: int = 3, seed: int = 0,
) -> List[FunctionSpec]:
    """The paper's three kinds as shared-base uploads (``FunctionSpec.delta``
    holds only the leaves that differ).  Where the blocks have an FFN, the
    leaves ``build_specs`` changes, changed as it changes them:

    * adapter: 16 embedding rows, plus the first ``ffn/w_in`` leaf + 0.01;
    * head: ``embed/table`` × 1.01 (also where the head is untied);
    * fine-tune: every ``/wq``, ``/w_in`` and ``/w_out`` + 0.005.

    A family without an FFN (mamba2) takes the first layer of ``w_xBC`` +
    0.01 for the adapter, and every ``/w_out`` and ``/w_z`` + 0.005 for the
    fine-tune.  Deltas keep the host from holding a full copy of the
    weights for every function.
    """
    rng = np.random.default_rng(seed + 1)
    specs: List[FunctionSpec] = []
    kinds = ["adapter", "head", "finetune"]
    src_dir = os.path.join(root, "sources")
    os.makedirs(src_dir, exist_ok=True)
    ffn_w_in = next((k for k in base_flat if k.endswith("ffn/w_in")), None)

    def shifted(k: str, by: float) -> np.ndarray:
        vals, rnd = _values(base_flat[k])
        return _encoded(rnd(vals + by), base_flat[k])

    for i in range(n_functions):
        kind = kinds[i % len(kinds)]
        delta: Dict[str, np.ndarray] = {}
        touched_rows: Dict[str, List[int]] = {}
        table = base_flat["embed/table"]
        if kind == "adapter":
            rows = list(range(8 * i, 8 * i + 16))
            vals, rnd = _values(table)
            vals = np.array(vals)
            noise = rnd(rng.standard_normal((len(rows), table.shape[1])).astype(np.float32))
            vals[rows] = rnd(vals[rows] + rnd(noise * 0.02))
            delta["embed/table"] = _encoded(vals, table)
            touched_rows["embed/table"] = rows
            if ffn_w_in is not None:
                delta[ffn_w_in] = shifted(ffn_w_in, 0.01)
            else:
                key = next(k for k in base_flat if k.endswith("/w_xBC"))
                vals, rnd = _values(base_flat[key])
                vals = np.array(vals)
                vals[0] = rnd(vals[0] + 0.01)  # one layer of the stacked leaf
                delta[key] = _encoded(vals, base_flat[key])
        elif kind == "head":
            vals, rnd = _values(table)
            delta["embed/table"] = _encoded(rnd(vals * 1.01), table)
        elif ffn_w_in is not None:  # finetune
            for k in base_flat:
                if "/wq" in k or "/w_in" in k or "/w_out" in k:
                    delta[k] = shifted(k, 0.005)
        else:
            for k in base_flat:
                if k.endswith("/w_out") or k.endswith("/w_z"):
                    delta[k] = shifted(k, 0.005)
        src = os.path.join(src_dir, f"fn{i}.npz")
        np.savez(src, **delta)
        specs.append(FunctionSpec(
            name=f"fn{i}-{kind}", family=cfg.name, delta=delta,
            touched_rows=touched_rows, source_path=src,
        ))
    return specs


def build_functions(
    root: str, cfg, model: Model, *, n_functions: int = 4, seed: int = 0,
    device: DeviceLike = None, base_params: Optional[PyTree] = None,
) -> Tuple[Worker, List[FunctionSpec]]:
    """Single-worker suite on ``device``.  ``base_params`` (e.g. weights
    carried from the JAX package) replaces ``model.init(seed)``."""
    worker = Worker(os.path.join(root, "worker"), device=device)
    if base_params is None:
        base_params = model.init(seed, device=worker.device)
    worker.register_runtime(cfg.name, model, base_params)
    base_flat = params_to_flat(base_params)
    specs = build_specs(root, cfg, base_flat, n_functions=n_functions, seed=seed)
    for spec in specs:
        worker.register_function(spec)
    return worker, specs


def build_cluster(
    root: str, cfg, model: Model, *, n_workers: int = 2, n_functions: int = 4,
    seed: int = 0, device: DeviceLike = None,
    base_params: Optional[PyTree] = None, **cluster_kw,
) -> Tuple[Cluster, List[FunctionSpec]]:
    """Multi-worker suite on ``device``: runtime broadcast to every worker,
    functions sharded by stable hash."""
    cluster = Cluster(os.path.join(root, "cluster"), n_workers=n_workers,
                      device=device, **cluster_kw)
    if base_params is None:
        base_params = model.init(seed, device=cluster.workers[0].device)
    cluster.register_runtime(cfg.name, model, base_params)
    base_flat = params_to_flat(base_params)
    specs = build_specs(root, cfg, base_flat, n_functions=n_functions, seed=seed)
    for spec in specs:
        cluster.register_function(spec)
    return cluster, specs


def request_tokens(spec: FunctionSpec, rng: np.random.Generator, vocab: int,
                   batch: int = 1, seq: int = 32) -> np.ndarray:
    rows = spec.touched_rows.get("embed/table")
    if rows:
        return rng.choice(np.asarray(rows), size=(batch, seq)).astype(np.int32)
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)


def zipf_schedule(
    n_requests: int, n_functions: int, *, alpha: float = 1.1, seed: int = 0,
) -> np.ndarray:
    """Function indices for a skewed trace: P(i) ∝ (i+1)^-alpha."""
    w = (np.arange(1, n_functions + 1, dtype=np.float64)) ** -alpha
    w /= w.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(n_functions, size=n_requests, p=w)


def make_requests(
    specs: Sequence[FunctionSpec], schedule: Sequence[int], vocab: int, *,
    strategy: "Strategy | str" = Strategy.SNAPFAAS, cold_fraction: float = 0.0,
    seed: int = 0, seq: int = 32,
) -> Iterator[InvocationRequest]:
    """Turn a schedule (sequence of function indices) into typed requests."""
    rng = np.random.default_rng(seed)
    strategy = Strategy.coerce(strategy)
    for idx in schedule:
        spec = specs[idx]
        yield InvocationRequest(
            function=spec.name,
            tokens=request_tokens(spec, rng, vocab, seq=seq),
            options=ColdStartOptions(
                strategy=strategy,
                force_cold=bool(rng.random() < cold_fraction),
            ),
        )


def replay_trace(
    worker: Worker, specs: List[FunctionSpec], *, n_requests: int,
    cold_fraction: float, strategy: "Strategy | str", seed: int = 0,
) -> List[InvocationResult]:
    """Round-robin trace on a single worker (synchronous)."""
    schedule = [i % len(specs) for i in range(n_requests)]
    vocab = worker.models[specs[0].family].cfg.vocab_size
    return [worker.invoke(req) for req in make_requests(
        specs, schedule, vocab, strategy=strategy,
        cold_fraction=cold_fraction, seed=seed,
    )]


def replay_cluster_trace(
    cluster: Cluster, specs: List[FunctionSpec], *, n_requests: int,
    cold_fraction: float, strategy: "Strategy | str", seed: int = 0,
    alpha: Optional[float] = None, max_inflight: Optional[int] = None,
) -> List[InvocationResult]:
    """Concurrent trace through the cluster scheduler; ``alpha`` switches
    from round-robin to Zipf-skewed popularity."""
    if alpha is None:
        schedule = [i % len(specs) for i in range(n_requests)]
    else:
        schedule = zipf_schedule(n_requests, len(specs), alpha=alpha, seed=seed)
    vocab = cluster.workers[0].models[specs[0].family].cfg.vocab_size
    return cluster.replay(
        make_requests(specs, schedule, vocab, strategy=strategy,
                      cold_fraction=cold_fraction, seed=seed),
        max_inflight=max_inflight,
    )


def summarize(strategy: "Strategy | str", results: List[InvocationResult]) -> Dict:
    cold = [r for r in results if r.cold]
    warm = [r for r in results if not r.cold]
    ms = lambda xs: round(float(np.mean(xs)) * 1e3, 3) if xs else None  # noqa: E731
    out = {
        "strategy": str(Strategy.coerce(strategy)),
        "n_cold": len(cold), "n_warm": len(warm),
        "cold_boot_ms": ms([r.boot_s for r in cold]),
        "cold_exec_ms": ms([r.exec_s for r in cold]),
        "cold_e2e_ms": ms([r.latency_s for r in cold]),
        "warm_e2e_ms": ms([r.latency_s for r in warm]),
    }
    resolved = sorted({str(r.strategy) for r in cold})
    if resolved and resolved != [out["strategy"]]:
        out["resolved"] = resolved
    unpooled = sum(1 for r in results if not r.pooled)
    if unpooled:
        out["unpooled"] = unpooled
    mets = [r.metrics for r in cold if r.metrics is not None]
    if mets:
        out.update(
            A_ms=ms([m.t_preconfig for m in mets]),
            B_ms=ms([m.t_eager for m in mets]),
            C_ms=ms([m.t_init for m in mets]),
            D_ms=ms([m.d_overhead for m in mets]),
            eager_mb=round(float(np.mean([m.eager_bytes for m in mets])) / 2**20, 2),
        )
    return out
