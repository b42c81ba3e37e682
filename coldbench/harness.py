"""One run of a cell: set-up, the measured window, the check.

The system under test is ``repro_torch``'s serving stack: a ``Cluster``
from ``serving.build_cluster`` with the benchmark's base weights, the
cell's functions registered as deltas, and requests entering through the
cluster's admission front (``AdmissionController``, with the cell's
``worker_concurrency`` and ``queue_depth``), which runs each one through
``Cluster._run``: single-flight, the keep-alive pool, ``Worker.invoke``
(restore, device patch, forward, float32 head).

The check runs once the window has closed, the peak has been read and the
program's state is freed: the first request of every function, served by
a cold start in set-up, and a sample of the window's completed requests,
drawn from the seed with the longest cold and the longest warm one in it,
go through the plain reference on the same inputs, and the widest gap of
the served logits is held to the cell's limit.
"""

from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import Future, wait
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

import devtrace
import inputs
import spec
import traffic
from reference import logit_gap

#: a request that has not come back this long after the window's close is lost
DRAIN_S = 60.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Record:
    fn: int
    seq: int
    due: float                 # when it was due (open loop) or sent (closed)
    sent: float
    tok_seed: int
    done: Optional[float] = None
    ok: bool = False
    shed: bool = False
    error: Optional[str] = None
    cold: bool = False
    queue_s: float = 0.0
    boot_s: float = 0.0
    exec_s: float = 0.0
    output: Any = None


@dataclass
class Ctx:
    """What a per-layer metric's reader gets."""

    cell: str
    cfg: Dict[str, Any]
    wl: Dict[str, Any]
    seconds: float
    t0: float
    t_end: float
    records: List[Record]
    functions: List[Dict[str, Any]]     # name, kind, delta leaf bytes
    chunk_bytes: int
    peak_bytes: int                     # the allocator's peak over the window
    trace: Optional[devtrace.Summary]
    cfg_mod: Any                        # the configuration's module (``spec.load_model``)
    spans: Optional[Dict[str, Any]]     # ``obs.drain()`` where a reader sets SPANS


def pct(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of a non-empty sequence."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def _program():
    """The program's entry points (imported here so that a checkout
    without it fails before any result)."""
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import build_params
    from repro_torch.serving import (AdmissionConfig, AdmissionController, ColdStartOptions,
                                     FunctionSpec, InvocationRequest, ShedError, Strategy,
                                     build_cluster)
    return dict(Model=Model, ModelConfig=ModelConfig, build_params=build_params,
                AdmissionConfig=AdmissionConfig, AdmissionController=AdmissionController,
                ColdStartOptions=ColdStartOptions, FunctionSpec=FunctionSpec,
                InvocationRequest=InvocationRequest, ShedError=ShedError,
                Strategy=Strategy, build_cluster=build_cluster)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             per_layer: Sequence[str] = (), base: str = spec.HERE,
             metrics_base: Optional[str] = None,
             tamper: Optional[Callable[[Any, Dict[str, Any]], None]] = None) -> Dict[str, Any]:
    """Run ``cell`` once.  ``base`` holds the configurations and workloads;
    ``per_layer`` names the metrics read in a traced run, from
    ``metrics_base`` (``base`` unless given); ``tamper(cluster, cfg)``
    breaks the timed path (tests of the check).  A traced run turns the
    port's recorder on over the window where one of the readers sets
    ``SPANS``, and hands them what it drained as ``Ctx.spans``."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl = spec.load_workload(cell, base)
    cfgd = spec.load_config(wl["config"], base)
    cfg_mod = spec.load_model(wl["config"], base)
    readers = {name: spec.load_metric(name, metrics_base or base) for name in per_layer}
    P = _program()
    cfg = P["ModelConfig"](name=cfgd["name"], **spec.model_fields(cfgd))
    model = P["Model"](cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    batch = int(wl["batch"])

    def phase(what: str) -> None:
        log(f"coldbench: set-up {what} by {time.perf_counter() - t_start:.2f} s")

    phase("imports")

    # -- set-up: inputs from the seed ---------------------------------------
    base_tree = inputs.make_base(P["build_params"], cfg, seed, dev)
    base_flat = inputs.flatten(base_tree)
    funcs = inputs.make_functions(wl["functions"], base_flat, seed)
    if cuda:
        torch.cuda.synchronize(dev)
    phase("weights and deltas on the device")
    ref_base = {k: v.to("cpu", copy=True) for k, v in base_flat.items()}
    ref_delta = [{k: v.to("cpu", copy=True) for k, v in f.delta.items()} for f in funcs]
    uploads = [{k: inputs.to_upload(v) for k, v in f.delta.items()} for f in funcs]
    fn_info = [dict(name=f.name, kind=f.kind,
                    leaf_bytes=[v.numel() * v.element_size() for v in f.delta.values()])
               for f in funcs]
    rows = [f.rows for f in funcs]
    names = [f.name for f in funcs]
    del funcs, base_flat
    phase("inputs")

    # -- set-up: the program ---------------------------------------------------
    workdir = tempfile.mkdtemp(prefix="coldbench-")
    cluster = ctrl = None
    try:
        adm_cfg = P["AdmissionConfig"](queue_depth=int(wl["queue_depth"]),
                                       worker_concurrency=int(wl["worker_concurrency"]))
        cluster, _ = P["build_cluster"](
            workdir, cfg, model, n_workers=int(wl["n_workers"]), n_functions=0,
            device=device, base_params=base_tree,
            pool_budget_bytes=int(wl["pool_budget_bytes"]), admission=adm_cfg)
        del base_tree
        phase("runtime registered")
        for name, up, r in zip(names, uploads, rows):
            cluster.register_function(P["FunctionSpec"](
                name=name, family=cfg.name, delta=up,
                touched_rows={"embed/table": list(r)} if r else {}))
        del uploads
        phase("functions registered")
        chunk_bytes = cluster.workers[0].registry.chunk_bytes
        opts = P["ColdStartOptions"](strategy=P["Strategy"].coerce(wl["strategy"]))

        def request(fn: int, seq: int, tok_seed: int):
            return P["InvocationRequest"](
                function=names[fn], options=opts,
                tokens=traffic.tokens(cfg.vocab_size, batch, seq, tok_seed, rows[fn]))

        ctrl = P["AdmissionController"](cluster, adm_cfg)
        first = _warm_up(ctrl, request, wl, seed)
        phase("warm-up")
        if tamper is not None:
            tamper(cluster, cfgd)
        if wl["loop"] == "open":
            schedule = traffic.open_schedule(wl, seconds, seed)
            reqs = [request(a.fn, a.seq, a.tok_seed) for a in schedule]
        if cuda:
            torch.cuda.synchronize(dev)
        gc.collect()
        gc.freeze()  # what set-up made is never scanned again in the window
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start

        # -- the measured window -------------------------------------------
        tracer = None
        if trace:
            if any(getattr(m, "SPANS", False) for m in readers.values()):
                import hostspans  # it imports this module
                tracer = hostspans.SpanTrace(cuda)
            else:
                tracer = devtrace.DeviceTrace(cuda)
        if tracer is not None:
            devtrace.wrap_invoke(cluster.workers[0], tracer.spans)
            t0 = tracer.start()
        else:
            t0 = time.perf_counter()
        t_end = t0 + seconds
        if wl["loop"] == "open":
            recs, futs, late = _open_loop(ctrl, schedule, reqs, t0)
            log(f"coldbench: generator lateness max {max(late) * 1e3:.3f} ms, "
                f"p95 {pct(late, 95) * 1e3:.3f} ms over {len(late)} arrivals")
        else:
            recs, futs = _closed_loop(ctrl, request, wl, seed, t0, t_end)
        wait(futs, timeout=max(0.0, t_end + DRAIN_S - time.perf_counter()))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if tracer is not None:
            tracer.stop()
        gc.unfreeze()
        ctrl.shutdown()
        _collect(recs, futs, P["ShedError"])
        summary = tracer.summary() if tracer is not None else None
        spans = getattr(tracer, "recorded", None)
        del tracer

        # -- end-to-end and per-layer metrics ----------------------------------
        e2e = {**end_to_end(recs, seconds, t_end), "setup_s": (setup_s, "s")}
        ctx = Ctx(cell=cell, cfg=cfgd, wl=wl, seconds=seconds, t0=t0, t_end=t_end,
                  records=recs, functions=fn_info, chunk_bytes=chunk_bytes,
                  peak_bytes=peak, trace=summary, cfg_mod=cfg_mod, spans=spans)
        layer = {}
        for name, reader in readers.items():
            v = reader.read(ctx)
            if v is not None:
                layer[name] = v
    finally:
        gc.unfreeze()
        if ctrl is not None:
            ctrl.shutdown()
        if cluster is not None:
            cluster.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)

    # -- the check, with the program's state freed ------------------------------
    del cluster, ctrl, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    window = sample(recs, int(wl["check"]["sample"]), seed)
    picked = first + window if window else []  # a window that served nothing fails
    checks = _check(cfg_mod.Reference(cfgd), wl, recs, picked, ref_base, ref_delta,
                    request, dev)
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(recs), "failed": sum(1 for r in recs if not r.ok),
           "e2e": e2e, "per_layer": layer, "peak_bytes": peak, "checks": checks,
           "n_cold": sum(1 for r in recs if r.ok and r.cold),
           "compared": {"cold": sum(r.cold for r in picked),
                        "warm": sum(not r.cold for r in picked)}}
    if summary is not None:
        out.update(busy_s=summary.busy_s, window_s=summary.window_s,
                   breakdown={"device_ops": summary.device_ops,
                              "idle_gaps": summary.idle_gaps})
    return out


def end_to_end(recs: Sequence[Record], seconds: float, t_end: float) -> Dict[str, tuple]:
    """Invocations completed in the window per second, and the 95th
    percentile latency of every request of the window (from when it was
    due), a failed or lost request counted as taking until the drain
    deadline."""
    done_in = [r for r in recs if r.ok and r.done <= t_end]
    lat = [(r.done - r.due) if r.ok else (t_end + DRAIN_S - r.due) for r in recs]
    return {"inv_per_s": (len(done_in) / seconds, "inv/s"),
            "e2e_p95_ms": (pct(lat, 95) * 1e3 if lat else math.inf, "ms")}


def _warm_up(ctrl, request, wl, seed) -> List[Record]:
    """Every function's cold start (restore and patch shapes), least
    popular first, so that the window starts from the same pool for every
    seed; then every length on every drain thread, on the function last
    started, which the pool holds.  Returns the cold starts' records,
    which the check compares."""
    n_fn, lens = len(wl["functions"]), list(wl["seq_lens"])
    tag = iter(range(10**6))
    tok = lambda: int(inputs.torch_seed(seed, 7, next(tag)) >> 2)  # noqa: E731
    first = []
    for fn in reversed(range(n_fn)):
        seq, t = lens[fn % len(lens)], tok()
        res = ctrl.submit(request(fn, seq, t)).result()
        first.append(Record(fn=fn, seq=seq, due=0.0, sent=0.0, tok_seed=t, ok=True,
                            cold=res.cold, output=res.output))
    for rnd in range(2):
        futs = [ctrl.submit(request(0, lens[(i + rnd) % len(lens)], tok()))
                for i in range(int(wl["worker_concurrency"]) * len(lens))]
        for f in futs:
            f.result()
    return first


def _open_loop(ctrl, schedule, reqs, t0):
    recs, futs, late = [], [], []
    for a, req in zip(schedule, reqs):
        due = t0 + a.t
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sent = time.perf_counter()
        late.append(sent - due)
        rec = Record(fn=a.fn, seq=a.seq, due=due, sent=sent, tok_seed=a.tok_seed)
        with record_function("coldbench.submit"):
            fut = ctrl.submit(req)
        fut.add_done_callback(lambda f, rec=rec: setattr(rec, "done", time.perf_counter()))
        recs.append(rec)
        futs.append(fut)
    return recs, futs, late


def _closed_loop(ctrl, request, wl, seed, t0, t_end):
    stream = traffic.closed_stream(wl, seed)
    lock = threading.Lock()
    recs: List[Record] = []
    futs: List[Future] = []

    def client():
        while True:
            with lock:
                if time.perf_counter() >= t_end:
                    return
                a = next(stream)
            req = request(a.fn, a.seq, a.tok_seed)
            sent = time.perf_counter()
            if sent >= t_end:
                return
            rec = Record(fn=a.fn, seq=a.seq, due=sent, sent=sent, tok_seed=a.tok_seed)
            with record_function("coldbench.submit"):
                fut = ctrl.submit(req)
            fut.add_done_callback(lambda f, rec=rec: setattr(rec, "done", time.perf_counter()))
            with lock:
                recs.append(rec)
                futs.append(fut)
            try:
                fut.result(timeout=max(0.0, t_end + DRAIN_S - time.perf_counter()))
            except Exception:  # broad-ok: the outcome is read from the future later
                pass

    threads = [threading.Thread(target=client, name=f"coldbench-client{i}", daemon=True)
               for i in range(int(wl["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(1.0, t_end + DRAIN_S - time.perf_counter()))
    return recs, futs


def _collect(recs: List[Record], futs: List[Future], shed_error) -> None:
    for rec, fut in zip(recs, futs):
        if not fut.done():
            rec.error = "no answer by the drain deadline"
            continue
        exc = fut.exception()
        if exc is not None:
            rec.shed = isinstance(exc, shed_error)
            rec.error = f"{type(exc).__name__}: {exc}"
            continue
        res = fut.result()
        rec.ok = True
        rec.cold, rec.queue_s = res.cold, res.queue_s
        rec.boot_s, rec.exec_s = res.boot_s, res.exec_s
        rec.output = res.output


def sample(recs: List[Record], n: int, seed: int) -> List[Record]:
    """``n`` completed requests drawn from the seed: a longest cold one and
    a longest warm one first (where there are such), then the rest."""
    ok = [r for r in recs if r.ok]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    picked: List[Record] = []
    for cold in (True, False):
        group = [r for r in ok if r.cold == cold]
        if group:
            top = max(r.seq for r in group)
            longest = [r for r in group if r.seq == top]
            picked.append(longest[int(rng.integers(len(longest)))])
    rest = [r for r in ok if all(r is not p for p in picked)]
    for i in rng.permutation(len(rest))[: max(0, n - len(picked))]:
        picked.append(rest[int(i)])
    return picked


def variant_weights(ref_base, delta, dev) -> Dict[str, torch.Tensor]:
    return {k: (delta[k] if k in delta else v).to(dev) for k, v in ref_base.items()}


def _check(ref, wl, recs, picked, ref_base, ref_delta, request, dev) -> Dict[str, Dict]:
    """The numbers compared, each with its limit: the widest logit gap of
    the ``picked`` outputs against the configuration's reference ``ref``,
    and the window's requests whose answer never came or came as an error
    (shed ones are counted as failed, not as wrong)."""
    lost = sum(1 for r in recs if not r.ok and not r.shed)
    checks = {"lost": {"value": float(lost), "limit": 0.0}}
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gap, weights, cur = 0.0, None, None
    try:
        with record_function("coldbench.reference"):
            for r in sorted(picked, key=lambda r: r.fn):
                if cur != r.fn:
                    weights = None
                    weights = variant_weights(ref_base, ref_delta[r.fn], dev)
                    cur = r.fn
                toks = torch.from_numpy(request(r.fn, r.seq, r.tok_seed).tokens).to(dev)
                g = logit_gap(r.output, ref.last_logits(weights, toks))
                log(f"coldbench: compared {wl['functions'][r.fn]} fn{r.fn} seq {r.seq} "
                    f"tok {r.tok_seed} {'cold' if r.cold else 'warm'} logit gap {g!r}")
                gap = max(gap, g)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    checks["logit_err"] = {"value": gap if picked else math.inf,
                           "limit": float(wl["check"]["logit_err"])}
    log(f"coldbench: {len(picked)} outputs compared with the reference, "
        f"{sum(r.cold for r in picked)} of them cold")
    return checks
