"""Serving worker of the port: ``repro.serving.worker`` on PyTorch.

A *function* is a registered model variant of a runtime *family*.  A
request either hits a warm instance or cold-starts through the snapshot
engine (the verbatim core copy) under the configured strategy; execution
runs the family's forward on the restored parameters.  What differs from
the JAX worker:

* the base pool is copied to the worker's device once, at
  ``register_runtime``, and shared by every instance of the family; no
  kernel or layer writes into a pooled tensor;
* ``_maybe_device_patch`` hands the ``snapshot_patch`` kernel byte views of
  the pooled base and the packed diff rows, so the patch is dtype-agnostic
  and out of place; on a CUDA worker it always launches the CUDA kernel
  (no fallback), on a CPU worker it takes the plain version;
* bfloat16 leaves cross the registry as ``uint16`` bit patterns and are
  reinterpreted from the model template's dtype here (``convert``);
* the exec window ends in ``torch.cuda.synchronize`` so ``exec_s`` is the
  device's time, not the enqueue's;
* ``invoke`` marks each step of the request path with a span of the
  recorder (``obs``, off unless enabled) and counts the bytes it copies to
  the device and its device-wide waits.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..convert import params_to_flat, to_tensor
from ..core import AccessLog, ColdStartMetrics, RestoredInstance, ZygoteRegistry
from ..core.planner import PAPER_C220G5, StorageModel, predict_demand_paged
from ..core.restore import MaterializedArray
from ..core.tiers import PrefetchStats, TierSpec
from ..device import DeviceLike, resolve_device
from ..kernels.snapshot_patch import patch_apply_op
from ..models import Batch, Model
from .api import (
    ColdStartOptions,
    InvocationRequest,
    InvocationResult,
    NpzSourceResolver,
    SourceResolver,
    Strategy,
    select_strategy,
)
from .policy import InstancePool, PoolPolicy

PyTree = Any

#: bytes the request path copies from the host to a CUDA device: tokens,
#: leaves materialised on the host, the patch's diff rows and selectors
h2d_bytes = obs.LaunchCounter("worker.h2d_bytes")
#: the request path's device-wide waits on a CUDA device: the synchronise
#: that ends ``exec_s`` and the blocking copy of the output to the host
syncs = obs.LaunchCounter("worker.syncs")


def _to_device(arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``to_tensor``, counting the bytes that cross to a CUDA device."""
    t = to_tensor(arr, dtype, device)
    if t.device.type == "cuda":
        h2d_bytes.add(t.nbytes)
    return t


@dataclass
class FunctionSpec:
    """What the developer uploads: variant params (numpy, bfloat16 as
    ``uint16`` bits) + which leaves its requests touch + a resolver for its
    source artifacts.  ``delta`` uploads only the arrays that differ from
    the family base."""

    name: str
    family: str
    variant: Dict[str, np.ndarray] = field(default_factory=dict)
    touched: Optional[List[str]] = None     # leaves a request reads (None=all)
    touched_rows: Dict[str, List[int]] = field(default_factory=dict)
    source_path: str = ""
    resolver: Optional[SourceResolver] = None  # default: NpzSourceResolver
    delta: Optional[Dict[str, np.ndarray]] = None  # shared-base upload
    exec_sleep_s: float = 0.0  # emulated handler I/O wait (load benches)


#: alias kept from the JAX package's API
RequestResult = InvocationResult


def device_patch(base: torch.Tensor, rows2d: np.ndarray, sel: np.ndarray,
                 chunk_bytes: int) -> torch.Tensor:
    """base ⊕ diff on ``base``'s device: a new tensor shaped like ``base``.

    The pooled ``base`` is viewed as bytes, cut into ``chunk_bytes`` rows
    (the partial tail chunk padded with zeros, out of place), and every row
    ``i`` with ``sel[i] >= 0`` is replaced by diff row ``sel[i]``."""
    dev = base.device
    flat = base.reshape(-1).view(torch.uint8)
    total = flat.numel()
    n = sel.shape[0]
    if n * chunk_bytes != total:  # partial tail chunk: pad, slice after
        flat = torch.cat([flat, flat.new_zeros(n * chunk_bytes - total)])
    out = patch_apply_op(
        flat.reshape(n, chunk_bytes),
        _to_device(rows2d, torch.uint8, dev),
        _to_device(sel, torch.int32, dev),
        mode="replace",
    )
    return out.reshape(-1)[:total].view(base.dtype).reshape(base.shape)


class Worker:
    """One worker machine: zygote registry + instance pool + model families,
    serving on one device (the GPU unless ``device="cpu"``)."""

    def __init__(self, root: str, *, pool_budget_bytes: int = 1 << 30,
                 chunk_bytes: int = 64 * 1024,
                 pool_policy: Optional[PoolPolicy] = None,
                 storage: StorageModel = PAPER_C220G5,
                 worker_id: int = 0,
                 tiers: Optional[TierSpec] = None,
                 prefetch_on_register: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.registry = ZygoteRegistry(root, chunk_bytes=chunk_bytes,
                                       tiers=tiers)
        self.pool = InstancePool(pool_budget_bytes, policy=pool_policy)
        self.storage = storage
        self.worker_id = worker_id
        self.faults = tiers.faults if tiers is not None else None
        self.prefetch_on_register = prefetch_on_register
        self.models: Dict[str, Model] = {}
        self.specs: Dict[str, FunctionSpec] = {}
        self._fwd: Dict[str, callable] = {}
        # device copies of the base pools / on-disk base images, per family
        self._pool_dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._base_npz: Dict[str, str] = {}
        # Eq. 1 resolution cache for Strategy.AUTO
        self._auto: Dict[str, Any] = {}
        self._lock = threading.RLock()

    # -- bootstrap (cluster-manager replication step) -------------------------

    def register_runtime(self, family: str, model: Model, base_params: PyTree,
                         fwd=None) -> None:
        """``fwd`` shares one forward callable across a cluster's workers."""
        self.models[family] = model
        flat = params_to_flat(base_params)
        self.registry.register_runtime(family, flat)
        if fwd is None:
            fwd = lambda p, tokens: model.logits(p, Batch(tokens=tokens))  # noqa: E731
        self._fwd[family] = fwd
        # the base pool on the device, copied once: shared (CoW-clean)
        # leaves are served zero-copy to every instance of the family
        pool = self.registry.pools[family]
        template = _leaves(model.param_shapes())
        self._pool_dev[family] = {
            p: to_tensor(pool.get(p), template[p].dtype, self.device)
            for p in self.registry.bases[family].arrays
        }
        # on-disk base image: what `regular` boots from
        base_path = os.path.join(self.registry.root, f"base-{family}.npz")
        np.savez(base_path, **{k.replace("/", "|"): v for k, v in flat.items()})
        self._base_npz[family] = base_path

    # -- function registration --------------------------------------------------

    def register_function(self, spec: FunctionSpec) -> None:
        if spec.delta is not None:
            rec = self.registry.register_from_base(
                spec.name, spec.family, spec.delta,
                source_path=spec.source_path,
            )
        else:
            rec = self.registry.register_function(
                spec.name, spec.family, spec.variant,
                source_path=spec.source_path,
            )
        self.specs[spec.name] = spec
        if spec.resolver is None:
            spec.resolver = self._default_resolver(spec)
        if spec.touched is not None:
            touched = spec.touched
        elif spec.delta is not None:
            touched = set(self.registry.bases[spec.family].arrays) | set(spec.delta)
        else:
            touched = spec.variant
        log = AccessLog()
        for path in touched:
            log.touch(path)
        for path, rows in spec.touched_rows.items():
            log.touch_rows(path, rows)
        self.registry.generate_working_set(spec.name, log)
        # measure function-import compute once, from a cold page cache
        if spec.source_path and os.path.exists(spec.source_path):
            fd = os.open(spec.source_path, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            except (AttributeError, OSError):
                pass
            finally:
                os.close(fd)
        t0 = time.perf_counter()
        spec.resolver.load_source()
        rec.init_compute_s = time.perf_counter() - t0
        if self.prefetch_on_register:
            self.prefetch_function(spec.name)
        with self._lock:
            self._auto.pop(spec.name, None)
        self._auto_entry(spec.name)

    def prefetch_function(self, fn: str, category: str = "ws") -> PrefetchStats:
        return self.registry.prefetch_working_set(fn, category)

    def record_function(
        self, fn: str, tokens: np.ndarray, *, n_profiles: int = 1,
    ) -> InvocationResult:
        out: Optional[InvocationResult] = None
        for _ in range(max(1, n_profiles)):
            out = self.invoke(InvocationRequest(
                function=fn, tokens=np.asarray(tokens),
                options=ColdStartOptions(record=True, force_cold=True),
            ))
        assert out is not None
        return out

    def deregister_function(self, fn: str) -> int:
        self.pool.drop(fn)
        self.specs.pop(fn, None)
        with self._lock:
            self._auto.pop(fn, None)
        return self.registry.deregister_function(fn)

    def tier_stats(self) -> Dict[str, Any]:
        return self.registry.store.tier_stats()

    def _default_resolver(self, spec: FunctionSpec) -> NpzSourceResolver:
        pool = self.registry.pools[spec.family]
        base = self.registry.bases[spec.family]
        own = spec.delta if spec.delta is not None else spec.variant
        return NpzSourceResolver(
            source_path=spec.source_path,
            base_path=self._base_npz.get(spec.family, ""),
            source_fallback=lambda: {k: np.array(v) for k, v in own.items()},
            base_fallback=lambda: {p: np.array(pool.get(p))
                                   for p in base.arrays},
        )

    # -- planner glue (Strategy.AUTO) ----------------------------------------

    def _auto_entry(self, fn: str):
        rec = self.registry.functions[fn]
        epoch = self.registry.store.residency_epoch
        with self._lock:
            entry = self._auto.get(fn)
            if entry is None or entry[0] is not rec.ws or entry[3] != epoch:
                sizes = self.registry.sizes(fn)
                best, preds = select_strategy(sizes, self.storage)
                demand = False
                if sizes.has_recording and \
                        best.value in ("reap", "snapfaas", "snapfaas-"):
                    dp = predict_demand_paged(best.value, sizes, self.storage)
                    demand = dp.total < preds[best].total
                entry = (rec.ws, best, preds, epoch, demand)
                self._auto[fn] = entry
            return entry

    def resolve_strategy(self, fn: str, strategy: "Strategy | str") -> Strategy:
        s = Strategy.coerce(strategy)
        if s is not Strategy.AUTO:
            return s
        return self._auto_entry(fn)[1]

    def resolve_demand_paging(self, fn: str, opts: ColdStartOptions) -> bool:
        if opts.demand_paging is not None:
            return opts.demand_paging
        if Strategy.coerce(opts.strategy) is not Strategy.AUTO:
            return False
        return bool(self._auto_entry(fn)[4])

    def predicted_cost(self, fn: str, strategy: Strategy) -> float:
        _, best, preds, _, _ = self._auto_entry(fn)
        pred = preds.get(Strategy.coerce(strategy))
        return pred.total if pred is not None else preds[best].total

    # -- request path --------------------------------------------------------------

    def _maybe_device_patch(
        self, family: str, path: str, ma: MaterializedArray
    ) -> Optional[torch.Tensor]:
        """Apply this array's diff chunks to the device copy of its base
        with the ``snapshot_patch`` kernel: base chunks never cross the
        host, diff chunks cross it once.  Cached per instance; invalidated
        by host writes."""
        if ma.patch is None or ma.written:
            return None
        if ma._dev is not None:
            return ma._dev
        base_dev = self._pool_dev.get(family, {}).get(path)
        if base_dev is None:
            return None
        rows2d = ma.patch.rows_2d()
        if rows2d.shape[0] == 0:
            return None
        with obs.span("worker.patch"):
            out = device_patch(base_dev, rows2d, ma.patch.sel, ma.meta.chunk_bytes)
        ma._dev = out
        return out

    def _params_for(
        self, spec: FunctionSpec, inst: RestoredInstance,
        request_rows: Optional[Dict[str, np.ndarray]] = None,
        record_log: Optional[AccessLog] = None,
    ) -> PyTree:
        """Materialize exactly what this request touches (row-granular for
        gather leaves); device shortcuts mirror their touches into
        ``record_log`` (REAP record mode)."""
        template = self.models[spec.family].param_shapes()
        rows = dict(spec.touched_rows)
        for k, v in (request_rows or {}).items():
            rows[k] = np.union1d(np.asarray(rows.get(k, []), np.int64), v)

        pool_dev = self._pool_dev.get(spec.family, {})

        def rec(t, prefix):
            if isinstance(t, dict):
                return {k: rec(v, f"{prefix}{k}/") for k, v in t.items()}
            path = prefix[:-1]
            ma = inst.arrays[path]
            if ma.state == "shared" and not ma.written and path in pool_dev:
                if record_log is not None:
                    record_log.touch(path)
                return pool_dev[path]  # zero-copy CoW share
            dev = self._maybe_device_patch(spec.family, path, ma)
            if dev is not None:
                if record_log is not None:
                    if path in rows:
                        record_log.touch_rows(path, rows[path])
                    else:
                        record_log.touch(path)
                return dev  # base ⊕ diff fused on device
            if path in rows:
                arr = ma.ensure_rows(rows[path], inst.metrics)
            else:
                arr = inst.value(path)
            return _to_device(arr, t.dtype, self.device)

        return rec(template, "")

    def invoke(self, request: InvocationRequest) -> InvocationResult:
        """Typed request path: warm-pool lookup, cold start, execution, pool
        re-admission."""
        with obs.request("worker.invoke", function=request.function) as root:
            return self._invoke(request, root)

    def _invoke(self, request: InvocationRequest, root) -> InvocationResult:
        fn = request.function
        opts = request.options
        if self.faults is not None:
            self.faults.before_invoke(self.worker_id)
        spec = self.specs.get(fn)
        if spec is None:
            raise KeyError(
                f"function {fn!r} is not registered on worker "
                f"{self.worker_id} (never registered, or deregistered)"
            )
        strategy = self.resolve_strategy(fn, opts.strategy)
        demand_paged = self.resolve_demand_paging(fn, opts)
        if opts.prefetch:
            self.prefetch_function(fn, opts.prefetch_category)
        t0 = time.perf_counter()
        with obs.span("worker.lookup"):
            inst = None if opts.force_cold else self.pool.get(fn)
        cold = inst is None
        root.set(cold=cold)
        if cold:
            with obs.span("worker.restore"):
                self.pool.drop(fn)
                loaders = self._loaders(spec)
                inst = self.registry.cold_start(
                    fn, strategy.value,
                    residual_init=lambda ds: {**ds, "kv_ready": True},
                    engine=opts.engine,
                    promote=opts.promote,
                    demand_paged=demand_paged,
                    **loaders,
                )
        boot = time.perf_counter() - t0

        te = time.perf_counter()
        record_log = AccessLog() if opts.record else None
        if record_log is not None:
            inst.attach_access_log(record_log)
        req_rows = {}
        if "embed/table" in spec.touched_rows or "embed/table" in spec.variant \
                or (spec.delta is not None and "embed/table" in spec.delta):
            req_rows["embed/table"] = np.unique(np.asarray(request.tokens))
        with obs.span("worker.params"):
            params = self._params_for(spec, inst, req_rows, record_log=record_log)
        with obs.span("worker.tokens"):
            tokens = _to_device(np.asarray(request.tokens, np.int32), torch.int32,
                                self.device)
        cuda = self.device.type == "cuda"
        with torch.no_grad(), obs.span("worker.forward"):
            logits = self._fwd[spec.family](params, tokens)
        with obs.span("worker.sync"):
            if cuda:
                torch.cuda.synchronize(self.device)
                syncs.add()
        if spec.exec_sleep_s > 0.0:
            time.sleep(spec.exec_sleep_s)  # emulated handler I/O wait
        exec_s = time.perf_counter() - te
        if inst.metrics is not None:
            inst.metrics.t_exec = exec_s
        if cold and inst.metrics is not None and inst.metrics.demand_paged:
            inst.finalize_demand_paging()
        if record_log is not None:
            inst.attach_access_log(None)
            self.registry.record_access(fn, record_log)
        # charge host buffers AND cached patched device copies (ma._dev) to
        # the pool budget: a warm patchable instance pins a device copy
        with obs.span("worker.pool_put"):
            nbytes = sum(
                a.meta.nbytes * (2 if a._dev is not None else 1)
                for a in inst.arrays.values()
            )
            pooled = self.pool.put(fn, inst, nbytes,
                                   cost=self.predicted_cost(fn, strategy))
        # the host copy waits for the stream, so it belongs in latency_s
        with obs.span("worker.output"):
            output = logits[:, -1, :8].float().cpu().numpy()
            if cuda:
                syncs.add()
        m: Optional[ColdStartMetrics] = inst.metrics if cold else None
        return InvocationResult(
            function=fn, cold=cold, requested=Strategy.coerce(opts.strategy),
            strategy=strategy,
            latency_s=time.perf_counter() - t0, boot_s=boot if cold else 0.0,
            exec_s=exec_s, pooled=pooled, worker_id=self.worker_id,
            metrics=m,
            output=output,
            fault_recovered=bool(
                m is not None and (m.read_retries or m.repaired_chunks)
            ),
        )

    def _loaders(self, spec: FunctionSpec):
        resolver = spec.resolver or self._default_resolver(spec)
        return {"source_loader": resolver.load_source,
                "base_loader": resolver.load_base}

    def source_files(self, fn: str) -> list:
        out = []
        spec = self.specs[fn]
        if spec.source_path:
            out.append(spec.source_path)
        p = self._base_npz.get(spec.family)
        if p:
            out.append(p)
        return out


def _leaves(tree: PyTree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
