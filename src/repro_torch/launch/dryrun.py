"""Multi-pod dry run: port of ``repro.launch.dryrun``.  Every (arch × shape)
cell is traced once on the meta device against the production meshes, and
its memory, cost, collective and roofline terms are reckoned against H100
constants.

The port has no SPMD partitioner: the cell's global step runs once on meta
under ``opcost.CostMode`` (every aten op and every kernel booking counted),
and the per-device terms come from the specs:

* FLOPs and bytes: the global counts divided by the device count (how
  JAX's own per-device count relates to its 1×1 count);
* argument, output and alias bytes: exactly each leaf's local shard
  (``local_slices`` at the mesh's first coordinate; the rules only shard
  dims that divide), arguments only where the step reads them, as jit
  drops the others;
* temp bytes: the peak of what the traced step allocated, split evenly
  over the devices.  An estimate: no partitioner or scheduler decides
  what lives where;
* collectives: ``collectives.step_collectives``, the stated model of what
  the sharded step sends.

Nothing is allocated on any device: parameters, optimizer state, batches
and caches are meta tensors.  It is the one entry point of the port that
runs on neither the card nor the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod|--both-meshes]

Artifacts: <out>/<arch>__<shape>__<mesh>.json (``artifacts/dryrun`` by
default) with the keys of the JAX package's, ``t_lower_s``,
``t_compile_s`` and ``hlo_bytes`` replaced by ``t_trace_s``, and the
port's own ``opcost`` (global counts, kernel calls, collectives by rule).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Iterator, Optional, Tuple

import torch

from .. import opcost
from .. import roofline as rl
from ..configs import ARCHS, get_config
from ..distrib.sharding import PartitionSpec, axis_names, local_slices
from ..models.blocks import build_plan
from ..models.config import SHAPES, cells_for
from . import collectives
from .mesh import make_production_mesh
from .specs import Cell, build_cell


def _pairs(tree: Any, specs: Any) -> Iterator[Tuple[torch.Tensor, PartitionSpec]]:
    """(tensor, spec) of every tensor leaf of ``tree``, whose structure the
    spec tree follows (a spec may stand for a subtree that it covers whole:
    a scalar metric's ``P()``)."""
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, torch.Tensor):
            yield tree, specs
        return
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, (tuple, list)):
        for t, s in zip(tree, specs):
            yield from _pairs(t, s)


def _local_bytes(mesh, tree: Any, specs: Any, read: Optional[set] = None) -> int:
    """The bytes of each tensor's shard at the mesh's first coordinate
    (only those in ``read``, by id, where given)."""
    origin = (0,) * len(axis_names(mesh))
    total = 0
    for t, spec in _pairs(tree, specs):
        if read is None or id(t) in read:
            sl = local_slices(mesh, spec, t.shape, origin)
            total += math.prod(s.stop - s.start for s in sl) * t.element_size()
    return total


def reads_position(cfg) -> bool:
    """Whether a decode step reads its position: attention does (cache
    slot, RoPE, mask) and whisper's positions table; an SSM recurrence
    does not.  The port reads it on the host, as an int, so no op shows
    the read."""
    return cfg.is_encoder_decoder or any(k.mixer == "attn" for k in build_plan(cfg).kinds)


def memory_report(cell: Cell, outputs: Any, read: set, peak_live_bytes: int,
                  n_devices: int) -> dict:
    """XLA's ``memory_analysis`` keys, per device, from the specs.  As jit
    drops the arguments a step does not use, an argument counts where the
    step reads it: some op took it as an input (``read``, by id), or it is
    the decode position of a model that reads it."""
    mesh = cell.rules.mesh
    read = set(read)
    if cell.shape.kind == "decode" and reads_position(cell.cfg):
        read.add(id(cell.args[3]))
    arg = _local_bytes(mesh, cell.args, cell.in_specs, read)
    out = _local_bytes(mesh, outputs, cell.out_specs)
    alias = sum(_local_bytes(mesh, cell.args[i], cell.in_specs[i], read)
                for i in cell.donate_argnums)
    mem = {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": out,
        "temp_size_in_bytes": peak_live_bytes // n_devices,
        "alias_size_in_bytes": alias,
        "host_argument_size_in_bytes": 0,
        "host_output_size_in_bytes": 0,
        "host_temp_size_in_bytes": 0,
    }
    mem["live_bytes_per_device"] = (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        - mem["alias_size_in_bytes"] + mem["temp_size_in_bytes"])
    return mem


def trace_cell(cell: Cell) -> Tuple[Any, opcost.CostTotals, set, list]:
    """One traced step: (its outputs, the global totals, the ids of the
    arguments it read, the collectives)."""
    outputs, totals, read = opcost.trace(cell.fn, *cell.args)
    return outputs, totals, read, collectives.step_collectives(cell)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             loss_chunk: int = 512, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, loss_chunk=loss_chunk)
    outputs, totals, read, colls = trace_cell(cell)
    t_trace = time.time() - t0

    n_dev = math.prod(mesh.axis_sizes)
    mem = memory_report(cell, outputs, read, totals.peak_live_bytes, n_dev)
    per_dev = totals.per_device(n_dev, colls)
    terms = rl.analyze(
        arch=cfg.name, shape_name=shape_name, mesh_name=mesh_name,
        n_devices=n_dev, totals=per_dev, dtype=cfg.dtype, collectives=colls, cfg=cfg,
        shape=shape, memory_report=mem,
    )
    result = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "ok": True,
        "t_trace_s": round(t_trace, 2),
        "memory_analysis": mem,
        "cost_analysis": {"flops": per_dev.flops, "bytes accessed": per_dev.bytes},
        "roofline": rl.to_json(terms),
        "opcost": {
            "flops_global": totals.flops,
            "bytes_global": totals.bytes,
            "peak_live_bytes_global": totals.peak_live_bytes,
            "kernel_calls": totals.kernel_calls,
            "kernel_flops_global": totals.kernel_flops,
            "kernel_bytes_global": totals.kernel_bytes,
            "devices": totals.devices,
            "microbatches": cell.microbatches,
            "collectives": collectives.collective_summary(colls),
            "constants": {"peak_flops": rl.PEAK_FLOPS[cfg.dtype], "hbm_bw": rl.HBM_BW,
                          "axis_bw": {a: rl.AXIS_BW[a] for a in mesh.axis_names}},
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{cfg.name}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        gb = mem.get("live_bytes_per_device", 0) / 2**30
        print(
            f"[dryrun] {cfg.name:16s} {shape_name:12s} {mesh_name:10s} "
            f"trace={t_trace:6.1f}s live={gb:6.2f}GiB/dev "
            f"Tc={terms.t_compute*1e3:8.2f}ms Tm={terms.t_memory*1e3:8.2f}ms "
            f"Tx={terms.t_collective*1e3:8.2f}ms dom={terms.dominant} "
            f"useful={terms.useful_flops_ratio:5.2f}",
            flush=True,
        )
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (e.g. gemma2-27b)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--loss-chunk", type=int, default=512)
    args = ap.parse_args(argv)

    jobs = []
    archs = ARCHS if args.all or args.arch is None else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = cells_for(cfg) if args.all or args.shape is None else [args.shape]
        for s in shapes:
            if args.both_meshes:
                jobs.append((arch, s, False))
                jobs.append((arch, s, True))
            else:
                jobs.append((arch, s, args.multipod))

    failures = []
    for arch, s, mp in jobs:
        try:
            run_cell(arch, s, multi_pod=mp, out_dir=args.out,
                     loss_chunk=args.loss_chunk)
        except Exception as e:  # broad-ok: every failure is collected and re-raised as SystemExit
            failures.append((arch, s, mp, repr(e)))
            print(f"[dryrun] FAIL {arch} {s} multipod={mp}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print(f"[dryrun] all {len(jobs)} cells traced OK")


if __name__ == "__main__":
    main()
