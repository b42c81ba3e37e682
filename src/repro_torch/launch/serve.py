"""End-to-end serving entry point of the port: cold-start strategies under a
request trace, scheduled across a multi-worker cluster, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --family gemma-2b \
        --functions 6 --requests 40 --cold-fraction 0.5 \
        --strategies auto --workers 4 --device cuda

The CLI of ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain kernel versions on the host).  It boots a
:class:`~repro_torch.serving.cluster.Cluster` on that device, registers
function variants of the family's reduced config, replays a trace for
every strategy (or, with ``--trace``, a seeded arrival trace through the
admission layer) and prints the boot/exec/e2e comparison and fleet metrics.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import List, Optional

import torch

from ..configs import get_config, reduced
from ..device import resolve_device
from ..models import build_model
from ..serving import (
    AdmissionConfig,
    AutoscaleConfig,
    StealConfig,
    Strategy,
    TRACE_PATTERNS,
    build_cluster,
    make_policy,
    make_trace,
    replay_cluster_trace,
    summarize,
)
from ..serving.policy import POLICIES
from ..serving.scheduler import PLACEMENTS


def _parse_autoscale(value: str) -> AutoscaleConfig:
    """``MIN:MAX`` → :class:`AutoscaleConfig` (argparse type hook)."""
    try:
        lo, hi = value.split(":")
        return AutoscaleConfig(min_workers=int(lo), max_workers=int(hi))
    except (ValueError, TypeError):
        raise argparse.ArgumentTypeError(
            f"expected MIN:MAX (e.g. 1:4), got {value!r}"
        ) from None


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="gemma-2b")
    ap.add_argument("--functions", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--cold-fraction", type=float, default=0.5)
    ap.add_argument("--strategies", nargs="*", default=None,
                    choices=[s.value for s in Strategy],
                    help="strategies to compare (default: all); in --trace "
                         "mode the first (or snapfaas) drives the replay")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--policy", default="lru", choices=sorted(POLICIES))
    ap.add_argument("--zipf-alpha", type=float, default=None,
                    help="skew the trace (Zipf exponent); default round-robin")
    ap.add_argument("--trace", default=None, choices=sorted(TRACE_PATTERNS),
                    help="trace-driven mode: arrival pattern to generate "
                         "and replay through the admission layer")
    ap.add_argument("--rps", type=float, default=200.0,
                    help="mean arrival rate of the generated trace")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="trace window (s)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--queue-depth", type=int, default=32,
                    help="per-worker admission queue bound")
    ap.add_argument("--concurrency", type=int, default=2,
                    help="per-worker execution concurrency cap")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="arrival-time multiplier (0 = replay as fast "
                         "as possible)")
    ap.add_argument("--placement", default="static",
                    choices=sorted(PLACEMENTS),
                    help="function→worker placement policy")
    ap.add_argument("--steal", action="store_true",
                    help="enable work stealing between admission lanes")
    ap.add_argument("--autoscale", type=_parse_autoscale, default=None,
                    metavar="MIN:MAX",
                    help="trace mode: autoscale the worker fleet between "
                         "MIN and MAX during the replay (starts at MIN)")
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the workers serve on (cpu: plain kernel "
                         "versions, for testing)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 matmuls in full float32 (reference numerics), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = args.root or tempfile.mkdtemp(prefix="repro_torch_serve_")
    cfg = reduced(get_config(args.family))
    model = build_model(cfg)

    n_workers = args.workers
    if args.autoscale is not None and args.trace is not None:
        n_workers = args.autoscale.min_workers
    cluster, fns = build_cluster(
        root, cfg, model, n_workers=n_workers, n_functions=args.functions,
        device=device,
        policy_factory=lambda: make_policy(args.policy),
        placement=args.placement,
        steal=StealConfig() if args.steal else None,
    )
    print(json.dumps({"device": str(device),
                      "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                                     "cudnn": torch.backends.cudnn.allow_tf32}}))
    if args.trace is not None:
        with cluster:
            trace = make_trace(
                args.trace, rps=args.rps, duration_s=args.duration,
                n_functions=len(fns), seed=args.seed,
                zipf_alpha=(1.1 if args.zipf_alpha is None
                            else args.zipf_alpha),
            )
            report = cluster.replay_trace(
                trace, fns,
                strategy=(args.strategies[0] if args.strategies else
                          Strategy.SNAPFAAS),
                admission=AdmissionConfig(
                    queue_depth=args.queue_depth,
                    worker_concurrency=args.concurrency,
                ),
                autoscale=args.autoscale,
                time_scale=args.time_scale,
            )
            fleet = cluster.metrics()
        print(json.dumps({"trace_serving": report.summary()}, indent=1))
        print(json.dumps({"scheduler": fleet["scheduler"]}, indent=1))
        print(json.dumps({"serving": fleet["serving"]}, indent=1))
        return

    strategies = args.strategies or ["regular", "reap", "seuss", "snapfaas-",
                                     "snapfaas", "auto"]
    rows = []
    with cluster:
        for strat in strategies:
            results = replay_cluster_trace(
                cluster, fns, n_requests=args.requests,
                cold_fraction=args.cold_fraction, strategy=strat, seed=1,
                alpha=args.zipf_alpha,
            )
            rows.append(summarize(strat, results))
        fleet = cluster.metrics()
    print(json.dumps(rows, indent=1))
    print(json.dumps({"fleet": fleet}, indent=1))
    base = {r["strategy"]: r for r in rows}
    for other in ("reap", "seuss"):
        if "snapfaas" in base and other in base:
            sp = base[other]["cold_e2e_ms"] / max(base["snapfaas"]["cold_e2e_ms"], 1e-9)
            print(f"snapfaas speedup over {other} (cold e2e): {sp:.2f}x")
    if "auto" in base and base["auto"].get("resolved"):
        print(f"auto resolved to: {base['auto']['resolved']}")


if __name__ == "__main__":
    main()
