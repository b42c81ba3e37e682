"""Replay CLI of the port: drive a seeded arrival trace through the
multi-worker cluster on the GPU, optionally under an injected fault
profile.

    PYTHONPATH=src python -m repro_torch.launch.replay --pattern poisson --rps 100
    PYTHONPATH=src python -m repro_torch.launch.replay --chaos remote-outage
    PYTHONPATH=src python -m repro_torch.launch.replay --chaos lossy-disk --chaos-seed 7 \\
        --device cpu

The flags of the top-level ``launch/serve.py`` replay CLI plus ``--device``
(default ``cuda``; ``cpu`` runs the plain kernel versions on the host).
``--chaos`` wires a named fault profile (``remote-outage``, ``lossy-disk``,
``flaky-worker``, ``standard``) into the storage tiers and the workers'
``before_invoke`` hook via a seeded :class:`~repro_torch.core.FaultInjector`;
the same (profile, seed) pair replays the same fault sequence.  Under a
profile every function is demoted to the remote tier first, so cold
restores take the faulted path, and the profile's clock is re-armed.  The
summary JSON reports the typed failure taxonomy (shed / timeout /
fault_recovered / fault_fatal), tier-health counters and the injected-fault
counts next to the latency percentiles.  The fleet, its flags and the
replay itself are ``launch.serve``'s (``add_fleet_flags``, ``start_fleet``,
``replay_seeded_trace``); this module adds the fault profile and its
document.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..configs import get_config, reduced
from ..core import CHAOS_PROFILES, FaultInjector, TierSpec, chaos_profile
from ..serving import TRACE_PATTERNS
from .serve import add_fleet_flags, replay_seeded_trace, start_fleet


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a seeded arrival trace through the cluster, "
                    "optionally under an injected fault profile"
    )
    ap.add_argument("--pattern", default="poisson", choices=TRACE_PATTERNS)
    ap.add_argument("--strategy", default="snapfaas")
    ap.add_argument("--chaos", default=None, choices=CHAOS_PROFILES,
                    metavar="PROFILE",
                    help=f"inject a named fault profile "
                         f"({', '.join(CHAOS_PROFILES)})")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-injector seed (same seed → same faults)")
    add_fleet_flags(ap, rps=100.0, seed=0)
    args = ap.parse_args(argv)

    injector = None
    if args.chaos is not None:
        injector = FaultInjector(chaos_profile(args.chaos, seed=args.chaos_seed))
    n_workers = args.workers
    if args.autoscale is not None:
        n_workers = args.autoscale.min_workers
    device, cluster, specs = start_fleet(
        args, reduced(get_config("gemma-2b")), n_workers=n_workers,
        prefix="repro_torch_replay_", seed=args.seed,
        tiers=TierSpec(ram_bytes=1 << 30, faults=injector))
    rep, metrics = replay_seeded_trace(cluster, specs, args, pattern=args.pattern,
                                       strategy=args.strategy, injector=injector)

    out = {
        "device": str(device),
        "summary": rep.summary(),
        "conservation_holds":
            rep.n_submitted == rep.n_completed + rep.n_shed + rep.n_failed,
        "tier_health": metrics["tiers"]["health"],
        "scheduler": metrics["scheduler"],
        "serving": {
            "failures": metrics["serving"]["failures"],
            "dead_workers": metrics["serving"]["dead_workers"],
            "n_worker_crashes": metrics["serving"]["n_worker_crashes"],
        },
    }
    if args.chaos is not None:
        out["chaos"] = {
            "profile": args.chaos,
            "seed": args.chaos_seed,
            "injected": metrics.get("chaos", {}),
        }
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
