"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 coldbench/run.py --workload stablelm-3b.warm-docs --seed 7 \\
        --seconds 51 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; its last key, ``checks``, and the last lines of standard
error give each number compared beside its limit.  The run exits non-zero
and prints no result without enough CUDA devices, or if JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build")
# kernel and build caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, "coldbench", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, HERE)

#: top-level module names that must not be loaded in the process that prints
BANNED = ("jax", "jaxlib", "flax", "repro")


def loaded_banned():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    import spec

    man = spec.manifest(ROOT)
    entry = spec.cell_entry(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"coldbench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    import harness

    e2e = [m["name"] for m in spec.metrics_for(man, args.workload, "end_to_end")]
    layer = [m["name"] for m in spec.metrics_for(man, args.workload, "per_layer")]
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, per_layer=layer if args.trace else ())
    bad = loaded_banned()
    if bad:
        print(f"coldbench: modules loaded that the run must not load: {bad}", file=sys.stderr)
        return 4
    if args.trace:
        metrics = {m["name"]: {"value": out["per_layer"][m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_for(man, args.workload, "per_layer")
                   if m["name"] in out["per_layer"]}
    else:
        metrics = {n: {"value": out["e2e"][n][0], "unit": out["e2e"][n][1]} for n in e2e}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(f"coldbench: {out['n_cold']} cold of {out['attempted']} attempted; "
          f"power limit {power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
