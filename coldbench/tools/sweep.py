"""Offer a cell's traffic at several open-loop rates, one process each.

    python3 coldbench/tools/sweep.py CELL SEED SECONDS RATE [RATE ...]

Each run gets a copy of the cell's workload with ``rate_per_s`` replaced;
it prints the offered rate beside what the run measured.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

CODE = """
import json, sys
sys.path[:0] = [{src!r}, {bench!r}]
import harness
out = harness.run_cell({cell!r}, {seed}, {seconds}, {trace}, base={base!r},
                       metrics_base={bench!r}, per_layer={per_layer!r})
print(json.dumps({{"e2e": {{k: v[0] for k, v in out["e2e"].items()}},
                  "layer": out["per_layer"], "correct": out["correct"],
                  "failed": out["failed"], "attempted": out["attempted"],
                  "checks": {{k: v["value"] for k, v in out["checks"].items()}}}}))
"""


def variant_run(cell, seed, seconds, change, *, trace=False, per_layer=()):
    """Run ``cell`` in its own process on a copy of its workload that
    ``change(wl)`` edits in place; returns the finished process."""
    base = tempfile.mkdtemp(prefix="coldbench-variant-")
    try:
        shutil.copytree(os.path.join(BENCH, "configs"), os.path.join(base, "configs"))
        os.makedirs(os.path.join(base, "workloads"))
        with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
            wl = json.load(f)
        change(wl)
        with open(os.path.join(base, "workloads", f"{cell}.json"), "w") as f:
            json.dump(wl, f)
        code = CODE.format(src=os.path.join(ROOT, "src"), bench=BENCH, cell=cell, seed=seed,
                           seconds=seconds, trace=bool(trace), base=base,
                           per_layer=list(per_layer))
        return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=900)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def last_line(r):
    return r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-800:]


def main() -> int:
    cell, seed, seconds, rates = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), sys.argv[4:]
    for rate in rates:
        r = variant_run(cell, seed, seconds,
                        lambda wl: wl["arrivals"].update(rate_per_s=float(rate)),
                        per_layer=["queue_ms.p95", "cold_pct", "boot_ms.p50", "exec_ms.p50"])
        print(f"rate {rate} rc={r.returncode} {last_line(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
