"""Run cells of the benchmark one after another, each run its own process,
and keep what each printed.

    python3 coldbench/tools/runs.py OUT_DIR CELL:SEED:SECONDS:TRACE [...]

For every run it writes ``OUT_DIR/<n>-<cell>-<seed>-t<trace>.{out,err}`` and
prints one line: the run's exit code, wall seconds and its result line.  A
cell named ``CELL@DIR`` runs the checkout unpacked in ``DIR`` instead.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", smi.stdout.strip(), flush=True)
    for n, job in enumerate(sys.argv[2:]):
        cell, seed, seconds, trace = job.split(":")
        root = ROOT
        if "@" in cell:
            cell, root = cell.split("@")
        cmd = [sys.executable, "coldbench/run.py", "--workload", cell, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=1500)
        wall = time.perf_counter() - t
        tag = f"{n:02d}-{cell}-{seed}-t{trace}"
        with open(os.path.join(out_dir, tag + ".out"), "w") as f:
            f.write(r.stdout)
        with open(os.path.join(out_dir, tag + ".err"), "w") as f:
            f.write(r.stderr)
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        try:
            res = json.loads(last)
            line = json.dumps({"metrics": {k: v["value"] for k, v in res["metrics"].items()},
                               "correct": res["correct"], "failed": res["failed"],
                               "attempted": res["attempted"],
                               "checks": {k: v["value"] for k, v in res["checks"].items()},
                               **({"busy_s": res["device"]["busy_s"],
                                   "window_s": res["device"]["window_s"]}
                                  if "busy_s" in res["device"] else {})})
        except (ValueError, KeyError):
            line = "no result; stderr tail: " + r.stderr[-1500:]
        print(f"{tag} rc={r.returncode} wall={wall:.1f} {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
