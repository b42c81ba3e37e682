"""Serve one seed of a closed-loop cell with the cell's lanes and with one
lane, and hold every completed request to the reference in both.

    python3 coldbench/tools/lanes.py CELL SEED SECONDS [TRACED_RUNS]

Every run is its own process on a copy of the cell's workload whose check
compares each completed request.  ``TRACED_RUNS`` (default 2) runs keep the
cell's callers and lanes and trace the window; one more has one caller and
one lane.  The callers draw from one stream, so the one-lane run serves a
prefix of the same requests.  It prints each run's gaps, and for the
requests that two runs both served (by token seed) whether their gaps are
the same: a request served alike under four lanes and under one reads the
same gap.
"""

import json
import re
import sys

from sweep import last_line, variant_run

COMPARED = re.compile(r"compared (\S+) fn(\d+) seq (\d+) tok (\d+) (cold|warm) logit gap (\S+)")


def gaps(stderr):
    """{token seed: gap} of the window's requests (set-up cold starts aside)."""
    return {int(m[3]): float(m[5]) for m in COMPARED.findall(stderr) if m[4] == "warm"}


def main() -> int:
    cell, seed, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
    traced = int(sys.argv[4]) if len(sys.argv) > 4 else 2

    def every(wl):
        wl["check"]["sample"] = 10**6

    def one_lane(wl):
        every(wl)
        wl.update(clients=1, worker_concurrency=1)

    runs = [(f"lanes{n}-traced", every, True) for n in range(traced)]
    runs.append(("one-lane", one_lane, False))
    seen = {}
    for tag, change, trace in runs:
        r = variant_run(cell, seed, seconds, change, trace=trace)
        g = gaps(r.stderr)
        seen[tag] = g
        worst = max(g.items(), key=lambda kv: kv[1]) if g else None
        print(json.dumps({"run": tag, "rc": r.returncode, "compared": len(g),
                          "widest": worst, "gaps": sorted(g.values())[-5:],
                          "result": last_line(r)}), flush=True)
    ref = seen["one-lane"]
    for tag, g in seen.items():
        if tag == "one-lane":
            continue
        both = sorted(set(g) & set(ref))
        same = sum(g[k] == ref[k] for k in both)
        diff = max((abs(g[k] - ref[k]) for k in both), default=0.0)
        print(json.dumps({"against_one_lane": tag, "both_served": len(both),
                          "same_gap": same, "largest_difference": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
