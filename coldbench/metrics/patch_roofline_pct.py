"""``kernels/snapshot_patch``: the byte bound of every patch a cold start
in the traced window launched (one a changed leaf of the function, the
leaf in chunk rows; frozen byte count of ``chip_smoke.py``), over the
profiler's device time of ``patch_replace_kernel``, in %."""

import costs
import devtrace
from harness import log


def read(ctx):
    if ctx.trace is None:
        return None
    calls, secs = devtrace.count(ctx.trace.kernels, r"\bpatch_replace_kernel\b")
    c = ctx.chunk_bytes
    leaves = [nb for r in ctx.records if r.ok and r.cold
              for nb in ctx.functions[r.fn]["leaf_bytes"]]
    if not calls or calls != len(leaves):
        log(f"patch_roofline_pct: {calls} patch launches traced, {len(leaves)} expected")
        return None
    nbytes = sum(costs.patch_bytes(costs.leaf_patch_rows(nb, c), c) for nb in leaves)
    return 100.0 * costs.bound_s(0.0, nbytes) / secs
