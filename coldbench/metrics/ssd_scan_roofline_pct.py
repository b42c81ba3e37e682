"""``kernels/ssd``: the bound of every ``ssd_scan`` call the traced window
ran (one a layer a request, by the frozen ``scan_cost``), over the
profiler's device time of the scan's CUDA kernels (three a bf16 call), in %."""

import costs
import devtrace
from harness import log

KERNELS_PER_CALL = {"bfloat16": 3, "float32": 4}


def read(ctx):
    if ctx.trace is None or ctx.cfg["family"] != "ssm":
        return None
    launches, secs = devtrace.count(
        ctx.trace.kernels, r"\bssd_(chunk_state|state_pass|chunk_scan|chunk_cb)\b")
    b = int(ctx.wl["batch"])
    bounds = [costs.bound_s(o, n) for r in ctx.records if r.ok
              for o, n in costs.scan_calls(ctx.cfg, b, r.seq)]
    per_call = KERNELS_PER_CALL[ctx.cfg.get("dtype", "bfloat16")]
    if not launches or launches != per_call * len(bounds):
        log(f"ssd_scan_roofline_pct: {launches} scan kernels traced, "
            f"{per_call * len(bounds)} expected")
        return None
    return 100.0 * sum(bounds) / secs
