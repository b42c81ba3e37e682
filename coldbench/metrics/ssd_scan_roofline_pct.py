"""``kernels/ssd``: the bound of every ``ssd_scan`` call the traced window
ran (the configuration's ``kernel_calls``, by the frozen ``scan_cost``),
over the profiler's device time of the scan's CUDA kernels (three a bf16
call), in %.  None for a model that makes no scan call."""

import costs
import devtrace
from harness import log

KERNELS_PER_CALL = {"bfloat16": 3, "float32": 4}


def read(ctx):
    if ctx.trace is None:
        return None
    b = int(ctx.wl["batch"])
    bounds = [costs.bound_s(o, n) for r in ctx.records if r.ok
              for o, n in ctx.cfg_mod.kernel_calls(ctx.cfg, b, r.seq)["ssd_scan"]]
    if not bounds:
        return None
    launches, secs = devtrace.count(
        ctx.trace.kernels, r"\bssd_(chunk_state|state_pass|chunk_scan|chunk_cb)\b")
    per_call = KERNELS_PER_CALL[ctx.cfg.get("dtype", "bfloat16")]
    if not launches or launches != per_call * len(bounds):
        log(f"ssd_scan_roofline_pct: {launches} scan kernels traced, "
            f"{per_call * len(bounds)} expected")
        return None
    return 100.0 * sum(bounds) / secs
