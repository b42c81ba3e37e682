"""``kernels/flash_attention``: the bound of every flash call the traced
window ran (one a layer a request, by the frozen ``fwd_cost``), over the
profiler's device time of the ``flash_fwd`` kernel, in %."""

import costs
import devtrace
from harness import log


def read(ctx):
    if ctx.trace is None or ctx.cfg["family"] == "ssm":
        return None
    calls, secs = devtrace.count(ctx.trace.kernels, r"\bflash_fwd\b")
    b = int(ctx.wl["batch"])
    bounds = [costs.bound_s(o, n) for r in ctx.records if r.ok
              for o, n in costs.flash_calls(ctx.cfg, b, r.seq)]
    if not calls or calls != len(bounds):
        log(f"flash_roofline_pct: {calls} flash launches traced, {len(bounds)} expected")
        return None
    return 100.0 * sum(bounds) / secs
