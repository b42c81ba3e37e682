"""``kernels/flash_attention``: the bound of every flash call the traced
window ran (the configuration's ``kernel_calls``, by the frozen
``fwd_cost``), over the profiler's device time of the ``flash_fwd``
kernel, in %.  None for a model that makes no flash call."""

import costs
import devtrace
from harness import log


def read(ctx):
    if ctx.trace is None:
        return None
    b = int(ctx.wl["batch"])
    bounds = [costs.bound_s(o, n) for r in ctx.records if r.ok
              for o, n in ctx.cfg_mod.kernel_calls(ctx.cfg, b, r.seq)["flash_attention"]]
    if not bounds:
        return None
    calls, secs = devtrace.count(ctx.trace.kernels, r"\bflash_fwd\b")
    if not calls or calls != len(bounds):
        log(f"flash_roofline_pct: {calls} flash launches traced, {len(bounds)} expected")
        return None
    return 100.0 * sum(bounds) / secs
