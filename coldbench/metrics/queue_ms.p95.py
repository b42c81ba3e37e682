"""Admission and single-flight wait: the 95th percentile of
``InvocationResult.queue_s`` over the window's completed requests, in ms."""

from harness import pct


def read(ctx):
    q = [r.queue_s for r in ctx.records if r.ok]
    return pct(q, 95) * 1e3 if q else None
