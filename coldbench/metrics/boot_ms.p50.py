"""Restore engine: the median ``InvocationResult.boot_s`` of the cold
starts (host clock around ``registry.cold_start``), in ms."""

from harness import pct


def read(ctx):
    boots = [r.boot_s for r in ctx.records if r.ok and r.cold]
    return pct(boots, 50) * 1e3 if boots else None
