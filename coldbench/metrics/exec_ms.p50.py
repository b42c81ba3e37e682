"""Forward: the median ``InvocationResult.exec_s`` of warm requests (host
clock from parameter lookup to ``torch.cuda.synchronize``), in ms."""

from harness import pct


def read(ctx):
    ex = [r.exec_s for r in ctx.records if r.ok and not r.cold]
    return pct(ex, 50) * 1e3 if ex else None
