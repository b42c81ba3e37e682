"""Keep-alive pool: the share of completed requests that started cold
(``InvocationResult.cold``), in %."""


def read(ctx):
    ok = [r for r in ctx.records if r.ok]
    return 100.0 * sum(r.cold for r in ok) / len(ok) if ok else None
