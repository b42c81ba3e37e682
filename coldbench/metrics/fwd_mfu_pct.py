"""Whole forward: the model FLOPs the outputs completed in the window need
(the configuration's ``forward_flops``: every layer over every position,
the head at each row's last position), over the window's seconds, as a
share of the card's bf16 peak, in %."""

import costs


def read(ctx):
    b = int(ctx.wl["batch"])
    flops = sum(ctx.cfg_mod.forward_flops(ctx.cfg, b, r.seq) for r in ctx.records
                if r.ok and r.done <= ctx.t_end)
    return 100.0 * flops / ctx.seconds / costs.BF16_FLOPS if flops else None
