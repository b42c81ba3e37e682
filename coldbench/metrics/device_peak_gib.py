"""Device memory: the CUDA caching allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset as the window opens), in GiB.
Every request in flight holds its float32 logits over every position
(``Model._logits_head``), so a leaner head shows here."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes > 0 else None
