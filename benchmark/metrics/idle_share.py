"""idle_share (``idle_share.<cells>``): 1 - (the union of the device's
activity) / (the traced window), from ``torch.profiler``'s trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
