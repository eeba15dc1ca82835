"""kernel_us_per_step (``kernel_us_per_step.<cells>``): the device time of
the entry's kernels a call (``torch.profiler``) over the call's steps, in
microseconds. One plant is bound by the latency of its chain of steps, so
this stands where a roofline share would read near zero. Traced run."""


def read(ctx):
    t = ctx.cell.traffic
    steps = t.get("steps_per_chunk", t.get("steps_per_call"))
    if ctx.trace is None or not ctx.traced_calls or not steps:
        return None
    kernel = ctx.trace.kernel_s(*ctx.kernels)
    if kernel <= 0:
        return None
    return kernel / ctx.traced_calls / steps * 1e6
