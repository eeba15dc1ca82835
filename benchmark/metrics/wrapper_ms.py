"""wrapper_ms (``wrapper_ms.<cells>``): mean milliseconds a call of the
span around the entry's call (``rollout_fused``, ``plant_rollout_fused``,
``plant_serve_chunk``; ending synchronized; the traced run's first half)
less its kernels' device time a call (``torch.profiler``, its second
half): what the host side of the entry costs beyond its kernels."""

import numpy as np


def read(ctx):
    s = ctx.spans.get(ctx.wrapper)
    if not s or ctx.trace is None or not ctx.traced_calls:
        return None
    kernel = ctx.trace.kernel_s(*ctx.kernels)
    if kernel <= 0:
        return None
    return float(np.mean(s) * 1e3 - kernel / ctx.traced_calls * 1e3)
