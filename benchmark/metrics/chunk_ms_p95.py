"""chunk_ms_p95: the 95th percentile of the wall milliseconds of every
chunk of the window, each from the command that opens it to its readings
on the host (host clock)."""

import numpy as np


def read(ctx):
    if len(ctx.call_s) < 20:
        return None
    return float(np.percentile(np.asarray(ctx.call_s) * 1e3, 95))
