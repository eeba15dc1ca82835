"""readings_ms (``readings_ms.<cells>``): mean milliseconds a chunk of the
benchmark's span around ``__main__._readings_from_chunk`` (the register
snapshot's copy to the host). Traced run."""

import numpy as np


def read(ctx):
    s = ctx.spans.get("readings")
    return float(np.mean(s) * 1e3) if s else None
