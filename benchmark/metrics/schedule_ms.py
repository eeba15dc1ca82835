"""schedule_ms (``schedule_ms.<cells>``): mean milliseconds a chunk of the
benchmark's span around ``__main__.build_chunk_schedule`` (ending
synchronized). Traced run."""

import numpy as np


def read(ctx):
    s = ctx.spans.get("schedule")
    return float(np.mean(s) * 1e3) if s else None
