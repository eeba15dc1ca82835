"""Cross-plant ensemble statistics."""

from ics_wt_physicsengine_torch.parallel.statistics import (  # noqa: F401
    ensemble_statistics,
    exceedance_probability,
)
