"""Assembled plant models: Monte-Carlo parameter-randomized batches."""

from ics_wt_physicsengine_torch.models.monte_carlo import (  # noqa: F401
    ParameterRanges,
    make_monte_carlo_batch,
)
