"""Assembled plant models: Monte-Carlo parameter-randomized batches and
the instrumented plant (physics plus the seven-sensor suite)."""

from ics_wt_physicsengine_torch.models.monte_carlo import (  # noqa: F401
    ParameterRanges,
    make_monte_carlo_batch,
)
from ics_wt_physicsengine_torch.models.plant import (  # noqa: F401
    PlantParams,
    PlantState,
    make_plant,
    make_plant_batch,
    plant_rollout,
    plant_rollout_auto,
    plant_rollout_scheduled,
    plant_rollout_serve,
    plant_step,
    plant_step_batched,
)
