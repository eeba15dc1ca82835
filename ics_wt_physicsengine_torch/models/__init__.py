"""Assembled plant models: Monte-Carlo parameter-randomized batches, the
instrumented plant (physics plus the seven-sensor suite), the named
BASELINE configurations and the learned plant surrogate."""

from ics_wt_physicsengine_torch.models.monte_carlo import (  # noqa: F401
    ParameterRanges,
    make_monte_carlo_batch,
)
from ics_wt_physicsengine_torch.models.plant import (  # noqa: F401
    PlantParams,
    PlantState,
    ServeChunk,
    config1_two_zone,
    config2_stratified_20_zone,
    config3_full_sensors,
    config4_monte_carlo,
    config5_hil_cli_args,
    make_plant,
    make_plant_batch,
    plant_rollout,
    plant_rollout_auto,
    plant_rollout_batched,
    plant_rollout_scheduled,
    plant_rollout_serve,
    plant_serve_chunk,
    plant_step,
    plant_step_batched,
)
from ics_wt_physicsengine_torch.models.surrogate import (  # noqa: F401
    SurrogateParams,
    fit_plant_surrogate,
    make_surrogate_dataset,
    run_mpc_surrogate,
    surrogate_mpc_plan,
    surrogate_rollout,
    surrogate_step,
    train_surrogate,
)
