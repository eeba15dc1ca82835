"""Plant-batch sharding over devices (data parallel, no collective), the
zone-sharded step (one column of zones split over devices, halos at every
stage), multi-process linking, and cross-plant ensemble statistics."""

from ics_wt_physicsengine_torch.parallel.fused import (  # noqa: F401
    sharded_plant_rollout_fused,
    sharded_rollout_fused,
)
from ics_wt_physicsengine_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_batch,
    make_mesh,
    shard_batch,
    sharded_rollout,
    sharded_step,
)
from ics_wt_physicsengine_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    local_plant_slice,
    shard_batch_multihost,
)
from ics_wt_physicsengine_torch.parallel.spatial import (  # noqa: F401
    ZoneMesh,
    gather_zones,
    make_plant_zone_mesh,
    make_zone_mesh,
    plant_zone_sharded_step,
    shard_batch_zones,
    shard_state_zones,
    zone_sharded_rollout,
    zone_sharded_step,
)
from ics_wt_physicsengine_torch.parallel.statistics import (  # noqa: F401
    ensemble_statistics,
    exceedance_probability,
)
