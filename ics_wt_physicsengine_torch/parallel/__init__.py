"""Plant-batch sharding over devices (data parallel, no collective),
multi-process linking, and cross-plant ensemble statistics. The
zone-sharded step of the JAX package (``parallel/spatial.py``) is not
ported yet (ROADMAP queue A item 9b)."""

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
from ics_wt_physicsengine_torch.parallel.statistics import (  # noqa: F401
    ensemble_statistics,
    exceedance_probability,
)
