"""Utilities: broadcasting helpers, checkpoint/resume, history logging,
profiling, device selection."""

from ics_wt_physicsengine_torch.utils.dispatch import (  # noqa: F401
    align_trailing,
)
from ics_wt_physicsengine_torch.utils.checkpoint import (  # noqa: F401
    load_metadata,
    load_pytree,
    load_simulation,
    save_pytree,
    save_simulation,
)
from ics_wt_physicsengine_torch.utils.history import (  # noqa: F401
    ParquetHistoryLogger,
)
from ics_wt_physicsengine_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    diagnostics,
    trace,
)
