"""
Physics core: the multi-zone CSTR over dense zone tensors.

Layering:
  thermodynamics -> chemistry / transport / spatial -> reactor

The compute paths are functions on tensors; the exported classes are the
reference simulator's object API over them (same names and signatures as
the JAX package's ``core``).
"""

from ics_wt_physicsengine_torch.core.thermodynamics import (  # noqa: F401
    ArrheniusParameters,
    TemperatureDependentKinetics,
    validate_thermodynamics,
)
from ics_wt_physicsengine_torch.core.chemistry import (  # noqa: F401
    AqueousChemistry,
    BufferSystem,
    ChemistryConstants,
    make_chemistry_constants,
    solve_pH,
    validate_chemistry,
)
from ics_wt_physicsengine_torch.core.transport import (  # noqa: F401
    FlowParameters,
    GeometryParameters,
    TransportModel,
    apply_exchange,
    exchange_matrix,
    validate_transport,
)
from ics_wt_physicsengine_torch.core.spatial import (  # noqa: F401
    SpatialModel,
    StratificationParameters,
    validate_spatial,
)
from ics_wt_physicsengine_torch.core.reactor import (  # noqa: F401
    BoundaryConditions,
    IntegratedCSTR,
    ReactorConfiguration,
    ReactorParams,
    ReactorState,
    conservation_metrics,
    default_substeps,
    derivatives,
    make_initial_state,
    make_params,
    rollout,
    rollout_scheduled,
    stack_boundary_schedule,
    step,
    validate_integrated_reactor,
)
from ics_wt_physicsengine_torch.device import resolve_device


def run_all_validations(device=None) -> None:
    """Run the five core validation suites: thermodynamics, chemistry,
    transport, spatial, integrated reactor. The suites that touch tensors
    (transport's stencil check, the reactor) run on ``device`` (``None``:
    the CUDA card); the others are host-side oracles.

    The JAX package's ``run_all_validations`` also runs the suites of its
    six extension axes (nitrogen, gas, particles, disinfection, biofilm,
    phase). Those axes are not ported yet, so their suites do not run here
    and this function does not vouch for them."""
    device = resolve_device(device)
    print(f"Running the core physics validations on {device}...")
    validate_thermodynamics()
    validate_chemistry()
    validate_transport(device)
    validate_spatial()
    validate_integrated_reactor(device)
    print("ALL CORE PHYSICS VALIDATIONS PASSED "
          "(extension-axis suites: not ported)")
