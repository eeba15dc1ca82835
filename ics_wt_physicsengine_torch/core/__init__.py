"""
Physics core: the multi-zone CSTR over dense zone tensors.

Layering:
  thermodynamics -> chemistry / transport / spatial -> reactor -> network
  extension axes: nitrogen, gas, particles, disinfection, biofilm, phase

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
from ics_wt_physicsengine_torch.core.nitrogen import (  # noqa: F401
    NitrogenParams,
    make_nitrogen_params,
    total_nitrogen_mgN,
    validate_nitrogen,
)
from ics_wt_physicsengine_torch.core.gas import (  # noqa: F401
    GasParams,
    co2_henry_constant,
    make_gas_params,
    oxygen_saturation,
    validate_gas,
)
from ics_wt_physicsengine_torch.core.particles import (  # noqa: F401
    ParticleParams,
    make_particle_params,
    stokes_velocity,
    total_solids_mgl,
    turbidity_ntu,
    turbidity_ntu_tap,
    validate_particles,
)
from ics_wt_physicsengine_torch.core.disinfection import (  # noqa: F401
    DisinfectionParams,
    PATHOGEN_NAMES,
    absorbance_254,
    log_inactivation,
    make_disinfection_params,
    uvt_percent,
    validate_disinfection,
)
from ics_wt_physicsengine_torch.core.biofilm import (  # noqa: F401
    BiofilmParams,
    hpc_cfu_per_ml,
    make_biofilm_params,
    total_biomass_carbon,
    validate_biofilm,
)
from ics_wt_physicsengine_torch.core.phase import (  # noqa: F401
    PhaseParams,
    enthalpy,
    evaporation_flux,
    ice_fraction,
    make_phase_params,
    saturation_vapor_pressure,
    validate_phase,
)
from ics_wt_physicsengine_torch.core.network import (  # noqa: F401
    NetworkState,
    NetworkTopology,
    make_network,
    network_step,
    rollout_network,
    rollout_network_scheduled,
    topology_arrays,
)
from ics_wt_physicsengine_torch.device import resolve_device

_AXIS_SUITES = (("nitrogen chemistry", validate_nitrogen),
                ("gas exchange", validate_gas),
                ("particle dynamics", validate_particles),
                ("disinfection", validate_disinfection),
                ("biofilm", validate_biofilm),
                ("phase-change", validate_phase))


def run_all_validations(device=None) -> None:
    """Run the five core validation suites (thermodynamics, chemistry,
    transport, spatial, integrated reactor), then the six extension-axis
    suites (nitrogen, gas, particles, disinfection, biofilm, phase). The
    suites that touch tensors run on ``device`` (``None``: the CUDA card);
    the others are host-side oracles."""
    device = resolve_device(device)
    print(f"Running all physics validations on {device}...")
    validate_thermodynamics()
    validate_chemistry()
    validate_transport(device)
    validate_spatial()
    validate_integrated_reactor(device)
    for name, suite in _AXIS_SUITES:
        if not suite(device=device):
            raise RuntimeError(f"{name} validation failed")
    print("ALL PHYSICS VALIDATIONS PASSED")
