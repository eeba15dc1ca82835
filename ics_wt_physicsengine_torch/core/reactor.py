"""
Integrated multi-zone CSTR, the core physics engine (port of the core branch
of ``ics_wt_physicsengine_tpu/core/reactor.py``).

- State is a dataclass of ``[..., n_zones]`` tensors; batched plant axes sit
  on the left, so the same ``derivatives`` serves one plant and a
  Monte-Carlo batch.
- ``step`` advances one dt with fixed-substep RK4 or RKC2; ``rollout`` and
  ``rollout_scheduled`` loop it over many steps (``lax.scan`` in the JAX
  package). The whole-rollout kernels live in ``ops/fused_rollout.py``.
- Parameters and initial states are built host-side in float64 NumPy, as
  in the JAX package, then cast and moved to the device, so both packages
  start from bit-identical values.

ODE system:
  pH:  dosing + inlet + mixing, each converted through the buffering-capacity
       chain rule dpH = -dH / (beta ln10)
  Cl:  dosing + inlet + mixing - k(T) f(pH) Cl
  T:   inlet + mixing - U A (T - T_amb)/(rho cp V)
with the stratification-modified exchange operator rebuilt each evaluation.

The six extension axes (nitrogen, gas, particles, disinfection, biofilm,
phase) are not ported yet: enabling one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch

from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import spatial as spatial_mod
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
from ics_wt_physicsengine_torch.core import transport as transport_mod
from ics_wt_physicsengine_torch.core.chemistry import ChemistryConstants, LN10
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, numpy_dtype,
                                               resolve_device)
from ics_wt_physicsengine_torch.ops import integrators
from ics_wt_physicsengine_torch.utils.dispatch import align_trailing

EXTENSION_FLAGS = ("enable_nitrogen", "enable_gas", "enable_particles",
                   "enable_disinfection", "enable_biofilm", "enable_phase")
EXTENSION_AXES = ("nitrogen", "gas", "particles", "disinfection", "biofilm",
                  "phase")


@dataclass
class ReactorConfiguration:
    """Complete reactor configuration (the JAX package's fields). Numeric
    fields may be NumPy arrays: a Monte-Carlo batch of configurations."""

    # Geometry
    volume: float = 1000.0        # [L]
    height: float = 2.0           # [m]
    diameter: float = 0.798       # [m]
    n_zones: int = 5

    # Flow
    flow_rate: float = 5.0        # [L/min]
    turbulent_intensity: float = 0.15
    recirculation_ratio: float = 5.0
    impeller_speed: float = 60.0  # [rpm]
    impeller_diameter: float = 0.3  # [m]
    power_number: float = 5.0

    # Chemistry
    initial_pH: float = 7.0
    alkalinity: float = 100.0     # [mg/L as CaCO3]
    total_carbonate: float = 2.0  # [mmol/L]

    # Chlorination
    initial_chlorine: float = 2.0  # [mg/L]

    # Temperature
    temperature: float = 20.0     # [C]
    enable_thermal_stratification: bool = True

    # Inlet conditions
    inlet_pH: float = 7.5
    inlet_chlorine: float = 0.0   # [mg/L]
    inlet_temperature: float = 20.0  # [C]

    # Extension axes (not ported yet; enabling one raises
    # NotImplementedError). Their fields are kept so that configurations
    # carry over from the JAX package unchanged.
    enable_nitrogen: bool = False
    initial_ammonia: float = 0.0
    initial_nitrite: float = 0.0
    initial_nitrate: float = 0.0
    initial_chloramine: float = 0.0
    nitrogen_kinetics: Optional[dict] = None
    enable_gas: bool = False
    initial_oxygen: Optional[float] = None
    gas_params: Optional[dict] = None
    enable_particles: bool = False
    initial_tss: float = 10.0
    particle_params: Optional[dict] = None
    enable_disinfection: bool = False
    initial_pathogens: float = 0.0
    initial_toc: float = 2.0
    initial_thm: float = 0.0
    disinfection_params: Optional[dict] = None
    enable_biofilm: bool = False
    initial_bacteria: float = 1e-4
    initial_bdoc: float = 0.3
    initial_biofilm: float = 0.0
    biofilm_params: Optional[dict] = None
    enable_phase: bool = False
    phase_params: Optional[dict] = None

    def validate(self) -> None:
        """Configuration consistency; elementwise over a batch."""

        def ok(cond) -> bool:
            return bool(np.all(cond))

        calculated_volume = math.pi * (np.asarray(self.diameter) / 2) ** 2 \
            * np.asarray(self.height) * 1000
        volume_error = np.abs(calculated_volume - self.volume) / np.asarray(
            self.volume)
        if not ok(volume_error <= 0.01):
            raise ValueError(
                f"Volume mismatch: specified {self.volume}L, calculated "
                f"{calculated_volume}L from geometry. "
                f"Max error: {float(np.max(volume_error)) * 100:.1f}%"
            )
        v = np.asarray(self.volume)
        if not ok((0 < v) & (v < 1e6)):
            raise ValueError("Volume out of range")
        q = np.asarray(self.flow_rate)
        if not ok((0 <= q) & (q < 1e5)):
            raise ValueError("Flow rate out of range (use 0 for batch mode)")
        ph = np.asarray(self.initial_pH)
        if not ok((0 <= ph) & (ph <= 14)):
            raise ValueError("pH out of range")
        cl = np.asarray(self.initial_chlorine)
        if not ok((0 <= cl) & (cl <= 10)):
            raise ValueError("Chlorine out of range")
        t = np.asarray(self.temperature)
        if not ok((0 <= t) & (t <= 40)):
            raise ValueError("Temperature out of typical range")


def reject_extensions(config: ReactorConfiguration) -> None:
    """Raise ``NotImplementedError`` for an enabled extension axis."""
    for flag in EXTENSION_FLAGS:
        if getattr(config, flag, False):
            raise NotImplementedError(
                f"{flag}: the {flag[len('enable_'):]} extension axis is not "
                "ported to the PyTorch package yet")


@dataclass(frozen=True)
class ReactorParams:
    """Physical parameters: 0-d tensors for one plant, ``[B]`` tensors for
    a Monte-Carlo batch. ``n_zones`` is a Python int. The extension axes are
    ``None`` (not ported yet); the fused kernels reject anything else."""

    n_zones: int

    # geometry
    volume_L: torch.Tensor = None
    zone_volume_L: torch.Tensor = None
    zone_height: torch.Tensor = None
    heat_area_m2: torch.Tensor = None      # lateral + two ends

    # transport
    k_exchange: torch.Tensor = None        # [1/s] interface exchange rate
    velocity_scale: torch.Tensor = None    # [m/s] superficial velocity

    # kinetics
    cl_k_ref: torch.Tensor = None          # [1/s]
    cl_ea: torch.Tensor = None             # [J/mol]

    # chemistry constants cached at the configuration temperature
    chem: ChemistryConstants = None

    # stratification
    strat_enabled: torch.Tensor = None     # 0.0 / 1.0
    ri_crit: torch.Tensor = None
    supp_factor: torch.Tensor = None

    nitrogen: Optional[object] = None
    gas: Optional[object] = None
    particles: Optional[object] = None
    disinfection: Optional[object] = None
    biofilm: Optional[object] = None
    phase: Optional[object] = None


@dataclass(frozen=True)
class BoundaryConditions:
    """Physical boundary conditions / forcing: Python floats or tensors
    (``[B]`` per plant, or ``[n_steps]`` in a schedule)."""

    inlet_flow_rate: float = 5.0       # [L/min]
    inlet_pH: float = 7.5
    inlet_chlorine: float = 0.0        # [mg/L]
    inlet_temperature: float = 20.0    # [C]

    acid_flow_rate: float = 0.0        # [L/min]
    acid_concentration: float = 0.1    # [mol/L]

    chlorine_flow_rate: float = 0.0    # [L/min]
    chlorine_concentration: float = 50.0  # [mg/L]

    ambient_temperature: float = 20.0  # [C]
    heat_loss_coefficient: float = 0.0  # [W/K]


@dataclass
class ReactorState:
    """Reactor state: primary ``[..., n_zones]`` tensors plus the derived
    quantities ``_update_derived`` recomputes."""

    time: torch.Tensor
    pH: torch.Tensor
    chlorine: torch.Tensor
    temperature: torch.Tensor
    flow_rate: torch.Tensor

    H_concentration: torch.Tensor = None
    density: torch.Tensor = None
    chlorine_decay_rate: torch.Tensor = None


def params_numpy(config: ReactorConfiguration, np_dtype) -> dict:
    """The parameter fields as NumPy arrays of ``np_dtype`` (``chem``
    nested), computed in float64 exactly as the JAX package's
    ``make_params`` does."""
    reject_extensions(config)
    config.validate()
    geometry = transport_mod.GeometryParameters(
        volume=config.volume, height=config.height,
        diameter=config.diameter, n_zones=config.n_zones,
    )
    flow = transport_mod.FlowParameters(
        flow_rate=config.flow_rate,
        turbulent_intensity=config.turbulent_intensity,
        recirculation_ratio=config.recirculation_ratio,
        impeller_speed=config.impeller_speed,
        impeller_diameter=config.impeller_diameter,
        power_number=config.power_number,
    )
    coeffs = transport_mod.transport_coefficients(
        geometry, flow, config.temperature)

    a_lateral = math.pi * config.diameter * config.height
    a_ends = 2 * math.pi * (config.diameter / 2) ** 2

    def arr(x):
        return np.asarray(x, np_dtype)

    k = chem.chemistry_constants_numpy(
        config.alkalinity, config.total_carbonate, config.temperature)
    return dict(
        n_zones=config.n_zones,
        volume_L=arr(config.volume),
        zone_volume_L=arr(config.volume / config.n_zones),
        zone_height=arr(geometry.zone_height),
        heat_area_m2=arr(a_lateral + a_ends),
        k_exchange=arr(coeffs["k_exchange"]),
        velocity_scale=arr(coeffs["superficial_velocity"]),
        cl_k_ref=arr(c.CL_DECAY_K_REF),
        cl_ea=arr(c.CL_DECAY_EA),
        chem={name: arr(v) for name, v in k.items()},
        strat_enabled=arr(1.0 if config.enable_thermal_stratification
                          else 0.0),
        ri_crit=arr(0.25),
        supp_factor=arr(0.5),
    )


def initial_state_numpy(config: ReactorConfiguration, np_dtype) -> dict:
    """The initial state fields as NumPy arrays of ``np_dtype``, derived
    quantities included, computed as the JAX package's
    ``make_initial_state`` does. Array-valued configuration fields give
    ``[B, n_zones]`` zone fields."""
    reject_extensions(config)
    z = config.n_zones
    batch = np.shape(np.asarray(config.initial_pH))

    def full(v):
        v = np.asarray(v, np_dtype)
        v = np.broadcast_to(v[..., None], v.shape + (z,))
        return np.broadcast_to(v, batch + (z,)).copy()

    state = ReactorState(
        time=np.zeros(batch, np_dtype) if batch
        else np.asarray(0.0, np_dtype),
        pH=full(config.initial_pH),
        chlorine=full(config.initial_chlorine),
        temperature=full(config.temperature),
        flow_rate=np.broadcast_to(
            np.asarray(config.flow_rate, np_dtype), batch).copy()
        if batch else np.asarray(config.flow_rate, np_dtype),
    )
    state = _update_derived(state)
    return {f.name: getattr(state, f.name) for f in fields(state)}


def make_params(config: ReactorConfiguration, dtype=DEFAULT_DTYPE,
                device=None) -> ReactorParams:
    """The parameter tensors of a validated configuration, on ``device``
    (``None``: the CUDA card)."""
    from ics_wt_physicsengine_torch.convert import params_from_numpy

    return params_from_numpy(params_numpy(config, numpy_dtype(dtype)),
                             dtype=dtype, device=device)


def make_initial_state(config: ReactorConfiguration, dtype=DEFAULT_DTYPE,
                       device=None) -> ReactorState:
    """The initial state of a configuration, on ``device`` (``None``: the
    CUDA card)."""
    from ics_wt_physicsengine_torch.convert import state_from_numpy

    return state_from_numpy(initial_state_numpy(config, numpy_dtype(dtype)),
                            dtype=dtype, device=device)


def _add_at_first(x, v):
    """``x`` with ``v`` added to zone 0 (``x.at[..., 0].add(v)``)."""
    return torch.cat([(x[..., 0] + v)[..., None], x[..., 1:]], dim=-1)


def derivatives(params: ReactorParams, pH, Cl, T,
                boundary: BoundaryConditions):
    """d(pH, Cl, T)/dt for ``[..., Z]`` zone tensors; the inlet and dosing
    sources enter at zone 0 and the outlet sink leaves at zone Z-1."""
    k = params.chem

    # In-domain clamp: every term is evaluated at in-bounds values, so an
    # extreme forcing cannot drive an intermediate stage to inf/NaN.
    pH = torch.clip(pH, 0.0, 14.0)
    Cl = torch.clamp(Cl, min=0.0)
    T = torch.clip(T, 0.0, 100.0)

    # Stratification-modified exchange operator: density profile ->
    # Richardson per interface -> suppression -> k_iface.
    rho = spatial_mod.water_density(T)
    supp = spatial_mod.mixing_suppression(
        rho, params.zone_height, params.velocity_scale,
        critical_richardson=params.ri_crit,
        suppression_factor=params.supp_factor,
        enabled=params.strat_enabled > 0.5,
    )
    k_iface = params.k_exchange[..., None] * supp if params.k_exchange.ndim \
        else params.k_exchange * supp

    # Dilution rate from the *boundary* inlet flow.
    q_per_v = (boundary.inlet_flow_rate / 60.0) / params.volume_L

    def mix(x):
        return transport_mod.apply_exchange(x, k_iface=k_iface,
                                            q_per_v=q_per_v)

    # --- pH dynamics ---
    H = 10.0 ** (-pH)
    beta = chem.buffering_capacity(pH, k)
    inv_beta_ln10 = 1.0 / (beta * LN10)

    dpH = -mix(H) * inv_beta_ln10  # mixing through the chain rule

    # zone-0 dosing + inlet terms
    dH_dosing = (boundary.acid_flow_rate / 60.0) \
        * boundary.acid_concentration / params.zone_volume_L
    H_inlet = 10.0 ** (-boundary.inlet_pH)
    dCl_dosing = (boundary.chlorine_flow_rate / 60.0) \
        * boundary.chlorine_concentration / params.zone_volume_L

    dH_inlet = q_per_v * (H_inlet - H[..., 0])
    dpH = _add_at_first(dpH, -(dH_dosing + dH_inlet) * inv_beta_ln10[..., 0])

    # --- chlorine dynamics ---
    dCl = mix(Cl)
    dCl = _add_at_first(
        dCl, dCl_dosing + q_per_v * (boundary.inlet_chlorine - Cl[..., 0]))
    k_base = thermo.arrhenius_rate(T, k_ref=params.cl_k_ref, e_a=params.cl_ea)
    ph_factor = chem.pH_dependent_chlorine_decay_factor(pH, k.Ka_HOCl)
    dCl = dCl - k_base * ph_factor * Cl

    # --- temperature dynamics ---
    dT = mix(T)
    dT = _add_at_first(dT, q_per_v * (boundary.inlet_temperature - T[..., 0]))
    # Heat loss uses the TOTAL tank volume in the denominator.
    v_m3 = params.volume_L / 1000.0
    heat_rate = boundary.heat_loss_coefficient * params.heat_area_m2 \
        / (c.WATER_DENSITY_20C * c.WATER_CP * v_m3)
    loss = align_trailing(heat_rate, T) \
        * (T - align_trailing(boundary.ambient_temperature, T))
    return dpH, dCl, dT - loss


def _cast_like(x, like):
    if isinstance(like, torch.Tensor):
        return x.to(like.dtype)
    return np.asarray(x).astype(like.dtype)


def _update_derived(state: ReactorState) -> ReactorState:
    """Recompute the derived quantities, cast to the primary-state dtype
    (NumPy values on the host path, tensors otherwise)."""
    return ReactorState(
        time=state.time,
        pH=state.pH,
        chlorine=state.chlorine,
        temperature=state.temperature,
        flow_rate=state.flow_rate,
        H_concentration=_cast_like(10.0 ** (-state.pH), state.pH),
        density=_cast_like(spatial_mod.water_density(state.temperature),
                           state.pH),
        chlorine_decay_rate=_cast_like(
            thermo.chlorine_decay_rate(state.temperature), state.pH),
    )


def _enforce_bounds(pH, Cl, T):
    """Physical bound clipping."""
    return (
        torch.clip(pH, 0.0, 14.0),
        torch.clamp(Cl, min=0.0),
        torch.clip(T, 0.0, 100.0),
    )


def _reject_extension_params(params: ReactorParams) -> None:
    for axis in EXTENSION_AXES:
        if getattr(params, axis) is not None:
            raise NotImplementedError(
                f"the {axis} extension axis is not ported to the PyTorch "
                "package yet")


def step(params: ReactorParams, state: ReactorState,
         boundary: BoundaryConditions, dt: float, substeps: int,
         stages: Optional[int] = None) -> ReactorState:
    """Advance the reactor by ``dt`` seconds: ``substeps`` RK4 steps, or
    s-stage RKC2 steps when ``stages`` is given, then the physical bounds."""
    _reject_extension_params(params)

    def f(y):
        return derivatives(params, y[0], y[1], y[2], boundary)

    y = (state.pH, state.chlorine, state.temperature)
    if stages is None:
        out = integrators.integrate_fixed(f, y, dt, substeps)
    else:
        out = integrators.integrate_rkc(f, y, dt, substeps, stages)
    pH, Cl, T = _enforce_bounds(*out)

    total_flow = (boundary.inlet_flow_rate + boundary.acid_flow_rate
                  + boundary.chlorine_flow_rate)
    new_state = ReactorState(
        time=state.time + dt,
        pH=pH,
        chlorine=Cl,
        temperature=T,
        flow_rate=torch.as_tensor(total_flow, dtype=pH.dtype,
                                  device=pH.device)
        + torch.zeros_like(state.flow_rate),
    )
    return _update_derived(new_state)


def _record(s: ReactorState) -> dict:
    return {"pH": s.pH, "chlorine": s.chlorine, "temperature": s.temperature}


def _stack(records):
    return {key: torch.stack([r[key] for r in records])
            for key in ("pH", "chlorine", "temperature")}


def rollout(params: ReactorParams, state: ReactorState,
            boundary: BoundaryConditions, dt: float, substeps: int,
            n_steps: int, record: bool = True,
            stages: Optional[int] = None):
    """Loop ``step`` over ``n_steps``. Returns ``(final_state, trajectory)``
    where the trajectory stacks the primary variables per step
    (``[n_steps, ..., Z]``), or is ``None`` when ``record=False``."""
    records = []
    for _ in range(n_steps):
        state = step(params, state, boundary, dt, substeps, stages=stages)
        if record:
            records.append(_record(state))
    return state, (_stack(records) if record else None)


def schedule_length(schedule: BoundaryConditions) -> int:
    """The ``n_steps`` that the ``[n_steps]`` fields of a schedule agree on;
    raises when there are none or they disagree."""
    lengths = {int(np.shape(getattr(schedule, f.name))[0])
               for f in fields(schedule)
               if np.ndim(getattr(schedule, f.name)) >= 1}
    if not lengths:
        raise ValueError("schedule has no [n_steps] fields; use rollout() "
                         "for constant boundary conditions")
    if len(lengths) > 1:
        raise ValueError(f"schedule fields disagree on n_steps: {lengths}")
    return lengths.pop()


def rollout_scheduled(params: ReactorParams, state: ReactorState,
                      schedule: BoundaryConditions, dt: float,
                      substeps: int, record: bool = True,
                      stages: Optional[int] = None):
    """Loop ``step`` over a time-varying boundary-condition schedule: a
    ``BoundaryConditions`` whose fields carry a leading ``[n_steps]`` axis
    (scalar fields hold for every step). Returns ``(final_state,
    trajectory)`` like ``rollout``."""
    n_steps = schedule_length(schedule)
    device = state.pH.device
    columns = {}
    for f in fields(schedule):
        x = getattr(schedule, f.name)
        if np.ndim(x) >= 1:
            x = torch.as_tensor(x, device=device)
        columns[f.name] = x

    records = []
    for i in range(n_steps):
        bc = BoundaryConditions(**{
            name: (x[i] if isinstance(x, torch.Tensor) else x)
            for name, x in columns.items()})
        state = step(params, state, bc, dt, substeps, stages=stages)
        if record:
            records.append(_record(state))
    return state, (_stack(records) if record else None)


def stack_boundary_schedule(boundaries) -> BoundaryConditions:
    """Stack a sequence of BoundaryConditions into the ``[n_steps]``-field
    schedule ``rollout_scheduled`` consumes."""
    out = {}
    for f in fields(BoundaryConditions):
        xs = [getattr(b, f.name) for b in boundaries]
        if any(isinstance(x, torch.Tensor) for x in xs):
            out[f.name] = torch.stack([torch.as_tensor(x) for x in xs])
        else:
            out[f.name] = np.stack([np.asarray(x) for x in xs])
    return BoundaryConditions(**out)


def _lambda_max(config: ReactorConfiguration) -> float:
    geometry = transport_mod.GeometryParameters(
        volume=config.volume, height=config.height,
        diameter=config.diameter, n_zones=config.n_zones)
    flow = transport_mod.FlowParameters(
        flow_rate=config.flow_rate, impeller_speed=config.impeller_speed,
        impeller_diameter=config.impeller_diameter,
        power_number=config.power_number)
    coeffs = transport_mod.transport_coefficients(geometry, flow,
                                                  config.temperature)
    return 4.0 * coeffs["k_exchange"] + coeffs["q_per_v"]


def default_substeps(config: ReactorConfiguration, dt: float) -> int:
    """RK4 substep policy: the stiffest linear rate is the exchange operator
    (spectral radius < 4 k_exchange) plus dilution; target lambda*h <= 1.8."""
    return max(1, math.ceil(dt * _lambda_max(config) / 1.8 - 1e-9))


def default_rkc_plan(config: ReactorConfiguration, dt: float,
                     max_stages: int = 8, mode: str = "strict"):
    """(substeps, stages) for RKC2 at this configuration's stiffness.
    ``mode="strict"`` caps lambda*h at 1.5 for accuracy; ``mode="fast"``
    is stability-limited (ensemble-grade accuracy, fewest evaluations)."""
    if mode not in ("strict", "fast"):
        raise ValueError(f"mode must be 'strict' or 'fast', got {mode!r}")
    return integrators.rkc_plan(
        dt, _lambda_max(config), max_stages=max_stages,
        accuracy_span=1.5 if mode == "strict" else None)


def conservation_metrics(params: ReactorParams,
                         state: ReactorState) -> Dict[str, torch.Tensor]:
    """Mass/charge/energy audit of a state."""
    zone_volume = params.zone_volume_L
    H = 10.0 ** (-state.pH)

    total_cl_mg = torch.sum(state.chlorine, dim=-1) * zone_volume
    total_h_mol = torch.sum(H, dim=-1) * zone_volume / 1000.0
    kw = thermo.water_ionization_constant(state.temperature[..., 0])
    total_oh_mol = torch.sum(align_trailing(kw, H) / H, dim=-1) \
        * zone_volume / 1000.0

    v_m3 = params.volume_L / 1000.0
    thermal_kj = (c.WATER_DENSITY_20C * c.WATER_CP * v_m3
                  * torch.mean(state.temperature - 20.0, dim=-1) / 1000.0)

    return {
        "total_chlorine_mg": total_cl_mg,
        "total_H_mol": total_h_mol,
        "total_OH_mol": total_oh_mol,
        "charge_balance_mol": total_h_mol - total_oh_mol,
        "thermal_energy_kJ": thermal_kj,
        "zones": params.n_zones,
        "timestamp": state.time,
    }


class IntegratedCSTR:
    """Stateful shell over the functions above: it owns the parameter
    tensors and the current state of one plant, and the reference
    simulator's diagnostic sub-models (``thermo``, ``buffer``,
    ``chemistry``, ``transport``, ``spatial``; host-side)."""

    def __init__(self, config: ReactorConfiguration, dtype=DEFAULT_DTYPE,
                 device=None, substeps: Optional[int] = None,
                 integrator: str = "rk4"):
        """``integrator``: "rk4", "rkc-strict" or "rkc-fast". ``device``
        ``None`` is the CUDA card."""
        if integrator not in ("rk4", "rkc-strict", "rkc-fast"):
            raise ValueError(f"Unknown integrator: {integrator!r}")
        config.validate()
        self.config = config
        self.integrator = integrator
        self.device = resolve_device(device)
        self._substeps_override = substeps
        self._dtype = dtype

        self.thermo = thermo.TemperatureDependentKinetics()
        self.buffer = chem.BufferSystem(
            alkalinity=config.alkalinity,
            total_carbonate=config.total_carbonate,
            temperature=config.temperature,
        )
        self.chemistry = chem.AqueousChemistry(self.buffer)
        self.transport = transport_mod.TransportModel(
            transport_mod.GeometryParameters(
                volume=config.volume, height=config.height,
                diameter=config.diameter, n_zones=config.n_zones),
            transport_mod.FlowParameters(
                flow_rate=config.flow_rate,
                turbulent_intensity=config.turbulent_intensity,
                recirculation_ratio=config.recirculation_ratio,
                impeller_speed=config.impeller_speed,
                impeller_diameter=config.impeller_diameter,
                power_number=config.power_number),
            config.temperature,
        )
        self.spatial = spatial_mod.SpatialModel(
            n_zones=config.n_zones, height=config.height,
            stratification_params=spatial_mod.StratificationParameters(
                enable_thermal_stratification=(
                    config.enable_thermal_stratification)),
        )

        self.params = make_params(config, dtype=dtype, device=self.device)
        self.state = make_initial_state(config, dtype=dtype,
                                        device=self.device)

    def substeps_for(self, dt: float) -> int:
        if self._substeps_override is not None:
            return self._substeps_override
        return default_substeps(self.config, dt)

    def _plan_for(self, dt: float):
        """(substeps, stages) for the configured integrator; stages=None
        selects RK4."""
        if self.integrator == "rk4":
            return self.substeps_for(dt), None
        mode = "strict" if self.integrator == "rkc-strict" else "fast"
        if self._substeps_override is not None:
            return self._substeps_override, 4
        return default_rkc_plan(self.config, dt, mode=mode)

    def step(self, dt: float, boundary: BoundaryConditions) -> ReactorState:
        m, s = self._plan_for(float(dt))
        self.state = step(self.params, self.state, boundary, float(dt), m,
                          stages=s)
        return self.state

    def derivatives(self, t, y, boundary: BoundaryConditions):
        """dy/dt for the packed state vector y = [pH_0..n, Cl_0..n,
        T_0..n]: the ODE-system entry point for users who drive their own
        integrator. ``t`` is accepted for ODE-API compatibility; the system
        is autonomous. ``y`` may be a tensor or NumPy values, which take the
        reactor's dtype and device."""
        del t
        n = self.config.n_zones
        if not isinstance(y, torch.Tensor):
            y = torch.from_numpy(np.asarray(y))
        y = y.to(dtype=self._dtype, device=self.device)
        dpH, dCl, dT = derivatives(self.params, y[..., :n], y[..., n:2 * n],
                                   y[..., 2 * n:], boundary)
        return torch.cat([dpH, dCl, dT], dim=-1)

    def rollout(self, dt: float, boundary: BoundaryConditions, n_steps: int,
                record: bool = True):
        m, s = self._plan_for(float(dt))
        self.state, traj = rollout(self.params, self.state, boundary,
                                   float(dt), m, int(n_steps), record=record,
                                   stages=s)
        return self.state, traj

    def rollout_scheduled(self, dt: float, schedule: BoundaryConditions,
                          record: bool = True):
        m, s = self._plan_for(float(dt))
        self.state, traj = rollout_scheduled(self.params, self.state,
                                             schedule, float(dt), m,
                                             record=record, stages=s)
        return self.state, traj

    def rollout_fused(self, dt: float, boundary: BoundaryConditions,
                      n_steps: int, record_every: Optional[int] = None):
        """Run many steps in one launch of the fused-rollout kernel
        (``ops/fused_rollout.py``; its plain version on the CPU)."""
        from ics_wt_physicsengine_torch.ops.fused_rollout import rollout_fused

        m, s = self._plan_for(float(dt))
        out = rollout_fused(self.params, self.state, boundary, dt=float(dt),
                            substeps=m, stages=s, n_steps=int(n_steps),
                            record_every=record_every)
        if record_every is None:
            self.state = out
            return self.state
        self.state, traj = out
        return self.state, traj

    def get_state_at_location(self, zone_idx: int, parameter: str) -> float:
        if zone_idx < 0 or zone_idx >= self.config.n_zones:
            raise ValueError(
                f"Zone index {zone_idx} out of range "
                f"[0, {self.config.n_zones - 1}]")
        arrays = {
            "pH": self.state.pH,
            "chlorine": self.state.chlorine,
            "temperature": self.state.temperature,
            "density": self.state.density,
        }
        if parameter not in arrays:
            raise ValueError(f"Unknown parameter: {parameter}")
        return float(arrays[parameter][..., zone_idx])

    def validate_conservation(self) -> Dict[str, float]:
        metrics = conservation_metrics(self.params, self.state)
        return {k: (v if isinstance(v, int) else float(v))
                for k, v in metrics.items()}

    def print_diagnostics(self) -> None:
        print("\n" + "=" * 70)
        print(f"CSTR PHYSICS DIAGNOSTICS (PyTorch engine, {self.device})")
        print("=" * 70)
        print(f"\nTime: {float(self.state.time):.1f} s")
        rt = self.transport.residence_time
        print(f"Residence time: "
              f"{'%.1f min' % rt if rt is not None else 'n/a (batch)'}")
        print(f"Mixing time: {self.transport.mixing_time_seconds:.1f} s")
        print(f"\n{'Zone':<6} {'pH':<8} {'Cl(mg/L)':<10} {'T(C)':<8} "
              f"{'rho(kg/m3)':<10}")
        print("-" * 50)
        pH, cl, t, rho = (x.cpu().numpy() for x in (
            self.state.pH, self.state.chlorine, self.state.temperature,
            self.state.density))
        for i in range(self.config.n_zones):
            print(f"{i:<6} {pH[i]:<8.3f} {cl[i]:<10.3f} {t[i]:<8.2f} "
                  f"{rho[i]:<10.2f}")
        cons = self.validate_conservation()
        print("\nConservation Laws:")
        print(f"  Total Chlorine: {cons['total_chlorine_mg']:.2f} mg")
        print(f"  Charge Balance: {cons['charge_balance_mol']:.2e} mol")
        _, ph_s = transport_mod.mixing_quality(self.state.pH)
        _, cl_s = transport_mod.mixing_quality(self.state.chlorine)
        print("\nMixing Quality:")
        print(f"  pH segregation index: {float(ph_s):.4f}")
        print(f"  Chlorine segregation index: {float(cl_s):.4f}")
        print("=" * 70 + "\n")


def validate_integrated_reactor(device=None) -> None:
    """Integration oracle: a closed 5-zone reactor holds its state for ten
    steps, and acid dosing then lowers the pH of the dosed zone. Runs on
    ``device`` (``None``: the CUDA card)."""
    config = ReactorConfiguration(
        volume=1000, height=2.0, diameter=0.798, n_zones=5,
        flow_rate=5.0, initial_pH=7.5, initial_chlorine=2.0, temperature=20.0,
    )
    reactor = IntegratedCSTR(config, device=device)

    boundary = BoundaryConditions(
        inlet_flow_rate=0.0, inlet_pH=7.5, inlet_chlorine=0.0,
        inlet_temperature=20.0, acid_flow_rate=0.0, chlorine_flow_rate=0.0,
    )

    for _ in range(10):
        reactor.step(dt=1.0, boundary=boundary)

    mean_ph = float(reactor.state.pH.mean())
    mean_cl = float(reactor.state.chlorine.mean())
    assert 6.0 < mean_ph < 9.0, f"pH drift: {mean_ph}"
    assert 0.0 < mean_cl < 5.0, f"Chlorine drift: {mean_cl}"

    conservation = reactor.validate_conservation()
    assert conservation["total_chlorine_mg"] > 0, "Chlorine conservation"

    pH_before = float(reactor.state.pH[0])
    boundary_with_acid = BoundaryConditions(
        inlet_flow_rate=0.0, acid_flow_rate=0.5, acid_concentration=0.1,
        chlorine_flow_rate=0.0,
    )
    for _ in range(20):
        reactor.step(dt=1.0, boundary=boundary_with_acid)
    assert float(reactor.state.pH[0]) < pH_before, "Acid should decrease pH"

    print("All integrated reactor validations passed")
