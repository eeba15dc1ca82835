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

Six optional extension axes add species and terms (``core/nitrogen.py``,
``gas.py``, ``particles.py``, ``disinfection.py``, ``biofilm.py``,
``phase.py``). An axis is on when its parameters are present; off, the
state carries none of its fields and every code path is the core one. The
axes run the plain PyTorch step: the fused kernels refuse them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ics_wt_physicsengine_torch.core import biofilm as biofilm_mod
from ics_wt_physicsengine_torch.core import chemistry as chem
from ics_wt_physicsengine_torch.core import constants as c
from ics_wt_physicsengine_torch.core import disinfection as disinfection_mod
from ics_wt_physicsengine_torch.core import gas as gas_mod
from ics_wt_physicsengine_torch.core import nitrogen as nitrogen_mod
from ics_wt_physicsengine_torch.core import particles as particles_mod
from ics_wt_physicsengine_torch.core import phase as phase_mod
from ics_wt_physicsengine_torch.core import spatial as spatial_mod
from ics_wt_physicsengine_torch.core import thermodynamics as thermo
from ics_wt_physicsengine_torch.core import transport as transport_mod
from ics_wt_physicsengine_torch.core.chemistry import ChemistryConstants, LN10
from ics_wt_physicsengine_torch.device import (DEFAULT_DTYPE, numpy_dtype,
                                               resolve_device)
from ics_wt_physicsengine_torch.ops import integrators
from ics_wt_physicsengine_torch.utils.dispatch import (align_trailing, clip,
                                                       map_tensors, nonneg)

EXTENSION_FLAGS = ("enable_nitrogen", "enable_gas", "enable_particles",
                   "enable_disinfection", "enable_biofilm", "enable_phase")
EXTENSION_AXES = ("nitrogen", "gas", "particles", "disinfection", "biofilm",
                  "phase")
# axis -> (parameter class, the NumPy function that makes its fields, the
# configuration field holding that function's overrides)
EXTENSION_PARAMS = {
    "nitrogen": (nitrogen_mod.NitrogenParams,
                 nitrogen_mod.nitrogen_params_numpy, "nitrogen_kinetics"),
    "gas": (gas_mod.GasParams, gas_mod.gas_params_numpy, "gas_params"),
    "particles": (particles_mod.ParticleParams,
                  particles_mod.particle_params_numpy, "particle_params"),
    "disinfection": (disinfection_mod.DisinfectionParams,
                     disinfection_mod.disinfection_params_numpy,
                     "disinfection_params"),
    "biofilm": (biofilm_mod.BiofilmParams,
                biofilm_mod.biofilm_params_numpy, "biofilm_params"),
    "phase": (phase_mod.PhaseParams, phase_mod.phase_params_numpy,
              "phase_params"),
}


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

    # Nitrogen / biological chemistry (core/nitrogen.py)
    enable_nitrogen: bool = False
    initial_ammonia: float = 0.0     # [mg N/L] total ammonia nitrogen
    initial_nitrite: float = 0.0     # [mg N/L]
    initial_nitrate: float = 0.0     # [mg N/L]
    initial_chloramine: float = 0.0  # [mg/L as Cl2] (combined chlorine)
    nitrogen_kinetics: Optional[dict] = None  # nitrogen_params_numpy kw

    # Gas exchange (core/gas.py)
    enable_gas: bool = False
    initial_oxygen: Optional[float] = None   # [mg/L]; None = saturation(T)
    gas_params: Optional[dict] = None        # gas_params_numpy kw

    # Particle dynamics (core/particles.py)
    enable_particles: bool = False
    initial_tss: float = 10.0                # [mg/L] total suspended solids
    particle_params: Optional[dict] = None   # particle_params_numpy kw

    # Disinfection (core/disinfection.py)
    enable_disinfection: bool = False
    initial_pathogens: float = 0.0           # [org/L] every pathogen class
    initial_toc: float = 2.0                 # [mg/L] organic carbon
    initial_thm: float = 0.0                 # [ug/L] trihalomethanes
    disinfection_params: Optional[dict] = None  # disinfection_params_numpy

    # Biofilm / bacterial regrowth (core/biofilm.py)
    enable_biofilm: bool = False
    initial_bacteria: float = 1e-4           # [mg C/L] (~5e2 CFU/mL HPC)
    initial_bdoc: float = 0.3                # [mg/L] biodegradable DOC
    initial_biofilm: float = 0.0             # [mg C/m2] wall film
    biofilm_params: Optional[dict] = None    # biofilm_params_numpy kw

    # Phase change (core/phase.py): widens the [0, 100] C temperature clip
    enable_phase: bool = False
    phase_params: Optional[dict] = None      # phase_params_numpy kw

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
        if self.enable_phase:
            # sub-zero states are ice; the boil band caps the hot end
            if not ok((-60 <= t) & (t <= 100)):
                raise ValueError("Temperature out of phase-change range")
        elif not ok((0 <= t) & (t <= 40)):
            raise ValueError("Temperature out of typical range")


@dataclass(frozen=True)
class ReactorParams:
    """Physical parameters: 0-d tensors for one plant, ``[B]`` tensors for
    a Monte-Carlo batch. ``n_zones`` is a Python int. An extension axis is
    ``None`` when it is off; the fused kernels reject any that is on."""

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

    # extension axes (None = off)
    nitrogen: Optional[nitrogen_mod.NitrogenParams] = None
    gas: Optional[gas_mod.GasParams] = None
    particles: Optional[particles_mod.ParticleParams] = None
    disinfection: Optional[disinfection_mod.DisinfectionParams] = None
    biofilm: Optional[biofilm_mod.BiofilmParams] = None
    phase: Optional[phase_mod.PhaseParams] = None


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

    inlet_ammonia: float = 0.0         # [mg N/L] (nitrogen only)

    # gas exchange only: source-water O2 / total carbonate and the
    # diffused-aeration actuator (volumetric O2 kLa; CO2 rides the same
    # bubbles scaled by the film ratio)
    inlet_oxygen: float = 9.0          # [mg/L]
    inlet_carbonate: float = 2.0       # [mmol/L]
    aeration_kla: float = 0.0          # [1/s]

    # particle dynamics only: source-water solids and the coagulant,
    # filter and sludge-blowdown actuators
    inlet_tss: float = 10.0            # [mg/L]
    coagulant_dose: float = 0.0        # [mg/L]
    filter_flow_rate: float = 0.0      # [L/min]
    sludge_blowdown: float = 0.0       # [1/s]
    # optional per-class source-water solids [..., C] [mg/L]; when set it
    # replaces inlet_tss x inlet_fractions
    inlet_tss_classes: Optional[torch.Tensor] = None

    # disinfection only: source-water pathogens and organics, inlet CT /
    # age / THM, and the UV bank (lamp wall fluence rate at the outlet zone)
    inlet_pathogens: float = 0.0       # [org/L] every class
    inlet_toc: float = 2.0             # [mg/L]
    inlet_ct: float = 0.0              # [mg min/L]
    inlet_age: float = 0.0             # [s]
    inlet_thm: float = 0.0             # [ug/L]
    uv_intensity: float = 0.0          # [mW/cm2] lamp wall fluence rate
    # optional per-class source-water pathogens [..., P] [org/L]; when set
    # it replaces inlet_pathogens
    inlet_pathogen_classes: Optional[torch.Tensor] = None

    # biofilm only: source-water planktonic biomass and substrate
    inlet_bacteria: float = 0.0        # [mg C/L]
    inlet_bdoc: float = 0.3            # [mg/L]

    # phase change only: the ambient moisture and wind over the surface
    ambient_humidity: float = 0.5      # relative humidity in [0, 1]
    wind_speed: float = 0.0            # [m/s]


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

    # nitrogen species (None unless enable_nitrogen; [..., Z])
    ammonia: torch.Tensor = None     # total ammonia nitrogen [mg N/L]
    nitrite: torch.Tensor = None     # [mg N/L]
    nitrate: torch.Tensor = None     # [mg N/L]
    chloramine: torch.Tensor = None  # monochloramine [mg/L as Cl2]

    # gas species (None unless enable_gas; [..., Z])
    oxygen: torch.Tensor = None      # dissolved O2 [mg/L]
    carbonate: torch.Tensor = None   # total carbonate C_T [mmol/L]

    # particle classes (None unless enable_particles)
    tss: torch.Tensor = None         # [..., C, Z] [mg/L]
    sludge: torch.Tensor = None      # [..., C] settled inventory

    # disinfection (None unless enable_disinfection)
    pathogens: torch.Tensor = None   # [..., P, Z] [org/L]
    ct: torch.Tensor = None          # [..., Z] CT credit [mg min/L]
    age: torch.Tensor = None         # [..., Z] water age [s]
    toc: torch.Tensor = None         # [..., Z] organics [mg/L]
    thm: torch.Tensor = None         # [..., Z] THMs [ug/L]

    # biofilm / regrowth (None unless enable_biofilm; [..., Z])
    bacteria: torch.Tensor = None    # planktonic [mg C/L]
    bdoc: torch.Tensor = None        # substrate [mg/L]
    biofilm: torch.Tensor = None     # wall film [mg C/m2]


# the state fields each extension axis adds, in the step's species order
EXTENSION_STATE = {
    "nitrogen": ("ammonia", "nitrite", "nitrate", "chloramine"),
    "gas": ("oxygen", "carbonate"),
    "particles": ("tss", "sludge"),
    "disinfection": ("pathogens", "ct", "age", "toc", "thm"),
    "biofilm": ("bacteria", "bdoc", "biofilm"),
}


def params_numpy(config: ReactorConfiguration, np_dtype) -> dict:
    """The parameter fields as NumPy arrays of ``np_dtype`` (``chem``
    nested), computed in float64 exactly as the JAX package's
    ``make_params`` does. An enabled extension axis is a nested mapping of
    its own fields."""
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
    axes = {axis: build(np_dtype, **(getattr(config, overrides) or {}))
            for axis, (_, build, overrides) in EXTENSION_PARAMS.items()
            if getattr(config, f"enable_{axis}")}
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
        **axes,
    )


def initial_state_numpy(config: ReactorConfiguration, np_dtype) -> dict:
    """The initial state fields as NumPy arrays of ``np_dtype``, derived
    quantities included, computed as the JAX package's
    ``make_initial_state`` does. Array-valued configuration fields give
    ``[B, n_zones]`` zone fields (``[B, C, n_zones]`` for the particle and
    pathogen classes)."""
    z = config.n_zones
    batch = np.shape(np.asarray(config.initial_pH))

    def full(v):
        v = np.asarray(v, np_dtype)
        v = np.broadcast_to(v[..., None], v.shape + (z,))
        return np.broadcast_to(v, batch + (z,)).copy()

    ext = {}
    if config.enable_nitrogen:
        ext.update(ammonia=full(config.initial_ammonia),
                   nitrite=full(config.initial_nitrite),
                   nitrate=full(config.initial_nitrate),
                   chloramine=full(config.initial_chloramine))
    if config.enable_gas:
        o2_0 = config.initial_oxygen
        if o2_0 is None:
            o2_0 = gas_mod.oxygen_saturation(
                np.asarray(config.temperature, np.float64))
        ext.update(oxygen=full(o2_0), carbonate=full(config.total_carbonate))
    if config.enable_particles:
        pp = particles_mod.particle_params_numpy(
            np.float64, **(config.particle_params or {}))
        fr = np.asarray(pp["inlet_fractions"], np_dtype)      # [C]
        tss0 = np.asarray(config.initial_tss, np_dtype)       # [...] or ()
        ext.update(
            tss=np.broadcast_to((tss0[..., None] * fr)[..., None],
                                batch + (particles_mod.N_CLASSES, z)).copy(),
            sludge=np.zeros(batch + (particles_mod.N_CLASSES,), np_dtype))
    if config.enable_disinfection:
        n0 = np.asarray(config.initial_pathogens, np_dtype)
        ext.update(
            pathogens=np.broadcast_to(
                n0[..., None, None],
                batch + (disinfection_mod.N_PATHOGENS, z)).copy(),
            ct=full(0.0), age=full(0.0), toc=full(config.initial_toc),
            thm=full(config.initial_thm))
    if config.enable_biofilm:
        ext.update(bacteria=full(config.initial_bacteria),
                   bdoc=full(config.initial_bdoc),
                   biofilm=full(config.initial_biofilm))
    state = ReactorState(
        time=np.zeros(batch, np_dtype) if batch
        else np.asarray(0.0, np_dtype),
        pH=full(config.initial_pH),
        chlorine=full(config.initial_chlorine),
        temperature=full(config.temperature),
        flow_rate=np.broadcast_to(
            np.asarray(config.flow_rate, np_dtype), batch).copy()
        if batch else np.asarray(config.flow_rate, np_dtype),
        **ext,
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


def _add_at_last(x, v):
    """``x`` with ``v`` added to zone Z-1 (``x.at[..., -1].add(v)``)."""
    return torch.cat([x[..., :-1], (x[..., -1] + v)[..., None]], dim=-1)


def _last_zone_mask(like):
    """A ``[..., Z]`` one-hot of zone Z-1: the free surface (gas exchange,
    evaporation) and the outlet (the UV bank)."""
    mask = torch.zeros_like(like)
    mask[..., -1] = 1.0
    return mask


def _aligned(axis_params, like):
    """Every field of an axis's parameters padded against ``like``."""
    return map_tensors(lambda x: align_trailing(x, like), axis_params)


def derivatives(params: ReactorParams, pH, Cl, T,
                boundary: BoundaryConditions, inlet_mask=None,
                outlet_mask=None, nitrogen=None, gas=None, particles=None,
                disinfection=None, biofilm=None):
    """d(pH, Cl, T)/dt for ``[..., Z]`` zone tensors, followed by the
    tendencies of the extension species passed in: ``nitrogen`` (ammonia,
    nitrite, nitrate, chloramine), ``gas`` (oxygen, carbonate),
    ``particles`` (tss ``[..., C, Z]``, sludge ``[..., C]``),
    ``disinfection`` (pathogens ``[..., P, Z]``, ct, age, toc, thm) and
    ``biofilm`` (bacteria, bdoc, biofilm). The phase axis acts through
    ``params.phase`` alone.

    The inlet and dosing sources enter at zone 0 and the outlet sink (with
    the free surface's gas exchange, evaporation and filtration) leaves at
    zone Z-1, unless ``inlet_mask``/``outlet_mask`` (``[..., Z]`` one-hot
    tensors) place them on other zones: the zone-sharded step
    (``parallel/spatial.py``) passes them, because a shard sees a
    halo-padded block of the column whose ends are ghosts. With a mask, the
    sludge tendency is gated by the inlet mask's sum, so that summing it
    over the shards gives the whole column's."""
    k = params.chem

    # In-domain clamp: every term is evaluated at in-bounds values, so an
    # extreme forcing cannot drive an intermediate stage to inf/NaN.
    pH = clip(pH, 0.0, 14.0)
    Cl = nonneg(Cl)
    pp_ph = phi = None
    if params.phase is not None:
        # sub-zero states are ice and the boil band caps the hot end
        pp_ph = _aligned(params.phase, T)
        T = clip(T, pp_ph.t_min, pp_ph.t_boil + pp_ph.delta_boil)
        phi = phase_mod.ice_fraction(T, pp_ph)
    else:
        T = clip(T, 0.0, 100.0)

    # Gas exchange makes total carbonate a per-zone state: buffering and
    # speciation see the dynamic C_T.
    if gas is not None:
        o2_s, ct_s = (nonneg(x) for x in gas)
        ct_mol = ct_s * 1e-3
        k = replace(k, C_T_mol=ct_mol)

    # Stratification-modified exchange operator: density profile ->
    # Richardson per interface -> suppression -> k_iface. With phase change
    # the Richardson path sees the ice-water mixture density and ice
    # throttles the exchange.
    if phi is None:
        rho = spatial_mod.water_density(T)
    else:
        rho = phase_mod.effective_density(T, pp_ph)
    supp = spatial_mod.mixing_suppression(
        rho, params.zone_height, params.velocity_scale,
        critical_richardson=params.ri_crit,
        suppression_factor=params.supp_factor,
        enabled=params.strat_enabled > 0.5,
    )
    k_iface = params.k_exchange[..., None] * supp if params.k_exchange.ndim \
        else params.k_exchange * supp
    if phi is not None:
        k_iface = k_iface * phase_mod.interface_mobility(phi)

    # Dilution rate from the *boundary* inlet flow.
    q_per_v = (boundary.inlet_flow_rate / 60.0) / params.volume_L

    if outlet_mask is None:
        def mix(x):
            return transport_mod.apply_exchange(x, k_iface=k_iface,
                                                q_per_v=q_per_v)
    else:
        def mix(x):  # the outlet sink on the masked zone
            return transport_mod.apply_exchange(x, k_iface=k_iface,
                                                q_per_v=0.0) \
                - align_trailing(q_per_v, x) * x * outlet_mask

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

    if inlet_mask is None:
        dH_inlet = q_per_v * (H_inlet - H[..., 0])
        dpH = _add_at_first(dpH,
                            -(dH_dosing + dH_inlet) * inv_beta_ln10[..., 0])
    else:
        qv = align_trailing(q_per_v, H)
        dpH = dpH - align_trailing(dH_dosing, H) * inlet_mask \
            * inv_beta_ln10 - qv * (align_trailing(H_inlet, H) - H) \
            * inlet_mask * inv_beta_ln10

    # --- chlorine dynamics ---
    dCl = mix(Cl)
    if inlet_mask is None:
        dCl = _add_at_first(
            dCl, dCl_dosing + q_per_v * (boundary.inlet_chlorine - Cl[..., 0]))
    else:
        dCl = dCl + align_trailing(dCl_dosing, Cl) * inlet_mask \
            + align_trailing(q_per_v, Cl) \
            * (align_trailing(boundary.inlet_chlorine, Cl) - Cl) * inlet_mask
    k_base = thermo.arrhenius_rate(T, k_ref=params.cl_k_ref, e_a=params.cl_ea)
    ph_factor = chem.pH_dependent_chlorine_decay_factor(pH, k.Ka_HOCl)
    dCl = dCl - k_base * ph_factor * Cl

    # --- temperature dynamics ---
    dT = mix(T)
    if inlet_mask is None:
        dT = _add_at_first(dT,
                           q_per_v * (boundary.inlet_temperature - T[..., 0]))
    else:
        dT = dT + align_trailing(q_per_v, T) \
            * (align_trailing(boundary.inlet_temperature, T) - T) * inlet_mask
    # Heat loss uses the TOTAL tank volume in the denominator.
    v_m3 = params.volume_L / 1000.0
    heat_rate = boundary.heat_loss_coefficient * params.heat_area_m2 \
        / (c.WATER_DENSITY_20C * c.WATER_CP * v_m3)
    loss = align_trailing(heat_rate, T) \
        * (T - align_trailing(boundary.ambient_temperature, T))
    if phi is not None:
        # Phase change: ice insulates the ambient loss, the free surface
        # loses latent heat to evaporation (blocked by an ice lid), and the
        # whole tendency is divided by the apparent heat capacity, so
        # temperatures pin at the phase fronts.
        loss = loss * (1.0 - pp_ph.ice_insulation * phi)
        q_evap = phase_mod.evaporative_cooling_flux(
            T, align_trailing(boundary.ambient_temperature, T),
            align_trailing(boundary.ambient_humidity, T),
            align_trailing(boundary.wind_speed, T), pp_ph)
        a_cross = params.volume_L / 1000.0 \
            / (params.zone_height * params.n_zones)          # [m^2]
        evap_rate = q_evap * align_trailing(
            a_cross / (c.WATER_DENSITY_20C * c.WATER_CP
                       * (params.zone_volume_L / 1000.0)), T)  # [K/s]
        surf = _last_zone_mask(T) if outlet_mask is None else outlet_mask
        sink = loss + evap_rate * (1.0 - phi) * surf
        dT = (dT - sink) * (1.0 / phase_mod.heat_capacity_ratio(T, pp_ph))
    else:
        dT = dT - loss

    if nitrogen is None and gas is None and particles is None \
            and disinfection is None and biofilm is None:
        return dpH, dCl, dT

    # shared inlet/source helper for the extension species
    def species(x, inlet_conc, reaction):
        if inlet_mask is None:
            return _add_at_first(mix(x) + reaction,
                                 q_per_v * (inlet_conc - x[..., 0]))
        return mix(x) + reaction + align_trailing(q_per_v, x) \
            * (align_trailing(inlet_conc, x) - x) * inlet_mask

    # O2 limitation (gas) scales the nitrification rates and those rates
    # set the O2 demand: rates first, equations second.
    gp = None if gas is None else _aligned(params.gas, T)

    extra = ()
    r1 = r2 = None
    if nitrogen is not None:
        # Chloramine formation is absent here: step() applies it as an
        # exact analytic operator split.
        np_ = _aligned(params.nitrogen, T)
        nh, no2, no3, nhcl = (nonneg(x) for x in nitrogen)
        r1 = nitrogen_mod.nitrification_rate(nh, T, np_)      # [mg N/L/s]
        r2 = nitrogen_mod.nitratation_rate(no2, T, np_)
        r3 = nitrogen_mod.denitrification_rate(no3, T, np_)
        if gas is not None:
            # aerobic steps are Monod-limited in O2; denitrification is
            # O2-inhibited
            lim = gas_mod.o2_monod(o2_s, gp.K_o2_nitrif)
            r1 = r1 * lim
            r2 = r2 * lim
            r3 = r3 * gas_mod.o2_inhibition(o2_s, gp.K_o2_denit)
        r_cm_decay = (np_.k_cm_decay / nitrogen_mod.SECONDS_PER_DAY) * nhcl

        dNH = species(nh, boundary.inlet_ammonia, -r1)
        dNO2 = species(no2, 0.0, r1 - r2)
        dNO3 = species(no3, 0.0, r2 - r3)
        dNHCl = species(nhcl, 0.0, -r_cm_decay)

        # alkalinity coupling through the buffering chain rule:
        # nitrification releases 2 H+/N, denitrification consumes 1 H+/N
        dH_bio = (nitrogen_mod.H_PER_N_NITRIF * r1
                  + nitrogen_mod.H_PER_N_DENIT * r3) \
            / nitrogen_mod._N_MGL_PER_MOL                    # [mol/L/s]
        dpH = dpH - dH_bio * inv_beta_ln10
        extra += (dNH, dNO2, dNO3, dNHCl)

    if gas is not None:
        # Two-film surface transfer on the top zone; diffused aeration
        # (boundary.aeration_kla) acts on every zone.
        surf = _last_zone_mask(T) if outlet_mask is None else outlet_mask
        kla_surf = gas_mod.kla_temperature(
            gp.kl_surface / align_trailing(params.zone_height, T),
            T, gp.theta_kla) * surf
        if phi is not None:
            # an ice lid blocks the surface film (aeration below it works)
            kla_surf = kla_surf * (1.0 - phi)
        kla_o2 = kla_surf + align_trailing(boundary.aeration_kla, T)
        r_o2 = kla_o2 * (gas_mod.oxygen_saturation(T) - o2_s)  # [mg/L/s]
        demand = 0.0
        if r1 is not None:
            # nitrification oxygen demand: 3.43 + 1.14 g O2 / g N
            demand = gas_mod.O2_PER_N_AOB * r1 + gas_mod.O2_PER_N_NOB * r2
        dO2 = species(o2_s, boundary.inlet_oxygen, r_o2 - demand)

        # CO2 exchanges against the dissolved (alpha0) carbonate fraction
        a0, _, _ = chem.alpha_carbonate(pH, k.Ka1, k.Ka2)
        r_co2_mol = (kla_o2 * gas_mod.CO2_FILM_RATIO) * (
            gas_mod.co2_saturation_mol(T, gp.p_co2_atm) - a0 * ct_mol)
        dCT = species(ct_s, boundary.inlet_carbonate, 1e3 * r_co2_mol)

        # equilibrium pH shift at constant alkalinity
        dpH = dpH + gas_mod.ph_per_carbonate(pH, k) * r_co2_mol
        extra += (dO2, dCT)

    if particles is not None:
        # The class axis sits ahead of the zone axis ([..., C, Z]); the
        # exchange stencil vectorizes over it through a class axis in the
        # interface rates.
        pp = params.particles
        tss, sludge = (nonneg(x) for x in particles)

        if outlet_mask is None:
            dTSS = transport_mod.apply_exchange(
                tss, k_iface=k_iface[..., None, :], q_per_v=q_per_v)
        else:
            dTSS = transport_mod.apply_exchange(
                tss, k_iface=k_iface[..., None, :], q_per_v=0.0) \
                - align_trailing(q_per_v, tss) * tss \
                * outlet_mask[..., None, :]
        # inlet advection at zone 0, split by the source-water fractions
        # or taken class-resolved from inlet_tss_classes
        if boundary.inlet_tss_classes is None:
            tss_in = align_trailing(boundary.inlet_tss, T) \
                * pp.inlet_fractions
        else:
            tss_in = torch.as_tensor(boundary.inlet_tss_classes,
                                     dtype=tss.dtype, device=tss.device)
        if inlet_mask is None:
            dTSS = _add_at_first(
                dTSS,
                align_trailing(q_per_v, tss_in) * (tss_in - tss[..., 0]))
        else:
            dTSS = dTSS + align_trailing(q_per_v, tss) \
                * (tss_in[..., None] - tss) * inlet_mask[..., None, :]

        # Stokes settling toward zone 0 at each zone's own viscosity
        w_rate = particles_mod.settling_rates_zonal(
            pp, T, params.zone_height)
        dsettle, deposit = particles_mod.settle(
            tss, w_rate, top_mask=outlet_mask, bottom_mask=inlet_mask)
        dTSS = dTSS + dsettle

        # coagulation chain (mass-conserving across classes)
        dTSS = dTSS + particles_mod.coagulation_chain(
            tss, boundary.coagulant_dose, pp)

        # recirculating filtration at the outlet zone
        q_filter = (boundary.filter_flow_rate / 60.0) / params.zone_volume_L
        if outlet_mask is None:
            dTSS = _add_at_last(
                dTSS, -align_trailing(q_filter, tss[..., -1])
                * pp.filter_eff * tss[..., -1])
        else:
            dTSS = dTSS - align_trailing(q_filter, tss) \
                * pp.filter_eff[..., None] * tss * outlet_mask[..., None, :]

        # sludge inventory: deposit in, resuspension + blowdown out
        resusp = align_trailing(pp.k_resuspension, sludge) * sludge
        dSludge = deposit - resusp \
            - align_trailing(boundary.sludge_blowdown, sludge) * sludge
        if inlet_mask is None:
            dTSS = _add_at_first(dTSS, resusp)
        else:
            dTSS = dTSS + resusp[..., None] * inlet_mask[..., None, :]
            # gated to the bottom-owning shard: the sum over the shards is
            # the column's tendency
            dSludge = dSludge * torch.sum(inlet_mask, dim=-1)[..., None]
        extra += (dTSS, dSludge)

    if disinfection is not None:
        # Chick-Watson chlorine kill rides the right-hand side; the UV bank
        # is an operator split in step(). The per-class leaves (k_cl,
        # k_uv, [..., P]) broadcast through their own [..., P, Z] expansion
        # and are not padded against the zone tensors.
        dp0 = params.disinfection
        dp = replace(_aligned(dp0, T), k_cl=dp0.k_cl, k_uv=dp0.k_uv)
        path, ct_min, age_s, toc, thm = disinfection
        path = nonneg(path)
        toc = nonneg(toc)

        # organics exert a chlorine demand; a pH-enhanced yield of it
        # becomes THMs and TOC is consumed stoichiometrically
        r_dem = disinfection_mod.chlorine_demand_rate(toc, Cl, T, dp)
        dCl = dCl - r_dem
        dTOC = species(toc, boundary.inlet_toc, -dp.s_toc * r_dem)
        dTHM = species(nonneg(thm), boundary.inlet_thm,
                       disinfection_mod.thm_formation_rate(r_dem, pH, dp))

        # CT credit and water age as advected scalars
        dCTcred = species(nonneg(ct_min), boundary.inlet_ct,
                          Cl / disinfection_mod.SECONDS_PER_MIN)
        dAge = species(nonneg(age_s), boundary.inlet_age,
                       torch.ones_like(T))

        # pathogen classes [..., P, Z]: mixing/advection over the class
        # axis, Chick-Watson sink
        lam = disinfection_mod.chlorine_lethality(
            Cl, pH, T, align_trailing(k.Ka_HOCl, pH), dp)
        if outlet_mask is None:
            dN = transport_mod.apply_exchange(
                path, k_iface=k_iface[..., None, :], q_per_v=q_per_v)
        else:
            dN = transport_mod.apply_exchange(
                path, k_iface=k_iface[..., None, :], q_per_v=0.0) \
                - align_trailing(q_per_v, path) * path \
                * outlet_mask[..., None, :]
        dN = dN - lam * path
        if boundary.inlet_pathogen_classes is None:
            n_in = boundary.inlet_pathogens + torch.zeros(
                path.shape[:-1], dtype=path.dtype, device=path.device)
        else:
            n_in = torch.as_tensor(boundary.inlet_pathogen_classes,
                                   dtype=path.dtype, device=path.device)
        if inlet_mask is None:
            dN = _add_at_first(
                dN, align_trailing(q_per_v, n_in) * (n_in - path[..., 0]))
        else:
            dN = dN + align_trailing(q_per_v, path) \
                * (n_in[..., None] - path) * inlet_mask[..., None, :]
        extra += (dN, dCTcred, dAge, dTOC, dTHM)

    if biofilm is not None:
        # Planktonic biomass and substrate are bulk species; the wall film
        # is attached (zone-local). All rates are slow: no operator split.
        bp = _aligned(params.biofilm, T)
        x_b, s_b, b_w = (nonneg(x) for x in biofilm)

        # colonizable area-to-volume ratio [m2/L]: the thermal model's
        # lateral + ends area split evenly across zones
        a_v = align_trailing(
            params.heat_area_m2 / (params.n_zones * params.zone_volume_L),
            T)
        u = align_trailing(params.velocity_scale, T)

        mu_x = biofilm_mod.specific_growth_bulk(s_b, Cl, T, bp)
        mu_b = biofilm_mod.specific_growth_film(s_b, Cl, T, b_w, bp)
        kx = biofilm_mod.kill_rate_bulk(Cl, bp)
        kb = biofilm_mod.kill_rate_film(Cl, bp)
        det = biofilm_mod.detachment_rate(u, bp)

        # bulk biomass: growth - kill - attachment + sloughed film
        r_x = mu_x * x_b - kx * x_b - bp.k_att * x_b + det * b_w * a_v
        # wall film (areal units): growth - kill + attachment - detachment
        r_b = mu_b * b_w - kb * b_w + bp.k_att * x_b / a_v - det * b_w
        # substrate: consumed by both compartments at the carbon yield; a
        # lysis fraction of killed biomass is recycled
        r_s = -(mu_x * x_b + mu_b * b_w * a_v) / bp.yield_c \
            + bp.f_lysis * (kx * x_b + kb * b_w * a_v)

        dX = species(x_b, boundary.inlet_bacteria, r_x)
        dS = species(s_b, boundary.inlet_bdoc, r_s)
        dB = r_b    # attached: no mixing, no advection, no inlet

        # the film's wall chlorine demand on the residual
        dCl = dCl - biofilm_mod.wall_demand_rate(Cl, b_w, a_v, bp)
        extra += (dX, dS, dB)

    return (dpH, dCl, dT) + extra


def _cast_like(x, like):
    if isinstance(like, torch.Tensor):
        return x.to(like.dtype)
    return np.asarray(x).astype(like.dtype)


def _update_derived(state: ReactorState) -> ReactorState:
    """Recompute the derived quantities, cast to the primary-state dtype
    (NumPy values on the host path, tensors otherwise)."""
    return replace(
        state,
        H_concentration=_cast_like(10.0 ** (-state.pH), state.pH),
        density=_cast_like(spatial_mod.water_density(state.temperature),
                           state.pH),
        chlorine_decay_rate=_cast_like(
            thermo.chlorine_decay_rate(state.temperature), state.pH),
    )


def _enforce_bounds(pH, Cl, T, phase=None):
    """Physical bound clipping. With the phase axis on, the [0, 100]
    temperature clip widens to [t_min, t_boil + delta_boil]."""
    if phase is None:
        t_clip = clip(T, 0.0, 100.0)
    else:
        t_clip = clip(T, align_trailing(phase.t_min, T),
                      align_trailing(phase.t_boil + phase.delta_boil, T))
    return (
        clip(pH, 0.0, 14.0),
        nonneg(Cl),
        t_clip,
    )


def species_layout(params: ReactorParams, state: ReactorState):
    """``(y, spans)``: the step's species tuple, (pH, Cl, T) then the
    fields of each enabled extension axis in the order of
    ``EXTENSION_STATE``, and each axis's slice of it."""
    y = (state.pH, state.chlorine, state.temperature)
    spans = {}
    for axis, names in EXTENSION_STATE.items():
        if getattr(params, axis) is None \
                or getattr(state, names[0]) is None:
            continue
        spans[axis] = slice(len(y), len(y) + len(names))
        y = y + tuple(getattr(state, name) for name in names)
    return y, spans


def check_deriv_fn_axes(spans, capable: Dict[str, bool]) -> None:
    """Refuse a custom derivative function that was not declared capable
    of an enabled extension axis (``capable``: axis -> declared)."""
    for axis in spans:
        if not capable.get(axis, False):
            fields_ = "/".join(EXTENSION_STATE[axis])
            raise ValueError(
                f"this custom deriv_fn was not declared {axis}-capable "
                f"(pass deriv_fn_{axis}=True if it accepts and returns the "
                f"{fields_} fields in the species order); the zone-sharded "
                f"step (parallel/spatial.py) supports {axis} through its "
                f"{axis}=True option")


def finish_step(params: ReactorParams, state: ReactorState,
                boundary: BoundaryConditions, out, spans, dt: float,
                uv_mask=None) -> ReactorState:
    """The end of ``step`` after the integrator: the physical bounds, the
    extension species floored at zero, the two exact operator splits (the
    UV bank on ``uv_mask``'s zone, by default zone Z-1, and
    chloramination), the new clock and flow, and the derived fields.
    ``out`` is the integrated species tuple laid out as ``spans`` says
    (``species_layout``); the zone-sharded step applies this to each
    shard."""
    pH, Cl, T = _enforce_bounds(*out[:3], phase=params.phase)
    ext = {name: nonneg(x)
           for axis, sl in spans.items()
           for name, x in zip(EXTENSION_STATE[axis], out[sl])}

    if "disinfection" in spans:
        # Operator split for the UV bank: exact survival over dt at the
        # Beer-Lambert average fluence of the stepped water, whose organics
        # and particles shade the lamps.
        dp0 = params.disinfection
        dpar = replace(_aligned(dp0, pH), k_cl=dp0.k_cl, k_uv=dp0.k_uv)
        tss_tot = torch.sum(ext["tss"], dim=-2) if "particles" in spans \
            else torch.zeros_like(ext["toc"])
        a254 = disinfection_mod.absorbance_254(ext["toc"], tss_tot, dpar)
        e0 = align_trailing(boundary.uv_intensity, pH)
        e_avg = disinfection_mod.average_fluence(e0, a254, dpar)
        surv = disinfection_mod.uv_survival(e_avg, dt, dpar)  # [..., P, Z]
        mask = _last_zone_mask(pH) if uv_mask is None else uv_mask
        ext["pathogens"] = ext["pathogens"] \
            * (1.0 + mask[..., None, :] * (surv - 1.0))

    if "nitrogen" in spans:
        # Operator split for chloramination (HOCl + NH3 -> NH2Cl, ~60 1/s
        # at 2 mg/L): the exact second-order extent over dt against the
        # stepped state. Its H+ release shifts pH through the buffering
        # chain rule, at the dynamic carbonate when gas is on.
        x_mol = nitrogen_mod.chloramination_extent(
            Cl, ext["ammonia"], pH, T, align_trailing(params.chem.Ka_HOCl,
                                                      pH),
            _aligned(params.nitrogen, pH), dt)
        Cl = nonneg(Cl - x_mol * nitrogen_mod._CL2_MGL_PER_MOL)
        ext["ammonia"] = nonneg(
            ext["ammonia"] - x_mol * nitrogen_mod._N_MGL_PER_MOL)
        ext["chloramine"] = ext["chloramine"] \
            + x_mol * nitrogen_mod._CL2_MGL_PER_MOL
        k_split = params.chem
        if "gas" in spans:
            k_split = replace(k_split, C_T_mol=ext["carbonate"] * 1e-3)
        beta = chem.buffering_capacity(pH, k_split)
        pH = clip(
            pH - nitrogen_mod.H_PER_N_CHLORAMINE * x_mol / (beta * LN10),
            0.0, 14.0)

    total_flow = (boundary.inlet_flow_rate + boundary.acid_flow_rate
                  + boundary.chlorine_flow_rate)
    new_state = ReactorState(
        time=state.time + dt,
        pH=pH,
        chlorine=Cl,
        temperature=T,
        flow_rate=torch.zeros_like(state.flow_rate) + total_flow,
        **ext,
    )
    return _update_derived(new_state)


def step(params: ReactorParams, state: ReactorState,
         boundary: BoundaryConditions, dt: float, substeps: int,
         stages: Optional[int] = None, deriv_fn=None,
         deriv_fn_nitrogen: bool = False, deriv_fn_gas: bool = False,
         deriv_fn_particles: bool = False,
         deriv_fn_disinfection: bool = False,
         deriv_fn_biofilm: bool = False, uv_mask=None) -> ReactorState:
    """Advance the reactor by ``dt`` seconds: ``substeps`` RK4 steps, or
    s-stage RKC2 steps when ``stages`` is given, then ``finish_step``: the
    physical bounds and the two exact operator splits, the UV bank
    (disinfection) and chloramination (nitrogen).

    ``deriv_fn`` replaces the derivative evaluation: a function of the
    species tuple (``species_layout``) returning its tendencies. It must be
    declared capable of every enabled extension axis
    (``deriv_fn_<axis>=True``), or the step raises ``ValueError``.
    ``uv_mask`` (``[..., Z]`` one-hot) puts the UV bank's split on another
    zone than Z-1."""
    y, spans = species_layout(params, state)
    if deriv_fn is None:
        def f(y):
            return derivatives(params, y[0], y[1], y[2], boundary,
                               **{axis: y[sl] for axis, sl in spans.items()})
    else:
        check_deriv_fn_axes(spans, dict(
            nitrogen=deriv_fn_nitrogen, gas=deriv_fn_gas,
            particles=deriv_fn_particles,
            disinfection=deriv_fn_disinfection, biofilm=deriv_fn_biofilm))
        f = deriv_fn

    if stages is None:
        out = integrators.integrate_fixed(f, y, dt, substeps)
    else:
        out = integrators.integrate_rkc(f, y, dt, substeps, stages)
    return finish_step(params, state, boundary, out, spans, dt,
                       uv_mask=uv_mask)


def _record(s: ReactorState) -> dict:
    return {"pH": s.pH, "chlorine": s.chlorine, "temperature": s.temperature}


def _stack(records):
    return {key: torch.stack([r[key] for r in records])
            for key in ("pH", "chlorine", "temperature")}


def _stepper(remat: bool):
    """``step``, or with ``remat`` ``step`` under
    ``torch.utils.checkpoint``: reverse-mode differentiation then keeps
    only each step's input state and recomputes the step's intermediates
    (every substep's) in the backward pass, at the cost of one more
    forward evaluation (``jax.checkpoint`` of the scan body in the JAX
    package)."""
    if not remat:
        return step

    def checkpointed(*args, **kw):
        return checkpoint(step, *args, use_reentrant=False, **kw)
    return checkpointed


def rollout(params: ReactorParams, state: ReactorState,
            boundary: BoundaryConditions, dt: float, substeps: int,
            n_steps: int, record: bool = True,
            stages: Optional[int] = None, remat: bool = False):
    """Loop ``step`` over ``n_steps``. Returns ``(final_state, trajectory)``
    where the trajectory stacks the primary variables per step
    (``[n_steps, ..., Z]``), or is ``None`` when ``record=False``.
    ``remat=True`` checkpoints each step (``_stepper``) for long-horizon
    gradients."""
    advance = _stepper(remat)
    records = []
    for _ in range(n_steps):
        state = advance(params, state, boundary, dt, substeps, stages=stages)
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
                      stages: Optional[int] = None, remat: bool = False):
    """Loop ``step`` over a time-varying boundary-condition schedule: a
    ``BoundaryConditions`` whose fields carry a leading ``[n_steps]`` axis
    (scalar fields hold for every step). Returns ``(final_state,
    trajectory)`` like ``rollout``; ``remat`` as there."""
    advance = _stepper(remat)
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
        state = advance(params, state, bc, dt, substeps, stages=stages)
        if record:
            records.append(_record(state))
    return state, (_stack(records) if record else None)


def stack_boundary_schedule(boundaries) -> BoundaryConditions:
    """Stack a sequence of BoundaryConditions into the ``[n_steps]``-field
    schedule ``rollout_scheduled`` consumes."""
    out = {}
    for f in fields(BoundaryConditions):
        xs = [getattr(b, f.name) for b in boundaries]
        if all(x is None for x in xs):
            out[f.name] = None          # an unset per-class inlet vector
        elif any(isinstance(x, torch.Tensor) for x in xs):
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
        # extension species, present only when their axis is enabled
        for name in ("ammonia", "nitrite", "nitrate", "chloramine",
                     "oxygen", "carbonate"):
            v = getattr(self.state, name)
            if v is not None:
                arrays[name] = v
        if self.state.tss is not None:
            arrays["tss"] = particles_mod.total_solids_mgl(self.state.tss)
            arrays["turbidity"] = particles_mod.turbidity_ntu(
                self.state.tss, self.params.particles)
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
