"""
Physical sample-line model: derived heat transfer + in-line sample decay.

The reference lists "Sample line heat transfer simplified (exponential
model)" among its sensor-model limitations (reference README.md:531):
its SampleLine relaxes the sample temperature toward ambient at a
HARD-CODED 10 %/s (reference base_sensor.py:210-214, "Simplified: 10%
approach per second") regardless of tubing size, flow rate, or
insulation — and it transports the measured VALUE unchanged, ignoring
that reactive species (chlorine!) decay during line residence.

This module replaces both simplifications with first-principles models:

**Heat transfer** — the steady plug-flow heat-exchanger solution
``T_out = T_amb + (T_in − T_amb)·exp(−NTU)`` with the NTU derived from
the installation, not assumed:

- internal film coefficient from Nusselt correlations: laminar fully
  developed Nu = 3.66 (constant wall T; Incropera Table 8.1) or
  Dittus-Boelter ``Nu = 0.023·Re^0.8·Pr^0.3`` (cooling) for Re > 4000,
  with a linear blend across the transition regime;
- tube wall conduction ``ln(d_o/d_i)/(2π·k_wall·L)``;
- external natural convection + insulation on the outside;
- ``NTU = U·A_i/(ṁ·c_p)`` over the line's wetted area.

**Sample decay** — first-order loss of the measured species during line
residence: ``value_out = value_in·exp(−k_line·τ_res)`` (chlorine demand
of tubing walls + bulk decay; k_line from the thermodynamics module's
Arrhenius rate when modeling chlorine).

``PhysicalSampleLine`` is a drop-in for ``types.SampleLine`` (same
``transport_sample`` contract the reference defines) with the derived
thermal model. Host-side floats throughout, as in the JAX package
(``ics_wt_physicsengine_tpu/sensors/sampleline.py``), whose values it
reproduces.

Water properties are evaluated at 20 °C (ρ=998 kg/m³, μ=1.002e-3 Pa·s,
k=0.598 W/m·K, Pr=7.01, c_p=4184 J/kg·K — CRC Handbook); the NTU's
sensitivity to properties over 0-40 °C is well under the uncertainty of
the external-film estimate, so temperature-dependent properties are not
worth their cost here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ics_wt_physicsengine_torch.sensors.types import SampleLine

# Water at 20 °C (CRC Handbook of Chemistry and Physics)
RHO_WATER = 998.2        # [kg/m^3]
MU_WATER = 1.002e-3      # [Pa s]
K_WATER = 0.598          # [W/m K]
CP_WATER = 4184.0        # [J/kg K]
PR_WATER = MU_WATER * CP_WATER / K_WATER   # ~7.01

NU_LAMINAR = 3.66        # fully developed, constant wall temperature
RE_LAMINAR = 2300.0      # transition bounds for the blend
RE_TURBULENT = 4000.0


def reynolds(velocity_m_s: float, diameter_m: float) -> float:
    """Pipe Reynolds number for water at 20 degC."""
    return RHO_WATER * velocity_m_s * diameter_m / MU_WATER


def nusselt(re: float, pr: float = PR_WATER) -> float:
    """Internal-flow Nusselt number: laminar constant (3.66) below
    Re=2300, Dittus-Boelter (cooling exponent 0.3) above Re=4000,
    linear blend between — continuous across the transition."""
    nu_turb = 0.023 * re ** 0.8 * pr ** 0.3
    if re <= RE_LAMINAR:
        return NU_LAMINAR
    if re >= RE_TURBULENT:
        return nu_turb
    w = (re - RE_LAMINAR) / (RE_TURBULENT - RE_LAMINAR)
    nu_t4000 = 0.023 * RE_TURBULENT ** 0.8 * pr ** 0.3
    return (1.0 - w) * NU_LAMINAR + w * nu_t4000


@dataclass
class LineThermalConfig:
    """Tubing installation for the derived heat-transfer model.

    Defaults describe the ubiquitous 1/4" PFA sample line: 4.8 mm bore,
    1.6 mm wall, k=0.19 W/m K (PTFE-family), bare in still air
    (h_ext ~ 10 W/m^2 K natural convection)."""

    inner_diameter_m: float = 4.8e-3
    wall_thickness_m: float = 1.6e-3
    wall_conductivity_w_mk: float = 0.19
    external_h_w_m2k: float = 10.0
    insulation_thickness_m: float = 0.0
    insulation_conductivity_w_mk: float = 0.04   # mineral wool / foam

    def __post_init__(self):
        if self.inner_diameter_m <= 0 or self.wall_thickness_m < 0:
            raise ValueError("tube geometry must be positive")
        if self.external_h_w_m2k <= 0:
            raise ValueError("external film coefficient must be positive")


def overall_U(config: LineThermalConfig, velocity_m_s: float) -> float:
    """Overall heat-transfer coefficient referenced to the INNER area
    [W/m^2 K]: internal film + wall conduction (+ insulation) + external
    film in series (cylindrical resistances)."""
    d_i = config.inner_diameter_m
    d_o = d_i + 2.0 * config.wall_thickness_m
    re = reynolds(velocity_m_s, d_i)
    h_i = nusselt(re) * K_WATER / d_i

    r_int = 1.0 / h_i
    r_wall = d_i * math.log(d_o / d_i) / (2.0 * config.wall_conductivity_w_mk)
    d_ins = d_o + 2.0 * config.insulation_thickness_m
    r_ins = 0.0
    if config.insulation_thickness_m > 0:
        r_ins = d_i * math.log(d_ins / d_o) / (
            2.0 * config.insulation_conductivity_w_mk)
    r_ext = d_i / (d_ins * config.external_h_w_m2k)
    return 1.0 / (r_int + r_wall + r_ins + r_ext)


def line_ntu(config: LineThermalConfig, length_m: float,
             flow_rate_L_s: float) -> float:
    """NTU = U*A_i / (mdot*cp) for the line's wetted inner area."""
    if flow_rate_L_s <= 0:
        return float("inf")          # stagnant: full equilibration
    d_i = config.inner_diameter_m
    area = math.pi * d_i * length_m
    velocity = (flow_rate_L_s * 1e-3) / (math.pi * (d_i / 2.0) ** 2)
    mdot = RHO_WATER * flow_rate_L_s * 1e-3
    return overall_U(config, velocity) * area / (mdot * CP_WATER)


def outlet_temperature(t_in, t_ambient, ntu):
    """Steady plug-flow solution T_out = T_amb + (T_in-T_amb)e^-NTU
    (pure arithmetic: floats, NumPy arrays or tensors for the
    temperatures)."""
    try:
        decay = math.exp(-ntu)
    except OverflowError:            # pragma: no cover
        decay = 0.0
    return t_ambient + (t_in - t_ambient) * decay


def outlet_value(value_in, k_line_per_s, residence_s):
    """First-order in-line sample decay (wall demand + bulk reaction):
    value_out = value_in * e^(-k*tau)."""
    return value_in * math.exp(-k_line_per_s * residence_s)


@dataclass
class PhysicalSampleLine(SampleLine):
    """SampleLine with DERIVED heat transfer and optional in-line sample
    decay — closes reference README.md:531. Drop-in: same
    ``transport_sample(value, temp, timestamp) -> (value', temp')``
    contract; only the relaxation-rate provenance changes.

    ``length_m`` fixes the geometry: the inherited ``volume_mL`` is
    recomputed from the bore area so delay and thermal models describe
    the SAME piece of tubing. ``line_decay_rate_per_s``: first-order
    loss of the measured species in the line (0 = conservative species;
    for chlorine use TemperatureDependentKinetics.decay_rate plus wall
    demand)."""

    length_m: float = 5.0
    thermal: LineThermalConfig = field(default_factory=LineThermalConfig)
    line_decay_rate_per_s: float = 0.0

    def __post_init__(self):
        area = math.pi * (self.thermal.inner_diameter_m / 2.0) ** 2
        self.volume_mL = area * self.length_m * 1e6
        super().__post_init__()
        self.ntu = line_ntu(self.thermal, self.length_m,
                            self.flow_rate_L_s)
        # effective first-order rate per second of residence, for
        # comparison against the reference's hard-coded 0.1/s
        self.thermal_rate_per_s = (
            self.ntu / self.transport_delay_s
            if self.transport_delay_s > 0 else float("inf"))

    def transport_sample(self, value: float, temp: float,
                         timestamp: float):
        self.add_sample(value, temp, timestamp)
        target_time = timestamp - self.transport_delay_s
        delayed_time, delayed_value, delayed_temp = min(
            self._delay_buffer, key=lambda s: abs(s[0] - target_time))
        residence = timestamp - delayed_time
        # heat exchange over the ACTUAL residence (fraction of the line
        # traversed), scaling the full-line NTU
        frac = (residence / self.transport_delay_s
                if self.transport_delay_s > 0 else 1.0)
        actual_temp = outlet_temperature(delayed_temp, self.ambient_temp,
                                         self.ntu * min(frac, 1.0))
        actual_value = outlet_value(delayed_value,
                                    self.line_decay_rate_per_s, residence)
        return actual_value, actual_temp


def validate_sample_line() -> bool:
    """Literature/structural checks (reference validate_* style):

    1. laminar Nu = 3.66 (Incropera Table 8.1);
    2. Dittus-Boelter at Re=10^4, Pr=7: Nu = 0.023*10^4^0.8*7^0.3 ~ 65;
    3. correlation continuous across the transition blend;
    4. NTU -> 0: outlet = inlet; NTU large: outlet = ambient;
    5. insulation reduces U; higher flow reduces per-pass approach
       (less residence, higher NTU denominator);
    6. conservative species (k=0) transported unchanged;
    7. the derived rate for the default bare 1/4" line at 500 mL/min is
       ~0.003/s — the reference's assumed 0.1/s (base_sensor.py:212)
       overstates sample-line heat loss by >30x for typical tubing, and
       the assumed constant cannot respond to insulation at all.
    """
    ok = True
    ok &= abs(nusselt(1000.0) - 3.66) < 1e-12
    nu_db = 0.023 * 1e4 ** 0.8 * PR_WATER ** 0.3
    ok &= abs(nusselt(1e4) - nu_db) / nu_db < 1e-12
    ok &= abs(nusselt(RE_TURBULENT - 1e-6)
              - nusselt(RE_TURBULENT + 1e-6)) < 1e-3
    ok &= abs(nusselt(RE_LAMINAR - 1e-6)
              - nusselt(RE_LAMINAR + 1e-6)) < 1e-3

    cfg = LineThermalConfig()
    ok &= abs(outlet_temperature(30.0, 20.0, 0.0) - 30.0) < 1e-12
    ok &= abs(outlet_temperature(30.0, 20.0, 50.0) - 20.0) < 1e-9

    u_bare = overall_U(cfg, 0.5)
    u_ins = overall_U(LineThermalConfig(insulation_thickness_m=0.01), 0.5)
    ok &= u_ins < u_bare

    ntu_slow = line_ntu(cfg, 5.0, 250.0 / 1000.0 / 60.0)
    ntu_fast = line_ntu(cfg, 5.0, 1000.0 / 1000.0 / 60.0)
    ok &= ntu_fast < ntu_slow            # faster flow: less approach

    ok &= abs(outlet_value(1.2, 0.0, 60.0) - 1.2) < 1e-12

    line = PhysicalSampleLine(flow_rate_mL_min=500.0, length_m=5.0)
    ok &= 0.001 < line.thermal_rate_per_s < 1.0
    insulated = PhysicalSampleLine(
        flow_rate_mL_min=500.0, length_m=5.0,
        thermal=LineThermalConfig(insulation_thickness_m=0.01))
    ok &= insulated.thermal_rate_per_s < line.thermal_rate_per_s
    return bool(ok)
