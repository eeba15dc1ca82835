"""
The contact tank's parameters, initial state and forcing terms, worked out
from a configuration file in float64 NumPy.

A plain restatement of the tank's published formulas (geometry, Corrsin
mixing, Stokes-Einstein diffusion, van 't Hoff and linear pKa laws, the
Arrhenius chlorine decay), written from the configuration alone: it takes
nothing that the program under test has made. Monte-Carlo plants are drawn
with ``numpy.random.default_rng(seed)`` in the order the configuration's
``monte_carlo.ranges`` lists them, then the alkalinity ratio.
"""

from __future__ import annotations

import math

import numpy as np

LN10 = math.log(10.0)
R_GAS = 8.314
T_REFERENCE_K = 293.15
T_25C_K = 298.15
CL_DECAY_K_REF = 1.0e-4
CL_DECAY_EA = 45000.0
DELTA_H_WATER = 55900.0
KW_25C = 1.0e-14
PKA1_25C, PKA2_25C, DPKA_DT = 6.35, 10.33, -0.008
PKA_HOCL_25C, DPKA_HOCL_DT = 7.5, 0.01
K_OCL_RELATIVE = 0.02
D_MOLECULAR_REF = 1.0e-9
VISCOSITY_EXP_COEFF = 1800.0
D_TURB_COEFF = 0.1
G_GRAVITY = 9.81
WATER_DENSITY_20C = 998.2
THERMAL_EXPANSION_COEFF = 2.1e-4
DENSITY_ANOMALY_COEFF = 0.008
RHO_MAX_4C = 999.97
WATER_CP = 4184.0

# The per-plant parameters the physics reads, each a [B] float64 array.
PARAM_NAMES = (
    "volume_L", "zone_volume_L", "zone_height", "heat_area_m2",
    "k_exchange", "velocity_scale", "cl_k_ref", "cl_ea",
    "Kw", "Ka1", "Ka2", "Ka_HOCl", "C_T_mol",
    "strat_enabled", "ri_crit", "supp_factor",
)
BOUNDARY_NAMES = (
    "inlet_flow_rate", "inlet_pH", "inlet_chlorine", "inlet_temperature",
    "acid_flow_rate", "acid_concentration",
    "chlorine_flow_rate", "chlorine_concentration",
    "ambient_temperature", "heat_loss_coefficient",
)


def sample_plants(config: dict, n_plants: int, seed: int,
                  randomize: bool = True) -> dict:
    """The configuration's reactor fields as ``[n_plants]`` float64 arrays:
    the Monte-Carlo ranges drawn from ``seed`` when ``randomize``, the
    published values otherwise."""
    reactor = config["reactor"]
    fields = {k: np.full(n_plants, float(v)) for k, v in reactor.items()
              if isinstance(v, (int, float)) and not isinstance(v, bool)}
    if randomize:
        mc = config["monte_carlo"]
        rng = np.random.default_rng(seed)
        for name, (lo, hi) in mc["ranges"].items():
            fields[name] = rng.uniform(lo, hi, n_plants)
        if "alkalinity" not in mc["ranges"]:
            ratio = rng.uniform(*mc["alkalinity_ratio"], n_plants)
            fields["alkalinity"] = ratio * 50.0 * fields["total_carbonate"]
    return fields


def reactor_params(config: dict, plants: dict) -> dict:
    """The physics parameters of each plant (``PARAM_NAMES``)."""
    r = config["reactor"]
    z = int(r["n_zones"])
    volume, height, diameter = (plants["volume"], plants["height"],
                                plants["diameter"])
    area = math.pi * (diameter / 2.0) ** 2
    zone_height = height / z
    zone_volume = volume / z
    velocity = (plants["flow_rate"] / 60000.0) / area
    n_rps = plants["impeller_speed"] / 60.0
    d_imp = plants["impeller_diameter"]
    t_k = np.clip(plants["temperature"], 0.0, 100.0) + 273.15
    viscosity_ratio = np.exp(-(VISCOSITY_EXP_COEFF
                               * (1.0 / t_k - 1.0 / T_REFERENCE_K)))
    d_eff = D_TURB_COEFF * n_rps * d_imp ** 2 \
        + D_MOLECULAR_REF * (t_k / T_REFERENCE_K) * viscosity_ratio
    k_exchange = (d_eff * area / zone_height) / (zone_volume / 1000.0)
    temp = plants["temperature"]
    ones = np.ones_like(volume)
    strat = 1.0 if r.get("enable_thermal_stratification", True) else 0.0
    return dict(
        volume_L=volume, zone_volume_L=volume / z, zone_height=zone_height,
        heat_area_m2=math.pi * diameter * height
        + 2 * math.pi * (diameter / 2) ** 2,
        k_exchange=k_exchange, velocity_scale=velocity,
        cl_k_ref=CL_DECAY_K_REF * ones, cl_ea=CL_DECAY_EA * ones,
        Kw=KW_25C * np.exp((DELTA_H_WATER / R_GAS)
                           * (1.0 / T_25C_K - 1.0 / t_k)),
        Ka1=10.0 ** (-(PKA1_25C + DPKA_DT * (temp - 25.0))),
        Ka2=10.0 ** (-(PKA2_25C + DPKA_DT * (temp - 25.0))),
        Ka_HOCl=10.0 ** (-(PKA_HOCL_25C + DPKA_HOCL_DT * (temp - 25.0))),
        C_T_mol=plants["total_carbonate"] / 1000.0,
        strat_enabled=strat * ones, ri_crit=0.25 * ones,
        supp_factor=0.5 * ones)


def initial_state(config: dict, plants: dict) -> dict:
    """``pH``, ``chlorine``, ``temperature`` as ``[B, Z]`` float64 arrays
    and each plant's clock ``time`` ``[B]`` (0)."""
    z = int(config["reactor"]["n_zones"])

    def field(v):
        return np.repeat(np.asarray(v, np.float64)[:, None], z, axis=1)

    return dict(pH=field(plants["initial_pH"]),
                chlorine=field(plants["initial_chlorine"]),
                temperature=field(plants["temperature"]),
                time=np.zeros(len(plants["initial_pH"])))


def boundary_terms(p: dict, b: dict, xp) -> dict:
    """The source terms of one forcing ``b`` (values or ``[B]`` arrays)
    for parameters ``p`` (``[B, 1]`` columns)."""
    return dict(
        q_per_v=(b["inlet_flow_rate"] / 60.0) / p["volume_L"],
        h_inlet=xp.exp(-LN10 * xp.asarray(b["inlet_pH"])),
        cl_inlet=xp.asarray(b["inlet_chlorine"]),
        t_inlet=xp.asarray(b["inlet_temperature"]),
        dh_dosing=(b["acid_flow_rate"] / 60.0) * b["acid_concentration"]
        / p["zone_volume_L"],
        dcl_dosing=(b["chlorine_flow_rate"] / 60.0) / p["zone_volume_L"]
        * b["chlorine_concentration"],
        t_amb=xp.asarray(b["ambient_temperature"]),
        heat_rate=b["heat_loss_coefficient"] * p["heat_area_m2"]
        / (WATER_DENSITY_20C * WATER_CP * (p["volume_L"] / 1000.0)),
    )
