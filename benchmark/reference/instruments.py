"""
The instrumented contact tank, plain NumPy: the tank of ``physics`` read
every step by the configuration's instruments.

Each instrument reads one value a step through the same pipeline: a supply
voltage that jitters around 24 V and latches a power fault once it leaves
(20, 28) V; a warm-up gate; calibration drift and expiry; white noise and
a first-order lag; the installation's extra noises and air bubbles; a
rate-of-change check; random open or short circuits (1e-4 a read); the
fault and status lattice; then its own overlay (glass electrode fouling
and slope for pH, membrane or DPD reagent for chlorine, electrode fouling
for a magnetic flow meter, an RTD's bridge for temperature).

Sample lines: a sensor with a line reads the value its zone had ``d =
round(delay / dt)`` steps before; for the first ``d`` reads of a rollout
that value comes from the ring the previous rollout handed on (the sample
nearest in time to ``now - delay``; ``lead_in``), and with no such sample
the rollout's own first sample stands in.

Codes: faults NONE 0, OPEN_CIRCUIT 1, SHORT_CIRCUIT 2, OUT_OF_RANGE 3,
RATE_FAULT 4, POWER_LOW 5, POWER_HIGH 6; statuses NORMAL 0, CALIBRATING 1,
WARMING_UP 2, FAILED 3, SATURATED 4, DRIFT_WARNING 5, CALIBRATION_EXPIRED
6, OPEN_CIRCUIT 7, SHORT_CIRCUIT 8, OUT_OF_RANGE 9, POWER_FAULT 10,
RATE_OF_CHANGE_FAULT 11: the program's published encoding of its readings.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import philox, physics

F_NONE, F_OPEN, F_SHORT, F_OOR, F_RATE, F_PLOW, F_PHIGH = range(7)
S_NORMAL, S_WARMING, S_FAILED, S_SATURATED = 0, 2, 3, 4
S_DRIFT, S_CALEXP, S_OOR, S_POWER, S_RATE = 5, 6, 9, 10, 11
FAULT_NAMES = ("NONE", "OPEN_CIRCUIT", "SHORT_CIRCUIT", "OUT_OF_RANGE",
               "RATE_FAULT", "POWER_LOW", "POWER_HIGH")
STATUS_NAMES = ("NORMAL", "CALIBRATING", "WARMING_UP", "FAILED",
                "SATURATED", "DRIFT_WARNING", "CALIBRATION_EXPIRED",
                "OPEN_CIRCUIT", "SHORT_CIRCUIT", "OUT_OF_RANGE",
                "POWER_FAULT", "RATE_OF_CHANGE_FAULT")

# Normals and uniforms a read takes, by kind: the five base normals
# (supply, noise, stagnation, grounding, vibration) and three base
# uniforms (bubble, fault roll, fault type) first, then the overlay's.
DRAWS = {"ph": (8, 3), "chlorine": (7, 3), "flow": (6, 4),
         "temperature": (7, 3)}

OVERLAY_CARRY = {
    "ph": dict(membrane_fouling=0.0, glass_etching=0.0,
               days_since_cleaning=0.0, water_hardness=100.0,
               reference_contamination=0.0, slope_percentage=100.0,
               cal_point_1=4.0, cal_point_2=7.0),
    "chlorine": dict(membrane_fouling=0.0, membrane_age_days=0.0,
                     electrode_polarization=0.0, reagent_potency=1.0,
                     reagent_age_days=0.0, light_exposure_hours=0.0,
                     storage_temperature=20.0),
    "flow": dict(bearing_friction=0.01, bearing_wear_days=0.0,
                 electrode_fouling=0.0, fluid_conductivity=100.0),
    "temperature": dict(cold_junction_temp=25.0, cold_junction_drift=0.0),
}
FLOAT_CARRY = ("current_value", "supply_voltage", "power_on_time",
               "calibration_offset", "last_calibration_time",
               "calibration_validity_hours", "last_value", "last_timestamp")


def word_offsets(instruments) -> list:
    """Each instrument's first word in a step: ``2 * ceil(normals / 2) +
    uniforms`` words each, in the configuration's order."""
    offsets, off = [], 0
    for ins in instruments:
        n, m = DRAWS[ins["kind"]]
        offsets.append(off)
        off += 2 * ((n + 1) // 2) + m
    if off != philox.WORDS:
        raise ValueError(f"the instruments take {off} words a step, "
                         f"not {philox.WORDS}")
    return offsets


def line_delay_s(config: dict) -> float:
    line = config["sample_line"]
    return (line["volume_mL"] / 1000.0) / (line["flow_mL_min"] / 1000.0
                                            / 60.0)


def sensor_params(config: dict) -> list:
    """Per instrument a dict of its parameters (Python floats)."""
    inst = config["installation"]
    out = []
    for ins in config["instruments"]:
        lo, hi = ins["range"]
        if ins["kind"] == "flow" and ins.get("full_scale_of_flow"):
            hi = ins["full_scale_of_flow"] * config["reactor"]["flow_rate"]
        p = dict(ins, min_value=float(lo), max_value=float(hi),
                 drift_rate=ins.get("drift_per_day", 0.0) / 24.0,
                 **{k: float(v) for k, v in inst.items()})
        if ins["kind"] == "flow":
            p["full_scale"] = hi
            p["precision"] = ins["precision_of_full_scale"] * hi
            p["max_rate"] = ins["max_rate_of_full_scale"] * hi
        out.append(p)
    return out


def initial_carries(config: dict, sparams: list, n_plants: int,
                    t0: float = 0.0) -> list:
    """Fresh carries of every instrument, warmed up: power on
    ``warmup + 1`` s before ``t0`` and calibrated at ``t0``."""
    out = []
    for sp in sparams:
        full = np.full
        c = dict(current_value=full(n_plants, sp["initial_value"]),
                 supply_voltage=full(n_plants, 24.0),
                 power_on_time=full(n_plants, t0 - sp["warmup_s"] - 1.0),
                 calibration_offset=full(n_plants, 0.0),
                 last_calibration_time=full(n_plants, t0),
                 calibration_validity_hours=full(n_plants, 24.0),
                 has_calibration=np.ones(n_plants, bool),
                 status=np.zeros(n_plants, np.int64),
                 fault=np.zeros(n_plants, np.int64),
                 last_value=full(n_plants, math.nan),
                 last_timestamp=full(n_plants, -1.0),
                 has_history=np.zeros(n_plants, bool))
        c.update({k: full(n_plants, v)
                  for k, v in OVERLAY_CARRY[sp["kind"]].items()})
        out.append(c)
    return out


def lead_in(ring: dict, delay: float, d: int, t0, dt: float) -> np.ndarray:
    """``[d, B]``: for each of the first ``d`` reads of a rollout, the
    incoming ring's sample nearest in time to the read's ``now - delay``
    (ties to the lower slot), where it is nearer than the rollout's own
    first sample and not yet overwritten by the rollout's appends; NaN
    otherwise."""
    lv = np.asarray(ring["line_values"], np.float64)
    lt = np.asarray(ring["line_times"], np.float64)
    count = np.asarray(ring["line_count"], np.int64)
    ptr = np.asarray(ring["line_ptr"], np.int64)
    b, cap = lv.shape
    g = np.arange(d)[:, None]
    target = np.asarray(t0, np.float64)[None, :] + (g + 1.0) * dt - delay
    s = np.arange(cap)[None, :]
    overwrite = np.remainder(s - ptr[:, None], cap)
    alive = (s < count[:, None])[None] & (overwrite[None] > g[:, :, None])
    dist = np.where(alive, np.abs(lt[None] - target[..., None]), math.inf)
    slot = np.argmin(dist, axis=-1)
    nearest = np.take_along_axis(dist, slot[..., None], -1)[..., 0]
    own = np.abs(delay - g * dt)
    use = (nearest < own) | ((nearest == own) & (slot < ptr[None, :]))
    vals = np.take_along_axis(np.broadcast_to(lv[None], (d, b, cap)),
                              slot[..., None], -1)[..., 0]
    return np.where(use, vals, math.nan)


def _base_read(sp, c, true_value, t, n, u, xp):
    """The shared pipeline; returns ``(carry', value, status, fault,
    had_history, last_timestamp_before)``."""
    cv, v0 = c["current_value"], c["supply_voltage"]
    power_bad = ~((20.0 < v0) & (v0 < 28.0))
    power_code = np.where(v0 <= 20.0, F_PLOW, F_PHIGH)
    supply = xp.where(power_bad, v0, 24.0 + n[0])
    warming = (t - c["power_on_time"]) < sp["warmup_s"]
    normal = ~power_bad & ~warming
    cal_age_h = (t - c["last_calibration_time"]) / 3600.0
    cal_expired = ~c["has_calibration"] \
        | (cal_age_h > c["calibration_validity_hours"])
    drift = sp["drift_rate"] * cal_age_h + c["calibration_offset"]
    prec = sp["precision"]
    value = 0.5 * (true_value + n[1] * prec + drift) + (1.0 - 0.5) * cv
    zero = xp.asarray(0.0)
    value = value + xp.where(sp["flow_velocity"] < 0.1, n[2] * prec * 2.0,
                             zero)
    value = value + xp.where(sp["grounding_quality"] < 0.8, n[3] * prec
                             * (2.0 - sp["grounding_quality"]), zero)
    value = value + xp.where(sp["pipe_vibration_g"] > 0.2, n[4]
                             * sp["pipe_vibration_g"] * prec, zero)
    bubble = (sp["air_bubble_frequency"] > 0) \
        & (u[0] < sp["air_bubble_frequency"] / 60.0)
    value = xp.where(bubble, math.nan, value)

    dt_hist = t - c["last_timestamp"]
    rate = xp.where(c["has_history"] & (dt_hist > 0)
                    & np.isfinite(c["last_value"]),
                    (value - c["last_value"]) / xp.maximum(dt_hist, 1e-30),
                    zero)
    lo, hi = sp["min_value"], sp["max_value"]
    span = hi - lo
    post_bad = ~((20.0 < supply) & (supply < 28.0))
    fault = np.where(
        post_bad, np.where(supply <= 20.0, F_PLOW, F_PHIGH),
        np.where((value < lo - 0.1 * span) | (value > hi + 0.1 * span),
                 F_OOR,
                 np.where(np.abs(rate) > sp["max_rate"], F_RATE,
                          np.where(u[1] < 1e-4,
                                   np.where(u[2] < 0.5, F_OPEN, F_SHORT),
                                   F_NONE))))
    open_short = (fault == F_OPEN) | (fault == F_SHORT)
    has_fault = fault != F_NONE
    bounded = xp.minimum(xp.maximum(value, lo), hi)
    bounded = xp.where(np.isnan(value), value, bounded)
    saturated = ~np.isnan(value) & (bounded != value)
    status_fault = np.where(
        open_short, S_FAILED,
        np.where(fault == F_OOR, S_OOR,
                 np.where((fault == F_PLOW) | (fault == F_PHIGH), S_POWER,
                          S_RATE)))
    prior = np.where(cal_expired, S_CALEXP, c["status"])
    status_ok = np.where(np.isnan(value), prior,
                         np.where(saturated, S_SATURATED,
                                  np.where(cal_expired, S_CALEXP,
                                           S_NORMAL)))
    status_ok = np.where((np.abs(drift) > 0.1 * span)
                         & (status_ok != S_CALEXP), S_DRIFT, status_ok)
    status_norm = np.where(has_fault, status_fault, status_ok)
    value_norm = xp.where(open_short, math.nan,
                          xp.where(has_fault, value, bounded))
    early = power_bad | warming
    out_value = xp.where(early, math.nan, value_norm)
    out_status = np.where(power_bad, S_POWER,
                          np.where(warming, S_WARMING, status_norm))
    out_fault = np.where(power_bad, power_code,
                         np.where(warming, F_NONE, fault))
    new = dict(c, current_value=xp.where(normal, value_norm, cv),
               supply_voltage=supply,
               status=np.where(normal, status_norm, c["status"]),
               fault=np.where(normal, out_fault, c["fault"]),
               last_value=out_value, last_timestamp=t + 0.0 * out_value,
               has_history=np.ones_like(c["has_history"]))
    return new, out_value, out_status, out_fault


def read(sp, c, true_value, t, n, u, temp, xp):
    """One read of instrument ``sp`` with carry ``c``; ``temp`` is the
    tapped zone's temperature (the pH electrode's fouling rate). Returns
    ``(carry', value, status, fault)``."""
    prev_ts, had_prev = c["last_timestamp"], c["has_history"]
    new, value0, status, fault = _base_read(sp, c, true_value, t, n, u, xp)
    finite = np.isfinite(value0)
    dt = xp.maximum(t - prev_ts, 0.0)
    update = had_prev & finite
    kind, lo, hi = sp["kind"], sp["min_value"], sp["max_value"]
    if kind == "ph":
        bio = xp.where(c["membrane_fouling"] > 0.05,
                       0.1 * xp.exp(0.05 * (temp - 25.0)),
                       xp.asarray(0.001))
        scaling = xp.where(sp["flow_velocity"] < 0.1,
                           c["water_hardness"] * 1e-4,
                           c["water_hardness"] * 1e-5)
        fouling = xp.where(update, xp.minimum(
            c["membrane_fouling"] + (bio + scaling) * dt / 86400.0, 1.0),
            c["membrane_fouling"])
        days_clean = xp.where(update, c["days_since_cleaning"]
                              + dt / 86400.0, c["days_since_cleaning"])
        electrical = n[5] * 0.002 * (1.0 + 0.1 * xp.abs(value0 - 7.0))
        junction = n[6] * 0.005 * (1.0 + c["reference_contamination"])
        days_cal = xp.where(new["has_calibration"],
                            (t - new["last_calibration_time"]) / 86400.0,
                            xp.asarray(0.0))
        slope = xp.where(new["has_calibration"] & finite,
                         xp.maximum(100.0 - 0.001 * days_cal, 90.0),
                         c["slope_percentage"])
        p1, p2 = c["cal_point_1"], c["cal_point_2"]
        distance = xp.minimum(xp.abs(value0 - p1), xp.abs(value0 - p2))
        slope_error = xp.where((p1 < value0) & (value0 < p2),
                               xp.asarray(0.0),
                               distance * (100.0 - slope) / 100.0)
        contamination = xp.where(finite, xp.minimum(
            c["reference_contamination"] + 0.0001 * (days_cal / 30.0), 0.5),
            c["reference_contamination"])
        final = value0 + electrical + junction + slope_error \
            + fouling * 0.2 + n[7] * (fouling * 0.05) + contamination * 0.1
        final = xp.minimum(xp.maximum(final, lo), hi)
        new.update(membrane_fouling=fouling, days_since_cleaning=days_clean,
                   reference_contamination=contamination,
                   slope_percentage=slope)
    elif kind == "chlorine" and sp["type"] == "amperometric":
        rate = 0.05 if sp["flow_velocity"] < 0.1 else 0.01
        fouling = xp.where(update, xp.minimum(
            c["membrane_fouling"] + rate * dt / 86400.0, 1.0),
            c["membrane_fouling"])
        age = xp.where(update, c["membrane_age_days"] + dt / 86400.0,
                       c["membrane_age_days"])
        final = (value0 + 0.0) * (1.0 - 0.8 * fouling) \
            + n[5] * 0.005 * (1.0 + age / 365.0) + n[6] * 0.003
        final = xp.minimum(xp.maximum(final, lo), hi)
        new.update(membrane_fouling=fouling, membrane_age_days=age)
    elif kind == "chlorine":            # DPD colorimetric
        thermal = xp.exp((50000.0 / 8.314) * (
            1.0 / 293.15 - 1.0 / (c["storage_temperature"] + 273.15)))
        light = xp.where(update, c["light_exposure_hours"] + dt / 3600.0,
                         c["light_exposure_hours"])
        degradation = thermal * (1.0 + 0.1 * (light / 100.0)) * 0.01
        potency = xp.where(update, xp.maximum(
            c["reagent_potency"] - degradation * dt / 86400.0, 0.0),
            c["reagent_potency"])
        age = xp.where(update, c["reagent_age_days"] + dt / 86400.0,
                       c["reagent_age_days"])
        final = value0 * potency * 0.95 + n[5] * 0.005
        final = xp.minimum(xp.maximum(final, lo), hi)
        new.update(light_exposure_hours=light, reagent_potency=potency,
                   reagent_age_days=age)
    elif kind == "flow":                # magnetic
        fs = sp["full_scale"]
        fouling = xp.where(update, c["electrode_fouling"]
                           + 0.001 * dt / 86400.0, c["electrode_fouling"])
        cond = c["fluid_conductivity"]
        cond_factor = xp.where(cond < 5.0, xp.asarray(0.0),
                               xp.where(cond < 20.0, cond / 20.0,
                                        xp.asarray(1.0)))
        final = value0 * xp.maximum(1.0 - 0.005 * fouling, 0.9) \
            * cond_factor + n[5] * 0.001 * fs
        bubble = (sp["air_bubble_frequency"] > 0) \
            & (u[3] < sp["air_bubble_frequency"] / 60.0)
        final = xp.where(bubble, xp.asarray(0.0), final)
        final = xp.where(final < 0.01 * fs, xp.asarray(0.0), final)
        final = xp.minimum(xp.maximum(final, 0.0), hi)
        new.update(electrode_fouling=fouling)
    else:                               # RTD
        r0 = sp["nominal_resistance"]
        r_meas = r0 * (1.0 + sp["rtd_alpha"] * value0) \
            + 2.0 * sp["lead_resistance"]
        i_a = sp["excitation_current_mA"] / 1000.0
        final = (r_meas / r0 - 1.0) / sp["rtd_alpha"] \
            + sp["self_heating_C_per_mW"] * ((i_a * i_a) * r_meas * 1000.0) \
            + n[5] * 0.001
        final = final + 0.01 * (value0 - sp["ambient_temperature"])
        final = xp.minimum(xp.maximum(final, lo), hi)
    value = xp.where(finite, final, value0)
    new.update(current_value=xp.where(finite, value, new["current_value"]),
               last_value=value)
    return new, value, status, fault


def plant_rollout(config: dict, rparams: dict, state: dict, carries: list,
                  leads: list, boundary: dict, *, integ: dict, n_steps: int,
                  seed: int, step0, plant_ids, record_every: int,
                  xp) -> dict:
    """``n_steps`` steps of ``integ`` (``physics.integrator``) of the
    instrumented plants under the constant ``boundary`` (scalars or
    ``[B]`` arrays). ``state``: ``pH``,
    ``chlorine``, ``temperature`` ``[B, Z]`` and ``time`` ``[B]``;
    ``carries``: per instrument its carry; ``leads``: per instrument the
    ``[d, B]`` lead-in of its sample line (``lead_in``) or None; ``step0``
    and ``plant_ids``: each plant's global step and plant counters.

    Returns the final ``state`` and ``carries``, and the readings
    ``values`` ``[n_steps // record_every, K, B]``, ``faults`` (the same,
    int) and ``status`` of the last read ``[K, B]``."""
    instruments = config["instruments"]
    sparams = sensor_params(config)
    offsets = word_offsets(instruments)
    p = physics.columns(rparams, xp)
    deriv, b = physics.make_deriv(p, xp), physics.forcing(p, boundary, xp)
    step, dt = physics.stepper(integ, xp), integ["dt"]
    flow_total = xp.asarray(np.asarray(boundary["inlet_flow_rate"])
                            + np.asarray(boundary["acid_flow_rate"])
                            + np.asarray(boundary["chlorine_flow_rate"]))
    step0 = np.asarray(step0, np.int64)
    steps = step0[None, :] + np.arange(n_steps)[:, None]
    w = philox.words(seed, steps, np.asarray(plant_ids, np.int64))
    rand = []
    for off, ins in zip(offsets, instruments):
        nn, nu = DRAWS[ins["kind"]]
        k = 2 * ((nn + 1) // 2) + nu
        rand.append(philox.draws(np.moveaxis(w[:, off:off + k], 1, 0),
                                 nn, nu, xp))
    d = int(round(line_delay_s(config) / dt))

    y = physics.stack_state(state, xp)
    time = xp.asarray(state["time"])
    carries = [{k: (xp.asarray(v) if k in FLOAT_CARRY or
                    np.asarray(v).dtype.kind == "f" else np.asarray(v))
                for k, v in c.items()} for c in carries]
    taps = [[] for _ in instruments]      # each line's samples so far
    rows, fault_rows = [], []
    status = None
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for g in range(n_steps):
            y = step(deriv, y, b)
            time = time + dt
            values, faults, statuses = [], [], []
            for i, (ins, sp) in enumerate(zip(instruments, sparams)):
                kind = ins["kind"]
                z = ins.get("zone", 0)
                temp = y[2][:, z]
                if kind == "ph":
                    tap = y[0][:, z] + sp["temperature_coefficient"] \
                        * (temp - 25.0)
                elif kind == "chlorine":
                    ratio = 10.0 ** (7.5 - y[0][:, z])
                    tap = y[1][:, z] * (0.5 + 0.5 * (ratio / (1.0 + ratio)))
                elif kind == "flow":
                    tap = flow_total + 0.0 * temp
                else:
                    tap = temp
                if ins.get("sample_line") and d > 0:
                    taps[i].append(tap)
                    if g < d:
                        lead = leads[i][g] if leads[i] is not None \
                            else np.full(len(tap), math.nan)
                        tap = xp.where(np.isnan(lead), taps[i][0], lead)
                    else:
                        tap = taps[i][g - d]
                nrm = [x[g] for x in rand[i][0]]
                uni = [x[g] for x in rand[i][1]]
                carries[i], v, s, f = read(sp, carries[i], tap, time, nrm,
                                           uni, temp, xp)
                values.append(v)
                faults.append(f)
                statuses.append(s)
            if (g + 1) % record_every == 0:
                rows.append(np.stack([np.asarray(v, np.float64)
                                      for v in values]))
                fault_rows.append(np.stack(faults))
            status = np.stack(statuses)
    final = {k: np.asarray(v, np.float64)
             for k, v in zip(physics.FIELDS, y)}
    final["time"] = np.asarray(time, np.float64)
    return dict(state=final, carries=carries,
                values=np.stack(rows), faults=np.stack(fault_rows),
                status=status)
