// The seven-instrument suite of the fused plant kernel (B3): the base
// sensor pipeline and the pH, chlorine, flow and temperature overlays as
// device functions, one thread per (plant, sensor).
//
// A read is split in two: the kind's true value, then base_read, which
// every kind shares, then the kind's overlay on the base reading. A warp
// whose lanes read sensors of different kinds so runs base_read once,
// converged, and diverges only for the overlays.
//
// Each function repeats ics_wt_physicsengine_torch/sensors/{base,ph,
// chlorine,flow,temperature}.py operation by operation and in the same
// order, with every constant folded in double and cast to the working type,
// so that under -fmad=false it rounds as the plain PyTorch version does.
// The sample line is resolved outside (fused_plant.cu), as with
// line_capacity = 0 params and the delayed_true hook.
//
// NaN must pass through min, max and clip here as it does through
// jnp.clip / torch.clamp: a bubble or a latched open circuit stays NaN.
// CUDA's fminf / fmaxf drop a NaN, so this file has its own versions.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fused_rollout.cuh"

namespace wt {

// sensors/types.py: STATUS_CODE and FAULT_CODE (enumeration order).
enum StatusCode {
  kStatusNormal = 0, kStatusCalibrating = 1, kStatusWarmingUp = 2,
  kStatusFailed = 3, kStatusSaturated = 4, kStatusDriftWarning = 5,
  kStatusCalibrationExpired = 6, kStatusOpenCircuit = 7,
  kStatusShortCircuit = 8, kStatusOutOfRange = 9, kStatusPowerFault = 10,
  kStatusRateOfChangeFault = 11
};
enum FaultCode {
  kFaultNone = 0, kFaultOpenCircuit = 1, kFaultShortCircuit = 2,
  kFaultOutOfRange = 3, kFaultRateFault = 4, kFaultPowerLow = 5,
  kFaultPowerHigh = 6
};

// Sensor types, uniform over a batch (ops/fused_plant.py::TYPE_CODES).
enum SensorTypeCode {
  kChlorineAmperometric = 0, kChlorineDpd = 1,
  kFlowTurbine = 0, kFlowMagnetic = 1,
  kTemperatureRtd = 0, kTemperatureThermocouple = 1
};

constexpr int kSensors = 7;
constexpr int kLineSensors = 4;
constexpr int kBaseParamCols = 11;
constexpr int kBaseFloatCols = 8;
constexpr int kBaseIntCols = 4;

__device__ __forceinline__ float wlog(float x) { return logf(x); }
__device__ __forceinline__ double wlog(double x) { return log(x); }
__device__ __forceinline__ float wsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double wsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float wcos(float x) { return cosf(x); }
__device__ __forceinline__ double wcos(double x) { return cos(x); }
__device__ __forceinline__ float wsin(float x) { return sinf(x); }
__device__ __forceinline__ double wsin(double x) { return sin(x); }
__device__ __forceinline__ float wpow(float b, float x) { return powf(b, x); }
__device__ __forceinline__ double wpow(double b, double x) {
  return pow(b, x);
}
__device__ __forceinline__ float wabs(float x) { return fabsf(x); }
__device__ __forceinline__ double wabs(double x) { return fabs(x); }

template <typename S>
__device__ __forceinline__ bool is_nan(S x) { return x != x; }
template <typename S>
__device__ __forceinline__ bool is_finite(S x) { return ::isfinite(x); }
template <typename S>
__device__ __forceinline__ S quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// NaN-propagating maximum, minimum and clip.
template <typename S>
__device__ __forceinline__ S nmax(S a, S b) {
  return (is_nan(a) || is_nan(b)) ? a + b : (a > b ? a : b);
}
template <typename S>
__device__ __forceinline__ S nmin(S a, S b) {
  return (is_nan(a) || is_nan(b)) ? a + b : (a < b ? a : b);
}
template <typename S>
__device__ __forceinline__ S nclip(S x, S lo, S hi) {
  return nmin(nmax(x, lo), hi);
}

// The base pipeline's parameters, in ops/fused_plant.py::_BASE_P order.
template <typename S>
struct BaseParams {
  S min_value, max_value, precision, drift_rate, warmup_time_s,
      max_rate_of_change, flow_velocity, air_bubble_frequency,
      grounding_quality, pipe_vibration_g, ambient_temperature;
};

// The base pipeline's carry: the float fields in _BASE_C order, then the
// integer and boolean ones.
template <typename S>
struct BaseCarry {
  S current_value, supply_voltage, power_on_time, calibration_offset,
      last_calibration_time, calibration_validity_hours, last_value,
      last_timestamp;
  bool has_calibration;
  int status, fault;
  bool has_history;
};

template <typename S>
__device__ __forceinline__ BaseParams<S> load_base_params(
    const S* __restrict__ table, int col0, int plant, int batch) {
  auto col = [&](int c) {
    return table[static_cast<int64_t>(col0 + c) * batch + plant];
  };
  return {col(0), col(1), col(2), col(3), col(4), col(5),
          col(6), col(7), col(8), col(9), col(10)};
}

template <typename S>
__device__ __forceinline__ BaseCarry<S> load_base_carry(
    const S* __restrict__ floats, int fcol0, const int* __restrict__ ints,
    int icol0, int plant, int batch) {
  auto f = [&](int c) {
    return floats[static_cast<int64_t>(fcol0 + c) * batch + plant];
  };
  auto i = [&](int c) {
    return ints[static_cast<int64_t>(icol0 + c) * batch + plant];
  };
  BaseCarry<S> c;
  c.current_value = f(0);
  c.supply_voltage = f(1);
  c.power_on_time = f(2);
  c.calibration_offset = f(3);
  c.last_calibration_time = f(4);
  c.calibration_validity_hours = f(5);
  c.last_value = f(6);
  c.last_timestamp = f(7);
  c.has_calibration = i(0) != 0;
  c.status = i(1);
  c.fault = i(2);
  c.has_history = i(3) != 0;
  return c;
}

template <typename S>
__device__ __forceinline__ void store_base_carry(
    const BaseCarry<S>& c, S* __restrict__ floats, int fcol0,
    int* __restrict__ ints, int icol0, int plant, int batch) {
  auto f = [&](int col) -> S& {
    return floats[static_cast<int64_t>(fcol0 + col) * batch + plant];
  };
  auto i = [&](int col) -> int& {
    return ints[static_cast<int64_t>(icol0 + col) * batch + plant];
  };
  f(0) = c.current_value;
  f(1) = c.supply_voltage;
  f(2) = c.power_on_time;
  f(3) = c.calibration_offset;
  f(4) = c.last_calibration_time;
  f(5) = c.calibration_validity_hours;
  f(6) = c.last_value;
  f(7) = c.last_timestamp;
  i(0) = c.has_calibration ? 1 : 0;
  i(1) = c.status;
  i(2) = c.fault;
  i(3) = c.has_history ? 1 : 0;
}

// Words to uniforms and standard normals (rand_from_words): a uniform is
// the word's top 24 bits times 2^-24 (exact), normals are Box-Muller pairs.
template <typename S>
__device__ __forceinline__ S uniform_from_word(uint32_t w) {
  return static_cast<S>(w >> 8) * S(1.0 / (1 << 24));
}

// kNormals normals from the first 2 * ceil(kNormals / 2) words, then
// kUniforms uniforms from the next words.
template <typename S, int kNormals, int kUniforms>
__device__ __forceinline__ void rand_from_words(const uint32_t* words,
                                                S* normals, S* uniforms) {
  constexpr int kPairs = (kNormals + 1) / 2;
#pragma unroll
  for (int pair = 0; pair < kPairs; ++pair) {
    const S u1 = uniform_from_word<S>(words[2 * pair]);
    const S u2 = uniform_from_word<S>(words[2 * pair + 1]);
    const S r = wsqrt(S(-2.0) * wlog(nmax(u1, S(1e-12))));
    const S theta = S(2.0 * 3.141592653589793) * u2;
    normals[2 * pair] = r * wcos(theta);
    if (2 * pair + 1 < kNormals) normals[2 * pair + 1] = r * wsin(theta);
  }
#pragma unroll
  for (int k = 0; k < kUniforms; ++k) {
    uniforms[k] = uniform_from_word<S>(words[2 * kPairs + k]);
  }
}

// sensors/base.py::base_read with the sample line resolved outside:
// ``true_value`` is already delayed. Updates the carry and returns the
// reading's value (NaN on the power-fault and warm-up paths, on a bubble
// and on an open or short circuit); ``out_fault`` receives the reading's
// fault code, which the carry keeps only on the normal path. n: 5 normals,
// u: 3 uniforms.
template <typename S>
__device__ __forceinline__ S base_read(const BaseParams<S>& p,
                                       BaseCarry<S>& c, S true_value, S t,
                                       const S* n, const S* u,
                                       int& out_fault) {
  const S nan = quiet_nan<S>();
  const S n_volt = n[0], n_noise = n[1], n_stag = n[2], n_gnd = n[3],
          n_vib = n[4];
  const S u_bub = u[0], u_fault_roll = u[1], u_fault_type = u[2];

  // pre-existing power fault
  const S v0 = c.supply_voltage;
  const bool power_bad = !((S(20.0) < v0) && (v0 < S(28.0)));
  const int power_fault_code =
      v0 <= S(20.0) ? kFaultPowerLow : kFaultPowerHigh;
  const S new_voltage = S(24.0) + n_volt;
  const S supply_voltage = power_bad ? v0 : new_voltage;

  // warm-up gate
  const bool warming = (t - c.power_on_time) < p.warmup_time_s;
  const bool normal_path = !power_bad && !warming;

  // calibration expiry
  const S cal_age_h = (t - c.last_calibration_time) / S(3600.0);
  const bool cal_expired =
      !c.has_calibration || (cal_age_h > c.calibration_validity_hours);

  // drift + noise + lag (hysteresis is never applied)
  const S drift = p.drift_rate * cal_age_h + c.calibration_offset;
  const S noise = n_noise * p.precision;
  const S lagged =
      S(0.5) * (true_value + noise + drift) + S(1.0 - 0.5) * c.current_value;

  // installation effects
  S value = lagged;
  value = value + (p.flow_velocity < S(0.1)
                       ? n_stag * p.precision * S(2.0)
                       : S(0.0));
  const bool bubble = (p.air_bubble_frequency > S(0.0)) &&
                      (u_bub < p.air_bubble_frequency / S(60.0));
  value = value + (p.grounding_quality < S(0.8)
                       ? n_gnd * p.precision * (S(2.0) - p.grounding_quality)
                       : S(0.0));
  value = value + (p.pipe_vibration_g > S(0.2)
                       ? n_vib * p.pipe_vibration_g * p.precision
                       : S(0.0));
  if (bubble) value = nan;

  // rate of change
  const S dt_hist = t - c.last_timestamp;
  const S rate =
      (c.has_history && (dt_hist > S(0.0)) && is_finite(c.last_value))
          ? (value - c.last_value) / nmax(dt_hist, S(1e-30))
          : S(0.0);

  // fault lattice
  const S span = p.max_value - p.min_value;
  const bool post_power_bad =
      !((S(20.0) < supply_voltage) && (supply_voltage < S(28.0)));
  const int post_power_code =
      supply_voltage <= S(20.0) ? kFaultPowerLow : kFaultPowerHigh;
  const bool out_of_range = (value < p.min_value - S(0.1) * span) ||
                            (value > p.max_value + S(0.1) * span);
  const bool rate_fault = wabs(rate) > p.max_rate_of_change;
  const bool random_fault = u_fault_roll < S(1e-4);
  const int random_code =
      u_fault_type < S(0.5) ? kFaultOpenCircuit : kFaultShortCircuit;
  const int fault = post_power_bad ? post_power_code
                    : out_of_range ? kFaultOutOfRange
                    : rate_fault   ? kFaultRateFault
                    : random_fault ? random_code
                                   : kFaultNone;
  const bool is_open_short =
      fault == kFaultOpenCircuit || fault == kFaultShortCircuit;
  const bool has_fault = fault != kFaultNone;

  // status resolution + saturation
  const S bounded = nclip(value, p.min_value, p.max_value);
  const bool saturated = !is_nan(value) && (bounded != value);
  const bool drift_warn = wabs(drift) > S(0.1) * span;
  const int status_fault =
      is_open_short ? kStatusFailed
      : fault == kFaultOutOfRange ? kStatusOutOfRange
      : (fault == kFaultPowerLow || fault == kFaultPowerHigh)
          ? kStatusPowerFault
          : kStatusRateOfChangeFault;
  const int prior_status = cal_expired ? kStatusCalibrationExpired : c.status;
  int status_ok = is_nan(value) ? prior_status
                  : saturated   ? kStatusSaturated
                  : cal_expired ? kStatusCalibrationExpired
                                : kStatusNormal;
  if (drift_warn && status_ok != kStatusCalibrationExpired) {
    status_ok = kStatusDriftWarning;
  }
  const int status_norm = has_fault ? status_fault : status_ok;
  const S value_norm = is_open_short ? nan : (has_fault ? value : bounded);

  // merge the three paths
  const bool early = power_bad || warming;
  const S out_value = early ? nan : value_norm;
  out_fault = power_bad ? power_fault_code : (warming ? kFaultNone : fault);

  if (normal_path) {
    c.current_value = value_norm;
    c.status = status_norm;
    c.fault = out_fault;
  }
  c.supply_voltage = supply_voltage;
  c.last_value = out_value;
  c.last_timestamp = t;
  c.has_history = true;
  return out_value;
}

// Every overlay ends alike: the overlay value replaces the reading where
// the base value was finite, becomes the carried current value there, and
// always replaces the carried last value.
template <typename S>
__device__ __forceinline__ S finish_overlay(BaseCarry<S>& c, bool finite,
                                            S final_value, S base_value) {
  const S value = finite ? final_value : base_value;
  if (finite) c.current_value = value;
  c.last_value = value;
  return value;
}

// ---- pH (sensors/ph.py) ----------------------------------------------------

template <typename S>
struct PhCarry {  // _OVERLAY_C["ph"] order
  S membrane_fouling, glass_etching, days_since_cleaning, water_hardness,
      reference_contamination, slope_percentage, cal_point_1, cal_point_2;
};

template <typename S>
__device__ __forceinline__ S nernst_compensated_ph(S temperature_coefficient,
                                                   S ph_zone, S t_zone) {
  return ph_zone + temperature_coefficient * (t_zone - S(25.0));
}

// The pH overlay (sensors/ph.py::ph_read after base_read on the delayed
// Nernst-compensated sample): ``out`` is the base reading, ``prev_ts`` and
// ``had_prev`` the carry's last timestamp and history flag before it,
// ``temp`` the tapped zone's temperature now. n: 8 normals, u: 3 uniforms.
template <typename S>
__device__ __forceinline__ S ph_overlay(const BaseParams<S>& p,
                                        BaseCarry<S>& c, PhCarry<S>& o,
                                        S out, S prev_ts, bool had_prev,
                                        S temp, S t, const S* n) {
  const bool finite = is_finite(out);
  const S n_elec = n[5], n_junc = n[6], n_foul = n[7];

  // fouling state update
  const S dt = nmax(t - prev_ts, S(0.0));
  const bool update = had_prev && finite;
  const S bio_rate = o.membrane_fouling > S(0.05)
                         ? S(0.1) * wexp(S(0.05) * (temp - S(25.0)))
                         : S(0.001);
  const S scaling_rate = p.flow_velocity < S(0.1)
                             ? o.water_hardness * S(1e-4)
                             : o.water_hardness * S(1e-5);
  const S fouling =
      update ? nmin(S(1.0), o.membrane_fouling +
                                (bio_rate + scaling_rate) * dt / S(86400.0))
             : o.membrane_fouling;
  const S days_clean = update ? o.days_since_cleaning + dt / S(86400.0)
                              : o.days_since_cleaning;

  // overlay terms
  const S ph_dev = wabs(out - S(7.0));
  const S electrical = n_elec * S(0.002) * (S(1.0) + S(0.1) * ph_dev);
  const S junction =
      n_junc * S(0.005) * (S(1.0) + o.reference_contamination);
  const S days_since_cal =
      c.has_calibration ? (t - c.last_calibration_time) / S(86400.0)
                        : S(0.0);
  const S slope_pct =
      (c.has_calibration && finite)
          ? nmax(S(90.0), S(100.0) - S(0.001) * days_since_cal)
          : o.slope_percentage;
  const bool in_cal_window = (o.cal_point_1 < out) && (out < o.cal_point_2);
  const S distance =
      nmin(wabs(out - o.cal_point_1), wabs(out - o.cal_point_2));
  const S slope_error =
      in_cal_window ? S(0.0)
                    : distance * (S(100.0) - slope_pct) / S(100.0);
  const S fouling_offset = fouling * S(0.2);
  const S fouling_noise = n_foul * (fouling * S(0.05));
  const S contamination =
      finite ? nmin(S(0.5), o.reference_contamination +
                                S(0.0001) * (days_since_cal / S(30.0)))
             : o.reference_contamination;
  const S reference_offset = contamination * S(0.1);
  const S final_value =
      nclip(out + electrical + junction + slope_error + fouling_offset +
                fouling_noise + reference_offset,
            p.min_value, p.max_value);

  o.membrane_fouling = fouling;
  o.days_since_cleaning = days_clean;
  o.reference_contamination = contamination;
  o.slope_percentage = slope_pct;
  return finish_overlay(c, finite, final_value, out);
}

// ---- chlorine (sensors/chlorine.py) -----------------------------------------

template <typename S>
struct ChlorineParams {  // _OVERLAY_P["cl"] order
  S ozone_sensitivity, h2o2_sensitivity, clo2_sensitivity;
};

template <typename S>
struct ChlorineCarry {  // _OVERLAY_C["cl"] order
  S membrane_fouling, membrane_age_days, electrode_polarization,
      reagent_potency, reagent_age_days, light_exposure_hours,
      storage_temperature;
};

template <typename S>
__device__ __forceinline__ S chlorine_true_value(S chlorine_zone, S ph_zone) {
  const S ratio = wpow(S(10.0), S(7.5) - ph_zone);
  const S fraction_hocl = ratio / (S(1.0) + ratio);
  return chlorine_zone * (S(0.5) + S(0.5) * fraction_hocl);
}

// The chlorine overlay (sensors/chlorine.py::chlorine_read after
// base_read on chlorine_true_value), arguments as ph_overlay's. n: 7
// normals, u: 3 uniforms. No interfering species is simulated: ozone,
// hydrogen peroxide and chlorine dioxide are zero, as on the plant path.
template <typename S>
__device__ __forceinline__ S chlorine_overlay(
    const BaseParams<S>& p, const ChlorineParams<S>& q, int sensor_type,
    BaseCarry<S>& c, ChlorineCarry<S>& o, S out, S prev_ts, bool had_prev,
    S t, const S* n) {
  const bool finite = is_finite(out);
  const S n1 = n[5], n2 = n[6];
  const S dt = nmax(t - prev_ts, S(0.0));
  const bool update = had_prev && finite;

  S final_value;
  if (sensor_type == kChlorineAmperometric) {
    const S interference = S(0.0) * q.ozone_sensitivity +
                           S(0.0) * q.h2o2_sensitivity +
                           S(0.0) * q.clo2_sensitivity;
    const S fouling_rate = p.flow_velocity < S(0.1) ? S(0.05) : S(0.01);
    const S fouling =
        update ? nmin(S(1.0),
                      o.membrane_fouling + fouling_rate * dt / S(86400.0))
               : o.membrane_fouling;
    const S age = update ? o.membrane_age_days + dt / S(86400.0)
                         : o.membrane_age_days;
    const S fouling_factor = S(1.0) - S(0.8) * fouling;
    const S polarization_noise =
        n1 * S(0.005) * (S(1.0) + age / S(365.0));
    const S diffusion_noise = n2 * S(0.003);
    final_value = (out + interference) * fouling_factor +
                  polarization_noise + diffusion_noise;
    o.membrane_fouling = fouling;
    o.membrane_age_days = age;
  } else {
    const S t_storage_k = o.storage_temperature + S(273.15);
    const S thermal = wexp(S(50000.0 / 8.314) *
                           (S(1.0 / 293.15) - S(1.0) / t_storage_k));
    const S light = update ? o.light_exposure_hours + dt / S(3600.0)
                           : o.light_exposure_hours;
    const S photo = S(1.0) + S(0.1) * (light / S(100.0));
    const S degradation = thermal * photo * S(0.01);
    const S potency =
        update ? nmax(S(0.0),
                      o.reagent_potency - degradation * dt / S(86400.0))
               : o.reagent_potency;
    const S reagent_age = update ? o.reagent_age_days + dt / S(86400.0)
                                 : o.reagent_age_days;
    const S optical_noise = n1 * S(0.005);
    final_value = out * potency * S(0.95) + optical_noise;
    o.reagent_potency = potency;
    o.reagent_age_days = reagent_age;
    o.light_exposure_hours = light;
  }
  final_value = nclip(final_value, p.min_value, p.max_value);
  return finish_overlay(c, finite, final_value, out);
}

// ---- flow (sensors/flow.py) --------------------------------------------------

template <typename S>
struct FlowCarry {  // _OVERLAY_C["flow"] order
  S bearing_friction, bearing_wear_days, electrode_fouling,
      fluid_conductivity;
};

// The flow overlay (sensors/flow.py::flow_read after base_read on the
// total inflow), arguments as ph_overlay's. n: 6 normals, u: 4 uniforms.
template <typename S>
__device__ __forceinline__ S flow_overlay(const BaseParams<S>& p,
                                          S full_scale, int sensor_type,
                                          BaseCarry<S>& c, FlowCarry<S>& o,
                                          S out, S prev_ts, bool had_prev,
                                          S t, const S* n, const S* u) {
  const bool finite = is_finite(out);
  const S n1 = n[5];
  const S u2 = u[3];
  const S dt = nmax(t - prev_ts, S(0.0));
  const bool update = had_prev && finite;

  S final_value;
  if (sensor_type == kFlowTurbine) {
    const S wear_factor = S(1.0) + p.pipe_vibration_g * S(5.0);
    const S wear =
        update ? o.bearing_wear_days + (dt / S(86400.0)) * wear_factor
               : o.bearing_wear_days;
    const S friction_threshold =
        o.bearing_friction * (S(1.0) + S(0.01) * (wear / S(365.0)));
    const S friction_loss = friction_threshold * full_scale;
    const S effective = out < friction_loss ? S(0.0) : out - friction_loss;
    const S vib_noise = n1 * p.pipe_vibration_g * S(0.01) * full_scale;
    final_value = effective + vib_noise;
    o.bearing_wear_days = wear;
  } else {
    const S fouling =
        update ? o.electrode_fouling + S(0.001) * dt / S(86400.0)
               : o.electrode_fouling;
    const S fouling_factor = nmax(S(0.9), S(1.0) - S(0.005) * fouling);
    const S cond = o.fluid_conductivity;
    const S conductivity_factor =
        cond < S(5.0) ? S(0.0) : (cond < S(20.0) ? cond / S(20.0) : S(1.0));
    const S electrical_noise = n1 * S(0.001) * full_scale;
    final_value =
        out * fouling_factor * conductivity_factor + electrical_noise;
    o.electrode_fouling = fouling;
  }
  const bool bubble = (p.air_bubble_frequency > S(0.0)) &&
                      (u2 < p.air_bubble_frequency / S(60.0));
  if (bubble) final_value = S(0.0);
  if (final_value < S(0.01) * full_scale) final_value = S(0.0);
  final_value = nclip(final_value, S(0.0), p.max_value);
  return finish_overlay(c, finite, final_value, out);
}

// ---- temperature (sensors/temperature.py) ------------------------------------

template <typename S>
struct TemperatureParams {  // _OVERLAY_P["temp"] order
  S nominal_resistance, rtd_alpha, lead_resistance, excitation_current_mA,
      self_heating_C_per_mW, seebeck_coefficient;
};

template <typename S>
struct TemperatureCarry {  // _OVERLAY_C["temp"] order
  S cold_junction_temp, cold_junction_drift;
};

// The temperature overlay (sensors/temperature.py::temperature_read after
// base_read on the delayed zone temperature). n: 7 normals, u: 3 uniforms.
template <typename S>
__device__ __forceinline__ S temperature_overlay(
    const BaseParams<S>& p, const TemperatureParams<S>& q, int sensor_type,
    BaseCarry<S>& c, TemperatureCarry<S>& o, S out, const S* n) {
  const bool finite = is_finite(out);
  const S n1 = n[5], n2 = n[6];

  S final_value;
  if (sensor_type == kTemperatureRtd) {
    const S r_true = q.nominal_resistance * (S(1.0) + q.rtd_alpha * out);
    const S r_measured = r_true + S(2.0) * q.lead_resistance;
    const S i_a = q.excitation_current_mA / S(1000.0);
    const S power_mw = (i_a * i_a) * r_measured * S(1000.0);
    const S self_heating = q.self_heating_C_per_mW * power_mw;
    const S t_measured =
        (r_measured / q.nominal_resistance - S(1.0)) / q.rtd_alpha;
    const S adc_noise = n1 * S(0.001);
    final_value = t_measured + self_heating + adc_noise;
  } else {
    const S v_seebeck = q.seebeck_coefficient * (out - o.cold_junction_temp);
    const S cj_drift = finite ? o.cold_junction_drift + n1 * S(0.01)
                              : o.cold_junction_drift;
    const S emf_noise = n2 * S(0.5);
    final_value = (v_seebeck + emf_noise) / q.seebeck_coefficient +
                  o.cold_junction_temp + cj_drift;
    o.cold_junction_drift = cj_drift;
  }
  const S stem_error = S(0.01) * (out - p.ambient_temperature);
  final_value = nclip(final_value + stem_error, p.min_value, p.max_value);
  return finish_overlay(c, finite, final_value, out);
}

}  // namespace wt
