// Fused whole-rollout kernel of the instrumented plant for the H100
// (sm_90a), bound with ctypes.
//
// B3 (wt_plant_rollout) replaces _plant_kernel in
// ics_wt_physicsengine_tpu/ops/fused_plant.py: per step, the B1/B2 physics
// of fused_rollout.cuh, then all seven instruments of sensors.cuh read the
// new state: random words become normals and uniforms, each sensor taps
// its zone, four sample lines delay their taps through circular histories,
// the base pipeline and its overlay run, and the readings (and, when asked,
// their fault codes) are recorded every record_every steps. Sensor carries
// and histories are written back at the end. Forcing is constant (a
// [10, B] table) or a [n_steps, 10] schedule that all plants share; a
// constant schedule gives the constant result bit for bit (one
// boundary_terms on the same values).
//
// Design: a block holds plants_per_block (P) whole plants in two kinds of
// warp, both sized by the wrapper (ops/fused_plant.py::plant_geometry):
// - physics warps: B1/B2's layout, one thread per (plant, zone), P * Z
//   threads rounded up to a multiple of 32. The padding threads run a
//   one-zone copy of the block's first plant, reach every barrier and store
//   nothing. Their exchange ends in named barrier 1 over the physics warps
//   alone (fused_rollout.cuh: PhysicsBarrier), not in __syncthreads.
// - sensor warps: one lane per (plant, sensor), laid out sensor-major, so
//   that neighbouring lanes are neighbouring plants of one sensor: a warp
//   runs few sensor kinds, and its loads and stores of [col, B] tables,
//   [d_max + 1, B] histories and [.., 7, B] readings are coalesced. Sensor
//   k's P lanes start at lane k * sensor_stride: stride P packs them
//   (7 * P lanes, rounded up to a multiple of 32); where all of them would
//   share one warp (P <= 4: one plant, or a few), stride 32 gives each
//   sensor a warp of its own, so that the seven pipelines run side by side
//   instead of one after another in a diverged warp. A lane holds only its
//   own sensor's parameters and carry (~37 values, not the ~200 of seven
//   sensors) for the whole run, and keeps its own copies of the clock and
//   the total inflow, made by the same operations as the physics
//   threads'. The read is split so that the base pipeline, which every
//   kind shares, runs converged (sensors.cuh).
// - randomness: lane k generates only the Philox4x32-10 blocks that cover
//   its own words (3 or 4 of them, 24 a plant-step in place of 19, the
//   design's extra cost), with the counter (step0 + step, plant0 + plant,
//   block, 0) of the plant-wide stream; the wrapper passes each sensor's
//   first block and word skip. A serving loop that launches once per chunk
//   passes its global step count as step0, so that the noise of a run does
//   not depend on how it is chunked, and a launch over lanes plant0 ..
//   plant0 + B - 1 of a larger fleet (one card's shard) passes plant0, so
//   that the noise does not depend on how the fleet is split. Injected
//   words ([n_steps, 76, B]) are read directly and ignore both.
// - clocks: each plant keeps its own clock (time [B]): a fleet whose
//   paused lanes held their clocks runs its lanes at different times.
// - overlap: after a step's bounds the physics threads publish (pH,
//   chlorine, temperature) into tap buffer step % 2 and the whole block
//   meets at one __syncthreads; the sensor lanes then read that buffer
//   while the physics threads compute the next step into the other one.
//   The physics threads write buffer step % 2 again only after the next
//   step's __syncthreads, which a sensor lane reaches only when its reads
//   of the step before are done. So a step costs about max(physics,
//   sensors), not their sum, and the sensors of the last step finish
//   after the physics has left its loop (no barrier follows it: the two
//   roles store disjoint outputs).
//
// Bound: operations, as B1/B2: the state, carries and histories move once
// per launch while every step does arithmetic on registers. A single plant
// is one block on one SM and is bound by the latency of its dependent
// chains: derivative evaluations, or one lane's pipeline where that is
// longer.

#include <cstdint>

#include "fused_rollout.cuh"
#include "philox.cuh"
#include "sensors.cuh"

namespace wt {

// Largest block the wrapper's geometry asks for (physics and sensor warps
// together); the physics threads are at most kThreadsPerBlock.
constexpr int kMaxBlockThreads = 448;

// Register budget, one for both roles. Unbounded, float32 takes 98
// registers: two 20-zone blocks of 7 warps an SM, so PLANT-4096's 512
// blocks run in two waves. Two blocks of kMaxBlockThreads a multiprocessor
// cap it at 72, four such blocks share an SM, and the 512 fit in one wave
// (at the price of ~150 bytes of spills in the sensor lanes). Float64,
// one block a multiprocessor, compiles to 128 with ~250 bytes of spills.
template <typename S>
constexpr int kPlantMinBlocks = sizeof(S) == 4 ? 2 : 1;

// Sensor order (ops/fused_plant.py::SENSORS): pH inlet, pH outlet, chlorine
// inlet, chlorine outlet, flow, temperature inlet, temperature outlet.
// Sample lines (_LINE_ATTRS): pH inlet, pH outlet, temperature inlet,
// temperature outlet. The field order is ops/fused_plant.py::STATICS_FIELDS.
struct PlantStatics {
  int zone[kSensors];        // tapped zone, normalized to [0, Z)
  int type[kSensors];        // SensorTypeCode (0 where the kind has none)
  int param_col[kSensors];   // first column in the parameter table
  int float_col[kSensors];   // first column in the float carry table
  int int_col[kSensors];     // first column in the integer carry table
  int word[kSensors];        // first of the sensor's words in a step
  int n_words[kSensors];     // how many words it draws (10 or 11)
  int block[kSensors];       // first Philox block holding them
  int skip[kSensors];        // word - 4 * block
  int n_blocks[kSensors];    // Philox blocks holding them (3 or 4)
  int d_max[kLineSensors];   // largest delay of the line, in steps
};
constexpr int kStaticsInts = sizeof(PlantStatics) / sizeof(int);

template <typename S>
struct PlantArgs {
  const S* params;           // [16, B]
  const S* forcing;          // [10, B]; [n_steps, 10] when scheduled is
                             // 1 (one schedule), [n_steps, 10, B] when 2
                             // (a schedule per plant)
  const S* sensor_params;    // [98, B]
  const S* carry_float_in;   // [94, B]
  const int* carry_int_in;   // [28, B]
  const int* delay_steps;    // [4, B]
  const uint32_t* words;     // [n_steps, 76, B], or null: Philox
  const S* time_in;          // [B]: each plant's clock
  const S *ph0, *cl0, *t0;   // [B, Z]
  S *ph, *cl, *t;            // [B, Z]
  S* time_out;               // [B]
  S* carry_float_out;        // [94, B]
  int* carry_int_out;        // [28, B]
  S* hist[kLineSensors];     // [d_max + 1, B], lead-in on entry
  S* readings;               // [n_steps / record_every, 7, B]
  int* faults;               // [n_steps / record_every, 7, B], or null
  RkcTable<S> rkc;
  PlantStatics statics;
  unsigned long long seed;
  uint32_t step0;            // the Philox counter of step 0
  uint32_t plant0;           // the Philox counter of plant 0
  int scheduled, stages, batch, n_zones, plants_per_block, physics_threads,
      sensor_stride, n_steps, substeps, record_every;
  StepSizes<S> h;
  S dt;
};

enum SensorKind { kKindPh, kKindChlorine, kKindFlow, kKindTemperature };

__device__ __forceinline__ int kind_of(int sensor) {
  return sensor < 2 ? kKindPh
         : sensor < 4 ? kKindChlorine
         : sensor == 4 ? kKindFlow
                       : kKindTemperature;
}

// The sample line of a sensor, or -1.
__device__ __forceinline__ int line_of(int sensor) {
  return sensor < 2 ? sensor : sensor >= 5 ? sensor - 3 : -1;
}

// Overlay columns per kind (ops/fused_plant.py::_OVERLAY_P, _OVERLAY_C).
__device__ __forceinline__ int overlay_params_of(int kind) {
  return kind == kKindPh ? 1 : kind == kKindChlorine ? 3
         : kind == kKindFlow ? 1 : 6;
}
__device__ __forceinline__ int overlay_carry_of(int kind) {
  return kind == kKindPh ? 8 : kind == kKindChlorine ? 7
         : kind == kKindFlow ? 4 : 2;
}

constexpr int kMaxOverlayParams = 6;   // temperature
constexpr int kMaxOverlayCarry = 8;    // pH

// One (plant, sensor) pair's instrument, held by its lane for the whole
// run. The overlay's parameters and carry are raw columns, which the kind
// reads as its own struct.
template <typename S>
struct Lane {
  BaseParams<S> base_params;
  BaseCarry<S> base_carry;
  S overlay_params[kMaxOverlayParams];
  S overlay_carry[kMaxOverlayCarry];
};

// The first fields of a register array as a struct of them, and back.
template <typename T, typename S>
__device__ __forceinline__ T fields_of(const S* values) {
  T out;
  S* fields = reinterpret_cast<S*>(&out);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / sizeof(S)); ++k) {
    fields[k] = values[k];
  }
  return out;
}

template <typename T, typename S>
__device__ __forceinline__ void put_fields(const T& value, S* values) {
  const S* fields = reinterpret_cast<const S*>(&value);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / sizeof(S)); ++k) {
    values[k] = fields[k];
  }
}

// Circular sample-line history of one plant: append this step's tap, read
// the tap from ``d`` steps ago. Slots not yet written in this run hold the
// lead-in the host resolved from the incoming ring; a NaN there means "no
// usable earlier sample" and falls back to slot 0, which holds the step-0
// tap for the whole lead-in window.
template <typename S>
__device__ __forceinline__ S delayed_tap(S* __restrict__ hist, int d_max,
                                         int d, int step, int plant,
                                         int batch, S tap) {
  if (d_max == 0) return tap;
  const int cap = d_max + 1;
  hist[static_cast<int64_t>(step % cap) * batch + plant] = tap;
  const int slot = (step % cap - d + cap) % cap;
  const S v = hist[static_cast<int64_t>(slot) * batch + plant];
  return is_nan(v) ? hist[plant] : v;
}

// Forcing modes (PlantArgs::scheduled): constant [10, B], one schedule
// [n_steps, 10] for every plant, or a schedule per plant [n_steps, 10, B]
// (a fleet's chunk, whose lanes slew toward their own commands).
constexpr int kSharedSchedule = 1;
constexpr int kPlantSchedule = 2;

// Column 0 of plant ``plant``'s row of step ``step`` in a per-plant
// schedule; column c lies c * batch further on.
template <typename S>
__device__ __forceinline__ const S* plant_row(const S* forcing, int step,
                                              int plant, int batch) {
  return forcing + static_cast<int64_t>(step) * kBoundaryCols * batch +
         plant;
}

// The total inflow the flow meter reads: the same three-term sum as the
// reference's, from a plant's forcing column or the step's schedule row.
template <typename Get>
__device__ __forceinline__ auto total_inflow(Get get) {
  return get(kInletFlow) + get(kAcidFlow) + get(kClFlow);
}

// A physics thread: B1/B2's (plant, zone) for the whole run, publishing
// its bounded state into tap[step % 2] every step.
template <typename S, bool kRkc>
__device__ __forceinline__ void physics_role(
    const PlantArgs<S>& a, const RkcTable<S>& rkc,
    S (*exchange_buf)[4][kThreadsPerBlock], S (*tap)[3][kThreadsPerBlock]) {
  const int tid = threadIdx.x;
  const int n_zones = a.n_zones;
  const int batch = a.batch;
  const bool real = tid < a.plants_per_block * n_zones;
  const int local_plant = real ? tid / n_zones : 0;
  const int zone = real ? tid - local_plant * n_zones : 0;
  const int plant = blockIdx.x * a.plants_per_block + local_plant;
  const bool active = real && plant < batch;
  // Threads past the last plant repeat its physics, padding threads a
  // one-zone copy of the block's first plant: they reach every barrier and
  // store nothing.
  const int pl = plant < batch ? plant : batch - 1;
  const int64_t idx = static_cast<int64_t>(pl) * n_zones + zone;

  const Plant<S> p = load_plant(a.params, pl, batch);
  Sources<S> b;
  if (!a.scheduled) {
    b = boundary_terms(p, [&](int c) { return a.forcing[c * batch + pl]; });
  }
  Exchange<S, PhysicsBarrier> x{exchange_buf, tid, zone,
                                real ? n_zones : 1, 0,
                                PhysicsBarrier{a.physics_threads}};

  S ph = a.ph0[idx], cl = a.cl0[idx], t = a.t0[idx];
  S time = a.time_in[pl];
  for (int step = 0; step < a.n_steps; ++step) {
    if (a.scheduled == kSharedSchedule) {
      const S* row = a.forcing + static_cast<int64_t>(step) * kBoundaryCols;
      b = boundary_terms(p, [&](int c) { return __ldg(row + c); });
    } else if (a.scheduled == kPlantSchedule) {
      const S* row = plant_row(a.forcing, step, pl, batch);
      b = boundary_terms(p, [&](int c) { return __ldg(row + c * batch); });
    }
    for (int sub = 0; sub < a.substeps; ++sub) {
      substep<S, kRkc>(p, b, x, rkc, a.stages, a.h, ph, cl, t);
    }
    bound(ph, cl, t);
    time = time + a.dt;
    S (*out)[kThreadsPerBlock] = tap[step & 1];
    out[0][tid] = ph;
    out[1][tid] = cl;
    out[2][tid] = t;
    __syncthreads();  // hand the step over to the sensor lanes
  }
  if (active) {
    a.ph[idx] = ph;
    a.cl[idx] = cl;
    a.t[idx] = t;
  }
  if (active && zone == 0) a.time_out[plant] = time;
}

// A sensor lane: one (plant, sensor) pair, reading step s from tap[s % 2]
// while the physics threads compute step s + 1. Sensor k's lanes start at
// lane k * sensor_stride.
template <typename S>
__device__ __forceinline__ void sensor_role(
    const PlantArgs<S>& a, const S (*tap)[3][kThreadsPerBlock], int lane) {
  const PlantStatics& st = a.statics;
  const int batch = a.batch;
  const int sensor = lane / a.sensor_stride;
  const int local_plant = lane - sensor * a.sensor_stride;
  const int plant = blockIdx.x * a.plants_per_block + local_plant;
  const bool active = sensor < kSensors &&
                      local_plant < a.plants_per_block && plant < batch;
  const int k = active ? sensor : 0;
  const int kind = kind_of(k);
  const int line = line_of(k);
  const int type = st.type[k];
  const int tap_at = local_plant * a.n_zones + st.zone[k];
  const int word = st.word[k], n_words = st.n_words[k];
  const int block = st.block[k], skip = st.skip[k];
  const int n_blocks = st.n_blocks[k];
  S* hist = nullptr;
  int d_max = 0, d = 0;
  if (active && line >= 0) {
    hist = line == 0 ? a.hist[0] : line == 1 ? a.hist[1]
           : line == 2 ? a.hist[2] : a.hist[3];
    d_max = st.d_max[line];
    d = a.delay_steps[static_cast<int64_t>(line) * batch + plant];
  }

  Lane<S> s{};
  S flow_total = S(0.0);
  if (active) {
    const int pcol = st.param_col[k], fcol = st.float_col[k];
    s.base_params = load_base_params(a.sensor_params, pcol, plant, batch);
    s.base_carry = load_base_carry(a.carry_float_in, fcol, a.carry_int_in,
                                   st.int_col[k], plant, batch);
    const int n_params = overlay_params_of(kind);
    const int n_carry = overlay_carry_of(kind);
#pragma unroll
    for (int c = 0; c < kMaxOverlayParams; ++c) {
      if (c < n_params) {
        s.overlay_params[c] = a.sensor_params[
            static_cast<int64_t>(pcol + kBaseParamCols + c) * batch + plant];
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxOverlayCarry; ++c) {
      if (c < n_carry) {
        s.overlay_carry[c] = a.carry_float_in[
            static_cast<int64_t>(fcol + kBaseFloatCols + c) * batch + plant];
      }
    }
    if (!a.scheduled && kind == kKindFlow) {
      flow_total = total_inflow(
          [&](int c) { return a.forcing[c * batch + plant]; });
    }
  }

  S time = a.time_in[plant < batch ? plant : batch - 1];
  for (int step = 0; step < a.n_steps; ++step) {
    __syncthreads();  // the physics threads have published this step
    time = time + a.dt;
    if (!active) continue;
    const S(*in)[kThreadsPerBlock] = tap[step & 1];
    const S ph_zone = in[0][tap_at];
    const S cl_zone = in[1][tap_at];
    const S t_zone = in[2][tap_at];
    if (a.scheduled == kSharedSchedule && kind == kKindFlow) {
      const S* row = a.forcing + static_cast<int64_t>(step) * kBoundaryCols;
      flow_total = total_inflow([&](int c) { return __ldg(row + c); });
    } else if (a.scheduled == kPlantSchedule && kind == kKindFlow) {
      const S* row = plant_row(a.forcing, step, plant, batch);
      flow_total =
          total_inflow([&](int c) { return __ldg(row + c * batch); });
    }

    // the kind's true value, delayed through its sample line
    S truth;
    if (kind == kKindPh) {
      truth = nernst_compensated_ph(s.overlay_params[0], ph_zone, t_zone);
    } else if (kind == kKindChlorine) {
      truth = chlorine_true_value(cl_zone, ph_zone);
    } else if (kind == kKindFlow) {
      truth = flow_total;
    } else {
      truth = t_zone;
    }
    if (line >= 0) {
      truth = delayed_tap(hist, d_max, d, step, plant, batch, truth);
    }

    // the lane's own words: 8 normals and 3 uniforms (a flow meter's 6
    // normals and 4 uniforms share the first three pairs)
    uint32_t w[kMaxSensorWords];
    if (a.words != nullptr) {
      const uint32_t* src =
          a.words + (static_cast<int64_t>(step) * kWordsPerStep + word) *
                        batch + plant;
#pragma unroll
      for (int c = 0; c < kMaxSensorWords; ++c) {
        w[c] = c < n_words ? src[static_cast<int64_t>(c) * batch] : 0u;
      }
    } else {
      sensor_step_words(a.seed, a.step0 + static_cast<uint32_t>(step),
                        a.plant0 + static_cast<uint32_t>(plant), block,
                        n_blocks, skip, w);
    }
    S n[8], u[4];
    rand_from_words<S, 8, 3>(w, n, u);
    if (kind == kKindFlow) {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = uniform_from_word<S>(w[6 + j]);
    }

    // base pipeline (converged), then the kind's overlay
    const S prev_ts = s.base_carry.last_timestamp;
    const bool had_prev = s.base_carry.has_history;
    int fault;
    const S out =
        base_read(s.base_params, s.base_carry, truth, time, n, u, fault);
    S value;
    if (kind == kKindPh) {
      PhCarry<S> o = fields_of<PhCarry<S>>(s.overlay_carry);
      value = ph_overlay(s.base_params, s.base_carry, o, out, prev_ts,
                         had_prev, t_zone, time, n);
      put_fields(o, s.overlay_carry);
    } else if (kind == kKindChlorine) {
      ChlorineCarry<S> o = fields_of<ChlorineCarry<S>>(s.overlay_carry);
      value = chlorine_overlay(
          s.base_params, fields_of<ChlorineParams<S>>(s.overlay_params),
          type, s.base_carry, o, out, prev_ts, had_prev, time, n);
      put_fields(o, s.overlay_carry);
    } else if (kind == kKindFlow) {
      FlowCarry<S> o = fields_of<FlowCarry<S>>(s.overlay_carry);
      value = flow_overlay(s.base_params, s.overlay_params[0], type,
                           s.base_carry, o, out, prev_ts, had_prev, time, n,
                           u);
      put_fields(o, s.overlay_carry);
    } else {
      TemperatureCarry<S> o =
          fields_of<TemperatureCarry<S>>(s.overlay_carry);
      value = temperature_overlay(
          s.base_params, fields_of<TemperatureParams<S>>(s.overlay_params),
          type, s.base_carry, o, out, n);
      put_fields(o, s.overlay_carry);
    }

    if ((step + 1) % a.record_every == 0) {
      const int64_t at =
          (static_cast<int64_t>((step + 1) / a.record_every - 1) * kSensors +
           k) * batch + plant;
      a.readings[at] = value;
      if (a.faults != nullptr) a.faults[at] = fault;
    }
  }

  if (active) {
    const int fcol = st.float_col[k];
    store_base_carry(s.base_carry, a.carry_float_out, fcol, a.carry_int_out,
                     st.int_col[k], plant, batch);
    const int n_carry = overlay_carry_of(kind);
#pragma unroll
    for (int c = 0; c < kMaxOverlayCarry; ++c) {
      if (c < n_carry) {
        a.carry_float_out[static_cast<int64_t>(fcol + kBaseFloatCols + c) *
                              batch + plant] = s.overlay_carry[c];
      }
    }
  }
}

template <typename S, bool kRkc>
__global__ void __launch_bounds__(kMaxBlockThreads, kPlantMinBlocks<S>)
plant_kernel(const __grid_constant__ PlantArgs<S> a) {
  __shared__ S exchange_buf[2][4][kThreadsPerBlock];
  __shared__ S tap[2][3][kThreadsPerBlock];
  __shared__ RkcTable<S> rkc;
  if (kRkc) {
    if (threadIdx.x == 0) rkc = a.rkc;
    __syncthreads();
  }
  // Whole warps take one role: physics_threads is a multiple of 32.
  if (static_cast<int>(threadIdx.x) < a.physics_threads) {
    physics_role<S, kRkc>(a, rkc, exchange_buf, tap);
  } else {
    sensor_role<S>(a, tap, threadIdx.x - a.physics_threads);
  }
}

template <typename S>
int launch(const void* params, const void* forcing, int scheduled,
           const double* rkc_host, int stages, const void* sensor_params,
           const void* carry_float_in, const int* carry_int_in,
           const int* delay_steps, const int* words,
           unsigned long long seed, unsigned step0, unsigned plant0,
           const void* time_in, const void* ph0, const void* cl0,
           const void* t0, void* ph, void* cl, void* t, void* time_out,
           void* carry_float_out,
           int* carry_int_out, void* const* hist, void* readings,
           int* faults, const int* statics, int batch,
           int n_zones, int plants_per_block, int physics_threads,
           int sensor_stride, int n_steps, int substeps, int record_every,
           double h_step, double dt, cudaStream_t stream) {
  const int sensor_threads = (kSensors * sensor_stride + 31) / 32 * 32;
  if (batch < 1 || n_zones < 1 || n_zones > kMaxZones || n_steps < 0 ||
      scheduled < 0 || scheduled > kPlantSchedule ||
      substeps < 1 || record_every < 1 ||
      (stages != 0 && (stages < 2 || stages > kMaxStages)) ||
      plants_per_block < 1 || sensor_stride < plants_per_block ||
      physics_threads % 32 != 0 ||
      plants_per_block * n_zones > physics_threads ||
      physics_threads > kThreadsPerBlock ||
      physics_threads + sensor_threads > kMaxBlockThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlantArgs<S> a{};
  a.params = static_cast<const S*>(params);
  a.forcing = static_cast<const S*>(forcing);
  a.sensor_params = static_cast<const S*>(sensor_params);
  a.carry_float_in = static_cast<const S*>(carry_float_in);
  a.carry_int_in = carry_int_in;
  a.delay_steps = delay_steps;
  a.words = reinterpret_cast<const uint32_t*>(words);
  a.time_in = static_cast<const S*>(time_in);
  a.ph0 = static_cast<const S*>(ph0);
  a.cl0 = static_cast<const S*>(cl0);
  a.t0 = static_cast<const S*>(t0);
  a.ph = static_cast<S*>(ph);
  a.cl = static_cast<S*>(cl);
  a.t = static_cast<S*>(t);
  a.time_out = static_cast<S*>(time_out);
  a.carry_float_out = static_cast<S*>(carry_float_out);
  a.carry_int_out = carry_int_out;
  for (int k = 0; k < kLineSensors; ++k) {
    a.hist[k] = static_cast<S*>(hist[k]);
  }
  a.readings = static_cast<S*>(readings);
  a.faults = faults;
  a.rkc = rkc_from_host<S>(rkc_host, stages);
  // statics: the fields of PlantStatics in order, 7 ints each and then
  // d_max (4), as ops/fused_plant.py::_statics_array lays them out
  int* fields = reinterpret_cast<int*>(&a.statics);
  for (int k = 0; k < kStaticsInts; ++k) {
    fields[k] = statics[k];
  }
  const PlantStatics& st = a.statics;
  for (int k = 0; k < kSensors; ++k) {
    if (st.zone[k] < 0 || st.zone[k] >= n_zones || st.n_words[k] < 1 ||
        st.n_words[k] > kMaxSensorWords || st.word[k] < 0 ||
        st.word[k] + st.n_words[k] > kWordsPerStep || st.skip[k] < 0 ||
        st.skip[k] > 3 || st.word[k] != 4 * st.block[k] + st.skip[k] ||
        st.n_blocks[k] < 1 || st.n_blocks[k] > kMaxSensorBlocks ||
        st.skip[k] + st.n_words[k] > 4 * st.n_blocks[k]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.seed = seed;
  a.step0 = step0;
  a.plant0 = plant0;
  a.scheduled = scheduled;
  a.stages = stages;
  a.batch = batch;
  a.n_zones = n_zones;
  a.plants_per_block = plants_per_block;
  a.physics_threads = physics_threads;
  a.sensor_stride = sensor_stride;
  a.n_steps = n_steps;
  a.substeps = substeps;
  a.record_every = record_every;
  a.h = step_sizes<S>(h_step);
  a.dt = static_cast<S>(dt);

  const dim3 block(physics_threads + sensor_threads);
  const dim3 grid((batch + plants_per_block - 1) / plants_per_block);
  auto kernel = stages == 0 ? plant_kernel<S, false> : plant_kernel<S, true>;
  kernel<<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The generator alone: words[step][k][plant] for ``n_steps`` steps, the
// plant-wide stream whose blocks the sensor lanes draw (for the checks of
// the stream).
__global__ void philox_words_kernel(unsigned long long seed, int n_steps,
                                    int batch, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(n_steps) * batch) return;
  const int step = static_cast<int>(i / batch);
  const int plant = static_cast<int>(i - static_cast<int64_t>(step) * batch);
  uint32_t words[kWordsPerStep];
  plant_step_words(seed, static_cast<uint32_t>(step),
                   static_cast<uint32_t>(plant), words);
  uint32_t* dst = out + static_cast<int64_t>(step) * kWordsPerStep * batch +
                  plant;
  for (int k = 0; k < kWordsPerStep; ++k) {
    dst[static_cast<int64_t>(k) * batch] = words[k];
  }
}

}  // namespace wt

extern "C" {

// B3. Returns the cudaError_t of the launch (0 on success). ``hist`` is a
// host array of the four history pointers and ``statics`` a host array of
// kStaticsInts (74) ints; ``words`` is null for the Philox stream under
// ``seed``, whose step counter starts at ``step0`` and plant counter at
// ``plant0``. ``time_in``/``time_out`` hold each plant's clock. ``faults``
// is null, or
// receives each recorded reading's fault code beside ``readings``. A block
// holds ``plants_per_block`` plants on ``physics_threads`` (a multiple of
// 32, at least plants_per_block * n_zones) physics threads
// and 7 * sensor_stride sensor lanes rounded up to a multiple of 32, sensor
// k's from lane k * sensor_stride (>= plants_per_block) on
// (ops/fused_plant.py::plant_geometry).
int wt_plant_rollout(int is_double, const void* params, const void* forcing,
                     int scheduled, const double* rkc, int stages,
                     const void* sensor_params, const void* carry_float_in,
                     const int* carry_int_in, const int* delay_steps,
                     const int* words, unsigned long long seed,
                     unsigned step0, unsigned plant0, const void* time_in,
                     const void* ph0, const void* cl0, const void* t0,
                     void* ph, void* cl, void* t, void* time_out,
                     void* carry_float_out,
                     int* carry_int_out, void* const* hist, void* readings,
                     int* faults, const int* statics, int batch, int n_zones,
                     int plants_per_block, int physics_threads,
                     int sensor_stride, int n_steps, int substeps,
                     int record_every, double h_step, double dt,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return wt::launch<double>(
        params, forcing, scheduled, rkc, stages, sensor_params,
        carry_float_in, carry_int_in, delay_steps, words, seed, step0,
        plant0, time_in, ph0, cl0, t0, ph, cl, t, time_out, carry_float_out,
        carry_int_out, hist, readings, faults, statics, batch, n_zones,
        plants_per_block, physics_threads, sensor_stride, n_steps, substeps,
        record_every, h_step, dt, s);
  }
  return wt::launch<float>(
      params, forcing, scheduled, rkc, stages, sensor_params, carry_float_in,
      carry_int_in, delay_steps, words, seed, step0, plant0, time_in, ph0,
      cl0, t0, ph, cl, t, time_out, carry_float_out, carry_int_out, hist,
      readings,
      faults, statics, batch, n_zones, plants_per_block, physics_threads,
      sensor_stride, n_steps, substeps, record_every, h_step, dt, s);
}

// The Philox words of ``n_steps`` steps of ``batch`` plants into
// ``out`` [n_steps, 76, batch] (int32 storage).
int wt_philox_words(unsigned long long seed, int n_steps, int batch,
                    int* out, void* stream) {
  if (n_steps < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(n_steps) * batch;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((total + threads - 1) / threads));
  wt::philox_words_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      seed, n_steps, batch, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* wt_plant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
