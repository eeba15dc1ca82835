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

  Plant<S> p = load_plant(a.params, pl, batch);
  Sources<S> b;
  if (!a.scheduled) {
    b = boundary_terms(p, [&](int c) { return a.forcing[c * batch + pl]; });
  }
  Exchange<S, PhysicsBarrier> x{exchange_buf, tid, zone,
                                real ? n_zones : 1, 0,
                                PhysicsBarrier{a.physics_threads}};
  // the division path is uniform over the physics warps; a fallback counts
  // the block
  settle_division(p, x, tid == 0);

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

// ---------------------------------------------------------------------------
// The table pack: every table B3 reads, made in one launch
// ---------------------------------------------------------------------------
//
// pack_tables_kernel (wt_pack_tables) replaces no TPU kernel: the JAX
// package builds B3's tables with XLA operations inside its jitted wrapper.
// The tables read ~270 leaves (a sensor's parameter or carry, a reactor
// parameter, a boundary field, the clock, a sample line's ring); made with
// PyTorch operations (ops/fused_plant.py::build_tables, the plain
// version's route) they cost a few launches a leaf and ~30 a lead-in
// (_resolve_lead_in), ~400 launches before B3 on an idle card in a served
// chunk. Here the wrapper hands the leaves over as a descriptor in the
// kernel's arguments (an address, or a host number's bits, an element type
// and a batch stride each: PackArgs), and one thread makes one element of
// a table, converting as PyTorch's casts do (static_cast, round to
// nearest).
//
// The lead-in: one thread per (line, history slot, plant) resolves the read
// that slot serves against the incoming ring, in _resolve_lead_in's
// operations, order and working type: target time, each surviving slot's
// distance, argmin's first-index tie-break (a NaN distance wins, as
// torch.argmin's), the step-0 sample's distance and the slot < ptr rule.
// It loops over the ring's filled slots only: an empty slot's distance is
// infinite and never the first minimum.
//
// Bound: neither operations nor bytes. At one plant it is one launch's
// latency (~36,000 elements of a 3600-step schedule); at 4096 plants it
// moves ~5 MB and reads the rings from L2 (31 reads of a ring row per
// slot).

namespace pack {

// Element type of a leaf (ops/fused_plant.py: LEAF_KINDS, HOST_FLOAT,
// HOST_INT): a tensor's, or a host number's bits (float64 or int64).
enum LeafKind : unsigned {
  kF32 = 0, kF64 = 1, kBool = 2, kI32 = 3, kI64 = 4, kHostF64 = 5,
  kHostI64 = 6
};
constexpr unsigned kKindBits = 4;

// Leaf order (ops/fused_plant.py: PACK_LEAVES): the sensors' parameters,
// float carries and integer carries, the reactor parameters, the boundary
// fields and the plant clock; then per sample line its ring's values,
// times, count and pointer and its delay.
constexpr int kPCols = 98, kFloatCCols = 94, kIntCCols = 28;
constexpr int kParamCols = 16, kBoundaryCols = 10;
constexpr int kLines = 4, kLineLeaves = 5;
constexpr int kFirstIntCol = kPCols + kFloatCCols;
constexpr int kFirstParam = kFirstIntCol + kIntCCols;
constexpr int kFirstBoundary = kFirstParam + kParamCols;
constexpr int kClock = kFirstBoundary + kBoundaryCols;
constexpr int kColumns = kClock + 1;
constexpr int kLeaves = kColumns + kLines * kLineLeaves;
enum LineLeaf { kValues = 0, kTimes = 1, kCount = 2, kPtr = 3, kDelay = 4 };
// The float block holds rows of the parameters, float carries and reactor
// parameters, then the forcing, the clock and the lead-ins; the int32
// block rows of the integer carries, then the delays in steps.

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 16384;

// The layout the wrapper passes, int64 each (ops/fused_plant.py:
// PACK_FIELDS).
struct Layout {
  long long n_leaves, n_pcols, n_float_ccols, n_int_ccols, n_params,
      n_boundary, batch, n_steps, scheduled, forcing_at, clock_at;
  long long forcing_plant_stride[kBoundaryCols];
  long long d_max[kLines], slots[kLines], lead[kLines],
      value_slot_stride[kLines], time_slot_stride[kLines], lead_at[kLines];
};

struct PackArgs {
  unsigned long long at[kLeaves];   // address, or a host number's bits
  unsigned code[kLeaves];           // kind | batch stride << kKindBits
  Layout l;
  long long n_lead;                 // elements of the four lead-ins
  double dt;
  void* floats;                     // the float block, working type
  int* ints;                        // the int32 block
};

// Element ``i`` of leaf ``k`` as T, converted as PyTorch's ``.to`` does.
template <typename T>
__device__ __forceinline__ T load(const PackArgs& a, int k, long long i) {
  const unsigned long long at = a.at[k];
  switch (a.code[k] & ((1u << kKindBits) - 1u)) {
    case kF32: return static_cast<T>(reinterpret_cast<const float*>(at)[i]);
    case kF64: return static_cast<T>(reinterpret_cast<const double*>(at)[i]);
    case kBool:
      return static_cast<T>(reinterpret_cast<const unsigned char*>(at)[i] !=
                            0);
    case kI32: return static_cast<T>(reinterpret_cast<const int*>(at)[i]);
    case kI64:
      return static_cast<T>(reinterpret_cast<const long long*>(at)[i]);
    case kHostF64:
      return static_cast<T>(__longlong_as_double(static_cast<long long>(at)));
    default: return static_cast<T>(static_cast<long long>(at));
  }
}

__device__ __forceinline__ long long stride_of(const PackArgs& a, int k) {
  return static_cast<long long>(a.code[k] >> kKindBits);
}

template <typename S>
__device__ __forceinline__ S quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);      // a Python NaN cast to float32
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Plant b's delay of line ``line`` in whole steps: round-half-even of the
// IEEE quotient delay / dt in the working type, clamped to [0, d_max]
// (NaN passes the clamp, as torch.clamp's), truncated to int32.
template <typename S>
__device__ __forceinline__ int delay_steps(const PackArgs& a, int line,
                                           long long b) {
  const int k = kColumns + line * kLineLeaves + kDelay;
  const S q = load<S>(a, k, b * stride_of(a, k)) / static_cast<S>(a.dt);
  S r = rint(q);
  if (!isnan(r)) {
    r = fmin(fmax(r, S(0)), static_cast<S>(a.l.d_max[line]));
  }
  return static_cast<int>(r);
}

// History slot j of line ``line`` for plant b (_resolve_lead_in).
template <typename S>
__device__ S lead_in(const PackArgs& a, int line, long long j, long long b) {
  if (!a.l.lead[line]) return quiet_nan<S>();
  const long long d = delay_steps<S>(a, line, b);
  const long long g = j - 1 - (a.l.d_max[line] - d);   // the read it serves
  if (g < 0 || g >= d) return quiet_nan<S>();
  const int base = kColumns + line * kLineLeaves;
  const S dt = static_cast<S>(a.dt);
  const S gf = static_cast<S>(g);
  const S delay = load<S>(a, base + kDelay, b * stride_of(a, base + kDelay));
  const S t0 = load<S>(a, kClock, b * stride_of(a, kClock));
  const S target = (t0 + (gf + S(1)) * dt) - delay;
  const long long count =
      load<long long>(a, base + kCount, b * stride_of(a, base + kCount));
  const long long ptr =
      load<long long>(a, base + kPtr, b * stride_of(a, base + kPtr));
  const long long slots = a.l.slots[line];
  const long long times = b * stride_of(a, base + kTimes);
  const long long filled = count < slots ? count : slots;
  S best = static_cast<S>(INFINITY);
  long long best_slot = 0;
  for (long long c = 0; c < filled; ++c) {
    long long overwritten = (c - ptr) % slots;
    if (overwritten < 0) overwritten += slots;
    const S dist =
        overwritten > g
            ? fabs(load<S>(a, base + kTimes,
                           times + c * a.l.time_slot_stride[line]) -
                   target)
            : static_cast<S>(INFINITY);
    if (isnan(dist) ? !isnan(best) : dist < best) {
      best = dist;
      best_slot = c;
    }
  }
  const S dist0 = fabs(delay - gf * dt);
  const bool use = best < dist0 || (best == dist0 && best_slot < ptr);
  if (!use) return quiet_nan<S>();
  return load<S>(a, base + kValues,
                 b * stride_of(a, base + kValues) +
                     best_slot * a.l.value_slot_stride[line]);
}

// Flat work: the column leaves (kColumns x B), the schedule (n_steps x 10,
// or n_steps x 10 x B), the delays (4 x B), the lead-ins (sum of
// (d_max + 1) x B), each element once.
template <typename S>
__global__ void __launch_bounds__(kThreads)
pack_tables_kernel(const __grid_constant__ PackArgs a) {
  const long long batch = a.l.batch;
  const long long n_columns = kColumns * batch;
  const long long n_forcing =
      a.l.scheduled == kSharedSchedule ? a.l.n_steps * kBoundaryCols
      : a.l.scheduled == kPlantSchedule
          ? a.l.n_steps * kBoundaryCols * batch
          : 0;
  const long long n_delays = kLines * batch;
  const long long total = n_columns + n_forcing + n_delays + a.n_lead;
  S* floats = static_cast<S*>(a.floats);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long r = i;
    if (r < n_columns) {
      const int k = static_cast<int>(r / batch);
      const long long b = r - k * batch;
      const long long at = b * stride_of(a, k);
      if (k < kFirstIntCol) {
        floats[r] = load<S>(a, k, at);
      } else if (k < kFirstParam) {
        a.ints[r - kFirstIntCol * batch] = load<int>(a, k, at);
      } else if (k < kFirstBoundary) {
        floats[r - kIntCCols * batch] = load<S>(a, k, at);
      } else if (k < kClock) {
        if (a.l.scheduled == 0) {
          floats[a.l.forcing_at + (k - kFirstBoundary) * batch + b] =
              load<S>(a, k, at);
        }
      } else {
        floats[a.l.clock_at + b] = load<S>(a, k, at);
      }
      continue;
    }
    r -= n_columns;
    if (r < n_forcing) {
      // [n_steps, 10] rows of one schedule, or [n_steps, 10, B]
      const long long b = a.l.scheduled == kPlantSchedule ? r % batch : 0;
      const long long row = a.l.scheduled == kPlantSchedule ? r / batch : r;
      const int c = static_cast<int>(row % kBoundaryCols);
      const long long step = row / kBoundaryCols;
      const int k = kFirstBoundary + c;
      floats[a.l.forcing_at + r] =
          load<S>(a, k, step * stride_of(a, k) +
                            b * a.l.forcing_plant_stride[c]);
      continue;
    }
    r -= n_forcing;
    if (r < n_delays) {
      a.ints[kIntCCols * batch + r] =
          delay_steps<S>(a, static_cast<int>(r / batch), r % batch);
      continue;
    }
    r -= n_delays;
    int line = 0;
    while (line < kLines - 1 && r >= (a.l.d_max[line] + 1) * batch) {
      r -= (a.l.d_max[line] + 1) * batch;
      ++line;
    }
    floats[a.l.lead_at[line] + r] = lead_in<S>(a, line, r / batch, r % batch);
  }
}

template <typename S>
int launch_pack(const unsigned long long* at, const unsigned* code,
                const long long* layout, double dt, void* floats, int* ints,
                cudaStream_t stream) {
  PackArgs a{};
  long long* fields = reinterpret_cast<long long*>(&a.l);
  for (int k = 0; k < static_cast<int>(sizeof(Layout) / sizeof(long long));
       ++k) {
    fields[k] = layout[k];
  }
  const Layout& l = a.l;
  if (l.n_leaves != kLeaves || l.n_pcols != kPCols ||
      l.n_float_ccols != kFloatCCols || l.n_int_ccols != kIntCCols ||
      l.n_params != kParamCols || l.n_boundary != kBoundaryCols ||
      l.batch < 1 || l.n_steps < 0 || l.scheduled < 0 ||
      l.scheduled > kPlantSchedule || floats == nullptr || ints == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < kLeaves; ++k) {
    a.at[k] = at[k];
    a.code[k] = code[k];
  }
  a.n_lead = 0;
  for (int line = 0; line < kLines; ++line) {
    if (l.d_max[line] < 0 || (l.lead[line] && l.slots[line] < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.n_lead += (l.d_max[line] + 1) * l.batch;
  }
  a.dt = dt;
  a.floats = floats;
  a.ints = ints;
  const long long n_forcing =
      l.scheduled == kSharedSchedule ? l.n_steps * kBoundaryCols
      : l.scheduled == kPlantSchedule ? l.n_steps * kBoundaryCols * l.batch
                                      : 0;
  const long long total =
      (kColumns + kLines) * l.batch + n_forcing + a.n_lead;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pack_tables_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pack

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

// The table pack: B3's tables from the descriptor (``at`` and ``code``,
// kLeaves each, and the int64 ``layout``: ops/fused_plant.py::
// pack_tables) into the float block ``floats`` (float64 if ``is_double``,
// else float32) and the int32 block ``ints``. Returns the cudaError_t of
// the launch, cudaErrorInvalidValue for a descriptor of another leaf
// order.
int wt_pack_tables(int is_double, const unsigned long long* at,
                   const unsigned* code, const long long* layout, double dt,
                   void* floats, int* ints, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return wt::pack::launch_pack<double>(at, code, layout, dt, floats, ints,
                                         s);
  }
  return wt::pack::launch_pack<float>(at, code, layout, dt, floats, ints, s);
}

const char* wt_plant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The float32 blocks of B3 launches that took the IEEE divisions
// (fused_rollout.cuh: settle_division) on the current device, into
// ``out``; zeroed by wt_plant_reset_division_fallbacks. Both wait for the
// device.
int wt_plant_division_fallbacks(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, wt::division_fallbacks, sizeof(*out)));
}

int wt_plant_reset_division_fallbacks() {
  const unsigned long long zero = 0;
  return static_cast<int>(
      cudaMemcpyToSymbol(wt::division_fallbacks, &zero, sizeof(zero)));
}

}  // extern "C"
