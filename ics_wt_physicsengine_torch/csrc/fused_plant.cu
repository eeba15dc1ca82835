// Fused whole-rollout kernel of the instrumented plant for the H100
// (sm_90a), bound with ctypes.
//
// B3 (wt_plant_rollout) replaces _plant_kernel in
// ics_wt_physicsengine_tpu/ops/fused_plant.py: per step, the B1/B2 physics
// of fused_rollout.cuh, then all seven instruments of sensors.cuh read the
// new state: random words become normals and uniforms, each sensor taps
// its zone, four sample lines delay their taps through circular histories,
// the base pipeline and its overlay run, and the readings are recorded
// every record_every steps. Sensor carries and histories are written back
// at the end. Forcing is constant (a [10, B] table) or a [n_steps, 10]
// schedule that all plants share; a constant schedule gives the constant
// result bit for bit (one boundary_terms on the same values).
//
// Design: B1/B2's layout. One thread holds one (plant, zone) in registers
// for the whole run and a block packs whole plants. After a step's bounds
// every thread publishes its pH, chlorine and temperature to shared
// memory, and after one barrier the plant's zone-0 thread runs the seven
// reads, taking any zone's tap from shared memory; the other threads go on
// to the next step and wait for it at that step's first barrier, so
// (Z-1)/Z of a block idles through the sensor phase. The histories live in
// global memory as [d_max + 1, B] per line (they are outputs anyway): a
// thread writes slot g % cap and reads slot (g - d + cap) % cap with its
// own plant's d, so uniform and per-plant delays are one code path.
// Randomness is Philox4x32-10 (philox.cuh) with counter (step, plant,
// block, 0) under the 64-bit seed, or words the caller supplies
// ([n_steps, 76, B], for checks).
//
// Bound: operations, as B1/B2: the state, carries and histories move once
// per launch while every step does arithmetic on registers. A single plant
// is one block on one SM and is bound by the latency of its dependent
// chain: derivative evaluations, then one thread's seven pipelines.

#include <cstdint>

#include "fused_rollout.cuh"
#include "philox.cuh"
#include "sensors.cuh"

namespace wt {

// Sensor order (ops/fused_plant.py::SENSORS): pH inlet, pH outlet, chlorine
// inlet, chlorine outlet, flow, temperature inlet, temperature outlet.
// Sample lines (_LINE_ATTRS): pH inlet, pH outlet, temperature inlet,
// temperature outlet.
struct PlantStatics {
  int zone[kSensors];        // tapped zone, normalized to [0, Z)
  int type[kSensors];        // SensorTypeCode (0 where the kind has none)
  int param_col[kSensors];   // first column in the parameter table
  int float_col[kSensors];   // first column in the float carry table
  int int_col[kSensors];     // first column in the integer carry table
  int word[kSensors];        // first of the sensor's words in a step
  int d_max[kLineSensors];   // largest delay of the line, in steps
};

template <typename S>
struct PlantArgs {
  const S* params;           // [16, B]
  const S* forcing;          // [10, B], or [n_steps, 10] when scheduled
  const S* sensor_params;    // [98, B]
  const S* carry_float_in;   // [94, B]
  const int* carry_int_in;   // [28, B]
  const int* delay_steps;    // [4, B]
  const uint32_t* words;     // [n_steps, 76, B], or null: Philox
  const S* time_in;          // [1]
  const S *ph0, *cl0, *t0;   // [B, Z]
  S *ph, *cl, *t;            // [B, Z]
  S* time_out;               // [1]
  S* carry_float_out;        // [94, B]
  int* carry_int_out;        // [28, B]
  S* hist[kLineSensors];     // [d_max + 1, B], lead-in on entry
  S* readings;               // [n_steps / record_every, 7, B]
  RkcTable<S> rkc;
  PlantStatics statics;
  unsigned long long seed;
  int scheduled, stages, batch, n_zones, plants_per_block, n_steps,
      substeps, record_every;
  StepSizes<S> h;
  S dt;
};

// One plant's instruments, held by its zone-0 thread for the whole run.
template <typename S>
struct Suite {
  BaseParams<S> base_params[kSensors];
  BaseCarry<S> base_carry[kSensors];
  S ph_temperature_coefficient[2];
  PhCarry<S> ph_carry[2];
  ChlorineParams<S> cl_params[2];
  ChlorineCarry<S> cl_carry[2];
  S flow_full_scale;
  FlowCarry<S> flow_carry;
  TemperatureParams<S> temp_params[2];
  TemperatureCarry<S> temp_carry[2];
};

template <typename T, int kCount, typename S>
__device__ __forceinline__ T load_columns(const S* __restrict__ table,
                                          int col0, int plant, int batch) {
  T out;
  S* fields = reinterpret_cast<S*>(&out);
#pragma unroll
  for (int k = 0; k < kCount; ++k) {
    fields[k] = table[static_cast<int64_t>(col0 + k) * batch + plant];
  }
  return out;
}

template <typename T, int kCount, typename S>
__device__ __forceinline__ void store_columns(const T& value,
                                              S* __restrict__ table, int col0,
                                              int plant, int batch) {
  const S* fields = reinterpret_cast<const S*>(&value);
#pragma unroll
  for (int k = 0; k < kCount; ++k) {
    table[static_cast<int64_t>(col0 + k) * batch + plant] = fields[k];
  }
}

template <typename S>
__device__ __noinline__ void load_suite(const PlantArgs<S>& a, int plant,
                                        Suite<S>& s) {
  const PlantStatics& st = a.statics;
  const int batch = a.batch;
  for (int k = 0; k < kSensors; ++k) {
    s.base_params[k] =
        load_base_params(a.sensor_params, st.param_col[k], plant, batch);
    s.base_carry[k] =
        load_base_carry(a.carry_float_in, st.float_col[k], a.carry_int_in,
                        st.int_col[k], plant, batch);
  }
  for (int k = 0; k < 2; ++k) {
    s.ph_temperature_coefficient[k] =
        a.sensor_params[static_cast<int64_t>(st.param_col[k] +
                                             kBaseParamCols) * batch + plant];
    s.ph_carry[k] = load_columns<PhCarry<S>, 8>(
        a.carry_float_in, st.float_col[k] + kBaseFloatCols, plant, batch);
    s.cl_params[k] = load_columns<ChlorineParams<S>, 3>(
        a.sensor_params, st.param_col[2 + k] + kBaseParamCols, plant, batch);
    s.cl_carry[k] = load_columns<ChlorineCarry<S>, 7>(
        a.carry_float_in, st.float_col[2 + k] + kBaseFloatCols, plant,
        batch);
    s.temp_params[k] = load_columns<TemperatureParams<S>, 6>(
        a.sensor_params, st.param_col[5 + k] + kBaseParamCols, plant, batch);
    s.temp_carry[k] = load_columns<TemperatureCarry<S>, 2>(
        a.carry_float_in, st.float_col[5 + k] + kBaseFloatCols, plant,
        batch);
  }
  s.flow_full_scale =
      a.sensor_params[static_cast<int64_t>(st.param_col[4] + kBaseParamCols) *
                          batch + plant];
  s.flow_carry = load_columns<FlowCarry<S>, 4>(
      a.carry_float_in, st.float_col[4] + kBaseFloatCols, plant, batch);
}

template <typename S>
__device__ __noinline__ void store_suite(const PlantArgs<S>& a, int plant,
                                         const Suite<S>& s) {
  const PlantStatics& st = a.statics;
  const int batch = a.batch;
  for (int k = 0; k < kSensors; ++k) {
    store_base_carry(s.base_carry[k], a.carry_float_out, st.float_col[k],
                     a.carry_int_out, st.int_col[k], plant, batch);
  }
  for (int k = 0; k < 2; ++k) {
    store_columns<PhCarry<S>, 8>(s.ph_carry[k], a.carry_float_out,
                                 st.float_col[k] + kBaseFloatCols, plant,
                                 batch);
    store_columns<ChlorineCarry<S>, 7>(s.cl_carry[k], a.carry_float_out,
                                       st.float_col[2 + k] + kBaseFloatCols,
                                       plant, batch);
    store_columns<TemperatureCarry<S>, 2>(
        s.temp_carry[k], a.carry_float_out,
        st.float_col[5 + k] + kBaseFloatCols, plant, batch);
  }
  store_columns<FlowCarry<S>, 4>(s.flow_carry, a.carry_float_out,
                                 st.float_col[4] + kBaseFloatCols, plant,
                                 batch);
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

// The sensor phase of one step for one plant: seven reads in SENSORS
// order. ``tap`` is the block's [3][threads] shared array of (pH, chlorine,
// temperature) after this step's bounds and ``tap0`` the index of the
// plant's zone 0 in it.
template <typename S>
__device__ __noinline__ void sensor_step(const PlantArgs<S>& a, Suite<S>& s,
                                         const S (*tap)[kThreadsPerBlock],
                                         int tap0, int plant, int step,
                                         S time, S flow_total) {
  const PlantStatics& st = a.statics;
  const int batch = a.batch;
  uint32_t words[kWordsPerStep];
  if (a.words != nullptr) {
    const uint32_t* src =
        a.words + static_cast<int64_t>(step) * kWordsPerStep * batch + plant;
    for (int k = 0; k < kWordsPerStep; ++k) {
      words[k] = src[static_cast<int64_t>(k) * batch];
    }
  } else {
    plant_step_words(a.seed, static_cast<uint32_t>(step),
                     static_cast<uint32_t>(plant), words);
  }
  auto delay_of = [&](int line) {
    return a.delay_steps[static_cast<int64_t>(line) * batch + plant];
  };
  S value[kSensors];
  S n[8], u[4];

  for (int k = 0; k < 2; ++k) {  // pH inlet, pH outlet: lines 0, 1
    const S ph_zone = tap[0][tap0 + st.zone[k]];
    const S t_zone = tap[2][tap0 + st.zone[k]];
    const S compensated = nernst_compensated_ph(
        s.ph_temperature_coefficient[k], ph_zone, t_zone);
    const S delayed = delayed_tap(a.hist[k], st.d_max[k], delay_of(k), step,
                                  plant, batch, compensated);
    rand_from_words<S, 8, 3>(words + st.word[k], n, u);
    value[k] = ph_read(s.base_params[k], s.base_carry[k], s.ph_carry[k],
                       delayed, t_zone, time, n, u);
  }
  for (int k = 0; k < 2; ++k) {  // chlorine inlet, chlorine outlet
    const int i = 2 + k;
    rand_from_words<S, 7, 3>(words + st.word[i], n, u);
    value[i] = chlorine_read(
        s.base_params[i], s.cl_params[k], st.type[i], s.base_carry[i],
        s.cl_carry[k], tap[1][tap0 + st.zone[i]],
        tap[0][tap0 + st.zone[i]], time, n, u);
  }
  rand_from_words<S, 6, 4>(words + st.word[4], n, u);
  value[4] = flow_read(s.base_params[4], s.flow_full_scale, st.type[4],
                       s.base_carry[4], s.flow_carry, flow_total, time, n,
                       u);
  for (int k = 0; k < 2; ++k) {  // temperature inlet, outlet: lines 2, 3
    const int i = 5 + k;
    const S t_zone = tap[2][tap0 + st.zone[i]];
    const S delayed = delayed_tap(a.hist[2 + k], st.d_max[2 + k],
                                  delay_of(2 + k), step, plant, batch,
                                  t_zone);
    rand_from_words<S, 7, 3>(words + st.word[i], n, u);
    value[i] = temperature_read(s.base_params[i], s.temp_params[k],
                                st.type[i], s.base_carry[i], s.temp_carry[k],
                                delayed, time, n, u);
  }

  if ((step + 1) % a.record_every == 0) {
    S* row = a.readings +
             static_cast<int64_t>((step + 1) / a.record_every - 1) *
                 kSensors * batch + plant;
    for (int k = 0; k < kSensors; ++k) {
      row[static_cast<int64_t>(k) * batch] = value[k];
    }
  }
}

template <typename S, bool kRkc>
__global__ void __launch_bounds__(kThreadsPerBlock)
plant_kernel(const __grid_constant__ PlantArgs<S> a) {
  __shared__ S exchange_buf[2][4][kThreadsPerBlock];
  __shared__ S tap[3][kThreadsPerBlock];
  __shared__ RkcTable<S> rkc;
  if (kRkc) {
    if (threadIdx.x == 0) rkc = a.rkc;
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int n_zones = a.n_zones;
  const int batch = a.batch;
  const int local_plant = tid / n_zones;
  const int zone = tid - local_plant * n_zones;
  const int plant = blockIdx.x * a.plants_per_block + local_plant;
  const bool active = plant < batch;
  // Threads past the last plant repeat its physics (they must reach every
  // barrier), read no instrument and store nothing.
  const int pl = active ? plant : batch - 1;
  const int64_t idx = static_cast<int64_t>(pl) * n_zones + zone;
  const bool reads_sensors = active && zone == 0;

  const Plant<S> p = load_plant(a.params, pl, batch);
  Sources<S> b;
  S flow_total = S(0.0);
  if (!a.scheduled) {
    auto get = [&](int c) { return a.forcing[c * batch + pl]; };
    b = boundary_terms(p, get);
    flow_total = get(kInletFlow) + get(kAcidFlow) + get(kClFlow);
  }
  Exchange<S> x{exchange_buf, tid, zone, n_zones, 0};

  Suite<S> suite;
  if (reads_sensors) load_suite(a, plant, suite);

  S ph = a.ph0[idx], cl = a.cl0[idx], t = a.t0[idx];
  S time = a.time_in[0];

  for (int step = 0; step < a.n_steps; ++step) {
    if (a.scheduled) {
      const S* row = a.forcing + static_cast<int64_t>(step) * kBoundaryCols;
      auto get = [&](int c) { return __ldg(row + c); };
      b = boundary_terms(p, get);
      flow_total = get(kInletFlow) + get(kAcidFlow) + get(kClFlow);
    }
    for (int sub = 0; sub < a.substeps; ++sub) {
      substep<S, kRkc>(p, b, x, rkc, a.stages, a.h, ph, cl, t);
    }
    bound(ph, cl, t);
    time = time + a.dt;

    // Publish the taps. The sensor thread reads them after the barrier;
    // they are written again only after the next step's evaluations, whose
    // barriers that thread reaches once its reads are done.
    tap[0][tid] = ph;
    tap[1][tid] = cl;
    tap[2][tid] = t;
    __syncthreads();
    if (reads_sensors) {
      sensor_step(a, suite, tap, tid, plant, step, time, flow_total);
    }
  }

  if (active) {
    a.ph[idx] = ph;
    a.cl[idx] = cl;
    a.t[idx] = t;
  }
  if (reads_sensors) store_suite(a, plant, suite);
  if (blockIdx.x == 0 && tid == 0) a.time_out[0] = time;
}

template <typename S>
int launch(const void* params, const void* forcing, int scheduled,
           const double* rkc_host, int stages, const void* sensor_params,
           const void* carry_float_in, const int* carry_int_in,
           const int* delay_steps, const int* words,
           unsigned long long seed, const void* time_in, const void* ph0,
           const void* cl0, const void* t0, void* ph, void* cl, void* t,
           void* time_out, void* carry_float_out, int* carry_int_out,
           void* const* hist, void* readings, const int* statics, int batch,
           int n_zones, int n_steps, int substeps, int record_every,
           double h_step, double dt, cudaStream_t stream) {
  if (batch < 1 || n_zones < 1 || n_zones > kMaxZones || n_steps < 0 ||
      substeps < 1 || record_every < 1 ||
      (stages != 0 && (stages < 2 || stages > kMaxStages))) {
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
  a.rkc = rkc_from_host<S>(rkc_host, stages);
  // statics: zone, type, param_col, float_col, int_col, word (7 each),
  // then d_max (4), as ops/fused_plant.py::_statics_array lays them out
  int* fields = reinterpret_cast<int*>(&a.statics);
  for (int k = 0; k < 6 * kSensors + kLineSensors; ++k) {
    fields[k] = statics[k];
  }
  for (int k = 0; k < kSensors; ++k) {
    if (a.statics.zone[k] < 0 || a.statics.zone[k] >= n_zones) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.seed = seed;
  a.scheduled = scheduled;
  a.stages = stages;
  a.batch = batch;
  a.n_zones = n_zones;
  a.plants_per_block = kThreadsPerBlock / n_zones;
  a.n_steps = n_steps;
  a.substeps = substeps;
  a.record_every = record_every;
  a.h = step_sizes<S>(h_step);
  a.dt = static_cast<S>(dt);

  const dim3 block(a.plants_per_block * n_zones);
  const dim3 grid((batch + a.plants_per_block - 1) / a.plants_per_block);
  auto kernel = stages == 0 ? plant_kernel<S, false> : plant_kernel<S, true>;
  kernel<<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The generator alone: words[step][k][plant] for ``n_steps`` steps, as
// sensor_step draws them (for the checks of the stream).
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
// 46 ints; ``words`` is null for the Philox stream under ``seed``.
int wt_plant_rollout(int is_double, const void* params, const void* forcing,
                     int scheduled, const double* rkc, int stages,
                     const void* sensor_params, const void* carry_float_in,
                     const int* carry_int_in, const int* delay_steps,
                     const int* words, unsigned long long seed,
                     const void* time_in, const void* ph0, const void* cl0,
                     const void* t0, void* ph, void* cl, void* t,
                     void* time_out, void* carry_float_out,
                     int* carry_int_out, void* const* hist, void* readings,
                     const int* statics, int batch, int n_zones, int n_steps,
                     int substeps, int record_every, double h_step, double dt,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return wt::launch<double>(
        params, forcing, scheduled, rkc, stages, sensor_params,
        carry_float_in, carry_int_in, delay_steps, words, seed, time_in, ph0,
        cl0, t0, ph, cl, t, time_out, carry_float_out, carry_int_out, hist,
        readings, statics, batch, n_zones, n_steps, substeps, record_every,
        h_step, dt, s);
  }
  return wt::launch<float>(
      params, forcing, scheduled, rkc, stages, sensor_params, carry_float_in,
      carry_int_in, delay_steps, words, seed, time_in, ph0, cl0, t0, ph, cl,
      t, time_out, carry_float_out, carry_int_out, hist, readings, statics,
      batch, n_zones, n_steps, substeps, record_every, h_step, dt, s);
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
