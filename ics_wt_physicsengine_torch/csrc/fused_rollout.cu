// Fused whole-rollout kernels for the H100 (sm_90a), bound with ctypes.
//
// B1 (wt_rollout_fused) replaces _rollout_kernel and B2
// (wt_rollout_scheduled) replaces _scheduled_kernel, both in
// ics_wt_physicsengine_tpu/ops/fused_rollout.py. Each plant advances
// n_steps x substeps RK4 steps (or s-stage RKC2 steps) of the 3-field zone
// ODE in fused_rollout.cuh, clamped after every step, in ONE launch; B2
// rebuilds the boundary source terms every step from a [n_steps, 10]
// schedule that all plants share.
//
// What bounds them: the work is arithmetic on registers and the state
// moves once per launch. An evaluation is ~400 instructions for the 83
// operations counted (ops/fused_rollout.py: DERIV_OPS): no FMA contraction,
// and eight or nine IEEE divisions, each its own branch region around the
// call to the division's slow path, which the compiler does not overlap
// (~50 cycles each on the chain). A full card (MC-4096, MC-32768) is bound
// by issue slots; a batch that leaves the schedulers few warps (one plant,
// SCHED-1) by the latency of each plant's chain of evaluations, about 800
// cycles each (tools/torch_rollout_probe.py). A zero dividend sent a
// division down its slow path (~220 cycles more): the interface rate of two
// equal densities, the source terms of zero flows; fused_rollout.cuh's
// div_rn and k_iface keep those quotients off it with the same results.
//
// Design: one thread holds one (plant, zone) in registers for the whole
// run, and the launch geometry comes from the host
// (ops/fused_rollout.py::rollout_geometry), sized by the batch; launch()
// refuses one it cannot run. Two layouts:
// - packed (kPacked): a block packs plants_per_block whole plants, P * Z
//   threads rounded up to whole warps (8 plants on 5 warps at Z = 20). The
//   neighbours come through shared memory and a barrier over the block's
//   own warps; padding threads run a one-zone copy of the block's first
//   plant and store nothing. It wins on a full card where a warp of the
//   other layout would leave lanes idle (Z = 20 from ~2000 plants).
// - warp (kWarp, Z <= 32): floor(32 / Z) whole plants in each warp, no
//   plant across a warp, up to four warps a block. The neighbours come by
//   warp shuffle (fused_rollout.cuh: WarpExchange): no shared memory, no
//   barrier, and each interface rate is computed once, by the zone below
//   it, and handed up. Idle lanes run copies of the warp's last plant's
//   first zones; a warp whose plants all lie past the batch returns. For
//   as many warps it runs 11-18% faster than the packed layout, and a
//   single plant runs in one warp (B1 gave it a block of twelve copies).
// B2 loads the next step's schedule row while the current step's
// evaluations run and builds its source terms at the end of the step, so
// the row's load latency leaves the chain. Plants past the batch repeat the
// last plant's work (they must reach every barrier) and store nothing.
// Float32 keeps the register count at or below 64 (32 warps an SM); float64
// takes up to 128.

#include <cstdint>

#include "fused_rollout.cuh"

namespace wt {

enum Layout { kPacked = 0, kWarp = 1 };
constexpr int kWarpSize = 32;
constexpr int kMaxWarpsPerBlock = 4;     // warp layout

template <int kLayout>
constexpr int kMaxThreads =
    kLayout == kWarp ? kWarpSize * kMaxWarpsPerBlock : kThreadsPerBlock;
// Blocks of the largest size an SM must hold: 64 registers a thread in
// float32, 128 in float64.
template <typename S, int kLayout>
constexpr int kMinBlocks =
    (sizeof(S) == 4 ? 65536 / 64 : 65536 / 128) / kMaxThreads<kLayout>;

template <typename S>
struct RolloutArgs {
  const S* params;            // [16, B]
  const S* forcing;           // [10, B], or [n_steps, 10] when scheduled
  const S *ph0, *cl0, *t0;    // [B, Z]
  S *ph, *cl, *t;             // [B, Z]
  S *ph_traj, *cl_traj, *t_traj;   // [n_steps / record_every, B, Z]
  RkcTable<S> rkc;
  int stages, batch, n_zones, plants_per_block, n_steps, substeps,
      record_every;
  StepSizes<S> h;
};

// The (plant, zone) a thread holds: ``real`` is false for a padding thread
// (packed) or an idle lane (warp), which run copies and store nothing.
struct Cell {
  int plant, zone, n_zones;
  bool real;
};

template <int kLayout>
__device__ __forceinline__ Cell cell_of(int tid, int n_zones,
                                        int plants_per_block) {
  Cell c;
  if (kLayout == kWarp) {
    const int per_warp = kWarpSize / n_zones;
    const int lane = tid % kWarpSize;
    const int raw = lane / n_zones;
    c.real = raw < per_warp;
    const int local = c.real ? raw : per_warp - 1;
    c.zone = c.real ? lane - raw * n_zones : lane - per_warp * n_zones;
    c.plant = blockIdx.x * plants_per_block + (tid / kWarpSize) * per_warp +
              local;
    c.n_zones = n_zones;
  } else {
    c.real = tid < plants_per_block * n_zones;
    const int local = c.real ? tid / n_zones : 0;
    c.zone = c.real ? tid - local * n_zones : 0;
    c.plant = blockIdx.x * plants_per_block + local;
    c.n_zones = c.real ? n_zones : 1;
  }
  return c;
}

template <typename S, bool kRkc, bool kScheduled, int kLayout>
__global__ void __launch_bounds__(kMaxThreads<kLayout>,
                                  kMinBlocks<S, kLayout>)
rollout_kernel(const __grid_constant__ RolloutArgs<S> a) {
  __shared__ RkcTable<S> rkc;
  if (kRkc) {
    if (threadIdx.x == 0) rkc = a.rkc;
    __syncthreads();
  }
  const int tid = threadIdx.x;
  const int batch = a.batch, n_zones = a.n_zones;
  const Cell c = cell_of<kLayout>(tid, n_zones, a.plants_per_block);
  // a warp of the warp layout whose first plant lies past the batch has
  // nothing to compute and no one to meet
  if (kLayout == kWarp &&
      blockIdx.x * a.plants_per_block +
              (tid / kWarpSize) * (kWarpSize / n_zones) >= batch) {
    return;
  }
  const bool active = c.real && c.plant < batch;
  const int pl = c.plant < batch ? c.plant : batch - 1;
  const int64_t idx = static_cast<int64_t>(pl) * n_zones + c.zone;

  const Plant<S> p = load_plant(a.params, pl, batch);
  Sources<S> b{};
  S row_next[kBoundaryCols];
  if (!kScheduled) {
    b = boundary_terms(p, [&](int k) { return a.forcing[k * batch + pl]; });
  } else if (a.n_steps > 0) {
    b = boundary_terms(p, [&](int k) { return __ldg(a.forcing + k); });
  }

  S ph = a.ph0[idx], cl = a.cl0[idx], t = a.t0[idx];
  const int64_t plane = static_cast<int64_t>(batch) * n_zones;

  auto run = [&](auto& x) {
    for (int i = 0; i < a.n_steps; ++i) {
      if (kScheduled) {
        // the next step's row, loaded while this step's evaluations run
        const int next = i + 1 < a.n_steps ? i + 1 : i;
        const S* row = a.forcing + static_cast<int64_t>(next) * kBoundaryCols;
#pragma unroll
        for (int k = 0; k < kBoundaryCols; ++k) row_next[k] = __ldg(row + k);
      }
      for (int sub = 0; sub < a.substeps; ++sub) {
        substep<S, kRkc>(p, b, x, rkc, a.stages, a.h, ph, cl, t);
      }
      bound(ph, cl, t);
      if (a.record_every > 0 && (i + 1) % a.record_every == 0 && active) {
        const int64_t at =
            static_cast<int64_t>((i + 1) / a.record_every - 1) * plane + idx;
        a.ph_traj[at] = ph;
        a.cl_traj[at] = cl;
        a.t_traj[at] = t;
      }
      if (kScheduled) {
        b = boundary_terms(p, [&](int k) { return row_next[k]; });
      }
    }
  };
  if constexpr (kLayout == kWarp) {
    WarpExchange<S> x{c.zone, c.n_zones};
    run(x);
  } else {
    __shared__ S exchange_buf[2][4][kThreadsPerBlock];
    Exchange<S> x{exchange_buf, tid, c.zone, c.n_zones, 0};
    run(x);
  }
  if (active) {
    a.ph[idx] = ph;
    a.cl[idx] = cl;
    a.t[idx] = t;
  }
}

// Whether the geometry can run: the packed layout needs whole warps that
// hold P * Z threads with less than one warp of padding, at most
// kThreadsPerBlock; the warp layout needs Z <= 32, whole warps, at most
// kMaxWarpsPerBlock of them, and floor(32 / Z) plants in each.
inline bool geometry_ok(int layout, int n_zones, int plants_per_block,
                        int block_threads) {
  if (plants_per_block < 1 || block_threads < kWarpSize ||
      block_threads % kWarpSize != 0) {
    return false;
  }
  if (layout == kPacked) {
    const int cells = plants_per_block * n_zones;
    return block_threads <= kThreadsPerBlock && cells <= block_threads &&
           block_threads - cells < kWarpSize;
  }
  if (layout == kWarp) {
    return n_zones <= kWarpSize &&
           block_threads <= kWarpSize * kMaxWarpsPerBlock &&
           plants_per_block ==
               (block_threads / kWarpSize) * (kWarpSize / n_zones);
  }
  return false;
}

template <typename S, bool kScheduled>
int launch(const void* params, const void* forcing, const double* rkc_host,
           int stages, const void* ph0, const void* cl0, const void* t0,
           void* ph, void* cl, void* t, void* ph_traj, void* cl_traj,
           void* t_traj, int batch, int n_zones, int n_steps, int substeps,
           int record_every, double h_step, int layout, int plants_per_block,
           int block_threads, cudaStream_t stream) {
  if (batch < 1 || n_zones < 1 || n_zones > kMaxZones || n_steps < 0 ||
      substeps < 1 || record_every < 0 ||
      (stages != 0 && (stages < 2 || stages > kMaxStages)) ||
      !geometry_ok(layout, n_zones, plants_per_block, block_threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RolloutArgs<S> a{};
  a.params = static_cast<const S*>(params);
  a.forcing = static_cast<const S*>(forcing);
  a.ph0 = static_cast<const S*>(ph0);
  a.cl0 = static_cast<const S*>(cl0);
  a.t0 = static_cast<const S*>(t0);
  a.ph = static_cast<S*>(ph);
  a.cl = static_cast<S*>(cl);
  a.t = static_cast<S*>(t);
  a.ph_traj = static_cast<S*>(ph_traj);
  a.cl_traj = static_cast<S*>(cl_traj);
  a.t_traj = static_cast<S*>(t_traj);
  a.rkc = rkc_from_host<S>(rkc_host, stages);
  a.stages = stages;
  a.batch = batch;
  a.n_zones = n_zones;
  a.plants_per_block = plants_per_block;
  a.n_steps = n_steps;
  a.substeps = substeps;
  a.record_every = record_every;
  a.h = step_sizes<S>(h_step);

  const dim3 grid((batch + plants_per_block - 1) / plants_per_block);
  const dim3 block(block_threads);
  const bool rkc = stages != 0;
  if (layout == kWarp) {
    auto kernel = rkc ? rollout_kernel<S, true, kScheduled, kWarp>
                      : rollout_kernel<S, false, kScheduled, kWarp>;
    kernel<<<grid, block, 0, stream>>>(a);
  } else {
    auto kernel = rkc ? rollout_kernel<S, true, kScheduled, kPacked>
                      : rollout_kernel<S, false, kScheduled, kPacked>;
    kernel<<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kScheduled>
int dispatch(int is_double, const void* params, const void* forcing,
             const double* rkc_host, int stages, const void* ph0,
             const void* cl0, const void* t0, void* ph, void* cl, void* t,
             void* ph_traj, void* cl_traj, void* t_traj, int batch,
             int n_zones, int n_steps, int substeps, int record_every,
             double h_step, int layout, int plants_per_block,
             int block_threads, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double, kScheduled>(
        params, forcing, rkc_host, stages, ph0, cl0, t0, ph, cl, t, ph_traj,
        cl_traj, t_traj, batch, n_zones, n_steps, substeps, record_every,
        h_step, layout, plants_per_block, block_threads, s);
  }
  return launch<float, kScheduled>(
      params, forcing, rkc_host, stages, ph0, cl0, t0, ph, cl, t, ph_traj,
      cl_traj, t_traj, batch, n_zones, n_steps, substeps, record_every,
      h_step, layout, plants_per_block, block_threads, s);
}

}  // namespace wt

extern "C" {

// B1: constant forcing; ``boundary`` is the [10, B] per-plant table. The
// last three ints are the geometry (ops/fused_rollout.py::rollout_geometry):
// layout (0 packed, 1 warp), plants a block, threads a block. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// geometry the kernel cannot run).
int wt_rollout_fused(int is_double, const void* params, const void* boundary,
                     const double* rkc, int stages, const void* ph0,
                     const void* cl0, const void* t0, void* ph, void* cl,
                     void* t, void* ph_traj, void* cl_traj, void* t_traj,
                     int batch, int n_zones, int n_steps, int substeps,
                     int record_every, double h_step, int layout,
                     int plants_per_block, int block_threads, void* stream) {
  return wt::dispatch<false>(is_double, params, boundary, rkc, stages, ph0,
                             cl0, t0, ph, cl, t, ph_traj, cl_traj, t_traj,
                             batch, n_zones, n_steps, substeps, record_every,
                             h_step, layout, plants_per_block, block_threads,
                             stream);
}

// B2: per-step forcing; ``schedule`` is the [n_steps, 10] table all plants
// share. Geometry as for B1.
int wt_rollout_scheduled(int is_double, const void* params,
                         const void* schedule, const double* rkc, int stages,
                         const void* ph0, const void* cl0, const void* t0,
                         void* ph, void* cl, void* t, void* ph_traj,
                         void* cl_traj, void* t_traj, int batch, int n_zones,
                         int n_steps, int substeps, int record_every,
                         double h_step, int layout, int plants_per_block,
                         int block_threads, void* stream) {
  return wt::dispatch<true>(is_double, params, schedule, rkc, stages, ph0,
                            cl0, t0, ph, cl, t, ph_traj, cl_traj, t_traj,
                            batch, n_zones, n_steps, substeps, record_every,
                            h_step, layout, plants_per_block, block_threads,
                            stream);
}

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
