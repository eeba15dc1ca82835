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
// Design: state stays [B, Z] row-major. One thread holds one (plant, zone)
// in registers for the whole run, and a block packs whole plants
// (floor(256 / Z) of them), so the zone stencil's neighbour exchange is a
// shared-memory read inside the block and no block ever waits on another.
// Per-plant scalars come from a struct-of-arrays table and are loaded once.
//
// Bound: the work is arithmetic on registers (about 100 FP32 operations per
// zone per derivative evaluation, two of them exp) and the bytes moved are
// the state read and written once, so both kernels are bound by
// operations, at 67 TFLOP/s of non-tensor FP32 on an H100 SXM. A single
// plant is one block on one SM and is bound by the latency of its chain of
// dependent evaluations instead.

#include <cstdint>

#include "fused_rollout.cuh"

namespace wt {

template <typename S, bool kRkc, bool kScheduled>
__global__ void __launch_bounds__(kThreadsPerBlock)
rollout_kernel(const S* __restrict__ params, const S* __restrict__ forcing,
               RkcTable<S> rkc_in, int stages,
               const S* __restrict__ ph0, const S* __restrict__ cl0,
               const S* __restrict__ t0, S* __restrict__ ph_out,
               S* __restrict__ cl_out, S* __restrict__ t_out,
               S* __restrict__ ph_traj, S* __restrict__ cl_traj,
               S* __restrict__ t_traj, int batch, int n_zones,
               int plants_per_block, int n_steps, int substeps,
               int record_every, StepSizes<S> h) {
  __shared__ S exchange_buf[2][4][kThreadsPerBlock];
  __shared__ RkcTable<S> rkc;
  if (kRkc) {
    if (threadIdx.x == 0) rkc = rkc_in;
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int local_plant = tid / n_zones;
  const int zone = tid - local_plant * n_zones;
  const int plant = blockIdx.x * plants_per_block + local_plant;
  const bool active = plant < batch;
  // Threads past the last plant repeat its work (they must reach every
  // barrier) and store nothing.
  const int pl = active ? plant : batch - 1;
  const int64_t idx = static_cast<int64_t>(pl) * n_zones + zone;

  const Plant<S> p = load_plant(params, pl, batch);
  Sources<S> b;
  if (!kScheduled) {
    b = boundary_terms(p, [&](int c) { return forcing[c * batch + pl]; });
  }
  Exchange<S> x{exchange_buf, tid, zone, n_zones, 0};

  S ph = ph0[idx], cl = cl0[idx], t = t0[idx];
  const int64_t plane = static_cast<int64_t>(batch) * n_zones;

  for (int i = 0; i < n_steps; ++i) {
    if (kScheduled) {
      const S* row = forcing + static_cast<int64_t>(i) * kBoundaryCols;
      b = boundary_terms(p, [&](int c) { return __ldg(row + c); });
    }
    for (int sub = 0; sub < substeps; ++sub) {
      substep<S, kRkc>(p, b, x, rkc, stages, h, ph, cl, t);
    }
    bound(ph, cl, t);
    if (record_every > 0 && (i + 1) % record_every == 0 && active) {
      const int64_t at = static_cast<int64_t>((i + 1) / record_every - 1) *
                             plane + idx;
      ph_traj[at] = ph;
      cl_traj[at] = cl;
      t_traj[at] = t;
    }
  }
  if (active) {
    ph_out[idx] = ph;
    cl_out[idx] = cl;
    t_out[idx] = t;
  }
}

template <typename S, bool kScheduled>
int launch(const void* params, const void* forcing, const double* rkc_host,
           int stages, const void* ph0, const void* cl0, const void* t0,
           void* ph, void* cl, void* t, void* ph_traj, void* cl_traj,
           void* t_traj, int batch, int n_zones, int n_steps, int substeps,
           int record_every, double h_step, cudaStream_t stream) {
  if (batch < 1 || n_zones < 1 || n_zones > kMaxZones || n_steps < 0 ||
      substeps < 1 || record_every < 0 ||
      (stages != 0 && (stages < 2 || stages > kMaxStages))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int plants_per_block = kThreadsPerBlock / n_zones;
  const dim3 block(plants_per_block * n_zones);
  const dim3 grid((batch + plants_per_block - 1) / plants_per_block);

  const RkcTable<S> rkc = rkc_from_host<S>(rkc_host, stages);
  auto kernel = stages == 0 ? rollout_kernel<S, false, kScheduled>
                            : rollout_kernel<S, true, kScheduled>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const S*>(params), static_cast<const S*>(forcing), rkc,
      stages, static_cast<const S*>(ph0), static_cast<const S*>(cl0),
      static_cast<const S*>(t0), static_cast<S*>(ph), static_cast<S*>(cl),
      static_cast<S*>(t), static_cast<S*>(ph_traj), static_cast<S*>(cl_traj),
      static_cast<S*>(t_traj), batch, n_zones, plants_per_block, n_steps,
      substeps, record_every, step_sizes<S>(h_step));
  return static_cast<int>(cudaGetLastError());
}

template <bool kScheduled>
int dispatch(int is_double, const void* params, const void* forcing,
             const double* rkc_host, int stages, const void* ph0,
             const void* cl0, const void* t0, void* ph, void* cl, void* t,
             void* ph_traj, void* cl_traj, void* t_traj, int batch,
             int n_zones, int n_steps, int substeps, int record_every,
             double h_step, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double, kScheduled>(
        params, forcing, rkc_host, stages, ph0, cl0, t0, ph, cl, t, ph_traj,
        cl_traj, t_traj, batch, n_zones, n_steps, substeps, record_every,
        h_step, s);
  }
  return launch<float, kScheduled>(
      params, forcing, rkc_host, stages, ph0, cl0, t0, ph, cl, t, ph_traj,
      cl_traj, t_traj, batch, n_zones, n_steps, substeps, record_every,
      h_step, s);
}

}  // namespace wt

extern "C" {

// B1: constant forcing; ``boundary`` is the [10, B] per-plant table.
// Returns the cudaError_t of the launch (0 on success).
int wt_rollout_fused(int is_double, const void* params, const void* boundary,
                     const double* rkc, int stages, const void* ph0,
                     const void* cl0, const void* t0, void* ph, void* cl,
                     void* t, void* ph_traj, void* cl_traj, void* t_traj,
                     int batch, int n_zones, int n_steps, int substeps,
                     int record_every, double h_step, void* stream) {
  return wt::dispatch<false>(is_double, params, boundary, rkc, stages, ph0,
                             cl0, t0, ph, cl, t, ph_traj, cl_traj, t_traj,
                             batch, n_zones, n_steps, substeps, record_every,
                             h_step, stream);
}

// B2: per-step forcing; ``schedule`` is the [n_steps, 10] table all plants
// share.
int wt_rollout_scheduled(int is_double, const void* params,
                         const void* schedule, const double* rkc, int stages,
                         const void* ph0, const void* cl0, const void* t0,
                         void* ph, void* cl, void* t, void* ph_traj,
                         void* cl_traj, void* t_traj, int batch, int n_zones,
                         int n_steps, int substeps, int record_every,
                         double h_step, void* stream) {
  return wt::dispatch<true>(is_double, params, schedule, rkc, stages, ph0,
                            cl0, t0, ph, cl, t, ph_traj, cl_traj, t_traj,
                            batch, n_zones, n_steps, substeps, record_every,
                            h_step, stream);
}

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
