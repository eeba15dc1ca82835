// Equilibrium-pH Newton solver for the H100 (sm_90a), bound with ctypes.
//
// B4 (wt_solve_ph) replaces _ph_newton_kernel in
// ics_wt_physicsengine_tpu/ops/ph_solver.py: for every element of a flat
// array, `iters` iterations of damped Newton-Raphson on the carbonate
// charge balance
//   f(pH) = [H+] - Kw/[H+] + (alpha1 + 2 alpha2) C_T - alk
// with the analytic derivative, the step capped at caps[i] in iteration i
// and pH clipped to [0, 14]. An element whose step fell below `tolerance`
// is done: that step is still applied, later ones are not.
//
// Design: one thread per element, grid-stride, the six inputs read once
// into registers, the whole loop on registers, one store. The TPU kernel's
// (8k, 128) tiles, its pad value and its float done-mask are Mosaic
// mechanics and are not carried over; the done-mask here is a bool and a
// done element keeps its pH by selection. Every element runs all `iters`
// iterations, as in the TPU kernel.
//
// The step caps come from the host as a table of `iters` values folded in
// double (MAX_NEWTON_STEP * NEWTON_STEP_DECAY ** i) and cast to the working
// type; all threads read the same entry, which the read-only cache
// broadcasts.
//
// Rounding: built with -fmad=false, IEEE divisions, expf / exp. The plain
// PyTorch version (ops/ph_solver.py::solve_pH_plain) does the same
// operations in the same order, so the two agree bit for bit. That matters
// in float32, where a tolerance of 1e-6 lies below the resolution of pH
// near the root: an element that cannot meet it keeps stepping inside the
// decayed cap, and one differently rounded operation would flip
// |delta| < tolerance and move the result by up to the cap.
//
// Bound: operations. An element does about 52 operations per iteration
// (ops/ph_solver.py::PH_OPS) on 7 values moved, so at 100 iterations the
// arithmetic outweighs the bytes by three orders of magnitude on an H100
// (67 TFLOP/s of non-tensor FP32 against 3.35 TB/s).

#include <cstdint>

namespace wt {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 16;
constexpr double kLn10 = 2.302585092994046;

__device__ __forceinline__ float wexp(float x) { return expf(x); }
__device__ __forceinline__ double wexp(double x) { return exp(x); }
__device__ __forceinline__ float wabs(float x) { return fabsf(x); }
__device__ __forceinline__ double wabs(double x) { return fabs(x); }

// clip that keeps NaN, as torch.clip does (fminf / fmaxf would drop it)
template <typename S>
__device__ __forceinline__ S nclip(S x, S lo, S hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
ph_newton_kernel(const S* __restrict__ kw_in, const S* __restrict__ ka1_in,
                 const S* __restrict__ ka2_in, const S* __restrict__ ct_in,
                 const S* __restrict__ alk_in, const S* __restrict__ ph0,
                 const S* __restrict__ caps, S* __restrict__ out, int64_t n,
                 int iters, S tolerance) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < n; idx += stride) {
    const S kw = kw_in[idx], ka1 = ka1_in[idx], ka2 = ka2_in[idx];
    const S ct = ct_in[idx], alk = alk_in[idx];
    S ph = ph0[idx];
    bool done = false;
    for (int i = 0; i < iters; ++i) {
      const S h = wexp(S(-kLn10) * ph);
      const S oh = kw / h;
      const S d = h * h + ka1 * h + ka1 * ka2;
      const S a1 = ka1 * h / d;
      const S a2 = ka1 * ka2 / d;
      const S f = h - oh + a1 * ct + S(2.0) * a2 * ct - alk;

      const S dh_dph = S(-kLn10) * h;
      const S doh_dph = -(kw / (h * h)) * dh_dph;
      const S dd_dh = S(2.0) * h + ka1;
      const S da1_dh = ka1 * (d - h * dd_dh) / (d * d);
      const S da2_dh = -ka1 * ka2 * dd_dh / (d * d);
      const S df = dh_dph - doh_dph + ct * da1_dh * dh_dph +
                   S(2.0) * ct * da2_dh * dh_dph;

      const S cap = __ldg(caps + i);
      const S delta = nclip(-f / df, -cap, cap);
      const S ph_new = nclip(ph + delta, S(0.0), S(14.0));
      if (!done) ph = ph_new;
      done = done || (wabs(delta) < tolerance);
    }
    out[idx] = ph;
  }
}

template <typename S>
int launch(const void* kw, const void* ka1, const void* ka2, const void* ct,
           const void* alk, const void* ph0, const void* caps, void* out,
           int64_t n, int iters, double tolerance, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < kMaxBlocks ? blocks
                                                             : kMaxBlocks));
  ph_newton_kernel<S><<<grid, dim3(kThreads), 0, stream>>>(
      static_cast<const S*>(kw), static_cast<const S*>(ka1),
      static_cast<const S*>(ka2), static_cast<const S*>(ct),
      static_cast<const S*>(alk), static_cast<const S*>(ph0),
      static_cast<const S*>(caps), static_cast<S*>(out), n, iters,
      static_cast<S>(tolerance));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wt

extern "C" {

// B4: every array holds n elements of the working type (float, or double
// when is_double), caps holds iters. Returns the cudaError_t of the launch
// (0 on success).
int wt_solve_ph(int is_double, const void* kw, const void* ka1,
                const void* ka2, const void* ct, const void* alk,
                const void* ph0, const void* caps, void* out, long long n,
                int iters, double tolerance, void* stream) {
  if (n < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return wt::launch<double>(kw, ka1, ka2, ct, alk, ph0, caps, out, n, iters,
                              tolerance, s);
  }
  return wt::launch<float>(kw, ka1, ka2, ct, alk, ph0, caps, out, n, iters,
                           tolerance, s);
}

const char* wt_ph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
