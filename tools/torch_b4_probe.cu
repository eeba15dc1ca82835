// Cycle probe of kernel B4's Newton iteration, for
// tools/torch_b4_compare.py --probe (never shipped, never launched by the
// package).
//
// Lanes solve their elements (a stride over them) with the iteration of
// csrc/ph_newton.cuh and the kernel's stopping rule: one lane a warp
// (`all_lanes` = 0: every stamp times one element alone, no other lane of
// its warp diverging into a slow path beside it) or all 32 (each lane's
// own elements, the warp's turn as the kernel sees it). Modes:
//   0: clock64() around each live iteration, binned by kIterBin cycles
//      into iter_hist[kBins];
//   1: clock64() around each of the iteration's seven IEEE divisions,
//      from its operands being ready to its quotient being ready, binned
//      by kDivBin cycles into div_hist[7][kBins].
// A stamp is taken only after the value it closes is ready: a volatile
// store consumes that value first, and a warp issues in order. Each
// element's live iterations and final pH go to live_out and ph_out, to be
// held against the kernel and ops/ph_solver.py::ph_live_iters.

#include <cstdint>

#include "ph_newton.cuh"

namespace wt {
namespace ph {
namespace probe {

constexpr int kBins = 256;
constexpr int kDivBin = 8;
constexpr int kIterBin = 16;

template <typename S>
__device__ __forceinline__ void consume(S x, S* sink) {
  *reinterpret_cast<volatile S*>(sink) = x;
}

__device__ __forceinline__ int bin(long long cycles, int width) {
  const long long b = cycles / width;
  return b < kBins - 1 ? static_cast<int>(b) : kBins - 1;
}

template <typename S>
struct StampedDiv {
  unsigned long long* hist;
  S* sink;
  __device__ __forceinline__ S operator()(int k, S a, S b) const {
    consume(a, sink);
    consume(b, sink);
    const long long t0 = clock64();
    const S q = IeeeDiv()(k, a, b);
    consume(q, sink);
    const long long t1 = clock64();
    atomicAdd(hist + k * kBins + bin(t1 - t0, kDivBin), 1ull);
    return q;
  }
};

template <typename S, int kMode>
__global__ void probe_kernel(const S* __restrict__ kw_in,
                             const S* __restrict__ ka1_in,
                             const S* __restrict__ ka2_in,
                             const S* __restrict__ ct_in,
                             const S* __restrict__ alk_in,
                             const S* __restrict__ ph0,
                             const S* __restrict__ caps, int64_t n, int iters,
                             S tolerance, int all_lanes,
                             unsigned long long* div_hist,
                             unsigned long long* iter_hist, int* live_out,
                             S* ph_out, S* sink) {
  const int per_warp = all_lanes ? 32 : 1;
  if (threadIdx.x % 32 >= per_warp) return;
  const int64_t lanes =
      static_cast<int64_t>(gridDim.x) * (blockDim.x / 32) * per_warp;
  const int64_t me = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                      threadIdx.x / 32) * per_warp + threadIdx.x % 32;
  S* my_sink = sink + me;
  for (int64_t e = me; e < n; e += lanes) {
    const S kw = kw_in[e], ka1 = ka1_in[e], ka2 = ka2_in[e], ct = ct_in[e];
    const S alk = alk_in[e];
    S ph = ph0[e];
    int i = 0;
    while (i < iters) {
      S delta;
      const S cap = __ldg(caps + i);
      if (kMode == 1) {
        delta = newton_delta(ph, kw, ka1, ka2, ct, alk, cap,
                             StampedDiv<S>{div_hist, my_sink});
        ph = nclip(ph + delta, S(0.0), S(14.0));
      } else {
        consume(ph, my_sink);
        const long long t0 = clock64();
        delta = newton_delta(ph, kw, ka1, ka2, ct, alk, cap, IeeeDiv());
        ph = nclip(ph + delta, S(0.0), S(14.0));
        consume(ph, my_sink);
        const long long t1 = clock64();
        atomicAdd(iter_hist + bin(t1 - t0, kIterBin), 1ull);
      }
      ++i;
      if (wabs(delta) < tolerance) break;
    }
    live_out[e] = i;
    ph_out[e] = ph;
  }
}

template <typename S>
int launch(int mode, int all_lanes, const void* const* in, const void* caps,
           int64_t n, int iters, double tolerance,
           unsigned long long* div_hist, unsigned long long* iter_hist,
           int* live_out, void* ph_out, void* sink, int blocks, int threads,
           cudaStream_t stream) {
  auto kernel = mode == 0 ? probe_kernel<S, 0> : probe_kernel<S, 1>;
  kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const S*>(in[0]), static_cast<const S*>(in[1]),
      static_cast<const S*>(in[2]), static_cast<const S*>(in[3]),
      static_cast<const S*>(in[4]), static_cast<const S*>(in[5]),
      static_cast<const S*>(caps), n, iters, static_cast<S>(tolerance),
      all_lanes, div_hist, iter_hist, live_out, static_cast<S*>(ph_out),
      static_cast<S*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe
}  // namespace ph
}  // namespace wt

// in: the six flat inputs (kw, ka1, ka2, ct, alk, ph0); sink holds one
// value per probing lane of the grid.
extern "C" int wt_b4_probe(int is_double, int mode, int all_lanes,
                           const void* const* in, const void* caps,
                           long long n, int iters, double tolerance,
                           unsigned long long* div_hist,
                           unsigned long long* iter_hist, int* live_out,
                           void* ph_out, void* sink, int blocks, int threads,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return wt::ph::probe::launch<double>(mode, all_lanes, in, caps, n, iters,
                                         tolerance, div_hist, iter_hist,
                                         live_out, ph_out, sink, blocks,
                                         threads, s);
  }
  return wt::ph::probe::launch<float>(mode, all_lanes, in, caps, n, iters,
                                      tolerance, div_hist, iter_hist,
                                      live_out, ph_out, sink, blocks, threads,
                                      s);
}
