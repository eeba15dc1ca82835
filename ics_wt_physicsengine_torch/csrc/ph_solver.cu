// Equilibrium-pH Newton solver for the H100 (sm_90a), bound with ctypes.
//
// B4 (wt_solve_ph) replaces _ph_newton_kernel in
// ics_wt_physicsengine_tpu/ops/ph_solver.py: for every element of a flat
// array, up to `iters` iterations of damped Newton-Raphson on the carbonate
// charge balance (ph_newton.cuh), the step capped at caps[i] in iteration i
// and pH clipped to [0, 14]. An element whose step fell below `tolerance`
// is done: that step is still applied, later ones are not.
//
// What bounds it: the iterations an element needs, not the `iters` the TPU
// kernel runs in lockstep. On the Monte-Carlo titration (PH-TITR) an
// element needs 5 iterations at the median and 11-13 on average, and a
// done element never changes again, so a thread that keeps iterating a
// done element (or waits for the slowest element of its warp) spends
// 87-95% of its work on nothing. Counted over the live iterations the
// arithmetic (52 operations an iteration) and the bytes (six inputs read,
// one output written) weigh about alike on an H100; the kernel is held to
// that bound (ops/ph_solver.py::ph_live_iters, PERF.md).
//
// Design: a lane takes a new element as soon as its own is done.
// - The grid comes from the host (ops/ph_solver.py::ph_geometry): three
//   blocks of 256 an SM when there are more elements than those lanes
//   (the blocks then stay until the work is gone), else the elements
//   spread over every SM at about one a lane.
// - Work is handed out in runs of 32 consecutive elements. A warp's first
//   run is fixed (warp w of block b takes run w * gridDim + b, so the
//   first runs spread over the SMs); where those do not cover every run,
//   later runs come from a counter shared by the launch, one atomicAdd by
//   lane 0 per run. Once refill_at<S>() of its lanes are done, they take
//   the next elements of the warp's run in the order of their lane (a
//   ballot, their rank by __popc), so the six loads of a refill touch
//   consecutive addresses. The warp leaves when no run is left and all
//   its lanes are done.
// - The refill rule is the working type's, from measured times
//   (tools/torch_b4_compare.py --ablate, PERF.md): float32 refills at 8
//   idle lanes, where the elements that never meet the tolerance are
//   scattered over the warps; float64 only once all 32 are idle (an exit
//   per warp), where a warp's elements need similar counts and a refill's
//   loads cost more than the idle lanes it fills.
// - The counter (`work`: the next run, the warps finished) belongs to one
//   launch: the wrapper keeps one pair per stream, zeroed when made, and
//   the launch's last warp sets it back to zero, so no launch pays for a
//   memset and two streams never share a counter.
// - Once a warp has no run left (and has taken kCompactAt turns), it
//   parks its unfinished elements in shared memory at a block barrier;
//   the block's first warps take them back, packed, and finish them. The
//   few elements that never meet the tolerance (3% of PH-EQ's float32
//   waters, each running all `iters`) then no longer keep a warp each
//   issuing for one or two lanes.
// - Each lane carries its own iteration count, so lanes sit at different
//   iterations and read the cap table through the read-only cache (a copy
//   in shared memory measured no faster).
// - The iteration's arithmetic is the plain version's, operation for
//   operation (-fmad=false, IEEE divisions), so the result is bit-equal to
//   it, and to the lockstep kernel, whatever the schedule.
//
// What was measured and left out (tools/torch_b4_compare.py, PERF.md):
// the divisions stay IEEE divisions: the Newton step's slow path (a zero
// f at the root) costs ~1% of a float32 iteration, and both a zero guard
// and branch-free divisions lengthened the iteration's chain by more;
// prefetching the next run into shared memory and counters per block or
// per group of blocks were no faster than this one counter.
//
// Rounding: bit equality matters in float32, where a tolerance of 1e-6
// lies below the resolution of pH near the root: an element that cannot
// meet it keeps stepping inside the decayed cap until `iters`, and one
// differently rounded operation would flip |delta| < tolerance and move
// the result by up to the cap.

#include <cstdint>

#include "ph_newton.cuh"

namespace wt {
namespace ph {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kCompactAt = 16;      // a warp's turns before it may park
constexpr int kInputs = 6;          // kw, ka1, ka2, ct, alk, ph
constexpr unsigned kFullMask = 0xffffffffu;

// Idle lanes of a warp at which they take new elements (see above).
template <typename S>
__host__ __device__ constexpr int refill_at() {
  return sizeof(S) == sizeof(double) ? kWarp : 8;
}

// Dynamic shared memory of a block of `threads`: a parking place for each
// thread's element (index, inputs and pH, iteration).
template <typename S>
__host__ __device__ constexpr size_t shared_bytes(int threads) {
  return threads * (sizeof(int64_t) + kInputs * sizeof(S) + sizeof(int));
}

template <typename S>
__global__ void __launch_bounds__(kMaxThreads)
ph_newton_kernel(const S* __restrict__ kw_in, const S* __restrict__ ka1_in,
                 const S* __restrict__ ka2_in, const S* __restrict__ ct_in,
                 const S* __restrict__ alk_in, const S* __restrict__ ph0,
                 const S* __restrict__ caps_in, S* __restrict__ out,
                 int64_t n, int iters, S tolerance,
                 unsigned long long* __restrict__ work) {
  extern __shared__ __align__(8) unsigned char ph_smem[];
  int64_t* const park_idx = reinterpret_cast<int64_t*>(ph_smem);
  S* const park = reinterpret_cast<S*>(park_idx + blockDim.x);
  int* const park_i = reinterpret_cast<int*>(park + kInputs * blockDim.x);
  __shared__ int parked;
  if (threadIdx.x == 0) parked = 0;
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const int64_t total_warps =
      static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);

  // the warp's run: elements [next, end) not yet handed out; later runs
  // come from the counter only where the first runs do not cover them all
  // (else `more` ends with the first run)
  const bool dynamic = (n + kWarp - 1) / kWarp > total_warps;
  int64_t next = (static_cast<int64_t>(threadIdx.x / kWarp) * gridDim.x +
                  blockIdx.x) * kWarp;
  int64_t end = next + kWarp < n ? next + kWarp : n;
  bool more = next < n;

  int64_t idx = 0;
  int i = 0;
  bool active = false;
  S kw = S(0.0), ka1 = S(0.0), ka2 = S(0.0), ct = S(0.0), alk = S(0.0);
  S ph = S(0.0);
  // one iteration of the lane's element; a done element is stored
  const auto step = [&]() {
    bool converged = false;
    if (i < iters) {
      const S cap = __ldg(caps_in + i);
      const S delta = newton_delta(ph, kw, ka1, ka2, ct, alk, cap,
                                   IeeeDiv());
      ph = nclip(ph + delta, S(0.0), S(14.0));
      converged = wabs(delta) < tolerance;
      ++i;
    }
    if (converged || i >= iters) {
      out[idx] = ph;
      active = false;
    }
  };
  for (int turn = 0;; ++turn) {
    // lanes without an element take the next ones of the run, in order
    bool fresh = false;
    unsigned need = __ballot_sync(kFullMask, !active);
    while (__popc(need) >= refill_at<S>() && more) {
      if (next >= end) {
        unsigned long long run = 0;
        if (dynamic && lane == 0) run = atomicAdd(work, 1ull) + total_warps;
        run = __shfl_sync(kFullMask, run, 0);
        next = static_cast<int64_t>(run) * kWarp;
        end = next + kWarp < n ? next + kWarp : n;
        more = dynamic && next < n;
        continue;
      }
      const int64_t avail = end - next;
      const int rank = __popc(need & below);
      if (!active && rank < avail) {
        idx = next + rank;
        active = true;
        fresh = true;
      }
      const int64_t wanted = __popc(need);
      next += wanted < avail ? wanted : avail;
      more = dynamic || next < end;
      need = __ballot_sync(kFullMask, !active);
    }
    if (fresh) {
      kw = kw_in[idx];
      ka1 = ka1_in[idx];
      ka2 = ka2_in[idx];
      ct = ct_in[idx];
      alk = alk_in[idx];
      ph = ph0[idx];
      i = 0;
    }
    // a warp with no run left parks once it has taken kCompactAt turns
    // (or has nothing left to iterate)
    if (!more &&
        (turn >= kCompactAt || !__any_sync(kFullMask, active))) {
      break;
    }
    if (active) step();
  }

  // Every warp of the block parks its unfinished elements; they are then
  // packed into the block's first warps, which finish them, so the few
  // elements that need many iterations no longer hold one warp each.
  if (active) {
    const int slot = atomicAdd(&parked, 1);
    park_idx[slot] = idx;
    park_i[slot] = i;
    park[0 * blockDim.x + slot] = kw;
    park[1 * blockDim.x + slot] = ka1;
    park[2 * blockDim.x + slot] = ka2;
    park[3 * blockDim.x + slot] = ct;
    park[4 * blockDim.x + slot] = alk;
    park[5 * blockDim.x + slot] = ph;
  }
  __syncthreads();
  active = static_cast<int>(threadIdx.x) < parked;
  if (active) {
    idx = park_idx[threadIdx.x];
    i = park_i[threadIdx.x];
    kw = park[0 * blockDim.x + threadIdx.x];
    ka1 = park[1 * blockDim.x + threadIdx.x];
    ka2 = park[2 * blockDim.x + threadIdx.x];
    ct = park[3 * blockDim.x + threadIdx.x];
    alk = park[4 * blockDim.x + threadIdx.x];
    ph = park[5 * blockDim.x + threadIdx.x];
  }
  while (__any_sync(kFullMask, active)) {
    if (active) step();
  }

  // the launch's last warp sets the counter back for the next launch
  if (dynamic && lane == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1ull) + 1ull ==
        static_cast<unsigned long long>(total_warps)) {
      work[0] = 0ull;
      work[1] = 0ull;
    }
  }
}

template <typename S>
int launch(const void* kw, const void* ka1, const void* ka2, const void* ct,
           const void* alk, const void* ph0, const void* caps, void* out,
           int64_t n, int iters, double tolerance, int blocks, int threads,
           unsigned long long* work, cudaStream_t stream) {
  ph_newton_kernel<S><<<dim3(blocks), dim3(threads), shared_bytes<S>(threads),
                        stream>>>(
      static_cast<const S*>(kw), static_cast<const S*>(ka1),
      static_cast<const S*>(ka2), static_cast<const S*>(ct),
      static_cast<const S*>(alk), static_cast<const S*>(ph0),
      static_cast<const S*>(caps), static_cast<S*>(out), n, iters,
      static_cast<S>(tolerance), work);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int blocks_per_sm(int threads) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ph_newton_kernel<S>, threads, shared_bytes<S>(threads));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace ph
}  // namespace wt

extern "C" {

// B4: every array holds n elements of the working type (float, or double
// when is_double), caps holds iters; `blocks` x `threads` is the grid
// (threads a whole number of warps, at most 256), `work` two unsigned
// 64-bit counters that are zero and that no other launch uses until this
// one has ended (it leaves them zero). Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for anything it cannot run.
int wt_solve_ph(int is_double, const void* kw, const void* ka1,
                const void* ka2, const void* ct, const void* alk,
                const void* ph0, const void* caps, void* out, long long n,
                int iters, double tolerance, int blocks, int threads,
                void* work, void* stream) {
  if (n < 1 || iters < 0 || blocks < 1 || threads < wt::ph::kWarp ||
      threads > wt::ph::kMaxThreads || threads % wt::ph::kWarp != 0 ||
      work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<unsigned long long*>(work);
  if (is_double) {
    return wt::ph::launch<double>(kw, ka1, ka2, ct, alk, ph0, caps, out, n,
                                  iters, tolerance, blocks, threads, w, s);
  }
  return wt::ph::launch<float>(kw, ka1, ka2, ct, alk, ph0, caps, out, n,
                               iters, tolerance, blocks, threads, w, s);
}

// Blocks of `threads` threads that one SM holds at once for this type
// (the occupancy calculator), or minus a cudaError_t.
int wt_ph_blocks_per_sm(int is_double, int threads) {
  return is_double ? wt::ph::blocks_per_sm<double>(threads)
                   : wt::ph::blocks_per_sm<float>(threads);
}

const char* wt_ph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
