// One damped Newton iteration of the equilibrium-pH solve (kernel B4), for
// csrc/ph_solver.cu and tools/torch_b4_probe.cu.
//
// The iteration is written once, with its seven divisions passed in as a
// functor ``divide(k, a, b)`` (k = 0..6 in the order below): the kernel
// divides with IeeeDiv, the probe wraps each division in clock stamps.
// Operations and their order are those of the plain PyTorch version
// (ops/ph_solver.py::ph_plain); built with -fmad=false the two agree bit
// for bit.

#pragma once

namespace wt {
namespace ph {

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

// The IEEE quotient, as written in the plain version.
struct IeeeDiv {
  template <typename S>
  __device__ __forceinline__ S operator()(int, S a, S b) const {
    return a / b;
  }
};

// The capped Newton step from ``ph`` on the carbonate charge balance
//   f(pH) = [H+] - Kw/[H+] + (alpha1 + 2 alpha2) C_T - alk
// with its analytic derivative.
template <typename S, typename Div>
__device__ __forceinline__ S newton_delta(S ph, S kw, S ka1, S ka2, S ct,
                                          S alk, S cap, const Div& divide) {
  const S h = wexp(S(-kLn10) * ph);
  const S oh = divide(0, kw, h);
  const S d = h * h + ka1 * h + ka1 * ka2;
  const S a1 = divide(1, ka1 * h, d);
  const S a2 = divide(2, ka1 * ka2, d);
  const S f = h - oh + a1 * ct + S(2.0) * a2 * ct - alk;

  const S dh_dph = S(-kLn10) * h;
  const S doh_dph = -divide(3, kw, h * h) * dh_dph;
  const S dd_dh = S(2.0) * h + ka1;
  const S da1_dh = divide(4, ka1 * (d - h * dd_dh), d * d);
  const S da2_dh = divide(5, -ka1 * ka2 * dd_dh, d * d);
  const S df = dh_dph - doh_dph + ct * da1_dh * dh_dph +
               S(2.0) * ct * da2_dh * dh_dph;
  return nclip(divide(6, -f, df), -cap, cap);
}

}  // namespace ph
}  // namespace wt
