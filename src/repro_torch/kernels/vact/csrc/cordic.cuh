// Hyperbolic CORDIC for Hopper: the V-ACT datapath as device functions,
// shared by the V-ACT kernels (vact.cu) and the fused Q-LSTM cell
// (../../qlstm/csrc/qlstm.cu).
//
// Rounds exactly like repro_torch.core.vact (and repro.core.vact):
//     m   = floor(x / ln2)            IEEE division
//     r   = x - m * ln2               separate multiply and subtract
//     CORDIC: x' = x + (d*y)*2^-i, y' = y + (d*x)*2^-i, z' = z -/+ atanh
//     e^x = (sinh r + cosh r) * 2^clamp(m, -126, 126)
// with 2^m built from its exponent bits (exact), so the scaling is one
// correctly rounded multiply, as jnp.ldexp is.  Every constant arrives
// from the host already rounded to fp32 by the same Python expressions
// the plain version uses (CordicParams), and the library is built with
// --fmad=false, so no multiply-add is contracted.
#pragma once

#include <cuda_runtime.h>

namespace qforce {

constexpr int kMaxIters = 24;

// passed by value from the host (ctypes.Structure of the same layout)
struct CordicParams {
  int n;                    // iterations, 1..kMaxIters
  float inv_gain;           // fp32(1 / cordic_gain(schedule))
  float ln2;                // fp32(log 2)
  float shift[kMaxIters];   // 2^-i for the k-th scheduled i
  float atanh[kMaxIters];   // fp32(atanh(2^-i)) for the k-th scheduled i
};

// e^x.  kN > 0: exactly kN iterations, fully unrolled with no exit test
// (the caller dispatches on p.n, so p.n == kN); kN == 0: p.n iterations
// behind a uniform exit, for any n in 1..kMaxIters.
template <int kN>
__device__ __forceinline__ float cordic_exp_n(float x, const CordicParams& p) {
  const float m = floorf(__fdiv_rn(x, p.ln2));
  const float r = __fsub_rn(x, __fmul_rn(m, p.ln2));
  float cx = p.inv_gain, cy = 0.f, zz = r;
#pragma unroll
  for (int k = 0; k < (kN > 0 ? kN : kMaxIters); ++k) {
    if (kN == 0 && k >= p.n) break;     // uniform across the grid
    const bool pos = zz >= 0.f;
    const float dy = __fmul_rn(pos ? cy : -cy, p.shift[k]);
    const float dx = __fmul_rn(pos ? cx : -cx, p.shift[k]);
    cx = __fadd_rn(cx, dy);
    cy = __fadd_rn(cy, dx);
    zz = pos ? __fsub_rn(zz, p.atanh[k]) : __fadd_rn(zz, p.atanh[k]);
  }
  const float e_r = __fadd_rn(cy, cx);
  const int mi = static_cast<int>(fminf(fmaxf(m, -126.f), 126.f));
  return __fmul_rn(e_r, __int_as_float((mi + 127) << 23));
}

template <int kN>
__device__ __forceinline__ float cordic_sigmoid_n(float x,
                                                  const CordicParams& p) {
  const float e = cordic_exp_n<kN>(-fabsf(x), p);   // e^{-|x|} in (0, 1]
  const float pos = __fdiv_rn(1.f, __fadd_rn(1.f, e));
  return x >= 0.f ? pos : __fsub_rn(1.f, pos);
}

// tanh(x) = 2 sigmoid(2x) - 1, as the reference composes it
template <int kN>
__device__ __forceinline__ float cordic_tanh_n(float x, const CordicParams& p) {
  return __fsub_rn(__fmul_rn(2.f, cordic_sigmoid_n<kN>(__fmul_rn(2.f, x), p)),
                   1.f);
}

// kind: 0 relu (a mux, as jax.nn.relu: NaN passes, -0 gives +0),
// 1 sigmoid, 2 tanh; kN as for cordic_exp_n
template <int kKind, int kN = 0>
__device__ __forceinline__ float vact_apply(float x, const CordicParams& p) {
  if (kKind == 0) return (x > 0.f || x != x) ? x : 0.f;
  if (kKind == 1) return cordic_sigmoid_n<kN>(x, p);
  return cordic_tanh_n<kN>(x, p);
}

}  // namespace qforce
