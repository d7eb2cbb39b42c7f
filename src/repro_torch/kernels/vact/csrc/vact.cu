// V-ACT for Hopper (sm_90a): the paper's CORDIC activation unit.
//
// Replaces src/repro/kernels/vact/vact.py:
//   vact_ew_kernel      (body _ew_kernel, _apply_kind, _sigmoid_tile,
//                        _cordic_exp_tile)    -> vact_ew_kernel below
//   vact_ew_q8_kernel   (body _ew_q8_kernel)  -> vact_ew_q8_kernel
//   vact_softmax_kernel (body _softmax_kernel) -> vact_softmax_kernel
// The CORDIC itself is cordic.cuh, shared with the Q-LSTM cell.
//
// What bounds it on this card: each element costs ~5 + 8*n fp32 ops
// (n = 6 CORDIC iterations at FxP8, 13 at the kernel's default) against
// 8 bytes moved (4 for int8 in/out), so at large sizes it is bound by
// bytes; on the agent's path the tensors are a few thousand elements
// ([B, 8] sub-goal, [B, 32] LSTM gates, [B, 4] logits), so one wave of
// a few blocks and the launch latency are the kernel's time.
//
// What the design does about it: one thread per element over the
// flattened tensor (grid-stride, tail masked), so there is no padding
// to (bm, bn) tiles in HBM as the Pallas wrapper does, and no shape
// beyond the element count; the activation kind is a template
// parameter and the CORDIC loop is unrolled to its 24-iteration maximum
// behind a uniform exit.  The int8 variant dequantizes on load and
// requantizes on store (rintf: round half to even, as jnp.round), so
// the fp32 value never reaches HBM.  Softmax gives each row one warp:
// max and sum by shuffles, exp by CORDIC, written once and divided in
// place by the same lane.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

using qforce::CordicParams;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

template <int kKind>
__global__ void __launch_bounds__(kThreads)
vact_ew_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, CordicParams p) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += step)
    out[i] = qforce::vact_apply<kKind>(x[i], p);
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
vact_ew_q8_kernel(const int8_t* __restrict__ qx,
                  const float* __restrict__ sx, int8_t* __restrict__ out,
                  long long n, CordicParams p) {
  const float s = sx[0];
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += step) {
    const float x = __fmul_rn(static_cast<float>(qx[i]), s);
    const float y = qforce::vact_apply<kKind>(x, p);
    const float q = fminf(fmaxf(rintf(__fmul_rn(y, 127.f)), -127.f), 127.f);
    out[i] = static_cast<int8_t>(q);
  }
}

// one warp per row of length N
__global__ void __launch_bounds__(kThreads)
vact_softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int M, int N, CordicParams p) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const float* xr = x + static_cast<long long>(row) * N;
  float* orow = out + static_cast<long long>(row) * N;
  float mx = -INFINITY;
  for (int j = lane; j < N; j += 32) mx = fmaxf(mx, xr[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = qforce::cordic_exp(__fsub_rn(xr[j], mx), p);
    orow[j] = e;
    sum = __fadd_rn(sum, e);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  for (int j = lane; j < N; j += 32) orow[j] = __fdiv_rn(orow[j], sum);
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// x, out: n contiguous fp32; kind 0 relu, 1 sigmoid, 2 tanh.  Launches
// on `stream`; returns cudaGetLastError() (-1 for an unknown kind).
extern "C" int qforce_vact_ew(int device, void* stream, const void* x,
                              void* out, long long n, int kind,
                              CordicParams p) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const int g = blocks_for(n);
  switch (kind) {
    case 0: vact_ew_kernel<0><<<g, kThreads, 0, s>>>(xi, o, n, p); break;
    case 1: vact_ew_kernel<1><<<g, kThreads, 0, s>>>(xi, o, n, p); break;
    case 2: vact_ew_kernel<2><<<g, kThreads, 0, s>>>(xi, o, n, p); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// qx, out: n contiguous int8; sx: one fp32 on the device.
extern "C" int qforce_vact_ew_q8(int device, void* stream, const void* qx,
                                 const void* sx, void* out, long long n,
                                 int kind, CordicParams p) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(qx);
  const float* sf = static_cast<const float*>(sx);
  int8_t* o = static_cast<int8_t*>(out);
  const int g = blocks_for(n);
  switch (kind) {
    case 0: vact_ew_q8_kernel<0><<<g, kThreads, 0, s>>>(qi, sf, o, n, p);
            break;
    case 1: vact_ew_q8_kernel<1><<<g, kThreads, 0, s>>>(qi, sf, o, n, p);
            break;
    case 2: vact_ew_q8_kernel<2><<<g, kThreads, 0, s>>>(qi, sf, o, n, p);
            break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: [M, N] contiguous fp32, softmax over each row.
extern "C" int qforce_vact_softmax(int device, void* stream, const void* x,
                                   void* out, int M, int N,
                                   CordicParams p) {
  cudaSetDevice(device);
  constexpr int kRowsPerBlock = kThreads / 32;
  const int g = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  vact_softmax_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), M, N, p);
  return static_cast<int>(cudaGetLastError());
}
