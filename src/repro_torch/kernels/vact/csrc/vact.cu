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
// ([B, 8] sub-goal, [B, 32] LSTM gates, [B, 4] logits), so the launch
// and one thread's chain of dependent CORDIC steps are the kernel's
// time.
//
// What vact_ew's design does about it:
//  * it reads a strided [rows, cols] operand (unit stride along cols,
//    `ld` elements between rows) and writes a contiguous [rows, cols]
//    output, so the LSTM's gate slices of the [B, 4H] gate tensor are
//    read in place, with no copy launched before each activation;
//  * the iteration count is a template parameter for the policies'
//    counts (6 at FxP8, 13 by default): the CORDIC is unrolled with no
//    exit test; one generic instance takes any other n;
//  * one element a thread: a thread's time is its chain of dependent
//    CORDIC steps, with two IEEE divisions, and a second chain in the
//    same thread lengthens it (tools/kernel_probe.py ew); ops.ew_plan
//    spreads a small tensor over many SMs in small blocks rather than
//    over a few full ones, and past its cap the grid strides.
// The int8 variant dequantizes on load and requantizes on store (rintf:
// round half to even, as jnp.round), so the fp32 value never reaches
// HBM.  Softmax gives each row one warp: max and sum by shuffles, exp by
// CORDIC, written once and divided in place by the same lane.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

using qforce::CordicParams;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

constexpr int kMaxEwThreads = 256;   // ops.EW_MAX_THREADS

// the row of element e in rows of `cols`: a 32-bit divide where both fit
__device__ __forceinline__ long long row_of(long long e, long long cols) {
  if (e <= 0xffffffffLL && cols <= 0xffffffffLL)
    return static_cast<unsigned>(e) / static_cast<unsigned>(cols);
  return e / cols;
}

// x: [rows, cols] at row stride ld (elements); out: [rows, cols]
// contiguous.  One element a thread, a grid stride past the grid.
template <int kKind, int kN>
__global__ void __launch_bounds__(kMaxEwThreads)
vact_ew_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long rows, long long cols, long long ld,
               CordicParams p) {
  const long long n = rows * cols;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += step) {
    const long long r = rows == 1 ? 0 : row_of(e, cols);
    out[e] = qforce::vact_apply<kKind, kN>(x[r * ld + (e - r * cols)], p);
  }
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
    const float e = qforce::cordic_exp_n<0>(__fsub_rn(xr[j], mx), p);
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

struct EwArgs {
  const float* x;
  float* out;
  long long rows, cols, ld;
  int threads, blocks;
  CordicParams p;
};

template <int kKind, int kN>
cudaError_t launch_ew_n(const EwArgs& a, cudaStream_t s) {
  vact_ew_kernel<kKind, kN><<<a.blocks, a.threads, 0, s>>>(
      a.x, a.out, a.rows, a.cols, a.ld, a.p);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t launch_ew(const EwArgs& a, cudaStream_t s) {
  if constexpr (kKind == 0) {
    return launch_ew_n<0, 0>(a, s);      // relu: no CORDIC
  } else {
    switch (a.p.n) {
      case 6: return launch_ew_n<kKind, 6>(a, s);
      case 13: return launch_ew_n<kKind, 13>(a, s);
      default: return launch_ew_n<kKind, 0>(a, s);
    }
  }
}

}  // namespace

// x: [rows, cols] fp32 at row stride ld elements, out: [rows, cols]
// contiguous fp32; kind 0 relu, 1 sigmoid, 2 tanh.  The launch follows
// ops.ew_plan: threads a block, blocks.  Launches on `stream`; returns
// cudaGetLastError() (-1 for an unknown kind).
extern "C" int qforce_vact_ew(int device, void* stream, const void* x,
                              void* out, long long rows, long long cols,
                              long long ld, int kind, int threads,
                              int blocks, CordicParams p) {
  cudaSetDevice(device);
  const EwArgs a{static_cast<const float*>(x), static_cast<float*>(out),
                 rows, cols, ld, threads, blocks, p};
  if (rows < 1 || cols < 1 || ld < 0 || threads < 32 ||
      threads > kMaxEwThreads || threads % 32 != 0 || blocks < 1 ||
      p.n < 1 || p.n > qforce::kMaxIters)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(launch_ew<0>(a, s));
    case 1: return static_cast<int>(launch_ew<1>(a, s));
    case 2: return static_cast<int>(launch_ew<2>(a, s));
    default: return -1;
  }
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
