// V-ACT for Hopper (sm_90a): the paper's CORDIC activation unit.
//
// Replaces src/repro/kernels/vact/vact.py:
//   vact_ew_kernel      (body _ew_kernel, _apply_kind, _sigmoid_tile,
//                        _cordic_exp_tile)    -> vact_ew_kernel below
//   vact_ew_q8_kernel   (body _ew_q8_kernel)  -> vact_ew_q8_kernel
//   vact_softmax_kernel (body _softmax_kernel) -> vact_softmax_rows_kernel,
//                        vact_softmax_block_kernel
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
//
// vact_ew_q8: its input is int8 and its output a function of the code
// alone (given the scale, kind and n), so a call has at most 256
// distinct values.  Each block builds the 256-code table first -- one
// thread a code, exactly the per-element arithmetic of the reference
// (dequantize, CORDIC, requantize by rintf: round half to even, as
// jnp.round) -- while its first 16-byte load is in flight, then streams
// its elements as table lookups: the kernel is a byte stream, as the
// FPGA's quantized activation is a LUT.  The table keeps one copy of
// each entry in every bank (word code*32 + lane), so a warp's 32
// lookups never conflict.  Input and output share their offset within
// 16 bytes (the wrapper allocates so), and a thread moves 16 bytes a
// chunk, with the bytes before the first and after the last chunk
// taken one at a time.  ops.q8_plan sizes the grid.
//
// vact_softmax: the plain version (core/vact.py) is m = max(x), e =
// cordic_exp(x - m), e / sum(e).  Every exponential and quotient here
// rounds as there (__fsub_rn, the same cordic_exp_n, __fdiv_rn); only
// the order of the row sum differs.  ops.softmax_plan picks one of
// two kernels, each reading a row from memory once and writing it once:
//  * rows kernel, cols <= 32: kLanes = next_pow2(cols) lanes a row (a
//    template parameter), 32 / kLanes rows a warp, one element a lane,
//    max and sum by __shfl_xor_sync inside the row's lanes;
//  * block kernel, longer rows: one block a row (one warp up to 1024
//    elements, then at most 32 elements a thread), the first `staged`
//    elements kept in dynamic shared memory (up to 227 KB) between
//    the max, the exponentials and the quotients; a row past that
//    re-reads its tail from device memory and recomputes the tail's
//    exponentials in the same kernel.
// The iteration count is a template parameter (6, 13, one generic
// instance), as for vact_ew.  Rows are read at row stride `ld`, so a
// view whose leading axes fold into one stride is read in place.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

using qforce::CordicParams;

constexpr int kMaxEwThreads = 256;      // ops.EW_MAX_THREADS
constexpr int kQ8Threads = 256;         // ops.Q8_THREADS: one a code
constexpr int kMaxSoftmaxThreads = 1024;
constexpr int kSmemLimit = 232448;      // a block's shared memory
constexpr unsigned kFull = 0xffffffffu;

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

// four codes (the bytes of w) through the table: `mine` is this lane's
// copy, entry u at mine[u * 32]
__device__ __forceinline__ uint32_t lookup4(uint32_t w,
                                            const uint32_t* mine) {
  return mine[(w & 0xffu) << 5] | (mine[((w >> 8) & 0xffu) << 5] << 8) |
         (mine[((w >> 16) & 0xffu) << 5] << 16) | (mine[(w >> 24) << 5] << 24);
}

// qx, out: n int8 at the same offset within 16 bytes (else every byte
// is taken alone); sx: one fp32 on the device.
template <int kKind, int kN>
__global__ void __launch_bounds__(kQ8Threads)
vact_ew_q8_kernel(const int8_t* __restrict__ qx,
                  const float* __restrict__ sx, int8_t* __restrict__ out,
                  long long n, CordicParams p) {
  __shared__ uint32_t table[256 * 32];
  const int t = threadIdx.x;
  const uintptr_t a = reinterpret_cast<uintptr_t>(qx);
  const bool paired = ((a ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long head =
      paired ? min(n, static_cast<long long>((16 - (a & 15)) & 15)) : n;
  const long long chunks = (n - head) / 16;
  const long long tail = head + chunks * 16;
  const long long step = static_cast<long long>(gridDim.x) * kQ8Threads;
  const long long first = static_cast<long long>(blockIdx.x) * kQ8Threads + t;
  const uint4* src = reinterpret_cast<const uint4*>(qx + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (first < chunks) v = src[first];      // in flight while the table builds
  {
    // entry for the byte t, i.e. the code (int8)t
    const float x = __fmul_rn(static_cast<float>(static_cast<int8_t>(t)),
                              sx[0]);
    const float y = qforce::vact_apply<kKind, kN>(x, p);
    const float q = fminf(fmaxf(rintf(__fmul_rn(y, 127.f)), -127.f), 127.f);
    const uint32_t b = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
    // rotated, so one store instruction's 32 lanes hit 32 banks
#pragma unroll
    for (int j = 0; j < 32; ++j) table[t * 32 + ((j + t) & 31)] = b;
  }
  __syncthreads();
  const uint32_t* mine = table + (t & 31);
  for (long long i = first; i < chunks; i += step) {
    uint4 next = make_uint4(0, 0, 0, 0);
    if (i + step < chunks) next = src[i + step];
    uint4 w;
    w.x = lookup4(v.x, mine);
    w.y = lookup4(v.y, mine);
    w.z = lookup4(v.z, mine);
    w.w = lookup4(v.w, mine);
    dst[i] = w;
    v = next;
  }
  // the bytes before the first chunk and after the last
  const long long loose = head + (n - tail);
  for (long long i = first; i < loose; i += step) {
    const long long e = i < head ? i : tail + (i - head);
    out[e] = static_cast<int8_t>(mine[static_cast<uint8_t>(qx[e]) << 5]);
  }
}

// ---------------------------------------------------------------------------
// softmax
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the block's max (kMax) or sum of v, in every thread; red: 32 floats
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < static_cast<int>(blockDim.x >> 5) ? red[lane]
                                                       : (kMax ? -INFINITY
                                                               : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();                // red is free again
  return r;
}

template <int kN>
__device__ __forceinline__ float exp_shifted(float x, float mx,
                                             const CordicParams& p) {
  return qforce::cordic_exp_n<kN>(__fsub_rn(x, mx), p);
}

// cols <= 32: kLanes (a power of two >= cols) lanes a row, 32 / kLanes
// rows a warp; a grid stride of warps past the grid.  kLanes is a
// template parameter, so the row and lane come by shifts and the
// shuffles are unrolled: at the agent's sizes the kernel's time is this
// one chain of load, shuffles, CORDIC, shuffles and division.
template <int kN, int kLanes>
__global__ void __launch_bounds__(kMaxEwThreads)
vact_softmax_rows_kernel(const float* __restrict__ x,
                         float* __restrict__ out, long long rows, int cols,
                         long long ld, CordicParams p) {
  constexpr int kPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r0 = warp * kPerWarp; r0 < rows; r0 += warps * kPerWarp) {
    const long long r = r0 + lane / kLanes;
    const bool ok = r < rows && sub < cols;
    const float v = ok ? x[r * ld + sub] : -INFINITY;
    float mx = v;
#pragma unroll
    for (int o = kLanes >> 1; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float e = ok ? exp_shifted<kN>(v, mx, p) : 0.f;
    float s = e;
#pragma unroll
    for (int o = kLanes >> 1; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    if (ok) out[r * cols + sub] = __fdiv_rn(e, s);
  }
}

// one block a row, rows strided over the grid.  The row's first
// `staged` elements stay in shared memory from the read to the
// quotient; the rest (the tail of a row past shared memory) is read
// again for the exponentials and again for the quotients.  vec: rows,
// output and `staged` 16-byte aligned; a thread then owns float4s.
template <int kN>
__global__ void __launch_bounds__(kMaxSoftmaxThreads)
vact_softmax_block_kernel(const float* __restrict__ x,
                          float* __restrict__ out, long long rows, int cols,
                          long long ld, int staged, bool vec,
                          CordicParams p) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red[32];
  const int t = threadIdx.x, nt = blockDim.x;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* xr = x + r * ld;
    float* orow = out + r * cols;
    // the max; the staged head kept
    float mx = -INFINITY;
    if (vec) {
      for (int j = 4 * t; j < staged; j += 4 * nt) {
        const float4 f = *reinterpret_cast<const float4*>(xr + j);
        stage4[j / 4] = f;
        mx = fmaxf(mx, fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w)));
      }
      for (int j = staged + 4 * t; j < cols; j += 4 * nt) {
        const float4 f = *reinterpret_cast<const float4*>(xr + j);
        mx = fmaxf(mx, fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w)));
      }
    } else {
      for (int j = t; j < staged; j += nt) {
        const float f = xr[j];
        stage[j] = f;
        mx = fmaxf(mx, f);
      }
      for (int j = staged + t; j < cols; j += nt) mx = fmaxf(mx, xr[j]);
    }
    mx = block_reduce<true>(mx, red);
    // the exponentials (kept in place where staged) and their sum; each
    // thread touches the same staged elements in every pass
    float s = 0.f;
    if (vec) {
      for (int j = 4 * t; j < staged; j += 4 * nt) {
        float4 f = stage4[j / 4];
        f.x = exp_shifted<kN>(f.x, mx, p);
        f.y = exp_shifted<kN>(f.y, mx, p);
        f.z = exp_shifted<kN>(f.z, mx, p);
        f.w = exp_shifted<kN>(f.w, mx, p);
        stage4[j / 4] = f;
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, f.x), f.y), f.z), f.w);
      }
      for (int j = staged + 4 * t; j < cols; j += 4 * nt) {
        const float4 f = *reinterpret_cast<const float4*>(xr + j);
        s = __fadd_rn(s, exp_shifted<kN>(f.x, mx, p));
        s = __fadd_rn(s, exp_shifted<kN>(f.y, mx, p));
        s = __fadd_rn(s, exp_shifted<kN>(f.z, mx, p));
        s = __fadd_rn(s, exp_shifted<kN>(f.w, mx, p));
      }
    } else {
#pragma unroll 4
      for (int j = t; j < staged; j += nt) {
        const float e = exp_shifted<kN>(stage[j], mx, p);
        stage[j] = e;
        s = __fadd_rn(s, e);
      }
#pragma unroll 4
      for (int j = staged + t; j < cols; j += nt)
        s = __fadd_rn(s, exp_shifted<kN>(xr[j], mx, p));
    }
    s = block_reduce<false>(s, red);
    // the quotients
    if (vec) {
      for (int j = 4 * t; j < staged; j += 4 * nt) {
        const float4 f = stage4[j / 4];
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(__fdiv_rn(f.x, s), __fdiv_rn(f.y, s),
                        __fdiv_rn(f.z, s), __fdiv_rn(f.w, s));
      }
      for (int j = staged + 4 * t; j < cols; j += 4 * nt) {
        const float4 f = *reinterpret_cast<const float4*>(xr + j);
        *reinterpret_cast<float4*>(orow + j) = make_float4(
            __fdiv_rn(exp_shifted<kN>(f.x, mx, p), s),
            __fdiv_rn(exp_shifted<kN>(f.y, mx, p), s),
            __fdiv_rn(exp_shifted<kN>(f.z, mx, p), s),
            __fdiv_rn(exp_shifted<kN>(f.w, mx, p), s));
      }
    } else {
      for (int j = t; j < staged; j += nt) orow[j] = __fdiv_rn(stage[j], s);
#pragma unroll 4
      for (int j = staged + t; j < cols; j += nt)
        orow[j] = __fdiv_rn(exp_shifted<kN>(xr[j], mx, p), s);
    }
  }
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

struct Q8Args {
  const int8_t* qx;
  const float* sx;
  int8_t* out;
  long long n;
  int blocks;
  CordicParams p;
};

template <int kKind, int kN>
cudaError_t launch_q8_n(const Q8Args& a, cudaStream_t s) {
  vact_ew_q8_kernel<kKind, kN><<<a.blocks, kQ8Threads, 0, s>>>(
      a.qx, a.sx, a.out, a.n, a.p);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t launch_q8(const Q8Args& a, cudaStream_t s) {
  if constexpr (kKind == 0) {
    return launch_q8_n<0, 0>(a, s);
  } else {
    switch (a.p.n) {
      case 6: return launch_q8_n<kKind, 6>(a, s);
      case 13: return launch_q8_n<kKind, 13>(a, s);
      default: return launch_q8_n<kKind, 0>(a, s);
    }
  }
}

struct SoftmaxArgs {
  const float* x;
  float* out;
  long long rows;
  int cols;
  long long ld;
  int lanes, threads, blocks, staged;
  bool vec;
  CordicParams p;
};

template <int kN, int kLanes>
cudaError_t launch_softmax_rows(const SoftmaxArgs& a, cudaStream_t s) {
  vact_softmax_rows_kernel<kN, kLanes><<<a.blocks, a.threads, 0, s>>>(
      a.x, a.out, a.rows, a.cols, a.ld, a.p);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_softmax(int regime, const SoftmaxArgs& a,
                           cudaStream_t s) {
  if (regime == 0) {
    switch (a.lanes) {
      case 1: return launch_softmax_rows<kN, 1>(a, s);
      case 2: return launch_softmax_rows<kN, 2>(a, s);
      case 4: return launch_softmax_rows<kN, 4>(a, s);
      case 8: return launch_softmax_rows<kN, 8>(a, s);
      case 16: return launch_softmax_rows<kN, 16>(a, s);
      default: return launch_softmax_rows<kN, 32>(a, s);
    }
  }
  const int smem = 4 * a.staged;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vact_softmax_block_kernel<kN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  vact_softmax_block_kernel<kN><<<a.blocks, a.threads, smem, s>>>(
      a.x, a.out, a.rows, a.cols, a.ld, a.staged, a.vec, a.p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
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

// qx, out: n contiguous int8 (out at qx's offset within 16 bytes, or
// every byte is taken alone); sx: one fp32 on the device.  The launch
// follows ops.q8_plan: `threads` must be Q8_THREADS (one a code).
extern "C" int qforce_vact_ew_q8(int device, void* stream, const void* qx,
                                 const void* sx, void* out, long long n,
                                 int kind, int threads, int blocks,
                                 CordicParams p) {
  cudaSetDevice(device);
  const Q8Args a{static_cast<const int8_t*>(qx),
                 static_cast<const float*>(sx), static_cast<int8_t*>(out),
                 n, blocks, p};
  if (n < 1 || threads != kQ8Threads || blocks < 1 || p.n < 1 ||
      p.n > qforce::kMaxIters)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(launch_q8<0>(a, s));
    case 1: return static_cast<int>(launch_q8<1>(a, s));
    case 2: return static_cast<int>(launch_q8<2>(a, s));
    default: return -1;
  }
}

// x: [rows, cols] fp32 at row stride ld elements, out: [rows, cols]
// contiguous fp32, softmax over each row.  The launch follows
// ops.softmax_plan: regime 0 (rows kernel, `lanes` a row) or 1 (block
// kernel, `staged` elements in shared memory), `threads` a block,
// `blocks`.  The block kernel reads float4s where x, ld, cols and
// `staged` allow.
extern "C" int qforce_vact_softmax(int device, void* stream, const void* x,
                                   void* out, long long rows, long long cols,
                                   long long ld, int regime, int lanes,
                                   int threads, int blocks, int staged,
                                   CordicParams p) {
  cudaSetDevice(device);
  if (rows < 1 || cols < 1 || cols > (1LL << 30) || ld < 0 ||
      threads < 32 || threads % 32 != 0 || blocks < 1 || p.n < 1 ||
      p.n > qforce::kMaxIters)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(cols);
  bool ok = false;
  if (regime == 0)
    ok = threads <= kMaxEwThreads && lanes >= c && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0;
  else if (regime == 1)
    ok = threads <= kMaxSoftmaxThreads && staged >= 0 && staged <= c &&
         4LL * staged + 32 * 4 <= kSmemLimit;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool rows16 = aligned16(x) && aligned16(out) && ld % 4 == 0 &&
                      c % 4 == 0;
  const SoftmaxArgs a{static_cast<const float*>(x), static_cast<float*>(out),
                      rows, c, ld, lanes, threads, blocks, staged,
                      rows16 && staged % 4 == 0, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.n) {
    case 6: return static_cast<int>(launch_softmax<6>(regime, a, s));
    case 13: return static_cast<int>(launch_softmax<13>(regime, a, s));
    default: return static_cast<int>(launch_softmax<0>(regime, a, s));
  }
}
