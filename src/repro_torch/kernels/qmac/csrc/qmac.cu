// Q-MAC for Hopper (sm_90a): int8 [M,K] x int8 [K,N] -> int32 [M,N],
// with an optional fused dequant epilogue out = (acc * sx[m]) * sw[n]
// in fp32.
//
// Replaces src/repro/kernels/qmac/qmac.py: qmac_i8_kernel (body
// _mm_kernel, int32 out) and qmac_i8_deq_kernel (body _mm_deq_kernel,
// fused epilogue) -- one source, the epilogue is a template switch.
//
// What bounds it on this card: on the serving path M is the micro-batch
// (1..32 rows) and N is 128 or 4, so the product does 2*M*N*K int8 ops
// over K*N weight bytes -- at most 64 ops per weight byte, far below the
// H100's ~590 int8 ops per HBM byte.  It is bound by bytes (mostly the
// weights), and at these sizes in practice by launch latency.
//
// What the design does about it: every operand byte is read from
// global memory once per block into shared memory, edges are masked in
// the loads (no padded copy of either operand in HBM, unlike the
// Pallas wrapper), and the product runs on __dp4a (four int8 MACs into
// an int32 per instruction) out of shared memory.  The weight tile is
// stored transposed, [n][k], so four consecutive k of one column are
// one 32-bit word.  Accumulation is exact int32 (|acc| <= K*127*128,
// K <= 131072), so the order of the K loop cannot change a bit.
//
// Rounding: the epilogue uses __int2float_rn and __fmul_rn, and the
// library is built with --fmad=false, so it rounds exactly like the
// reference's (acc.astype(f32) * sx) * sw.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;          // rows of X per block
constexpr int kBN = 32;          // columns of W per block
// bytes of K per shared-memory stage: at M <= 32 only ceil(N/32) blocks
// run, so the K loop's latency per stage is the kernel's time; a deep
// stage keeps 64 independent loads per thread in flight between syncs
constexpr int kBK = 256;
constexpr int kThreads = 256;    // 32 columns x 8 row groups
constexpr int kRows = kBM / (kThreads / kBN);   // rows per thread: 4
constexpr int kPitch = kBK + 4;  // row pitch in bytes: 65 words, odd,
                                 // so column reads hit distinct banks
constexpr int kWords = kPitch / 4;
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "each thread loads a whole number of tile bytes");

template <bool kDeq>
__global__ void __launch_bounds__(kThreads)
qmac_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
            const float* __restrict__ sx, const float* __restrict__ sw,
            int sw_stride, void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t s_x[kBM * kPitch];
  __shared__ __align__(16) int8_t s_w[kBN * kPitch];
  const int tx = threadIdx.x % kBN;      // output column in the tile
  const int ty = threadIdx.x / kBN;      // row group
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  int acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // X tile, row-major [m][k]; bytes past M or K are zero
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      s_x[r * kPitch + kk] =
          (m < M && k < K) ? qx[(long long)m * K + k] : int8_t(0);
    }
    // W tile, transposed to [n][k]; reads run along n (coalesced)
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int kk = i / kBN, c = i % kBN;
      const int n = n0 + c, k = k0 + kk;
      s_w[c * kPitch + kk] =
          (n < N && k < K) ? qw[(long long)k * N + n] : int8_t(0);
    }
    __syncthreads();
    const int* x32 = reinterpret_cast<const int*>(s_x);
    const int* w32 = reinterpret_cast<const int*>(s_w);
    const int words = (min(kBK, K - k0) + 3) / 4;
    for (int w = 0; w < words; ++w) {
      const int b = w32[tx * kWords + w];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = __dp4a(x32[(ty + i * (kThreads / kBN)) * kWords + w], b,
                        acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + ty + i * (kThreads / kBN);
    if (m >= M) continue;
    if (kDeq) {
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[m]),
                                sw[n * sw_stride]);
      static_cast<float*>(out)[(long long)m * N + n] = v;
    } else {
      static_cast<int*>(out)[(long long)m * N + n] = acc[i];
    }
  }
}

}  // namespace

// qx [M,K] int8, qw [K,N] int8, both row-major and contiguous.  With
// deq != 0: sx [M] fp32 and sw fp32 read at n * sw_stride (stride 0 for
// a per-tensor scale), out [M,N] fp32; else out [M,N] int32 and sx/sw
// are not read.  Launches on `stream`; returns cudaGetLastError().
extern "C" int qforce_qmac_i8(int device, void* stream, const void* qx,
                              const void* qw, const void* sx,
                              const void* sw, int sw_stride, void* out,
                              int M, int N, int K, int deq) {
  cudaSetDevice(device);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(qx);
  const int8_t* w = static_cast<const int8_t*>(qw);
  if (deq) {
    qmac_kernel<true><<<grid, kThreads, 0, s>>>(
        x, w, static_cast<const float*>(sx), static_cast<const float*>(sw),
        sw_stride, out, M, N, K);
  } else {
    qmac_kernel<false><<<grid, kThreads, 0, s>>>(
        x, w, nullptr, nullptr, 0, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
