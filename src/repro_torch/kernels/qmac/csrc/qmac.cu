// Q-MAC for Hopper (sm_90a): int8 [M,K] x int8 [K,N] -> int32 [M,N],
// with an optional fused dequant epilogue out = (acc * sx[m]) * sw[n]
// in fp32.
//
// Replaces src/repro/kernels/qmac/qmac.py: qmac_i8_kernel (body
// _mm_kernel, int32 out) and qmac_i8_deq_kernel (body _mm_deq_kernel,
// fused epilogue) -- one source and one main loop; the epilogue is a
// template switch.
//
// What bounds it on this card: on the serving path M is the micro-batch
// (1..32 rows), K is 2048 (the fc) or 128 (the Q head) and N is 128 or
// 4, so the product does 2*M*N*K int8 ops over K*N weight bytes -- at
// most 64 ops per weight byte, far below the H100's ~590 int8 ops per
// HBM byte.  It is bound by bytes, and at these sizes in practice by
// latency: one output tile per block leaves the card empty (4 blocks at
// the fc) while each block walks K alone.
//
// What the design does about it:
// - Split K.  The grid is ceil(N/kBN) x ceil(M/kBM) x S; block z owns
//   bytes [z*slice, (z+1)*slice) of K (ops.split_plan picks S and the
//   slice, a multiple of 16 bytes, so the fc runs 8 x 16 = 128 blocks).
//   Each block reduces its slice to an int32 partial tile.
// - Reduce in the same launch.  A block writes its partial tile to a
//   workspace, fences, and bumps a per-tile counter; the block that
//   arrives last sums the S partials, runs the epilogue, and resets the
//   counter to 0 for the next call.  Integer addition is exact and
//   associative, so neither the split nor the arrival order can change
//   a bit.  The wrapper keeps one workspace per (device, stream).
// - Wide loads.  Each thread brings 16 bytes of X in one load and a 4x4
//   byte block of W as four 32-bit loads (scalar byte loads only where K
//   or N is not aligned); the next 128-byte chunk of the slice is loaded
//   into registers while the current one is consumed, with one barrier
//   per chunk over a double-buffered shared tile.  The W block is
//   transposed on chip with __byte_perm (prmt) so four consecutive k of
//   one column form a __dp4a word.  __dp4a, not mma.sync: a 32 x 16
//   tile over a 128-byte chunk is 16 K words per output, and the time
//   is the load and reduction latency, which tensor cores do not touch;
//   wgmma's 64-row tile would be half empty at M <= 32.
//
// The expert axis.  MoE serving runs the same product once for each of
// E experts, x [E,C,K] x w [E,K,N] (the reference's _fwd_bmm, XLA code
// there, not a Pallas kernel: no library call computes an int8 product
// batched over experts, and a launch per expert would be 384 a layer).
// The batch is folded into grid.y: block row y is expert y / ceil(M/kBM)
// and row tile y % ceil(M/kBM), each expert's operands, scales and
// output at their own offsets.  The split plan, its workspace and its
// counters count E x tiles; a batch of 1 is the plain product.  At
// qwen3-moe's shapes (E = 128, K x N = 2048 x 768) the batch alone
// gives 6,144 tiles, so no product splits K; a decode step's C = 4 rows
// an expert do 8 ops per weight byte, so it is bound by bytes, and the
// 32-row tile leaves 28 of its rows empty (a later redesign's work).
//
// Accumulation is exact int32 (|acc| <= K*127*128, K <= 131072).
// Rounding: the epilogue uses __int2float_rn and __fmul_rn, and the
// library is built with --fmad=false, so it rounds exactly like the
// reference's (acc.astype(f32) * sx) * sw.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;          // rows of X per block
constexpr int kBN = 16;          // columns of W per block
constexpr int kKC = 128;         // bytes of K per shared-memory chunk
constexpr int kThreads = 256;    // 16 columns x 16 row pairs
constexpr int kTile = kBM * kBN; // int32 partials per tile
constexpr int kXW = kKC / 4 + 4; // X row pitch, words: 16-byte rows for
                                 // the vector stores, and the two rows a
                                 // warp reads sit 4 banks apart
constexpr int kWW = kKC / 4 + 1; // W column pitch, words: odd, so the 16
                                 // columns a warp reads hit 16 banks
static_assert(kThreads * 16 == kBM * kKC, "one 16-byte X load a thread");
static_assert((kKC / 4) * (kBN / 4) <= kThreads, "one W block a thread");

// the 16 bytes of X at off, of which the first `valid` are inside the
// matrix and the slice (zeros past them): one 16-byte load where
// aligned, else byte loads
__device__ __forceinline__ int4 load_x(const int8_t* __restrict__ qx,
                                       long long off, int valid,
                                       bool vec) {
  if (vec) {
    if (valid >= 16) return __ldg(reinterpret_cast<const int4*>(qx + off));
    return make_int4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < valid)
      w[j / 4] |= uint32_t(uint8_t(qx[off + j])) << (8 * (j % 4));
  return make_int4(int(w[0]), int(w[1]), int(w[2]), int(w[3]));
}

template <bool kDeq>
__global__ void __launch_bounds__(kThreads)
qmac_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
            const float* __restrict__ sx, const float* __restrict__ sw,
            int sw_stride, void* __restrict__ out, int M, int N, int K,
            int slice, int vec_x, int vec_w, int* __restrict__ ws,
            int* __restrict__ counters) {
  __shared__ __align__(16) int s_x[2][kBM * kXW];
  __shared__ int s_w[2][kBN * kWW];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tx = tid % kBN;          // output column in the tile
  const int ty = tid / kBN;          // output rows ty and ty + 16
  const int n0 = blockIdx.x * kBN;
  // grid.y folds the expert (batch) axis over the row tiles
  const int row_tiles = (M + kBM - 1) / kBM;
  const int e = blockIdx.y / row_tiles;
  const int m0 = (blockIdx.y - e * row_tiles) * kBM;
  qx += (long long)e * M * K;
  qw += (long long)e * K * N;
  const long long e_out = (long long)e * M * N;
  if (kDeq) {
    sx += (long long)e * M;
    sw += (long long)e * N * sw_stride;
  }
  const int S = gridDim.z;
  const int kbeg = blockIdx.z * slice;
  const int kend = min(K, kbeg + slice);

  // loader roles: X row xr, bytes [xc, xc + 16) of the chunk; W block of
  // rows [wk, wk + 4) and columns [wn, wn + 4) of the chunk's tile
  const int xr = tid / (kKC / 16), xc = (tid % (kKC / 16)) * 16;
  const bool w_loader = tid < (kKC / 4) * (kBN / 4);
  const int wk = (tid / (kBN / 4)) * 4, wn = (tid % (kBN / 4)) * 4;
  const int xm = m0 + xr, wcol = n0 + wn;

  int4 rx;
  uint32_t rw[4];
  auto load = [&](int k0) {
    const int kx = k0 + xc;
    rx = load_x(qx, (long long)xm * K + kx,
                xm < M ? min(16, kend - kx) : 0, vec_x);
    if (!w_loader) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + wk + i;
      uint32_t v = 0u;
      if (k < kend) {
        const long long off = (long long)k * N + wcol;
        if (vec_w) {
          if (wcol < N)
            v = __ldg(reinterpret_cast<const uint32_t*>(qw + off));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (wcol + j < N)
              v |= uint32_t(uint8_t(qw[off + j])) << (8 * j);
        }
      }
      rw[i] = v;
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&s_x[buf][xr * kXW + xc / 4]) = rx;
    if (!w_loader) return;
    // rw[i] holds row k+i at columns n..n+3; column j of the block is
    // byte j of every row, packed low row first
    const uint32_t lo01 = __byte_perm(rw[0], rw[1], 0x5140);
    const uint32_t hi01 = __byte_perm(rw[0], rw[1], 0x7362);
    const uint32_t lo23 = __byte_perm(rw[2], rw[3], 0x5140);
    const uint32_t hi23 = __byte_perm(rw[2], rw[3], 0x7362);
    int* w = &s_w[buf][wn * kWW + wk / 4];
    w[0 * kWW] = int(__byte_perm(lo01, lo23, 0x5410));
    w[1 * kWW] = int(__byte_perm(lo01, lo23, 0x7632));
    w[2 * kWW] = int(__byte_perm(hi01, hi23, 0x5410));
    w[3 * kWW] = int(__byte_perm(hi01, hi23, 0x7632));
  };

  int acc0 = 0, acc1 = 0;
  if (kbeg < kend) load(kbeg);
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kKC) {
    // buffer buf was last read two chunks ago, before the barrier of
    // the previous chunk, so one barrier per chunk suffices
    store(buf);
    __syncthreads();
    if (k0 + kKC < kend) load(k0 + kKC);
    const int words = (min(kKC, kend - k0) + 3) / 4;
    const int* x0 = &s_x[buf][ty * kXW];
    const int* x1 = &s_x[buf][(ty + kBM / 2) * kXW];
    const int* w = &s_w[buf][tx * kWW];
    for (int i = 0; i < words; ++i) {
      const int b = w[i];
      acc0 = __dp4a(x0[i], b, acc0);
      acc1 = __dp4a(x1[i], b, acc1);
    }
    buf ^= 1;
  }

  if (S > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* part = ws + (long long)tile * S * kTile;
    part[blockIdx.z * kTile + tid] = acc0;
    part[blockIdx.z * kTile + tid + kThreads] = acc1;
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&counters[tile], 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    acc0 = 0;
    acc1 = 0;
#pragma unroll 4
    for (int z = 0; z < S; ++z) {
      acc0 += __ldcg(part + z * kTile + tid);
      acc1 += __ldcg(part + z * kTile + tid + kThreads);
    }
    if (tid == 0) counters[tile] = 0;
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const int acc[2] = {acc0, acc1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + i * (kBM / 2);
    if (m >= M) continue;
    if (kDeq) {
      static_cast<float*>(out)[e_out + (long long)m * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[m]),
                    sw[n * sw_stride]);
    } else {
      static_cast<int*>(out)[e_out + (long long)m * N + n] = acc[i];
    }
  }
}

}  // namespace

// qx [batch,M,K] int8, qw [batch,K,N] int8, both row-major and
// contiguous (batch 1: the plain [M,K] x [K,N] product).  With deq != 0:
// sx [batch,M] fp32 and sw fp32, expert e's read at (e*N + n) *
// sw_stride (stride 0 for one per-tensor scale), out [batch,M,N] fp32;
// else out [batch,M,N] int32 and sx/sw are not read.  K is cut into
// `splits` slices of `slice` bytes (the last one shorter); with
// splits > 1, ws holds ws_ints int32 and counters n_counters int32, all
// 0, at least tiles * splits * kBM * kBN and tiles, where tiles =
// batch * ceil(M/kBM) * ceil(N/kBN); the kernel leaves the counters at
// 0.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a cut, a batch or a workspace that does not
// fit.
extern "C" int qforce_qmac_i8(int device, void* stream, const void* qx,
                              const void* qw, const void* sx,
                              const void* sw, int sw_stride, void* out,
                              int M, int N, int K, int batch, int deq,
                              int splits, int slice, void* ws,
                              long long ws_ints, void* counters,
                              int n_counters) {
  cudaSetDevice(device);
  const long long rows = (long long)batch * ((M + kBM - 1) / kBM);
  if (batch < 1 || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)rows, splits);
  const long long tiles = (long long)grid.x * grid.y;
  const bool cut_ok =
      splits == 1
          ? slice >= K
          : slice % 16 == 0 && (long long)(splits - 1) * slice < K &&
                (long long)splits * slice >= K && ws != nullptr &&
                ws_ints >= tiles * splits * kTile && counters != nullptr &&
                n_counters >= tiles;
  if (splits < 1 || !cut_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(qx);
  const int8_t* w = static_cast<const int8_t*>(qw);
  // 16-byte X loads need aligned rows and slice starts; 4-byte W loads
  // aligned rows and whole column groups
  const int vec_x =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  int* wsp = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (deq) {
    qmac_kernel<true><<<grid, kThreads, 0, s>>>(
        x, w, static_cast<const float*>(sx), static_cast<const float*>(sw),
        sw_stride, out, M, N, K, slice, vec_x, vec_w, wsp, cnt);
  } else {
    qmac_kernel<false><<<grid, kThreads, 0, s>>>(
        x, w, nullptr, nullptr, 0, out, M, N, K, slice, vec_x, vec_w, wsp,
        cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
