// Q-Conv for Hopper (sm_90a): integer NHWC/HWIO convolution with a
// fused dequant + bias (+ ReLU) epilogue, as an implicit GEMM straight
// from the int8 input.
//
// Replaces src/repro/kernels/qconv/qconv.py: qconv_i8_taps_kernel (body
// _conv_taps_kernel).  Same integer program, same rounding: for every
// output pixel m and channel n, walk the T = KH*KW taps in kh-major
// order; each tap is an exact int32 dot over C of the tap's source
// pixel with the tap's weight column, dequantized by that pixel's scale
// and carried in fp32:
//     acc = acc + (float)d * sx[pixel]     (zero d and zero sx in padding)
//     out = acc * sw[n] + b[n], then max(out, 0) when fused_relu.
//
// What bounds it on this card: on the pixel stem C is 12 or 16 and N is
// 16 or 32, so each input byte feeds at most T*N = 288 MACs while the
// fp32 output (4*N bytes per pixel) is the largest stream.  It is bound
// by bytes (input, its per-pixel scales, and the fp32 output), and at
// the stem's sizes in practice by launch latency.
//
// What the design does about it: no [T, M, C] tap stack is built in HBM
// (the Pallas wrapper materializes one, a 9x copy of the input); each
// block computes the source pixel of every tap from its output pixel,
// the stride and the SAME pads, stages that pixel's channels in shared
// memory (zero outside the image), and runs the channel dot on __dp4a.
// The fp32 carry across taps and the output tile stay in registers, so
// the output is written once.
//
// Rounding: __int2float_rn, __fmul_rn and __fadd_rn keep each multiply
// and add separate, and the library is built with --fmad=false, so the
// result is bitwise the reference's tap-ordered fp32 accumulation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;          // output pixels per thread
constexpr int kCK = 32;           // channel bytes per shared-memory stage
constexpr int kPitch = kCK + 4;   // 9 words: odd, conflict-free columns
constexpr int kWords = kPitch / 4;

// kBN output channels per block; kThreads / kBN row groups of kRows
// pixels each, so a block covers kBM output pixels
template <int kBN>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
             const int8_t* __restrict__ qw, const float* __restrict__ sw,
             int sw_stride, const float* __restrict__ bias,
             float* __restrict__ out, int B, int H, int W, int C, int KH,
             int KW, int N, int stride, int pad_t, int pad_l, int Ho,
             int Wo, int relu) {
  constexpr int kTY = kThreads / kBN;
  constexpr int kBM = kTY * kRows;
  __shared__ __align__(16) int8_t s_x[kBM * kPitch];
  __shared__ __align__(16) int8_t s_w[kBN * kPitch];
  __shared__ int s_b[kBM], s_oh[kBM], s_ow[kBM];
  __shared__ long long s_pix[kBM];   // source pixel of this tap, or -1
  __shared__ float s_sx[kBM];

  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int hw = Ho * Wo;
      const int rem = m % hw;
      s_b[r] = m / hw;
      s_oh[r] = rem / Wo;
      s_ow[r] = rem % Wo;
    } else {
      s_b[r] = -1;
    }
  }

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int di = 0; di < KH; ++di) {
    for (int dj = 0; dj < KW; ++dj) {
      const int t = di * KW + dj;
      __syncthreads();   // previous tap's readers of s_pix / s_sx are done
      for (int r = threadIdx.x; r < kBM; r += kThreads) {
        const int b = s_b[r];
        const int ih = s_oh[r] * stride - pad_t + di;
        const int iw = s_ow[r] * stride - pad_l + dj;
        const bool ok = b >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W;
        const long long pix = ((long long)b * H + ih) * W + iw;
        s_pix[r] = ok ? pix : -1;
        s_sx[r] = ok ? sx[pix] : 0.f;
      }
      int d[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) d[i] = 0;
      for (int c0 = 0; c0 < C; c0 += kCK) {
        __syncthreads();
        for (int i = threadIdx.x; i < kBM * kCK; i += kThreads) {
          const int r = i / kCK, cc = i % kCK;
          const int c = c0 + cc;
          const long long pix = s_pix[r];
          s_x[r * kPitch + cc] =
              (pix >= 0 && c < C) ? qx[pix * C + c] : int8_t(0);
        }
        // weights of tap t, [c][n] in HBM -> [n][c] in shared memory
        for (int i = threadIdx.x; i < kCK * kBN; i += kThreads) {
          const int cc = i / kBN, col = i % kBN;
          const int c = c0 + cc, n = n0 + col;
          s_w[col * kPitch + cc] =
              (c < C && n < N) ? qw[((long long)t * C + c) * N + n]
                               : int8_t(0);
        }
        __syncthreads();
        const int* x32 = reinterpret_cast<const int*>(s_x);
        const int* w32 = reinterpret_cast<const int*>(s_w);
        const int words = (min(kCK, C - c0) + 3) / 4;
        for (int w = 0; w < words; ++w) {
          const int bw = w32[tx * kWords + w];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            d[i] = __dp4a(x32[(ty + i * kTY) * kWords + w], bw, d[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = __fadd_rn(
            acc[i], __fmul_rn(__int2float_rn(d[i]), s_sx[ty + i * kTY]));
    }
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float s_n = sw[n * sw_stride];
  const float b_n = bias[n];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + ty + i * kTY;
    if (m >= M) continue;
    float v = __fadd_rn(__fmul_rn(acc[i], s_n), b_n);
    if (relu) v = fmaxf(v, 0.f);
    out[(long long)m * N + n] = v;
  }
}

template <int kBN>
void launch(cudaStream_t s, const int8_t* qx, const float* sx,
            const int8_t* qw, const float* sw, int sw_stride,
            const float* bias, float* out, int B, int H, int W, int C,
            int KH, int KW, int N, int stride, int pad_t, int pad_l, int Ho,
            int Wo, int relu) {
  constexpr int kBM = (kThreads / kBN) * kRows;
  const int M = B * Ho * Wo;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  qconv_kernel<kBN><<<grid, kThreads, 0, s>>>(
      qx, sx, qw, sw, sw_stride, bias, out, B, H, W, C, KH, KW, N, stride,
      pad_t, pad_l, Ho, Wo, relu);
}

}  // namespace

// qx [B,H,W,C] int8 NHWC, sx [B,H,W] fp32, qw [KH,KW,C,N] int8 HWIO, all
// contiguous; sw fp32 read at n * sw_stride (0: one per-tensor scale),
// bias [N] fp32, out [B,Ho,Wo,N] fp32.  pad_t/pad_l are the top/left
// pads (SAME) or 0 (VALID); Ho/Wo the output size.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int qforce_qconv_i8(int device, void* stream, const void* qx,
                               const void* sx, const void* qw,
                               const void* sw, int sw_stride,
                               const void* bias, void* out, int B, int H,
                               int W, int C, int KH, int KW, int N,
                               int stride, int pad_t, int pad_l, int Ho,
                               int Wo, int relu) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(qx);
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (N <= 16) {
    launch<16>(s, x, sxf, w, swf, sw_stride, bf, o, B, H, W, C, KH, KW, N,
               stride, pad_t, pad_l, Ho, Wo, relu);
  } else {
    launch<32>(s, x, sxf, w, swf, sw_stride, bf, o, B, H, W, C, KH, KW, N,
               stride, pad_t, pad_l, Ho, Wo, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
