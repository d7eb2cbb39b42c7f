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
// What bounds it on this card: on the pixel stem C is 3, 12, 16 or 32
// and N is 16 or 32, so each input byte feeds at most T*N = 288 MACs
// while the fp32 output (4*N bytes per pixel) is the largest stream.
// It is bound by bytes: the input, its per-pixel scales, and above all
// the output.  Tensor cores are not needed: at C <= 16 a tap's dot is
// one to four __dp4a words, far too shallow for an mma tile's 32-byte
// depth, and the work per byte is far below the int8 ridge.
//
// What the design does about it (ops.band_plan sizes every block):
// - Each block owns a band of R output rows of one image, all Wo of
//   them, and a tile of N.  Those rows read (R-1)*stride + KH input
//   rows, one contiguous span of NHWC bytes; the block stages the span
//   once, with 16-byte loads (scalar head and tail where the span is
//   not aligned), and the span's per-pixel scales the same way.  The
//   N tile's weights arrive as 4x4 byte blocks (four channels by four
//   outputs, four 32-bit loads a thread), turned with __byte_perm into
//   [tap][n][channel words] at an odd word pitch, so the channel groups
//   a warp reads sit in distinct banks.  After that one barrier the tap
//   loop runs from shared memory; padding is an index test, not a copy
//   of zeros.  A tap outside the image adds nothing: it would add +0 to
//   the carry, which leaves its bits as they are (the carry starts at +0
//   and a round-to-nearest sum is -0 only when both terms are).
// - C is padded to a multiple of 4 in shared memory only (zero weight
//   bytes in the pad), so a tap's dot costs ceil(C/4) __dp4a words:
//   one at C = 3, three at C = 12.
// - For 3x3 kernels at the stems' channel counts the tap loop is a
//   template instance: all nine int32 dots are computed unrolled and
//   branch-free first (independent, so their loads overlap), then the
//   fp32 carry runs over them in kh-major order.  Other shapes take the
//   general loop, which computes the same sums in the same order.
// - R is chosen so the grid has about two blocks per SM or more (the
//   DQN stem at bucket 32 runs 256 blocks; the HRL stem at 512 frames
//   512), and each thread owns one pixel and four channels at a time.
// - Neighbouring threads own neighbouring channel groups, then
//   neighbouring pixels, so a warp writes whole contiguous [pixel, N]
//   rows of the fp32 output, with float4 stores where N allows.
// - Shared memory is dynamic; above 48 KB the launcher raises the
//   kernel's limit with cudaFuncSetAttribute.  The planner refuses a
//   shape whose single output row does not fit 227 KB.
//
// Rounding: __int2float_rn, __fmul_rn and __fadd_rn keep each multiply
// and add separate, and the library is built with --fmad=false, so the
// result is bitwise the reference's tap-ordered fp32 accumulation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kSmemLimit = 232448;    // 227 KB, a block's most on sm_90

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// words a weight column takes in shared memory: the channel words
// rounded up to an odd count, so the channel groups of one warp read
// distinct banks
__host__ __device__ constexpr int w_pitch(int cw) { return cw | 1; }

// the shared memory layout of a band: x bytes (C padded to C4, plus 16
// bytes of slack for the aligned copy's shift), the span's fp32 scales
// (plus 16), and the N tile's weights [T][NT4][w_pitch] words; each
// region a multiple of 16 bytes
struct Layout {
  int x_bytes, sx_bytes, w_bytes;
  __host__ __device__ Layout(int in_rows, int W, int C, int T, int NT) {
    const int c4 = round_up(C, 4);
    x_bytes = round_up(in_rows * W * c4 + 16, 16);
    sx_bytes = round_up(in_rows * W * 4 + 16, 16);
    w_bytes = round_up(T * round_up(NT, 4) * w_pitch(c4 / 4) * 4, 16);
  }
  __host__ __device__ int total() const {
    return x_bytes + sx_bytes + w_bytes;
  }
};

// copy n elements of T from global src to shared memory, 16 bytes at a
// time where src is aligned; element i goes to put(i, value).  With a
// `direct` destination whose address is src's mod 16, the aligned body
// is stored 16 bytes at a time to direct[i] instead.
template <typename T, typename Put>
__device__ __forceinline__ void stage(const T* __restrict__ src, int n,
                                      Put put, T* direct) {
  constexpr int kPer = 16 / sizeof(T);
  const int mis = int((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min(n, (kPer - mis) % kPer);
  const int vecs = (n - head) / kPer;
  for (int i = threadIdx.x; i < head; i += blockDim.x) put(i, src[i]);
  const int4* body = reinterpret_cast<const int4*>(src + head);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const int4 q = __ldg(body + v);
    if (direct != nullptr) {
      *reinterpret_cast<int4*>(direct + head + v * kPer) = q;
    } else {
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int j = 0; j < kPer; ++j) put(head + v * kPer + j, e[j]);
    }
  }
  for (int i = head + vecs * kPer + threadIdx.x; i < n; i += blockDim.x)
    put(i, src[i]);
}

// kKH, kKW, kCW > 0: a kernel size and a count of channel words fixed at
// compile time, with the tap loop unrolled; 0: any, read at run time
template <int kKH, int kKW, int kCW>
__global__ void __launch_bounds__(kMaxThreads)
qconv_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
             const int8_t* __restrict__ qw, const float* __restrict__ sw,
             int sw_stride, const float* __restrict__ bias,
             float* __restrict__ out, int H, int W, int C, int KH, int KW,
             int N, int stride, int pad_t, int pad_l, int Ho, int Wo,
             int relu, int R, int NT, int bands, int ntiles, int x_bytes,
             int sx_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = round_up(C, 4), CW = C4 / 4, NT4 = round_up(NT, 4);
  const int P = w_pitch(CW);
  if constexpr (kKH > 0) {
    // the launcher picks this instance only for its own shape
    KH = kKH;
    KW = kKW;
  }
  const int T = KH * KW;

  int blk = blockIdx.x;
  const int tile = blk % ntiles;
  blk /= ntiles;
  const int band = blk % bands;
  const int b = blk / bands;
  const int oh0 = band * R, oh1 = min(Ho, oh0 + R);
  const int n0 = tile * NT, nt = min(NT, N - n0);
  const int ih_lo = max(0, oh0 * stride - pad_t);
  const int ih_hi = min(H, (oh1 - 1) * stride - pad_t + KH);

  // the band's input rows, [row][w][C4]
  const int8_t* xsrc = qx + ((long long)b * H + ih_lo) * W * C;
  const int xn = (ih_hi - ih_lo) * W * C;
  int8_t* xs;
  if (C4 == C && (reinterpret_cast<uintptr_t>(xsrc) & 3) == 0) {
    // the span as it lies in HBM, shifted so its aligned body lands on
    // 16-byte boundaries of shared memory
    xs = reinterpret_cast<int8_t*>(smem) +
         (reinterpret_cast<uintptr_t>(xsrc) & 15);
    stage(xsrc, xn, [&](int i, int8_t v) { xs[i] = v; }, xs);
  } else {
    // repack to C4 bytes a pixel; the pad bytes meet zero weights
    xs = reinterpret_cast<int8_t*>(smem);
    stage(xsrc, xn, [&](int i, int8_t v) {
      const int p = i / C;
      xs[p * C4 + (i - p * C)] = v;
    }, static_cast<int8_t*>(nullptr));
  }
  // their per-pixel scales, [row][w]
  const float* ssrc = sx + ((long long)b * H + ih_lo) * W;
  float* ss = reinterpret_cast<float*>(smem + x_bytes) +
              ((reinterpret_cast<uintptr_t>(ssrc) & 15) / 4);
  stage(ssrc, (ih_hi - ih_lo) * W, [&](int i, float v) { ss[i] = v; }, ss);
  // the N tile's weights, HWIO [t][c][n] -> [t][n][P words]: a thread takes
  // a 4x4 block (channels 4w..4w+3 by outputs 4g..4g+3 of tap t) as four
  // independent 32-bit loads (byte loads where N is ragged), turns it
  // with __byte_perm, and stores four words; zero past C and past N
  int* w32s = reinterpret_cast<int*>(smem + x_bytes + sx_bytes);
  const int NG4 = NT4 / 4;
  const bool vec_w =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(qw) & 3) == 0;
#pragma unroll 4
  for (int u = threadIdx.x; u < T * CW * NG4; u += blockDim.x) {
    const int g = u % NG4, r = u / NG4;
    const int w = r % CW, t = r / CW;
    const int n = n0 + 4 * g;
    uint32_t row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * w + k;
      const long long off = ((long long)t * C + c) * N + n;
      uint32_t v = 0u;
      if (c < C && n < n0 + nt) {
        if (vec_w) {
          v = __ldg(reinterpret_cast<const uint32_t*>(qw + off));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < n0 + nt)
              v |= uint32_t(uint8_t(qw[off + j])) << (8 * j);
        }
      }
      row[k] = v;
    }
    const uint32_t lo01 = __byte_perm(row[0], row[1], 0x5140);
    const uint32_t hi01 = __byte_perm(row[0], row[1], 0x7362);
    const uint32_t lo23 = __byte_perm(row[2], row[3], 0x5140);
    const uint32_t hi23 = __byte_perm(row[2], row[3], 0x7362);
    int* dst = w32s + (t * NT4 + 4 * g) * P + w;
    dst[0 * P] = int(__byte_perm(lo01, lo23, 0x5410));
    dst[1 * P] = int(__byte_perm(lo01, lo23, 0x7632));
    dst[2 * P] = int(__byte_perm(hi01, hi23, 0x5410));
    dst[3 * P] = int(__byte_perm(hi01, hi23, 0x7632));
  }
  __syncthreads();

  const int* x32 = reinterpret_cast<const int*>(xs);
  const int* w32 = w32s;
  const int NG = (nt + 3) / 4;
  const int items = (oh1 - oh0) * Wo * NG;
  const bool vec_out = N % 4 == 0;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it % NG, p = it / NG;
    const int oh = oh0 + p / Wo, ow = p % Wo;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kKH > 0) {
      // every tap's int32 dots first, unrolled and branch-free (a tap
      // outside the image gets d = 0 and s = 0, which adds +0), then
      // the fp32 carry in kh-major order
      constexpr int kT = kKH * kKW;
      constexpr int kP = w_pitch(kCW);
      int d[kT][4];
      float s[kT];
      const int* wg = w32 + g * 4 * kP;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int ih = oh * stride - pad_t + t / kKW;
        const int iw = ow * stride - pad_l + t % kKW;
        const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
        const int pix = ok ? (ih - ih_lo) * W + iw : 0;
        const int* xw = x32 + pix * kCW;
        const int* ww = wg + t * NT4 * kP;
#pragma unroll
        for (int j = 0; j < 4; ++j) d[t][j] = 0;
#pragma unroll
        for (int w = 0; w < kCW; ++w) {
          const int xv = xw[w];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[t][j] = __dp4a(xv, ww[j * kP + w], d[t][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) d[t][j] = ok ? d[t][j] : 0;
        s[t] = ok ? ss[pix] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = __fadd_rn(acc[j],
                             __fmul_rn(__int2float_rn(d[t][j]), s[t]));
      }
    } else {
      for (int di = 0; di < KH; ++di) {
        const int ih = oh * stride - pad_t + di;
        if (ih < 0 || ih >= H) continue;
        for (int dj = 0; dj < KW; ++dj) {
          const int iw = ow * stride - pad_l + dj;
          if (iw < 0 || iw >= W) continue;
          const int pix = (ih - ih_lo) * W + iw;
          const int* xw = x32 + pix * CW;
          const int* ww = w32 + ((di * KW + dj) * NT4 + g * 4) * P;
          int d[4] = {0, 0, 0, 0};
          for (int w = 0; w < CW; ++w) {
            const int xv = xw[w];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              d[j] = __dp4a(xv, ww[j * P + w], d[j]);
          }
          const float s = ss[pix];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(__int2float_rn(d[j]), s));
        }
      }
    }
    const int n = n0 + g * 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n + j < N) {
        const float s_n = __ldg(sw + (n + j) * sw_stride);
        v[j] = __fadd_rn(__fmul_rn(acc[j], s_n), __ldg(bias + n + j));
        if (relu) v[j] = fmaxf(v[j], 0.f);
      }
    }
    float* o = out + ((long long)b * Ho + oh) * Wo * N +
               (long long)ow * N + n;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) o[j] = v[j];
    }
  }
}

}  // namespace

// qx [B,H,W,C] int8 NHWC, sx [B,H,W] fp32, qw [KH,KW,C,N] int8 HWIO, all
// contiguous; sw fp32 read at n * sw_stride (0: one per-tensor scale),
// bias [N] fp32, out [B,Ho,Wo,N] fp32 (16-byte aligned).  pad_t/pad_l
// are the top/left pads (SAME) or 0 (VALID); Ho/Wo the output size.
// The band plan: `rows` output rows a block, an N tile of `n_tile`
// channels (a multiple of 4), `threads` a block and `smem` bytes of
// shared memory, which must be what the layout takes.  Launches on
// `stream`; returns cudaGetLastError() or cudaErrorInvalidValue for a
// plan the kernel cannot run.
extern "C" int qforce_qconv_i8(int device, void* stream, const void* qx,
                               const void* sx, const void* qw,
                               const void* sw, int sw_stride,
                               const void* bias, void* out, int B, int H,
                               int W, int C, int KH, int KW, int N,
                               int stride, int pad_t, int pad_l, int Ho,
                               int Wo, int relu, int rows, int n_tile,
                               int threads, int smem) {
  cudaSetDevice(device);
  const int in_rows = min(H, (rows - 1) * stride + KH);
  const Layout lay(in_rows, W, C, KH * KW, n_tile);
  if (rows < 1 || n_tile < 4 || n_tile % 4 != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem != lay.total() ||
      smem > kSmemLimit ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (Ho + rows - 1) / rows;
  const int ntiles = (N + n_tile - 1) / n_tile;
  const long long blocks = (long long)B * bands * ntiles;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the stems' 3x3 layers at their channel counts (C = 3, 5-8, 12, 16,
  // 32) get an unrolled tap loop; anything else the general one
  const int cw = (C + 3) / 4;
  auto kernel = qconv_kernel<0, 0, 0>;
  if (KH == 3 && KW == 3) {
    switch (cw) {
      case 1: kernel = qconv_kernel<3, 3, 1>; break;
      case 2: kernel = qconv_kernel<3, 3, 2>; break;
      case 3: kernel = qconv_kernel<3, 3, 3>; break;
      case 4: kernel = qconv_kernel<3, 3, 4>; break;
      case 8: kernel = qconv_kernel<3, 3, 8>; break;
      default: break;
    }
  }
  if (smem > kStaticSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      sw_stride, static_cast<const float*>(bias), static_cast<float*>(out),
      H, W, C, KH, KW, N, stride, pad_t, pad_l, Ho, Wo, relu, rows, n_tile,
      bands, ntiles, lay.x_bytes, lay.sx_bytes);
  return static_cast<int>(cudaGetLastError());
}
