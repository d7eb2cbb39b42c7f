// Fused Q-LSTM cell for Hopper (sm_90a): one LSTM step of the paper's
// Q-LSTM block -- two int8 gate products, dequant, bias, CORDIC gates
// i|f|g|o, c' = f*c + i*g, h' = tanh(c')*o -- in one launch.
//
// Replaces src/repro/kernels/qlstm/qlstm.py: qlstm_cell_kernel (body
// _qlstm_kernel, gates by _sigmoid_tile / _tanh_tile).  The CORDIC is
// the V-ACT device code (../../vact/csrc/cordic.cuh).
//
// What bounds it on this card: at the paper's H = 32 and Din = 32 a
// step reads an 8 KB weight stripe and 65 B + 128 B per batch row, and
// does 2*(Din+H)*4H int8 MACs plus ~5 CORDICs (~60 fp32 ops each at
// n = 6) per hidden unit: by both counts a few microseconds of work at
// B = 128, so the time is the launch and the longest chain of dependent
// steps in one thread.
//
// What the design does about it:
//  * the grid is (batch-row groups) x (hidden-unit groups) of
//    ops.cell_plan: a block takes `rows` batch rows by `units` hidden
//    units (at most 8 x 8), so B = 128, H = 32 runs 128 blocks, not 16;
//  * a block stages only its units' gate columns g*H + j (g = 0..3) of
//    qw [Din, 4H] and qu [H, 4H], transposed to [column][k] so four k of
//    one column are one __dp4a word, at an odd word pitch so the 32
//    lanes of a warp reading 32 columns hit 32 banks.  The stripe
//    arrives as 4x4 byte blocks turned with __byte_perm (prmt) into four
//    column words: four 32-bit loads where H is a multiple of 4, byte
//    loads otherwise.  All of a thread's loads of a round (a block of
//    each stripe, a word of each of x and h) are issued before its
//    stores, and the epilogue's scales, bias and c before the staging,
//    so the block waits about one round trip to memory, not five;
//  * four lanes share one (row, unit), one gate each: one column's
//    x and h dots (Din/4 + H/4 __dp4a), dequant and bias, and one CORDIC
//    (tanh's lane doubles its input and its sigmoid, as the reference's
//    tanh = 2 sigmoid(2x) - 1 does, so no lane diverges).  The gates
//    reach the unit's first lane by __shfl_sync, which moves them
//    exactly, and that lane computes c' and tanh(c').  The critical path
//    is the dots, one CORDIC, the shuffles and tanh(c'), where a thread
//    per unit ran all four gates' dots and five CORDICs in sequence;
//  * the iteration count is a template parameter for 6 and 13 (the
//    CORDIC unrolled with no exit test), with one generic instance.
// Rows past B and units past H are staged as zeros and never stored.
//
// Rounding: the epilogue is the reference's order,
//   ((acc_x*sx)*sw[col] + (acc_h*sh)*su[col]) + b[col],
//   c' = (f*c) + (i*g),  h' = tanh(c') * o,
// with _rn intrinsics and --fmad=false, so it is bitwise the plain
// version; the int32 dots are exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../vact/csrc/cordic.cuh"

namespace {

using qforce::CordicParams;

constexpr int kMaxRows = 8;       // ops.MAX_ROWS
constexpr int kMaxUnits = 8;      // ops.UNITS
constexpr int kMaxThreads = 4 * kMaxRows * kMaxUnits;
constexpr int kSmemLimit = 232448;

// bytes per shared-memory row holding k int8 values: a whole number of
// words, and an odd number of them (ops._pitch)
__host__ __device__ inline int pitch(int k) {
  const int words = (k + 3) / 4;
  return 4 * (words | 1);
}

// a block's shared memory, in bytes from its start (ops.smem_bytes):
// w [4*units][px], u [4*units][ph], x [rows][px], h [rows][ph]
struct Layout {
  int px, ph, u, x, h, total;
  __host__ __device__ Layout(int Din, int H, int rows, int units)
      : px(pitch(Din)), ph(pitch(H)), u(4 * units * px),
        x(u + 4 * units * ph), h(x + rows * px), total(h + rows * ph) {}
};

// Four rows k0..k0+3 of src [K][4H] at columns g*H + j .. g*H + j + 3,
// of which the first `ncols` exist (zeros past K and past ncols): rw[r]
// holds row k0 + r, column c in byte c.  `word`: one 32-bit load a row
// (H a multiple of 4, src 4-byte aligned, so ncols is 4 or 0); bytes
// otherwise.
__device__ __forceinline__ void load_quad(uint32_t (&rw)[4],
                                          const int8_t* __restrict__ src,
                                          int K, int H, int k0, int g, int j,
                                          int ncols, bool word) {
  const long long G = 4LL * H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + r;
    const int8_t* at = src + k * G + g * H + j;
    if (word) {
      rw[r] = (k < K && ncols > 0) ? *reinterpret_cast<const uint32_t*>(at)
                                   : 0u;
    } else {
      uint32_t v = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k < K && c < ncols)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(at[c])) << (8 * c);
      rw[r] = v;
    }
  }
}

// The quad's columns as __dp4a words (byte r of column c's word is row
// k0 + r), stored at word k0/4 of the first `ncols` block columns from
// col0 in dst [cols][wp words]
__device__ __forceinline__ void store_quad(int* dst, int wp, int col0,
                                           int kw, int ncols,
                                           const uint32_t (&rw)[4]) {
  const uint32_t lo01 = __byte_perm(rw[0], rw[1], 0x5140);
  const uint32_t hi01 = __byte_perm(rw[0], rw[1], 0x7362);
  const uint32_t lo23 = __byte_perm(rw[2], rw[3], 0x5140);
  const uint32_t hi23 = __byte_perm(rw[2], rw[3], 0x7362);
  const uint32_t t[4] = {__byte_perm(lo01, lo23, 0x5410),
                         __byte_perm(lo01, lo23, 0x7632),
                         __byte_perm(hi01, hi23, 0x5410),
                         __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < ncols) dst[(col0 + c) * wp + kw] = static_cast<int>(t[c]);
}

// word w (k = 4w..4w+3) of row b of src [B][K], zeros past B and K;
// `word`: one 32-bit load (K a multiple of 4, src 4-byte aligned)
__device__ __forceinline__ uint32_t load_row_word(
    const int8_t* __restrict__ src, int B, int K, int b, int w, bool word) {
  if (b >= B) return 0u;
  const int8_t* at = src + static_cast<long long>(b) * K + 4 * w;
  if (word) return *reinterpret_cast<const uint32_t*>(at);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (4 * w + c < K)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(at[c])) << (8 * c);
  return v;
}

template <int kN>
__global__ void __launch_bounds__(kMaxThreads)
qlstm_cell_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                  const int8_t* __restrict__ qh, const float* __restrict__ sh,
                  const int8_t* __restrict__ qw, const float* __restrict__ sw,
                  const int8_t* __restrict__ qu, const float* __restrict__ su,
                  const float* __restrict__ bias, const float* __restrict__ c,
                  float* __restrict__ h_out, float* __restrict__ c_out,
                  int B, int Din, int H, int rows, int units, CordicParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(Din, H, rows, units);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem);
  int8_t* s_u = s_w + lay.u;
  int8_t* s_x = s_w + lay.x;
  int8_t* s_h = s_w + lay.h;
  const int b0 = blockIdx.x * rows, j0 = blockIdx.y * units;

  // lane g of four takes gate g of one (row, unit); lanes past the
  // block's pairs compute on row 0, unit 0 and store nothing, so every
  // lane of the warp reaches the shuffles
  const int g = threadIdx.x & 3, pair = threadIdx.x >> 2;
  const bool live = pair < rows * units;
  const int r = live ? pair / units : 0, jj = live ? pair % units : 0;
  const int b = b0 + r, j = j0 + jj;
  const bool store = live && b < B && j < H;
  // the epilogue's operands, loaded now so they arrive during staging
  const int col = g * H + j;
  const bool in_h = j < H;
  const float fsx = sx[0], fsh = sh[0];
  const float fsw = in_h ? sw[col] : 0.f, fsu = in_h ? su[col] : 0.f;
  const float fb = in_h ? bias[col] : 0.f;
  const float c_in = (g == 0 && store) ? c[static_cast<long long>(b) * H + j]
                                       : 0.f;

  // One pass stages everything: per round a thread issues its loads of
  // a 4x4 block of each stripe and a word of each of x and h, then its
  // stores, so the block waits for about one round trip to memory.
  const int kgx = (Din + 3) / 4, kgh = (H + 3) / 4;
  const int WX = lay.px / 4, WH = lay.ph / 4;
  const int quads = (units + 3) / 4;        // column quads of a gate
  const bool stripe_word = H % 4 == 0 &&
                           reinterpret_cast<uintptr_t>(qw) % 4 == 0 &&
                           reinterpret_cast<uintptr_t>(qu) % 4 == 0;
  const bool x_word = Din % 4 == 0 && reinterpret_cast<uintptr_t>(qx) % 4 == 0;
  const bool h_word = H % 4 == 0 && reinterpret_cast<uintptr_t>(qh) % 4 == 0;
  const int nW = kgx * 4 * quads, nU = kgh * 4 * quads;
  const int nX = rows * kgx, nH = rows * kgh;
  const int most = max(max(nW, nU), max(nX, nH));
  for (int i = threadIdx.x; i < most; i += blockDim.x) {
    uint32_t w4[4], u4[4], xv = 0u, hv = 0u;
    // a stripe item: k group i / (4 quads), gate, column quad
    const int qi = i % (4 * quads), gi = qi / quads, jq = qi % quads;
    const int ncols = min(4, min(units - 4 * jq, H - (j0 + 4 * jq)));
    if (i < nW)
      load_quad(w4, qw, Din, H, 4 * (i / (4 * quads)), gi, j0 + 4 * jq,
                ncols, stripe_word);
    if (i < nU)
      load_quad(u4, qu, H, H, 4 * (i / (4 * quads)), gi, j0 + 4 * jq,
                ncols, stripe_word);
    if (i < nX) xv = load_row_word(qx, B, Din, b0 + i / kgx, i % kgx, x_word);
    if (i < nH) hv = load_row_word(qh, B, H, b0 + i / kgh, i % kgh, h_word);
    // columns past H inside the block get zero words
    const int ncols_blk = min(4, units - 4 * jq);
    if (i < nW)
      store_quad(reinterpret_cast<int*>(s_w), WX, gi * units + 4 * jq,
                 i / (4 * quads), ncols_blk, w4);
    if (i < nU)
      store_quad(reinterpret_cast<int*>(s_u), WH, gi * units + 4 * jq,
                 i / (4 * quads), ncols_blk, u4);
    if (i < nX)
      reinterpret_cast<int*>(s_x)[(i / kgx) * WX + i % kgx] = int(xv);
    if (i < nH)
      reinterpret_cast<int*>(s_h)[(i / kgh) * WH + i % kgh] = int(hv);
  }
  __syncthreads();

  const int* xw = reinterpret_cast<const int*>(s_x) + r * WX;
  const int* hw = reinterpret_cast<const int*>(s_h) + r * WH;
  const int* ww = reinterpret_cast<const int*>(s_w) + (g * units + jj) * WX;
  const int* uw = reinterpret_cast<const int*>(s_u) + (g * units + jj) * WH;
  int ax = 0, ah = 0;
#pragma unroll 8
  for (int w = 0; w < kgx; ++w) ax = __dp4a(xw[w], ww[w], ax);
#pragma unroll 8
  for (int w = 0; w < kgh; ++w) ah = __dp4a(hw[w], uw[w], ah);

  const float gx = __fmul_rn(__fmul_rn(__int2float_rn(ax), fsx), fsw);
  const float gh = __fmul_rn(__fmul_rn(__int2float_rn(ah), fsh), fsu);
  const float gate = __fadd_rn(__fadd_rn(gx, gh), fb);
  // i, f, o: sigmoid(gate); g: tanh(gate) = 2 sigmoid(2 gate) - 1
  const bool is_g = g == 2;
  const float s = qforce::cordic_sigmoid_n<kN>(
      is_g ? __fmul_rn(2.f, gate) : gate, p);
  const float act = is_g ? __fsub_rn(__fmul_rn(2.f, s), 1.f) : s;
  const int lane0 = (threadIdx.x & 31) & ~3;
  const float ig = __shfl_sync(0xffffffffu, act, lane0 + 0);
  const float fg = __shfl_sync(0xffffffffu, act, lane0 + 1);
  const float gg = __shfl_sync(0xffffffffu, act, lane0 + 2);
  const float og = __shfl_sync(0xffffffffu, act, lane0 + 3);
  if (g == 0 && store) {
    const long long at = static_cast<long long>(b) * H + j;
    const float cn = __fadd_rn(__fmul_rn(fg, c_in), __fmul_rn(ig, gg));
    c_out[at] = cn;
    h_out[at] = __fmul_rn(qforce::cordic_tanh_n<kN>(cn, p), og);
  }
}

}  // namespace

// qx [B,Din] i8, qh [B,H] i8, qw [Din,4H] i8, qu [H,4H] i8, sx/sh one
// fp32 each on the device, sw/su/bias [4H] fp32, c [B,H] fp32, all
// contiguous; writes h_out, c_out [B,H] fp32.  The launch follows
// ops.cell_plan: blocks of `rows` batch rows x `units` hidden units,
// `threads` a block (4 * rows * units rounded up to a warp), `smem`
// bytes of shared memory; the launcher refuses any other plan.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int qforce_qlstm_cell(int device, void* stream, const void* qx,
                                 const void* sx, const void* qh,
                                 const void* sh, const void* qw,
                                 const void* sw, const void* qu,
                                 const void* su, const void* bias,
                                 const void* c, void* h_out, void* c_out,
                                 int B, int Din, int H, int rows, int units,
                                 int threads, int smem, CordicParams p) {
  cudaSetDevice(device);
  if (B < 1 || Din < 0 || H < 1 || rows < 1 || rows > kMaxRows ||
      units < 1 || units > kMaxUnits || units > H ||
      threads != 32 * ((4 * rows * units + 31) / 32) ||
      smem != Layout(Din, H, rows, units).total || smem > kSmemLimit ||
      p.n < 1 || p.n > qforce::kMaxIters)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + rows - 1) / rows, (H + units - 1) / units);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qlstm_cell_kernel<0>;
  if (p.n == 6) kernel = qlstm_cell_kernel<6>;
  if (p.n == 13) kernel = qlstm_cell_kernel<13>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const int8_t*>(qh), static_cast<const float*>(sh),
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      static_cast<const int8_t*>(qu), static_cast<const float*>(su),
      static_cast<const float*>(bias), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, Din, H,
      rows, units, p);
  return static_cast<int>(cudaGetLastError());
}
