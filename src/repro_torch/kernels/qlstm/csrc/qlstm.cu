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
// B = 128, so the time is one launch and one wave of 16 blocks.
//
// What the design does about it: the whole int8 stripe [Din + H, 4H]
// sits in shared memory, transposed so four consecutive k of one gate
// column are one 32-bit word for __dp4a (exact int32), with an odd word
// pitch so neighbouring columns hit distinct banks.  One thread owns
// hidden unit j of batch row b and reads its four gate columns (j, H+j,
// 2H+j, 3H+j), so the gates, c and h stay in registers: the only global
// traffic is the operands once and (h', c') once.  A block takes 8
// batch rows; rows past B are masked (the Pallas wrapper pads the batch
// to a multiple of 8 in HBM instead).
//
// Rounding: the epilogue is the reference's order,
//   ((acc_x*sx)*sw[col] + (acc_h*sh)*su[col]) + b[col],
//   c' = (f*c) + (i*g),  h' = tanh(c') * o,
// with _rn intrinsics and --fmad=false, so it is bitwise the plain
// version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../vact/csrc/cordic.cuh"

namespace {

using qforce::CordicParams;

constexpr int kThreads = 256;
constexpr int kRows = 8;          // batch rows per block

// bytes per shared-memory row holding k int8 values: a whole number of
// words, and an odd number of them
__host__ __device__ inline int pitch(int k) {
  const int words = (k + 3) / 4;
  return 4 * (words | 1);
}

__global__ void __launch_bounds__(kThreads)
qlstm_cell_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                  const int8_t* __restrict__ qh, const float* __restrict__ sh,
                  const int8_t* __restrict__ qw, const float* __restrict__ sw,
                  const int8_t* __restrict__ qu, const float* __restrict__ su,
                  const float* __restrict__ bias, const float* __restrict__ c,
                  float* __restrict__ h_out, float* __restrict__ c_out,
                  int B, int Din, int H, CordicParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int PX = pitch(Din), PH = pitch(H);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem);   // [G][PX]
  int8_t* s_u = s_w + G * PX;                       // [G][PH]
  int8_t* s_x = s_u + G * PH;                       // [kRows][PX]
  int8_t* s_h = s_x + kRows * PX;                   // [kRows][PH]
  const int b0 = blockIdx.x * kRows;

  // the stripe, transposed to [col][k]; global reads run along col
  for (int i = threadIdx.x; i < G * PX; i += kThreads) {
    const int k = i / G, col = i % G;
    s_w[col * PX + k] = k < Din ? qw[static_cast<long long>(k) * G + col]
                                : int8_t(0);
  }
  for (int i = threadIdx.x; i < G * PH; i += kThreads) {
    const int k = i / G, col = i % G;
    s_u[col * PH + k] = k < H ? qu[static_cast<long long>(k) * G + col]
                              : int8_t(0);
  }
  for (int i = threadIdx.x; i < kRows * PX; i += kThreads) {
    const int r = i / PX, k = i % PX, b = b0 + r;
    s_x[i] = (b < B && k < Din) ? qx[static_cast<long long>(b) * Din + k]
                                : int8_t(0);
  }
  for (int i = threadIdx.x; i < kRows * PH; i += kThreads) {
    const int r = i / PH, k = i % PH, b = b0 + r;
    s_h[i] = (b < B && k < H) ? qh[static_cast<long long>(b) * H + k]
                              : int8_t(0);
  }
  __syncthreads();

  const float fsx = sx[0], fsh = sh[0];
  const int* w32 = reinterpret_cast<const int*>(s_w);
  const int* u32 = reinterpret_cast<const int*>(s_u);
  const int* x32 = reinterpret_cast<const int*>(s_x);
  const int* h32 = reinterpret_cast<const int*>(s_h);
  const int WX = PX / 4, WH = PH / 4;
  const int nwx = (Din + 3) / 4, nwh = (H + 3) / 4;
  for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
    const int r = idx / H, j = idx % H, b = b0 + r;
    if (b >= B) continue;
    int ax[4] = {0, 0, 0, 0}, ah[4] = {0, 0, 0, 0};
    for (int w = 0; w < nwx; ++w) {
      const int xv = x32[r * WX + w];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        ax[g] = __dp4a(xv, w32[(g * H + j) * WX + w], ax[g]);
    }
    for (int w = 0; w < nwh; ++w) {
      const int hv = h32[r * WH + w];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        ah[g] = __dp4a(hv, u32[(g * H + j) * WH + w], ah[g]);
    }
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * H + j;
      const float gx = __fmul_rn(__fmul_rn(__int2float_rn(ax[g]), fsx),
                                 sw[col]);
      const float gh = __fmul_rn(__fmul_rn(__int2float_rn(ah[g]), fsh),
                                 su[col]);
      gate[g] = __fadd_rn(__fadd_rn(gx, gh), bias[col]);
    }
    const float ig = qforce::cordic_sigmoid(gate[0], p);
    const float fg = qforce::cordic_sigmoid(gate[1], p);
    const float gg = qforce::cordic_tanh(gate[2], p);
    const float og = qforce::cordic_sigmoid(gate[3], p);
    const long long at = static_cast<long long>(b) * H + j;
    const float cn = __fadd_rn(__fmul_rn(fg, c[at]), __fmul_rn(ig, gg));
    c_out[at] = cn;
    h_out[at] = __fmul_rn(qforce::cordic_tanh(cn, p), og);
  }
}

// shared memory one block takes for (Din, H); ops.smem_bytes mirrors it
// and refuses what exceeds the card's per-block limit before a launch
int smem_bytes(int Din, int H) {
  return (4 * H + kRows) * (pitch(Din) + pitch(H));
}

}  // namespace

// qx [B,Din] i8, qh [B,H] i8, qw [Din,4H] i8, qu [H,4H] i8, sx/sh one
// fp32 each on the device, sw/su/bias [4H] fp32, c [B,H] fp32, all
// contiguous; writes h_out, c_out [B,H] fp32.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int qforce_qlstm_cell(int device, void* stream, const void* qx,
                                 const void* sx, const void* qh,
                                 const void* sh, const void* qw,
                                 const void* sw, const void* qu,
                                 const void* su, const void* bias,
                                 const void* c, void* h_out, void* c_out,
                                 int B, int Din, int H, CordicParams p) {
  cudaSetDevice(device);
  const int smem = smem_bytes(Din, H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qlstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + kRows - 1) / kRows;
  qlstm_cell_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const int8_t*>(qh), static_cast<const float*>(sh),
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      static_cast<const int8_t*>(qu), static_cast<const float*>(su),
      static_cast<const float*>(bias), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, Din, H, p);
  return static_cast<int>(cudaGetLastError());
}
