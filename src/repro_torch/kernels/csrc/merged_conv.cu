// Merged-segment convolution for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel in src/repro/kernels/merged_conv.py (`merged_conv`,
// body `_kernel`): a VALID NHWC convolution with stride s and HWIO weights,
// followed by the segment epilogue (bias, then relu / relu6 / silu).
//
// Design: an implicit GEMM.  Rows are the M = N*Ho*Wo output pixels, columns
// the Cout output channels, and the reduction runs over Ktot = kh*kw*Cin in
// the order (u, v, c) -- exactly the row-major order of the HWIO weight, so
// the weight is read as a dense (Ktot, Cout) matrix.  The input element of
// row m and reduction index r is x[base(m) + off(r)] with
//   base(m) = ((n*H + ho*s)*W + wo*s)*Cin,   off(r) = (u*W + v)*Cin + c,
// so the strided window is addressed directly in the NHWC input: no im2col
// buffer and no phase-major relayout (the TPU kernel needed that relayout for
// contiguous DMA windows; here each block gathers its own window).
//
// Each block owns a BM x BN output tile and walks the reduction in BK-deep
// slices: it stages the input slice (BK x BM) and the weight slice (BK x BN)
// in shared memory, and every thread accumulates a TM x TN register tile with
// fp32 FFMA.  Blocks share nothing, so the TPU kernel's carry of a prefetched
// halo window from one grid step to the next has no counterpart: every block
// loads its own window.  The ragged pixel, reduction and Cout edges are masked
// with zeros in the loads and skipped in the stores, so no padding of the
// channel axis is needed.
//
// Bound: at the main path's shapes (mostly 1x1 and small merged kernels at
// batch 8) the work sits near the fp32 ridge of the card (67 TFLOP/s FFMA over
// 3.35 TB/s, about 20 FLOP per byte): large-Cin/Cout units are bound by FFMA
// issue, thin ones by the bytes of the activation.  This first version keeps
// both simple: a 4x4 register tile gives 16 FFMA per 8 shared-memory floats
// read, and the loads coalesce along the NHWC channel axis and the HWIO Cout
// axis.  Tensor cores (TF32/bf16 wgmma) and a cp.async/TMA pipeline are later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                             // output pixels per block
constexpr int BN = 64;                             // output channels per block
constexpr int BK = 16;                             // reduction slice depth
constexpr int TM = 4;                              // pixels per thread
constexpr int TN = 4;                              // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);     // 256
constexpr int A_ROWS_PER_THREAD = BM * BK / THREADS;   // 4
constexpr int B_ROWS_PER_THREAD = BN * BK / THREADS;   // 4
constexpr int A_ROW_STEP = THREADS / BK;               // 16
constexpr int B_ROW_STEP = THREADS / BN;               // 4

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                       // relu
    case 2: return fminf(fmaxf(v, 0.f), 6.f);           // relu6
    case 3: return v / (1.f + expf(-v));                // silu
    default: return v;
  }
}

__global__ void __launch_bounds__(THREADS)
merged_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int H, int W, int Cin, int KW, int Cout, int stride,
                   int Ho, int Wo, int M, int Ktot, int act) {
  // +4 keeps rows 16-byte aligned and spreads the transposed stores.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Input loader: column ak of the slice, pixel rows am0 + A_ROW_STEP*i.
  const int ak = tid % BK;
  const int am0 = tid / BK;
  int a_base[A_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int m = m0 + am0 + A_ROW_STEP * i;
    if (m < M) {
      const int hw = Ho * Wo;
      const int img = m / hw;
      const int rem = m - img * hw;
      const int ho = rem / Wo;
      const int wo = rem - ho * Wo;
      a_base[i] = ((img * H + ho * stride) * W + wo * stride) * Cin;
    } else {
      a_base[i] = -1;
    }
  }

  // Weight loader: output channel n0 + bn, slice rows bk0 + B_ROW_STEP*i.
  const int bn = tid % BN;
  const int bk0 = tid / BN;
  const bool b_ok = n0 + bn < Cout;

  // Compute mapping: pixels ty*TM.., channels tx*TN..
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kwc = KW * Cin;
  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    const int r = k0 + ak;
    int a_off = -1;
    if (r < Ktot) {
      const int u = r / kwc;
      const int rem = r - u * kwc;
      const int v = rem / Cin;
      const int c = rem - v * Cin;
      a_off = (u * W + v) * Cin + c;
    }
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const bool ok = a_off >= 0 && a_base[i] >= 0;
      As[ak][am0 + A_ROW_STEP * i] = ok ? __ldg(x + a_base[i] + a_off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_ROWS_PER_THREAD; ++i) {
      const int kr = k0 + bk0 + B_ROW_STEP * i;
      Bs[bk0 + B_ROW_STEP * i][bn] =
          (b_ok && kr < Ktot) ? __ldg(w + (size_t)kr * Cout + n0 + bn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, activation, masked NHWC store (row m is pixel m).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Cout) {
        const float v = acc[i][j] + (bias != nullptr ? bias[co] : 0.f);
        y[(size_t)m * Cout + co] = activate(v, act);
      }
    }
  }
}

}  // namespace

// x (N,H,W,Cin), w (kh,kw,Cin,Cout), bias (Cout) or NULL, y (N,Ho,Wo,Cout);
// all fp32, contiguous, on the device of `stream`.  act: 0 none, 1 relu,
// 2 relu6, 3 silu.  Returns the launch's cudaError_t (0 on success).
extern "C" int merged_conv_f32(const float* x, const float* w,
                               const float* bias, float* y, int n, int h,
                               int wd, int cin, int kh, int kw, int cout,
                               int stride, int ho, int wo, int act,
                               void* stream) {
  const int M = n * ho * wo;
  const int ktot = kh * kw * cin;
  const dim3 grid((M + BM - 1) / BM, (cout + BN - 1) / BN);
  merged_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, h, wd, cin, kw, cout, stride, ho, wo, M, ktot, act);
  return static_cast<int>(cudaGetLastError());
}
