// Depthwise / grouped merged-segment convolution for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel in src/repro/kernels/depthwise_conv.py
// (`depthwise_conv`, body `_kernel`): a VALID NHWC convolution with stride s
// and feature_group_count = G, weights HWIO (kh, kw, cin_g, G*cout_g) with
// group-major output channels, followed by the segment epilogue (bias, then
// relu / relu6 / silu).  It covers the three cases of the TPU kernel with one
// loop: depthwise (cin_g = cout_g = 1), channel multiplier (cin_g = 1,
// cout_g > 1) and general grouped (cin_g > 1).
//
// Design: one thread per output element (n, ho, wo, co), co fastest, so that
// a warp's input loads, weight loads and output stores all run along the
// contiguous channel axis of NHWC / HWIO.  Each thread accumulates its
// kh*kw*cin_g taps in one fp32 register (the TPU kernel's per-group fp32
// accumulator) and reads w[u, v, ci, co] in the HWIO layout directly, so the
// TPU kernel's group-blocked weight relayout and its channel padding are not
// needed.  Threads share nothing; the TPU kernel's prefetch of the next grid
// step's halo window has no counterpart.
//
// Bound: a depthwise conv does 2*kh*kw FLOPs per output element against one
// input and one output element of traffic, far below the card's fp32 ridge
// (about 20 FLOP per byte), so it is bound by device memory.  The kh*kw
// re-reads of each input element by neighbouring output pixels are served by
// L1/L2 rather than HBM; the compulsory traffic is one read of the input and
// one write of the output.  Staging the halo window in shared memory is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                       // relu
    case 2: return fminf(fmaxf(v, 0.f), 6.f);           // relu6
    case 3: return v / (1.f + expf(-v));                // silu
    default: return v;
  }
}

__global__ void __launch_bounds__(THREADS)
depthwise_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int H, int W, int Cin, int KH, int KW, int cin_g,
                      int Cout, int cout_g, int stride, int Ho, int Wo,
                      long long total, int act) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % Cout);
  long long p = idx / Cout;
  const int wo = (int)(p % Wo);
  p /= Wo;
  const int ho = (int)(p % Ho);
  const int img = (int)(p / Ho);
  const int ci0 = (co / cout_g) * cin_g;

  const float* xp =
      x + ((size_t)(img * H + ho * stride) * W + wo * stride) * Cin + ci0;
  float acc = 0.f;
  for (int u = 0; u < KH; ++u) {
    for (int v = 0; v < KW; ++v) {
      const float* xr = xp + ((size_t)u * W + v) * Cin;
      const float* wr = w + (size_t)((u * KW + v) * cin_g) * Cout + co;
      for (int ci = 0; ci < cin_g; ++ci)
        acc = fmaf(__ldg(xr + ci), __ldg(wr + (size_t)ci * Cout), acc);
    }
  }
  if (bias != nullptr) acc += bias[co];
  y[idx] = activate(acc, act);
}

}  // namespace

// x (N,H,W,G*cin_g), w (kh,kw,cin_g,G*cout_g), bias (Cout) or NULL,
// y (N,Ho,Wo,Cout); all fp32, contiguous, on the device of `stream`.
// act: 0 none, 1 relu, 2 relu6, 3 silu.  Returns the launch's cudaError_t.
extern "C" int depthwise_conv_f32(const float* x, const float* w,
                                  const float* bias, float* y, int n, int h,
                                  int wd, int cin, int kh, int kw, int cin_g,
                                  int cout, int groups, int stride, int ho,
                                  int wo, int act, void* stream) {
  const long long total = (long long)n * ho * wo * cout;
  const long long blocks = (total + THREADS - 1) / THREADS;
  depthwise_conv_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, h, wd, cin, kh, kw, cin_g, cout, cout / groups, stride,
      ho, wo, total, act);
  return static_cast<int>(cudaGetLastError());
}
