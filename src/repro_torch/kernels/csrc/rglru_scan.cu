// RG-LRU linear recurrence for Hopper (sm_90a), fp32:
//   h_t = a_t * h_{t-1} + b_t over t, h_0 = 0;  a, b, h (B, S, C).
//
// Replaces the TPU kernel in src/repro/kernels/rglru_scan.py (`rglru_scan`,
// body `_kernel`): grid (batch, channel tiles, time tiles), time innermost,
// the carry h in VMEM scratch across the sequential time tiles.  CUDA
// blocks run in no order, so the carry cannot cross blocks; instead one
// thread owns one (batch, channel) and loops over all S steps with h in a
// register.  Consecutive threads take consecutive channels, so each step's
// loads of a and b and its store of h are coalesced rows of the (B, S, C)
// arrays.  The loads of UNROLL steps are issued before their
// multiply-adds, so each thread keeps 2 * UNROLL loads in flight.  The
// ragged channel edge is masked; nothing is padded (the TPU op padded
// channels to 128 and time to 256 for its tiling).  Each step is a
// correctly rounded multiply and then a correctly rounded add (no FMA
// contraction): the plain version's arithmetic, so the two agree bitwise.
//
// Bound: bytes, 3 * B * S * C * 4 (a and b read once, h written once) at
// 2 FLOPs per 12 bytes.  Parallelism is B * C threads: at (8, S, 2560),
// 20,480 threads in 160 blocks of 128, 1.2 blocks (5 warps) per SM of the
// 132, so the card is NOT filled: about 1.3 MB of loads in flight where
// the HBM rate needs ~3 MB.  Splitting time into chunks (a two-level scan
// over the affine maps (a, b)) would fill it; that is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const size_t step = C;
  float hv = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
    const size_t o = base + t * step;
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      av[i] = __ldg(a + o + i * step);
      bv[i] = __ldg(b + o + i * step);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      h[o + i * step] = hv;
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + t * step;
    hv = __fadd_rn(__fmul_rn(__ldg(a + o), hv), __ldg(b + o));
    h[o] = hv;
  }
}

}  // namespace

// a, b, h (B,S,C) fp32, contiguous, on the device of `stream`;
// B <= 65535.  Returns the launch's cudaError_t (0 on success).
extern "C" int rglru_scan_f32(const float* a, const float* b, float* h,
                              int bsz, int s, int c, void* stream) {
  if (bsz <= 0 || s <= 0 || c <= 0 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + THREADS - 1) / THREADS, bsz);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, s, c);
  return static_cast<int>(cudaGetLastError());
}
