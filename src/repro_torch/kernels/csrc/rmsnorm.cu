// RMSNorm for Hopper (sm_90a), fp32:  y = x * rsqrt(mean(x^2) + eps) * (1 + g),
// row-wise over x (M, D), g (D,).
//
// Replaces the TPU kernel in src/repro/kernels/rmsnorm.py (`rmsnorm`, body
// `_kernel`): one row tile per grid step, the row kept in VMEM between the
// reduction and the scale, so device memory sees one read of x and one
// write of y.  Here one block of 256 threads owns one row: each thread sums
// the squares of its strided share of the row in fp32 (float4 loads where
// the row allows them), a warp-shuffle then shared-memory reduction gives
// the block the row's sum, and a second pass over the row (still in L1/L2:
// at most 10 KB at D = 2560) writes y.  The order of the arithmetic is the
// plain version's: the mean is the sum divided by D, then x * r, then
// (x * r) * (1 + g).  Ragged D and unaligned rows take the scalar path;
// nothing is padded (the TPU op padded rows to 128).
//
// Bound: bytes.  2 * M * D * 4 + 4 * D bytes at 1 FLOP per byte or so,
// far below the fp32 ridge (~20 FLOP/byte).  At M = 8 (one decode step)
// only 8 blocks run: the launch is latency, not bandwidth.  At M = 1024
// (a probe) 1024 blocks of 8 warps cover the 132 SMs several times over.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

// VEC: D % 4 == 0 and x, g, y 16-byte aligned (the wrapper decides).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ y, int D, float eps) {
  __shared__ float red[WARPS + 1];
  const size_t row = blockIdx.x;
  const float* xr = x + row * D;
  float* yr = y + row * D;
  float ss = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < D / 4; i += THREADS) {
      const float4 v = __ldg(x4 + i);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      const float v = __ldg(xr + i);
      ss = fmaf(v, v, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = threadIdx.x; i < D / 4; i += THREADS) {
      const float4 v = __ldg(x4 + i);
      const float4 s = __ldg(g4 + i);
      y4[i] = make_float4(v.x * r * (1.f + s.x), v.y * r * (1.f + s.y),
                          v.z * r * (1.f + s.z), v.w * r * (1.f + s.w));
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS)
      yr[i] = __ldg(xr + i) * r * (1.f + __ldg(g + i));
  }
}

}  // namespace

// x (M,D), g (D), y (M,D); fp32, contiguous, on the device of `stream`;
// vec != 0 only when D % 4 == 0 and the three pointers are 16-byte
// aligned.  Returns the launch's cudaError_t (0 on success).
extern "C" int rmsnorm_f32(const float* x, const float* g, float* y, int m,
                           int d, float eps, int vec, void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rmsnorm_kernel<true><<<m, THREADS, 0, s>>>(x, g, y, d, eps);
  else
    rmsnorm_kernel<false><<<m, THREADS, 0, s>>>(x, g, y, d, eps);
  return static_cast<int>(cudaGetLastError());
}
