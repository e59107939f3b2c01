// RMSNorm for Hopper (sm_90a):  y = x * rsqrt(mean(x^2) + eps) * (1 + g),
// row-wise over x (M, D), g (D,).  Two bodies of one template: fp32 (x, g,
// y fp32) and bf16 (x, y bf16; g bf16 or fp32).
//
// Replaces the TPU kernel in src/repro/kernels/rmsnorm.py (`rmsnorm`, body
// `_kernel`): one row tile per grid step, the row kept in VMEM between the
// reduction and the scale, so device memory sees one read of x and one
// write of y; it upcasts x and g to fp32, computes in fp32 and writes
// x.dtype.  Here one block of 256 threads owns one row: each thread sums
// the squares of its strided share of the row in fp32 (four elements a
// load where the row allows it: a float4, or four bf16 in 8 bytes), a
// warp-shuffle then shared-memory reduction gives the block the row's
// sum, and a second pass over the row (still in L1/L2: at most 10 KB at
// D = 2560 in fp32) writes y.  The order of the arithmetic is the plain
// version's: the mean is the sum divided by D, then x * r, then
// (x * r) * (1 + g).  Both bodies share that arithmetic element for
// element: the bf16 body widens each load to fp32 (exact), keeps the same
// four-element chunks per thread, so the same row reduction in the same
// order, and rounds once, at the store, to bf16 (round to nearest even).
// So its output is bitwise the fp32 body's on the widened operands,
// rounded.  Ragged D and unaligned rows take the scalar path; nothing is
// padded (the TPU op padded rows to 128).
//
// Bound: bytes.  M * D * (4 + 4) + 4 * D bytes in fp32, M * D * (2 + 2) +
// 2 * D in bf16 (half the fp32 body's at each row), at 1 FLOP per byte or
// so, far below the fp32 ridge (~20 FLOP/byte).  At M = 8 (one decode
// step) only 8 blocks run: the launch is latency, not bandwidth.  At
// M = 1024 (a probe) 1024 blocks of 8 warps cover the 132 SMs several
// times over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// One element, and four consecutive ones (a 16- or 8-byte aligned chunk),
// of an fp32 or bf16 row, widened to fp32; and their stores, rounded.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  // bf16 -> fp32 is the 16 bits shifted up: exact
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// T: x and y; G: g.  VEC: D % 4 == 0 and x, g, y aligned to four
// elements (the wrapper decides).
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ g,
               T* __restrict__ y, int D, float eps) {
  __shared__ float red[WARPS + 1];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float ss = 0.f;
  if (VEC) {
    for (int i = threadIdx.x; i < D / 4; i += THREADS) {
      const float4 v = ld4(xr + 4 * i);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      const float v = ld1(xr + i);
      ss = fmaf(v, v, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
  if (VEC) {
    for (int i = threadIdx.x; i < D / 4; i += THREADS) {
      const float4 v = ld4(xr + 4 * i);
      const float4 s = ld4(g + 4 * i);
      st4(yr + 4 * i,
          make_float4(v.x * r * (1.f + s.x), v.y * r * (1.f + s.y),
                      v.z * r * (1.f + s.z), v.w * r * (1.f + s.w)));
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS)
      st1(yr + i, ld1(xr + i) * r * (1.f + ld1(g + i)));
  }
}

template <typename T, typename G>
int launch(const void* x, const void* g, void* y, int m, int d, float eps,
           int vec, void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(g);
  T* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, G, true><<<m, THREADS, 0, s>>>(xp, gp, yp, d, eps);
  else
    rmsnorm_kernel<T, G, false><<<m, THREADS, 0, s>>>(xp, gp, yp, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M,D), g (D), y (M,D); fp32, contiguous, on the device of `stream`;
// vec != 0 only when D % 4 == 0 and the three pointers are 16-byte
// aligned.  Returns the launch's cudaError_t (0 on success).
extern "C" int rmsnorm_f32(const float* x, const float* g, float* y, int m,
                           int d, float eps, int vec, void* stream) {
  return launch<float, float>(x, g, y, m, d, eps, vec, stream);
}

// The bf16 body: x, y bf16; g bf16 (g_f32 == 0) or fp32 (g_f32 != 0);
// vec != 0 only when D % 4 == 0 and x and y are 8-byte and g 8-byte (bf16)
// or 16-byte (fp32) aligned.  Returns the launch's cudaError_t.
extern "C" int rmsnorm_bf16(const void* x, const void* g, void* y, int m,
                            int d, float eps, int g_f32, int vec,
                            void* stream) {
  if (g_f32)
    return launch<__nv_bfloat16, float>(x, g, y, m, d, eps, vec, stream);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, m, d, eps, vec,
                                              stream);
}
