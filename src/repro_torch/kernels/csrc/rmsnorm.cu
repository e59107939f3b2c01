// RMSNorm for Hopper (sm_90a):  y = x * rsqrt(mean(x^2) + eps) * (1 + g),
// row-wise over x (M, D), g (D,).  Two bodies of one template: fp32 (x, g,
// y fp32) and bf16 (x, y bf16; g bf16 or fp32).
//
// Replaces the TPU kernel in src/repro/kernels/rmsnorm.py (`rmsnorm`, body
// `_kernel`): one row tile per grid step, the row kept in VMEM between the
// reduction and the scale, so device memory sees one read of x and one
// write of y; it upcasts x and g to fp32, computes in fp32 and writes
// x.dtype.
//
// Bound: bytes.  M * D * (4 + 4) + 4 * D bytes in fp32, M * D * (2 + 2) +
// 2 * D in bf16, at 1 FLOP per byte or so, far below the fp32 ridge (~20
// FLOP/byte).  At M = 8 (one decode step) the launch is latency, not
// bandwidth.
//
// The design (three paths; `launch_plan` in kernels/rmsnorm.py picks one
// from D, the alignment and M, the same for both bodies):
// - A warp a row (D % 4 == 0, the rows aligned to four elements, D up to
//   640: the configs' 576 and SmolLM-135M's training rows): lane l owns
//   the four-element chunks l, l + 32, l + 64, ... (a float4, or four
//   bf16 in 8 bytes: each load of the warp 512 or 256 contiguous bytes),
//   loads them and g's at once, before the reduction, and keeps x in
//   registers as loaded (a bf16 chunk is widened where it is used), so x
//   is read once; the sum of squares in fp32 in element order, then warp
//   shuffles only (no shared memory, no __syncthreads).  WR rows a block,
//   WR chosen by fill: one row a block where M cannot give every SM a
//   block (a decode step), up to 8 where M fills the card several times
//   over.  Wider rows stay a block a row: timed on the H100, the warp path
//   lost to it from D 768 up (up to 1.9x at bf16 D 1024, and at D 2560 and
//   over at M 8).
// - A block a row (wider rows): 256 threads, the same four-element
//   chunks, a warp-shuffle then shared-memory reduction, a second pass
//   over the row (still in L1/L2) writes y.
// - Ragged D and unaligned rows: the same block a row, element by element.
// The order of the arithmetic is the plain version's: the mean is the sum
// divided by D, then x * r, then (x * r) * (1 + g).  Both bodies share
// every path element for element: the bf16 body widens each load to fp32
// (exact), keeps the fp32 body's chunks per thread, so the same row
// reduction in the same order, and rounds once, at the store, to bf16
// (round to nearest even).  So its output is bitwise the fp32 body's on
// the widened operands, rounded.  Nothing is padded (the TPU op padded rows
// to 128).
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

// Four consecutive elements (a 16- or 8-byte aligned chunk) of an fp32 or
// bf16 row as loaded, and widened to fp32 (bf16 -> fp32 is the 16 bits
// shifted up: exact).
__device__ __forceinline__ float4 raw4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 raw4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 wide4(float4 v) { return v; }
__device__ __forceinline__ float4 wide4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

// One element, and four consecutive ones, widened to fp32; and their
// stores, rounded.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) {
  return wide4(raw4(p));
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

// A warp a row: lane l owns the four-element chunks l + 32 j, j < NQ, of
// the row's D / 4 (the block path's chunks; each load of the warp 512 or
// 256 contiguous bytes), and loads them and g's at once, before the
// reduction.
template <typename T, typename G, int NQ>
__global__ void __launch_bounds__(THREADS)
rmsnorm_warp(const T* __restrict__ x, const G* __restrict__ g,
             T* __restrict__ y, int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const int quads = D / 4;
  const T* xr = x + static_cast<size_t>(row) * D;
  T* yr = y + static_cast<size_t>(row) * D;
  decltype(raw4(x)) xv[NQ];
  decltype(raw4(g)) gv[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    if (lane + 32 * j < quads) {
      xv[j] = raw4(xr + 4 * (lane + 32 * j));
      gv[j] = raw4(g + 4 * (lane + 32 * j));
    }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    if (lane + 32 * j < quads) {
      const float4 v = wide4(xv[j]);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    if (lane + 32 * j < quads) {
      const float4 v = wide4(xv[j]), s = wide4(gv[j]);
      st4(yr + 4 * (lane + 32 * j),
          make_float4(v.x * r * (1.f + s.x), v.y * r * (1.f + s.y),
                      v.z * r * (1.f + s.z), v.w * r * (1.f + s.w)));
    }
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

// The warp path's instance of NQ chunks a lane (the plan's `nq`).
template <typename T, typename G, int NQ>
int launch_warp(const T* x, const G* g, T* y, int m, int d, float eps,
                int wr, cudaStream_t s) {
  rmsnorm_warp<T, G, NQ><<<(m + wr - 1) / wr, 32 * wr, 0, s>>>(x, g, y, m,
                                                                d, eps);
  return static_cast<int>(cudaGetLastError());
}

// path 0: a block a row, element by element; 1: a block a row, four
// elements a load; 2: a warp a row, wr rows a block, nq chunks of four
// elements a lane (nq * 128 >= d).
template <typename T, typename G>
int launch(const void* x, const void* g, void* y, int m, int d, float eps,
           int path, int wr, int nq, void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(g);
  T* yp = static_cast<T*>(y);
  if (path == 0) {
    rmsnorm_kernel<T, G, false><<<m, THREADS, 0, s>>>(xp, gp, yp, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == 1) {
    rmsnorm_kernel<T, G, true><<<m, THREADS, 0, s>>>(xp, gp, yp, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 2 || d % 4 != 0 || wr <= 0 || 32 * wr > THREADS ||
      128 * nq < d)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nq) {
    case 1: return launch_warp<T, G, 1>(xp, gp, yp, m, d, eps, wr, s);
    case 2: return launch_warp<T, G, 2>(xp, gp, yp, m, d, eps, wr, s);
    case 3: return launch_warp<T, G, 3>(xp, gp, yp, m, d, eps, wr, s);
    case 4: return launch_warp<T, G, 4>(xp, gp, yp, m, d, eps, wr, s);
    case 5: return launch_warp<T, G, 5>(xp, gp, yp, m, d, eps, wr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M,D), g (D), y (M,D); fp32, contiguous, on the device of `stream`;
// the plan (path, wr, nq) as `launch` takes it: paths 1 and 2 only when D
// % 4 == 0 and the three pointers are 16-byte aligned.  Returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int rmsnorm_f32(const float* x, const float* g, float* y, int m,
                           int d, float eps, int path, int wr, int nq,
                           void* stream) {
  return launch<float, float>(x, g, y, m, d, eps, path, wr, nq, stream);
}

// The bf16 body: x, y bf16; g bf16 (g_f32 == 0) or fp32 (g_f32 != 0); the
// plan as rmsnorm_f32's: paths 1 and 2 only when D % 4 == 0 and x, y and a
// bf16 g are 8-byte (an fp32 g 16-byte) aligned.  Returns the launch's
// cudaError_t.
extern "C" int rmsnorm_bf16(const void* x, const void* g, void* y, int m,
                            int d, float eps, int g_f32, int path, int wr,
                            int nq, void* stream) {
  if (g_f32)
    return launch<__nv_bfloat16, float>(x, g, y, m, d, eps, path, wr, nq,
                                         stream);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, m, d, eps, path, wr,
                                              nq, stream);
}
