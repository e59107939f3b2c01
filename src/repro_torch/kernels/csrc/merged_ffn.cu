// Merged rank-r residual layer for Hopper (sm_90a), fp32:  y = x + (x @ U) @ V.
//
// Replaces the TPU kernel in src/repro/kernels/merged_ffn.py (`merged_ffn`,
// body `_kernel`): the merged transformer segment that the rank-merge
// produces, x (M, D), U (D, R), V (R, D), fp32 accumulation, the residual
// add fused into the epilogue, P = x @ U never written to device memory.
//
// The TPU kernel builds the P panel of an m-panel once, during its j == 0
// sweep, and keeps it in VMEM scratch for the later j sweeps: the TPU grid
// runs in order on one core.  CUDA blocks run in no order and share no
// scratch, so that carry cannot be kept in one block's memory.  Hopper's
// thread-block clusters take its place: the blocks of one 32-row m-panel
// (one per 64-wide n-tile of the output, up to 16) form a cluster, each
// computes a 64-wide chunk of P into its own shared memory, and every
// block reads the chunks of the others through distributed shared memory:
//
//   for each pass over the rank (cluster size CS chunks per pass):
//     P_b  = x[m-tile, :] @ U[:, chunk b]      (block b, own shared memory)
//     cluster barrier
//     for each chunk q of the pass:            (copied from block q)
//       acc += P_q @ V[chunk q, n-tile]         (BM x BN, fp32 registers)
//     cluster barrier
//   y[m-tile, n-tile] = acc + x[m-tile, n-tile]
//
// So P is computed once per m-panel (the function's 4MDR FLOPs, where
// recomputing it per n-tile would cost (ceil(D/64) + 1) * 2MDR), shared
// memory does not grow with R, and P never touches device memory.  Only a
// model wider than 16 n-tiles (D > 1024) splits its n-tiles over several
// clusters (grid z), each recomputing P.  Both products use the 4x4 FFMA
// register tile of merged_conv.cu over 32-deep shared-memory slices, the
// next slice loaded into registers while the current one computes; ragged
// M, D and R are masked with zeros in the loads and skipped in the stores,
// so nothing is padded (the TPU op padded every axis to 128).
//
// Bound: at the prefill/probe shape (M = 1024, D = R = 576) the 4MDR =
// 1.36 GFLOP against 2.6 MB of operands is well above the fp32 ridge
// (67 TFLOP/s FFMA over 3.35 TB/s, ~20 FLOP/byte): operations bound it
// (32 m-tiles x 9 blocks = 288 blocks of 128 threads, about two per SM).
// At decode (M = 8, one token per sequence) the 2.6 MB of U and V bound
// it; the grid is one cluster of 9 blocks, each reading 1/9 of U and of
// V, and of each block's 32 rows only 8 are live (their threads skip the
// FFMAs of the others).  Tensor cores (3xTF32 or wgmma), a TMA pipeline
// and more blocks at decode are later work.
//
// Quantized variant (merged_ffn_q, the TPU kernel's `quant=True` body):
// the same kernel instantiated on the element types of the panel that
// feeds P and of U and V.  U and V are narrow (int8, or fp8-e4m3 through
// cuda_fp8.h), prefetched narrow into registers and converted to fp32 as
// each slice is stored to shared memory; the P panel is built from the
// int8 activation xq under w8a8 (its per-tensor scale folded into u_scale
// on the device by the op) or from x itself (int8 weights only), and each
// chunk of P is multiplied by u_scale[r] as it is written to shared
// memory (the TPU kernel's "dequant P panel").  The
// second product runs over narrow V; the epilogue multiplies acc by
// v_scale[n] and adds the residual, always from the fp32 x.  The sums stay
// fp32.  At decode the narrow U and V are a quarter of the fp32 kernel's
// bytes, but its time there is latency, not bytes (PERF.md has both).
#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32;                             // rows (tokens) per block
constexpr int BN = 64;                             // output columns per block
constexpr int BR = 64;                             // rank chunk (P columns)
constexpr int BK = 32;                             // reduction slice depth
constexpr int TM = 4;                              // rows per thread
constexpr int TN = 4;                              // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);     // 128
constexpr int X_ROWS_PER_THREAD = BM * BK / THREADS;   // 8
constexpr int W_ROWS_PER_THREAD = BN * BK / THREADS;   // 16
constexpr int X_ROW_STEP = THREADS / BK;               // 4
constexpr int W_ROW_STEP = THREADS / BN;               // 2
constexpr int P_LD = BM + 4;                       // +4 keeps float4 rows aligned
constexpr int P_VEC4 = BR * P_LD / 4;              // float4s in one P chunk
constexpr int MAX_CLUSTER = 16;                    // H100, non-portable above 8
static_assert(BR == BN, "one loader and one thread map serve P and acc");
static_assert(BR % BK == 0 && THREADS % BK == 0 && THREADS % BN == 0,
              "the loaders cover whole slices");

// Narrow<T>: the register type an element of T is prefetched in (read-only
// path) and its conversion to fp32.  The loaders convert when they store a
// slice to shared memory, not when they load it: a conversion right after
// the load would stall the warp on the load, and the prefetch of the next
// slice would no longer overlap the current slice's FFMAs.
template <typename T> struct Narrow;
template <> struct Narrow<float> {
  using raw = float;
  static __device__ __forceinline__ raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float f32(raw v) { return v; }
};
template <> struct Narrow<int8_t> {
  using raw = int;
  static __device__ __forceinline__ raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const signed char*>(p));
  }
  // Without the quarter-rate I2F convert: the bits 0x4B000000 + k are the
  // float 2^23 + k exactly for 0 <= k < 2^23, so with k = v + 128 one
  // integer add and one float subtraction give v exactly.
  static __device__ __forceinline__ float f32(raw v) {
    return __int_as_float(0x4B000080 + v) - 8388736.f;
  }
};
template <> struct Narrow<__nv_fp8_e4m3> {
  using raw = unsigned int;
  static __device__ __forceinline__ raw load(const __nv_fp8_e4m3* p) {
    return __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  static __device__ __forceinline__ float f32(raw v) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(v), __NV_E4M3)));
  }
};

// XQ: element type of the panel xq that feeds P = xq @ U (x itself in the
// fp32 instance); WT: element type of U and V; QUANT: apply u_scale to P
// and v_scale to acc.
template <typename XQ, typename WT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
merged_ffn_kernel(const float* __restrict__ x, const XQ* __restrict__ xq,
                  const WT* __restrict__ u, const WT* __restrict__ v,
                  const float* __restrict__ u_scale,
                  const float* __restrict__ v_scale, float* __restrict__ y,
                  int M, int D, int R) {
  __shared__ __align__(16) float Xs[BK][BM + 4];   // x slice, transposed
  __shared__ __align__(16) float Ws[BK][BN];       // U slice, then V slice
  __shared__ __align__(16) float Ps[BR][P_LD];     // own P chunk, rank-major
  __shared__ __align__(16) float Pl[BR][P_LD];     // chunk being consumed

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = (blockIdx.z * cs + rank) * BN;
  const bool has_out = n0 < D;                     // uniform per block
  const int n_chunks = (R + BR - 1) / BR;

  // x loader: column xk of the slice, rows xm0 + X_ROW_STEP*i.
  const int xk = tid % BK;
  const int xm0 = tid / BK;
  // U / V loader: column wc of the tile, slice rows wk0 + W_ROW_STEP*i.
  const int wc = tid % BN;
  const int wk0 = tid / BN;
  // Compute mapping: rows ty*TM.., columns tx*TN.. (of P, then of acc).
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // Rows past M hold zeros: their threads load but skip the FFMA loops
  // (a whole warp covers 8 rows, so at M = 8 three of four warps idle
  // instead of multiplying zeros).
  const bool live = m0 + ty * TM < M;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < n_chunks; c0 += cs) {
    // Phase 1: this block's chunk, P_c = x[m-tile, :] @ U[:, c*BR...].
    const int c = c0 + rank;
    if (c < n_chunks) {
      float p[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) p[i][j] = 0.f;
      const int ur = c * BR + wc;
      // The next slice is loaded into registers while this one computes.
      typename Narrow<XQ>::raw xr[X_ROWS_PER_THREAD];
      typename Narrow<WT>::raw wr[W_ROWS_PER_THREAD];
      auto load_u_slice = [&](int k0) {
        const int d = k0 + xk;
#pragma unroll
        for (int i = 0; i < X_ROWS_PER_THREAD; ++i) {
          const int m = m0 + xm0 + X_ROW_STEP * i;
          xr[i] = (m < M && d < D) ? Narrow<XQ>::load(xq + (size_t)m * D + d)
                                   : 0;
        }
#pragma unroll
        for (int i = 0; i < W_ROWS_PER_THREAD; ++i) {
          const int kr = k0 + wk0 + W_ROW_STEP * i;
          wr[i] = (kr < D && ur < R) ? Narrow<WT>::load(u + (size_t)kr * R + ur)
                                     : 0;
        }
      };
      load_u_slice(0);
      for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
        for (int i = 0; i < X_ROWS_PER_THREAD; ++i)
          Xs[xk][xm0 + X_ROW_STEP * i] = Narrow<XQ>::f32(xr[i]);
#pragma unroll
        for (int i = 0; i < W_ROWS_PER_THREAD; ++i)
          Ws[wk0 + W_ROW_STEP * i][wc] = Narrow<WT>::f32(wr[i]);
        __syncthreads();
        if (k0 + BK < D) load_u_slice(k0 + BK);
        if (live) {
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            const float4 a =
                *reinterpret_cast<const float4*>(&Xs[kk][ty * TM]);
            const float4 b =
                *reinterpret_cast<const float4*>(&Ws[kk][tx * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                p[i][j] = fmaf(av[i], bv[j], p[i][j]);
          }
        }
        __syncthreads();
      }
      // Rank-major: row r of Ps holds P[m-tile, c*BR + r].
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float sc = 1.f;                            // fp32: P as summed
        if constexpr (QUANT) {
          const int r = c * BR + tx * TN + j;
          sc = r < R ? u_scale[r] : 0.f;
        }
        *reinterpret_cast<float4*>(&Ps[tx * TN + j][ty * TM]) = make_float4(
            p[0][j] * sc, p[1][j] * sc, p[2][j] * sc, p[3][j] * sc);
      }
    }
    // Every chunk of this pass is in its owner's shared memory.
    cluster.sync();

    // Phase 2: acc += P_q @ V[q*BR..., n-tile] for each chunk q of the pass.
    if (has_out) {
      const int last = min(cs, n_chunks - c0);
      const int vn = n0 + wc;
      for (int q = 0; q < last; ++q) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(&Ps[0][0], q));
        float4* dst = reinterpret_cast<float4*>(&Pl[0][0]);
        for (int i = tid; i < P_VEC4; i += THREADS) dst[i] = src[i];
        // (the __syncthreads after the first V slice load publishes Pl;
        // the one closing the previous chunk's loop freed it)
        const int rq = (c0 + q) * BR;
        typename Narrow<WT>::raw vr[W_ROWS_PER_THREAD];
        auto load_v_slice = [&](int k0) {
#pragma unroll
          for (int i = 0; i < W_ROWS_PER_THREAD; ++i) {
            const int r = rq + k0 + wk0 + W_ROW_STEP * i;
            vr[i] = (r < R && vn < D) ? Narrow<WT>::load(v + (size_t)r * D + vn)
                                      : 0;
          }
        };
        load_v_slice(0);
        for (int k0 = 0; k0 < BR; k0 += BK) {
#pragma unroll
          for (int i = 0; i < W_ROWS_PER_THREAD; ++i)
            Ws[wk0 + W_ROW_STEP * i][wc] = Narrow<WT>::f32(vr[i]);
          __syncthreads();
          if (k0 + BK < BR) load_v_slice(k0 + BK);
          if (live) {
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
              const float4 a =
                  *reinterpret_cast<const float4*>(&Pl[k0 + kk][ty * TM]);
              const float4 b =
                  *reinterpret_cast<const float4*>(&Ws[kk][tx * TN]);
              const float av[TM] = {a.x, a.y, a.z, a.w};
              const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                  acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
          }
          __syncthreads();
        }
      }
    }
    // No block overwrites its chunk (next pass) or exits (last pass) while
    // another block of the cluster may still be reading it.
    cluster.sync();
  }

  // Epilogue: (acc * v_scale[n],) the residual x[m, n] added in fp32,
  // masked store.
  if (!has_out) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < D) {
        const size_t o = (size_t)m * D + n;
        float a = acc[i][j];
        if constexpr (QUANT) a *= v_scale[n];
        y[o] = a + __ldg(x + o);
      }
    }
  }
}

template <typename XQ, typename WT, bool QUANT>
int launch(const float* x, const void* xq, const void* u, const void* v,
           const float* u_scale, const float* v_scale, float* y, int m,
           int d, int r, void* stream) {
  const int n_tiles = (d + BN - 1) / BN;
  const int cs = n_tiles < MAX_CLUSTER ? n_tiles : MAX_CLUSTER;
  if (cs > 8) {
    // Once per device and instance, so that a launch inside CUDA-graph
    // capture makes no call that capture forbids.
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(merged_ffn_kernel<XQ, WT, QUANT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (m + BM - 1) / BM, (n_tiles + cs - 1) / cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, merged_ffn_kernel<XQ, WT, QUANT>, x, static_cast<const XQ*>(xq),
      static_cast<const WT*>(u), static_cast<const WT*>(v), u_scale, v_scale,
      y, m, d, r);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M,D), u (D,R), v (R,D), y (M,D); all fp32, contiguous, on the device
// of `stream`; ceil(M/32) <= 65535.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int merged_ffn_f32(const float* x, const float* u, const float* v,
                              float* y, int m, int d, int r, void* stream) {
  return launch<float, float, false>(x, x, u, v, nullptr, nullptr, y, m, d,
                                     r, stream);
}

// The quantized variant: x (M,D) fp32 (the residual); xq (M,D) the panel
// feeding P, fp32 (xq_type 0: x itself) or int8 (1, w8a8); u (D,R) and
// v (R,D) int8 (w_type 1) or fp8-e4m3 (2); u_scale (R) and v_scale (D)
// fp32.  Returns the launch's cudaError_t, or cudaErrorInvalidValue for a
// type pair it does not take.
extern "C" int merged_ffn_q(const float* x, const void* xq, const void* u,
                            const void* v, const float* u_scale,
                            const float* v_scale, float* y, int m, int d,
                            int r, int xq_type, int w_type, void* stream) {
  if (xq_type == 0 && w_type == 1)
    return launch<float, int8_t, true>(x, xq, u, v, u_scale, v_scale, y, m,
                                       d, r, stream);
  if (xq_type == 1 && w_type == 1)
    return launch<int8_t, int8_t, true>(x, xq, u, v, u_scale, v_scale, y, m,
                                        d, r, stream);
  if (xq_type == 0 && w_type == 2)
    return launch<float, __nv_fp8_e4m3, true>(x, xq, u, v, u_scale, v_scale,
                                              y, m, d, r, stream);
  if (xq_type == 1 && w_type == 2)
    return launch<int8_t, __nv_fp8_e4m3, true>(x, xq, u, v, u_scale,
                                               v_scale, y, m, d, r, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
