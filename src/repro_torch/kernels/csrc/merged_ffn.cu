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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(THREADS)
merged_ffn_kernel(const float* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ v, float* __restrict__ y,
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
      float xr[X_ROWS_PER_THREAD], wr[W_ROWS_PER_THREAD];
      auto load_u_slice = [&](int k0) {
        const int d = k0 + xk;
#pragma unroll
        for (int i = 0; i < X_ROWS_PER_THREAD; ++i) {
          const int m = m0 + xm0 + X_ROW_STEP * i;
          xr[i] = (m < M && d < D) ? __ldg(x + (size_t)m * D + d) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < W_ROWS_PER_THREAD; ++i) {
          const int kr = k0 + wk0 + W_ROW_STEP * i;
          wr[i] = (kr < D && ur < R) ? __ldg(u + (size_t)kr * R + ur) : 0.f;
        }
      };
      load_u_slice(0);
      for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
        for (int i = 0; i < X_ROWS_PER_THREAD; ++i)
          Xs[xk][xm0 + X_ROW_STEP * i] = xr[i];
#pragma unroll
        for (int i = 0; i < W_ROWS_PER_THREAD; ++i)
          Ws[wk0 + W_ROW_STEP * i][wc] = wr[i];
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
      for (int j = 0; j < TN; ++j)
        *reinterpret_cast<float4*>(&Ps[tx * TN + j][ty * TM]) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
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
        float vr[W_ROWS_PER_THREAD];
        auto load_v_slice = [&](int k0) {
#pragma unroll
          for (int i = 0; i < W_ROWS_PER_THREAD; ++i) {
            const int r = rq + k0 + wk0 + W_ROW_STEP * i;
            vr[i] = (r < R && vn < D) ? __ldg(v + (size_t)r * D + vn) : 0.f;
          }
        };
        load_v_slice(0);
        for (int k0 = 0; k0 < BR; k0 += BK) {
#pragma unroll
          for (int i = 0; i < W_ROWS_PER_THREAD; ++i)
            Ws[wk0 + W_ROW_STEP * i][wc] = vr[i];
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

  // Epilogue: the residual x[m, n] added in fp32, masked store.
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
        y[o] = acc[i][j] + __ldg(x + o);
      }
    }
  }
}

}  // namespace

// x (M,D), u (D,R), v (R,D), y (M,D); all fp32, contiguous, on the device
// of `stream`; ceil(M/32) <= 65535.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int merged_ffn_f32(const float* x, const float* u, const float* v,
                              float* y, int m, int d, int r, void* stream) {
  const int n_tiles = (d + BN - 1) / BN;
  const int cs = n_tiles < MAX_CLUSTER ? n_tiles : MAX_CLUSTER;
  if (cs > 8) {
    // Once per device, so that a launch inside CUDA-graph capture makes
    // no call that capture forbids.
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(merged_ffn_kernel,
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
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, merged_ffn_kernel, x, u, v, y, m, d, r);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
