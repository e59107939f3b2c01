// Merged rank-r residual layer for Hopper (sm_90a), fp32 result:
//   y = x + ((xq @ U) · u_scale) @ V · v_scale
// (fp32 entry: xq = x, no scales; with the residual switch off, y without
// the x term: one rank's partial of a tensor-parallel split).
//
// Replaces the TPU kernel in src/repro/kernels/merged_ffn.py (`merged_ffn`,
// body `_kernel`, and its `quant=True` body): x (M, D), U (D, R), V (R, D),
// fp32 sums, the residual from the fp32 x added in the epilogue.
//
// Two launches of one tile core, in order on the caller's stream:
//   phase A  P = xq @ U (· u_scale)      (M, R) fp32 workspace, written once
//   phase B  y = x + (P @ V) (· v_scale) (M, D)
// The TPU kernel carried its P panel across sequential j sweeps in VMEM.
// CUDA blocks share no scratch, and a thread-block cluster holds at most 16
// blocks, so keeping P on chip would mean recomputing it once per cluster
// of output tiles at D > 1024 (8MDR FLOPs where the function needs 4MDR).
// Here P makes one trip through L2 (10.5 MB at M 1024, R 2560; 80 KB at
// decode), which costs far less.
//
// What bounds each phase on the H100, and what the design does about it:
// - Operations, above about M = 64 (probes at M = 1024, prefill at M = 128).
//   The products use the tensor cores (mma.sync m16n8k8 TF32, fp32
//   accumulation) at fp32 accuracy: an fp32 operand a is split into
//   hi = rna_tf32(a) and lo = rna_tf32(a - hi), and a·b is summed as
//   lo·hi' + hi·lo' + hi·hi' (3xTF32; the dropped lo·lo' is 2^-22 of |a·b|).
//   A narrow operand (int8, |v| <= 128; fp8-e4m3, 4 significant bits) is
//   exact in TF32, so fp32 x narrow takes 2 products and narrow x narrow
//   (w8a8's phase A) one.  3xTF32 runs at 495/3 TFLOP/s, 2.5x the fp32
//   FFMA rate that bounds cuBLAS's fp32 SGEMM.
//   Tiles are 128 x 128 over 32-deep k-slices, 8 warps of 64 x 32.
// - Bytes, below about M = 64 (decode: U and V are 52 MB at D = R = 2560,
//   2.65 MB at D 576).  Tiles are 16 x 64, 4 warps, and the reduction is
//   split as well as the output (up to 16 ways), so that a phase runs
//   hundreds of blocks, 5 resident per SM, each with 3 slices of loads in
//   flight: far over the ~3 MB the HBM rate times its latency needs.
// - Both: a ring of STAGES slices of A and B tiles in dynamic shared memory,
//   filled by cp.async.cg 16-byte copies (zero-filled past the ragged M, D
//   and R edges, so nothing is padded in Python); one __syncthreads per
//   slice.  Where a row is not 16-byte aligned (odd D or R) the copies go
//   element by element (cp.async of 4 bytes, or plain loads for 1-byte
//   types): right, slower, and never on a model's main path.  Narrow values
//   stay narrow in shared memory and are converted as fragments are built.
// - Split reduction, deterministic: the blocks of one output tile's splits
//   form a cluster; each writes its partial tile to its shared memory, and
//   after a cluster barrier each block sums a 1/S share of the tile over
//   the S partials through distributed shared memory, always in split
//   order.  No float atomics: two calls on the same inputs give bitwise
//   the same y.
//
// The launch plan (tile shape, splits, k-chunk per split, grid) is chosen
// in Python (`launch_plan` in kernels/merged_ffn.py, where the CPU tests
// check that it covers every output and reduction index once) and passed
// in; this file checks it and derives the grid from it.
#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;            // k-slice depth
constexpr int MAX_SPLITS = 16;    // cluster size; non-portable above 8

// BM x BN block tile, WARPS_M x WARPS_N warps, STAGES slices in flight,
// MIN_BLOCKS resident per SM (the launch bound).
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_,
                       WARPS_N = WARPS_N_, STAGES = STAGES_,
                       MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles
  static_assert(WM % 16 == 0 && WN % 8 == 0, "whole mma tiles per warp");
};
using Small = Tile<16, 64, 1, 4, 4, 4>;     // M <= 64: bytes (5 fit an SM)
using Large = Tile<128, 128, 2, 4, 4, 1>;   // M > 64: operations

// Shared-memory layout of one instance.  Row pitches keep every row
// 16-byte aligned for cp.async and make the fragment loads conflict-free
// (A read as pairs of k, B rows 2t and 2t + 1, see the k-loop): A rows of
// 40 floats (or 48 bytes), B rows of BN + 4 floats (or BN + 16 bytes).
// After the k-loop the same memory holds the fp32 partial tile.
template <class C, typename TA, typename TB> struct Layout {
  using SA = typename Elem<TA>::storage;
  using SB = typename Elem<TB>::storage;
  static constexpr int A_LD = BK + (Elem<TA>::wide ? 8 : 16);
  static constexpr int B_LD = C::BN + (Elem<TB>::wide ? 4 : 16);
  static constexpr int A_BYTES = C::BM * A_LD * int(sizeof(SA));
  static constexpr int STAGE = A_BYTES + BK * B_LD * int(sizeof(SB));
  static constexpr int C_LD = C::BN + 4;
  static constexpr int PIPE = C::STAGES * STAGE;
  static constexpr int RED = C::BM * C_LD * 4;
  static constexpr int BYTES = PIPE > RED ? PIPE : RED;
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
};

// One product C[M, N] (+)= A[M, K] @ B[K, N], both row-major; split s of
// the grid's x axis sums k in [s * k_chunk, (s + 1) * k_chunk).
struct Args {
  const void* a;
  const void* b;
  const float* scale;   // per column of C (QUANT), else unused
  const float* resid;   // (M, N) added after the scale (RESID), else unused
  float* out;           // (M, N)
  int M, N, K, k_chunk;
  int a_vec, b_vec;     // 1: rows 16-byte aligned, copy in 16-byte chunks
};

// ROWS x COLS tile at (row0, col0) of a row-major matrix with row pitch ld
// into shared memory of pitch LD; rows >= row_lim and columns >= col_lim
// are zero-filled.
template <typename S, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(S* dst, const S* src, int ld,
                                          int row0, int col0, int row_lim,
                                          int col_lim, bool vec, int tid) {
  if (vec) {
    constexpr int V = 16 / int(sizeof(S));
    constexpr int CHUNKS = ROWS * COLS / V;
#pragma unroll
    for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (CHUNKS % THREADS == 0 || c < CHUNKS) {
        const int r = c / (COLS / V), cc = (c % (COLS / V)) * V;
        const int gr = row0 + r, gc = col0 + cc;
        const bool ok = gr < row_lim && gc < col_lim;
        cp_async16(dst + r * LD + cc, ok ? src + (size_t)gr * ld + gc : src,
                   ok);
      }
    }
  } else {
    constexpr int ELEMS = ROWS * COLS;
#pragma unroll 4
    for (int i = 0; i < (ELEMS + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (ELEMS % THREADS == 0 || e < ELEMS) {
        const int r = e / COLS, cc = e % COLS;
        const int gr = row0 + r, gc = col0 + cc;
        const bool ok = gr < row_lim && gc < col_lim;
        if constexpr (sizeof(S) == 4) {
          cp_async4(dst + r * LD + cc, ok ? src + (size_t)gr * ld + gc : src,
                    ok);
        } else {
          dst[r * LD + cc] = ok ? src[(size_t)gr * ld + gc] : S(0);
        }
      }
    }
  }
}

template <bool QUANT, bool RESID>
__device__ __forceinline__ void store(const Args& p, int row, int col,
                                      float v) {
  if (row < p.M && col < p.N) {
    if constexpr (QUANT) v *= __ldg(p.scale + col);
    const size_t o = (size_t)row * p.N + col;
    if constexpr (RESID) v += __ldg(p.resid + o);
    p.out[o] = v;
  }
}

// QUANT: scale the sum by scale[col]; RESID: add resid (phase B).
template <class C, typename TA, typename TB, bool QUANT, bool RESID>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
ffn_gemm(const Args p) {
  using L = Layout<C, TA, TB>;
  using SA = typename L::SA;
  using SB = typename L::SB;
  constexpr bool WA = Elem<TA>::wide, WB = Elem<TB>::wide;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
  const int m0 = blockIdx.z * C::BM, n0 = blockIdx.y * C::BN;
  const int k_begin = blockIdx.x * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int n_slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const SA* A = static_cast<const SA*>(p.a);
  const SB* B = static_cast<const SB*>(p.b);

  auto a_tile = [&](int s) {
    return reinterpret_cast<SA*>(smem + s * L::STAGE);
  };
  auto b_tile = [&](int s) {
    return reinterpret_cast<SB*>(smem + s * L::STAGE + L::A_BYTES);
  };
  auto load = [&](int s, int k0) {
    load_tile<SA, C::BM, BK, L::A_LD, C::THREADS>(
        a_tile(s), A, p.K, m0, k0, p.M, k_end, p.a_vec, tid);
    load_tile<SB, BK, C::BN, L::B_LD, C::THREADS>(
        b_tile(s), B, p.N, k0, n0, k_end, p.N, p.b_vec, tid);
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_slices) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int i = 0; i < n_slices; ++i) {
    cp_async_wait<C::STAGES - 2>();   // slice i has landed
    // ... and every warp is done with slice i - 1, whose buffer is next
    __syncthreads();
    const int nxt = i + C::STAGES - 1;
    if (nxt < n_slices) load(nxt % C::STAGES, k_begin + nxt * BK);
    cp_async_commit();

    const SA* As = a_tile(i % C::STAGES);
    const SB* Bs = b_tile(i % C::STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[C::MT][4], al[C::MT][4], bh[C::NT][2], bl[C::NT][2];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        // The mma's k index t of a lane reads k-slice column kk + 2t, its
        // k index t + 4 column kk + 2t + 1 (B below likewise), so that a
        // lane reads its two A columns as one pair.
        const SA* r = As + (wm0 + mt * 16 + g) * L::A_LD + kk + 2 * t;
        float f[4];
        if constexpr (WA) {
          const float2 lo8 = *reinterpret_cast<const float2*>(r);
          const float2 hi8 =
              *reinterpret_cast<const float2*>(r + 8 * L::A_LD);
          f[0] = lo8.x, f[2] = lo8.y, f[1] = hi8.x, f[3] = hi8.y;
        } else {
          f[0] = Elem<TA>::f32(r[0]), f[2] = Elem<TA>::f32(r[1]);
          f[1] = Elem<TA>::f32(r[8 * L::A_LD]);
          f[3] = Elem<TA>::f32(r[8 * L::A_LD + 1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) split<WA>(f[j], ah[mt][j], al[mt][j]);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const SB* c = Bs + (kk + 2 * t) * L::B_LD + wn0 + nt * 8 + g;
        split<WB>(Elem<TB>::f32(c[0]), bh[nt][0], bl[nt][0]);
        split<WB>(Elem<TB>::f32(c[L::B_LD]), bh[nt][1], bl[nt][1]);
      }
      // The small terms first, then hi·hi; each term over every tile
      // before the next, so that no product waits on the one before it.
      if constexpr (WA) {
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
            mma(acc[mt][nt], al[mt], bh[nt]);
      }
      if constexpr (WB) {
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
            mma(acc[mt][nt], ah[mt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
    }
  }
  cp_async_wait<0>();

  if (gridDim.x == 1) {   // no split: the epilogue straight from registers
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int r = m0 + wm0 + mt * 16 + g;
        const int c = n0 + wn0 + nt * 8 + 2 * t;
        store<QUANT, RESID>(p, r, c, acc[mt][nt][0]);
        store<QUANT, RESID>(p, r, c + 1, acc[mt][nt][1]);
        store<QUANT, RESID>(p, r + 8, c, acc[mt][nt][2]);
        store<QUANT, RESID>(p, r + 8, c + 1, acc[mt][nt][3]);
      }
    return;
  }

  // Split reduction through the cluster (the x axis of the grid).
  __syncthreads();   // the pipeline's memory becomes the partial tile
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int r = wm0 + mt * 16 + g, c = wn0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * L::C_LD + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * L::C_LD + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its block's memory
  const int S = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int V4 = C::BM * C::BN / 4;
  const int share = (V4 + S - 1) / S;
  const int lo = q * share, hi = min(V4, lo + share);
  for (int i = lo + tid; i < hi; i += C::THREADS) {
    const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    float* own = Cs + r * L::C_LD + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {   // split order: deterministic
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(own, s));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store<QUANT, RESID>(p, m0 + r, n0 + c, sum.x);
    store<QUANT, RESID>(p, m0 + r, n0 + c + 1, sum.y);
    store<QUANT, RESID>(p, m0 + r, n0 + c + 2, sum.z);
    store<QUANT, RESID>(p, m0 + r, n0 + c + 3, sum.w);
  }
  cluster.sync();   // no block leaves while another may read its partial
}

// One phase's plan as the wrapper computed it.
struct Plan {
  int bm, bn, splits, k_chunk;
};

// The splits cover [0, K) once, in whole k-slices.
bool plan_ok(const Plan& pl, int K) {
  if (pl.splits < 1 || pl.splits > MAX_SPLITS) return false;
  if (K == 0) return pl.splits == 1;
  if (pl.k_chunk <= 0 || pl.k_chunk % BK) return false;
  return (long long)(pl.splits - 1) * pl.k_chunk < K &&
         (long long)pl.splits * pl.k_chunk >= K;
}

bool vec_ok(const void* ptr, int ld, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         ((long long)ld * elem_bytes) % 16 == 0;
}

// The kernel instance, its dynamic shared memory and cluster size
// attributes set once per device, so that a launch inside CUDA-graph
// capture makes no call that capture forbids.
template <class C, typename TA, typename TB, bool QUANT, bool RESID>
cudaError_t prepared(void (**kernel)(Args)) {
  *kernel = ffn_gemm<C, TA, TB, QUANT, RESID>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(*kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<C, TA, TB>::BYTES);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// A launch as a cluster of `splits` blocks along x.
template <class C, typename TA, typename TB>
cudaLaunchConfig_t config(dim3 grid, int splits, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = Layout<C, TA, TB>::BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class C, typename TA, typename TB, bool QUANT, bool RESID>
int launch_gemm(const Args& a, int splits, cudaStream_t stream) {
  void (*kernel)(Args) = nullptr;
  cudaError_t e = prepared<C, TA, TB, QUANT, RESID>(&kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ny = (a.N + C::BN - 1) / C::BN;
  const long long nz = (a.M + C::BM - 1) / C::BM;
  if (ny > 65535 || nz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<C, TA, TB>(
      dim3(splits, static_cast<unsigned>(ny), static_cast<unsigned>(nz)),
      splits, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the fp32 instance of tile C resident at once in clusters of
// `splits` (cudaOccupancyMaxActiveClusters times the cluster size).
template <class C>
int slots(int splits) {
  void (*kernel)(Args) = nullptr;
  cudaError_t e = prepared<C, float, float, false, false>(&kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<C, float, float>(dim3(splits), splits, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters * splits : -static_cast<int>(e);
}

// C = A @ B (M, N, K) with the tile the plan names.
template <typename TA, typename TB, bool QUANT, bool RESID>
int phase(const Plan& pl, const void* a, const void* b, const float* scale,
          const float* resid, float* out, int M, int N, int K,
          cudaStream_t stream) {
  if (!plan_ok(pl, K)) return static_cast<int>(cudaErrorInvalidValue);
  Args args{a, b, scale, resid, out, M, N, K, pl.k_chunk,
            vec_ok(a, K, int(sizeof(TA))), vec_ok(b, N, int(sizeof(TB)))};
  if (pl.bm == Small::BM && pl.bn == Small::BN)
    return launch_gemm<Small, TA, TB, QUANT, RESID>(args, pl.splits, stream);
  if (pl.bm == Large::BM && pl.bn == Large::BN)
    return launch_gemm<Large, TA, TB, QUANT, RESID>(args, pl.splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Phase A into the workspace p (skipped at R = 0), then phase B into y,
// with the residual x in its epilogue or (residual == 0) without it.
// Without it, phase B is the instance phase A already has for an fp32
// panel: the switch adds no kernel instance.  A rank of a tensor-parallel
// split (U's columns and V's rows on the 'model' axis) computes a partial
// (P_r @ V_r); only one rank of the split may add x before the sum.
template <typename XQ, typename WT, bool QUANT>
int run(const float* x, const void* xq, const void* u, const void* v,
        const float* u_scale, const float* v_scale, float* y, float* p,
        int m, int d, int r, const Plan& pa, const Plan& pb, int residual,
        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r > 0) {
    const int e = phase<XQ, WT, QUANT, false>(pa, xq, u, u_scale, nullptr, p,
                                             m, r, d, st);
    if (e != 0) return e;
  }
  if (residual)
    return phase<float, WT, QUANT, true>(pb, p, v, v_scale, x, y, m, d, r,
                                         st);
  return phase<float, WT, QUANT, false>(pb, p, v, v_scale, nullptr, y, m, d,
                                        r, st);
}

}  // namespace

// x (M,D), u (D,R), v (R,D), y (M,D), p (M,R) the workspace; all fp32,
// contiguous, on the device of `stream`.  The plan of each phase (A:
// P = x@U, B: y = x + P@V): tile rows and columns (16 x 64 or 128 x 128),
// splits of the reduction (1-16, a cluster) and the k-chunk of a split (a
// multiple of 32); residual 1 adds x (y = x + P@V), 0 leaves it out
// (y = P@V).  Returns the launches' cudaError_t (0 on success), or
// cudaErrorInvalidValue for a plan that does not cover the product.
extern "C" int merged_ffn_f32(const float* x, const float* u, const float* v,
                              float* y, float* p, int m, int d, int r,
                              int bm_a, int bn_a, int splits_a, int kc_a,
                              int bm_b, int bn_b, int splits_b, int kc_b,
                              int residual, void* stream) {
  return run<float, float, false>(x, x, u, v, nullptr, nullptr, y, p, m, d,
                                  r, Plan{bm_a, bn_a, splits_a, kc_a},
                                  Plan{bm_b, bn_b, splits_b, kc_b}, residual,
                                  stream);
}

// The quantized variant: x (M,D) fp32 (the residual); xq (M,D) the panel
// feeding P, fp32 (xq_type 0: x itself) or int8 (1, w8a8); u (D,R) and
// v (R,D) int8 (w_type 1) or fp8-e4m3 (2); u_scale (R) and v_scale (D)
// fp32; the plan and the residual switch as above.  Returns the launches'
// cudaError_t, or cudaErrorInvalidValue for a type pair or plan it does
// not take.
extern "C" int merged_ffn_q(const float* x, const void* xq, const void* u,
                            const void* v, const float* u_scale,
                            const float* v_scale, float* y, float* p, int m,
                            int d, int r, int xq_type, int w_type, int bm_a,
                            int bn_a, int splits_a, int kc_a, int bm_b,
                            int bn_b, int splits_b, int kc_b, int residual,
                            void* stream) {
  const Plan pa{bm_a, bn_a, splits_a, kc_a}, pb{bm_b, bn_b, splits_b, kc_b};
  if (xq_type == 0 && w_type == 1)
    return run<float, int8_t, true>(x, xq, u, v, u_scale, v_scale, y, p, m,
                                    d, r, pa, pb, residual, stream);
  if (xq_type == 1 && w_type == 1)
    return run<int8_t, int8_t, true>(x, xq, u, v, u_scale, v_scale, y, p, m,
                                     d, r, pa, pb, residual, stream);
  if (xq_type == 0 && w_type == 2)
    return run<float, __nv_fp8_e4m3, true>(x, xq, u, v, u_scale, v_scale, y,
                                           p, m, d, r, pa, pb, residual,
                                           stream);
  if (xq_type == 1 && w_type == 2)
    return run<int8_t, __nv_fp8_e4m3, true>(x, xq, u, v, u_scale, v_scale, y,
                                            p, m, d, r, pa, pb, residual,
                                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the bm x bn tile (fp32) resident on this device at once in
// clusters of `splits`, or minus a cudaError_t: what the launch plan's
// cost model assumes (H100_SLOTS in kernels/merged_ffn.py).
extern "C" int merged_ffn_slots(int bm, int bn, int splits) {
  if (splits < 1 || splits > MAX_SPLITS)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bm == Small::BM && bn == Small::BN) return slots<Small>(splits);
  if (bm == Large::BM && bn == Large::BN) return slots<Large>(splits);
  return -static_cast<int>(cudaErrorInvalidValue);
}
