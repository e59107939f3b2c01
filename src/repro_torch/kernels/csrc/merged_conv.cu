// Merged-segment convolution for Hopper (sm_90a), fp32 result.
//
// Replaces the TPU kernel in src/repro/kernels/merged_conv.py (`merged_conv`,
// body `_kernel`, and its `quant=True` body): a VALID NHWC convolution with
// stride s and HWIO weights, summed in fp32 (the quantized body multiplies
// the sum by a per-Cout fp32 scale), then the bias and relu / relu6 / silu.
//
// An implicit GEMM on the tensor cores.  Rows are the M = N*Ho*Wo output
// pixels, columns the Cout output channels, and the reduction runs over
// K = kh*kw*Cin in the order (u, v, c), the row-major order of the HWIO
// weight, which is read as a dense (K, Cout) matrix.  Row m and reduction
// index r of the input operand is x[base(m) + off(r)] with
//   base(m) = ((n*H + ho*s)*W + wo*s)*Cin,   off(r) = (u*W + v)*Cin + c,
// so the strided window is gathered straight from the NHWC input: no
// im2col buffer and no phase-major relayout (the TPU kernel needed that
// relayout for contiguous DMA windows).  Blocks share nothing, so the TPU
// kernel's halo window carried from one grid step to the next has no
// counterpart: every block gathers its own rows.
//
// What bounds it on the H100, and what the design does about it:
// - Bytes at MobileNetV2's batch-8 units (1x1 convs over 14^2-112^2 maps,
//   K 16-576): the activation read once and the output written once, 1-12
//   us a unit at 3.35 TB/s.  Each block keeps a ring of STAGES k-slices of
//   the gathered input tile (A) and the weight slice (B) in flight, filled
//   by cp.async, with one barrier per slice.  Where Cin keeps a 16-byte run
//   of reduction indices inside one (u, v) tap (Cin % 4 == 0 in fp32,
//   Cin % 16 == 0 in int8; 8- and 4-byte copies serve Cin % 8 and % 4) and
//   the pointers are aligned, the copies are 16 bytes; else element by
//   element (the stem's Cin 3).  A thread copies one fixed column chunk of
//   the slice, so the (u, v, c) decomposition runs once per thread and
//   slice; the row bases are computed once per block into shared memory.
//   A 1x1 stride-1 conv is a dense (M, Cin) panel: off(r) = r.
// - Operations at 3x3 and larger merged kernels (ResNet34's units, the
//   probes' merged segments, K into the thousands).  The products use the
//   tensor cores at fp32 accuracy: mma.sync m16n8k8 TF32 with an fp32
//   operand split hi + lo and a·b summed as lo·hi' + hi·lo' + hi·hi'
//   (3xTF32, tf32_mma.cuh), 2 products for fp32 x narrow (int8 and
//   fp8-e4m3 values are exact in TF32), 1 for int8 x e4m3, and for w8a8
//   (int8 x int8) the int8 mma.sync m16n8k32 summed exactly in int32, which
//   the launch plan takes only while K * 128 * 128 < 2^31.
// - Tile shapes by shape: 128 x 16 for MobileNetV2's shallow units (K < 512,
//   memory-bound: the most blocks, and loads, in flight; its Cout 16/24/32
//   units stop multiplying masked zeros), 128 x 32 and 64 x 64 for deeper
//   reductions, and 128 x 128 for wide, deep shapes (K >= 2048), where a
//   warp's 64 x 32 tile reuses each fragment over 16 products; a wider
//   tile only where it still gives every SM two blocks.
// - Too few blocks where M is small and K deep (14x14 and 7x7 maps at
//   batch 8): the reduction is split over the blocks of a thread-block
//   cluster, up to 8.  Each block writes its partial tile to its shared
//   memory; after a cluster barrier each sums a 1/S share of the tile over
//   the S partials through distributed shared memory, always in split
//   order (int32 partials of the int8 mma are summed as int32).  No float
//   atomics: two calls on the same inputs give bitwise the same y.  The
//   epilogue (scale, bias, activation) runs once, after that sum.
//
// The launch plan (tile, copy widths, dense panel, int8 mma, splits,
// k-chunk of a split) is chosen in Python (`launch_plan` in
// kernels/merged_conv.py, whose CPU tests check that every output and
// reduction index is covered once) and passed in; this file checks it and
// derives the grid from it.
#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;                 // k-slice depth
constexpr int MAX_SPLITS = 8;          // portable cluster size
constexpr int S8_MAX_K = 1 << 17;      // K * 2^14 < 2^31: the int32 sum

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
using N16 = Tile<128, 16, 4, 1, 3, 3>;     // shallow: bytes
using N32 = Tile<128, 32, 4, 1, 3, 3>;
using N64 = Tile<64, 64, 2, 2, 4, 3>;
using Wide = Tile<128, 128, 2, 4, 4, 1>;   // wide and deep: operations

// Shared-memory layout of one instance.  Row pitches keep every row
// 16-byte aligned for cp.async and make the fragment loads conflict-free:
// A rows of 40 floats (or 48 bytes), B rows of BN + 4 floats (or BN + 16
// bytes).  After the ring, BM ints hold the block's row bases; after the
// k-loop the ring's memory holds the partial tile of a split.
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
  static constexpr int ROWS = PIPE + C::BM * 4;
  static constexpr int BYTES = ROWS > RED ? ROWS : RED;
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
};

// One conv as a product C[M, N] = A[M, K] @ B[K, N]; split s of a row
// tile's cluster sums k in [s * k_chunk, (s + 1) * k_chunk).
struct Conv {
  const void* x;        // (N, H, W, Cin)
  const void* w;        // (K, N) = (kh, kw, Cin, Cout)
  const float* scale;   // (N) per output channel (QUANT), else unused
  const float* bias;    // (N) or null
  float* y;             // (M, N) = (N, Ho, Wo, Cout)
  int H, W, Cin, KW, stride, Ho, Wo;
  int M, N, K, k_chunk, splits, act;
  int a_vec, b_vec;     // bytes a copy: 16, 8, 4, or 1 (a plain load)
  int dense;            // 1x1 stride 1: off(r) = r
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                       // relu
    case 2: return fminf(fmaxf(v, 0.f), 6.f);           // relu6
    case 3: return v / (1.f + expf(-v));                // silu
    default: return v;
  }
}

// V bytes from global into shared memory, zero where !ok (V = 4, 8, 16).
template <int V>
__device__ __forceinline__ void copy(void* dst, const void* src, bool ok) {
  if constexpr (V == 16) {
    cp_async16(dst, src, ok);
  } else if constexpr (V == 8) {
    cp_async8(dst, src, ok);
  } else {
    static_assert(V == 4, "cp.async copies 4, 8 or 16 bytes");
    cp_async4(dst, src, ok);
  }
}

// One byte, zero where !ok: a plain load (cp.async copies at least 4).
__device__ __forceinline__ uint8_t load_byte(const void* src, bool ok) {
  return ok ? __ldg(static_cast<const unsigned char*>(src)) : uint8_t(0);
}

// The input slice [k0, k0 + BK) of the block's BM rows into A (pitch LD).
// A thread copies one column chunk of the slice, at rows tid / CPR + i *
// STEP: one (u, v, c) decomposition a slice.  Rows whose base is < 0 lie
// past M; indices >= k_end are past the split's chunk.  Both are zeros.
template <typename S, int BM, int LD, int THREADS, int V>
__device__ __forceinline__ void gather_a(S* dst, const S* x, const int* rows,
                                         const Conv& p, int k0, int k_end,
                                         int tid) {
  constexpr int VE = V / int(sizeof(S));   // elements a copy
  constexpr int CPR = BK / VE;             // copies a row
  constexpr int STEP = THREADS / CPR;
  static_assert(VE >= 1 && THREADS % CPR == 0, "whole copies a row");
  const int kc = (tid % CPR) * VE;
  const int k = k0 + kc;
  const bool k_ok = k < k_end;
  int off = k;
  if (k_ok && !p.dense) {
    const int kwc = p.KW * p.Cin;
    const int u = k / kwc;
    const int rem = k - u * kwc;
    const int v = rem / p.Cin;
    off = (u * p.W + v) * p.Cin + (rem - v * p.Cin);
  }
  constexpr int N = (BM + STEP - 1) / STEP;
  if constexpr (V == 1) {
    // Every byte's load before any store, so that none waits on the
    // store before it.
    uint8_t b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = tid / CPR + i * STEP;
      const int base = BM % STEP == 0 || r < BM ? rows[r] : -1;
      b[i] = load_byte(x + base + off, k_ok && base >= 0);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = tid / CPR + i * STEP;
      if (BM % STEP == 0 || r < BM)
        reinterpret_cast<uint8_t*>(dst)[r * LD + kc] = b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = tid / CPR + i * STEP;
      if (BM % STEP == 0 || r < BM) {
        const int base = rows[r];
        const bool ok = k_ok && base >= 0;
        copy<V>(dst + r * LD + kc, ok ? x + base + off : x, ok);
      }
    }
  }
}

// The weight slice: rows [k0, k0 + BK) of the (K, N) matrix, columns
// [n0, n0 + COLS), into B (pitch LD); rows >= k_end and columns >= N are
// zeros.
template <typename S, int COLS, int LD, int THREADS, int V>
__device__ __forceinline__ void load_b(S* dst, const S* w, const Conv& p,
                                       int k0, int k_end, int n0, int tid) {
  constexpr int VE = V / int(sizeof(S));
  constexpr int CPR = COLS / VE;
  constexpr int CHUNKS = BK * CPR;
  constexpr int N = (CHUNKS + THREADS - 1) / THREADS;
  static_assert(VE >= 1 && COLS % VE == 0, "whole copies a row");
  if constexpr (V == 1) {
    uint8_t b[N];   // every byte's load before any store, as in gather_a
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = tid + i * THREADS;
      const int gr = k0 + c / CPR, gc = n0 + c % CPR;
      const bool ok = (CHUNKS % THREADS == 0 || c < CHUNKS) && gr < k_end &&
                      gc < p.N;
      b[i] = load_byte(w + (size_t)gr * p.N + gc, ok);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = tid + i * THREADS;
      if (CHUNKS % THREADS == 0 || c < CHUNKS)
        reinterpret_cast<uint8_t*>(dst)[(c / CPR) * LD + c % CPR] = b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = tid + i * THREADS;
      if (CHUNKS % THREADS == 0 || c < CHUNKS) {
        const int r = c / CPR, cc = (c % CPR) * VE;
        const int gr = k0 + r, gc = n0 + cc;
        const bool ok = gr < k_end && gc < p.N;
        copy<V>(dst + r * LD + cc, ok ? w + (size_t)gr * p.N + gc : w, ok);
      }
    }
  }
}

// Scale (QUANT), bias and activation of the sums of row `row`, columns
// col and col + 1, and their masked store.
template <bool QUANT>
__device__ __forceinline__ void store2(const Conv& p, int row, int col,
                                       float v0, float v1) {
  if (row >= p.M) return;
  float v[2] = {v0, v1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = col + j;
    if (c < p.N) {
      if constexpr (QUANT) v[j] *= __ldg(p.scale + c);
      v[j] += p.bias != nullptr ? __ldg(p.bias + c) : 0.f;
      v[j] = activate(v[j], p.act);
    }
  }
  float* out = p.y + (size_t)row * p.N + col;
  if (col + 1 < p.N && (p.N & 1) == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
    if (col < p.N) out[0] = v[0];
    if (col + 1 < p.N) out[1] = v[1];
  }
}

// XT / WT: element types of x and w; QUANT: multiply the sum by
// scale[col]; S8: the int8 mma (XT = WT = int8_t), else TF32.
template <class C, typename XT, typename WT, bool QUANT, bool S8>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
conv_gemm(const Conv p) {
  using L = Layout<C, XT, WT>;
  using SA = typename L::SA;
  using SB = typename L::SB;
  using Acc = std::conditional_t<S8, int, float>;
  constexpr bool WA = Elem<XT>::wide, WB = Elem<WT>::wide;
  static_assert(!S8 || (std::is_same_v<XT, int8_t> &&
                        std::is_same_v<WT, int8_t>), "the int8 mma");
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem + L::PIPE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
  const int part = blockIdx.x % p.splits;   // this block's split
  const int m0 = (blockIdx.x / p.splits) * C::BM, n0 = blockIdx.y * C::BN;
  const int k_begin = part * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int n_slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const SA* X = static_cast<const SA*>(p.x);
  const SB* Wt = static_cast<const SB*>(p.w);

  // The rows' input bases, once per block (-1 past M).
  for (int r = tid; r < C::BM; r += C::THREADS) {
    const int m = m0 + r;
    int base = -1;
    if (m < p.M) {
      const int hw = p.Ho * p.Wo;
      const int img = m / hw;
      const int rem = m - img * hw;
      const int ho = rem / p.Wo;
      const int wo = rem - ho * p.Wo;
      base = ((img * p.H + ho * p.stride) * p.W + wo * p.stride) * p.Cin;
    }
    rows[r] = base;
  }
  __syncthreads();

  auto a_tile = [&](int s) {
    return reinterpret_cast<SA*>(smem + s * L::STAGE);
  };
  auto b_tile = [&](int s) {
    return reinterpret_cast<SB*>(smem + s * L::STAGE + L::A_BYTES);
  };
  // One slice into stage s, at the plan's copy widths (uniform branches).
  auto load = [&](int s, int k0) {
    SA* a = a_tile(s);
    SB* b = b_tile(s);
    if (p.a_vec == 16) {
      gather_a<SA, C::BM, L::A_LD, C::THREADS, 16>(a, X, rows, p, k0, k_end,
                                                   tid);
    } else if constexpr (sizeof(SA) == 1) {
      if (p.a_vec == 8)
        gather_a<SA, C::BM, L::A_LD, C::THREADS, 8>(a, X, rows, p, k0, k_end,
                                                    tid);
      else if (p.a_vec == 4)
        gather_a<SA, C::BM, L::A_LD, C::THREADS, 4>(a, X, rows, p, k0, k_end,
                                                    tid);
      else
        gather_a<SA, C::BM, L::A_LD, C::THREADS, 1>(a, X, rows, p, k0, k_end,
                                                    tid);
    } else {
      gather_a<SA, C::BM, L::A_LD, C::THREADS, 4>(a, X, rows, p, k0, k_end,
                                                  tid);
    }
    if (p.b_vec == 16) {
      load_b<SB, C::BN, L::B_LD, C::THREADS, 16>(b, Wt, p, k0, k_end, n0,
                                                 tid);
    } else if constexpr (sizeof(SB) == 1) {
      if (p.b_vec == 8)
        load_b<SB, C::BN, L::B_LD, C::THREADS, 8>(b, Wt, p, k0, k_end, n0,
                                                  tid);
      else if (p.b_vec == 4)
        load_b<SB, C::BN, L::B_LD, C::THREADS, 4>(b, Wt, p, k0, k_end, n0,
                                                  tid);
      else
        load_b<SB, C::BN, L::B_LD, C::THREADS, 1>(b, Wt, p, k0, k_end, n0,
                                                  tid);
    } else {
      load_b<SB, C::BN, L::B_LD, C::THREADS, 4>(b, Wt, p, k0, k_end, n0,
                                                tid);
    }
  };

  Acc acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);

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
    if constexpr (S8) {
      // One k32 product a slice: A as 4-byte runs of a row, B packed from
      // 4 rows of a column.
      const uint8_t* Ab = reinterpret_cast<const uint8_t*>(As);
      const uint8_t* Bb = reinterpret_cast<const uint8_t*>(Bs);
      uint32_t a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const uint8_t* r = Ab + (wm0 + mt * 16 + g) * L::A_LD + 4 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8 * L::A_LD);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r + 8 * L::A_LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* c =
              Bb + (16 * h + 4 * t) * L::B_LD + wn0 + nt * 8 + g;
          b[nt][h] = uint32_t(c[0]) | (uint32_t(c[L::B_LD]) << 8) |
                     (uint32_t(c[2 * L::B_LD]) << 16) |
                     (uint32_t(c[3 * L::B_LD]) << 24);
        }
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[C::MT][4], al[C::MT][4], bh[C::NT][2], bl[C::NT][2];
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          // The mma's k index t of a lane reads k-slice column kk + 2t,
          // its k index t + 4 column kk + 2t + 1 (B below likewise), so
          // that a lane reads its two A columns as one pair.
          const SA* r = As + (wm0 + mt * 16 + g) * L::A_LD + kk + 2 * t;
          float f[4];
          if constexpr (WA) {
            const float2 lo8 = *reinterpret_cast<const float2*>(r);
            const float2 hi8 =
                *reinterpret_cast<const float2*>(r + 8 * L::A_LD);
            f[0] = lo8.x, f[2] = lo8.y, f[1] = hi8.x, f[3] = hi8.y;
          } else {
            f[0] = Elem<XT>::f32(r[0]), f[2] = Elem<XT>::f32(r[1]);
            f[1] = Elem<XT>::f32(r[8 * L::A_LD]);
            f[3] = Elem<XT>::f32(r[8 * L::A_LD + 1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) split<WA>(f[j], ah[mt][j], al[mt][j]);
        }
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const SB* c = Bs + (kk + 2 * t) * L::B_LD + wn0 + nt * 8 + g;
          split<WB>(Elem<WT>::f32(c[0]), bh[nt][0], bl[nt][0]);
          split<WB>(Elem<WT>::f32(c[L::B_LD]), bh[nt][1], bl[nt][1]);
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
          for (int nt = 0; nt < C::NT; ++nt)
            mma(acc[mt][nt], ah[mt], bh[nt]);
      }
    }
  }
  cp_async_wait<0>();

  if (p.splits == 1) {   // no split: the epilogue straight from registers
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int r = m0 + wm0 + mt * 16 + g;
        const int c = n0 + wn0 + nt * 8 + 2 * t;
        store2<QUANT>(p, r, c, float(acc[mt][nt][0]), float(acc[mt][nt][1]));
        store2<QUANT>(p, r + 8, c, float(acc[mt][nt][2]),
                      float(acc[mt][nt][3]));
      }
    return;
  }

  // Split reduction through the cluster (consecutive blocks along x).
  __syncthreads();   // the ring's memory becomes the partial tile
  Acc* Cs = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int r = wm0 + mt * 16 + g, c = wn0 + nt * 8 + 2 * t;
      Cs[r * L::C_LD + c] = acc[mt][nt][0];
      Cs[r * L::C_LD + c + 1] = acc[mt][nt][1];
      Cs[(r + 8) * L::C_LD + c] = acc[mt][nt][2];
      Cs[(r + 8) * L::C_LD + c + 1] = acc[mt][nt][3];
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its block's memory
  const int S = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int V2 = C::BM * C::BN / 2;
  const int share = (V2 + S - 1) / S;
  const int lo = q * share, hi = min(V2, lo + share);
  for (int i = lo + tid; i < hi; i += C::THREADS) {
    const int r = i / (C::BN / 2), c = (i % (C::BN / 2)) * 2;
    Acc* own = Cs + r * L::C_LD + c;
    Acc s0 = Acc(0), s1 = Acc(0);
    for (int s = 0; s < S; ++s) {   // split order: deterministic
      const Acc* v = cluster.map_shared_rank(own, s);
      s0 += v[0];
      s1 += v[1];
    }
    store2<QUANT>(p, m0 + r, n0 + c, float(s0), float(s1));
  }
  cluster.sync();   // no block leaves while another may read its partial
}

// The plan as the wrapper computed it.
struct Plan {
  int bm, bn, splits, k_chunk, a_vec, b_vec, dense, s8;
};

// The splits cover [0, K) once, in whole k-slices.
bool plan_covers(const Plan& pl, int K) {
  if (pl.splits < 1 || pl.splits > MAX_SPLITS) return false;
  if (K == 0) return pl.splits == 1;
  if (pl.k_chunk <= 0 || pl.k_chunk % BK) return false;
  return (long long)(pl.splits - 1) * pl.k_chunk < K &&
         (long long)pl.splits * pl.k_chunk >= K;
}

// A copy width of `vec` bytes over rows of `len` elements of `elem`
// bytes at `ptr`: one element, or a 4-, 8- or 16-byte run that divides a
// row (narrow types; fp32 takes 4 and 16) at an aligned pointer.
bool width_ok(int vec, const void* ptr, long long len, int elem) {
  if (vec == elem) return true;
  if (vec != 4 && vec != 8 && vec != 16) return false;
  if (vec < elem || (elem == 4 && vec == 8)) return false;
  return reinterpret_cast<uintptr_t>(ptr) % vec == 0 &&
         (len * elem) % vec == 0;
}

// The kernel instance, its dynamic shared memory and cluster attributes
// set once per device, so that a launch inside CUDA-graph capture makes no
// call that capture forbids.
template <class C, typename XT, typename WT, bool QUANT, bool S8>
cudaError_t prepared(void (**kernel)(Conv)) {
  *kernel = conv_gemm<C, XT, WT, QUANT, S8>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(*kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<C, XT, WT>::BYTES);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <class C, typename XT, typename WT, bool QUANT, bool S8>
int launch_conv(const Conv& a, cudaStream_t stream) {
  void (*kernel)(Conv) = nullptr;
  cudaError_t e = prepared<C, XT, WT, QUANT, S8>(&kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long gx = (long long)a.splits * ((a.M + C::BM - 1) / C::BM);
  const long long gy = (a.N + C::BN - 1) / C::BN;
  if (gx > 0x7FFFFFFFLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (a.splits == 1) {   // no cluster: a plain launch
    kernel<<<grid, C::THREADS, Layout<C, XT, WT>::BYTES, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = Layout<C, XT, WT>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Checks the plan against the shape and the operands, then launches the
// tile it names.
template <typename XT, typename WT, bool QUANT, bool S8>
int run(const Plan& pl, const void* x, const void* w, const float* scale,
        const float* bias, float* y, int n, int h, int wd, int cin, int kh,
        int kw, int cout, int stride, int ho, int wo, int act,
        void* stream) {
  const long long m = (long long)n * ho * wo;
  const long long k = (long long)kh * kw * cin;
  if (m > 0x7FFFFFFFLL || k > 0x7FFFFFFFLL || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = static_cast<int>(k);
  if (!plan_covers(pl, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (S8 != (pl.s8 != 0) || (S8 && K >= S8_MAX_K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.dense && (kh != 1 || kw != 1 || stride != 1 || ho != h || wo != wd))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!width_ok(pl.a_vec, x, cin, int(sizeof(typename Elem<XT>::storage))) ||
      !width_ok(pl.b_vec, w, cout, int(sizeof(typename Elem<WT>::storage))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv a{x, w, scale, bias, y, h, wd, cin, kw, stride, ho, wo,
               static_cast<int>(m), cout, K, pl.k_chunk, pl.splits, act,
               pl.a_vec, pl.b_vec, pl.dense};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.bm == N16::BM && pl.bn == N16::BN)
    return launch_conv<N16, XT, WT, QUANT, S8>(a, st);
  if (pl.bm == N32::BM && pl.bn == N32::BN)
    return launch_conv<N32, XT, WT, QUANT, S8>(a, st);
  if (pl.bm == N64::BM && pl.bn == N64::BN)
    return launch_conv<N64, XT, WT, QUANT, S8>(a, st);
  if (pl.bm == Wide::BM && pl.bn == Wide::BN)
    return launch_conv<Wide, XT, WT, QUANT, S8>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (N,H,W,Cin), w (kh,kw,Cin,Cout), bias (Cout) or NULL, y (N,Ho,Wo,Cout);
// all fp32, contiguous, on the device of `stream`.  act: 0 none, 1 relu,
// 2 relu6, 3 silu.  The plan: tile rows and columns (128 x 16, 128 x 32,
// 64 x 64 or 128 x 128), splits of the reduction (1-8, a cluster) and the
// k-chunk of a split (a multiple of 32), the input's and the weight's copy
// widths in bytes (16 or 4), dense (a 1x1 stride-1 panel) and s8 (0 here).
// Returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int merged_conv_f32(const float* x, const float* w,
                               const float* bias, float* y, int n, int h,
                               int wd, int cin, int kh, int kw, int cout,
                               int stride, int ho, int wo, int act, int bm,
                               int bn, int splits, int k_chunk, int a_vec,
                               int b_vec, int dense, int s8, void* stream) {
  const Plan pl{bm, bn, splits, k_chunk, a_vec, b_vec, dense, s8};
  return run<float, float, false, false>(pl, x, w, nullptr, bias, y, n, h,
                                         wd, cin, kh, kw, cout, stride, ho,
                                         wo, act, stream);
}

// The quantized variant: x fp32 (x_type 0) or int8 (1); w int8 (w_type 1)
// or fp8-e4m3 (2); scale (Cout) fp32, applied to the sum before the bias.
// The plan as above, with copy widths of 16, 8, 4 or 1 byte for narrow
// operands and s8 = 1 for the int8 mma (int8 x int8 while
// kh*kw*Cin < 2^17).  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for a type pair or plan it does not take.
extern "C" int merged_conv_q(const void* x, const void* w, const float* scale,
                             const float* bias, float* y, int n, int h,
                             int wd, int cin, int kh, int kw, int cout,
                             int stride, int ho, int wo, int act, int x_type,
                             int w_type, int bm, int bn, int splits,
                             int k_chunk, int a_vec, int b_vec, int dense,
                             int s8, void* stream) {
  const Plan pl{bm, bn, splits, k_chunk, a_vec, b_vec, dense, s8};
#define MERGED_CONV_Q(XT, WT, S8)                                           \
  run<XT, WT, true, S8>(pl, x, w, scale, bias, y, n, h, wd, cin, kh, kw,    \
                        cout, stride, ho, wo, act, stream)
  if (x_type == 0 && w_type == 1) return MERGED_CONV_Q(float, int8_t, false);
  if (x_type == 1 && w_type == 1)
    return s8 ? MERGED_CONV_Q(int8_t, int8_t, true)
              : MERGED_CONV_Q(int8_t, int8_t, false);
  if (x_type == 0 && w_type == 2)
    return MERGED_CONV_Q(float, __nv_fp8_e4m3, false);
  if (x_type == 1 && w_type == 2)
    return MERGED_CONV_Q(int8_t, __nv_fp8_e4m3, false);
#undef MERGED_CONV_Q
  return static_cast<int>(cudaErrorInvalidValue);
}
