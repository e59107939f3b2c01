// Flash attention (forward) for Hopper (sm_90a), the fp32 body:
//   o = softmax(q k^T / sqrt(D) [+ causal mask]) v
// over q (B, S, H, D), k and v (B, S, KVH, D) with H % KVH == 0 (query head
// h reads kv head h / (H / KVH): GQA and MQA without expanding k and v),
// o (B, S, H, D).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`): grid (batch*heads, q tiles, kv
// tiles), kv innermost, with the running max m, normalizer l and output
// accumulator acc in VMEM scratch across the sequential kv sweep.  CUDA
// blocks run in no order, so the kv sweep is a loop inside one block, with
// m, l and acc in registers.  Kept from the TPU kernel: online softmax in
// fp32, -1e30 for masked scores, kv tiles past the diagonal never loaded,
// the epilogue's division by max(l, 1e-30).
//
// What bounds it on the H100, and what the design does about it:
// - Operations at the probes (RecurrentGemma: 676 MFLOP against 23 MB at
//   S 128, D 256).  Both products run on the tensor cores as mma.sync
//   m16n8k8 TF32 at fp32 accuracy (3xTF32 hi/lo splits, tf32_mma.cuh):
//   495/3 TFLOP/s against the 67 of fp32 FFMA.  q is split into hi and lo
//   once per block and kept in registers; each k and v element is split as
//   its fragment is built.  The k index of the mma is permuted (k index t
//   of a lane reads key or column 2t, index t + 4 reads 2t + 1), so the
//   scores' accumulator fragment is, element for element, the A fragment
//   of p·v: p never leaves registers.  Timed on the H100 (PERF.md), the
//   arithmetic is not what bounds it: without the products the probe runs
//   within 5 % of its time, without the splits, the exact exp and the
//   score exchange within 15 %.  The waits are (the K/V copies, two
//   barriers a tile, q's loads and o's stores), at one block of 8 warps an
//   SM (210-234 registers a thread): later work.
// - Bytes and latency at prefill (S 16: 2.6 MB).  K and V tiles stream
//   through a ring of STAGES tiles in dynamic shared memory filled by
//   cp.async (16-byte copies where rows are 16-byte aligned, else 4-byte
//   ones; zero-filled past S and D, so nothing is padded in device
//   memory): the next tiles' copies overlap the current tile's products.
// - Grid fill and K/V reuse.  A block's query rows are the (s, head) pairs
//   of one (batch, kv head) in s-major order: the H/KVH query heads that
//   share a kv head sit in the same m-tiles, so every K/V tile is loaded
//   once for the whole group, and the rows of a block sit at nearly the
//   same s, so the causal mask wastes little of the diagonal tile.  Blocks
//   of WR row groups of 16 rows; at D > 64 the WD = D/64 warps of a row
//   group split the q·k^T depth (each holds 64 columns of q in registers)
//   and sum their partial scores through shared memory in a fixed order,
//   then split the output columns of p·v.  Where even one row group per
//   block leaves SMs idle (S 16) at D 256, DSPLIT = 2 blocks share a row
//   tile, each computing the scores and half of the output columns.  The
//   launch plan (WR, DSPLIT) comes from `launch_plan` in
//   kernels/flash_attention.py, where the CPU tests check that it covers
//   every output once.  The row tiles with the most kv tiles (largest s)
//   are scheduled first.
// - Deterministic: no atomics, every sum in a fixed order, so two calls on
//   the same inputs give bitwise the same o.
//
// The bf16 body is a kernel of its own (flash_attention_bf16.cu).
//
// Shared memory: STAGES x (BKV rows of K at pitch DP + 8 floats and of the
// block's V columns at pitch DV + 4: conflict-free fragment loads), plus
// the partial-score exchange.  At D 256, WR 2: 108,800 bytes.  Set once per
// device, outside graph capture.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int STAGES = 3;   // K/V tiles in flight

// DP: head dim rounded up (32, 64, 128 or 256); WR row groups of 16 query
// rows per block; DSPLIT blocks share a row tile, each DP / DSPLIT output
// columns.
template <int DP_, int WR_, int DSPLIT_>
struct Cfg {
  static constexpr int DP = DP_, WR = WR_, DSPLIT = DSPLIT_;
  static constexpr int WD = DP >= 128 ? DP / 64 : 1;   // warps splitting D
  static constexpr int WARPS = WR * WD, THREADS = WARPS * 32;
  static constexpr int BM = 16 * WR;                    // query rows a block
  static constexpr int BKV = DP >= 128 ? 16 : 32;       // keys a kv tile
  static constexpr int DQ = DP / WD;                    // q·k depth a warp
  static constexpr int DV = DP / DSPLIT;                // out columns a block
  static constexpr int DO = DV / WD;                    // out columns a warp
  static constexpr int KS = DQ / 8, NT = BKV / 8, NO = DO / 8;
  static constexpr int LDK = DP + 8, LDV = DV + 4;      // pitches (floats)
  static constexpr int STAGE = BKV * (LDK + LDV);       // floats a stage
  static constexpr int XS = WD > 1 ? WARPS * NT * 32 * 4 : 0;
  static constexpr int BYTES = (STAGES * STAGE + XS) * 4;
  static_assert(DQ % 8 == 0 && DO % 8 == 0, "whole mma tiles per warp");
  static_assert(DV % 16 == 0, "V pitch = 4 mod 16: conflict-free loads");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int S, H, KVH, D;
  float scale;
  int causal;
  int vec;   // 1: K and V rows 16-byte aligned, copied in 16-byte chunks
};

template <class C>
__global__ void __launch_bounds__(C::THREADS) attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / C::WD, wc = warp % C::WD;
  const int G = p.H / p.KVH;
  const int rows = p.S * G;            // query rows of one (batch, kv head)
  const int b = blockIdx.y / p.KVH, hk = blockIdx.y % p.KVH;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::BM;   // largest s first
  const int col0 = blockIdx.z * C::DV;
  // Offsets fit in int: the wrapper refuses tensors above 2^31 - 1 elements.
  const int q_row = p.H * p.D, kv_row = p.KVH * p.D;
  const float* kb = p.k + b * p.S * kv_row + hk * p.D;
  const float* vb = p.v + b * p.S * kv_row + hk * p.D;
  const int qb = b * p.S * q_row + hk * G * p.D;   // row (s, j): + s*q_row + j*D

  // The lane's two rows (g and g + 8 of the warp's m-tile): their s, and
  // their offset in q and o (-1 past the last row).
  const int ra = r0 + wr * 16 + g, rb = ra + 8;
  const int sa = ra / G, sb = rb / G;
  const int oa = ra < rows ? qb + sa * q_row + (ra - sa * G) * p.D : -1;
  const int ob = rb < rows ? qb + sb * q_row + (rb - sb * G) * p.D : -1;

  const int last_row = min(r0 + C::BM, rows) - 1;
  const int last_key = p.causal ? last_row / G : p.S - 1;
  const int n_tiles = last_key / C::BKV + 1;

  auto load = [&](int stage, int tile) {
    float* Ks = smem + stage * C::STAGE;
    float* Vs = Ks + C::BKV * C::LDK;
    const int key0 = tile * C::BKV;
    if (p.vec) {
      constexpr int KC = C::BKV * C::DP / 4, VC = C::BKV * C::DV / 4;
#pragma unroll
      for (int i = 0; i < (KC + C::THREADS - 1) / C::THREADS; ++i) {
        const int c = tid + i * C::THREADS;
        if (KC % C::THREADS == 0 || c < KC) {
          const int r = c / (C::DP / 4), cc = (c % (C::DP / 4)) * 4;
          const bool ok = key0 + r < p.S && cc < p.D;
          cp_async16(Ks + r * C::LDK + cc,
                     ok ? kb + (key0 + r) * kv_row + cc : kb, ok);
        }
      }
#pragma unroll
      for (int i = 0; i < (VC + C::THREADS - 1) / C::THREADS; ++i) {
        const int c = tid + i * C::THREADS;
        if (VC % C::THREADS == 0 || c < VC) {
          const int r = c / (C::DV / 4), cc = (c % (C::DV / 4)) * 4;
          const bool ok = key0 + r < p.S && col0 + cc < p.D;
          cp_async16(Vs + r * C::LDV + cc,
                     ok ? vb + (key0 + r) * kv_row + col0 + cc : vb, ok);
        }
      }
    } else {
      for (int c = tid; c < C::BKV * C::DP; c += C::THREADS) {
        const int r = c / C::DP, cc = c % C::DP;
        const bool ok = key0 + r < p.S && cc < p.D;
        cp_async4(Ks + r * C::LDK + cc,
                  ok ? kb + (key0 + r) * kv_row + cc : kb, ok);
      }
      for (int c = tid; c < C::BKV * C::DV; c += C::THREADS) {
        const int r = c / C::DV, cc = c % C::DV;
        const bool ok = key0 + r < p.S && col0 + cc < p.D;
        cp_async4(Vs + r * C::LDV + cc,
                  ok ? vb + (key0 + r) * kv_row + col0 + cc : vb, ok);
      }
    }
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[C::NO][4];
#pragma unroll
  for (int i = 0; i < C::NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // The first K/V tiles in flight before q is read, so that the two
  // overlap.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  // q split once: A fragments of the warp's DQ columns.
  uint32_t qh[C::KS][4], ql[C::KS][4];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wc * C::DQ + ks * 8 + 2 * t + (j >> 1);
      const int off = (j & 1) ? ob : oa;
      const float f = (off >= 0 && col < p.D) ? __ldg(p.q + off + col) : 0.f;
      split<true>(f, qh[ks][j], ql[ks][j]);
    }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();   // tile it has landed
    // ... and every warp is done with tile it - 1 (whose buffer is next)
    // and with the previous partial scores
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < n_tiles) load(nxt % STAGES, nxt);
    cp_async_commit();
    const float* Ks = smem + (it % STAGES) * C::STAGE;
    const float* Vs = Ks + C::BKV * C::LDK;

    // Scores of the warp's 16 rows against the tile's BKV keys over its
    // DQ columns of q: B[k][n] = K[key n][column k].
    // The small terms and hi·hi in two accumulators (two dependent chains
    // of mma per n-tile instead of one), added at the end.
    float sc[C::NT][4], sl[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = sl[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t bh[C::NT][2], bl[C::NT][2];
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float2 kk = *reinterpret_cast<const float2*>(
            Ks + (nt * 8 + g) * C::LDK + wc * C::DQ + ks * 8 + 2 * t);
        split<true>(kk.x, bh[nt][0], bl[nt][0]);
        split<true>(kk.y, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) mma(sl[nt], ql[ks], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) mma(sl[nt], qh[ks], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) mma(sc[nt], qh[ks], bh[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] += sl[nt][e];
    if constexpr (C::WD > 1) {
      // The row group's WD partial sums, added in column-slice order by
      // each of its warps alike.
      float4* X = reinterpret_cast<float4*>(smem + STAGES * C::STAGE);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        X[(warp * C::NT + nt) * 32 + lane] =
            make_float4(sc[nt][0], sc[nt][1], sc[nt][2], sc[nt][3]);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wr), "n"(C::WD * 32));
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        float4 s4 = X[((wr * C::WD) * C::NT + nt) * 32 + lane];
#pragma unroll
        for (int c = 1; c < C::WD; ++c) {
          const float4 x = X[((wr * C::WD + c) * C::NT + nt) * 32 + lane];
          s4.x += x.x;
          s4.y += x.y;
          s4.z += x.z;
          s4.w += x.w;
        }
        sc[nt][0] = s4.x, sc[nt][1] = s4.y, sc[nt][2] = s4.z,
        sc[nt][3] = s4.w;
      }
    }

    // Online softmax.  Accumulator element e of an n-tile: row g (e < 2)
    // or g + 8, key 2t + (e & 1) of the tile's 8; a row's values are
    // spread over the 4 lanes of a quad.
    const int key0 = it * C::BKV;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e] * p.scale;
        if (key >= p.S || (p.causal && key > (e < 2 ? sa : sb))) x = NEG;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      rs[h] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(sc[nt][e] - m[e >> 1]);
        sc[nt][e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int no = 0; no < C::NO; ++no) {
      acc[no][0] *= corr[0];
      acc[no][1] *= corr[0];
      acc[no][2] *= corr[1];
      acc[no][3] *= corr[1];
    }

    // acc += p @ V[:, the warp's DO columns]: the scores' fragment of
    // n-tile ks is the A fragment of k-step ks (a0 = c0, a1 = c2,
    // a2 = c1, a3 = c3 under the permuted k index).
#pragma unroll
    for (int ks = 0; ks < C::NT; ++ks) {
      uint32_t ah[4], al[4];
      split<true>(sc[ks][0], ah[0], al[0]);
      split<true>(sc[ks][2], ah[1], al[1]);
      split<true>(sc[ks][1], ah[2], al[2]);
      split<true>(sc[ks][3], ah[3], al[3]);
      uint32_t bh[C::NO][2], bl[C::NO][2];
#pragma unroll
      for (int no = 0; no < C::NO; ++no) {
        const float* vp =
            Vs + (ks * 8 + 2 * t) * C::LDV + wc * C::DO + no * 8 + g;
        split<true>(vp[0], bh[no][0], bl[no][0]);
        split<true>(vp[C::LDV], bh[no][1], bl[no][1]);
      }
#pragma unroll
      for (int no = 0; no < C::NO; ++no) mma(acc[no], al, bh[no]);
#pragma unroll
      for (int no = 0; no < C::NO; ++no) mma(acc[no], ah, bl[no]);
#pragma unroll
      for (int no = 0; no < C::NO; ++no) mma(acc[no], ah, bh[no]);
    }
  }
  cp_async_wait<0>();

  const float den_a = fmaxf(l[0], 1e-30f), den_b = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int no = 0; no < C::NO; ++no) {
    const int col = col0 + wc * C::DO + no * 8 + 2 * t;
    if (oa >= 0) {
      if (col < p.D) p.o[oa + col] = acc[no][0] / den_a;
      if (col + 1 < p.D) p.o[oa + col + 1] = acc[no][1] / den_a;
    }
    if (ob >= 0) {
      if (col < p.D) p.o[ob + col] = acc[no][2] / den_b;
      if (col + 1 < p.D) p.o[ob + col + 1] = acc[no][3] / den_b;
    }
  }
}

template <class C>
int launch(const Params& p, int b, cudaStream_t stream) {
  // The dynamic shared memory attribute once per device, so that a launch
  // inside CUDA-graph capture makes no call that capture forbids.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(attention_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  const int rows = p.S * (p.H / p.KVH);
  const dim3 grid((rows + C::BM - 1) / C::BM, b * p.KVH, C::DSPLIT);
  attention_kernel<C><<<grid, C::THREADS, C::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance of head-dim tile DP that the plan (wr, dsplit) names.
template <int DP>
int dispatch(const Params& p, int b, int wr, int dsplit,
             cudaStream_t stream) {
  if (dsplit == 1) {
    if (wr == 1) return launch<Cfg<DP, 1, 1>>(p, b, stream);
    if (wr == 2) return launch<Cfg<DP, 2, 1>>(p, b, stream);
    if constexpr (DP < 256) {
      if (wr == 4) return launch<Cfg<DP, 4, 1>>(p, b, stream);
    }
  } else if (dsplit == 2 && wr == 1) {
    return launch<Cfg<DP, 1, 2>>(p, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,S,H,D), k and v (B,S,KVH,D), o (B,S,H,D); fp32, contiguous, on the
// device of `stream`; H % KVH == 0, 1 <= D <= 256, B * KVH <= 65535.  The
// plan: wr row groups of 16 query rows per block (1, 2, or 4 below D 129)
// and dsplit blocks per row tile (1, or 2 with wr 1).  Returns the
// launch's cudaError_t (0 on success), or cudaErrorInvalidValue for a
// shape or plan it does not take.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int b, int s,
                                   int h, int kvh, int d, int causal, int wr,
                                   int dsplit, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      b * kvh > 65535 || d <= 0 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const Params p{q, k, v, o, s, h, kvh, d,
                 1.0f / std::sqrt(static_cast<float>(d)), causal,
                 (d % 4 == 0 && aligned) ? 1 : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return dispatch<32>(p, b, wr, dsplit, st);
  if (d <= 64) return dispatch<64>(p, b, wr, dsplit, st);
  if (d <= 128) return dispatch<128>(p, b, wr, dsplit, st);
  return dispatch<256>(p, b, wr, dsplit, st);
}
