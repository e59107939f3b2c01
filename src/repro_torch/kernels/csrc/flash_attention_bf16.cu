// Flash attention (forward), the bf16 body, for Hopper (sm_90a):
//   o = softmax(q k^T / sqrt(D) [+ causal mask]) v
// over q (B, S, H, D), k and v (B, S, KVH, D), o (B, S, H, D), all bf16,
// with H % KVH == 0 (query head h reads kv head h / (H / KVH)).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`) at bf16, and computes its function:
// fp32 scores, online softmax in fp32, masked scores of weight exactly 0,
// p kept fp32 into p·v, fp32 sums, acc / max(l, 1e-30), o rounded once, at
// its store, to bf16 (round to nearest even).  The TPU kernel kept m, l
// and acc in VMEM across its sequential kv grid axis; here a loop over the
// kv tiles inside one block keeps them in registers.  (It replaces a bf16
// body that was the fp32 body's template at bf16: TF32 mma.sync, p split
// in two, 16 or 32 keys a tile and two barriers each, 1.8-4.3x slower
// than scaled_dot_product_attention at S >= 128 on the H100.)
//
// What bounds it on the H100, and what the design does about it:
// - Operations (S 128-1024).  Both products run on wgmma, the bf16 tensor
//   cores at their full rate: q·k^T as m64n64k16 with q and the K tile in
//   shared memory (a product of two bf16 values is exact in fp32, so the
//   scores are the fp32 products of the widened operands, summed in
//   another order); p·v as m64n64k16 with p from registers (the scores'
//   accumulator, repacked in place: its pairs of 16 columns are the A
//   fragment) and the V tile MN-major in shared memory.  p enters as
//   three bf16 pieces, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi
//   - mid), which sum to p exactly; each piece·v is exact in fp32, so
//   three products against one V tile keep p fp32, as the TPU kernel does.
//   (Rounding p to bf16, as scaled_dot_product_attention does, would be
//   another function.)  The tensor work of a (query, key) pair is 8·D
//   FLOPs, twice the function's 4·D.  A warpgroup keeps two tiles in
//   flight: the scores of tile i + 1 are issued before p·v of tile i and
//   go through the softmax while p·v runs; no branch separates an issue
//   from its wait and nothing else touches an accumulator in between (else
//   ptxas serializes the products).  The softmax works in base 2 with the
//   scale folded in (one FFMA and one MUFU ex2 an element).
// - Bytes and latency (S 16; the K/V stream at every S).  K and V tiles
//   of 64 keys arrive by TMA into a ring of up to STAGES stages guarded by
//   mbarriers (a launch uses no more stages than its longest row tile has
//   kv tiles, so a short prefill fits more blocks an SM).  There is no
//   __syncthreads in the kv loop.  The tensor maps are 4-D over k and v as
//   they lie, (D, KVH, S, B), boxes of (64 columns, 1 head, 64 keys, 1
//   batch) in the 128-byte swizzle: the hardware's out-of-bounds fill
//   gives zeros past D within a head and past S within a batch, so
//   nothing is padded in device memory.  Where TMA cannot address the
//   rows (D % 8 != 0 or k, v not 16-byte aligned) one warp copies the same
//   tiles with plain loads and stores.  Beside two consumer warpgroups a
//   producer warpgroup issues the copies (and hands its registers to the
//   consumers with setmaxnreg); a block of one consumer warpgroup loads
//   its own tiles (its warp 0 refills a stage once the stage is read), 4
//   warps a block, two or three blocks an SM.
// - Grid fill and K/V reuse.  A block's query rows are the (s, head)
//   pairs of one (batch, kv head) in s-major order, CW consumer
//   warpgroups of 64 rows each, so every K/V tile is loaded once for the
//   whole group and the causal mask wastes little of the diagonal tile.
//   A block holds the output columns [z·DV, (z+1)·DV) of its rows: at D
//   256 (and where the card is not filled otherwise) DSPLIT = DP / DV
//   blocks share a row tile, each recomputing the scores, so that the
//   accumulator of 64 rows × DV columns is DV / 2 registers a thread, at
//   most 64.  The launch plan (CW, DSPLIT) comes from `launch_plan` in
//   kernels/flash_attention.py, where the CPU tests check that it covers
//   every output once and mirrors this file's constants.  The row tiles
//   with the most kv tiles (largest s) are scheduled first; kv tiles
//   above the diagonal are never loaded.  q is read once a block by its
//   warpgroup (16-byte cp.async copies where rows allow, into the same
//   swizzled layout: a group's rows are no TMA box when 64 % G != 0); o is
//   stored from registers.
// - Deterministic: no atomics, every sum in a fixed order, so two calls on
//   the same inputs give bitwise the same o.
//
// Shared memory: CW q tiles (64 × DP), then the stages (K 64 × DP, V 64 ×
// DV), bf16, each 1024-byte aligned; the barriers in the alignment slack
// before them or after the last stage.  STAGES: as many as fit, 2 to 4, in
// one block an SM with two consumer warpgroups and in half the SM with
// one.  Set once per device and instance, outside graph capture.
#include <cuda.h>   // CUtensorMap and its enums only: nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#include "hopper.cuh"
#include "tf32_mma.cuh"   // cp_async16

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV = 64;          // keys a kv tile
constexpr int ROWS = 64;         // query rows a consumer warpgroup
constexpr int CHUNK = 64;        // bf16 columns of a swizzled chunk
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;     // a block's most, on the H100
constexpr int SMEM_HALF = 115712;      // each of two blocks on one SM
constexpr int SMEM_EXTRA = 1024;       // alignment slack (and barriers)

constexpr int clamp_stages(int n) {
  return n < MIN_STAGES ? MIN_STAGES : n > MAX_STAGES ? MAX_STAGES : n;
}

// DP: head dim rounded up (64, 128 or 256); DV: output columns a block (64
// or 128); CW: consumer warpgroups a block (1 or 2).
template <int DP_, int DV_, int CW_>
struct Cfg {
  static constexpr int DP = DP_, DV = DV_, CW = CW_;
  // Beside two consumer warpgroups, a producer warpgroup, which hands its
  // registers to the consumers (a block of 384 threads starts at 168 a
  // thread); one consumer warpgroup loads its own tiles (a block of 4
  // warps: two or three blocks an SM).
  static constexpr bool OWN = CW == 1;
  static constexpr int THREADS = OWN ? 128 : 384;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static constexpr int KC = DP / CHUNK, VC = DV / CHUNK;   // chunks
  static constexpr int QT = ROWS * 128, KT = BKV * 128;    // chunk bytes
  static constexpr int Q_BYTES = CW * KC * QT;
  static constexpr int K_BYTES = KC * KT, V_BYTES = VC * KT;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int STAGES = clamp_stages(
      ((CW == 2 ? SMEM_LIMIT : SMEM_HALF) - SMEM_EXTRA - Q_BYTES) /
      STAGE_BYTES);
  static constexpr int BYTES =
      SMEM_EXTRA + Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(DP % CHUNK == 0 && DV % CHUNK == 0 && DV <= DP, "chunks");
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int S, H, KVH, D;
  float scale;
  int causal;
  int tma;    // 1: K and V by TMA (D % 8 == 0, k and v 16-byte aligned)
  int qvec;   // 1: q rows in 16-byte chunks (D % 8 == 0, q 16-byte aligned)
  int ovec;   // 1: o stored as bf16 pairs (D even, o 4-byte aligned)
  int stages; // stages of the ring this launch: at most the longest row
              // tile's kv tiles (fewer stages, more blocks an SM)
};

// 2^x, flushing subnormals (the MUFU instruction alone).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Without TMA: rows [key0, key0 + BKV) × columns [c0, c0 + 64·chunks) of
// one (batch, kv head) of k or v into swizzled chunks at dst, zero past S
// and D; the producer warp's 32 lanes.
__device__ __forceinline__ void copy_tile(unsigned char* dst, const bf16* src,
                                          const Params& p, int b, int hk,
                                          int key0, int c0, int chunks,
                                          int lane) {
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  const int cols = chunks * CHUNK;
  for (int e = lane; e < BKV * cols; e += 32) {
    const int r = e / cols, c = e % cols;
    const int key = key0 + r, col = c0 + c;
    uint16_t val = 0;
    if (key < p.S && col < p.D)
      val = s16[(static_cast<size_t>(b) * p.S + key) * p.KVH * p.D +
                hk * p.D + col];
    *reinterpret_cast<uint16_t*>(dst + (c / CHUNK) * (BKV * 128) +
                                 swizzled(r, c % CHUNK)) = val;
  }
}

// hi, mid and lo of a pair of fp32 values, packed as bf16 pairs (the
// first value in the low half).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;   // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attention_bf16(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const Params p) {
  // The tiles from the first 1024-byte boundary; the barriers before
  // them where the gap holds them, else after them (SMEM_EXTRA covers
  // both).
  extern __shared__ unsigned char smem_raw[];
  const uintptr_t raw = reinterpret_cast<uintptr_t>(smem_raw);
  unsigned char* Qs =
      reinterpret_cast<unsigned char*>((raw + 1023) & ~uintptr_t(1023));
  unsigned char* KV = Qs + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(Qs) - raw >= 16 * p.stages
          ? smem_raw
          : KV + p.stages * C::STAGE_BYTES);
  uint64_t* empty = full + p.stages;
  const int NS = p.stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.H / p.KVH;
  const int rows = p.S * G;            // query rows of one (batch, kv head)
  const int b = blockIdx.y / p.KVH, hk = blockIdx.y % p.KVH;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * (ROWS * C::CW);
  const int col0 = blockIdx.z * C::DV;
  const int last_row = min(r0 + ROWS * C::CW, rows) - 1;
  const int n_tiles = (p.causal ? last_row / G : p.S - 1) / BKV + 1;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], p.tma ? 1 : 32);
      if constexpr (!C::OWN) mbar_init(&empty[s], C::CW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // K and V tile `tile` into stage st, by one warp: one lane's TMA copies,
  // or the 32 lanes' loads and stores.
  const auto load_tile = [&](int st, int tile) {
    unsigned char* Ks = KV + st * C::STAGE_BYTES;
    unsigned char* Vs = Ks + C::K_BYTES;
    const int key0 = tile * BKV;
    if (p.tma) {
      if (lane == 0) {
        mbar_arrive_tx(&full[st], C::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < C::KC; ++c)
          tma_load_4d(Ks + c * C::KT, &kmap, &full[st], c * CHUNK, hk, key0,
                      b);
#pragma unroll
        for (int c = 0; c < C::VC; ++c)
          tma_load_4d(Vs + c * C::KT, &vmap, &full[st], col0 + c * CHUNK,
                      hk, key0, b);
      }
    } else {
      copy_tile(Ks, p.k, p, b, hk, key0, 0, C::KC, lane);
      copy_tile(Vs, p.v, p, b, hk, key0, col0, C::VC, lane);
      fence_async_smem();
      mbar_arrive(&full[st]);
    }
  };

  if constexpr (C::OWN) {
    // The first tiles in flight before q is read, so that the two overlap.
    if (warp == 0)
      for (int it = 0; it < min(NS, n_tiles); ++it) load_tile(it, it);
  } else if (warp >= 4 * C::CW) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp > 4 * C::CW) return;
    // The producer warp: the ring refilled as both warpgroups release it.
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      if (it >= NS) mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
      load_tile(st, it);
    }
    return;
  }

  // A consumer warpgroup: 64 query rows.
  if constexpr (!C::OWN) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, tw = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* Qw = Qs + wg * (C::KC * C::QT);
  const int qr0 = r0 + wg * ROWS;

  // q once: the warpgroup's rows into swizzled chunks, zero past D;
  // 16-byte cp.async copies (all in flight at once) where the rows allow,
  // else element loads.  Rows past the last are left as they are: the
  // products keep rows apart, and their o is not stored.
  if (p.qvec) {
    constexpr int UNITS = C::DP / 8;   // 16-byte units a row
#pragma unroll
    for (int i = 0; i < ROWS * UNITS / 128; ++i) {
      const int c = tw + 128 * i;
      const int r = c / UNITS, u = c % UNITS, R = qr0 + r;
      if (R >= rows) continue;   // a row past the last: its o is not stored
      const bool ok = u * 8 < p.D;
      const int s = R / G;
      cp_async16(Qw + (u >> 3) * C::QT + r * 128 + (((u ^ r) & 7) << 4),
                 ok ? p.q + ((static_cast<size_t>(b) * p.S + s) * p.H +
                             hk * G + (R - s * G)) * p.D + u * 8
                    : p.q,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    const uint16_t* q16 = reinterpret_cast<const uint16_t*>(p.q);
    for (int e = tw; e < ROWS * C::DP; e += 128) {
      const int r = e / C::DP, c = e % C::DP, R = qr0 + r;
      if (R >= rows) continue;
      uint16_t val = 0;
      if (c < p.D) {
        const int s = R / G;
        val = q16[((static_cast<size_t>(b) * p.S + s) * p.H + hk * G +
                   (R - s * G)) * p.D + c];
      }
      *reinterpret_cast<uint16_t*>(Qw + (c / CHUNK) * C::QT +
                                   swizzled(r, c % CHUNK)) = val;
    }
  }
  fence_async_smem();
  named_barrier(1 + wg, 128);

  // This thread's two rows (g and g + 8 of its warp's 16) and their s.
  const int ra = qr0 + wq * 16 + g, rb = ra + 8;
  const int sa = ra / G, sb = rb / G;
  // The warpgroup's own kv tiles (0 when it holds no row), and the first
  // tile that the causal mask or the end of S reaches.
  const int my_last = min(qr0 + ROWS, rows) - 1;
  const int my_tiles =
      qr0 < rows ? (p.causal ? my_last / G : p.S - 1) / BKV + 1 : 0;
  const int first_s = qr0 / G;

  float o[C::VC][32];
#pragma unroll
  for (int c = 0; c < C::VC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const uint64_t dq = desc_sw128(Qw);

  // s = q·k^T of the tile in stage st over the head dim: k steps of 16
  // columns, 4 a chunk (32 bytes apart), chunks QT (q) and KT (K) apart;
  // >> 4 in descriptors.  Issued and committed, not waited for.
  const auto issue_qk = [&](float (&s)[32], int st) {
    const uint64_t dk = desc_sw128(KV + st * C::STAGE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk)
      wgmma_ss(s, dq + (((kk >> 2) * C::QT + (kk & 3) * 32) >> 4),
               dk + (((kk >> 2) * C::KT + (kk & 3) * 32) >> 4), kk > 0);
    wgmma_commit();
  };
  // Online softmax of tile it's scores, in place (s becomes p), the
  // running max and the lane's partial sums updated, corr the factor for
  // the accumulator.  s[4j + e]: row g (e < 2) or g + 8, key 8j + 2t +
  // (e & 1) of the tile; a row's 64 values lie in the 4 lanes of a quad.
  // In base 2 with the scale folded in: m is the running max of
  // s·scale·log2(e) and p = 2^(s·scale·log2(e) - m), one FFMA and one
  // MUFU an element.  A masked score is -inf (its weight exactly 0, as
  // -1e30's is in the TPU kernel for every row that has a key); m starts
  // at -1e30, so a row with no key yet keeps corr 1 and p 0.
  const float c2 = p.scale * LOG2E;
  const auto softmax = [&](float (&s)[32], int it, float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    const int key0 = it * BKV;
    if (key0 + BKV > p.S || (p.causal && key0 + BKV - 1 > first_s)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (key >= p.S || (p.causal && key > ((i & 2) ? sb : sa)))
          s[i] = -INFINITY;
      }
    }
    // four chains of maxima and of sums: rows g, g + 8 × even, odd j
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1][(i >> 2) & 1] =
          fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], s[i]);
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(mx[r][0], mx[r][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x * c2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      mb[r] = -m_new;
    }
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = ex2(fmaf(s[i], c2, mb[(i >> 1) & 1]));
      s[i] = pe;
      rs[(i >> 1) & 1][(i >> 2) & 1] += pe;
    }
    // the quad's partial sums are added once, at the end
    l[0] = l[0] * corr[0] + (rs[0][0] + rs[0][1]);
    l[1] = l[1] * corr[1] + (rs[1][0] + rs[1][1]);
  };

  // p in three bf16 pieces, as A fragments of the 4 k steps of 16 keys
  // (k step kk is elements 8kk .. 8kk + 7 of the scores, in pairs).
  uint32_t ph[4][4], pm[4][4], pl[4][4];
  const auto split = [&](const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph[kk][j],
               pm[kk][j], pl[kk][j]);
  };

  // o += p·v of the tile in stage st, the small pieces first: k step kk
  // reads V rows 16kk .. 16kk + 15 (2048 bytes on), chunk c its 64
  // columns.  Issued and committed, not waited for.
  const auto issue_pv = [&](int st) {
    const uint64_t dv = desc_sw128(KV + st * C::STAGE_BYTES + C::K_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < C::VC; ++c)
        wgmma_rs_mn(o[c], pl[kk], dv + ((c * C::KT + kk * 2048) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < C::VC; ++c)
        wgmma_rs_mn(o[c], pm[kk], dv + ((c * C::KT + kk * 2048) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < C::VC; ++c)
        wgmma_rs_mn(o[c], ph[kk], dv + ((c * C::KT + kk * 2048) >> 4));
    wgmma_commit();
  };
  // ... and its wait; the stage, read, is refilled with tile `next` (by
  // warp 0 where the warpgroup loads its own tiles) or released to the
  // producer (one arrival for the warpgroup).
  const auto wait_pv = [&](int st, int next) {
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::VC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(o[c][i]);
    if constexpr (C::OWN) {
      if (warp == 0 && next < n_tiles) load_tile(st, next);
    } else if (tw == 0) {
      mbar_arrive(&empty[st]);
    }
  };

  // The warpgroup's tiles, two in flight: the scores of tile it + 1 are
  // issued before p·v of tile it, and go through the softmax while p·v
  // runs on the tensor cores.  No branch separates an issue from its wait
  // and nothing else touches an accumulator in between (ptxas would
  // serialize the products): o is rescaled, and p split, once both have
  // completed; the last tile's p·v is peeled off the loop.
  if (my_tiles > 0) {
    float corr[2];
    float s[32];
    mbar_wait(&full[0], 0);
    issue_qk(s, 0);
    wgmma_wait<0>();
    softmax(s, 0, corr);   // corr multiplies the zero accumulator
    split(s);
    for (int it = 0; it + 1 < my_tiles; ++it) {
      const int st = it % NS, nx = (it + 1) % NS;
      mbar_wait(&full[nx], ((it + 1) / NS) & 1);
      issue_qk(s, nx);
      issue_pv(st);
      wgmma_wait<1>();   // the scores of tile it + 1, not p·v of tile it
      softmax(s, it + 1, corr);
      wait_pv(st, it + NS);
#pragma unroll
      for (int c = 0; c < C::VC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
      split(s);
    }
    issue_pv((my_tiles - 1) % NS);
    wait_pv((my_tiles - 1) % NS, my_tiles - 1 + NS);
  }
  // The block's tiles past the warpgroup's own (the causal mask ends its
  // rows earlier): released as they arrive.
  if constexpr (!C::OWN) {
    for (int it = my_tiles; it < n_tiles; ++it) {
      const int st = it % NS;
      mbar_wait(&full[st], (it / NS) & 1);
      if (tw == 0) mbar_arrive(&empty[st]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den_a = fmaxf(l[0], 1e-30f), den_b = fmaxf(l[1], 1e-30f);
  const auto row_off = [&](int r, int s) {
    return ((static_cast<size_t>(b) * p.S + s) * p.H + hk * G + (r - s * G)) *
           p.D;
  };
  const size_t oa = ra < rows ? row_off(ra, sa) : 0;
  const size_t ob = rb < rows ? row_off(rb, sb) : 0;
#pragma unroll
  for (int c = 0; c < C::VC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + c * CHUNK + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((h ? rb : ra) >= rows) continue;
        const float den = h ? den_b : den_a;
        bf16* dst = p.o + (h ? ob : oa) + col;
        const float x0 = o[c][4 * j + 2 * h] / den;
        const float x1 = o[c][4 * j + 2 * h + 1] / den;
        if (p.ovec && col + 1 < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < p.D) dst[0] = __float2bfloat16_rn(x0);
          if (col + 1 < p.D) dst[1] = __float2bfloat16_rn(x1);
        }
      }
    }
}

// cuTensorMapEncodeTiled (a libcuda function), found once through the
// CUDA runtime's entry-point query, so the library links no libcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(ptr);
  }
  return fn;
}

// The map of k or v (B, S, KVH, D) as the 4-D (D, KVH, S, B): boxes of 64
// columns × 1 head × BKV keys × 1 batch, 128-byte swizzle, zeros out of
// bounds.
bool encode(CUtensorMap* map, const void* base, int b, int s, int kvh,
            int d) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(kvh),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(kvh) * d * 2,
                                 static_cast<cuuint64_t>(s) * kvh * d * 2};
  const cuuint32_t box[4] = {CHUNK, 1, BKV, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
           int b, cudaStream_t stream) {
  // The dynamic shared memory attribute once per device, so that a launch
  // inside CUDA-graph capture makes no call that capture forbids.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(attention_bf16<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  Params q = p;
  q.stages = min(C::STAGES, (p.S - 1) / BKV + 1);
  const int rows = p.S * (p.H / p.KVH);
  const dim3 grid((rows + ROWS * C::CW - 1) / (ROWS * C::CW), b * p.KVH,
                  C::DP / C::DV);
  attention_bf16<C><<<grid, C::THREADS,
                      SMEM_EXTRA + C::Q_BYTES + q.stages * C::STAGE_BYTES,
                      stream>>>(km, vm, q);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DV>
int by_cw(const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
          int b, int cw, cudaStream_t stream) {
  if (cw == 1) return launch<Cfg<DP, DV, 1>>(km, vm, p, b, stream);
  if constexpr (DV == 128) {   // the plan takes two warpgroups at 128 only
    if (cw == 2) return launch<Cfg<DP, DV, 2>>(km, vm, p, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,S,H,D), k and v (B,S,KVH,D), o (B,S,H,D); bf16, contiguous, on the
// device of `stream`; H % KVH == 0, 1 <= D <= 256, B * KVH <= 65535.  The
// plan: cw consumer warpgroups of 64 query rows a block (1 or 2) and
// dsplit blocks a row tile (DP / dsplit output columns each: 64 or 128,
// DP the head dim rounded up to 64, 128 or 256).  Returns the launch's
// cudaError_t (0 on success), or cudaErrorInvalidValue for a shape or
// plan it does not take.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int h, int kvh, int d, int causal,
                                    int cw, int dsplit, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      b * kvh > 65535 || d <= 0 || d > 256 || dsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const int dv = dp % dsplit == 0 ? dp / dsplit : 0;
  const auto aligned = [](const void* ptr, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(ptr) % n == 0;
  };
  Params p{static_cast<const bf16*>(q),
           static_cast<const bf16*>(k),
           static_cast<const bf16*>(v),
           static_cast<bf16*>(o),
           s, h, kvh, d,
           1.0f / std::sqrt(static_cast<float>(d)),
           causal,
           d % 8 == 0 && aligned(k, 16) && aligned(v, 16),
           d % 8 == 0 && aligned(q, 16),
           d % 2 == 0 && aligned(o, 4),
           0};
  CUtensorMap km, vm;
  std::memset(&km, 0, sizeof km);
  std::memset(&vm, 0, sizeof vm);
  if (p.tma && !(encode(&km, k, b, s, kvh, d) && encode(&vm, v, b, s, kvh, d)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 64 && dv == 64) return by_cw<64, 64>(km, vm, p, b, cw, st);
  if (dp == 128 && dv == 128) return by_cw<128, 128>(km, vm, p, b, cw, st);
  if (dp == 128 && dv == 64) return by_cw<128, 64>(km, vm, p, b, cw, st);
  if (dp == 256 && dv == 128) return by_cw<256, 128>(km, vm, p, b, cw, st);
  if (dp == 256 && dv == 64) return by_cw<256, 64>(km, vm, p, b, cw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
