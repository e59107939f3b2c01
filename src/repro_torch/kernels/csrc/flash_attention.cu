// Flash attention (forward) for Hopper (sm_90a), fp32:
//   o = softmax(q k^T / sqrt(D) [+ causal mask]) v
// over q (B, S, H, D), k and v (B, S, KVH, D) with H % KVH == 0 (query head
// h reads kv head h / (H / KVH): GQA and MQA without expanding k and v),
// o (B, S, H, D).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`): grid (batch*heads, q tiles, kv
// tiles), kv innermost, with the running max m, normalizer l and output
// accumulator acc in VMEM scratch across the sequential kv sweep.  CUDA
// blocks run in no order, so the kv sweep becomes a loop inside one block:
// one block per (batch*head, 32-row q tile), 4 warps, each warp owning 8
// query rows whose m, l and acc live in its registers for the whole loop.
// Per kv tile of 32 keys the block stages K and V in shared memory; each
// lane of a warp scores one key against the warp's 8 rows (s = q.k *
// scale, the q rows broadcast from shared memory), the row max and sum
// are warp shuffles, p goes through shared memory, and each lane adds
// p @ V into its D/32 columns of the 8 rows.  Causal: kv tiles past the
// q tile's last row are never loaded, and the diagonal tile is masked
// with -1e30 (key 0 is valid for every row, so no row's max stays -1e30
// after the first tile).  The epilogue divides by max(l, 1e-30), as the
// TPU kernel does.  Ragged S and D are masked with zeros; nothing is
// padded in device memory.
//
// Shared memory: q and k tiles rows padded to DP + 1 floats (the lanes
// read 32 different k rows at one column: no bank conflicts), v and p
// unpadded: (2 * 32 * (DP + 1) + 32 * DP + 32 * 32) floats, 102,656 bytes
// at DP = 256 (head_dim 256: RecurrentGemma), above the 48 KB of static
// shared memory, so the kernel takes it as dynamic shared memory after
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize); two blocks per SM.
// DP is the head dim rounded up to 32, 64, 128 or 256 (D <= 256).
//
// Bound: at the path's shapes operations (causal ~2 * BH * S^2 * D FLOPs
// for q k^T and p v together, against (3 + 1) * B * S * H * D * 4 bytes
// when kv is expanded; with kv read per KVH head the bytes are smaller
// still).  fp32 FFMA only: tensor cores (wgmma) and a cp.async / TMA
// pipeline for the K / V tiles are later work.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // keys per kv tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;       // query rows per warp
constexpr float NEG = -1e30f;

template <int DP>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(2 * BQ * (DP + 1) + BK * DP + BQ * BK) *
         sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int H, int KVH, int D, float scale,
                       int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);            // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);            // [BK][DP]
  float* Ps = Vs + BK * DP;                  // [BQ][BK]
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 32;                // output columns per lane

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * ROWS;
  const size_t q_row = static_cast<size_t>(H) * D;     // stride of s in q, o
  const size_t k_row = static_cast<size_t>(KVH) * D;   // stride of s in k, v
  const float* qb = q + static_cast<size_t>(b) * S * q_row +
                    static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * S * k_row +
                    static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * S * k_row +
                    static_cast<size_t>(hk) * D;
  float* ob = o + static_cast<size_t>(b) * S * q_row +
              static_cast<size_t>(h) * D;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    const int s = q0 + r;
    Qs[r * LD + c] = (s < S && c < D) ? __ldg(qb + s * q_row + c) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int last = causal ? min(q0 + BQ, S) - 1 : S - 1;
  for (int k0 = 0; k0 <= last; k0 += BK) {
    // The previous tile's K, V and P reads are done (first pass: Qs is
    // written) before the tile is overwritten.
    __syncthreads();
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const int s = k0 + r;
      const bool ok = s < S && c < D;
      Ks[r * LD + c] = ok ? __ldg(kb + s * k_row + c) : 0.f;
      Vs[r * DP + c] = ok ? __ldg(vb + s * k_row + c) : 0.f;
    }
    __syncthreads();

    // Scores of key k0 + lane against the warp's ROWS rows.
    float sv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sv[i] = 0.f;
    const float* kr = Ks + lane * LD;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        sv[i] = fmaf(Qs[(r0 + i) * LD + d], kd, sv[i]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + r0 + i;
      float s = sv[i] * scale;
      if (key >= S || (causal && key > qi)) s = NEG;
      float mx = s;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(s - m_new);
      float ps = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, w);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
      Ps[(r0 + i) * BK + lane] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();

    // acc[rows, lane + 32c] += p[rows, :] @ V[:, lane + 32c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Ps[(r0 + i) * BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) ob[qi * q_row + col] = acc[i][c] / den;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int b,
           int s, int h, int kvh, int d, int causal, void* stream) {
  constexpr size_t smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    // Once per device, so that a launch inside CUDA-graph capture makes no
    // call that capture forbids.
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(flash_attention_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed[dev] = true;
    }
  }
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  const float scale = 1.0f / std::sqrt(static_cast<float>(d));
  flash_attention_kernel<DP><<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, s, h, kvh, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,S,H,D), k and v (B,S,KVH,D), o (B,S,H,D); fp32, contiguous, on the
// device of `stream`; H % KVH == 0, 1 <= D <= 256, B * H <= 65535.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int b, int s,
                                   int h, int kvh, int d, int causal,
                                   void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      b * h > 65535 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 32) return launch<32>(q, k, v, o, b, s, h, kvh, d, causal, stream);
  if (d <= 64) return launch<64>(q, k, v, o, b, s, h, kvh, d, causal, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, b, s, h, kvh, d, causal, stream);
  if (d <= 256)
    return launch<256>(q, k, v, o, b, s, h, kvh, d, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
