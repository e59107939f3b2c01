// RG-LRU linear recurrence for Hopper (sm_90a), fp32, and its gradient:
//   forward   h_t = a_t * h_{t-1} + b_t over t, h_{-1} = 0;  a, b, h (B, S, C)
//   backward  d_{S-1} = g_{S-1},  d_t = g_t + a_{t+1} * d_{t+1};
//             db_t = d_t,  da_t = d_t * h_{t-1} (h_{-1} = 0);
//             a, h, g, da, db (B, S, C)
//
// The forward replaces the TPU kernel in src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_kernel`): grid (batch, channel tiles, time tiles),
// time innermost, the carry h in VMEM scratch across the sequential time
// tiles.  The backward replaces no Pallas kernel: it is the gradient that
// the JAX package takes through XLA's transpose of its scan
// (src/repro/models/rglru.py `rglru_scan`), one fused program there.
//
// Each channel's chain runs sequentially in t, a correctly rounded multiply
// and then a correctly rounded add a step (no FMA contraction, no two-level
// scan over the affine maps): the plain versions' arithmetic, so the
// forward is bitwise `rglru_scan_ref` and the backward bitwise autograd of
// it (autograd's two-term sums commute, its zero-fill adds are exact).
//
// Bound: bytes.  Forward 3 * B*S*C * 4 (a, b read, h written), backward
// 5 * B*S*C * 4 (a, h, g read, da, db written), at 2-3 FLOPs an element.
// What limits a one-thread-a-chain kernel is the bytes in flight: a thread
// that loads its own steps keeps a few of them in flight, and at
// (8, S, 2560) the 20,480 chains are too few threads to cover the HBM's
// latency that way.  So a block of CT threads owns CT channels of one
// batch (one thread a chain) and stages the sequence in shared memory:
// all its threads copy each chunk's rows of every operand with cp.async
// (16 bytes a copy where C % 4 == 0 and the rows are aligned, else 4),
// and the chains read their steps from there (row r, column j: no bank
// conflicts) and store h (or da, db) straight to global memory, a
// coalesced row of CT floats a step.  Two bodies:
//   * S <= CHUNK (32; the served prompts' 16): the whole sequence's copies
//     are issued at once into one static tile, then one barrier and the
//     chain.  At this length the ring's bookkeeping costs more than the
//     kernel's own work can hide (measured on the H100).
//   * S > CHUNK (the probes' and training's 128): chunks of CHUNK steps in
//     a ring of `stages` (up to 4 forward, 3 backward: every block's ring
//     resident, three blocks an SM), all issued before the chain starts;
//     chunk k + stages is issued as soon as chunk k has been consumed.
// The backward walks the chunks from the top of the sequence down; its h
// tile is shifted one step earlier, so step t finds h_{t-1} in its own
// row, and a_{t+1} stays in a register from the step before.  The launch
// plan (`launch_plan` in kernels/rglru_scan.py) picks CT (64 where that
// still gives every SM two blocks), the body and the stages; ragged C is
// masked (zero-filled copies, no store), ragged S ends a chunk early;
// nothing is padded.
#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"   // cp_async16, cp_async4, commit and wait

namespace {

// The most dynamic shared memory a block may take on the H100 (227 KB).
constexpr int SMEM_MAX = 232448;
// Above this a launch needs the dynamic shared memory attribute.
constexpr int SMEM_DEFAULT = 48 * 1024;
// Time steps of a chunk; a sequence of at most CHUNK steps is one chunk.
constexpr int CHUNK = 32;
constexpr int MAX_STAGES = 4;

// Wait until at most n (< MAX_STAGES) of this thread's cp.async groups are
// still pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Rows [r0, r0 + rows) of one batch's (S, C) plane `src`, channels
// [c0, c0 + CT), into the tile `dst` (row r at dst + r * CT), copied by
// the block's CT threads VEC floats a copy; channels at or past C are
// zero-filled (their chains store nothing).
template <int CT, int VEC>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int rows, int c0, int C) {
  constexpr int PER_ROW = CT / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += CT) {
    const int r = i / PER_ROW;
    const int v = (i % PER_ROW) * VEC;
    const float* s = src + static_cast<size_t>(r0 + r) * C + c0 + v;
    if (VEC == 4)
      cp_async16(dst + r * CT + v, s, c0 + v < C);
    else
      cp_async4(dst + r * CT + v, s, c0 + v < C);
  }
}

// Steps [0, rows) of a staged chunk (a's tile `sa`, b's `sb`) of channel
// column j: h from hv on, stored at out + r * C; returns the last h.
template <int CT>
__device__ __forceinline__ float fwd_chain(const float* sa, const float* sb,
                                           float hv, float* out, int rows,
                                           int C, int j) {
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    hv = __fadd_rn(__fmul_rn(sa[r * CT + j], hv), sb[r * CT + j]);
    out[static_cast<size_t>(r) * C] = hv;
  }
  return hv;
}

// Steps t0 + rows - 1 down to t0 of a staged chunk of channel column j: a's
// tile `sa`, g's `sg`, and `sh` whose row r holds h_{t0+r-1} (row 0 unread
// at t0 = 0); d and an carry d_{t+1} and a_{t+1} across chunks.  da, db
// point at step t0 of the channel.
template <int CT>
__device__ __forceinline__ void bwd_chain(const float* sa, const float* sg,
                                          const float* sh, float& d,
                                          float& an, float* da, float* db,
                                          int t0, int rows, int S, int C,
                                          int j) {
#pragma unroll 8
  for (int r = rows - 1; r >= 0; --r) {
    const int t = t0 + r;
    const float gt = sg[r * CT + j];
    d = t == S - 1 ? gt : __fadd_rn(gt, __fmul_rn(an, d));
    const float hp = t > 0 ? sh[r * CT + j] : 0.f;
    db[static_cast<size_t>(r) * C] = d;
    da[static_cast<size_t>(r) * C] = __fmul_rn(d, hp);
    an = sa[r * CT + j];
  }
}

// S <= CHUNK: the whole sequence's copies issued at once into one static
// tile, one barrier, then the chain.
template <int CT, int VEC>
__global__ void __launch_bounds__(CT)
scan_fwd_short(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ h, int S, int C) {
  __shared__ __align__(16) float sa[CHUNK * CT], sb[CHUNK * CT];
  const int j = threadIdx.x, c0 = blockIdx.x * CT, c = c0 + j;
  const size_t plane = static_cast<size_t>(blockIdx.y) * S * C;
  copy_rows<CT, VEC>(sa, a + plane, 0, S, c0, C);
  copy_rows<CT, VEC>(sb, b + plane, 0, S, c0, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (c < C) fwd_chain<CT>(sa, sb, 0.f, h + plane + c, S, C, j);
}

// S > CHUNK: a ring of `stages` chunks of CHUNK steps in dynamic shared
// memory; chunk k + stages is issued once chunk k has been consumed.
template <int CT, int VEC>
__global__ void __launch_bounds__(CT)
scan_fwd_ring(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ h, int S, int C, int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TILE = CHUNK * CT;          // floats of one operand's rows
  const int j = threadIdx.x, c0 = blockIdx.x * CT, c = c0 + j;
  const size_t plane = static_cast<size_t>(blockIdx.y) * S * C;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  // stage k % stages holds a's rows of chunk k, then b's
  auto load = [&](int k) {
    float* st = smem + (k % stages) * 2 * TILE;
    const int t0 = k * CHUNK, rows = min(CHUNK, S - t0);
    copy_rows<CT, VEC>(st, a + plane, t0, rows, c0, C);
    copy_rows<CT, VEC>(st + TILE, b + plane, t0, rows, c0, C);
    cp_async_commit();                      // one group a chunk
  };
  for (int k = 0; k < stages; ++k) load(k);
  float hv = 0.f;
  for (int k = 0; k < chunks; ++k) {
    // this thread's copies of chunk k (the groups after it are the chunks
    // still in flight: stages - 1, fewer once nothing is refilled) ...
    cp_async_wait_n(min(stages - 1, chunks - 1 - k));
    __syncthreads();                        // ... and everyone else's
    const float* st = smem + (k % stages) * 2 * TILE;
    const int t0 = k * CHUNK;
    if (c < C)
      hv = fwd_chain<CT>(st, st + TILE, hv,
                         h + plane + static_cast<size_t>(t0) * C + c,
                         min(CHUNK, S - t0), C, j);
    if (k + stages < chunks) {
      __syncthreads();                      // the stage is free again
      load(k + stages);
    }
  }
}

// The backward's copies of the chunk of steps [t0, t1): a's and g's rows,
// and h's one step earlier (none for t = 0).
template <int CT, int VEC>
__device__ __forceinline__ void copy_bwd(float* st, int tile, const float* a,
                                         const float* g, const float* h,
                                         int t0, int t1, int c0, int C) {
  copy_rows<CT, VEC>(st, a, t0, t1 - t0, c0, C);
  copy_rows<CT, VEC>(st + tile, g, t0, t1 - t0, c0, C);
  if (t0 > 0)
    copy_rows<CT, VEC>(st + 2 * tile, h, t0 - 1, t1 - t0, c0, C);
  else
    copy_rows<CT, VEC>(st + 2 * tile + CT, h, 0, t1 - 1, c0, C);
}

template <int CT, int VEC>
__global__ void __launch_bounds__(CT)
scan_bwd_short(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ g, float* __restrict__ da,
               float* __restrict__ db, int S, int C) {
  __shared__ __align__(16) float st[3 * CHUNK * CT];
  const int j = threadIdx.x, c0 = blockIdx.x * CT, c = c0 + j;
  const size_t plane = static_cast<size_t>(blockIdx.y) * S * C;
  copy_bwd<CT, VEC>(st, CHUNK * CT, a + plane, g + plane, h + plane, 0, S,
                    c0, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float d = 0.f, an = 0.f;
  if (c < C)
    bwd_chain<CT>(st, st + CHUNK * CT, st + 2 * CHUNK * CT, d, an,
                  da + plane + c, db + plane + c, 0, S, S, C, j);
}

// The ring walks the chunks from the top of the sequence down: chunk k
// holds steps [t0, t1), t1 = S - k * CHUNK, the last one the ragged rest.
template <int CT, int VEC>
__global__ void __launch_bounds__(CT)
scan_bwd_ring(const float* __restrict__ a, const float* __restrict__ h,
              const float* __restrict__ g, float* __restrict__ da,
              float* __restrict__ db, int S, int C, int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TILE = CHUNK * CT;
  const int j = threadIdx.x, c0 = blockIdx.x * CT, c = c0 + j;
  const size_t plane = static_cast<size_t>(blockIdx.y) * S * C;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  auto load = [&](int k) {
    const int t1 = S - k * CHUNK;
    copy_bwd<CT, VEC>(smem + (k % stages) * 3 * TILE, TILE, a + plane,
                      g + plane, h + plane, max(t1 - CHUNK, 0), t1, c0, C);
    cp_async_commit();
  };
  for (int k = 0; k < stages; ++k) load(k);
  float d = 0.f, an = 0.f;                  // d_{t+1} and a_{t+1}
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait_n(min(stages - 1, chunks - 1 - k));
    __syncthreads();
    const float* st = smem + (k % stages) * 3 * TILE;
    const int t1 = S - k * CHUNK, t0 = max(t1 - CHUNK, 0);
    if (c < C) {
      const size_t o = plane + static_cast<size_t>(t0) * C + c;
      bwd_chain<CT>(st, st + TILE, st + 2 * TILE, d, an, da + o, db + o, t0,
                    t1 - t0, S, C, j);
    }
    if (k + stages < chunks) {
      __syncthreads();
      load(k + stages);
    }
  }
}

// The dynamic shared memory attribute once per device and instance (its
// `ready` flags), and only for a launch above the default 48 KB: the short
// body (static shared memory), which the captured serving steps take,
// never calls it inside CUDA-graph capture.
template <typename K>
int allow_smem(K kernel, int bytes, bool (&ready)[64]) {
  if (bytes <= SMEM_DEFAULT) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  return 0;
}

struct Plan {
  int ct, tc, stages, vec;
};

// The shape and plan checks both entry points share: cudaSuccess, or
// cudaErrorInvalidValue for a shape or plan the kernels do not take
// (`operands`: the operands copied through shared memory, `ptrs`).  The
// plan is either one chunk of the whole sequence (tc = S <= CHUNK,
// stages 1: the short body) or chunks of CHUNK steps in a ring of 2 to
// MAX_STAGES (S > CHUNK: the ring body).
int check(int bsz, int s, int c, const Plan& p, int operands,
          const void* const* ptrs) {
  const bool one = p.tc == s && s <= CHUNK && p.stages == 1;
  const bool ring = p.tc == CHUNK && s > CHUNK && p.stages >= 2 &&
                    p.stages <= MAX_STAGES &&
                    p.stages <= (s + CHUNK - 1) / CHUNK;
  if (bsz <= 0 || s <= 0 || c <= 0 || bsz > 65535 ||
      (p.ct != 32 && p.ct != 64) || (p.vec != 1 && p.vec != 4) ||
      !(one || ring) || p.stages * operands * CHUNK * p.ct * 4 > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.vec == 4) {
    if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < operands; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int CT, int VEC>
int fwd(const float* a, const float* b, float* h, int bsz, int s, int c,
        const Plan& p, cudaStream_t stream) {
  const dim3 grid((c + CT - 1) / CT, bsz);
  if (p.stages == 1) {
    scan_fwd_short<CT, VEC><<<grid, CT, 0, stream>>>(a, b, h, s, c);
  } else {
    static bool ready[64] = {};
    const int bytes = p.stages * 2 * CHUNK * CT * 4;
    if (int e = allow_smem(scan_fwd_ring<CT, VEC>, bytes, ready)) return e;
    scan_fwd_ring<CT, VEC><<<grid, CT, bytes, stream>>>(a, b, h, s, c,
                                                        p.stages);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CT, int VEC>
int bwd(const float* a, const float* h, const float* g, float* da,
        float* db, int bsz, int s, int c, const Plan& p,
        cudaStream_t stream) {
  const dim3 grid((c + CT - 1) / CT, bsz);
  if (p.stages == 1) {
    scan_bwd_short<CT, VEC><<<grid, CT, 0, stream>>>(a, h, g, da, db, s, c);
  } else {
    static bool ready[64] = {};
    const int bytes = p.stages * 3 * CHUNK * CT * 4;
    if (int e = allow_smem(scan_bwd_ring<CT, VEC>, bytes, ready)) return e;
    scan_bwd_ring<CT, VEC><<<grid, CT, bytes, stream>>>(a, h, g, da, db, s,
                                                        c, p.stages);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h (B,S,C) fp32, contiguous, on the device of `stream`;
// B <= 65535.  The plan: ct channels (threads) a block (32 or 64); tc time
// steps a chunk and a ring of `stages` chunks, either tc = S <= 32 and
// stages 1 (the short body) or tc = 32 and 2-4 stages (the ring, S > 32);
// vec floats a copy (4: C % 4 == 0 and the inputs 16-byte aligned; else
// 1).  Returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int rglru_scan_f32(const float* a, const float* b, float* h,
                              int bsz, int s, int c, int ct, int tc,
                              int stages, int vec, void* stream) {
  const Plan p{ct, tc, stages, vec};
  const void* ptrs[] = {a, b};
  if (int e = check(bsz, s, c, p, 2, ptrs)) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ct == 64)
    return vec == 4 ? fwd<64, 4>(a, b, h, bsz, s, c, p, st)
                    : fwd<64, 1>(a, b, h, bsz, s, c, p, st);
  return vec == 4 ? fwd<32, 4>(a, b, h, bsz, s, c, p, st)
                  : fwd<32, 1>(a, b, h, bsz, s, c, p, st);
}

// The gradient of rglru_scan_f32: a, h (its output), g (the output's
// gradient) in, da, db out; all (B,S,C) fp32, contiguous, on the device of
// `stream`.  The plan and the return value as for rglru_scan_f32.
extern "C" int rglru_scan_bwd_f32(const float* a, const float* h,
                                  const float* g, float* da, float* db,
                                  int bsz, int s, int c, int ct, int tc,
                                  int stages, int vec, void* stream) {
  const Plan p{ct, tc, stages, vec};
  const void* ptrs[] = {a, h, g};
  if (int e = check(bsz, s, c, p, 3, ptrs)) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ct == 64)
    return vec == 4 ? bwd<64, 4>(a, h, g, da, db, bsz, s, c, p, st)
                    : bwd<64, 1>(a, h, g, da, db, bsz, s, c, p, st);
  return vec == 4 ? bwd<32, 4>(a, h, g, da, db, bsz, s, c, p, st)
                  : bwd<32, 1>(a, h, g, da, db, bsz, s, c, p, st);
}
