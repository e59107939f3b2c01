// Depthwise / grouped merged-segment convolution for Hopper (sm_90a), fp32
// result.
//
// Replaces the TPU kernel in src/repro/kernels/depthwise_conv.py
// (`depthwise_conv`, body `_kernel`, and its `quant=True` body): a VALID
// NHWC convolution with stride s and feature_group_count = G, weights HWIO
// (kh, kw, cin_g, G*cout_g) with group-major output channels, followed by
// the segment epilogue (bias, then relu / relu6 / silu).  It covers the
// three cases of the TPU kernel: depthwise (cin_g = cout_g = 1), channel
// multiplier (cin_g = 1, cout_g > 1) and general grouped (cin_g > 1).  The
// HWIO weight is read directly, so the TPU kernel's group-blocked weight
// relayout and its channel padding are not needed.
//
// Bound: 2*kh*kw FLOPs per output element against one input and one output
// element of traffic, far below the card's ridge: device memory bounds it
// (MobileNetV2's 13 units: about 0.044 ms of compulsory bytes at batch 8).
//
// Design: one template, instantiated per element types and tile.
// - Several outputs per thread.  A thread computes a strip of OW outputs
//   along Wo for V output channels: V = 4 channels from one 16-byte load
//   of fp32 (or one 32-bit load of int8 / fp8), OW = 4.  Per input row u
//   the thread loads each of its kw weight vectors once and uses it for
//   the whole strip.  Where the (square) kernel and the stride are
//   compile-time (3x3 s1, 3x3 s2, 1x1: MobileNetV2's depthwise units) the
//   strip's (OW - 1)*s + kw input columns of each row are loaded once into
//   registers and reused as the window slides, and the rows unroll, so all
//   of a strip's loads are in flight together; elsewhere each tap's input
//   vector is loaded (from L1).  So the per-output weight reloads and
//   most of the kh*kw input re-reads go.
//   Threads run along the channel vectors fastest, so a warp's loads and
//   stores are contiguous in NHWC.
// - The scalar edge path (V = 1, OW = 1) of the same template: channel
//   counts that are not multiples of 4, rows that are not aligned, and
//   general grouped convs, which loop over cin_g per tap.
// - The sum of each output stays one fp32 register over the taps in a
//   fixed order (u, v, ci), as before; then the per-channel scale
//   (quantized body), the bias, the activation.
// - 32-bit index math from blockIdx (the wrapper refuses tensors above
//   2^31 - 1 elements).
// - No shared-memory halo.  Neighbouring strips and rows re-read the
//   (kw - s) halo columns and the kh - s rows through L1 and L2; HBM sees
//   each input byte about once.  Timed on the H100 at MobileNetV2's
//   units, this design already ran faster than cuDNN's depthwise kernel
//   in both bodies (PERF.md), so no halo tile, with its barrier and
//   shared-memory round trips, was added.
// The tile (V, OW, the kw / stride instance, threads per block) is chosen
// in Python (`launch_plan` in kernels/depthwise_conv.py, where the CPU
// tests check that it covers every output once and fills the card at
// MobileNetV2's units) and passed in; this file checks it.
//
// Quantized body (depthwise_conv_q): the same template on the element
// types of x and w -- an int8 input under w8a8, int8 or fp8-e4m3 weights --
// each element converted to fp32 as it is loaded, the sum in fp32, then
// multiplied by the per-output-channel fp32 scale (w8a8: the activation's
// per-tensor scale folded in on the device by the op) before the bias and
// the activation.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int OW_VEC = 4;   // outputs a thread along Wo, vector path

// One element of x or w as fp32 (read-only path).
__device__ __forceinline__ float to_f32(const float* p) { return __ldg(p); }
// int8 without the quarter-rate I2F convert: the bits 0x4B000000 + k are
// the float 2^23 + k exactly for 0 <= k < 2^23, so with k = v + 128 one
// integer add and one float subtraction give v exactly.
__device__ __forceinline__ float to_f32(const int8_t* p) {
  const int v = __ldg(reinterpret_cast<const signed char*>(p));
  return __int_as_float(0x4B000080 + v) - 8388736.f;
}
__device__ __forceinline__ float to_f32(const __nv_fp8_e4m3* p) {
  const __nv_fp8_storage_t bits =
      __ldg(reinterpret_cast<const unsigned char*>(p));
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
}

// Four consecutive elements as fp32 from one aligned load.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  // byte i + 128 = (word ^ 0x80808080) byte i, moved by one byte permute
  // into the low byte of 2^23's bits (0x4B000000)
  const uint32_t u =
      __ldg(reinterpret_cast<const unsigned int*>(p)) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float (&f)[4]) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>((u >> (8 * i)) & 0xFFu), __NV_E4M3)));
}

// V elements: one vector load (V = 4, contiguous) or V scalar loads at
// the given offsets from p.
template <int V, typename T>
__device__ __forceinline__ void load(const T* p, const int (&off)[V],
                                     bool contiguous, float (&f)[V]) {
  if constexpr (V == 4) {
    if (contiguous) {
      load4(p + off[0], f);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(p + off[i]);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                       // relu
    case 2: return fminf(fmaxf(v, 0.f), 6.f);           // relu6
    case 3: return v / (1.f + expf(-v));                // silu
    default: return v;
  }
}

struct Args {
  const void* x;
  const void* w;
  const float* scale;   // (Cout), quantized body only
  const float* bias;    // (Cout) or null
  float* y;
  int H, W, Cin, KH, KW, cin_g, Cout, cout_g, stride, Ho, Wo, act;
  int strips, cvecs, total;   // Wo strips, channel vectors, threads
};

// XT / WT: element types of x and w; QUANT: multiply the sum by scale[co].
// V output channels and OW outputs along Wo a thread; K_T / S_T: the
// (square) kernel size and stride where they are compile-time (0:
// runtime).  A compile-time instance takes depthwise convs only (cout_g
// 1); its rows unroll, so all of a strip's loads are in flight at once.
template <typename XT, typename WT, bool QUANT, int V, int OW, int K_T,
          int S_T>
__global__ void __launch_bounds__(MAX_THREADS)
depthwise_conv_kernel(const Args a) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.total) return;
  const int cv = idx % a.cvecs;
  idx /= a.cvecs;
  const int strip = idx % a.strips;
  idx /= a.strips;
  const int ho = idx % a.Ho, img = idx / a.Ho;
  const int co = cv * V, wo0 = strip * OW;
  const int n_out = min(OW, a.Wo - wo0);
  const int KW = K_T ? K_T : a.KW;
  const int S = S_T ? S_T : a.stride;
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);

  // The first input channel of each output channel's group, and the
  // weight column of each output channel.
  int xc[V], wc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    xc[i] = ((co + i) / a.cout_g) * a.cin_g;
    wc[i] = co + i;
  }
  // Then xc[i] = co + i.  The compile-time instances take only depthwise
  // convs, so their loads carry no branch (a runtime one made the int8
  // loads wait on each other).
  const bool x_contig = K_T > 0 || a.cout_g == 1;

  float acc[OW][V];
#pragma unroll
  for (int o = 0; o < OW; ++o)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[o][i] = 0.f;

  const int KH = K_T ? K_T : a.KH;
#pragma unroll
  for (int u = 0; u < KH; ++u) {
    // input pixel (img, ho*s + u, wo0*s), channel 0
    const int pix = (img * a.H + ho * S + u) * a.W + wo0 * S;
    const XT* xr = x + pix * a.Cin;
    if constexpr (K_T > 0) {
      // The strip's input columns once, in registers.
      constexpr int WIN = (OW - 1) * S_T + K_T;
      float xw[WIN][V];
#pragma unroll
      for (int c = 0; c < WIN; ++c) {
        if (wo0 * S_T + c < a.W) {
          load<V>(xr + c * a.Cin, xc, x_contig, xw[c]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) xw[c][i] = 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < K_T; ++v) {
        float wv[V];
        load<V>(w + (u * K_T + v) * a.Cout, wc, true, wv);
#pragma unroll
        for (int o = 0; o < OW; ++o)
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[o][i] = fmaf(xw[o * S_T + v][i], wv[i], acc[o][i]);
      }
    } else {
      for (int v = 0; v < KW; ++v) {
        for (int ci = 0; ci < a.cin_g; ++ci) {
          float wv[V];
          load<V>(w + ((u * KW + v) * a.cin_g + ci) * a.Cout, wc, true, wv);
#pragma unroll
          for (int o = 0; o < OW; ++o) {
            if (o < n_out) {
              float xv[V];
              load<V>(xr + (o * S + v) * a.Cin + ci, xc, x_contig, xv);
#pragma unroll
              for (int i = 0; i < V; ++i)
                acc[o][i] = fmaf(xv[i], wv[i], acc[o][i]);
            }
          }
        }
      }
    }
  }

  float sc[V], bs[V];
  const int zero[V] = {};
  if constexpr (QUANT) load<V>(a.scale + co, zero, true, sc);
  if (a.bias != nullptr) load<V>(a.bias + co, zero, true, bs);
  float* yr = a.y + ((img * a.Ho + ho) * a.Wo + wo0) * a.Cout + co;
#pragma unroll
  for (int o = 0; o < OW; ++o) {
    if (o < n_out) {
      float r[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float s = acc[o][i];
        if constexpr (QUANT) s *= sc[i];
        if (a.bias != nullptr) s += bs[i];
        r[i] = activate(s, a.act);
      }
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(yr + o * a.Cout) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
        yr[o * a.Cout] = r[0];
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Launch the tile the plan names: vec (4 or 1) channels a thread, the
// square kernel size and stride instance (k_t, s_t; 0 0 for runtime ones),
// threads per block.
template <typename XT, typename WT, bool QUANT>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, float* y, int n, int h, int wd, int cin,
           int kh, int kw, int cin_g, int cout, int groups, int stride,
           int ho, int wo, int act, int vec, int k_t, int s_t, int threads,
           cudaStream_t stream) {
  if (groups <= 0 || cout % groups || threads <= 0 ||
      threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, scale, bias, y, h, wd, cin, kh, kw, cin_g, cout, cout / groups,
         stride, ho, wo, act, 0, 0, 0};
  const int ow = vec == 4 ? OW_VEC : 1;
  if (vec == 4) {
    // Four output channels from one load: one input channel per output
    // (cin_g 1), channel counts and pointers aligned to the vector.
    const bool ok =
        cin_g == 1 && cout % 4 == 0 && (a.cout_g > 1 || cin % 4 == 0) &&
        aligned(x, a.cout_g == 1 ? 4 * int(sizeof(XT)) : 1) &&
        aligned(w, 4 * int(sizeof(WT))) && aligned(scale, 16) &&
        aligned(bias, 16) && aligned(y, 16);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  } else if (vec != 1 || k_t != 0 || s_t != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k_t != 0 && (kh != k_t || kw != k_t || s_t != stride ||
                    a.cout_g != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.strips = (wo + ow - 1) / ow;
  a.cvecs = cout / vec;
  const long long total = (long long)n * ho * a.strips * a.cvecs;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.total = static_cast<int>(total);
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  void (*kernel)(Args) = nullptr;
  if (vec == 1) {
    kernel = depthwise_conv_kernel<XT, WT, QUANT, 1, 1, 0, 0>;
  } else if (k_t == 3 && s_t == 1) {
    kernel = depthwise_conv_kernel<XT, WT, QUANT, 4, OW_VEC, 3, 1>;
  } else if (k_t == 3 && s_t == 2) {
    kernel = depthwise_conv_kernel<XT, WT, QUANT, 4, OW_VEC, 3, 2>;
  } else if (k_t == 1 && s_t == 1) {
    kernel = depthwise_conv_kernel<XT, WT, QUANT, 4, OW_VEC, 1, 1>;
  } else if (k_t == 0 && s_t == 0) {
    kernel = depthwise_conv_kernel<XT, WT, QUANT, 4, OW_VEC, 0, 0>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N,H,W,G*cin_g), w (kh,kw,cin_g,G*cout_g), bias (Cout) or NULL,
// y (N,Ho,Wo,Cout); all fp32, contiguous, on the device of `stream`.
// act: 0 none, 1 relu, 2 relu6, 3 silu.  The plan: vec (4: four output
// channels a thread, 1: the scalar path), k_t and s_t (3 1, 3 2 or 1 1:
// the instance for that square kernel and stride, depthwise convs only;
// 0 0: any), threads per
// block (a multiple of 32, at most 256).  Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for a plan that does not fit.
extern "C" int depthwise_conv_f32(const float* x, const float* w,
                                  const float* bias, float* y, int n, int h,
                                  int wd, int cin, int kh, int kw, int cin_g,
                                  int cout, int groups, int stride, int ho,
                                  int wo, int act, int vec, int k_t,
                                  int s_t, int threads, void* stream) {
  return launch<float, float, false>(
      x, w, nullptr, bias, y, n, h, wd, cin, kh, kw, cin_g, cout, groups,
      stride, ho, wo, act, vec, k_t, s_t, threads,
      static_cast<cudaStream_t>(stream));
}

// The quantized variant: x fp32 (x_type 0) or int8 (1); w int8 (w_type 1)
// or fp8-e4m3 (2); scale (Cout) fp32, applied to the sum before the bias.
// Other shapes, arguments and the plan as depthwise_conv_f32.  Returns the
// launch's cudaError_t, or cudaErrorInvalidValue for a type pair or plan
// it does not take.
extern "C" int depthwise_conv_q(const void* x, const void* w,
                                const float* scale, const float* bias,
                                float* y, int n, int h, int wd, int cin,
                                int kh, int kw, int cin_g, int cout,
                                int groups, int stride, int ho, int wo,
                                int act, int x_type, int w_type, int vec,
                                int k_t, int s_t, int threads,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW_Q(XT, WT)                                                       \
  launch<XT, WT, true>(x, w, scale, bias, y, n, h, wd, cin, kh, kw, cin_g, \
                       cout, groups, stride, ho, wo, act, vec, k_t, s_t,  \
                       threads, st)
  if (x_type == 0 && w_type == 1) return DW_Q(float, int8_t);
  if (x_type == 1 && w_type == 1) return DW_Q(int8_t, int8_t);
  if (x_type == 0 && w_type == 2) return DW_Q(float, __nv_fp8_e4m3);
  if (x_type == 1 && w_type == 2) return DW_Q(int8_t, __nv_fp8_e4m3);
#undef DW_Q
  return static_cast<int>(cudaErrorInvalidValue);
}
