// Shared by the tensor-core kernels (merged_ffn.cu, flash_attention.cu,
// merged_conv.cu): cp.async copies into shared memory, how an operand
// type is stored and widened, the 3xTF32 split of an fp32 operand, one
// mma.sync m16n8k8 TF32 product with fp32 accumulation, and one m16n8k32
// int8 product with int32 accumulation.
#pragma once

#include <cuda_fp8.h>
#include <cstdint>

// 16 bytes from global into shared memory; zero-filled where !ok (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// 8 bytes, likewise.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}

// 4 bytes, likewise.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Elem<T>: how an element of T is stored (shared memory keeps it at its
// own width), whether it needs the hi/lo split, and its fp32 value.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using storage = float;
  static constexpr bool wide = true;
  static __device__ __forceinline__ float f32(float v) { return v; }
};
template <> struct Elem<int8_t> {
  using storage = int8_t;
  static constexpr bool wide = false;
  // Without the quarter-rate I2F: the bits 0x4B000000 + k are the float
  // 2^23 + k exactly for 0 <= k < 2^23, so with k = v + 128 one integer
  // add and one float subtraction give v exactly.
  static __device__ __forceinline__ float f32(int8_t v) {
    return __int_as_float(0x4B000080 + v) - 8388736.f;
  }
};
template <> struct Elem<__nv_fp8_e4m3> {
  using storage = uint8_t;
  static constexpr bool wide = false;
  static __device__ __forceinline__ float f32(uint8_t v) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(v), __NV_E4M3)));
  }
};

// hi (and, for a wide operand, lo) of one fragment element.  The mma
// reads the top 19 bits of a TF32 operand and ignores the low 13, so
// adding half a TF32 ulp (0x1000) to the bits rounds to nearest (ties
// away from zero, as cvt.rna.tf32.f32, which sm_90 emulates in four
// instructions).  hi's exact value (the bits masked) gives lo = f - hi
// exactly, and lo is rounded the same way: 4 instructions an element.
// a·b summed as lo·hi' + hi·lo' + hi·hi' (3xTF32) keeps fp32 accuracy:
// the dropped lo·lo' is 2^-22 of |a·b|.
template <bool WIDE>
__device__ __forceinline__ void split(float f, uint32_t& hi, uint32_t& lo) {
  if constexpr (WIDE) {
    const uint32_t h = __float_as_uint(f) + 0x1000u;
    hi = h;
    lo = __float_as_uint(f - __uint_as_float(h & 0xFFFFE000u)) + 0x1000u;
  } else {
    hi = __float_as_uint(f);   // exact in TF32
    lo = 0u;
  }
}

// c += a·b over one m16n8k8 tile.  Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b over one m16n8k32 tile of int8 codes, summed exactly in int32
// (no saturation: the caller keeps |sum| < 2^31).  A: registers 0 and 2
// hold row g's k 4t..4t+3 and 16+4t..16+4t+3, registers 1 and 3 row
// g + 8's; B: register 0 holds column g's k 4t..4t+3, register 1 its
// k 16+4t..; C as the TF32 product's (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
