// Tensor-core fragments shared by the port's kernels (sm_90a, mma.sync).
//
// One k-step of a product is 32 bytes of K: 16 bf16 values (m16n8k16) or 8
// f32 values (m16n8k8 tf32). A fragments come from shared memory through
// ldmatrix; B fragments are two 32-bit loads from a row that holds K
// contiguously, at byte offsets 4*tq and 4*tq + 16. Both addressings are the
// same in bytes for the two types, so a kernel body written in bytes serves
// both.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Per-type constants: values per k-step (32 bytes), per ldmatrix column half
// and per 16-byte row pad.
template <typename T>
struct Elems {
  static constexpr int kK = 32 / (int)sizeof(T);
  static constexpr int kHalf = 16 / (int)sizeof(T);
  static constexpr int kPad = 16 / (int)sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stores the pair (v0, v1) at p, rounded to T.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32 bits x -> (hi, lo), both tf32, with x = hi + lo to about 2^-22.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi[e]) : "f"(__uint_as_float(x[e])));
    const float r = __uint_as_float(x[e]) - __uint_as_float(hi[e]);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo[e]) : "f"(r));
  }
}

__device__ __forceinline__ uint32_t ld_b32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
