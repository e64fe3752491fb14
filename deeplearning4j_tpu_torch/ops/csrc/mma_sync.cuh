// The tensor-core primitives of the port's mma.sync kernels: the cp.async
// copies, ldmatrix, the bf16 and tf32 mma.sync, the tf32 split and 3xTF32,
// and mma_nt, the product C = A B^T of two row-major tiles in shared
// memory. The flash-attention kernels (flash_mma.cuh, rows 13-15) and the
// LSTM sequence backward's per-step product (lstm_seq_bwd.cu, rows 7 and 9)
// take them from here.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"): lane
// l = 4 g + t (g = l / 4, t = l % 4) holds
//   C, m16n8 (f32):   c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g+8
//   A, m16n8k16 bf16: a0 row g, k 2t..2t+1; a1 row g+8; a2 row g, k 2t+8..;
//                     a3 row g+8, k 2t+8..
//   B, m16n8k16 bf16: b0 k 2t..2t+1, column g; b1 k 2t+8.., column g
//   A, m16n8k8 tf32:  a0 row g, k t; a1 row g+8, k t; a2 row g, k t+4;
//                     a3 row g+8, k t+4
//   B, m16n8k8 tf32:  b0 k t, column g; b1 k t+4, column g
// In f32 every product is 3xTF32: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
// small terms first, each product exact in the f32 accumulator; the lo lo
// term and the rounding of lo leave about 2^-21 of each product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dl4j_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// BYTES from src to dst in shared memory, or zeros where !pred
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- fragments
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both tf32 (round to nearest, ties away, as cvt.rna rounds)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a b in 3xTF32: the two small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --------------------------------------------------------------- products
// c[j] += A[16 x K] B[8 NJ x K]^T (columns 8j..8j+7); A's 16 rows from a
// (stride SA), B's 8 NJ rows from b (stride SB), both row-major in shared
// memory; K a multiple of 16
template <int K, int NJ, int SA, int SB>
__device__ __forceinline__ void mma_nt(float (&c)[NJ][4], const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  static_assert(K % 16 == 0 && NJ % 2 == 0, "bf16 tiles: k16 steps, pairs of n8");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * SA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * SB + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * p], af, bf[0], bf[1]);
      mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

template <int K, int NJ, int SA, int SB>
__device__ __forceinline__ void mma_nt(float (&c)[NJ][4], const float* a, const float* b) {
  static_assert(K % 8 == 0, "tf32 tiles: k8 steps");
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(a[g * SA + kk * 8 + t], ah[0], al[0]);
    split(a[(g + 8) * SA + kk * 8 + t], ah[1], al[1]);
    split(a[g * SA + kk * 8 + t + 4], ah[2], al[2]);
    split(a[(g + 8) * SA + kk * 8 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bh[2], bl[2];
      split(b[(8 * j + g) * SB + kk * 8 + t], bh[0], bl[0]);
      split(b[(8 * j + g) * SB + kk * 8 + t + 4], bh[1], bl[1]);
      mma_3xtf32(c[j], ah, al, bh, bl);
    }
  }
}

}  // namespace dl4j_mma
