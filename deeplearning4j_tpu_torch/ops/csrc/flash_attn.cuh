// Pieces shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): the thread layout over rows and head dimensions, the
// staging of a tile of rows into shared memory, and the dot product of a
// thread's slice with a staged row.
//
// Layout. A row (a query row in the forward and dq kernels, a key row in
// the dk/dv kernel) belongs to TPR neighbouring threads of one warp, each
// holding DT = min(D, 16) of its D elements in registers; a block of
// kThreads threads owns ROWS = kThreads / TPR rows. A dot product over D is
// each thread's DT fused multiply-adds, then a butterfly of
// __shfl_xor_sync over the TPR threads, which leaves the same sum, bit for
// bit, in each of them (float addition is commutative). Keeping DT at 16
// holds a thread to 4-5 register vectors of 16 at every D up to 128, so
// nothing spills.
//
// Shared memory holds f32 (bf16 inputs widen when staged): row j's slice
// for thread part p starts at j * RS + p * SLICE. SLICE = DT + 4 pads each
// slice by 16 bytes, so the float4 loads of the TPR different slices that
// one quarter-warp issues for the same row fall on different banks; the
// threads of one part read the same address (a broadcast).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace dl4j_flash {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF, not -inf
constexpr int kThreads = 128;      // threads per block (four full warps)
constexpr int kTile = 32;          // rows per staged tile

template <int D>
struct Layout {
  static_assert(D == 4 || D == 8 || D == 16 || D == 32 || D == 64 || D == 128,
                "head dims instantiated: 4, 8, 16, 32, 64, 128");
  static constexpr int DT = D < 16 ? D : 16;  // elements per thread
  static constexpr int TPR = D / DT;          // threads per row
  static constexpr int ROWS = kThreads / TPR; // rows per block
  static constexpr int SLICE = DT + 4;        // shared floats per thread slice
  static constexpr int RS = TPR * SLICE;      // shared floats per staged row
};

// sum over the TPR threads of one row
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[0:DT] (registers) . s[0:DT] (shared, 16-byte aligned), in order of the
// elements
template <int DT>
__device__ __forceinline__ float dot(const float* a, const float* s) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DT; i += 4) {
    const float4 b = *reinterpret_cast<const float4*>(s + i);
    acc = fmaf(a[i], b.x, acc);
    acc = fmaf(a[i + 1], b.y, acc);
    acc = fmaf(a[i + 2], b.z, acc);
    acc = fmaf(a[i + 3], b.w, acc);
  }
  return acc;
}

// acc[0:DT] += w * s[0:DT] (shared, 16-byte aligned)
template <int DT>
__device__ __forceinline__ void axpy(float* acc, float w, const float* s) {
#pragma unroll
  for (int i = 0; i < DT; i += 4) {
    const float4 b = *reinterpret_cast<const float4*>(s + i);
    acc[i] = fmaf(w, b.x, acc[i]);
    acc[i + 1] = fmaf(w, b.y, acc[i + 1]);
    acc[i + 2] = fmaf(w, b.z, acc[i + 2]);
    acc[i + 3] = fmaf(w, b.w, acc[i + 3]);
  }
}

// rows [row0, row0 + kTile) of src [T, D] (one head) into dst in the shared
// layout, as f32, zeros past row T. Consecutive threads read consecutive
// elements.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int T_len) {
  using L = Layout<D>;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const int r = row0 + j;
    dst[j * L::RS + (d / L::DT) * L::SLICE + d % L::DT] =
        r < T_len ? dl4j::ld(src, static_cast<size_t>(r) * D + d) : 0.f;
  }
}

// this thread's slice of row r of src [T, D] (zeros past row T)
template <int D, typename T>
__device__ __forceinline__ void load_slice(float* dst, const T* src, int r, int part,
                                           int T_len) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < L::DT; ++i)
    dst[i] = r < T_len ? dl4j::ld(src, static_cast<size_t>(r) * D + part * L::DT + i) : 0.f;
}

// whether key c of batch row b is a real key: inside T and, with a key mask
// [B, T], mask > 0 (flash_attention.py: kmask > 0)
__device__ __forceinline__ bool key_ok(const float* mask, int b, int c, int T_len) {
  return c < T_len && (mask == nullptr || mask[static_cast<size_t>(b) * T_len + c] > 0.f);
}

}  // namespace dl4j_flash
