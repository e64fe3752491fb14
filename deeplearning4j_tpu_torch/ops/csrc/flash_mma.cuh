// Tensor-core pieces shared by the flash-attention forward (flash_attn.cu)
// and the dq and dk/dv backward kernels (flash_attn_bwd.cu): the cp.async
// tile ring, mma_pv, the masked online softmax on accumulator fragments,
// and the key test, over the primitives of mma_sync.cuh (cp.async,
// ldmatrix, mma.sync, the tf32 split, mma_nt).
//
// Layout. A block is four warps; a warp owns 16 rows (query rows in the
// forward and dq, key rows in dk/dv) and computes with mma.sync, whose fragments
// (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8") give lane
// l = 4 g + t (g = l / 4, t = l % 4) these elements:
//   C, m16n8 (f32):   c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g+8
//   A, m16n8k16 bf16: a0 row g, k 2t..2t+1; a1 row g+8; a2 row g, k 2t+8..;
//                     a3 row g+8, k 2t+8..
//   B, m16n8k16 bf16: b0 k 2t..2t+1, column g; b1 k 2t+8.., column g
//   A, m16n8k8 tf32:  a0 row g, k t; a1 row g+8, k t; a2 row g, k t+4;
//                     a3 row g+8, k t+4
//   B, m16n8k8 tf32:  b0 k t, column g; b1 k t+4, column g
// A row of the C fragment lies in one quad (the four lanes of one g), so a
// row's max and sum take __shfl_xor_sync over 1 and 2.
//
// Products. mma_nt forms C = A B^T with A (16 rows of the warp) and B (the
// tile) both row-major in shared memory over the head dim: S = Q K^T in the
// forward and dq, dP = dO V^T in dq, S^T = K Q^T and dP^T = V dO^T in dk/dv.
// mma_pv forms C = C * alpha + beta * (P X) with P the previous product's C
// fragments and X row-major [k][n] in shared memory: O += P V,
// dQ += (dS K) * scale, dV += P^T dO and dK += (dS^T Q) * scale, one tile's
// product added at a time as the Pallas kernels add it. In bf16 the C
// fragments of P pack straight into A fragments (two bf16 per register,
// columns 2t, 2t+1 are the A fragment's k pair) and X is read by
// ldmatrix.trans; B of mma_nt by ldmatrix. In f32
// every product is 3xTF32: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
// small terms first, each product exact in the f32 accumulator; the lo lo
// term and the rounding of lo leave about 2^-21 of each product. The tf32 A
// fragment wants k indices t and t+4 where the C fragment gives a lane
// columns 2t and 2t+1, so within each chunk of 8 the k index t stands for
// column 2t and t+4 for 2t+1, and X's rows are read in the same order: the
// product sums over k, so the relabelling changes nothing.
//
// Shared memory: a row of D elements (zero-padded to DP = max(D, 16), the
// k16 step of bf16) takes S = DP + 16 bytes of elements, so the 8 rows one
// ldmatrix reads, and the rows g (or 2t) of one tf32 fragment load, fall on
// different banks. Tiles arrive by cp.async, 16 bytes a copy (8 for bf16 at
// D = 4, a row being 8 bytes), with the source size 0 past T: those rows
// are zeros. The pad columns [D, DP) are written to zero once and never
// copied to.
#pragma once

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "mma_sync.cuh"

namespace dl4j_mma {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF, not -inf
constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;  // threads per block
constexpr int kWarpRows = 16;        // rows a warp owns

template <int D>
__host__ __device__ constexpr int dpad() { return D < 16 ? 16 : D; }
// shared row stride in elements: the padded head dim and 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int stride() { return dpad<D>() + 16 / static_cast<int>(sizeof(T)); }

// rows [r0, r0 + R) of src [T, D] into dst (R rows of stride S), zeros past
// row T; consecutive threads copy consecutive 16-byte pieces
template <typename T, int D, int R, int S>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int T_len) {
  constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  constexpr int kBytes = kRowBytes < 16 ? kRowBytes : 16;
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kCopies = D / kPer;                           // copies a row
  for (int i = threadIdx.x; i < R * kCopies; i += kBlock) {
    const int r = i / kCopies, c = (i % kCopies) * kPer;
    const bool in = r0 + r < T_len;
    cp_async<kBytes>(dst + r * S + c, in ? src + static_cast<size_t>(r0 + r) * D + c : src, in);
  }
}

// R floats of src from index i0 into dst, zeros past index n
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n) {
  for (int i = threadIdx.x; i < R; i += kBlock) {
    const bool in = i0 + i < n;
    cp_async<4>(dst + i, in ? src + i0 + i : src, in);
  }
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) { x = __float2bfloat16(0.f); }

// columns [D, DP) of R rows of stride S: zero (nothing when D >= 16)
template <typename T, int D, int R, int S>
__device__ __forceinline__ void zero_pad(T* buf) {
  constexpr int kPad = dpad<D>() - D;
  if constexpr (kPad > 0) {
    for (int i = threadIdx.x; i < R * kPad; i += kBlock) set_zero(buf[(i / kPad) * S + D + i % kPad]);
  }
}

// key tile `tile` (keys [tile BK, tile BK + BK) of k and v, and their mask
// when there is one) into stage tile % 2 of a ring of two [BK][S] tiles
// each: one cp.async group
template <typename T, int D, int BK, int S>
__device__ __forceinline__ void issue_kv(T* ks, T* vs, float* ms, const T* k, const T* v,
                                         const float* mrow, int tile, int T_len) {
  const int st = tile & 1, k0 = tile * BK;
  load_rows<T, D, BK, S>(ks + st * BK * S, k, k0, T_len);
  load_rows<T, D, BK, S>(vs + st * BK * S, v, k0, T_len);
  if (mrow != nullptr) load_vec<BK>(ms + st * BK, mrow, k0, T_len);
  cp_commit();
}

// whether key c of batch row b is a real key: inside T and, with a key mask
// [B, T], mask > 0 (flash_attention.py: kmask > 0)
__device__ __forceinline__ bool key_ok(const float* mask, int b, int c, int T_len) {
  return c < T_len && (mask == nullptr || mask[static_cast<size_t>(b) * T_len + c] > 0.f);
}

// --------------------------------------------------------------- products
// c[n] = c[n] * alpha + beta * (P X)[:, 8n..8n+7], P [16 x K] in the C
// fragments p (k in columns), X [K x 8 NN] row-major in shared memory
// (stride SX); alpha0 scales row g, alpha1 row g+8
template <int K, int NN, int SX>
__device__ __forceinline__ void mma_pv(float (&c)[NN][4], const float (&p)[K / 8][4],
                                       const __nv_bfloat16* x, float alpha0, float alpha1,
                                       float beta) {
  static_assert(K % 16 == 0 && NN % 2 == 0, "bf16 tiles: k16 steps, pairs of n8");
  const int lane = threadIdx.x % 32;
  uint32_t a[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
#pragma unroll
  for (int n = 0; n < NN / 2; ++n) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, x + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SX + n * 16 +
                                (lane >> 4) * 8);
      mma_bf16(t0, a[kk], bf[0], bf[1]);
      mma_bf16(t1, a[kk], bf[2], bf[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float al = e < 2 ? alpha0 : alpha1;
      c[2 * n][e] = c[2 * n][e] * al + t0[e] * beta;
      c[2 * n + 1][e] = c[2 * n + 1][e] * al + t1[e] * beta;
    }
  }
}

template <int K, int NN, int SX>
__device__ __forceinline__ void mma_pv(float (&c)[NN][4], const float (&p)[K / 8][4],
                                       const float* x, float alpha0, float alpha1, float beta) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  uint32_t ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {  // k index t is column 2t, t+4 is 2t+1
    split(p[kk][0], ah[kk][0], al[kk][0]);
    split(p[kk][2], ah[kk][1], al[kk][1]);
    split(p[kk][1], ah[kk][2], al[kk][2]);
    split(p[kk][3], ah[kk][3], al[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t bh[2], bl[2];
      split(x[(kk * 8 + 2 * t) * SX + n * 8 + g], bh[0], bl[0]);
      split(x[(kk * 8 + 2 * t + 1) * SX + n * 8 + g], bh[1], bl[1]);
      mma_3xtf32(acc, ah[kk], al[kk], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = c[n][e] * (e < 2 ? alpha0 : alpha1) + acc[e] * beta;
  }
}

// ------------------------------------------------------- online softmax
// One tile of scores s (C fragments, already scaled and masked to -1e30)
// for this lane's rows g (r = 0) and g+8 (r = 1): the running max m and the
// lane's part of the running sum l move to the tile, s becomes
// p = exp(s - m_safe), and alpha[r] is what the rows' accumulators are
// scaled by, with the Pallas kernel's guards:
//   m_new = max(m, max_j s_j); m_safe = m_new <= -5e29 ? 0 : m_new
//   alpha = exp((m <= -5e29 ? m_safe : m) - m_safe)
// A lane sums only its own columns; the quad's four parts are added at the
// end (row_total).
template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[r], tmax);
    const float m_safe = m_new <= 0.5f * kNegInf ? 0.f : m_new;
    alpha[r] = expf((m[r] <= 0.5f * kNegInf ? m_safe : m[r]) - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][2 * r] = expf(s[j][2 * r] - m_safe);
      s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_safe);
      psum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + psum;
    m[r] = m_new;
  }
}

// the sum over a quad (a C-fragment row's four lanes)
__device__ __forceinline__ float row_total(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ store
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the C fragments c (16 rows from r0, columns [0, 8 NN)) times 1 / div of
// each row into dst [T, D], rows below T and columns below D only
template <typename T, int D, int NN>
__device__ __forceinline__ void store_rows(T* dst, const float (&c)[NN][4], int r0, int T_len,
                                           float div0, float div1) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float div = r ? div1 : div0;
    if (row >= T_len) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        store_pair(dst + static_cast<size_t>(row) * D + col, c[n][2 * r] / div,
                   c[n][2 * r + 1] / div);
    }
  }
}

// whether every [T, D] pointer the kernels copy with cp.async, or store in
// pairs, is aligned to its copy size, min(16, D * sizeof(T)) bytes
template <typename T>
inline bool aligned(int D, std::initializer_list<const void*> ptrs) {
  const size_t row = static_cast<size_t>(D) * sizeof(T);
  const size_t a = row < 16 ? row : 16;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % a != 0) return false;
  return true;
}

}  // namespace dl4j_mma
