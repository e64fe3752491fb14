// Flash-attention backward for Hopper (sm_90a): dq, then dk and dv.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py:_flash_bwd, its two
// pallas_calls: _dq_kernel (dq over key tiles) and _dkv_kernel (dk, dv over
// query tiles). From the forward's inputs q, k, v [BH, T, D] (f32 or bf16),
// the key mask [B, T] (or none), its out [BH, T, D] and lse [BH, T] (f32),
// and the upstream gradient g = dO [BH, T, D], everything in f32:
//   delta_i = sum_d dO_id * O_id                  (per query row)
//   s_ij = (q_i . k_j) * scale, -1e30 where masked (key mask, past T, causal)
//   p_ij = exp(s_ij - lse_i); dp_ij = dO_i . v_j; ds_ij = p_ij (dp_ij - delta_i)
//   dq_i = sum over key tiles of (sum_j ds_ij k_j) * scale
//   dk_j = sum over query tiles of (sum_i ds_ij q_i) * scale
//   dv_j = sum_i p_ij dO_i
// each stored once in the input type. A masked key has p = exp(-1e30 - lse)
// = 0 in every row, so its dk and dv are 0; a row with no real key has
// lse = 0 (the forward's rule), so p = exp(-1e30) = 0 and its dq is 0.
// delta is computed here by the dq kernel, for its own rows, and written to
// a [BH, T] f32 scratch that the dk/dv kernel reads after it (the JAX
// package computes it with a jnp.sum outside its kernels).
//
// What bounds it on this card: operations. Per (row, key) pair the dq
// kernel does three products of 2*D operations (recompute s, dp, ds k), the
// dk/dv kernel four (s, p^T dO, dp, ds^T q); at the main path's shape (B=4,
// H=8, T=4096, D=64, causal) that is 103 and 137 GFLOP against a few
// hundred MB: 0.104 and 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.624 and 0.833 ms at the 165 TFLOP/s of f32-accurate tensor-core
// products (3xTF32).
//
// Both kernels run their products on the tensor cores by mma.sync
// (flash_mma.cuh): bf16 as m16n8k16 with f32 sums, rounding P, dS and dS^T
// to bf16 (2^-9 of each) where they become operands; f32 as m16n8k8 TF32 in
// 3xTF32. D < 16 is zero-padded in shared memory. Each output element has
// one owner, so there are no atomics and the result does not depend on the
// order of the blocks. Tensors must be aligned to min(16, D * size) bytes
// (a cp.async copy); the launch returns cudaErrorMisalignedAddress
// otherwise.
//
// The dq kernel (PERF.md row 14) has the forward's shape. One block of 4
// warps per (64-query tile, head), heaviest tiles first; a warp owns 16
// query rows and their dQ accumulator in registers. The block's Q and dO
// are copied once into shared memory (the A operands); K and V come in
// tiles of 64 keys (32 in f32 at D = 128) through a 2-stage cp.async ring
// with the key mask beside them. A prologue forms delta for the block's
// rows (two threads a row, dO and O read from device memory), stores it for
// rows below T and keeps it in shared memory, where a lane finds its rows g
// and g+8. Per key tile, a warp SUB keys at a time:
//   S = Q K^T (mma_nt); P = exp(S * scale - lse), 0 where the key is not
//   real (past T it is zero-filled, and s = 0 would give exp(-lse)), is
//   masked or (causal) lies after the row: only the last tile, masked tiles
//   and the diagonal need the test;
//   dP = dO V^T (mma_nt); dS = P (dP - delta);
//   dQ += (dS K) * scale (mma_pv: dS packed from C to A fragments, K read by
//   ldmatrix.trans in bf16, in the relabelled k order in f32).
// Under causal masking the loop ends at the tile of the block's last row,
// and a warp skips a sub-tile wholly after its rows (it would add exactly
// 0). A row past T reads zeros and is not stored.
//
// The dk/dv kernel (PERF.md row 15): one block of 4 warps per (64-key tile,
// head); a warp owns 16 keys and their dK and dV accumulators in
// registers. The block's K and V are copied once; Q and dO come in tiles
// of query rows (64; 32 in bf16 at D = 64; 16 at D = 128, see Dkv) through
// a 2-stage cp.async ring, with their lse and delta. The scores are formed
// transposed, S^T = K Q^T, so that P^T and dS^T land in C fragments with
// the keys as rows and feed the next products as A fragments:
//   P^T = exp(S^T * scale - lse); dV += P^T dO
//   dP^T = V dO^T; dS^T = P^T (dP^T - delta); dK += (dS^T Q) * scale
// one tile's products added at a time as the Pallas kernel adds them. A
// query past T has q = 0 and lse = 0 in the ring, which would give p = 1,
// so it is masked explicitly, as are keys that are not real and (causal)
// queries before the key. Under causal masking the loop starts at the
// first query tile that can see the block's keys, and a warp skips a
// sub-tile of queries wholly before its keys (it would add exactly 0).
//
// Measured (chip_smoke.py at the main shape, NVIDIA H100 80GB HBM3,
// 700.00 W): the dk/dv kernel f32 3.965 ms against 7.549 for the CUDA-core
// design it replaced (21% of the bound), bf16 1.142 ms against 7.510 (12%
// of the bound; SDPA's whole forward and backward 0.733 ms); 168 registers
// a thread in bf16 (three blocks an SM), 221 in f32, no spills. The dq
// kernel: f32 3.358 ms against 6.561 for the CUDA-core design it replaced
// (a row over D/16 threads, f32 FMAs; now 19% of the bound), bf16 0.690 ms
// against 6.669 (15% of the bound; SDPA's whole forward and backward
// 0.775 ms); 122 registers a thread in bf16 (four blocks an SM), 253 in
// f32, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

namespace tc = dl4j_mma;

// tiles and shared memory of flash_bwd_dq: Q and dO of the block's rows
// [BQ][S], a ring of two K and two V tiles [BK][S], two tiles of the key
// mask [BK], the rows' delta [BQ]. A warp takes a stage's keys SUB at a
// time, so that its P, dP and dQ stay in registers: 32 at D >= 64. BK is 32
// for f32 at D = 128, as in the forward. kMinBlocks, the blocks an SM must
// hold, caps the registers a thread takes (65536 / (128 kMinBlocks)).
template <typename T, int D>
struct Dq {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BQ = tc::kWarps * tc::kWarpRows;
  static constexpr int BK = !kBf16 && D == 128 ? 32 : 64;
  static constexpr int SUB = D >= 64 ? 32 : BK;
  static constexpr int kMinBlocks = kBf16 ? (D <= 64 ? 4 : 2) : 1;
  static constexpr int DP = tc::dpad<D>(), S = tc::stride<T, D>();
  static constexpr size_t kSmem = static_cast<size_t>(2 * BQ + 4 * BK) * S * sizeof(T) +
                                  (2 * BK + BQ) * sizeof(float);
  static_assert(tc::kBlock == 2 * BQ, "the delta prologue takes two threads a row");
};

template <typename T, int D>
__global__ void __launch_bounds__(tc::kBlock, Dq<T, D>::kMinBlocks)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ mask, const T* __restrict__ o, const T* __restrict__ g,
             const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
             int H, int T_len, int causal, float scale) {
  using F = Dq<T, D>;
  constexpr int BQ = F::BQ, BK = F::BK, SUB = F::SUB, S = F::S, NJ = SUB / 8, NN = F::DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + BQ * S;
  T* ks = gs + BQ * S;      // [2][BK][S]
  T* vs = ks + 2 * BK * S;  // [2][BK][S]
  float* ms = reinterpret_cast<float*>(vs + 2 * BK * S);  // [2][BK]
  float* dsm = ms + 2 * BK;                                // [BQ]

  const int bh = blockIdx.x, b = bh / H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, t = lane & 3;
  const int wrow = row0 + warp * tc::kWarpRows;  // this warp's first row
  const size_t base = static_cast<size_t>(bh) * T_len * D;
  const float* mrow = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * T_len;

  tc::zero_pad<T, D, 2 * BQ + 4 * BK, S>(qs);
  const int last_row = min(row0 + BQ, T_len) - 1;
  const int n_tiles = ((causal ? last_row + 1 : T_len) + BK - 1) / BK;
  tc::load_rows<T, D, BQ, S>(qs, q + base, row0, T_len);
  tc::load_rows<T, D, BQ, S>(gs, g + base, row0, T_len);
  tc::issue_kv<T, D, BK, S>(ks, vs, ms, k + base, v + base, mrow, 0, T_len);

  // delta of the block's rows while the copies fly: two threads a row, each
  // half of the elements; stored for rows below T by one of them, and kept
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = row0 + r;
    float part = 0.f;
    if (row < T_len) {
      const size_t at = base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        const size_t i = at + 2 * j + half;
        part = fmaf(dl4j::ld(g, i), dl4j::ld(o, i), part);
      }
    }
    const float sum = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dsm[r] = sum;
      if (row < T_len) delta[static_cast<size_t>(bh) * T_len + row] = sum;
    }
  }
  __syncthreads();
  // this lane's rows g and g+8: their delta and lse (0 past T)
  float dl[2], ll[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + gr + 8 * r;
    dl[r] = dsm[warp * tc::kWarpRows + gr + 8 * r];
    ll[r] = row < T_len ? lse[static_cast<size_t>(bh) * T_len + row] : 0.f;
  }

  float dqa[NN][4] = {};
  const T* qw = qs + warp * tc::kWarpRows * S;
  const T* gw = gs + warp * tc::kWarpRows * S;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      tc::issue_kv<T, D, BK, S>(ks, vs, ms, k + base, v + base, mrow, it + 1, T_len);
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
#pragma unroll 1
    for (int h = 0; h < BK / SUB; ++h) {
      const int k0 = it * BK + h * SUB;  // this sub-tile's first key
      // under causal masking a sub-tile wholly after the warp's rows adds 0
      if (causal && k0 >= wrow + tc::kWarpRows) continue;
      const T* kt = ks + (st * BK + h * SUB) * S;
      const T* vt = vs + (st * BK + h * SUB) * S;
      const float* mt = ms + st * BK + h * SUB;

      // P = exp(S * scale - lse); a key past T (zero-filled: s = 0 would
      // give exp(-lse)), masked, or (causal) after the row gives p = 0
      float p[NJ][4] = {};
      tc::mma_nt<F::DP, NJ, S, S>(p, qw, kt);
      const bool edge = k0 + SUB > T_len || mrow != nullptr || (causal && k0 + SUB - 1 > wrow);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            ok = key < T_len && (mrow == nullptr || mt[key - k0] > 0.f) &&
                 (!causal || key <= wrow + gr + 8 * (e >> 1));
          }
          p[j][e] = ok ? expf(p[j][e] * scale - ll[e >> 1]) : 0.f;
        }
      }
      // dP = dO V^T; dS = P (dP - delta)
      float dp[NJ][4] = {};
      tc::mma_nt<F::DP, NJ, S, S>(dp, gw, vt);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - dl[e >> 1]);
      }
      // dQ += (dS K) * scale
      tc::mma_pv<SUB, NN, S>(dqa, dp, kt, 1.f, 1.f, scale);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  tc::store_rows<T, D, NN>(dq + base, dqa, wrow, T_len, 1.f, 1.f);
}

// tiles and shared memory of flash_bwd_dkv: K and V of the block's keys
// [BK][S], a ring of two Q and two dO tiles [BQ][S], two tiles of lse and
// of delta [BQ]. A warp takes a stage's queries SUB at a time, so that its
// P^T, dP^T, dK and dV stay in registers: at D = 64, 32 (bf16 within 168
// registers, three blocks an SM; f32 in stages of 64, the loop over the two
// halves not unrolled, which keeps the 3xTF32 code small); at D = 128,
// where dK and dV alone take 128 registers, 16. kMinBlocks, the blocks an
// SM must hold, caps the registers a thread takes (65536 / (128
// kMinBlocks)).
template <typename T, int D>
struct Dkv {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BK = tc::kWarps * tc::kWarpRows;
  static constexpr int BQ = D == 128 ? 16 : (D == 64 && kBf16 ? 32 : 64);
  static constexpr int SUB = D == 64 ? 32 : BQ;
  static constexpr int kMinBlocks = kBf16 && D == 64 ? 3 : 1;
  static constexpr int DP = tc::dpad<D>(), S = tc::stride<T, D>();
  static constexpr size_t kSmem = static_cast<size_t>(2 * BK + 4 * BQ) * S * sizeof(T) +
                                  4 * BQ * sizeof(float);
};

// query tile `tile` (q, dO, lse, delta) into stage tile % 2 of the ring:
// one cp.async group
template <typename T, int D>
__device__ __forceinline__ void issue_q(T* qs, T* gs, float* ls, float* ds, const T* q,
                                        const T* g, const float* lrow, const float* drow,
                                        int q0, int tile, int T_len) {
  using F = Dkv<T, D>;
  const int st = tile & 1;
  tc::load_rows<T, D, F::BQ, F::S>(qs + st * F::BQ * F::S, q, q0, T_len);
  tc::load_rows<T, D, F::BQ, F::S>(gs + st * F::BQ * F::S, g, q0, T_len);
  tc::load_vec<F::BQ>(ls + st * F::BQ, lrow, q0, T_len);
  tc::load_vec<F::BQ>(ds + st * F::BQ, drow, q0, T_len);
  tc::cp_commit();
}

template <typename T, int D>
__global__ void __launch_bounds__(tc::kBlock, Dkv<T, D>::kMinBlocks)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mask, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int T_len, int causal,
              float scale) {
  using F = Dkv<T, D>;
  constexpr int BQ = F::BQ, SUB = F::SUB, S = F::S, NJ = SUB / 8, NN = F::DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + F::BK * S;
  T* qs = vs + F::BK * S;   // [2][BQ][S]
  T* gs = qs + 2 * BQ * S;  // [2][BQ][S]
  float* ls = reinterpret_cast<float*>(gs + 2 * BQ * S);  // [2][BQ]
  float* ds = ls + 2 * BQ;                                 // [2][BQ]

  const int bh = blockIdx.x, b = bh / H;
  const int key0 = blockIdx.y * F::BK;  // the first key tiles are the heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, t = lane & 3;
  const int wkey = key0 + warp * tc::kWarpRows;  // this warp's first key
  const size_t base = static_cast<size_t>(bh) * T_len * D;
  const float* lrow = lse + static_cast<size_t>(bh) * T_len;
  const float* drow = delta + static_cast<size_t>(bh) * T_len;

  tc::zero_pad<T, D, 2 * F::BK + 4 * BQ, S>(ks);
  // whether this lane's keys (rows g and g+8) are real
  bool real[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) real[r] = tc::key_ok(mask, b, wkey + gr + 8 * r, T_len);

  // under causal masking no row before key0 sees a key of this block
  const int first = causal ? (key0 / BQ) * BQ : 0;
  const int n_tiles = (T_len - first + BQ - 1) / BQ;
  tc::load_rows<T, D, F::BK, S>(ks, k + base, key0, T_len);
  tc::load_rows<T, D, F::BK, S>(vs, v + base, key0, T_len);
  issue_q<T, D>(qs, gs, ls, ds, q + base, g + base, lrow, drow, first, 0, T_len);

  float dka[NN][4] = {}, dva[NN][4] = {};
  const T* kw = ks + warp * tc::kWarpRows * S;
  const T* vw = vs + warp * tc::kWarpRows * S;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue_q<T, D>(qs, gs, ls, ds, q + base, g + base, lrow, drow, first + (it + 1) * BQ,
                    it + 1, T_len);
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
#pragma unroll 1
    for (int h = 0; h < BQ / SUB; ++h) {
      const int q0 = first + it * BQ + h * SUB;  // this sub-tile's first query
      // under causal masking a sub-tile wholly before the warp's keys adds 0
      if (causal && q0 + SUB <= wkey) continue;
      const T* qt = qs + (st * BQ + h * SUB) * S;
      const T* gt = gs + (st * BQ + h * SUB) * S;
      const float* lt = ls + st * BQ + h * SUB;
      const float* dt = ds + st * BQ + h * SUB;

      // P^T = exp(S^T * scale - lse): keys in rows, the sub-tile's queries
      // in columns; a query past T (q = 0, lse = 0 would give p = 1), a key
      // that is not real, or (causal) a query before the key gives p = 0
      float p[NJ][4] = {};
      tc::mma_nt<F::DP, NJ, S, S>(p, kw, qt);
      const bool edge = q0 + SUB > T_len || (causal && q0 < wkey + tc::kWarpRows);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          bool ok = real[e >> 1];
          if (edge)
            ok = ok && q0 + col < T_len && (!causal || q0 + col >= wkey + gr + 8 * (e >> 1));
          p[j][e] = ok ? expf(p[j][e] * scale - lt[col]) : 0.f;
        }
      }
      // dV += P^T dO
      tc::mma_pv<SUB, NN, S>(dva, p, gt, 1.f, 1.f, 1.f);
      // dP^T = V dO^T; dS^T = P^T (dP^T - delta)
      float dp[NJ][4] = {};
      tc::mma_nt<F::DP, NJ, S, S>(dp, vw, gt);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - dt[8 * j + 2 * t + (e & 1)]);
      }
      // dK += (dS^T Q) * scale
      tc::mma_pv<SUB, NN, S>(dka, dp, qt, 1.f, 1.f, scale);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  tc::store_rows<T, D, NN>(dk + base, dka, wkey, T_len, 1.f, 1.f);
  tc::store_rows<T, D, NN>(dv + base, dva, wkey, T_len, 1.f, 1.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* o, const void* g, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int BH, int H, int T_len, int causal, float scale,
                   cudaStream_t stream) {
  if (dq != nullptr) {
    using F = Dq<T, D>;
    if (!tc::aligned<T>(D, {q, k, v, o, g, dq})) return cudaErrorMisalignedAddress;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F::kSmem));
    if (e != cudaSuccess) return e;
    const dim3 grid(BH, (T_len + F::BQ - 1) / F::BQ);
    flash_bwd_dq<T, D><<<grid, tc::kBlock, F::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const T*>(o), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq), H,
        T_len, causal, scale);
    return cudaGetLastError();
  }
  using F = Dkv<T, D>;
  if (!tc::aligned<T>(D, {q, k, v, g, dk, dv})) return cudaErrorMisalignedAddress;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F::kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid_dkv(BH, (T_len + F::BK - 1) / F::BK);
  flash_bwd_dkv<T, D><<<grid_dkv, tc::kBlock, F::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, T_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* mask,
                     const void* o, const void* g, const void* lse, void* delta, void* dq,
                     void* dk, void* dv, int BH, int H, int T_len, int causal, float scale,
                     cudaStream_t s) {
#define DL4J_FLASH_BWD(DIM)                                                                \
  case DIM:                                                                                \
    return launch<T, DIM>(q, k, v, mask, o, g, lse, delta, dq, dk, dv, BH, H, T_len, causal, \
                          scale, s);
  switch (D) {
    DL4J_FLASH_BWD(4)
    DL4J_FLASH_BWD(8)
    DL4J_FLASH_BWD(16)
    DL4J_FLASH_BWD(32)
    DL4J_FLASH_BWD(64)
    DL4J_FLASH_BWD(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DL4J_FLASH_BWD
}

}  // namespace

// dq [BH, T, D] (input type), and delta [BH, T] f32 as scratch for the dk/dv
// kernel, from q, k, v, out and g [BH, T, D] (f32, or bf16 with bf16 != 0),
// lse [BH, T] f32 and mask [B, T] f32 or null. Returns the CUDA error code
// of the launch, 0 when it launched.
extern "C" int dl4j_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* o, const void* g,
                                      const void* lse, void* delta, void* dq, int BH, int H,
                                      int T_len, int D, int causal, int bf16, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, mask, o, g, lse, delta, dq, nullptr, nullptr,
                                   BH, H, T_len, causal, scale, s);
  return dispatch<float>(D, q, k, v, mask, o, g, lse, delta, dq, nullptr, nullptr, BH, H,
                         T_len, causal, scale, s);
}

// dk and dv [BH, T, D] (input type) from q, k, v, g, lse, mask as above and
// the delta that dl4j_flash_attn_bwd_dq wrote (launch it first, on the same
// stream).
extern "C" int dl4j_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* g, const void* lse,
                                       const void* delta, void* dk, void* dv, int BH, int H,
                                       int T_len, int D, int causal, int bf16, float scale,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* d = const_cast<void*>(delta);
  if (bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, mask, nullptr, g, lse, d, nullptr, dk, dv, BH,
                                   H, T_len, causal, scale, s);
  return dispatch<float>(D, q, k, v, mask, nullptr, g, lse, d, nullptr, dk, dv, BH, H, T_len,
                         causal, scale, s);
}
