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
// hundred MB: 1.54 and 2.05 ms at the 67 TFLOP/s f32 CUDA-core rate, 0.104
// and 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate.
//
// Design, simple and right first (PERF.md rows 14-15), in the layout of the
// forward (flash_attn.cuh): the dq kernel is one block per (query tile,
// head), its rows' q, dO and dq in registers, looping over tiles of 32 keys
// and values staged in shared memory; the dk/dv kernel one block per (key
// tile, head), its keys' k, v, dk and dv in registers, looping over tiles
// of 32 query rows of q and dO (with their lse and delta) in shared memory.
// Each output element has one owner thread, so there are no atomics and the
// results do not depend on the order of the blocks. Under causal masking
// the dq kernel skips key tiles above its last row and the dk/dv kernel
// query tiles before its first key; in the Pallas kernels those tiles add
// p = 0 exactly. The Pallas kernels' scaling of each tile's product before
// it is added to dq and dk is kept. Rows past T are neither computed into
// the sums nor stored (the Pallas wrapper pads them with dO = 0, which adds
// exactly nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "flash_attn.cuh"

namespace {

using namespace dl4j_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ mask, const T* __restrict__ o, const T* __restrict__ g,
             const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
             int H, int T_len, int causal, float scale) {
  using L = Layout<D>;
  __shared__ __align__(16) float ks[kTile * L::RS];
  __shared__ __align__(16) float vs[kTile * L::RS];
  __shared__ bool kval[kTile];

  const int bh = blockIdx.x, b = bh / H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * L::ROWS;  // heaviest tiles first
  const int part = threadIdx.x % L::TPR;
  const int r = row0 + threadIdx.x / L::TPR;
  const size_t base = static_cast<size_t>(bh) * T_len * D;

  float qr[L::DT], dor[L::DT], dqa[L::DT], tmp[L::DT];
  load_slice<D>(qr, q + base, r, part, T_len);
  load_slice<D>(dor, g + base, r, part, T_len);
  load_slice<D>(tmp, o + base, r, part, T_len);  // this row's out, for delta
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < L::DT; ++i) dsum = fmaf(dor[i], tmp[i], dsum);
  const float delta_r = row_sum<L::TPR>(dsum);
  float lse_r = 0.f;
  if (r < T_len) {
    lse_r = lse[static_cast<size_t>(bh) * T_len + r];
    if (part == 0) delta[static_cast<size_t>(bh) * T_len + r] = delta_r;
  }
#pragma unroll
  for (int i = 0; i < L::DT; ++i) dqa[i] = 0.f;

  const int last_row = min(row0 + L::ROWS, T_len) - 1;
  const int n_keys = causal ? last_row + 1 : T_len;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();
    stage<D>(ks, k + base, k0, T_len);
    stage<D>(vs, v + base, k0, T_len);
    if (threadIdx.x < kTile) kval[threadIdx.x] = key_ok(mask, b, k0 + threadIdx.x, T_len);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < L::DT; ++i) tmp[i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float* kj = ks + j * L::RS + part * L::SLICE;
      const float s = row_sum<L::TPR>(dot<L::DT>(qr, kj)) * scale;
      const bool ok = kval[j] && (!causal || r >= k0 + j);
      const float p = ok ? expf(s - lse_r) : 0.f;  // exp(-1e30 - lse) is 0
      const float dp = row_sum<L::TPR>(dot<L::DT>(dor, vs + j * L::RS + part * L::SLICE));
      axpy<L::DT>(tmp, p * (dp - delta_r), kj);
    }
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dqa[i] = __fadd_rn(dqa[i], __fmul_rn(tmp[i], scale));
  }

  if (r < T_len) {
    const size_t out = base + static_cast<size_t>(r) * D + part * L::DT;
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dl4j::st(dq, out + i, dqa[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mask, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int T_len, int causal,
              float scale) {
  using L = Layout<D>;
  __shared__ __align__(16) float qs[kTile * L::RS];
  __shared__ __align__(16) float gs[kTile * L::RS];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int bh = blockIdx.x, b = bh / H;
  const int key0 = blockIdx.y * L::ROWS;  // the first key tiles are the heaviest
  const int part = threadIdx.x % L::TPR;
  const int c = key0 + threadIdx.x / L::TPR;  // this thread's key
  const size_t base = static_cast<size_t>(bh) * T_len * D;

  float kr[L::DT], vr[L::DT], dka[L::DT], dva[L::DT], tmp[L::DT];
  load_slice<D>(kr, k + base, c, part, T_len);
  load_slice<D>(vr, v + base, c, part, T_len);
#pragma unroll
  for (int i = 0; i < L::DT; ++i) dka[i] = dva[i] = 0.f;
  const bool real = key_ok(mask, b, c, T_len);

  // under causal masking no row before key0 sees a key of this block
  const int first = causal ? (key0 / kTile) * kTile : 0;
  for (int q0 = first; q0 < T_len; q0 += kTile) {
    __syncthreads();
    stage<D>(qs, q + base, q0, T_len);
    stage<D>(gs, g + base, q0, T_len);
    if (threadIdx.x < kTile) {
      const int rq = q0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * T_len + rq;
      lse_s[threadIdx.x] = rq < T_len ? lse[at] : 0.f;
      delta_s[threadIdx.x] = rq < T_len ? delta[at] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < L::DT; ++i) tmp[i] = 0.f;
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const int rq = q0 + i;
      const float* qi = qs + i * L::RS + part * L::SLICE;
      const float* gi = gs + i * L::RS + part * L::SLICE;
      const float s = row_sum<L::TPR>(dot<L::DT>(kr, qi)) * scale;
      const bool ok = real && rq < T_len && (!causal || rq >= c);
      const float p = ok ? expf(s - lse_s[i]) : 0.f;  // exp(-1e30 - lse) is 0
      axpy<L::DT>(dva, p, gi);
      const float dp = row_sum<L::TPR>(dot<L::DT>(vr, gi));
      axpy<L::DT>(tmp, p * (dp - delta_s[i]), qi);
    }
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dka[i] = __fadd_rn(dka[i], __fmul_rn(tmp[i], scale));
  }

  if (c < T_len) {
    const size_t out = base + static_cast<size_t>(c) * D + part * L::DT;
#pragma unroll
    for (int i = 0; i < L::DT; ++i) {
      dl4j::st(dk, out + i, dka[i]);
      dl4j::st(dv, out + i, dva[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* o, const void* g, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int BH, int H, int T_len, int causal, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const dim3 grid(BH, (T_len + L::ROWS - 1) / L::ROWS);
  if (dq != nullptr) {
    flash_bwd_dq<T, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const T*>(o), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq), H,
        T_len, causal, scale);
  } else {
    flash_bwd_dkv<T, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, T_len, causal, scale);
  }
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
