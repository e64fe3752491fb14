// Flash-attention forward for Hopper (sm_90a): out and lse.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py:_flash_call (the
// pallas_call of _fwd_kernel). For q, k, v [BH, T, D] (f32 or bf16; head bh
// of batch row b = bh / H) and an optional key mask [B, T] (> 0: a real key),
// per query row, everything in f32 whatever the input type:
//   s_j = (q . k_j) * scale, or -1e30 where key j is masked, past T, or
//         (causal) after the row
//   online softmax over tiles of keys, with the kernel's guards:
//     m_new = max(m, max_j s_j); m_safe = m_new <= -5e29 ? 0 : m_new
//     alpha = exp((m <= -5e29 ? m_safe : m) - m_safe)
//     p_j = exp(s_j - m_safe); acc = acc * alpha + sum_j p_j v_j
//     l = l * alpha + sum_j p_j
//   out = acc / max(l, 1e-30) in the input type
//   lse = l > 0 ? (m <= -5e29 ? 0 : m) + log(max(l, 1e-30)) : 0     (f32)
// so a row with no real key gives out = 0 and lse = 0, and the backward's
// exp(s - lse) is exp(-1e30) = 0 there. The sentinel is -1e30, not -inf:
// exp(-inf - -inf) would be NaN on rows that have seen no real key yet.
//
// What bounds it on this card: two products over the score tile (q k^T and
// p v), 4*D operations per (row, key) pair, against reading q, k, v once
// and writing out and lse. At the main path's shape (B=4, H=8, T=4096,
// D=64, causal: T(T+1)/2 pairs per head) that is 68.7 GFLOP against 134 MB
// in f32, so operations bound it: 1.03 ms at the 67 TFLOP/s f32 rate of the
// CUDA cores, 0.069 ms at the 989 TFLOP/s bf16 tensor-core rate.
//
// Design, simple and right first (PERF.md row 13). One block of 128
// threads per (query tile, head); a query row belongs to TPR threads, each
// holding DT = min(D, 16) elements of q and of the accumulator in registers
// (flash_attn.cuh). Tiles of 32 keys and values are staged in shared memory
// as f32 by coalesced loads; a thread reads them as float4 broadcasts. Per
// tile, each row's 32 scores stay in registers (the loop is unrolled), the
// tile's row max is taken first and then the tile is accumulated, as the
// Pallas kernel does per block. The products are f32 FMAs on the CUDA
// cores; rounding p to bf16 for the tensor cores would change the numerics
// (a later change, with its tolerance). Any T: the ragged edge is masked in the
// kernel (keys past T score -1e30, rows past T are not stored), without
// padding; the JAX wrapper's padding to a block multiple only adds masked
// keys and discarded rows. Under causal masking a block skips the key tiles
// that lie wholly above its last row: in the Pallas kernel such a tile adds
// exactly nothing (its scores are all -1e30, so alpha = 1 and p = 0). Blocks
// are scheduled heaviest (last query tiles) first. expf and logf, not the
// fast intrinsics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "flash_attn.cuh"

namespace {

using namespace dl4j_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
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

  float qr[L::DT], acc[L::DT];
  load_slice<D>(qr, q + base, r, part, T_len);
#pragma unroll
  for (int i = 0; i < L::DT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int last_row = min(row0 + L::ROWS, T_len) - 1;
  const int n_keys = causal ? last_row + 1 : T_len;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();  // the previous tile has been read by every thread
    stage<D>(ks, k + base, k0, T_len);
    stage<D>(vs, v + base, k0, T_len);
    if (threadIdx.x < kTile) kval[threadIdx.x] = key_ok(mask, b, k0 + threadIdx.x, T_len);
    __syncthreads();

    float s[kTile];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float sj = row_sum<L::TPR>(dot<L::DT>(qr, ks + j * L::RS + part * L::SLICE)) * scale;
      const bool ok = kval[j] && (!causal || r >= k0 + j);
      s[j] = ok ? sj : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float m_safe = m_new <= 0.5f * kNegInf ? 0.f : m_new;
    const float alpha = expf((m <= 0.5f * kNegInf ? m_safe : m) - m_safe);
#pragma unroll
    for (int i = 0; i < L::DT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - m_safe);
      psum += p;
      axpy<L::DT>(acc, p, vs + j * L::RS + part * L::SLICE);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (r < T_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    const size_t o = base + static_cast<size_t>(r) * D + part * L::DT;
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dl4j::st(out, o + i, acc[i] / l_safe);
    if (part == 0) {
      const float m_fin = m <= 0.5f * kNegInf ? 0.f : m;
      lse[static_cast<size_t>(bh) * T_len + r] = l > 0.f ? m_fin + logf(l_safe) : 0.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int BH, int H, int T_len, int causal, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const dim3 grid(BH, (T_len + L::ROWS - 1) / L::ROWS);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), H,
      T_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* mask,
                     void* out, void* lse, int BH, int H, int T_len, int causal, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    case 8: return launch<T, 8>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    case 16: return launch<T, 16>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [BH, T, D] (input type) and lse [BH, T] f32 of q, k, v [BH, T, D]
// (f32, or bf16 with bf16 != 0); mask [B, T] f32 or null; H heads per batch
// row. Returns the CUDA error code of the launch, 0 when it launched.
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse, int BH, int H,
                                   int T_len, int D, int causal, int bf16, float scale,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
  return dispatch<float>(D, q, k, v, mask, out, lse, BH, H, T_len, causal, scale, s);
}
