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
// in f32, so operations bound it: 0.069 ms at the 989 TFLOP/s bf16
// tensor-core rate, 0.416 ms for f32-accurate products at 165 TFLOP/s
// (3xTF32: three TF32 products at 495 TFLOP/s each).
//
// Design (PERF.md row 13): the products on the tensor cores by mma.sync
// (flash_mma.cuh). One block of 4 warps per (64-query tile, head); a warp
// owns 16 query rows, its O accumulator and its rows' m and l in registers.
// K and V come in tiles of 64 keys through a 2-stage cp.async ring in
// shared memory (the next tile's copy overlaps this tile's products), with
// the key mask beside them; Q is copied once. Per tile, S = Q K^T lands in
// C fragments (bf16: m16n8k16 from ldmatrix; f32: m16n8k8 in 3xTF32), is
// scaled and masked there (the last tile, masked tiles and the causal
// diagonal only), and the online softmax works on the fragments: a row lies
// in one quad, so its max takes two xor-shuffles, and each lane keeps its
// part of l until the end. P goes from the C fragments straight into A
// fragments (bf16: rounded to bf16, 2^-9 of each p; f32: split into tf32
// hi and lo), V is read by ldmatrix.trans (bf16) or in the relabelled k
// order (f32), and O = O * alpha + P V, one tile's product at a time as
// the Pallas kernel adds it. l sums the f32 p. Any T: keys past T score
// -1e30 and rows past T are not stored; cp.async fills rows past T with
// zeros. D < 16 is zero-padded to 16 in shared memory (exact zeros in the
// products) and only D columns are stored. Under causal masking a block
// skips the key tiles above its last row (in the Pallas kernel such a tile
// adds exactly nothing); blocks run heaviest (last query tiles) first. expf
// and logf, not the fast intrinsics. Q is read from shared memory by
// ldmatrix each tile rather than held in registers, which keeps D = 128
// within the register file. Tensors must be aligned to min(16, D * size)
// bytes (a cp.async copy); the launch returns cudaErrorMisalignedAddress
// otherwise.
//
// Measured (chip_smoke.py at the main shape, NVIDIA H100 80GB HBM3,
// 700.00 W): f32 1.960 ms against 5.626 for the CUDA-core design it
// replaced (21% of the bound), bf16 0.486 ms against 5.541 (14% of the
// bound; SDPA's forward 0.216 ms).
// 128 registers a thread in bf16 (four blocks an SM), 226 in f32, no
// spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "flash_mma.cuh"

namespace {

using namespace dl4j_mma;

// tiles and shared memory of flash_fwd: Q [BQ][S], a ring of two K and two
// V tiles [BK][S], two tiles of the key mask [BK]. BK is 32 for f32 at
// D = 128, where the O accumulator and the split P take the registers.
// kMinBlocks, the blocks an SM must hold, caps the registers a thread takes
// (65536 / (128 kMinBlocks)).
template <typename T, int D>
struct Fwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BQ = kWarps * kWarpRows, BK = !kBf16 && D == 128 ? 32 : 64;
  static constexpr int kMinBlocks = kBf16 && D <= 64 ? 4 : 1;
  static constexpr int DP = dpad<D>(), S = stride<T, D>();
  static constexpr size_t kSmem =
      static_cast<size_t>(BQ + 4 * BK) * S * sizeof(T) + 2 * BK * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlock, Fwd<T, D>::kMinBlocks)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
          int H, int T_len, int causal, float scale) {
  using F = Fwd<T, D>;
  constexpr int BK = F::BK, S = F::S, NJ = BK / 8, NN = F::DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + F::BQ * S;
  T* vs = ks + 2 * BK * S;
  float* ms = reinterpret_cast<float*>(vs + 2 * BK * S);

  const int bh = blockIdx.x, b = bh / H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * F::BQ;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wrow = row0 + warp * kWarpRows;  // this warp's first row
  const size_t base = static_cast<size_t>(bh) * T_len * D;
  const float* mrow = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * T_len;

  zero_pad<T, D, F::BQ + 4 * BK, S>(qs);
  const int last_row = min(row0 + F::BQ, T_len) - 1;
  const int n_tiles = ((causal ? last_row + 1 : T_len) + BK - 1) / BK;
  load_rows<T, D, F::BQ, S>(qs, q + base, row0, T_len);
  issue_kv<T, D, BK, S>(ks, vs, ms, k + base, v + base, mrow, 0, T_len);

  float o[NN][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue_kv<T, D, BK, S>(ks, vs, ms, k + base, v + base, mrow, it + 1, T_len);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = it & 1, k0 = it * BK;

    float s[NJ][4] = {};
    mma_nt<F::DP, NJ, S, S>(s, qs + warp * kWarpRows * S, ks + st * BK * S);
    // keys past T, masked, or (causal) after the row score -1e30; only the
    // last tile, masked tiles and the diagonal tile need the test
    const bool edge = k0 + BK > T_len || mrow != nullptr || (causal && k0 + BK - 1 > wrow);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = wrow + g + 8 * (e >> 1);
          const bool ok = key < T_len && (mrow == nullptr || ms[st * BK + key - k0] > 0.f) &&
                          (!causal || key <= row);
          if (!ok) s[j][e] = kNegInf;
        }
      }
    }
    float alpha[2];
    softmax_tile<NJ>(s, m, l, alpha);
    mma_pv<BK, NN, S>(o, s, vs + st * BK * S, alpha[0], alpha[1], 1.f);
    __syncthreads();  // every warp is done with this stage before it refills
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = row_total(l[r]);
    l_safe[r] = fmaxf(lt, 1e-30f);
    const int row = wrow + g + 8 * r;
    if (t == 0 && row < T_len) {
      const float m_fin = m[r] <= 0.5f * kNegInf ? 0.f : m[r];
      lse[static_cast<size_t>(bh) * T_len + row] = lt > 0.f ? m_fin + logf(l_safe[r]) : 0.f;
    }
  }
  store_rows<T, D, NN>(out + base, o, wrow, T_len, l_safe[0], l_safe[1]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int BH, int H, int T_len, int causal, float scale,
                   cudaStream_t stream) {
  using F = Fwd<T, D>;
  if (!aligned<T>(D, {q, k, v, out})) return cudaErrorMisalignedAddress;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F::kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (T_len + F::BQ - 1) / F::BQ);
  flash_fwd<T, D><<<grid, kBlock, F::kSmem, stream>>>(
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
