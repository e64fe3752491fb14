// Row-wise softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_sxent_fwd_impl (the
// pallas_call of _sxent_fwd_kernel) and _sxent_bwd (the pallas_call of
// _sxent_bwd_kernel). For each row of logits x [N, C] and labels lab [N, C],
// in f32 whatever the input type (promote(dtype, f32) for f32 and bf16):
//   m = max(x), s = sum(exp(x - m)), lse = log(s) + m
//   forward:  loss = -sum(lab * (x - lse))                 -> [N] f32
//   backward: p = exp(x - m) / s, logp = x - lse
//             dx = (p * sum(lab) - lab) * g   (in x's type)
//             dl = -logp * g                  (in lab's type)
// with g [N] the upstream gradient of the row losses.
//
// What bounds it on this card: a few operations per element against reading
// x and lab (and writing dx and dl), so bytes bound both: 12.6 MB forward and
// 25 MB backward at N=16384, C=96, f32 (PERF.md rows 10-11).
//
// Design: the TPU kernel takes a tile of 1024 rows and reduces along lanes.
// Here one warp owns one row; a block is 8 warps, 8 rows. The forward reads
// its row once into registers: each lane holds kChunks pieces of kVec
// consecutive columns (piece q = lane + 32 n), loaded 16 bytes at a time
// where every row starts 16-byte aligned and C is a multiple of kVec, else
// one element at a time; max, sum(exp) and the loss are warp shuffles over
// those registers. kChunks is the smallest of a few powers of two that
// holds the row (C up to 1024 either way); a wider row takes the loop
// kernel, three passes over the row through L1. The backward loops over its
// row in three passes, the row staying in L1 between them. Nothing crosses
// rows, so there is no exchange between blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using dl4j::ld;
using dl4j::st;

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max and sum(exp(x - max)) of one row, the same in every lane
template <typename TX>
__device__ __forceinline__ void row_stats(const TX* x, int C, int lane, float* m, float* s) {
  float mx = -INFINITY;
  for (int c = lane; c < C; c += 32) mx = fmaxf(mx, ld(x, c));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += expf(ld(x, c) - mx);
  *m = mx;
  *s = warp_sum(sum);
}

// the forward over rows wider than the register kernels take: three passes
template <typename TX, typename TL>
__global__ void __launch_bounds__(kThreads)
sxent_fwd_loop(const TX* __restrict__ x, const TL* __restrict__ lab, float* __restrict__ loss,
               int N, int C) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp leaves together
  const TX* xr = x + static_cast<size_t>(row) * C;
  const TL* lr = lab + static_cast<size_t>(row) * C;
  float m, s;
  row_stats(xr, C, lane, &m, &s);
  const float lse = logf(s) + m;
  float acc = 0.f;
  for (int c = lane; c < C; c += 32) acc += ld(lr, c) * (ld(xr, c) - lse);
  acc = warp_sum(acc);
  if (lane == 0) loss[row] = -acc;
}

// kVec elements of type T from p (aligned to the pack) into f32 registers
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};
template <typename T, int kVec>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[kVec]) {
  const Pack<T, kVec> pk = *reinterpret_cast<const Pack<T, kVec>*>(p);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = ld(pk.v, e);
}

// the forward with the row in registers: lane l holds columns
// [q kVec, q kVec + kVec) for q = l + 32 n, n < kChunks (C a multiple of
// kVec when kVec > 1)
template <typename TX, typename TL, int kVec, int kChunks>
__global__ void __launch_bounds__(kThreads)
sxent_fwd(const TX* __restrict__ x, const TL* __restrict__ lab, float* __restrict__ loss, int N,
          int C) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const TX* xr = x + static_cast<size_t>(row) * C;
  const TL* lr = lab + static_cast<size_t>(row) * C;
  float xv[kChunks][kVec], lv[kChunks][kVec];
  float mx = -INFINITY;
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    const int c0 = (lane + 32 * n) * kVec;
    if (c0 < C) {
      load_pack<TX, kVec>(xr + c0, xv[n]);
      load_pack<TL, kVec>(lr + c0, lv[n]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        xv[n][e] = -INFINITY;  // exp gives 0
        lv[n][e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) mx = fmaxf(mx, xv[n][e]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += expf(xv[n][e] - mx);
  const float lse = logf(warp_sum(sum)) + mx;
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
    if ((lane + 32 * n) * kVec < C)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc += lv[n][e] * (xv[n][e] - lse);
  acc = warp_sum(acc);
  if (lane == 0) loss[row] = -acc;
}

template <typename TX, typename TL>
__global__ void __launch_bounds__(kThreads)
sxent_bwd(const TX* __restrict__ x, const TL* __restrict__ lab, const float* __restrict__ g,
          TX* __restrict__ dx, TL* __restrict__ dl, int N, int C) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * C;
  float m, s;
  row_stats(x + base, C, lane, &m, &s);
  float lab_sum = 0.f;
  for (int c = lane; c < C; c += 32) lab_sum += ld(lab, base + c);
  lab_sum = warp_sum(lab_sum);
  const float lse = logf(s) + m;
  const float gr = g[row];
  for (int c = lane; c < C; c += 32) {
    const float xv = ld(x, base + c), lv = ld(lab, base + c);
    const float p = expf(xv - m) / s;
    st(dx, base + c, (p * lab_sum - lv) * gr);
    st(dl, base + c, -(xv - lse) * gr);
  }
}

template <typename TX, typename TL, int kVec, int kChunks>
void fwd(const void* x, const void* lab, void* loss, int N, int C, int blocks,
         cudaStream_t stream) {
  sxent_fwd<TX, TL, kVec, kChunks><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TL*>(lab), static_cast<float*>(loss), N, C);
}

// the register kernel whose kChunks (1, 2, 4, ... kMax) is the fewest that
// hold `chunks` pieces a lane; false when none does
template <typename TX, typename TL, int kVec, int kChunks, int kMax>
bool fwd_fits(int chunks, const void* x, const void* lab, void* loss, int N, int C, int blocks,
              cudaStream_t stream) {
  if (chunks <= kChunks) {
    fwd<TX, TL, kVec, kChunks>(x, lab, loss, N, C, blocks, stream);
    return true;
  }
  if constexpr (kChunks < kMax)
    return fwd_fits<TX, TL, kVec, 2 * kChunks, kMax>(chunks, x, lab, loss, N, C, blocks, stream);
  return false;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX, typename TL>
cudaError_t launch(bool backward, const void* x, const void* lab, const void* g, void* out,
                   void* dx, void* dl, int N, int C, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  if (backward) {
    sxent_bwd<TX, TL><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TL*>(lab), static_cast<const float*>(g),
        static_cast<TX*>(dx), static_cast<TL*>(dl), N, C);
    return cudaGetLastError();
  }
  // 16 bytes of the wider type a piece; every row starts aligned when the
  // arrays do and C is a multiple of the piece
  constexpr int kVec = 16 / static_cast<int>(sizeof(TX) > sizeof(TL) ? sizeof(TX) : sizeof(TL));
  const bool vec = C % kVec == 0 && aligned16(x) && aligned16(lab);
  const int per = vec ? kVec : 1;
  const int chunks = (C / per + 31) / 32;
  const bool fits = vec ? fwd_fits<TX, TL, kVec, 1, 8>(chunks, x, lab, out, N, C, blocks, stream)
                        : fwd_fits<TX, TL, 1, 1, 32>(chunks, x, lab, out, N, C, blocks, stream);
  if (!fits)
    sxent_fwd_loop<TX, TL><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TL*>(lab), static_cast<float*>(out), N, C);
  return cudaGetLastError();
}

cudaError_t dispatch(bool backward, const void* x, const void* lab, const void* g, void* out,
                     void* dx, void* dl, int N, int C, int x_bf16, int lab_bf16,
                     cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (x_bf16)
    return lab_bf16 ? launch<bf, bf>(backward, x, lab, g, out, dx, dl, N, C, s)
                    : launch<bf, float>(backward, x, lab, g, out, dx, dl, N, C, s);
  return lab_bf16 ? launch<float, bf>(backward, x, lab, g, out, dx, dl, N, C, s)
                  : launch<float, float>(backward, x, lab, g, out, dx, dl, N, C, s);
}

}  // namespace

// loss [N] f32 = row losses of x, lab [N, C] (each f32 or bf16). Returns the
// CUDA error code of the launch, 0 when it launched.
extern "C" int dl4j_softmax_xent_fwd(const void* x, const void* lab, void* loss, int N, int C,
                                     int x_bf16, int lab_bf16, void* stream) {
  return dispatch(false, x, lab, nullptr, loss, nullptr, nullptr, N, C, x_bf16, lab_bf16,
                  static_cast<cudaStream_t>(stream));
}

// dx (x's type) and dl (lab's type) [N, C] from g [N] f32.
extern "C" int dl4j_softmax_xent_bwd(const void* x, const void* lab, const void* g, void* dx,
                                     void* dl, int N, int C, int x_bf16, int lab_bf16,
                                     void* stream) {
  return dispatch(true, x, lab, g, nullptr, dx, dl, N, C, x_bf16, lab_bf16,
                  static_cast<cudaStream_t>(stream));
}
