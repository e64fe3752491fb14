// Cross-channel local response normalization, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_lrn_fwd_impl (the
// pallas_call of _lrn_fwd_kernel) and _lrn_bwd (the pallas_call of
// _lrn_bwd_kernel). Over the trailing (channel) axis of x taken as
// [rows, C], rows = B*H*W of an NHWC activation, with the window
// W(c) = [c - n/2, c + n - 1 - n/2] (asymmetric for even n):
//   forward:  d = k + alpha * sum_{j in W(c)} x_j^2,   y = x * d^(-beta)
//   backward: dx = g * d^(-beta)
//                  - (2*alpha*beta) * x * sum_{j : c in W(j)} g_j x_j d_j^(-beta-1)
// where the backward's window is W reflected, [c - (n-1-n/2), c + n/2]
// (_window_sum_adjoint: the same window for odd n, one channel off for even
// n). Each operation is computed in f32 and rounded to the storage type where
// the plain PyTorch version (ops/lrn.py) rounds it, as the Pallas kernel
// computes in x's dtype: x*x, every partial sum of the window in order, the
// product with alpha, d, the power, y; and in the backward g*x, the power,
// t, every partial sum, (2ab)*x, both products and the difference. The
// constants k, alpha, -beta, -beta-1 and 2ab arrive already rounded to the
// storage type. __fmul_rn/__fadd_rn keep nvcc from contracting a pair into an
// FMA that the plain version does not have. d^e is powf (not
// exp2f(e*log2f(d))): torch's pow, which the plain version runs, is powf on
// the card, so the two agree bit for bit in f32.
//
// What bounds it on this card: bytes. The forward reads x and writes y (and
// d in training); the backward reads x, d and g and writes dx. About 30
// operations an element (two powf in the backward), far below the card's
// ridge: AlexNet's first LRN, [128, 56, 56, 96] f32, moves 462 MB in a
// training forward (0.138 ms at 3.35 TB/s) and 617 MB in the backward.
//
// Design: the TPU kernel takes tiles of 1024 rows with the channel axis
// whole. Here one block of 256 threads takes a tile of R = max(1, 4096/C)
// rows: the tile is one contiguous run of R*C elements, so the first pass
// reads it coalesced and stages x*x (forward) or t = g*x*d^(-beta-1)
// (backward) in shared memory, each computed once; after a barrier each
// thread takes elements of the run again and sums its window of n staged
// values from shared memory in registers, then reads its own x (and d, g)
// again, from L1, and writes the output coalesced. Shared memory is R*C*4
// bytes: 16 KB at most for C <= 4096; a larger C takes one row a block, up
// to 16384 channels (64 KB, above 48 KB by the dynamic-size attribute).
// Rows are independent: nothing crosses blocks. A template flag drops the
// store of d for serving, a third of the forward's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using dl4j::add;
using dl4j::ld;
using dl4j::mul;
using dl4j::rnd;
using dl4j::st;
using dl4j::sub;

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // staged floats per block (R*C) for C <= 4096
constexpr int kDefaultSmem = 48 * 1024;

inline int tile_rows(int C) { return C >= kTileElems ? 1 : kTileElems / C; }

template <typename T, bool kWriteD>
__global__ void __launch_bounds__(kThreads)
lrn_fwd(const T* __restrict__ x, T* __restrict__ y, T* __restrict__ d, long long rows, int C,
        int n, int R, float k, float alpha, float neg_beta) {
  extern __shared__ float staged[];  // x*x of the tile, rounded to T
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = rows - r0;
  const int elems = static_cast<int>(left < R ? left : R) * C;
  const size_t base = static_cast<size_t>(r0) * C;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const float v = ld(x, base + e);
    staged[e] = mul<T>(v, v);
  }
  __syncthreads();
  const int lo = n / 2;  // W(c) = [c - lo, c - lo + n - 1]
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int c = e % C;
    const float* row = staged + (e - c);
    float s = 0.0f;  // the channels outside [0, C) add 0, which leaves s as it is
    for (int j = 0; j < n; ++j) {
      const int cc = c - lo + j;
      if (cc >= 0 && cc < C) s = add<T>(s, row[cc]);
    }
    const float dd = add<T>(k, mul<T>(alpha, s));
    st(y, base + e, mul<T>(ld(x, base + e), rnd<T>(powf(dd, neg_beta))));
    if (kWriteD) st(d, base + e, dd);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd(const T* __restrict__ x, const T* __restrict__ d, const T* __restrict__ g,
        T* __restrict__ dx, long long rows, int C, int n, int R, float neg_beta,
        float neg_beta_m1, float two_ab) {
  extern __shared__ float staged[];  // t = (g*x) * d^(-beta-1) of the tile, rounded to T
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = rows - r0;
  const int elems = static_cast<int>(left < R ? left : R) * C;
  const size_t base = static_cast<size_t>(r0) * C;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const size_t i = base + e;
    staged[e] = mul<T>(mul<T>(ld(g, i), ld(x, i)), rnd<T>(powf(ld(d, i), neg_beta_m1)));
  }
  __syncthreads();
  const int lo = n - 1 - n / 2;  // the reflected window [c - lo, c - lo + n - 1]
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int c = e % C;
    const float* row = staged + (e - c);
    float s = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int cc = c - lo + j;
      if (cc >= 0 && cc < C) s = add<T>(s, row[cc]);
    }
    const size_t i = base + e;
    const float first = mul<T>(ld(g, i), rnd<T>(powf(ld(d, i), neg_beta)));
    const float second = mul<T>(mul<T>(two_ab, ld(x, i)), s);
    st(dx, i, sub<T>(first, second));
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, void* d, long long rows, int C, int n,
                       float k, float alpha, float neg_beta, cudaStream_t stream) {
  const int R = tile_rows(C);
  const size_t smem = static_cast<size_t>(R) * C * sizeof(float);
  const long long blocks = (rows + R - 1) / R;
  cudaError_t err;
  if (d != nullptr) {
    if ((err = prepare(lrn_fwd<T, true>, smem)) != cudaSuccess) return err;
    lrn_fwd<T, true><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(d), rows, C, n, R, k,
        alpha, neg_beta);
  } else {
    if ((err = prepare(lrn_fwd<T, false>, smem)) != cudaSuccess) return err;
    lrn_fwd<T, false><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), nullptr, rows, C, n, R, k, alpha,
        neg_beta);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* d, const void* g, void* dx, long long rows,
                       int C, int n, float neg_beta, float neg_beta_m1, float two_ab,
                       cudaStream_t stream) {
  const int R = tile_rows(C);
  const size_t smem = static_cast<size_t>(R) * C * sizeof(float);
  const long long blocks = (rows + R - 1) / R;
  cudaError_t err;
  if ((err = prepare(lrn_bwd<T>, smem)) != cudaSuccess) return err;
  lrn_bwd<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), static_cast<const T*>(g),
      static_cast<T*>(dx), rows, C, n, R, neg_beta, neg_beta_m1, two_ab);
  return cudaGetLastError();
}

}  // namespace

// y (and d, unless d is null) [rows, C] from x [rows, C], all of x's type
// (bf16 when bf16 is 1, else f32). k, alpha and -beta rounded to that type.
// Returns the CUDA error code of the launch, 0 when it launched.
extern "C" int dl4j_lrn_fwd(const void* x, void* y, void* d, int rows, int C, int n, int bf16,
                            float k, float alpha, float neg_beta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, y, d, rows, C, n, k, alpha, neg_beta, s);
  return launch_fwd<float>(x, y, d, rows, C, n, k, alpha, neg_beta, s);
}

// dx [rows, C] from x, d and g [rows, C], all of one type; -beta, -beta-1 and
// 2*alpha*beta rounded to that type.
extern "C" int dl4j_lrn_bwd(const void* x, const void* d, const void* g, void* dx, int rows,
                            int C, int n, int bf16, float neg_beta, float neg_beta_m1,
                            float two_ab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(x, d, g, dx, rows, C, n, neg_beta, neg_beta_m1, two_ab,
                                     s);
  return launch_bwd<float>(x, d, g, dx, rows, C, n, neg_beta, neg_beta_m1, two_ab, s);
}
