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
// computes in x's dtype: x*x, every partial sum of the window in j order, the
// product with alpha, d, the power, y; and in the backward g*x, the power,
// t, every partial sum, (2ab)*x, both products and the difference. The
// constants k, alpha, -beta, -beta-1 and 2ab arrive already rounded to the
// storage type. __fmul_rn/__fadd_rn keep nvcc from contracting a pair into an
// FMA that the plain version does not have. d^e is powf (not
// exp2f(e*log2f(d))): torch's pow, which the plain version runs, is powf on
// the card, so the two agree bit for bit in f32.
//
// What bounds it on this card: the SM's work, not bytes. The forward reads
// x and writes y (and d in training); the backward reads x, d and g and
// writes dx: AlexNet's first LRN, [128, 56, 56, 96] f32, moves 462 MB in a
// training forward (0.138 ms at 3.35 TB/s) and 617 MB in the backward. But
// powf, which must stay, is some 60-70 instructions an element (an
// extended-precision log2 and exp2), two in the backward; with device
// memory taken out of the way (scripts/torch_lrn_tiles.py's l2 variant) the
// bf16 kernels take the same time on an H100 (within 3%), and the f32 ones
// 87-89% of it (the serving forward all of it).
// So the design spends no instruction it can save: bf16 arithmetic on pairs
// (mul/add/sub.rn.bf16x2, one rounding each, no conversion instruction),
// the backward's two powers of one d computed together so that they share
// its log2, and in the fast path exponents the compiler knows.

// Design. The tensors are taken as one flat run of rows*C elements, cut
// into tiles of kThreads*kElems elements, in vectors of 16 bytes (4 f32 or
// 8 bf16). A thread loads its kElems elements of each input (kElems/V
// vectors, a warp 512 contiguous bytes a load), all before it uses the
// first, and keeps them in registers across the barrier: each input is read
// from device memory once. A block takes one tile; the blocks resident on an
// SM overlap one another's loads with their sums and powers.
// It stages x*x (forward) or t = (g*x)*d^(-beta-1) (backward) of its
// elements in shared memory, in the storage type, each computed once; a few
// threads stage the halo, the values a window reaches past the tile's ends
// (hl before, hr after, at most n-1 together), from device memory: the only
// elements read twice. After one barrier each thread sums the windows of its
// own elements and writes the outputs as 16-byte vectors. A tile need not
// hold whole rows, so every C takes the same path: a vector's channel
// follows from its tile's (one division a tile) and the thread's place in
// the tile (divided once), and a tap whose channel leaves [0, C) of its
// element's row adds nothing, as the plain version adds its zero padding
// (adding +0 leaves a sum that never is -0 as it is).
// - AlexNet's LRN, n = kFastN and beta = kFastBeta, over vectors that lie
//   inside one row (the wrapper's plan says "fast": C a multiple of the
//   vector and no head), sums its windows in registers: the vector's values
//   and its n-1 neighbours from shared memory, the neighbours outside the row
//   zeroed once a vector, then n adds an element (in bf16 a pair) with no
//   test; its powers take -0.75 and -1.75 as constants. Through the
//   general loop below the same windows take 28-50% longer in f32 and
//   76-86% in bf16 (H100, AlexNet's two LRN shapes; the sweep's fast_off
//   variant).
// - Every other window loops over the taps inside the row, from shared
//   memory.
// The wrapper's plan (ops/lrn.py: plan) gives the vector width (16 bytes, or
// one element where the pointers disagree modulo 16 bytes), the head (the
// elements before the first 16-byte-aligned element of every pointer) and
// the tile; the head and the ragged tail (fewer than a vector each) are
// taken one element at a time by the first block. The C entries check the
// plan against the pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using dl4j::add;
using dl4j::mul;
using dl4j::rnd;
using dl4j::sub;

constexpr int kThreads = 256;  // threads a block
constexpr int kElems = 8;      // elements of each input a thread holds a tile
constexpr int kFastN = 5;      // the window summed in registers (AlexNet's n) ...
constexpr float kFastBeta = 0.75f;  // ... under this beta, a constant of the powers
constexpr int kVecBytes = 16;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V elements of T as one access (16 bytes, or one element)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

// Two bf16 in one register, element 2i in the low half as a vector holds
// them. An operation on a pair rounds each result once, as the plain version
// rounds the f32 operation on two bf16 (a product of two bf16 is exact in f32;
// a sum that f32 rounds first still rounds to the same bf16), with no
// conversion instruction; the explicit .rn keeps ptxas from contracting a
// product and a sum into one rounding.
struct Bf2 {
  uint32_t v;
};
__device__ __forceinline__ float lo_of(Bf2 a) { return __uint_as_float(a.v << 16); }
__device__ __forceinline__ float hi_of(Bf2 a) { return __uint_as_float(a.v & 0xffff0000u); }
__device__ __forceinline__ Bf2 pack(float lo, float hi) {  // each rounded to bf16
  Bf2 r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r.v) : "f"(hi), "f"(lo));
  return r;
}
template <typename T>
__device__ __forceinline__ Bf2 mul(Bf2 a, Bf2 b) {
  Bf2 r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r.v) : "r"(a.v), "r"(b.v));
  return r;
}
template <typename T>
__device__ __forceinline__ Bf2 add(Bf2 a, Bf2 b) {
  Bf2 r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r.v) : "r"(a.v), "r"(b.v));
  return r;
}
template <typename T>
__device__ __forceinline__ Bf2 sub(Bf2 a, Bf2 b) {
  Bf2 r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r.v) : "r"(a.v), "r"(b.v));
  return r;
}
// powf(d, e) for each e of es, rounded to T: computed together, the
// backward's two powers of one d share its log2
template <typename T, int K>
__device__ __forceinline__ void powers(float d, const float (&es)[K], float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) r[i] = rnd<T>(powf(d, es[i]));
}
template <typename T, int K>
__device__ __forceinline__ void powers(Bf2 d, const float (&es)[K], Bf2 (&r)[K]) {
  float lo[K], hi[K];
  powers<T>(lo_of(d), es, lo);
  powers<T>(hi_of(d), es, hi);
#pragma unroll
  for (int i = 0; i < K; ++i) r[i] = pack(lo[i], hi[i]);
}
template <typename E>
__device__ __forceinline__ E splat(float v);
template <>
__device__ __forceinline__ float splat<float>(float v) { return v; }
template <>
__device__ __forceinline__ Bf2 splat<Bf2>(float v) { return pack(v, v); }

// The lanes of a vector, the values the arithmetic takes at once: pairs of
// bf16 where a vector holds 8, else single elements as f32
template <typename T, int V>
struct Lanes {
  using E = float;
  static constexpr int kN = V;
  __device__ __forceinline__ static void get(const Vec<T, V>& v, E (&l)[kN]) {
#pragma unroll
    for (int k = 0; k < V; ++k) l[k] = tof(v.e[k]);
  }
  __device__ __forceinline__ static Vec<T, V> put(const E (&l)[kN]) {
    Vec<T, V> v;
#pragma unroll
    for (int k = 0; k < V; ++k) v.e[k] = fromf<T>(l[k]);
    return v;
  }
  __device__ __forceinline__ static void of(const float (&f)[V], E (&l)[kN]) {
#pragma unroll
    for (int k = 0; k < V; ++k) l[k] = f[k];
  }
};
template <>
struct Lanes<__nv_bfloat16, 8> {
  using E = Bf2;
  static constexpr int kN = 4;
  __device__ __forceinline__ static void get(const Vec<__nv_bfloat16, 8>& v, E (&l)[kN]) {
    memcpy(l, &v, sizeof(v));
  }
  __device__ __forceinline__ static Vec<__nv_bfloat16, 8> put(const E (&l)[kN]) {
    Vec<__nv_bfloat16, 8> v;
    memcpy(&v, l, sizeof(v));
    return v;
  }
  __device__ __forceinline__ static void of(const float (&f)[8], E (&l)[kN]) {
#pragma unroll
    for (int p = 0; p < kN; ++p) l[p] = pack(f[2 * p], f[2 * p + 1]);  // exact: bf16 values
  }
};

// where a launch's elements lie: set by the C entries from n, C and the plan
struct Geometry {
  int total;   // rows * C
  int C, n;
  int lo;      // the window of channel c starts at c - lo
  int head;    // elements before the first vector
  int hl, hr;  // halo: the staged values a window reaches before and after a tile
  int pad;     // hl rounded up to 16 bytes: the staged tile starts aligned
};

// y (and d) from x, on lanes E. stage gives the value the windows sum and
// kKeep values that finish takes back; kFast: the exponents are -kFastBeta
// and -kFastBeta-1, which the compiler then knows (the fast path's plan holds
// beta to it)
template <typename T_, bool kWriteD>
struct FwdOp {
  using T = T_;
  static constexpr int kIn = 1, kOut = kWriteD ? 2 : 1, kKeep = 0;
  static constexpr bool kReflected = false;
  const T* in[kIn];  // x
  T* out[kOut];      // y, d
  float k, alpha, neg_beta;

  template <bool kFast, typename E>
  __device__ __forceinline__ E stage(const E (&v)[kIn], E (&)[kKeep + 1]) const {
    return mul<T>(v[0], v[0]);
  }
  template <bool kFast, typename E>
  __device__ __forceinline__ void finish(const E (&v)[kIn], const E (&)[kKeep + 1], E s,
                                         E (&r)[kOut]) const {
    const E dd = add<T>(splat<E>(k), mul<T>(splat<E>(alpha), s));
    const float es[1] = {kFast ? -kFastBeta : neg_beta};
    E p[1];
    powers<T>(dd, es, p);
    r[0] = mul<T>(v[0], p[0]);
    if constexpr (kWriteD) r[1] = dd;
  }
};

// dx from x, d and g, on lanes E: stage takes both powers of d and keeps
// d^(-beta) for finish
template <typename T_>
struct BwdOp {
  using T = T_;
  static constexpr int kIn = 3, kOut = 1, kKeep = 1;
  static constexpr bool kReflected = true;
  const T* in[kIn];  // x, d, g
  T* out[kOut];      // dx
  float neg_beta, neg_beta_m1, two_ab;

  template <bool kFast, typename E>
  __device__ __forceinline__ E stage(const E (&v)[kIn], E (&keep)[kKeep + 1]) const {
    const float es[2] = {kFast ? -kFastBeta - 1.0f : neg_beta_m1, kFast ? -kFastBeta : neg_beta};
    E p[2];
    powers<T>(v[1], es, p);
    keep[0] = p[1];
    return mul<T>(mul<T>(v[2], v[0]), p[0]);
  }
  template <bool kFast, typename E>
  __device__ __forceinline__ void finish(const E (&v)[kIn], const E (&keep)[kKeep + 1], E s,
                                         E (&r)[kOut]) const {
    const E first = mul<T>(v[2], keep[0]);
    const E second = mul<T>(mul<T>(splat<E>(two_ab), v[0]), s);
    r[0] = sub<T>(first, second);
  }
};

// the staged value of element p, from device memory
template <class Op>
__device__ __forceinline__ float stage_at(const Op& op, int p) {
  float v[Op::kIn], keep[Op::kKeep + 1];
#pragma unroll
  for (int j = 0; j < Op::kIn; ++j) v[j] = tof(op.in[j][p]);
  return op.template stage<false>(v, keep);
}

// one element of the head or the tail, its window read from device memory
template <class Op>
__device__ void element(const Op& op, const Geometry& geo, int i) {
  using T = typename Op::T;
  const int c = i % geo.C;
  const int jlo = max(0, geo.lo - c), jhi = min(geo.n, geo.C + geo.lo - c);
  float s = 0.0f;
  for (int j = jlo; j < jhi; ++j) s = add<T>(s, stage_at(op, i - geo.lo + j));
  float v[Op::kIn], keep[Op::kKeep + 1], r[Op::kOut];
#pragma unroll
  for (int j = 0; j < Op::kIn; ++j) v[j] = tof(op.in[j][i]);
  op.template stage<false>(v, keep);
  op.template finish<false>(v, keep, s, r);
#pragma unroll
  for (int j = 0; j < Op::kOut; ++j) op.out[j][i] = fromf<T>(r[j]);
}

// s = the window sums of the lanes of the vector of staged elements e0 ...
// e0 + V - 1, whose first channel is c0 (wrapping into the next row at C),
// each in j order over the taps inside its row
template <typename T, int V, int N, int L>
__device__ __forceinline__ void window_sums(const T* st, int e0, int c0, const Geometry& geo,
                                            typename Lanes<T, V>::E (&s)[Lanes<T, V>::kN]) {
  using E = typename Lanes<T, V>::E;
  if constexpr (N > 0 && std::is_same<E, Bf2>::value) {
    // n == N, lo == L, the vector inside one row, as pairs: a neighbouring
    // pair outside the row is outside the window of all V elements (C and
    // c0 are even, so a pair is inside or outside whole); tap j of pair p
    // is word p + j/2, or for odd j its high half and the next word's low
    static_assert(L % 2 == 0 && (N - 1 - L) % 2 == 0, "taps in pairs");
    constexpr int kW = (V + N - 1) / 2;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(st + e0);
    uint32_t w[kW];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const bool in = c0 - L + 2 * i >= 0;
      const uint32_t v = sw[in ? i - L / 2 : 0];
      w[i] = in ? v : 0u;
    }
    const uint4 own = *reinterpret_cast<const uint4*>(sw);
    w[L / 2] = own.x;
    w[L / 2 + 1] = own.y;
    w[L / 2 + 2] = own.z;
    w[L / 2 + 3] = own.w;
#pragma unroll
    for (int i = 0; i < (N - 1 - L) / 2; ++i) {
      const bool in = c0 + V + 2 * i < geo.C;
      const uint32_t v = sw[in ? V / 2 + i : 0];
      w[L / 2 + V / 2 + i] = in ? v : 0u;
    }
#pragma unroll
    for (int p = 0; p < V / 2; ++p) {
      Bf2 a{0u};
#pragma unroll
      for (int j = 0; j < N; ++j)
        a = add<T>(a, Bf2{j % 2 == 0 ? w[p + j / 2]
                                     : __byte_perm(w[p + j / 2], w[p + j / 2 + 1], 0x5432)});
      s[p] = a;
    }
  } else if constexpr (N > 0) {
    // the same, element by element: a neighbour outside the row is outside
    // the window of all V elements
    float w[V + N - 1];
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const bool in = c0 - L + m >= 0;
      const float v = tof(st[in ? e0 - L + m : e0]);
      w[m] = in ? v : 0.0f;
    }
    const Vec<T, V> own = *reinterpret_cast<const Vec<T, V>*>(st + e0);
#pragma unroll
    for (int k = 0; k < V; ++k) w[L + k] = tof(own.e[k]);
#pragma unroll
    for (int m = 0; m < N - 1 - L; ++m) {
      const bool in = c0 + V + m < geo.C;
      const float v = tof(st[in ? e0 + V + m : e0]);
      w[L + V + m] = in ? v : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) a = add<T>(a, w[k + j]);
      s[k] = a;
    }
  } else {
    float f[V];
    int c = c0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int jlo = max(0, geo.lo - c), jhi = min(geo.n, geo.C + geo.lo - c);
      const T* p = st + (e0 + k - geo.lo);
      float a = 0.0f;
      for (int j = jlo; j < jhi; ++j) a = add<T>(a, tof(p[j]));
      f[k] = a;
      if (++c == geo.C) c = 0;
    }
    Lanes<T, V>::of(f, s);
  }
}

// this thread's vectors of tile t of every input: vector u is the tile's
// vector u*kThreads + threadIdx.x, so a warp's load is 32 neighbouring vectors
template <class Op, int V>
__device__ __forceinline__ void load_tile(const Op& op, int head, int t, int nvec,
                                          Vec<typename Op::T, V> (&r)[Op::kIn][kElems / V]) {
  constexpr int kVecs = kElems / V;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int q = t * (kThreads * kVecs) + u * kThreads + threadIdx.x;
    if (q < nvec) {
#pragma unroll
      for (int j = 0; j < Op::kIn; ++j)
        r[j][u] = reinterpret_cast<const Vec<typename Op::T, V>*>(op.in[j] + head)[q];
    }
  }
}

// the walk of one block over its tiles (lrn_fwd and lrn_bwd below)
template <class Op, int V, int N>
__device__ __forceinline__ void walk_tiles(const Op& op, const Geometry& geo) {
  using T = typename Op::T;
  using VT = Vec<T, V>;
  using Ln = Lanes<T, V>;
  using E = typename Ln::E;
  constexpr int kIn = Op::kIn, kOut = Op::kOut, kL = Ln::kN;
  constexpr int kVecs = kElems / V;  // this thread's vectors of each input a tile
  constexpr int kTileVecs = kThreads * kVecs;
  constexpr bool kFast = N > 0;
  constexpr int L = N == 0 ? 0 : (Op::kReflected ? N - 1 - N / 2 : N / 2);
  extern __shared__ __align__(16) unsigned char smem[];
  T* const st = reinterpret_cast<T*>(smem) + geo.pad;  // staged [-hl, len + hr)
  const int tid = threadIdx.x;
  const int nvec = (geo.total - geo.head) / V;
  const int body_end = geo.head + nvec * V;
  const int tiles = (nvec + kTileVecs - 1) / kTileVecs;
  if (blockIdx.x == 0 && tid < geo.head + geo.total - body_end)
    element(op, geo, tid < geo.head ? tid : body_end + tid - geo.head);

  int m[kVecs];  // channel of each of this thread's vectors past its tile's first
#pragma unroll
  for (int u = 0; u < kVecs; ++u) m[u] = ((u * kThreads + tid) * V) % geo.C;

  VT cur[kIn][kVecs];
  E keep[kVecs][kL][Op::kKeep + 1];  // what staging keeps for finish
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    load_tile<Op, V>(op, geo.head, t, nvec, cur);
    const int start = geo.head + t * kTileVecs * V;
    const int len = min(kTileVecs * V, body_end - start);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int q = u * kThreads + tid;
      if (t * kTileVecs + q < nvec) {
        E in[kIn][kL], sv[kL];
#pragma unroll
        for (int j = 0; j < kIn; ++j) Ln::get(cur[j][u], in[j]);
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          E v[kIn];
#pragma unroll
          for (int j = 0; j < kIn; ++j) v[j] = in[j][l];
          sv[l] = op.template stage<kFast>(v, keep[u][l]);
        }
        reinterpret_cast<VT*>(st)[q] = Ln::put(sv);
      }
    }
    for (int h = tid; h < geo.hl + geo.hr; h += kThreads) {
      const int p = h < geo.hl ? start - geo.hl + h : start + len + (h - geo.hl);
      st[p - start] = fromf<T>(p >= 0 && p < geo.total ? stage_at(op, p) : 0.0f);
    }
    __syncthreads();
    const int ct = start % geo.C;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int q = u * kThreads + tid;
      if (t * kTileVecs + q < nvec) {
        int c0 = ct + m[u];
        if (c0 >= geo.C) c0 -= geo.C;
        E s[kL], in[kIn][kL], o[kOut][kL];
        window_sums<T, V, N, L>(st, q * V, c0, geo, s);
#pragma unroll
        for (int j = 0; j < kIn; ++j) Ln::get(cur[j][u], in[j]);
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          E v[kIn], r[kOut];
#pragma unroll
          for (int j = 0; j < kIn; ++j) v[j] = in[j][l];
          op.template finish<kFast>(v, keep[u][l], s[l], r);
#pragma unroll
          for (int j = 0; j < kOut; ++j) o[j][l] = r[j];
        }
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          reinterpret_cast<VT*>(op.out[j] + geo.head)[t * kTileVecs + q] = Ln::put(o[j]);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kWriteD, int V, int N>
__global__ void __launch_bounds__(kThreads) lrn_fwd(const FwdOp<T, kWriteD> op,
                                                    const Geometry geo) {
  walk_tiles<FwdOp<T, kWriteD>, V, N>(op, geo);
}

template <typename T, int V, int N>
__global__ void __launch_bounds__(kThreads) lrn_bwd(const BwdOp<T> op, const Geometry geo) {
  walk_tiles<BwdOp<T>, V, N>(op, geo);
}

template <int V, int N, typename T, bool kWriteD>
auto kernel_of(const FwdOp<T, kWriteD>&) { return lrn_fwd<T, kWriteD, V, N>; }
template <int V, int N, typename T>
auto kernel_of(const BwdOp<T>&) { return lrn_bwd<T, V, N>; }

template <class Op, int V, int N>
cudaError_t launch(const Op& op, Geometry geo, cudaStream_t stream) {
  using T = typename Op::T;
  constexpr int kTileVecs = kThreads * kElems / V;
  constexpr int kAlign = kVecBytes / static_cast<int>(sizeof(T));
  geo.pad = (geo.hl + kAlign - 1) / kAlign * kAlign;
  const int nvec = (geo.total - geo.head) / V;
  int grid = (nvec + kTileVecs - 1) / kTileVecs;
  if (grid < 1) grid = 1;  // the first block takes the head and the tail
  const size_t smem = static_cast<size_t>(geo.pad + kTileVecs * V + geo.hr) * sizeof(T);
  const auto kernel = kernel_of<V, N>(op);
  cudaError_t err;
  if (smem > kDefaultSmem &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  kernel<<<grid, kThreads, smem, stream>>>(op, geo);
  return cudaGetLastError();
}

// The plan's checks: vec 16 bytes of T or 1, head < vec, tile =
// kThreads*kElems, "fast" only where its window and its powers run
// (n == kFastN, the exponents -kFastBeta and -kFastBeta-1, every vector
// inside a row), and every pointer 16-byte aligned at the head's end where
// there is a vector (cudaErrorMisalignedAddress where one is not).
template <typename T>
cudaError_t check_plan(std::initializer_list<const void*> ptrs,
                       std::initializer_list<float> powers, int rows, int C, int n, int vec,
                       int head, int tile, int fast) {
  constexpr int kWide = kVecBytes / static_cast<int>(sizeof(T));
  const long long total = static_cast<long long>(rows) * C;
  if (rows < 1 || C < 1 || n < 1 || total >= (1LL << 31) || (vec != 1 && vec != kWide) ||
      head < 0 || head >= vec || head > total || tile != kThreads * kElems)
    return cudaErrorInvalidValue;
  if (fast) {
    float want = -kFastBeta;
    for (const float e : powers) {
      if (e != want) return cudaErrorInvalidValue;
      want -= 1.0f;
    }
    if (!(n == kFastN && vec == kWide && head == 0 && C % vec == 0))
      return cudaErrorInvalidValue;
  }
  const bool vectors = (total - head) / vec > 0;
  for (const void* p : ptrs) {
    if (p == nullptr) continue;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (a % sizeof(T) != 0 || (vectors && (a + head * sizeof(T)) % (vec * sizeof(T)) != 0))
      return cudaErrorMisalignedAddress;
  }
  return cudaSuccess;
}

Geometry geometry(int rows, int C, int n, int lo, int head) {
  Geometry g{};
  g.total = rows * C;
  g.C = C;
  g.n = n;
  g.lo = lo;
  g.head = head;
  g.hl = lo < C - 1 ? lo : C - 1;  // a tap farther than C-1 is in another row
  g.hr = n - 1 - lo < C - 1 ? n - 1 - lo : C - 1;
  return g;
}

template <class Op>
cudaError_t dispatch(const Op& op, const Geometry& geo, int vec, int fast, cudaStream_t s) {
  constexpr int kWide = kVecBytes / static_cast<int>(sizeof(typename Op::T));
  if (vec == 1) return launch<Op, 1, 0>(op, geo, s);
  if (fast) return launch<Op, kWide, kFastN>(op, geo, s);
  return launch<Op, kWide, 0>(op, geo, s);
}

template <typename T>
cudaError_t run_fwd(const void* x, void* y, void* d, int rows, int C, int n, int vec, int head,
                    int tile, int fast, float k, float alpha, float neg_beta, cudaStream_t s) {
  cudaError_t err = check_plan<T>({x, y, d}, {neg_beta}, rows, C, n, vec, head, tile, fast);
  if (err != cudaSuccess) return err;
  const Geometry geo = geometry(rows, C, n, n / 2, head);
  const T* xt = static_cast<const T*>(x);
  if (d != nullptr)
    return dispatch(FwdOp<T, true>{{xt}, {static_cast<T*>(y), static_cast<T*>(d)}, k, alpha,
                                   neg_beta},
                    geo, vec, fast, s);
  return dispatch(FwdOp<T, false>{{xt}, {static_cast<T*>(y)}, k, alpha, neg_beta}, geo, vec,
                  fast, s);
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* d, const void* g, void* dx, int rows, int C,
                    int n, int vec, int head, int tile, int fast, float neg_beta,
                    float neg_beta_m1, float two_ab, cudaStream_t s) {
  cudaError_t err =
      check_plan<T>({x, d, g, dx}, {neg_beta, neg_beta_m1}, rows, C, n, vec, head, tile, fast);
  if (err != cudaSuccess) return err;
  const Geometry geo = geometry(rows, C, n, n - 1 - n / 2, head);
  return dispatch(BwdOp<T>{{static_cast<const T*>(x), static_cast<const T*>(d),
                            static_cast<const T*>(g)},
                           {static_cast<T*>(dx)}, neg_beta, neg_beta_m1, two_ab},
                  geo, vec, fast, s);
}

}  // namespace

// y (and d, unless d is null) [rows, C] from x [rows, C], all of x's type
// (bf16 when bf16 is 1, else f32), under the wrapper's plan (vec, head,
// tile, fast: ops/lrn.py). k, alpha and -beta rounded to that type.
// Returns the CUDA error code of the launch, 0 when it launched;
// cudaErrorMisalignedAddress where a pointer breaks the plan.
extern "C" int dl4j_lrn_fwd(const void* x, void* y, void* d, int rows, int C, int n, int bf16,
                            int vec, int head, int tile, int fast, float k, float alpha,
                            float neg_beta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_fwd<__nv_bfloat16>(x, y, d, rows, C, n, vec, head, tile, fast, k, alpha,
                                  neg_beta, s);
  return run_fwd<float>(x, y, d, rows, C, n, vec, head, tile, fast, k, alpha, neg_beta, s);
}

// dx [rows, C] from x, d and g [rows, C], all of one type, under the
// wrapper's plan; -beta, -beta-1 and 2*alpha*beta rounded to that type.
extern "C" int dl4j_lrn_bwd(const void* x, const void* d, const void* g, void* dx, int rows,
                            int C, int n, int bf16, int vec, int head, int tile, int fast,
                            float neg_beta, float neg_beta_m1, float two_ab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_bwd<__nv_bfloat16>(x, d, g, dx, rows, C, n, vec, head, tile, fast, neg_beta,
                                  neg_beta_m1, two_ab, s);
  return run_bwd<float>(x, d, g, dx, rows, C, n, vec, head, tile, fast, neg_beta,
                        neg_beta_m1, two_ab, s);
}
