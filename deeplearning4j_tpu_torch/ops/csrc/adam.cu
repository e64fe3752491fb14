// Multi-tensor Adam update for Hopper (sm_90a): every leaf of one update in
// one launch. Two C entries: dl4j_adam_update_multi takes the step's scalars
// by value; dl4j_adam_update_multi_dev reads lr, bc1 and bc2 from device
// memory when the kernel runs, for a training step captured once in a CUDA
// graph and replayed once per update (a by-value argument is frozen at the
// capture, so every replay would take the first step's learning rate and
// bias corrections).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:fused_adam_update (the
// pallas_call of _adam_kernel), which the JAX package calls once per
// parameter leaf. For every element of every leaf:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   u  = ((-lr) * (m'/bc1)) / (sqrt(v'/bc2) + eps)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t computed on the host from the step
// count, and lr the schedule's value: all runtime arguments. float32 only:
// the update runs in the f32 island of nn/updaters.py:optimizer_update for
// every model dtype. Each product, sum, quotient and square root is rounded
// once, in the order of the plain PyTorch version
// (ops/adam.py:adam_update_reference), with __fmul_rn/__fadd_rn so nvcc
// cannot contract a pair into an FMA the plain version does not have.
//
// What bounds it on this card: bytes. It reads g, m, v and writes u, m', v'
// (24 bytes an element) for about 12 operations an element, far below the
// card's ridge. The char-RNN's 14 leaves move 81.6 MB per update: 24 us at
// 3.35 TB/s. Launched once per leaf (the earlier design: 14-28 launches,
// each with its own host call and allocations) it took 0.352 ms, launches
// and host work rather than memory.
//
// Design: up to kMaxLeaves leaves go into one struct passed by value as the
// kernel's argument (their six pointers, element counts and prefix chunk
// counts, under the 4 KB a kernel's arguments may take), so no pointer
// table is copied to the card. The host cuts each leaf into chunks of
// kChunk elements; block c finds its leaf from the prefix counts and
// takes chunk c - first[leaf] of it. A leaf whose six pointers are all
// 16-byte aligned moves as float4 (each thread whole 16-byte words,
// neighbouring threads neighbouring words), its last n % 4 elements and
// every other leaf one float at a time. One launch takes up to kMaxLeaves
// leaves: once per update for every net the port trains. The arithmetic
// of an element is the per-leaf kernel's adam_elem, unchanged, so the bits
// are the same.
//
// Measured (chip_smoke.py, 14 leaves of 3,398,752 f32, NVIDIA H100 80GB
// HBM3, 700.00 W): the kernel 0.0310 ms on the card (79% of the bound);
// one grouped call 0.2205 ms, the host's checks, three allocations, 42
// views and the ctypes call included (torch.optim.Adam(fused=True).step()
// 0.163 ms in the same run).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 48;            // ops/adam.py: MAX_LEAVES
constexpr int kChunk = 4 * 4 * kThreads;  // elements a block takes: 4 float4 a thread

struct Scalars {
  float neg_lr, bc1, bc2, b1, omb1, b2, omb2, eps;  // omb = 1 - b, rounded on the host
};

struct Leaves {
  const float* g[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  float* u[kMaxLeaves];
  float* m_out[kMaxLeaves];
  float* v_out[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];  // first chunk of each leaf, then the chunks from n_leaves on
  unsigned long long vec;     // bit l: leaf l's six pointers are 16-byte aligned
};
static_assert(sizeof(Leaves) + sizeof(Scalars) + sizeof(const float*) <= 4096,
              "a kernel's arguments take 4 KB");

__device__ __forceinline__ void adam_elem(float g, float m, float v, const Scalars& s,
                                          float& u, float& m2, float& v2) {
  m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  u = __fdiv_rn(__fmul_rn(s.neg_lr, __fdiv_rn(m2, s.bc1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), s.eps));
}

// `dev`, where it is not null, holds lr, bc1 and bc2 (f32, on the card) in
// place of s.neg_lr, s.bc1 and s.bc2: read once per block, negated exactly,
// so the arithmetic and its bits are the by-value entry's.
__global__ void __launch_bounds__(kThreads) adam_multi(const Leaves L, Scalars s,
                                                       const float* __restrict__ dev) {
  if (dev != nullptr) {
    s.neg_lr = -dev[0];
    s.bc1 = dev[1];
    s.bc2 = dev[2];
  }
  const int c = blockIdx.x;
  int l = 0;
  while (L.first[l + 1] <= c) ++l;  // a leaf with no chunk has first[l + 1] = first[l]
  const long long n = L.n[l];
  const long long begin = static_cast<long long>(c - L.first[l]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  long long scalar_from = begin;
  if ((L.vec >> l) & 1ull) {
    const long long end4 = (end < (n & ~3ll) ? end : (n & ~3ll)) / 4;
    const float4* g = reinterpret_cast<const float4*>(L.g[l]);
    const float4* m = reinterpret_cast<const float4*>(L.m[l]);
    const float4* v = reinterpret_cast<const float4*>(L.v[l]);
    float4* u = reinterpret_cast<float4*>(L.u[l]);
    float4* m_out = reinterpret_cast<float4*>(L.m_out[l]);
    float4* v_out = reinterpret_cast<float4*>(L.v_out[l]);
#pragma unroll 4
    for (long long i = begin / 4 + threadIdx.x; i < end4; i += kThreads) {
      const float4 gg = g[i], mm = m[i], vv = v[i];
      float4 uu, m2, v2;
      adam_elem(gg.x, mm.x, vv.x, s, uu.x, m2.x, v2.x);
      adam_elem(gg.y, mm.y, vv.y, s, uu.y, m2.y, v2.y);
      adam_elem(gg.z, mm.z, vv.z, s, uu.z, m2.z, v2.z);
      adam_elem(gg.w, mm.w, vv.w, s, uu.w, m2.w, v2.w);
      u[i] = uu;
      m_out[i] = m2;
      v_out[i] = v2;
    }
    scalar_from = 4 * end4;  // past the chunk's end, or the leaf's last n % 4
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads)
    adam_elem(L.g[l][i], L.m[l][i], L.v[l][i], s, L.u[l][i], L.m_out[l][i], L.v_out[l][i]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int launch(const void* const* g, const void* const* m, const void* const* v, void* const* u,
           void* const* m_out, void* const* v_out, const long long* n, int n_leaves,
           const Scalars& s, const float* dev, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  Leaves L{};
  long long chunks = 0;
  for (int l = 0; l < n_leaves; ++l) {
    L.g[l] = static_cast<const float*>(g[l]);
    L.m[l] = static_cast<const float*>(m[l]);
    L.v[l] = static_cast<const float*>(v[l]);
    L.u[l] = static_cast<float*>(u[l]);
    L.m_out[l] = static_cast<float*>(m_out[l]);
    L.v_out[l] = static_cast<float*>(v_out[l]);
    L.n[l] = n[l];
    L.first[l] = static_cast<int>(chunks);
    chunks += (n[l] + kChunk - 1) / kChunk;
    if (aligned16(g[l]) && aligned16(m[l]) && aligned16(v[l]) && aligned16(u[l]) &&
        aligned16(m_out[l]) && aligned16(v_out[l]))
      L.vec |= 1ull << l;
  }
  if (chunks < 1 || chunks > 0x7fffffffll) return cudaErrorInvalidValue;
  for (int l = n_leaves; l <= kMaxLeaves; ++l) L.first[l] = static_cast<int>(chunks);
  adam_multi<<<static_cast<unsigned>(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      L, s, dev);
  return cudaGetLastError();
}

}  // namespace

// One Adam step for `n_leaves` (1 to kMaxLeaves) f32 leaves, in one
// launch: leaf l reads g[l], m[l], v[l] and writes u[l], m_out[l],
// v_out[l], n[l] elements each (host arrays of pointers on the card and of
// counts; no two buffers may alias). `omb1` and `omb2` are 1 - b1 and 1 - b2
// computed in double and rounded, as the Pallas kernel's Python constants
// are. Returns the CUDA error code of the launch, 0 when it launched;
// cudaErrorInvalidValue, and no launch, for a count out of range or leaves
// with no element.
extern "C" int dl4j_adam_update_multi(const void* const* g, const void* const* m,
                                      const void* const* v, void* const* u,
                                      void* const* m_out, void* const* v_out,
                                      const long long* n, int n_leaves, float lr, float bc1,
                                      float bc2, float b1, float omb1, float b2, float omb2,
                                      float eps, void* stream) {
  return launch(g, m, v, u, m_out, v_out, n, n_leaves,
                Scalars{-lr, bc1, bc2, b1, omb1, b2, omb2, eps}, nullptr, stream);
}

// The same step with lr, bc1 and bc2 read from `scalars` (three f32 on the
// card, in that order) when the kernel runs, not when it is launched: the
// entry of a captured training step, whose host enqueues a copy of the
// step's row of the scalar table into `scalars` before each replay. Given
// the same three values, its outputs are the by-value entry's, bit for
// bit. Returns as dl4j_adam_update_multi does.
extern "C" int dl4j_adam_update_multi_dev(const void* const* g, const void* const* m,
                                          const void* const* v, void* const* u,
                                          void* const* m_out, void* const* v_out,
                                          const long long* n, const float* scalars,
                                          int n_leaves, float b1, float omb1, float b2,
                                          float omb2, float eps, void* stream) {
  if (scalars == nullptr) return cudaErrorInvalidValue;
  return launch(g, m, v, u, m_out, v_out, n, n_leaves,
                Scalars{0.0f, 1.0f, 1.0f, b1, omb1, b2, omb2, eps}, scalars, stream);
}
