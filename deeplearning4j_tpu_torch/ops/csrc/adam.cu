// Per-leaf Adam update for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:fused_adam_update (the
// pallas_call of _adam_kernel), one launch per parameter leaf as the JAX
// package makes one pallas_call per leaf. For every element:
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
// 3.35 TB/s.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores, so each
// thread moves whole 16-byte words and neighbouring threads neighbouring
// words; a leaf whose pointers are not all 16-byte aligned, and the last
// n % 4 elements, take the scalar loop. Later work: one launch for all
// leaves (a multi-tensor list), which removes 13 of the 14 launches.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 threads per SM fill the card

struct Scalars {
  float neg_lr, bc1, bc2, b1, omb1, b2, omb2, eps;  // omb = 1 - b, rounded on the host
};

__device__ __forceinline__ void adam_elem(float g, float m, float v, const Scalars& s,
                                          float& u, float& m2, float& v2) {
  m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  u = __fdiv_rn(__fmul_rn(s.neg_lr, __fdiv_rn(m2, s.bc1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), s.eps));
}

__global__ void __launch_bounds__(kThreads)
adam_vec4(const float4* __restrict__ g, const float4* __restrict__ m,
          const float4* __restrict__ v, float4* __restrict__ u, float4* __restrict__ m_out,
          float4* __restrict__ v_out, size_t n4, Scalars s) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
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
}

// elements [begin, n) one at a time
__global__ void __launch_bounds__(kThreads)
adam_scalar(const float* __restrict__ g, const float* __restrict__ m,
            const float* __restrict__ v, float* __restrict__ u, float* __restrict__ m_out,
            float* __restrict__ v_out, size_t begin, size_t n, Scalars s) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = begin + static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    adam_elem(g[i], m[i], v[i], s, u[i], m_out[i], v_out[i]);
}

int blocks_for(size_t work) {
  const size_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// One Adam step for one f32 leaf of `n` elements: reads g, m, v, writes u,
// m_out, v_out (none may alias another). `omb1`/`omb2` are 1 - b1 and 1 - b2
// computed in double and rounded, as the Pallas kernel's Python constants
// are. Returns the CUDA error code of the first launch that failed, 0 when
// all launched.
extern "C" int dl4j_adam_update(const void* g, const void* m, const void* v, void* u,
                                void* m_out, void* v_out, int n, float lr, float bc1,
                                float bc2, float b1, float omb1, float b2, float omb2,
                                float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars s{-lr, bc1, bc2, b1, omb1, b2, omb2, eps};
  const size_t total = static_cast<size_t>(n);
  const bool vec = aligned16(g) && aligned16(m) && aligned16(v) && aligned16(u) &&
                   aligned16(m_out) && aligned16(v_out);
  const size_t n4 = vec ? total / 4 : 0;
  if (n4 > 0) {
    adam_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(m),
        static_cast<const float4*>(v), static_cast<float4*>(u), static_cast<float4*>(m_out),
        static_cast<float4*>(v_out), n4, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t begin = 4 * n4;
  if (begin < total) {
    adam_scalar<<<blocks_for(total - begin), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(m),
        static_cast<const float*>(v), static_cast<float*>(u), static_cast<float*>(m_out),
        static_cast<float*>(v_out), begin, total, s);
    return cudaGetLastError();
  }
  return cudaSuccess;
}
