// Element helpers shared by the port's kernels: loads and stores in the
// storage type (all of them), rounding to it, and the activations with their
// derivatives from the activated value (the peephole-LSTM kernels,
// lstm_seq.cu and lstm_seq_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace dl4j {

// activation codes; ops/lstm_sequence.py:_ACT_CODES holds the same table
enum Act { kTanh = 0, kSigmoid = 1, kHardSigmoid = 2, kRelu = 3, kIdentity = 4 };

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// round to the storage type and back (identity for f32)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// one elementwise op of the plain PyTorch version: computed in f32 without
// contraction into an FMA, then rounded to the storage type
template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float sub(float a, float b) { return rnd<T>(__fsub_rn(a, b)); }

template <typename T>
__device__ __forceinline__ float activate(int kind, float x) {
  switch (kind) {
    case kTanh:
      return rnd<T>(tanhf(x));
    case kSigmoid: {  // 0.5 * (tanh(0.5 * x) + 1)
      const float t = rnd<T>(tanhf(rnd<T>(0.5f * x)));
      return rnd<T>(0.5f * rnd<T>(t + 1.0f));
    }
    case kHardSigmoid:  // clip(0.2 * x + 0.5, 0, 1), 0.2 rounded to the type as JAX does
      return fminf(fmaxf(rnd<T>(rnd<T>(rnd<T>(0.2f) * x) + 0.5f), 0.0f), 1.0f);
    case kRelu:
      return fmaxf(x, 0.0f);
    default:
      return x;
  }
}

// derivative of an activation from its activated value y (pallas_kernels._ACT)
template <typename T>
__device__ __forceinline__ float derivative(int kind, float y) {
  switch (kind) {
    case kTanh:  // 1 - y * y
      return sub<T>(1.0f, mul<T>(y, y));
    case kSigmoid:  // y * (1 - y)
      return mul<T>(y, sub<T>(1.0f, y));
    case kHardSigmoid:  // 0.2 inside (0, 1), else 0
      return (y > 0.0f && y < 1.0f) ? rnd<T>(0.2f) : 0.0f;
    case kRelu:
      return y > 0.0f ? 1.0f : 0.0f;
    default:
      return 1.0f;
  }
}

}  // namespace dl4j
