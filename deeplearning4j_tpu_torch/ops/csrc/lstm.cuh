// What the peephole-LSTM sources share besides their tensor-core products
// (lstm_mma.cuh, lstm_drw.cuh): the backward's gate math (gate_grads,
// store_dzx) and the peephole reductions (peephole_partials,
// peephole_reduce). lstm_cell.cu takes all of them, lstm_seq_bwd.cu all but
// peephole_partials. They follow the backward of
// _cell_math (deeplearning4j_tpu/ops/pallas_kernels.py:87-101, :122-133),
// so they round at the same points.
//
// Layout of the cell backward's gate kernel (lstm_cell.cu: cell_bwd_gates
// and its peephole partials): a block owns kUnits hidden units x kRows batch
// rows, a thread one (row, unit).
#pragma once

#include "common.cuh"

// in the unnamed namespace of the source that includes it (internal
// linkage: each source is a library of its own)
namespace {

using namespace dl4j;

constexpr int kUnits = 8;    // hidden units per block
constexpr int kRows = 32;    // batch rows per block (ops/lstm_cell.py: CELL_ROW_BLOCK)
constexpr int kThreads = kUnits * kRows;

// The gate gradients of one (row, unit) from its step's activated values
// (the backward of _cell_math, pallas_kernels._bwd_kernel :122-133), each op
// rounded to the type:
//   do = dh*cact*gate'(o)
//   dc_tot = dc + dh*o*act'(cact) + do*pO
//   df = dc_tot*c_prev*gate'(f),  di = dc_tot*a*gate'(i),  da = dc_tot*i*act'(a)
//   dc_prev = dc_tot*f + df*pF + di*pI
struct GateGrads {
  float d_a, d_f, d_o, d_i, dc_prev;
};

template <typename T>
__device__ __forceinline__ GateGrads gate_grads(float dh, float dc, float a, float f, float o,
                                                float i, float cact, float cp, float pF,
                                                float pI, float pO, int act, int gate) {
  GateGrads g;
  g.d_o = mul<T>(mul<T>(dh, cact), derivative<T>(gate, o));
  const float dc_tot = add<T>(add<T>(dc, mul<T>(mul<T>(dh, o), derivative<T>(act, cact))),
                              mul<T>(g.d_o, pO));
  g.d_f = mul<T>(mul<T>(dc_tot, cp), derivative<T>(gate, f));
  g.d_i = mul<T>(mul<T>(dc_tot, a), derivative<T>(gate, i));
  g.d_a = mul<T>(mul<T>(dc_tot, i), derivative<T>(act, a));
  g.dc_prev = add<T>(add<T>(mul<T>(dc_tot, f), mul<T>(g.d_f, pF)), mul<T>(g.d_i, pI));
  return g;
}

// row b of dzx [B, 4H], unit j: the columns [da, df, do, di]
template <typename T>
__device__ __forceinline__ void store_dzx(T* __restrict__ dzx, const GateGrads& g, int b, int j,
                                          int H) {
  const size_t zrow = static_cast<size_t>(b) * 4 * H;
  st(dzx, zrow + j, g.d_a);
  st(dzx, zrow + H + j, g.d_f);
  st(dzx, zrow + 2 * static_cast<size_t>(H) + j, g.d_o);
  st(dzx, zrow + 3 * static_cast<size_t>(H) + j, g.d_i);
}

// dpF, dpI, dpO[j] = sum over the `parts` slots of psum ([parts, 3, H]), in
// f32, written once in the type
template <typename T>
__global__ void peephole_reduce(const float* __restrict__ psum, T* __restrict__ dpf,
                                T* __restrict__ dpi, T* __restrict__ dpo, int parts, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * H) return;
  const int g = idx / H, j = idx % H;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += psum[(static_cast<size_t>(p) * 3 + g) * H + j];
  st(g == 0 ? dpf : g == 1 ? dpi : dpo, j, s);
}

// The peephole terms of this block's threads (tf, ti, to: this thread's
// df*c_prev, di*c_prev, do*c, 0 outside the arrays) summed over the block's
// rows in f32 into psum[blockIdx.y][3][H]. Every thread of the block calls it.
__device__ __forceinline__ void peephole_partials(float tf, float ti, float to,
                                                  float* __restrict__ psum, int H) {
  __shared__ float red[3][kRows][kUnits];
  const int u = threadIdx.x % kUnits;
  const int r = threadIdx.x / kUnits;
  const int j = blockIdx.x * kUnits + u;
  red[0][r][u] = tf;
  red[1][r][u] = ti;
  red[2][r][u] = to;
  __syncthreads();
  if (r < 3 && j < H) {
    float s = 0.f;
    for (int rr = 0; rr < kRows; ++rr) s += red[r][rr][u];
    psum[(static_cast<size_t>(blockIdx.y) * 3 + r) * H + j] = s;
  }
}

}  // namespace
