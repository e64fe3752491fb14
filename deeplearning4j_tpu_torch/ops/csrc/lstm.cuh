// Kernels shared by the peephole-LSTM sources: the forward step (lstm_seq.cu
// runs it T times a call, lstm_cell.cu once) and the backward's gate math,
// products and reductions (lstm_cell.cu over one step; lstm_seq_bwd.cu takes
// the gate math, drw_gemm and peephole_reduce, and forms its per-step
// product on the tensor cores).
// Both follow _cell_math (deeplearning4j_tpu/ops/pallas_kernels.py:87-101)
// and its backward, so they round at the same points.
//
// Layout: a block owns kUnits hidden units x kRows batch rows and all four
// gate columns [a, f, o, i] of those units, so the gate math and the c/h
// update stay in registers with no exchange between blocks. Products are
// tiled through shared memory and accumulated in f32.
#pragma once

#include "common.cuh"

// in the unnamed namespace of the source that includes it (internal
// linkage: each source is a library of its own)
namespace {

using namespace dl4j;

constexpr int kUnits = 8;    // hidden units per block
constexpr int kRows = 32;    // batch rows per block
constexpr int kTileK = 64;   // depth of one shared-memory tile of a product
constexpr int kThreads = kUnits * kRows;
constexpr int kCols = 4 * kUnits;  // RW columns a forward block reads: 4 gates x kUnits

// One forward step:
//   z = zx + h_prev @ RW                  (product accumulated in f32, rounded)
//   a = act(z[:, :H])
//   f = gate(z[:, H:2H] + c_prev * pF),  i = gate(z[:, 3H:] + c_prev * pI)
//   c = f * c_prev + i * a
//   o = gate(z[:, 2H:3H] + c * pO),      h = o * act(c)
//   masked: h = m*h + (1-m)*h_prev, c = m*c + (1-m)*c_prev
// In bf16 every elementwise result is rounded to bf16 where the plain PyTorch
// version rounds it. h_last, cact_out and the residual pointers may be null.
template <typename T, bool kMasked, bool kStoreResiduals>
__global__ void __launch_bounds__(kThreads)
lstm_step(const T* __restrict__ zx,      // [B, 4H] of this step
          const T* __restrict__ mask,    // [B] of this step (masked only)
          const T* __restrict__ h_prev,  // [B, H]
          const T* __restrict__ c_prev,  // [B, H]
          const T* __restrict__ rw,      // [H, 4H]
          const T* __restrict__ pf, const T* __restrict__ pi,
          const T* __restrict__ po,      // [H] each
          T* __restrict__ h_out,         // [B, H]
          T* __restrict__ c_out,         // [B, H]
          T* __restrict__ h_last,        // [B, H]: a second copy of h, or null
          T* __restrict__ a_out, T* __restrict__ f_out,
          T* __restrict__ o_out,
          T* __restrict__ i_out,         // [B, H] each: residuals (kStoreResiduals)
          T* __restrict__ cact_out,      // [B, H]: act(c) (kStoreResiduals), or null
          int B, int H, int act, int gate) {
  __shared__ float hs[kRows][kTileK + 1];  // +1: rows of one warp hit other banks
  __shared__ float ws[kTileK][kCols];

  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int r = tid / kUnits;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int j = j0 + u;
  const int b = b0 + r;
  const size_t H4 = 4 * static_cast<size_t>(H);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < H; k0 += kTileK) {
    for (int e = tid; e < kRows * kTileK; e += kThreads) {
      const int rr = e / kTileK, kk = e % kTileK;
      const int bb = b0 + rr, k = k0 + kk;
      hs[rr][kk] = (bb < B && k < H) ? ld(h_prev, static_cast<size_t>(bb) * H + k) : 0.f;
    }
    for (int e = tid; e < kTileK * kCols; e += kThreads) {
      const int kk = e / kCols, col = e % kCols;
      const int g = col / kUnits, jj = j0 + col % kUnits;
      const int k = k0 + kk;
      ws[kk][col] = (k < H && jj < H)
                        ? ld(rw, static_cast<size_t>(k) * H4 + static_cast<size_t>(g) * H + jj)
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kTileK; ++kk) {
      const float hv = hs[r][kk];
      acc[0] = fmaf(hv, ws[kk][u], acc[0]);
      acc[1] = fmaf(hv, ws[kk][kUnits + u], acc[1]);
      acc[2] = fmaf(hv, ws[kk][2 * kUnits + u], acc[2]);
      acc[3] = fmaf(hv, ws[kk][3 * kUnits + u], acc[3]);
    }
    __syncthreads();
  }
  if (b >= B || j >= H) return;

  const size_t zrow = static_cast<size_t>(b) * H4;
  const size_t hidx = static_cast<size_t>(b) * H + j;
  const float hp = ld(h_prev, hidx);
  const float cp = ld(c_prev, hidx);
  // z = zx + (h_prev @ RW).astype(dtype), as _cell_math rounds it
  const float za = rnd<T>(ld(zx, zrow + j) + rnd<T>(acc[0]));
  const float zf = rnd<T>(ld(zx, zrow + H + j) + rnd<T>(acc[1]));
  const float zo = rnd<T>(ld(zx, zrow + 2 * static_cast<size_t>(H) + j) + rnd<T>(acc[2]));
  const float zi = rnd<T>(ld(zx, zrow + 3 * static_cast<size_t>(H) + j) + rnd<T>(acc[3]));

  const float a = activate<T>(act, za);
  const float f = activate<T>(gate, rnd<T>(zf + rnd<T>(cp * ld(pf, j))));
  const float i = activate<T>(gate, rnd<T>(zi + rnd<T>(cp * ld(pi, j))));
  float c = rnd<T>(rnd<T>(f * cp) + rnd<T>(i * a));
  const float o = activate<T>(gate, rnd<T>(zo + rnd<T>(c * ld(po, j))));
  const float cact = activate<T>(act, c);
  float h = rnd<T>(o * cact);
  if (kMasked) {
    const float m = ld(mask, b);
    const float keep = rnd<T>(1.0f - m);
    h = rnd<T>(rnd<T>(m * h) + rnd<T>(keep * hp));
    c = rnd<T>(rnd<T>(m * c) + rnd<T>(keep * cp));
  }
  st(h_out, hidx, h);
  st(c_out, hidx, c);
  if (h_last != nullptr) st(h_last, hidx, h);
  if (kStoreResiduals) {
    st(a_out, hidx, a);
    st(f_out, hidx, f);
    st(o_out, hidx, o);
    st(i_out, hidx, i);
    if (cact_out != nullptr) st(cact_out, hidx, cact);
  }
}

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

// dzx[b, :] @ RW[j, :]^T for this thread's (b, j), accumulated in f32 over
// the 4H columns, tiled through shared memory; every thread of the block
// takes part. dzx may be null (returns 0).
template <typename T>
__device__ float dzx_rwt(const T* __restrict__ dzx, const T* __restrict__ rw, int B, int H,
                         int b0, int j0, int r, int u) {
  __shared__ float ds[kRows][kTileK + 1];  // +1: rows of one warp hit other banks
  __shared__ float ws[kTileK][kUnits];
  const int tid = threadIdx.x;
  const size_t H4 = 4 * static_cast<size_t>(H);
  float acc = 0.f;
  if (dzx == nullptr) return acc;
  for (size_t k0 = 0; k0 < H4; k0 += kTileK) {
    for (int e = tid; e < kRows * kTileK; e += kThreads) {
      const int rr = e / kTileK, kk = e % kTileK;
      const int bb = b0 + rr;
      const size_t k = k0 + kk;
      ds[rr][kk] = (bb < B && k < H4) ? ld(dzx, static_cast<size_t>(bb) * H4 + k) : 0.f;
    }
    for (int e = tid; e < kTileK * kUnits; e += kThreads) {
      const int uu = e / kTileK, kk = e % kTileK;
      const int jj = j0 + uu;
      const size_t k = k0 + kk;
      ws[kk][uu] = (jj < H && k < H4) ? ld(rw, static_cast<size_t>(jj) * H4 + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kTileK; ++kk) acc = fmaf(ds[r][kk], ws[kk][u], acc);
    __syncthreads();
  }
  return acc;
}

// dh = (dzx @ RW^T), rounded to the type; masked, plus (1-m)*dh_in (`m` [B]
// and `dh_in` [B, H], both null unmasked). Grid as lstm_step's.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dh(const T* __restrict__ dzx, const T* __restrict__ rw, const T* __restrict__ m,
            const T* __restrict__ dh_in, T* __restrict__ dh, int B, int H) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int r = tid / kUnits;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const float rec = dzx_rwt<T>(dzx, rw, B, H, b0, j0, r, u);
  const int b = b0 + r;
  if (b >= B || j0 + u >= H) return;
  const size_t hidx = static_cast<size_t>(b) * H + j0 + u;
  float v = rnd<T>(rec);
  if (kMasked) v = add<T>(v, mul<T>(sub<T>(1.0f, ld(m, b)), ld(dh_in, hidx)));
  st(dh, hidx, v);
}

constexpr int kGemmM = 64;   // rows of dRW (hidden units k) per block
constexpr int kGemmN = 64;   // columns of dRW (gate columns) per block
constexpr int kGemmR = 16;   // depth (time x batch rows) of one tile
constexpr int kGemmThreads = 256;  // each thread holds a 4 x 4 block of dRW

// dRW[k, n] = sum_r hprev[r, k] * dzx[r, n] over R rows, in f32, written once
// in the type; hprev row r is h0[r] for r < B, else ys[r - B] (over a
// sequence, h_{t-1} of row r's step; over one step, R = B and ys is unused).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
drw_gemm(const T* __restrict__ h0, const T* __restrict__ ys, const T* __restrict__ dzx,
         T* __restrict__ drw, int R, int B, int H) {
  __shared__ float as[kGemmR][kGemmM];
  __shared__ float bs[kGemmR][kGemmN];
  const int tid = threadIdx.x;
  const int tm = (tid / (kGemmN / 4)) * 4;
  const int tn = (tid % (kGemmN / 4)) * 4;
  const int m0 = blockIdx.y * kGemmM;
  const int n0 = blockIdx.x * kGemmN;
  const int H4 = 4 * H;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < R; r0 += kGemmR) {
    for (int e = tid; e < kGemmR * kGemmM; e += kGemmThreads) {
      const int rr = e / kGemmM, mm = e % kGemmM;
      const int row = r0 + rr, k = m0 + mm;
      float v = 0.f;
      if (row < R && k < H)
        v = row < B ? ld(h0, static_cast<size_t>(row) * H + k)
                    : ld(ys, static_cast<size_t>(row - B) * H + k);
      as[rr][mm] = v;
    }
    for (int e = tid; e < kGemmR * kGemmN; e += kGemmThreads) {
      const int rr = e / kGemmN, nn = e % kGemmN;
      const int row = r0 + rr, n = n0 + nn;
      bs[rr][nn] = (row < R && n < H4) ? ld(dzx, static_cast<size_t>(row) * H4 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kGemmR; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        av[q] = as[rr][tm + q];
        bv[q] = bs[rr][tn + q];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int k = m0 + tm + x, n = n0 + tn + y;
      if (k < H && n < H4) st(drw, static_cast<size_t>(k) * H4 + n, acc[x][y]);
    }
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
