// The peephole-LSTM backward's dRW product on the tensor cores (mma.sync over
// mma_sync.cuh):
//   dRW[k, n] = sum_r hprev[r, k] dzx[r, n]   over R rows, in f32, written
//   once in the type; hprev row r is h0[r] for r < B, else ys[r - B] (over a
//   sequence, h_{t-1} of row r's step; over one step, R = B and ys is unused).
// lstm_seq_bwd.cu launches it once a call for rows 7 and 9 (R = T B) and
// alone (dl4j_drw_product); lstm_cell.cu once a step for row 2 (R = B).
//
// Replaces the dRW sums of deeplearning4j_tpu/ops/pallas_kernels.py: the
// per-step drw_scr += h_prev^T dzx in f32 of _seq_bwd_kernel and
// _seq_bwd_kernel_masked, rounded to the type after t = 0, and the cell's
// jnp.dot(hprev^T, dzx) in _bwd_kernel.
//
// What bounds it on this card: 2 R H 4H operations (34.4 GFLOP at R =
// 16384, H = 512: 0.208 ms at the 3xTF32 rate, 0.035 ms in bf16) against
// R H + R 4H + H 4H elements moved (172 MB in f32: 0.051 ms), so operations
// at the sequence's R; at the cell's R = 64 the 4 MB of dRW written.
//
// Design: C = A^T B with the reduction axis r the row of both operands, A =
// hprev [R, H] and B = dzx [R, 4H]. A block owns kDrwM units x kDrwN gate
// columns of dRW and streams r through a kDrwStages-deep cp.async ring in
// tiles of kDrwTileBytes of a column (32 rows in f32, 64 in bf16); each stage
// holds both tiles as they lie (r rows, units or columns contiguous), each
// row padded by 8 elements. Its kDrwWarps warps hold a kDrwWarpsM x
// kDrwWarpsN grid of sub-tiles of C in registers over all of r, so no
// partial passes between warps. A's fragments are read transposed (the
// mma's m is the stored column) and B's k-major, as the forward step reads
// RW: bf16 by ldmatrix.trans for both; tf32 by scalar A[k = t][m = g] and
// B[k = t][n = g] loads, the row stride 8 past a multiple of 32 floats so
// that 8 t + g falls on 32 banks. Each bf16 mma, and each k step's three
// tf32 products of 3xTF32, sums from zero and is added to the warp's f32
// sum by an f32 add: one tensor-core accumulator over a long k drifted past
// the f32 limits (lstm_mma.cuh, PERF.md §6), and here k = R reaches 16384.
// At H = 512 the output tiles alone fill half the SMs, so the caller may
// split R into `slices` of whole tiles (blockIdx.z; ops/lstm_sequence.py's
// drw_slices picks them from R and H): each slice writes its f32 partial
// [slice][H][4H] and drw_reduce adds the slices in slice order and rounds
// to the type. One slice writes dRW itself. No atomics: the result does not
// depend on the order blocks run in. Copies take 16 bytes where every row of
// h0, ys (H elements) and dzx (4H) starts 16-byte aligned, 4 where 4-byte,
// else one element (bf16 rows of odd H).
#pragma once

#include "lstm_mma.cuh"

namespace {

constexpr int kDrwM = 128;          // rows of dRW (hidden units) a block
constexpr int kDrwN = 128;          // columns of dRW (gate columns) a block
constexpr int kDrwWarps = 8;
constexpr int kDrwWarpsM = 2;       // warps along the units, the rest along the columns
constexpr int kDrwStages = 4;       // depth of the cp.async ring
constexpr int kDrwTileBytes = 128;  // bytes of a column's r rows in one tile
constexpr int kDrwThreads = 32 * kDrwWarps;
constexpr int kDrwWarpsN = kDrwWarps / kDrwWarpsM;
constexpr int kDrwMT = kDrwM / kDrwWarpsM / 16;  // m16 tiles of a warp's sub-tile
constexpr int kDrwNT = kDrwN / kDrwWarpsN / 8;   // n8 tiles of a warp's sub-tile
// r rows of one tile: whole k steps (8 in tf32, 16 in bf16)
template <typename T>
constexpr int kDrwRows = kDrwTileBytes / static_cast<int>(sizeof(T));
// shared row strides in elements: 8 past a multiple of 32 (tf32's 8 t + g
// on 32 banks; 16 bytes past a multiple of 128 for ldmatrix's 8 rows)
constexpr int kDrwStrideA = kDrwM + 8;
constexpr int kDrwStrideB = kDrwN + 8;
template <typename T>
constexpr int kDrwStageElems = kDrwRows<T> * (kDrwStrideA + kDrwStrideB);
template <typename T>
constexpr size_t kDrwSmemBytes = kDrwStages * kDrwStageElems<T> * sizeof(T);
static_assert(kDrwWarps % kDrwWarpsM == 0 && kDrwM % 32 == 0 && kDrwN % 32 == 0 &&
                  kDrwM % (16 * kDrwWarpsM) == 0 && kDrwN % (16 * kDrwWarpsN) == 0,
              "warps split the tile evenly into m16 tiles and pairs of n8 tiles");
static_assert(kDrwRows<float> % 8 == 0 && kDrwRows<__nv_bfloat16> % 16 == 0,
              "a tile is whole k steps");
static_assert(kDrwSmemBytes<float> == kDrwSmemBytes<__nv_bfloat16> &&
                  kDrwSmemBytes<float> <= 232448,
              "the ring is as large in either type and fits an SM");

// tile `r0` of r into `stage`: hprev's rows r0.. at the block's units (A,
// m0..) and dzx's rows r0.. at its columns (B, n0..), zeros past r_end, H
// and 4H; pieces of kBytes
template <typename T, int kBytes>
__device__ __forceinline__ void drw_copy_tile(T* stage, const T* h0, const T* ys, const T* dzx,
                                              int B, int H, int r0, int r_end, int m0,
                                              int n0) {
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPiecesA = kDrwM / kPer, kPiecesB = kDrwN / kPer;
  for (int i = threadIdx.x; i < kDrwRows<T> * kPiecesA; i += kDrwThreads) {
    const int rr = i / kPiecesA, c = (i % kPiecesA) * kPer;
    const int r = r0 + rr, m = m0 + c;
    const bool in = r < r_end && m < H;
    const T* src = h0;
    if (in)
      src = r < B ? h0 + static_cast<size_t>(r) * H + m
                  : ys + static_cast<size_t>(r - B) * H + m;
    copy_piece<T, kBytes>(stage + rr * kDrwStrideA + c, src, in);
  }
  T* bs = stage + kDrwRows<T> * kDrwStrideA;
  const int H4 = 4 * H;
  for (int i = threadIdx.x; i < kDrwRows<T> * kPiecesB; i += kDrwThreads) {
    const int rr = i / kPiecesB, c = (i % kPiecesB) * kPer;
    const int r = r0 + rr, n = n0 + c;
    const bool in = r < r_end && n < H4;
    copy_piece<T, kBytes>(bs + rr * kDrwStrideB + c,
                          in ? dzx + static_cast<size_t>(r) * H4 + n : dzx, in);
  }
}

// tile `tile` of the block's slice into its stage of the ring, in pieces of
// `copy_bytes` (16, 4, or one element)
template <typename T>
__device__ __forceinline__ void drw_issue(T* smem, int tile, const T* h0, const T* ys,
                                          const T* dzx, int B, int H, int r_begin, int r_end,
                                          int m0, int n0, int copy_bytes) {
  T* stage = smem + (tile % kDrwStages) * kDrwStageElems<T>;
  const int r0 = r_begin + tile * kDrwRows<T>;
  if (copy_bytes == 16)
    drw_copy_tile<T, 16>(stage, h0, ys, dzx, B, H, r0, r_end, m0, n0);
  else if (copy_bytes == 4)
    drw_copy_tile<T, 4>(stage, h0, ys, dzx, B, H, r0, r_end, m0, n0);
  else
    drw_copy_tile<T, static_cast<int>(sizeof(T))>(stage, h0, ys, dzx, B, H, r0, r_end, m0, n0);
}

// c[i][j] += A[:, 16 i..]^T B[:, 8 j..] over one tile's r rows, A and B the
// warp's columns of the stage (row strides kDrwStrideA, kDrwStrideB): 3xTF32,
// each k step of 8 summed by the tensor cores from zero and added to c
__device__ __forceinline__ void drw_tile_product(float (&c)[kDrwMT][kDrwNT][4], const float* a,
                                                 const float* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // one k step at a time: unrolled, the steps' operands outgrew 255
  // registers and spilled
#pragma unroll 1
  for (int kk = 0; kk < kDrwRows<float> / 8; ++kk) {
    const float* a0 = a + (kk * 8 + t) * kDrwStrideA + g;  // A[k = t][m = g]
    const float* a4 = a0 + 4 * kDrwStrideA;                 // A[k = t + 4][m = g]
    uint32_t ah[kDrwMT][4], al[kDrwMT][4];
#pragma unroll
    for (int i = 0; i < kDrwMT; ++i) {
      dl4j_mma::split(a0[16 * i], ah[i][0], al[i][0]);
      dl4j_mma::split(a0[16 * i + 8], ah[i][1], al[i][1]);
      dl4j_mma::split(a4[16 * i], ah[i][2], al[i][2]);
      dl4j_mma::split(a4[16 * i + 8], ah[i][3], al[i][3]);
    }
    const float* b0 = b + (kk * 8 + t) * kDrwStrideB + g;  // B[k = t][n = g]
    const float* b4 = b0 + 4 * kDrwStrideB;
#pragma unroll
    for (int j = 0; j < kDrwNT; ++j) {
      uint32_t bh[2], bl[2];
      dl4j_mma::split(b0[8 * j], bh[0], bl[0]);
      dl4j_mma::split(b4[8 * j], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < kDrwMT; ++i) {
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        dl4j_mma::mma_3xtf32(step, ah[i], al[i], bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] += step[e];
      }
    }
  }
}

// the same in bf16: both fragments by ldmatrix.trans, each mma summed from
// zero (m16n8k16, f32 sums) and added to c
__device__ __forceinline__ void drw_tile_product(float (&c)[kDrwMT][kDrwNT][4],
                                                 const __nv_bfloat16* a,
                                                 const __nv_bfloat16* b) {
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int kk = 0; kk < kDrwRows<__nv_bfloat16> / 16; ++kk) {
    // A's four 8 x 8 matrices (m 0-7 | 8-15) x (k 0-7 | 8-15): lane l points
    // at row k = l & 7 (+ 8 for l >= 16) of matrix l / 8, at m + 8 for odd ones
    uint32_t af[kDrwMT][4];
#pragma unroll
    for (int i = 0; i < kDrwMT; ++i)
      dl4j_mma::ldmatrix_x4_trans(
          af[i], a + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kDrwStrideA + 16 * i +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int p = 0; p < kDrwNT / 2; ++p) {
      uint32_t bf[4];  // n8 tiles 2p (bf[0], bf[1]) and 2p + 1 (bf[2], bf[3])
      dl4j_mma::ldmatrix_x4_trans(
          bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kDrwStrideB + 16 * p +
                  (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kDrwMT; ++i) {
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
        dl4j_mma::mma_bf16(s0, af[i], bf[0], bf[1]);
        dl4j_mma::mma_bf16(s1, af[i], bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[i][2 * p][e] += s0[e];
          c[i][2 * p + 1][e] += s1[e];
        }
      }
    }
  }
}

// two neighbouring elements of a row, i even (dRW rows have 4H elements)
__device__ __forceinline__ void st2(float* p, size_t i, float x, float y) {
  *reinterpret_cast<float2*>(p + i) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, size_t i, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(x, y);
}

// The block's kDrwM x kDrwN tile of dRW over rows [blockIdx.z slice_rows,
// + slice_rows) of R: into `part` [gridDim.z][H][4H] in f32, or, with `part`
// null (one slice), into `drw` in the type. Grid (ceil(4H / kDrwN),
// ceil(H / kDrwM), slices) of kDrwThreads, kDrwSmemBytes<T> of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kDrwThreads, 1)
drw_mma(const T* __restrict__ h0, const T* __restrict__ ys, const T* __restrict__ dzx,
        T* __restrict__ drw, float* __restrict__ part, int R, int B, int H, int slice_rows,
        int copy_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % kDrwWarpsM) * (kDrwM / kDrwWarpsM);
  const int wn = (warp / kDrwWarpsM) * (kDrwN / kDrwWarpsN);
  const int n0 = blockIdx.x * kDrwN, m0 = blockIdx.y * kDrwM;
  const int r_begin = blockIdx.z * slice_rows;
  const int r_end = min(R, r_begin + slice_rows);
  const int tiles = r_end > r_begin ? (r_end - r_begin + kDrwRows<T> - 1) / kDrwRows<T> : 0;
  float c[kDrwMT][kDrwNT][4] = {};
  for (int s = 0; s < kDrwStages - 1; ++s) {
    if (s < tiles) drw_issue(smem, s, h0, ys, dzx, B, H, r_begin, r_end, m0, n0, copy_bytes);
    dl4j_mma::cp_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    dl4j_mma::cp_wait<kDrwStages - 2>();
    // tile `tile` has landed, and every warp is done with tile - 1, whose
    // stage the next copy fills
    __syncthreads();
    if (tile + kDrwStages - 1 < tiles)
      drw_issue(smem, tile + kDrwStages - 1, h0, ys, dzx, B, H, r_begin, r_end, m0, n0,
                copy_bytes);
    dl4j_mma::cp_commit();
    const T* stage = smem + (tile % kDrwStages) * kDrwStageElems<T>;
    drw_tile_product(c, stage + wm, stage + kDrwRows<T> * kDrwStrideA + wn);
  }
  dl4j_mma::cp_wait<0>();
  // lane (g, t) of m16 tile i and n8 tile j holds rows g and g + 8, columns
  // 2t and 2t + 1
  const int g = lane >> 2, t = lane & 3;
  const size_t H4 = 4 * static_cast<size_t>(H);
#pragma unroll
  for (int i = 0; i < kDrwMT; ++i)
#pragma unroll
    for (int j = 0; j < kDrwNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        const size_t n = n0 + wn + 8 * j + 2 * t;
        if (m >= H || n >= H4) continue;
        const size_t idx = static_cast<size_t>(m) * H4 + n;
        if (part != nullptr)
          st2(part, blockIdx.z * static_cast<size_t>(H) * H4 + idx, c[i][j][2 * h],
              c[i][j][2 * h + 1]);
        else
          st2(drw, idx, c[i][j][2 * h], c[i][j][2 * h + 1]);
      }
}

// dRW[i] = the `slices` partials of element i ([slices][n] f32) added in
// slice order, written once in the type
template <typename T>
__global__ void drw_reduce(const float* __restrict__ part, T* __restrict__ drw, int slices,
                           size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int p = 1; p < slices; ++p) s += part[p * n + i];
  st(drw, i, s);
}

// dRW of R rows (R, B, H > 0) on `stream`: drw_mma over `slices` slices of
// whole tiles, then, with more than one, drw_reduce over `part` (f32 scratch
// of slices * H * 4H elements). `drw` is H x 4H, 2-element aligned. Returns
// the CUDA error code of the first launch that failed, 0 when all launched.
template <typename T>
cudaError_t launch_drw(const void* h0_v, const void* ys_v, const void* dzx_v, void* drw_v,
                       float* part, int R, int B, int H, int slices, cudaStream_t stream) {
  if (slices < 1 || (slices > 1 && part == nullptr) || !aligned_to(drw_v, 2 * sizeof(T)))
    return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(H) * sizeof(T);  // dzx's rows: 4 x
  const auto all_aligned = [&](size_t n) {
    return row_bytes % n == 0 && aligned_to(h0_v, n) && aligned_to(ys_v, n) &&
           aligned_to(dzx_v, n);
  };
  const int copy_bytes = all_aligned(16) ? 16 : all_aligned(4) ? 4 : static_cast<int>(sizeof(T));
  const int smem = static_cast<int>(kDrwSmemBytes<T>);
  cudaError_t err =
      cudaFuncSetAttribute(drw_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (R + kDrwRows<T> - 1) / kDrwRows<T>;
  const int slice_rows = (tiles + slices - 1) / slices * kDrwRows<T>;
  const dim3 grid((4 * H + kDrwN - 1) / kDrwN, (H + kDrwM - 1) / kDrwM, slices);
  T* drw = static_cast<T*>(drw_v);
  drw_mma<T><<<grid, kDrwThreads, smem, stream>>>(
      static_cast<const T*>(h0_v), static_cast<const T*>(ys_v), static_cast<const T*>(dzx_v),
      drw, slices > 1 ? part : nullptr, R, B, H, slice_rows, copy_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n = static_cast<size_t>(H) * 4 * H;
  drw_reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(part, drw, slices, n);
  return cudaGetLastError();
}

}  // namespace
