// The peephole-LSTM's recurrent products on the tensor cores (mma.sync over
// mma_sync.cuh), shared by the sources that launch them:
// - lstm_step_mma, the forward step z = zx + h_prev @ RW with its gate
//   epilogue: lstm_seq.cu runs it T times a call (rows 5, 6 and 8),
//   lstm_cell.cu once (row 1);
// - block_product, the backward's dzx @ RW^T for a block's rows and units:
//   lstm_seq_bwd.cu's step kernel (rows 7 and 9) and lstm_bwd_dh_mma, which
//   lstm_seq_bwd.cu launches for dh0 and lstm_cell.cu for the cell's dh_prev
//   (row 2).
//
// Both products stream k through a cp.async ring in chunks, split each chunk
// into k slices (a warp each), and add the slices' partial products through
// shared memory in slice order: no atomics, so the result does not depend on
// the order blocks run in. bf16 takes m16n8k16 with f32 sums; f32 takes
// 3xTF32, each k step's three products summed by the tensor cores from zero
// and added to the warp's f32 sum (mma_nt_f32_steps, mma_nn_f32_steps): one
// tensor-core accumulator over the whole depth drifted past the f32 limits
// (PERF.md §6).
#pragma once

#include "lstm.cuh"
#include "mma_sync.cuh"

namespace {

bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ==================================================== backward: dzx @ RW^T
// The per-step product's tile. kBwdRows is also the row block of the
// peephole partials: psum is [steps, ceil(B / kBwdRows), 3, H]
// (ops/lstm_sequence.py: BWD_ROW_BLOCK must equal it).
constexpr int kBwdRows = 16;    // batch rows per block: m16 row tiles
constexpr int kBwdUnits = 16;   // hidden units per block: two n8 tiles
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kRowTiles = kBwdRows / 16;
constexpr int kSlices = kBwdWarps / kRowTiles;  // k slices of a chunk, a warp each
constexpr int kPairs = 8 / kSlices;  // elements of its row tile's 16 x 16 a lane ends with
constexpr int kStages = 4;      // depth of the cp.async ring
static_assert(kBwdRows % 16 == 0 && kBwdWarps % kRowTiles == 0 && 8 % kSlices == 0,
              "each row tile's C fragments split evenly over its slices");

// k elements of one chunk: 1024 bytes of a row in either type
template <typename T>
constexpr int kChunk = 1024 / static_cast<int>(sizeof(T));
// shared row stride in elements: the chunk and 16 bytes, so the rows one
// ldmatrix (or one tf32 fragment load) reads fall on different banks
template <typename T>
constexpr int kStride = kChunk<T> + 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kStageElems = (kBwdRows + kBwdUnits) * kStride<T>;
template <typename T>
constexpr size_t kSmemBytes = kStages * kStageElems<T> * sizeof(T);
// after the loop the ring holds the slices' partial products
// [kSlices][kRowTiles][16][16] and the peephole terms [3][kBwdRows][kBwdUnits]
constexpr int kRedFloats = kSlices * kRowTiles * 16 * 16;
static_assert((kRedFloats + 3 * kBwdRows * kBwdUnits) * sizeof(float) <= kSmemBytes<float>
                  && kSmemBytes<float> == kSmemBytes<__nv_bfloat16>,
              "the reductions fit in the ring, which is as large in either type");

// chunk `k0` of the block's rows of dzx (rows b0.., stage rows 0..31) and
// of RW (rows j0.., stage rows 32..47) into `stage`, zeros past B, H and
// K = 4H; 16-byte copies when `wide`, else 4-byte ones
template <typename T, int kBytes>
__device__ __forceinline__ void copy_chunk(T* stage, const T* dzx, const T* rw, int B, int H,
                                           int b0, int j0, int k0) {
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kCopies = kChunk<T> / kPer;                    // copies a row
  const int K = 4 * H;
  for (int i = threadIdx.x; i < (kBwdRows + kBwdUnits) * kCopies; i += kBwdThreads) {
    const int r = i / kCopies, c = (i % kCopies) * kPer;
    const bool is_a = r < kBwdRows;
    const int row = is_a ? b0 + r : j0 + r - kBwdRows;
    const T* src = is_a ? dzx : rw;
    const bool in = row < (is_a ? B : H) && k0 + c < K;
    dl4j_mma::cp_async<kBytes>(stage + r * kStride<T> + c,
                               in ? src + static_cast<size_t>(row) * K + k0 + c : src, in);
  }
}

// chunk `chunk` of k into its stage of the ring
template <typename T>
__device__ __forceinline__ void issue_chunk(T* smem, int chunk, const T* dzx, const T* rw, int B,
                                            int H, int b0, int j0, bool wide) {
  T* stage = smem + (chunk % kStages) * kStageElems<T>;
  if (wide)
    copy_chunk<T, 16>(stage, dzx, rw, B, H, b0, j0, chunk * kChunk<T>);
  else
    copy_chunk<T, 4>(stage, dzx, rw, B, H, b0, j0, chunk * kChunk<T>);
}

// c[n] += A[16 x K] B[16 x K]^T (columns 8n..8n+7) in f32: mma_nt's
// 3xTF32 (lo hi, hi lo, hi hi), but each k step of 8 summed by the tensor
// cores from zero and added to c by an f32 add. (Summed in one tensor-core
// accumulator over k = 4H, as mma_nt sums, the product drifted from an f64
// product well past the plain f32 version, and the f32 Adam recipe left its
// limits against the CPU in chip_smoke.py: the accumulator's own adds do
// not round to nearest.)
template <int K, int SA, int SB>
__device__ __forceinline__ void mma_nt_f32_steps(float (&c)[2][4], const float* a, const float* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    dl4j_mma::split(a[g * SA + kk * 8 + t], ah[0], al[0]);
    dl4j_mma::split(a[(g + 8) * SA + kk * 8 + t], ah[1], al[1]);
    dl4j_mma::split(a[g * SA + kk * 8 + t + 4], ah[2], al[2]);
    dl4j_mma::split(a[(g + 8) * SA + kk * 8 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      dl4j_mma::split(b[(8 * n + g) * SB + kk * 8 + t], bh[0], bl[0]);
      dl4j_mma::split(b[(8 * n + g) * SB + kk * 8 + t + 4], bh[1], bl[1]);
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      dl4j_mma::mma_3xtf32(step, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += step[e];
    }
  }
}

// one warp's k slice of a chunk: C += A B^T, A its 16 rows of dzx, B the
// block's 16 rows of RW
template <int K, int SA, int SB>
__device__ __forceinline__ void slice_product(float (&c)[2][4], const float* a, const float* b) {
  mma_nt_f32_steps<K, SA, SB>(c, a, b);
}
template <int K, int SA, int SB>
__device__ __forceinline__ void slice_product(float (&c)[2][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b) {
  dl4j_mma::mma_nt<K, 2, SA, SB>(c, a, b);
}

// the block row and unit of this lane's element p (< kPairs) of the block's
// product: of the eight C-fragment elements a lane of a row tile holds
// (q = 4 n + 2 rh + e: n8 tile n, row g + 8 rh, column 2t + e), slice s
// ends with q = kPairs s .. kPairs s + kPairs - 1 (one q each at 16 rows)
__device__ __forceinline__ void lane_elem(int p, int& row, int& col) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rtile = warp % kRowTiles, slice = warp / kRowTiles;
  const int q = kPairs * slice + p;
  row = 16 * rtile + (lane >> 2) + 8 * ((q >> 1) & 1);
  col = 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
}

// dzx[b, :] @ RW[j, :]^T for this lane's elements (lane_elem), accumulated in
// f32 on the tensor cores; every thread of the block takes part
template <typename T>
__device__ __forceinline__ void block_product(const T* __restrict__ dzx,
                                              const T* __restrict__ rw, int B, int H, int b0,
                                              int j0, bool wide, T* smem, float* red,
                                              float (&rec)[kPairs]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rtile = warp % kRowTiles, slice = warp / kRowTiles;
  constexpr int kKw = kChunk<T> / kSlices;  // k of one warp's slice of a chunk
  float c[2][4] = {};
  const int chunks = (4 * H + kChunk<T> - 1) / kChunk<T>;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) issue_chunk(smem, s, dzx, rw, B, H, b0, j0, wide);
    dl4j_mma::cp_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    dl4j_mma::cp_wait<kStages - 2>();
    // chunk ch has landed, and every warp is done with chunk ch - 1, whose
    // stage the next copy fills
    __syncthreads();
    if (ch + kStages - 1 < chunks)
      issue_chunk(smem, ch + kStages - 1, dzx, rw, B, H, b0, j0, wide);
    dl4j_mma::cp_commit();
    const T* stage = smem + (ch % kStages) * kStageElems<T>;
    slice_product<kKw, kStride<T>, kStride<T>>(c, stage + 16 * rtile * kStride<T> + slice * kKw,
                                               stage + kBwdRows * kStride<T> + slice * kKw);
  }
  dl4j_mma::cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the partial products
  const int g = lane >> 2, t = lane & 3;
  float* mine = red + (slice * kRowTiles + rtile) * 256;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    mine[g * 16 + 8 * n + 2 * t] = c[n][0];
    mine[g * 16 + 8 * n + 2 * t + 1] = c[n][1];
    mine[(g + 8) * 16 + 8 * n + 2 * t] = c[n][2];
    mine[(g + 8) * 16 + 8 * n + 2 * t + 1] = c[n][3];
  }
  __syncthreads();
  // the slices' partials of each of this lane's elements, added in order
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    int row, col;
    lane_elem(p, row, col);
    rec[p] = 0.f;
#pragma unroll
    for (int q = 0; q < kSlices; ++q)
      rec[p] += red[(q * kRowTiles + rtile) * 256 + (row % 16) * 16 + col];
  }
}

// dh = (dzx @ RW^T), rounded to the type; masked, plus (1-m)*dh_in (`m` [B]
// and `dh_in` [B, H], both null unmasked). Grid (ceil(H / kBwdUnits),
// ceil(B / kBwdRows)) of kBwdThreads, kSmemBytes<T> of dynamic shared memory;
// `wide` when every row of dzx and RW starts 16-byte aligned.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kBwdThreads)
lstm_bwd_dh_mma(const T* __restrict__ dzx, const T* __restrict__ rw, const T* __restrict__ m,
                const T* __restrict__ dh_in, T* __restrict__ dh, int B, int H, int wide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * kBwdUnits;
  const int b0 = blockIdx.y * kBwdRows;
  float rec[kPairs];
  block_product<T>(dzx, rw, B, H, b0, j0, wide != 0, reinterpret_cast<T*>(smem_raw),
                   reinterpret_cast<float*>(smem_raw), rec);
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    int row, col;
    lane_elem(e, row, col);
    const int b = b0 + row, j = j0 + col;
    if (b >= B || j >= H) continue;
    const size_t hidx = static_cast<size_t>(b) * H + j;
    float v = rnd<T>(rec[e]);
    if (kMasked) v = add<T>(v, mul<T>(sub<T>(1.0f, ld(m, b)), ld(dh_in, hidx)));
    st(dh, hidx, v);
  }
}

// block_product's copies: 16 bytes (`wide`) where every row of dzx and RW
// (4H elements) starts 16-byte aligned, else 4 (a row is even, so 4-byte
// pieces always fit it); cudaErrorMisalignedAddress where a base is not
// 4-byte aligned
template <typename T>
cudaError_t bwd_copy_wide(const void* dzx, const void* rw, int H, int* wide) {
  if (!aligned_to(rw, 4) || !aligned_to(dzx, 4)) return cudaErrorMisalignedAddress;
  const size_t row_bytes = 4 * static_cast<size_t>(H) * sizeof(T);
  *wide = row_bytes % 16 == 0 && aligned_to(rw, 16) && aligned_to(dzx, 16);
  return cudaSuccess;
}

// ==================================================== forward: h_prev @ RW
// A block owns kFwdRows batch rows x kFwdUnits hidden units and all four
// gate columns [a, f, o, i] of those units, so the gate math stays in the
// block. Its product is C [kFwdRows x 4 kFwdUnits] = A B: A its rows of
// h_prev ([B, H], k contiguous, as the backward's A), B RW's columns of its
// units ([H, 4H] row-major: rows run over k, n contiguous), both staged as
// they lie, B's columns gate-major (column q of gate g at g kFwdUnits + q).
// bf16 reads A's fragments with ldmatrix and B's with ldmatrix.trans; tf32
// reads B[k = t][n = g] and B[k = t + 4][n = g] by scalar loads, A[g][t] and
// A[g][t + 4] as the backward does (k = t, t + 4 in both operands).
constexpr int kFwdRows = 16;   // batch rows per block: m16 row tiles
constexpr int kFwdUnits = 16;  // hidden units per block
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRowTiles = kFwdRows / 16;
constexpr int kFwdSlices = kFwdWarps / kFwdRowTiles;  // k slices of a chunk, a warp each
constexpr int kFwdCols = 4 * kFwdUnits;               // gate columns of the block
constexpr int kFwdTilesN = kFwdCols / 8;              // their n8 tiles
// (row, unit) pairs a thread ends with, all four gates of each
constexpr int kFwdPairs = kFwdRows * kFwdUnits / kFwdThreads;
constexpr int kFwdStages = 4;        // depth of the cp.async ring
constexpr int kFwdChunkBytes = 512;  // bytes of an A row in one chunk
static_assert(kFwdRows % 16 == 0 && kFwdWarps % kFwdRowTiles == 0 && kFwdUnits % 8 == 0,
              "m16 row tiles split evenly over the warps; whole 32-byte pieces of a gate");
static_assert(kFwdPairs >= 1 && kFwdRows * kFwdUnits % kFwdThreads == 0,
              "every thread ends with whole (row, unit) pairs");

// k elements of one chunk
template <typename T>
constexpr int kFwdChunk = kFwdChunkBytes / static_cast<int>(sizeof(T));
// A's row stride: the chunk and 16 bytes (ldmatrix rows, and tf32's
// A[g][t] loads, on different banks); B's: the block's columns and 8
// elements (ldmatrix.trans rows, and tf32's B[t][g] loads, 8 t + g, on
// different banks), 16-byte aligned in either type
template <typename T>
constexpr int kFwdStrideA = kFwdChunk<T> + 16 / static_cast<int>(sizeof(T));
constexpr int kFwdStrideB = kFwdCols + 8;
template <typename T>
constexpr int kFwdStageElems = kFwdRows * kFwdStrideA<T> + kFwdChunk<T> * kFwdStrideB;
template <typename T>
constexpr size_t kFwdSmemBytes = kFwdStages * kFwdStageElems<T> * sizeof(T);
// after the loop the ring holds the slices' partial products
// [kFwdSlices][kFwdRows][kFwdRedStride]; with the stride 8 floats past a
// multiple of 32, each half warp's 8-byte stores of its C fragments fall on
// all 32 banks once
constexpr int kFwdRedStride = kFwdCols + 8;
constexpr int kFwdRedFloats = kFwdSlices * kFwdRows * kFwdRedStride;
static_assert(kFwdChunk<float> / kFwdSlices % 8 == 0,
              "a warp's slice is whole k steps: 8 in tf32, 16 in bf16");
static_assert(kFwdRedFloats * sizeof(float) <= kFwdSmemBytes<float>
                  && kFwdSmemBytes<float> == kFwdSmemBytes<__nv_bfloat16>
                  && kFwdSmemBytes<float> <= 232448,
              "the partials fit in the ring, which is as large in either type and fits an SM");

// one piece of kBytes from src to dst, or zeros where !in: cp.async for 16
// and 4 bytes; a load and a store for one bf16 element (rows that start
// only 2-byte aligned)
template <typename T, int kBytes>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, bool in) {
  if constexpr (kBytes >= 4)
    dl4j_mma::cp_async<kBytes>(dst, src, in);
  else
    st(dst, 0, in ? ld(src, 0) : 0.f);
}

// chunk `k0` of k into `stage`: the block's rows of h_prev (b0.., A) and
// RW's rows k0.. at its units' gate columns (j0.. of each gate, B), zeros
// past B, H and the units; pieces of kBytes
template <typename T, int kBytes>
__device__ __forceinline__ void fwd_copy_chunk(T* stage, const T* h_prev, const T* rw, int B,
                                               int H, int b0, int j0, int k0) {
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPiecesA = kFwdChunk<T> / kPer;                // pieces of an A row
  constexpr int kPiecesG = kFwdUnits / kPer;                   // pieces of a gate in a B row
  for (int i = threadIdx.x; i < kFwdRows * kPiecesA; i += kFwdThreads) {
    const int r = i / kPiecesA, c = (i % kPiecesA) * kPer;
    const int b = b0 + r, k = k0 + c;
    const bool in = b < B && k < H;
    copy_piece<T, kBytes>(stage + r * kFwdStrideA<T> + c,
                          in ? h_prev + static_cast<size_t>(b) * H + k : h_prev, in);
  }
  T* bs = stage + kFwdRows * kFwdStrideA<T>;
  const size_t H4 = 4 * static_cast<size_t>(H);
  for (int i = threadIdx.x; i < kFwdChunk<T> * 4 * kPiecesG; i += kFwdThreads) {
    const int kk = i / (4 * kPiecesG), rest = i % (4 * kPiecesG);
    const int g = rest / kPiecesG, u = (rest % kPiecesG) * kPer;
    const int k = k0 + kk, j = j0 + u;
    const bool in = k < H && j < H;
    copy_piece<T, kBytes>(
        bs + kk * kFwdStrideB + g * kFwdUnits + u,
        in ? rw + static_cast<size_t>(k) * H4 + static_cast<size_t>(g) * H + j : rw, in);
  }
}

// chunk `chunk` of k into its stage of the ring, in pieces of `copy_bytes`
// (16, 4, or one element)
template <typename T>
__device__ __forceinline__ void fwd_issue_chunk(T* smem, int chunk, const T* h_prev,
                                                const T* rw, int B, int H, int b0, int j0,
                                                int copy_bytes) {
  T* stage = smem + (chunk % kFwdStages) * kFwdStageElems<T>;
  const int k0 = chunk * kFwdChunk<T>;
  if (copy_bytes == 16)
    fwd_copy_chunk<T, 16>(stage, h_prev, rw, B, H, b0, j0, k0);
  else if (copy_bytes == 4)
    fwd_copy_chunk<T, 4>(stage, h_prev, rw, B, H, b0, j0, k0);
  else
    fwd_copy_chunk<T, static_cast<int>(sizeof(T))>(stage, h_prev, rw, B, H, b0, j0, k0);
}

// c[n] += A[16 x K] B[K x 8 NT] (columns 8n..8n+7) in f32, B k-major (row
// k, stride SB): 3xTF32, each k step of 8 summed from zero and added to c
// by an f32 add, as mma_nt_f32_steps
template <int K, int NT, int SA, int SB>
__device__ __forceinline__ void mma_nn_f32_steps(float (&c)[NT][4], const float* a,
                                                 const float* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    dl4j_mma::split(a[g * SA + kk * 8 + t], ah[0], al[0]);
    dl4j_mma::split(a[(g + 8) * SA + kk * 8 + t], ah[1], al[1]);
    dl4j_mma::split(a[g * SA + kk * 8 + t + 4], ah[2], al[2]);
    dl4j_mma::split(a[(g + 8) * SA + kk * 8 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2], bl[2];
      dl4j_mma::split(b[(kk * 8 + t) * SB + 8 * n + g], bh[0], bl[0]);
      dl4j_mma::split(b[(kk * 8 + t + 4) * SB + 8 * n + g], bh[1], bl[1]);
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      dl4j_mma::mma_3xtf32(step, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += step[e];
    }
  }
}

// c[n] += A[16 x K] B[K x 8 NT] in bf16 with f32 sums, B k-major: A's
// fragments by ldmatrix (as mma_nt), B's by ldmatrix.trans, a pair of n8
// tiles each (as flash_mma.cuh's mma_pv)
template <int K, int NT, int SA, int SB>
__device__ __forceinline__ void mma_nn_bf16(float (&c)[NT][4], const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
  static_assert(K % 16 == 0 && NT % 2 == 0, "bf16 tiles: k16 steps, pairs of n8");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    dl4j_mma::ldmatrix_x4(af, a + (lane & 15) * SA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t bf[4];
      dl4j_mma::ldmatrix_x4_trans(
          bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SB + p * 16 + (lane >> 4) * 8);
      dl4j_mma::mma_bf16(c[2 * p], af, bf[0], bf[1]);
      dl4j_mma::mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// one warp's k slice of a chunk: C += A B, A its 16 rows of h_prev, B the
// block's gate columns of RW
template <int K>
__device__ __forceinline__ void fwd_slice_product(float (&c)[kFwdTilesN][4], const float* a,
                                                  const float* b) {
  mma_nn_f32_steps<K, kFwdTilesN, kFwdStrideA<float>, kFwdStrideB>(c, a, b);
}
template <int K>
__device__ __forceinline__ void fwd_slice_product(float (&c)[kFwdTilesN][4],
                                                  const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b) {
  mma_nn_bf16<K, kFwdTilesN, kFwdStrideA<__nv_bfloat16>, kFwdStrideB>(c, a, b);
}

// the block row and unit of this thread's pair p (< kFwdPairs)
__device__ __forceinline__ void fwd_pair(int p, int& row, int& unit) {
  const int idx = threadIdx.x + p * kFwdThreads;
  row = idx / kFwdUnits;
  unit = idx % kFwdUnits;
}

// h_prev[b, :] @ RW[:, g H + j] for this thread's pairs (fwd_pair) and the
// four gates g, accumulated in f32 on the tensor cores; every thread of the
// block takes part
template <typename T>
__device__ __forceinline__ void fwd_block_product(const T* __restrict__ h_prev,
                                                  const T* __restrict__ rw, int B, int H,
                                                  int b0, int j0, int copy_bytes, T* smem,
                                                  float* red, float (&z)[kFwdPairs][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rtile = warp % kFwdRowTiles, slice = warp / kFwdRowTiles;
  constexpr int kKw = kFwdChunk<T> / kFwdSlices;  // k of one warp's slice of a chunk
  float c[kFwdTilesN][4] = {};
  const int chunks = (H + kFwdChunk<T> - 1) / kFwdChunk<T>;
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < chunks) fwd_issue_chunk(smem, s, h_prev, rw, B, H, b0, j0, copy_bytes);
    dl4j_mma::cp_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    dl4j_mma::cp_wait<kFwdStages - 2>();
    // chunk ch has landed, and every warp is done with chunk ch - 1, whose
    // stage the next copy fills
    __syncthreads();
    if (ch + kFwdStages - 1 < chunks)
      fwd_issue_chunk(smem, ch + kFwdStages - 1, h_prev, rw, B, H, b0, j0, copy_bytes);
    dl4j_mma::cp_commit();
    const T* stage = smem + (ch % kFwdStages) * kFwdStageElems<T>;
    fwd_slice_product<kKw>(c, stage + 16 * rtile * kFwdStrideA<T> + slice * kKw,
                           stage + kFwdRows * kFwdStrideA<T> + slice * kKw * kFwdStrideB);
  }
  dl4j_mma::cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the partial products
  const int g = lane >> 2, t = lane & 3;
  float* mine = red + (slice * kFwdRows + 16 * rtile) * kFwdRedStride + 2 * t;
#pragma unroll
  for (int n = 0; n < kFwdTilesN; ++n) {
    *reinterpret_cast<float2*>(mine + g * kFwdRedStride + 8 * n) = make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * kFwdRedStride + 8 * n) =
        make_float2(c[n][2], c[n][3]);
  }
  __syncthreads();
  // the slices' partials of each gate of this thread's pairs, added in order
#pragma unroll
  for (int p = 0; p < kFwdPairs; ++p) {
    int row, unit;
    fwd_pair(p, row, unit);
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
      z[p][gt] = 0.f;
#pragma unroll
      for (int s = 0; s < kFwdSlices; ++s)
        z[p][gt] += red[(s * kFwdRows + row) * kFwdRedStride + gt * kFwdUnits + unit];
    }
  }
}

// One forward step:
//   z = zx + h_prev @ RW                  (product accumulated in f32, rounded)
//   a = act(z[:, :H])
//   f = gate(z[:, H:2H] + c_prev * pF),  i = gate(z[:, 3H:] + c_prev * pI)
//   c = f * c_prev + i * a
//   o = gate(z[:, 2H:3H] + c * pO),      h = o * act(c)
//   masked: h = m*h + (1-m)*h_prev, c = m*c + (1-m)*c_prev
// In bf16 every elementwise result is rounded to bf16 where the plain PyTorch
// version rounds it. h_last, cact_out and the residual pointers may be null.
// Grid (ceil(H / kFwdUnits), ceil(B / kFwdRows)) of kFwdThreads,
// kFwdSmemBytes<T> of dynamic shared memory; `copy_bytes` from fwd_copy_bytes.
template <typename T, bool kMasked, bool kStoreResiduals>
__global__ void __launch_bounds__(kFwdThreads, 1)
lstm_step_mma(const T* __restrict__ zx,      // [B, 4H] of this step
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
              int B, int H, int act, int gate, int copy_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * kFwdUnits;
  const int b0 = blockIdx.y * kFwdRows;
  const size_t H4 = 4 * static_cast<size_t>(H);

  // this thread's operands, loaded before the product so that their latency
  // hides behind it
  float in_zx[kFwdPairs][4], in_hp[kFwdPairs], in_cp[kFwdPairs], in_pf[kFwdPairs],
      in_pi[kFwdPairs], in_po[kFwdPairs], in_m[kFwdPairs];
#pragma unroll
  for (int p = 0; p < kFwdPairs; ++p) {
    int row, unit;
    fwd_pair(p, row, unit);
    const int b = b0 + row, j = j0 + unit;
    if (b >= B || j >= H) continue;
    const size_t zrow = static_cast<size_t>(b) * H4;
    const size_t hidx = static_cast<size_t>(b) * H + j;
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) in_zx[p][gt] = ld(zx, zrow + static_cast<size_t>(gt) * H + j);
    in_hp[p] = ld(h_prev, hidx);
    in_cp[p] = ld(c_prev, hidx);
    in_pf[p] = ld(pf, j);
    in_pi[p] = ld(pi, j);
    in_po[p] = ld(po, j);
    in_m[p] = kMasked ? ld(mask, b) : 1.f;
  }

  float acc[kFwdPairs][4];
  fwd_block_product<T>(h_prev, rw, B, H, b0, j0, copy_bytes, reinterpret_cast<T*>(smem_raw),
                       reinterpret_cast<float*>(smem_raw), acc);
#pragma unroll
  for (int p = 0; p < kFwdPairs; ++p) {
    int row, unit;
    fwd_pair(p, row, unit);
    const int b = b0 + row, j = j0 + unit;
    if (b >= B || j >= H) continue;
    const size_t hidx = static_cast<size_t>(b) * H + j;
    const float hp = in_hp[p];
    const float cp = in_cp[p];
    // z = zx + (h_prev @ RW).astype(dtype), as _cell_math rounds it
    const float za = rnd<T>(in_zx[p][0] + rnd<T>(acc[p][0]));
    const float zf = rnd<T>(in_zx[p][1] + rnd<T>(acc[p][1]));
    const float zo = rnd<T>(in_zx[p][2] + rnd<T>(acc[p][2]));
    const float zi = rnd<T>(in_zx[p][3] + rnd<T>(acc[p][3]));

    const float a = activate<T>(act, za);
    const float f = activate<T>(gate, rnd<T>(zf + rnd<T>(cp * in_pf[p])));
    const float i = activate<T>(gate, rnd<T>(zi + rnd<T>(cp * in_pi[p])));
    float c = rnd<T>(rnd<T>(f * cp) + rnd<T>(i * a));
    const float o = activate<T>(gate, rnd<T>(zo + rnd<T>(c * in_po[p])));
    const float cact = activate<T>(act, c);
    float h = rnd<T>(o * cact);
    if (kMasked) {
      const float m = in_m[p];
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
}

// The forward's copy pieces: 16 bytes where every row of h (H elements) and
// of RW starts 16-byte aligned (`h_a`, `h_b`: the bases of the h_prev rows
// the steps read); 4 where they start 4-byte aligned; else one element.
// Also lets lstm_step_mma<T, kMasked, kStoreResiduals> take its shared memory.
template <typename T, bool kMasked, bool kStoreResiduals>
cudaError_t fwd_copy_bytes(const void* rw, const void* h_a, const void* h_b, int H,
                           int* copy_bytes) {
  const size_t row_bytes = static_cast<size_t>(H) * sizeof(T);
  const auto all_aligned = [&](size_t n) {
    return row_bytes % n == 0 && aligned_to(rw, n) && aligned_to(h_a, n) && aligned_to(h_b, n);
  };
  *copy_bytes = all_aligned(16) ? 16 : all_aligned(4) ? 4 : static_cast<int>(sizeof(T));
  return cudaFuncSetAttribute(lstm_step_mma<T, kMasked, kStoreResiduals>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kFwdSmemBytes<T>));
}

dim3 fwd_grid(int B, int H) {
  return dim3((H + kFwdUnits - 1) / kFwdUnits, (B + kFwdRows - 1) / kFwdRows);
}

}  // namespace
