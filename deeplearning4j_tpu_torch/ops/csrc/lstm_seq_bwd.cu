// Peephole-LSTM sequence backward for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_seq_bwd (the
// pallas_call of _seq_bwd_kernel), the backward rule of the sequence VJP
// (dl4j_lstm_seq_bwd); and _seq_masked_bwd (the pallas_call of
// _seq_bwd_kernel_masked), that of the masked VJP (dl4j_lstm_seq_masked_bwd,
// the kMasked instantiation of the same kernels). Reverse time, t = T-1 .. 0,
// from the residuals of the training forward (a, f, o, i, c [T, B, H], ys
// as h):
//   c_prev, h_prev = c[t-1], ys[t-1]  (c0, h0 at t = 0)
//   c  = f*c_prev + i*a,  cact = act(c)          (recomputed, not stored)
//   dh = dys[t] + dh_carry,  dc = dc_carry       (dhT, dcT at t = T-1)
//   do = dh*cact*gate'(o)
//   dc_tot = dc + dh*o*act'(cact) + do*pO
//   df = dc_tot*c_prev*gate'(f),  di = dc_tot*a*gate'(i),  da = dc_tot*i*act'(a)
//   dzx[t] = [da, df, do, di]
//   dh_carry = (dzx[t] @ RW^T)        (accumulated in f32, rounded to the type)
//   dc_carry = dc_tot*f + df*pF + di*pI
//   dRW += h_prev^T @ dzx[t]; dpF += sum_b df*c_prev; dpI += sum_b di*c_prev;
//   dpO += sum_b do*c                 (all four accumulated in f32)
// and returns dh0 = dh_carry, dc0 = dc_carry after t = 0. Masked, with m the
// step's mask: the gate math takes dh := m*dh and dc := m*dc (c recomputed is
// then the pre-mask c), and what the mask held passes through to t-1:
//   dc_carry += (1-m)*dc,   dh_carry = (dzx[t] @ RW^T) + (1-m)*dh,
// dh and dc taken before the mask (dh0 and dc0 the same after t = 0). dzx is
// 0 at a masked step, so dRW and the peephole sums need no change. Derivatives are
// taken from the activated values (y*(1-y) for the tanh-form sigmoid). In
// bf16 every elementwise result is rounded where the plain PyTorch version
// (ops/lstm_sequence.py:lstm_sequence_backward_reference) rounds it.
//
// What bounds it on this card: 2*B*4H*H*T operations for the recurrent
// product and as many for dRW (68.7 GFLOP at T=256, B=64, H=512), against
// about 380 MB of streams, so operations bound it (PERF.md row 7). As in the
// forward, step t-1 needs all of step t's dzx, so the reverse loop is a chain
// of small launches and latency, not the bound, sets its time.
//
// Design: the TPU grid runs in reverse order and keeps the dh/dc carries and
// the f32 dRW sum in VMEM; Hopper blocks run in no order, so
// - the reverse loop lives on the host: one launch of lstm_bwd_step_mma per
//   step. Each block owns kBwdRows batch rows x kBwdUnits hidden units and
//   all four gate columns of those units. dh_carry needs every 4H column of
//   dzx[t+1], so the exchange goes through global memory: step t starts
//   with the product dzx[t+1] @ RW^T for its rows and units, a C = A B^T of
//   two row-major operands over k = 4H, on the tensor cores (mma.sync:
//   mma_sync.cuh's mma_nt in bf16, m16n8k16 with f32 sums; in f32 its
//   3xTF32 with each k step's sum added to the f32 sum, mma_nt_f32_steps). The
//   k axis streams through a kStages-deep cp.async ring of 1 KB chunks
//   (A: the block's rows of dzx[t+1], B: its units' rows of RW, both read
//   from L2), so the next chunks' copies overlap the current chunk's
//   products. A 16 x 16 tile gives 128 blocks at B=64, H=512, one per SM;
//   the dzx slab is read H/16 times a step (the CUDA-core kernel it
//   replaced: H/8) and RW B/16 times. Each block's eight warps split every
//   chunk into eight k slices, and the slices' partial products are added
//   through shared memory in slice order. (scripts/torch_lstm_bwd_tiles.py
//   times other tiles, rings and chunks on the card; PERF.md §6, PR 10,
//   gives what it read: 32 or 64 rows a block took longer a step, and the
//   ring's depth and the chunk's size moved it little.) No atomics: the
//   result does not depend on the order blocks run in. Then each lane runs
//   the gate epilogue for its element of the tile, its operands loaded
//   before the product. The product (block_product, its copies and
//   fragments) lives in lstm_mma.cuh, which lstm_cell.cu shares for the
//   cell's dh_prev and whose forward step lstm_seq.cu runs. dc ping-pongs
//   between two scratch buffers. One more launch (lstm_bwd_dh_mma, also in
//   lstm_mma.cuh) computes dh0 = dzx[0] @ RW^T with the same product. Masked, step t also needs (1-m[t+1])*dh of step
//   t+1 in its carry: step t+1 stores its pre-mask dh in a [2, B, H]
//   ping-pong buffer, which step t reads (the same element, so the same
//   lane, one launch later).
// - the sums across time are second passes, in f32: dRW is one product of
//   depth R = T*B over the stored h_{t-1} (h0, then ys) and dzx, on the
//   tensor cores (lstm_drw.cuh's drw_mma, split into slices of R that
//   drw_reduce adds in order when the caller asks for them); each step
//   kernel reduces its peephole terms over its rows into a per-step,
//   per-row-block f32 slot, and peephole_reduce sums the slots.
// Later work: a persistent reverse loop, wgmma and TMA for the step's and
// dRW's products.

#include "lstm_drw.cuh"

namespace {

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kBwdThreads)
lstm_bwd_step_mma(const T* __restrict__ dzx_next,  // [B, 4H]: dzx[t+1]; null at t = T-1
                  const T* __restrict__ dh_last,   // [B, H]: dhT, used at t = T-1
                  const T* __restrict__ dy,        // [B, H]: dys[t]
                  const T* __restrict__ dc_in,     // [B, H]: dc carried from t+1 (dcT)
                  const T* __restrict__ a_r, const T* __restrict__ f_r,
                  const T* __restrict__ o_r, const T* __restrict__ i_r,  // [B, H] at t
                  const T* __restrict__ c_prev,    // [B, H]: c[t-1], or c0
                  const T* __restrict__ rw,        // [H, 4H]
                  const T* __restrict__ pf, const T* __restrict__ pi,
                  const T* __restrict__ po,        // [H] each
                  const T* __restrict__ m_t,       // [B]: mask of step t (masked only)
                  const T* __restrict__ m_next,    // [B]: mask of t+1; null at t = T-1
                  const T* __restrict__ dh_next,   // [B, H]: pre-mask dh of t+1 (masked only)
                  T* __restrict__ dh_out,          // [B, H]: this step's pre-mask dh (masked only)
                  T* __restrict__ dzx,             // [B, 4H]: dzx[t]
                  T* __restrict__ dc_out,          // [B, H]: dc carried to t-1 (dc0 at t = 0)
                  float* __restrict__ psum,        // [gridDim.y, 3, H]: this step's slots
                  int B, int H, int act, int gate, int wide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* terms = red + kRedFloats;  // [3][kBwdRows][kBwdUnits]
  const int j0 = blockIdx.x * kBwdUnits;
  const int b0 = blockIdx.y * kBwdRows;

  // this lane's operands, loaded before the product so that their latency
  // hides behind it
  float in_dy[kPairs], in_dc[kPairs], in_a[kPairs], in_f[kPairs], in_o[kPairs],
      in_i[kPairs], in_cp[kPairs], in_carry[kPairs], in_m[kPairs], in_keep_next[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    int row, col;
    lane_elem(e, row, col);
    const int b = b0 + row, j = j0 + col;
    if (b >= B || j >= H) continue;
    const size_t hidx = static_cast<size_t>(b) * H + j;
    in_dy[e] = ld(dy, hidx);
    in_dc[e] = ld(dc_in, hidx);
    in_a[e] = ld(a_r, hidx);
    in_f[e] = ld(f_r, hidx);
    in_o[e] = ld(o_r, hidx);
    in_i[e] = ld(i_r, hidx);
    in_cp[e] = ld(c_prev, hidx);
    // dhT at t = T-1; masked, the pre-mask dh of t+1 that (1-m[t+1]) keeps
    in_carry[e] = dzx_next == nullptr ? ld(dh_last, hidx) : kMasked ? ld(dh_next, hidx) : 0.f;
    in_keep_next[e] = kMasked && dzx_next != nullptr ? sub<T>(1.0f, ld(m_next, b)) : 0.f;
    in_m[e] = kMasked ? ld(m_t, b) : 1.f;
  }

  float rec[kPairs] = {};
  if (dzx_next != nullptr)  // the same for the whole block
    block_product<T>(dzx_next, rw, B, H, b0, j0, wide != 0, smem, red, rec);
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    int row, col;
    lane_elem(e, row, col);
    const int b = b0 + row, j = j0 + col;
    float tf = 0.f, ti = 0.f, to = 0.f;  // this element's peephole terms
    if (b < B && j < H) {
      const size_t hidx = static_cast<size_t>(b) * H + j;
      // dh_scr = (dzx @ RW^T).astype(dtype), plus (1-m)*dh of t+1 when
      // masked; dh = dy + dh_scr
      float dh_carry = in_carry[e];
      if (dzx_next != nullptr) {
        dh_carry = rnd<T>(rec[e]);
        if (kMasked) dh_carry = add<T>(dh_carry, mul<T>(in_keep_next[e], in_carry[e]));
      }
      float dh = add<T>(in_dy[e], dh_carry);
      float dc = in_dc[e];
      // masked: the gate math sees m*dh and m*dc; (1-m)*dc passes to t-1
      // here, (1-m)*dh through dh_out to step t-1's carry
      const float dh_t = dh, dc_t = dc;
      float keep = 0.0f;
      if (kMasked) {
        const float m = in_m[e];
        keep = sub<T>(1.0f, m);
        dh = mul<T>(m, dh_t);
        dc = mul<T>(m, dc_t);
        st(dh_out, hidx, dh_t);
      }
      const float cp = in_cp[e];
      const float a = in_a[e], f = in_f[e], o = in_o[e], i = in_i[e];
      const float c = add<T>(mul<T>(f, cp), mul<T>(i, a));
      const float cact = activate<T>(act, c);
      const GateGrads g = gate_grads<T>(dh, dc, a, f, o, i, cact, cp, ld(pf, j), ld(pi, j),
                                        ld(po, j), act, gate);
      store_dzx(dzx, g, b, j, H);
      float dc_next = g.dc_prev;
      if (kMasked) dc_next = add<T>(dc_next, mul<T>(keep, dc_t));
      st(dc_out, hidx, dc_next);
      tf = mul<T>(g.d_f, cp);
      ti = mul<T>(g.d_i, cp);
      to = mul<T>(g.d_o, c);
    }
    terms[(0 * kBwdRows + row) * kBwdUnits + col] = tf;
    terms[(1 * kBwdRows + row) * kBwdUnits + col] = ti;
    terms[(2 * kBwdRows + row) * kBwdUnits + col] = to;
  }
  __syncthreads();
  // the peephole terms summed over the block's rows in order, in f32, into
  // psum[blockIdx.y][3][H]
  const int tid = threadIdx.x;
  if (tid < 3 * kBwdUnits && j0 + tid % kBwdUnits < H) {
    const int term = tid / kBwdUnits, u = tid % kBwdUnits;
    float s = 0.f;
    for (int rr = 0; rr < kBwdRows; ++rr) s += terms[(term * kBwdRows + rr) * kBwdUnits + u];
    psum[(static_cast<size_t>(blockIdx.y) * 3 + term) * H + j0 + u] = s;
  }
}

// mask_v [steps, B] and dhbuf_v (2*B*H scratch) are null unmasked
template <typename T, bool kMasked>
cudaError_t run_backward(const void* dys_v, const void* dhT_v, const void* dcT_v,
                         const void* mask_v, const void* ys_v, const void* a_v,
                         const void* f_v, const void* o_v, const void* i_v, const void* c_v,
                         const void* h0_v, const void* c0_v, const void* rw_v,
                         const void* pf_v, const void* pi_v, const void* po_v, void* dzx_v,
                         void* dh0_v, void* dc0_v, void* drw_v, void* dpf_v, void* dpi_v,
                         void* dpo_v, void* dcbuf_v, void* dhbuf_v, void* drw_part_v,
                         void* psum_v, int steps, int B, int H, int act, int gate,
                         int drw_slices, cudaStream_t stream) {
  const T* rw = static_cast<const T*>(rw_v);
  const T* c = static_cast<const T*>(c_v);
  const T* mask = static_cast<const T*>(mask_v);
  T* dzx = static_cast<T*>(dzx_v);
  T* dcbuf = static_cast<T*>(dcbuf_v);
  T* dhbuf = static_cast<T*>(dhbuf_v);
  float* psum = static_cast<float*>(psum_v);
  const size_t BH = static_cast<size_t>(B) * H;
  int wide;
  cudaError_t err = bwd_copy_wide<T>(dzx, rw, H, &wide);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(kSmemBytes<T>);
  err = cudaFuncSetAttribute(lstm_bwd_step_mma<T, kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lstm_bwd_dh_mma<T, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kBwdUnits - 1) / kBwdUnits, (B + kBwdRows - 1) / kBwdRows);
  for (int t = steps - 1; t >= 0; --t) {
    const size_t off = t * BH;
    const T* dc_in = t == steps - 1 ? static_cast<const T*>(dcT_v) : dcbuf + ((t + 1) & 1) * BH;
    T* dc_out = t == 0 ? static_cast<T*>(dc0_v) : dcbuf + (t & 1) * BH;
    const bool last = t == steps - 1;
    lstm_bwd_step_mma<T, kMasked><<<grid, kBwdThreads, smem, stream>>>(
        last ? nullptr : dzx + 4 * (off + BH), static_cast<const T*>(dhT_v),
        static_cast<const T*>(dys_v) + off, dc_in, static_cast<const T*>(a_v) + off,
        static_cast<const T*>(f_v) + off, static_cast<const T*>(o_v) + off,
        static_cast<const T*>(i_v) + off,
        t == 0 ? static_cast<const T*>(c0_v) : c + off - BH, rw,
        static_cast<const T*>(pf_v), static_cast<const T*>(pi_v),
        static_cast<const T*>(po_v), kMasked ? mask + static_cast<size_t>(t) * B : nullptr,
        kMasked && !last ? mask + static_cast<size_t>(t + 1) * B : nullptr,
        kMasked ? dhbuf + ((t + 1) & 1) * BH : nullptr,
        kMasked ? dhbuf + (t & 1) * BH : nullptr, dzx + 4 * off, dc_out,
        psum + static_cast<size_t>(t) * grid.y * 3 * H, B, H, act, gate, wide);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  lstm_bwd_dh_mma<T, kMasked><<<grid, kBwdThreads, smem, stream>>>(
      dzx, rw, kMasked ? mask : nullptr, kMasked ? dhbuf : nullptr, static_cast<T*>(dh0_v),
      B, H, wide);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_drw<T>(h0_v, ys_v, dzx, drw_v, static_cast<float*>(drw_part_v), steps * B, B,
                      H, drw_slices, stream);
  if (err != cudaSuccess) return err;
  peephole_reduce<T><<<(3 * H + 255) / 256, 256, 0, stream>>>(
      psum, static_cast<T*>(dpf_v), static_cast<T*>(dpi_v), static_cast<T*>(dpo_v),
      steps * static_cast<int>(grid.y), H);
  return cudaGetLastError();
}

}  // namespace

// Runs the whole backward on `stream`: `steps` reverse-step launches, the dh0
// product, the dRW product (drw_mma, and drw_reduce over `drw_slices` > 1
// slices of R) and the peephole reduction. `dcbuf` is scratch of 2*B*H
// elements, `drw_part` f32 scratch of drw_slices*H*4H (none for one slice),
// `psum` f32 scratch of steps*ceil(B/kBwdRows)*3*H. Returns the CUDA error
// code of the first launch that failed, 0 when all launched.
extern "C" int dl4j_lstm_seq_bwd(const void* dys, const void* dhT, const void* dcT,
                                 const void* ys, const void* a, const void* f, const void* o,
                                 const void* i, const void* c, const void* h0, const void* c0,
                                 const void* rw, const void* pf, const void* pi,
                                 const void* po, void* dzx, void* dh0, void* dc0, void* drw,
                                 void* dpf, void* dpi, void* dpo, void* dcbuf, void* drw_part,
                                 void* psum, int steps, int B, int H, int act, int gate,
                                 int drw_slices, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_backward<__nv_bfloat16, false>(dys, dhT, dcT, nullptr, ys, a, f, o, i, c, h0,
                                              c0, rw, pf, pi, po, dzx, dh0, dc0, drw, dpf,
                                              dpi, dpo, dcbuf, nullptr, drw_part, psum, steps,
                                              B, H, act, gate, drw_slices, s);
  return run_backward<float, false>(dys, dhT, dcT, nullptr, ys, a, f, o, i, c, h0, c0, rw, pf,
                                    pi, po, dzx, dh0, dc0, drw, dpf, dpi, dpo, dcbuf, nullptr,
                                    drw_part, psum, steps, B, H, act, gate, drw_slices, s);
}

// The masked backward (rows of `mask` [steps, B] that are 0 pass dh and dc
// through to the step before): as dl4j_lstm_seq_bwd, with `dhbuf` scratch of
// 2*B*H elements for the pre-mask dh that each step hands to the one before.
extern "C" int dl4j_lstm_seq_masked_bwd(const void* dys, const void* dhT, const void* dcT,
                                        const void* mask, const void* ys, const void* a,
                                        const void* f, const void* o, const void* i,
                                        const void* c, const void* h0, const void* c0,
                                        const void* rw, const void* pf, const void* pi,
                                        const void* po, void* dzx, void* dh0, void* dc0,
                                        void* drw, void* dpf, void* dpi, void* dpo,
                                        void* dcbuf, void* dhbuf, void* drw_part, void* psum,
                                        int steps, int B, int H, int act, int gate,
                                        int drw_slices, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_backward<__nv_bfloat16, true>(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0,
                                             rw, pf, pi, po, dzx, dh0, dc0, drw, dpf, dpi,
                                             dpo, dcbuf, dhbuf, drw_part, psum, steps, B, H,
                                             act, gate, drw_slices, s);
  return run_backward<float, true>(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0, rw, pf, pi,
                                   po, dzx, dh0, dc0, drw, dpf, dpi, dpo, dcbuf, dhbuf,
                                   drw_part, psum, steps, B, H, act, gate, drw_slices, s);
}

// The dRW product alone (R = steps*B rows, each > 0): dRW [H, 4H] =
// sum_r hprev[r]^T dzx[r], hprev row r h0[r] for r < B, else ys[r - B]
// (ys [steps, B, H], of which the first steps-1 are read), with `part` as
// dl4j_lstm_seq_bwd's `drw_part`. Returns the CUDA error code of the first
// launch that failed, 0 when all launched.
extern "C" int dl4j_drw_product(const void* h0, const void* ys, const void* dzx, void* drw,
                                void* part, int R, int B, int H, int slices, int bf16,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (bf16) return launch_drw<__nv_bfloat16>(h0, ys, dzx, drw, p, R, B, H, slices, s);
  return launch_drw<float>(h0, ys, dzx, drw, p, R, B, H, slices, s);
}
