// Peephole-LSTM sequence forward for Hopper (sm_90a): the lean inference
// primal and the training forward that also streams the residuals.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_seq_lean_impl (the
// pallas_call of _seq_lean_kernel with the math of _cell_math), in both of
// its static modes, unmasked and masked (dl4j_lstm_seq_lean); and
// _seq_fwd_impl (the pallas_call of _seq_fwd_kernel), the forward rule of
// the sequence VJP, which also writes a, f, o, i and c of every step
// (dl4j_lstm_seq_train_fwd, the kStoreResiduals instantiation of the same
// step kernel); and _seq_masked_fwd_impl (the pallas_call of
// _seq_fwd_kernel_masked), the forward rule of the masked VJP
// (dl4j_lstm_seq_masked_train_fwd, kMasked and kStoreResiduals: a, f, o, i
// are stored at every step, masked or not, and the c stream holds the c
// carried on, after the mask). For each step t:
//   z = zx[t] + h_prev @ RW                  (product accumulated in f32)
//   a = act(z[:, :H])
//   f = gate(z[:, H:2H] + c_prev * pF),  i = gate(z[:, 3H:] + c_prev * pI)
//   c = f * c_prev + i * a
//   o = gate(z[:, 2H:3H] + c * pO),      h = o * act(c)
//   masked: h = m*h + (1-m)*h_prev, c = m*c + (1-m)*c_prev
//   ys[t] = h; (h, c) carried to t+1.
// Gate columns are [a, f, o, i]; sigmoid is the tanh form the Pallas kernels
// use. In bf16 every elementwise result is rounded to bf16 where the plain
// PyTorch version (ops/lstm_sequence.py) rounds it, so the two agree closely.
//
// What bounds it on this card: each step reads all of RW (H x 4H: 4 MiB f32,
// 2 MiB bf16 at H=512) and does 2*B*H*4H operations, but step t+1 needs all
// of step t's h. At the batch sizes served (B=64 full batch, B=8 decode
// ticks) one step is far too small to fill the card, so the sequence is a
// chain of T small launches and latency, not bytes or operations, sets its
// time (PERF.md rows 5, 6 and 8). RW stays in the 50 MB L2 from one step to
// the next.
//
// Design: a TPU grid runs in order and carries h/c in VMEM; Hopper blocks run
// in no order, so the time loop lives on the host. One C call runs T launches
// of lstm_mma.cuh's lstm_step_mma on the caller's stream. Each block owns
// kFwdRows batch rows x kFwdUnits hidden units and all four gate columns of
// those units, so the gate math and the c/h update stay in the block with no
// exchange between blocks. The h_prev @ RW product runs on the tensor cores
// (mma.sync: bf16 m16n8k16 with f32 sums, f32 in 3xTF32 with each k step's
// sum added to the f32 sum): k = H streams through a cp.async ring in
// 512-byte chunks of h_prev's rows (A) and RW's rows at the block's columns
// (B), each chunk split into eight k slices, a warp each, whose partial
// products are added through shared memory in slice order. A 16 x 16 tile
// gives 128 blocks at B=64, H=512, one per SM
// (scripts/torch_lstm_fwd_tiles.py times other tiles, rings and chunks).
// ys[t-1] is h_prev for step t; c ping-pongs between two scratch buffers,
// or, in the training forward, is the c residual stream itself. The
// residuals add 5*T*B*H stored elements and no operations. Later work: a
// persistent kernel with RW split across SMs, wgmma.

#include "lstm_mma.cuh"

namespace {

template <typename T, bool kMasked>
cudaError_t run_sequence(const void* zx_v, const void* mask_v, const void* h0_v,
                         const void* c0_v, const void* rw_v, const void* pf_v,
                         const void* pi_v, const void* po_v, void* ys_v,
                         void* hT_v, void* cT_v, void* cbuf_v, int steps, int B,
                         int H, int act, int gate, cudaStream_t stream) {
  const T* zx = static_cast<const T*>(zx_v);
  const T* mask = static_cast<const T*>(mask_v);
  T* ys = static_cast<T*>(ys_v);
  T* cbuf = static_cast<T*>(cbuf_v);
  const size_t BH = static_cast<size_t>(B) * H;
  int copy_bytes;
  cudaError_t err = fwd_copy_bytes<T, kMasked, false>(rw_v, h0_v, ys_v, H, &copy_bytes);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(kFwdSmemBytes<T>);
  for (int t = 0; t < steps; ++t) {
    const bool last = t == steps - 1;
    const T* hp = t == 0 ? static_cast<const T*>(h0_v) : ys + (t - 1) * BH;
    const T* cp = t == 0 ? static_cast<const T*>(c0_v) : cbuf + ((t - 1) & 1) * BH;
    T* co = last ? static_cast<T*>(cT_v) : cbuf + (t & 1) * BH;
    lstm_step_mma<T, kMasked, false><<<fwd_grid(B, H), kFwdThreads, smem, stream>>>(
        zx + t * 4 * BH, kMasked ? mask + static_cast<size_t>(t) * B : nullptr,
        hp, cp, static_cast<const T*>(rw_v), static_cast<const T*>(pf_v),
        static_cast<const T*>(pi_v), static_cast<const T*>(po_v), ys + t * BH, co,
        last ? static_cast<T*>(hT_v) : nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        B, H, act, gate, copy_bytes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Training forward: as run_sequence, and every step also stores a, f, o, i
// and c into [steps, B, H] streams; c[t-1] is c_prev of step t. `mask_v` is
// null for the unmasked mode.
template <typename T, bool kMasked>
cudaError_t run_sequence_train(const void* zx_v, const void* mask_v, const void* h0_v,
                               const void* c0_v, const void* rw_v, const void* pf_v,
                               const void* pi_v, const void* po_v, void* ys_v, void* a_v,
                               void* f_v, void* o_v, void* i_v, void* c_v, void* hT_v,
                               void* cT_v, int steps, int B, int H, int act, int gate,
                               cudaStream_t stream) {
  const T* zx = static_cast<const T*>(zx_v);
  const T* mask = static_cast<const T*>(mask_v);
  T* ys = static_cast<T*>(ys_v);
  T* c = static_cast<T*>(c_v);
  const size_t BH = static_cast<size_t>(B) * H;
  int copy_bytes;
  cudaError_t err = fwd_copy_bytes<T, kMasked, true>(rw_v, h0_v, ys_v, H, &copy_bytes);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(kFwdSmemBytes<T>);
  for (int t = 0; t < steps; ++t) {
    const size_t off = t * BH;
    const T* hp = t == 0 ? static_cast<const T*>(h0_v) : ys + off - BH;
    const T* cp = t == 0 ? static_cast<const T*>(c0_v) : c + off - BH;
    lstm_step_mma<T, kMasked, true><<<fwd_grid(B, H), kFwdThreads, smem, stream>>>(
        zx + 4 * off, kMasked ? mask + static_cast<size_t>(t) * B : nullptr, hp, cp,
        static_cast<const T*>(rw_v),
        static_cast<const T*>(pf_v), static_cast<const T*>(pi_v),
        static_cast<const T*>(po_v), ys + off, c + off,
        t == steps - 1 ? static_cast<T*>(hT_v) : nullptr, static_cast<T*>(a_v) + off,
        static_cast<T*>(f_v) + off, static_cast<T*>(o_v) + off, static_cast<T*>(i_v) + off,
        nullptr, B, H, act, gate, copy_bytes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // c_T is the last row of the c stream
  return cudaMemcpyAsync(cT_v, c + (steps - 1) * BH, BH * sizeof(T),
                         cudaMemcpyDeviceToDevice, stream);
}

}  // namespace

// Runs the whole sequence: `steps` launches of lstm_step_mma on `stream`. `mask` is
// null for the unmasked mode. `cbuf` is scratch of 2*B*H elements. Returns
// the CUDA error code of the first launch that failed, 0 when all launched.
extern "C" int dl4j_lstm_seq_lean(const void* zx, const void* mask,
                                  const void* h0, const void* c0, const void* rw,
                                  const void* pf, const void* pi, const void* po,
                                  void* ys, void* hT, void* cT, void* cbuf,
                                  int steps, int B, int H, int act, int gate,
                                  int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (mask != nullptr)
      return run_sequence<__nv_bfloat16, true>(zx, mask, h0, c0, rw, pf, pi, po, ys, hT,
                                               cT, cbuf, steps, B, H, act, gate, s);
    return run_sequence<__nv_bfloat16, false>(zx, mask, h0, c0, rw, pf, pi, po, ys, hT,
                                              cT, cbuf, steps, B, H, act, gate, s);
  }
  if (mask != nullptr)
    return run_sequence<float, true>(zx, mask, h0, c0, rw, pf, pi, po, ys, hT, cT, cbuf,
                                     steps, B, H, act, gate, s);
  return run_sequence<float, false>(zx, mask, h0, c0, rw, pf, pi, po, ys, hT, cT, cbuf, steps,
                                    B, H, act, gate, s);
}

// Runs the training forward: `steps` launches of lstm_step_mma that also store
// the residuals a, f, o, i, c ([steps, B, H] each), then copies c_T out of
// the c stream. Returns the CUDA error code of the first launch or copy that
// failed, 0 when all were issued.
extern "C" int dl4j_lstm_seq_train_fwd(const void* zx, const void* h0, const void* c0,
                                       const void* rw, const void* pf, const void* pi,
                                       const void* po, void* ys, void* a, void* f, void* o,
                                       void* i, void* c, void* hT, void* cT, int steps,
                                       int B, int H, int act, int gate, int bf16,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_sequence_train<__nv_bfloat16, false>(zx, nullptr, h0, c0, rw, pf, pi, po, ys,
                                                    a, f, o, i, c, hT, cT, steps, B, H, act,
                                                    gate, s);
  return run_sequence_train<float, false>(zx, nullptr, h0, c0, rw, pf, pi, po, ys, a, f, o,
                                          i, c, hT, cT, steps, B, H, act, gate, s);
}

// The masked training forward (`mask` [steps, B]; a step whose mask is 0
// holds h and c): as dl4j_lstm_seq_train_fwd, the c stream and c_T after the
// mask, a, f, o, i before it.
extern "C" int dl4j_lstm_seq_masked_train_fwd(const void* zx, const void* mask,
                                              const void* h0, const void* c0, const void* rw,
                                              const void* pf, const void* pi, const void* po,
                                              void* ys, void* a, void* f, void* o, void* i,
                                              void* c, void* hT, void* cT, int steps, int B,
                                              int H, int act, int gate, int bf16,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_sequence_train<__nv_bfloat16, true>(zx, mask, h0, c0, rw, pf, pi, po, ys, a,
                                                   f, o, i, c, hT, cT, steps, B, H, act,
                                                   gate, s);
  return run_sequence_train<float, true>(zx, mask, h0, c0, rw, pf, pi, po, ys, a, f, o, i, c,
                                         hT, cT, steps, B, H, act, gate, s);
}
