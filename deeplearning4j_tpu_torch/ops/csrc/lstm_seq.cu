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
// ticks) one step is far too small to fill the card, so the sequence is
// latency-bound, not bound by bytes or operations: PERF.md records ~40 us
// per step at both B=8 and B=64, so the time is the serial K loop of one
// block (tile load, sync, FMAs, sync), not the launch and not the work. RW
// (4 MiB) stays in the 50 MB L2 from one step to the next.
//
// Design: a TPU grid runs in order and carries h/c in VMEM; Hopper blocks run
// in no order, so the time loop lives on the host. One C call runs T step
// launches on the caller's stream. Each block owns kUnits hidden units and
// kRows batch rows and computes all four gate columns of those units, so the
// gate math and the c/h update stay in registers with no exchange between
// blocks. The h_prev @ RW product is tiled through shared memory. ys[t-1]
// is h_prev for step t; c ping-pongs between two scratch buffers, or, in the
// training forward, is the c residual stream itself. The residuals add
// 5*T*B*H stored elements and no operations, so the training forward is
// bound as the lean one is (PERF.md row 6). Later
// work: a persistent kernel with RW split across SMs and wgmma for the
// recurrent product.

#include "common.cuh"

namespace {

using namespace dl4j;

constexpr int kUnits = 8;    // hidden units per block
constexpr int kRows = 32;    // batch rows per block
constexpr int kTileK = 64;   // depth of one shared-memory tile of h_prev @ RW
constexpr int kThreads = kUnits * kRows;
constexpr int kCols = 4 * kUnits;  // RW columns a block reads: 4 gates x kUnits

template <typename T, bool kMasked, bool kStoreResiduals>
__global__ void __launch_bounds__(kThreads)
lstm_step(const T* __restrict__ zx,      // [B, 4H] of this step
          const T* __restrict__ mask,    // [B] of this step (masked only)
          const T* __restrict__ h_prev,  // [B, H]
          const T* __restrict__ c_prev,  // [B, H]
          const T* __restrict__ rw,      // [H, 4H]
          const T* __restrict__ pf, const T* __restrict__ pi,
          const T* __restrict__ po,      // [H] each
          T* __restrict__ h_out,         // [B, H]: ys[t]
          T* __restrict__ c_out,         // [B, H]
          T* __restrict__ h_last,        // [B, H]: hT on the last step, else null
          T* __restrict__ a_out, T* __restrict__ f_out,
          T* __restrict__ o_out,
          T* __restrict__ i_out,         // [B, H] each: residuals (kStoreResiduals)
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
  float h = rnd<T>(o * activate<T>(act, c));
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
  }
}

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
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = 0; t < steps; ++t) {
    const bool last = t == steps - 1;
    const T* hp = t == 0 ? static_cast<const T*>(h0_v) : ys + (t - 1) * BH;
    const T* cp = t == 0 ? static_cast<const T*>(c0_v) : cbuf + ((t - 1) & 1) * BH;
    T* co = last ? static_cast<T*>(cT_v) : cbuf + (t & 1) * BH;
    lstm_step<T, kMasked, false><<<grid, kThreads, 0, stream>>>(
        zx + t * 4 * BH, kMasked ? mask + static_cast<size_t>(t) * B : nullptr,
        hp, cp, static_cast<const T*>(rw_v), static_cast<const T*>(pf_v),
        static_cast<const T*>(pi_v), static_cast<const T*>(po_v), ys + t * BH, co,
        last ? static_cast<T*>(hT_v) : nullptr, nullptr, nullptr, nullptr, nullptr, B, H,
        act, gate);
    const cudaError_t err = cudaGetLastError();
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
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = 0; t < steps; ++t) {
    const size_t off = t * BH;
    const T* hp = t == 0 ? static_cast<const T*>(h0_v) : ys + off - BH;
    const T* cp = t == 0 ? static_cast<const T*>(c0_v) : c + off - BH;
    lstm_step<T, kMasked, true><<<grid, kThreads, 0, stream>>>(
        zx + 4 * off, kMasked ? mask + static_cast<size_t>(t) * B : nullptr, hp, cp,
        static_cast<const T*>(rw_v),
        static_cast<const T*>(pf_v), static_cast<const T*>(pi_v),
        static_cast<const T*>(po_v), ys + off, c + off,
        t == steps - 1 ? static_cast<T*>(hT_v) : nullptr, static_cast<T*>(a_v) + off,
        static_cast<T*>(f_v) + off, static_cast<T*>(o_v) + off, static_cast<T*>(i_v) + off,
        B, H, act, gate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // c_T is the last row of the c stream
  return cudaMemcpyAsync(cT_v, c + (steps - 1) * BH, BH * sizeof(T),
                         cudaMemcpyDeviceToDevice, stream);
}

}  // namespace

// Runs the whole sequence: `steps` launches of lstm_step on `stream`. `mask` is
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

// Runs the training forward: `steps` launches of lstm_step that also store
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
