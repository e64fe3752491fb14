// Per-step peephole-LSTM cell for Hopper (sm_90a): one step forward, and its
// backward.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_cell_fwd_impl (the
// pallas_call of _fwd_kernel over _cell_math; dl4j_lstm_cell_fwd) and
// _cell_bwd (the pallas_call of _bwd_kernel; dl4j_lstm_cell_bwd), the forward
// and backward rules of fused_lstm_cell's custom VJP. For one step, zx being
// this step's hoisted x @ W + b:
//   forward:  z = zx + h_prev @ RW (accumulated in f32, rounded to the type);
//             a = act(z_a), f = gate(z_f + c_prev*pF), i = gate(z_i + c_prev*pI),
//             c = f*c_prev + i*a, o = gate(z_o + c*pO), h = o*act(c);
//             writes h, c and the residuals a, f, o, i, act(c), all seven,
//             as the TPU kernel does.
//   backward: from the residuals, c_prev, c, h_prev, RW, the peepholes and
//             (dh, dc): dzx = [da, df, do, di] and dc_prev (lstm.cuh's
//             gate_grads), dh_prev = dzx @ RW^T, this step's
//             dRW = h_prev^T @ dzx (both accumulated in f32 and rounded to
//             the type), dpF, dpI, dpO the column sums over B of df*c_prev,
//             di*c_prev, do*c (products and sums in f32, rounded once, as
//             XLA computes jnp.sum of a bf16 product). Every output is in the
//             type of dh, so in bf16 each step's dRW is rounded before the
//             caller sums the steps (unlike the sequence backward, which sums
//             dRW over T in f32: lstm_seq_bwd.cu).
// Sigmoid is the tanh form the Pallas kernels use; in bf16 every elementwise
// result is rounded where the plain PyTorch version (ops/lstm_cell.py) rounds
// it.
//
// What bounds it on this card: one step at B=64, H=512 reads RW (4 MiB f32)
// and does 2*B*H*4H operations (134 MFLOP) forward and twice that backward,
// a bound of 0.81 and 1.6 us in f32 (operations at the 3xTF32 rate), 0.88
// and 1.57 us in bf16 (bytes). One launch, or four, cannot fill the card
// with so little work, so latency, not the bound, sets the time, as in the
// sequence kernels (PERF.md rows 5-9); the caller's Python loop over T adds
// a host round trip per step.
//
// Design: the forward is lstm_seq.cu's step kernel (lstm_mma.cuh's
// lstm_step_mma, the residual-storing instantiation, also writing act(c)),
// launched once: its product on the tensor cores. The backward is four
// launches on the caller's stream: cell_bwd_gates (the elementwise gate
// math, lstm.cuh's kUnits x kRows block layout, and the peephole terms
// summed over the block's rows into an f32 slot per row block), then
// lstm_bwd_dh_mma (dh_prev = dzx @ RW^T on the tensor cores, the sequence
// backward's dh0 product from lstm_mma.cuh), drw_mma (dRW over R = B rows on
// the tensor cores, the sequence backward's dRW product from lstm_drw.cuh;
// drw_reduce too when the caller splits R) and peephole_reduce (the slots
// summed), shared with the sequence backward. No atomics: the result does
// not depend on the order blocks run in. Later work: one persistent launch,
// or a CUDA graph, for a sequence of cells.

#include "lstm_drw.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_bwd_gates(const T* __restrict__ a_r, const T* __restrict__ f_r,
               const T* __restrict__ o_r, const T* __restrict__ i_r,
               const T* __restrict__ cact_r,  // [B, H] each: forward residuals
               const T* __restrict__ c_prev, const T* __restrict__ c,  // [B, H]
               const T* __restrict__ pf, const T* __restrict__ pi,
               const T* __restrict__ po,      // [H] each
               const T* __restrict__ dh_in, const T* __restrict__ dc_in,  // [B, H]
               T* __restrict__ dzx,           // [B, 4H]
               T* __restrict__ dc_prev,       // [B, H]
               float* __restrict__ psum,      // [gridDim.y, 3, H]
               int B, int H, int act, int gate) {
  const int u = threadIdx.x % kUnits;
  const int r = threadIdx.x / kUnits;
  const int j = blockIdx.x * kUnits + u;
  const int b = blockIdx.y * kRows + r;
  float tf = 0.f, ti = 0.f, to = 0.f;  // this thread's peephole terms
  if (b < B && j < H) {
    const size_t hidx = static_cast<size_t>(b) * H + j;
    const float cp = ld(c_prev, hidx);
    const GateGrads g =
        gate_grads<T>(ld(dh_in, hidx), ld(dc_in, hidx), ld(a_r, hidx), ld(f_r, hidx),
                      ld(o_r, hidx), ld(i_r, hidx), ld(cact_r, hidx), cp, ld(pf, j),
                      ld(pi, j), ld(po, j), act, gate);
    store_dzx(dzx, g, b, j, H);
    st(dc_prev, hidx, g.dc_prev);
    // the products in f32, not rounded to the type: XLA forms them in f32
    // for the f32 sum of a bf16 jnp.sum
    tf = __fmul_rn(g.d_f, cp);
    ti = __fmul_rn(g.d_i, cp);
    to = __fmul_rn(g.d_o, ld(c, hidx));
  }
  peephole_partials(tf, ti, to, psum, H);
}

template <typename T>
cudaError_t run_forward(const void* zx, const void* h_prev, const void* c_prev, const void* rw,
                        const void* pf, const void* pi, const void* po, void* h, void* c,
                        void* a, void* f, void* o, void* i, void* cact, int B, int H, int act,
                        int gate, cudaStream_t stream) {
  int copy_bytes;
  const cudaError_t err = fwd_copy_bytes<T, false, true>(rw, h_prev, h_prev, H, &copy_bytes);
  if (err != cudaSuccess) return err;
  lstm_step_mma<T, false, true>
      <<<fwd_grid(B, H), kFwdThreads, static_cast<int>(kFwdSmemBytes<T>), stream>>>(
          static_cast<const T*>(zx), nullptr, static_cast<const T*>(h_prev),
          static_cast<const T*>(c_prev), static_cast<const T*>(rw), static_cast<const T*>(pf),
          static_cast<const T*>(pi), static_cast<const T*>(po), static_cast<T*>(h),
          static_cast<T*>(c), nullptr, static_cast<T*>(a), static_cast<T*>(f),
          static_cast<T*>(o), static_cast<T*>(i), static_cast<T*>(cact), B, H, act, gate,
          copy_bytes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_backward(const void* a, const void* f, const void* o, const void* i,
                         const void* cact, const void* c_prev, const void* c,
                         const void* h_prev, const void* rw_v, const void* pf,
                         const void* pi, const void* po, const void* dh, const void* dc,
                         void* dzx_v, void* dh_prev, void* dc_prev, void* drw, void* dpf,
                         void* dpi, void* dpo, void* drw_part, void* psum_v, int B, int H,
                         int act, int gate, int drw_slices, cudaStream_t stream) {
  const T* rw = static_cast<const T*>(rw_v);
  T* dzx = static_cast<T*>(dzx_v);
  float* psum = static_cast<float*>(psum_v);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  cell_bwd_gates<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(f), static_cast<const T*>(o),
      static_cast<const T*>(i), static_cast<const T*>(cact), static_cast<const T*>(c_prev),
      static_cast<const T*>(c), static_cast<const T*>(pf), static_cast<const T*>(pi),
      static_cast<const T*>(po), static_cast<const T*>(dh), static_cast<const T*>(dc), dzx,
      static_cast<T*>(dc_prev), psum, B, H, act, gate);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int wide;
  err = bwd_copy_wide<T>(dzx, rw, H, &wide);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(kSmemBytes<T>);
  err = cudaFuncSetAttribute(lstm_bwd_dh_mma<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 dh_grid((H + kBwdUnits - 1) / kBwdUnits, (B + kBwdRows - 1) / kBwdRows);
  lstm_bwd_dh_mma<T, false><<<dh_grid, kBwdThreads, smem, stream>>>(
      dzx, rw, nullptr, nullptr, static_cast<T*>(dh_prev), B, H, wide);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_drw<T>(h_prev, h_prev, dzx, drw, static_cast<float*>(drw_part), B, B, H,
                      drw_slices, stream);
  if (err != cudaSuccess) return err;
  peephole_reduce<T><<<(3 * H + 255) / 256, 256, 0, stream>>>(
      psum, static_cast<T*>(dpf), static_cast<T*>(dpi), static_cast<T*>(dpo),
      static_cast<int>(grid.y), H);
  return cudaGetLastError();
}

}  // namespace

// One step forward on `stream` (B, H > 0): one launch. Returns the CUDA error
// code of the launch, 0 when it launched.
extern "C" int dl4j_lstm_cell_fwd(const void* zx, const void* h_prev, const void* c_prev,
                                  const void* rw, const void* pf, const void* pi,
                                  const void* po, void* h, void* c, void* a, void* f, void* o,
                                  void* i, void* cact, int B, int H, int act, int gate,
                                  int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_forward<__nv_bfloat16>(zx, h_prev, c_prev, rw, pf, pi, po, h, c, a, f, o, i,
                                      cact, B, H, act, gate, s);
  return run_forward<float>(zx, h_prev, c_prev, rw, pf, pi, po, h, c, a, f, o, i, cact, B, H,
                            act, gate, s);
}

// One step backward on `stream` (B, H > 0): the gate math, the dh_prev and dRW
// products and the peephole reduction, four launches (five when dRW's R = B
// rows are split into `drw_slices` > 1 slices, with `drw_part` f32 scratch
// of drw_slices*H*4H). `psum` is f32 scratch of ceil(B/kRows)*3*H (lstm.cuh's
// kRows, 32: ops/lstm_cell.py's CELL_ROW_BLOCK). Returns the CUDA error code
// of the first launch that failed, 0 when all launched.
extern "C" int dl4j_lstm_cell_bwd(const void* a, const void* f, const void* o, const void* i,
                                  const void* cact, const void* c_prev, const void* c,
                                  const void* h_prev, const void* rw, const void* pf,
                                  const void* pi, const void* po, const void* dh,
                                  const void* dc, void* dzx, void* dh_prev, void* dc_prev,
                                  void* drw, void* dpf, void* dpi, void* dpo, void* drw_part,
                                  void* psum, int B, int H, int act, int gate, int drw_slices,
                                  int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_backward<__nv_bfloat16>(a, f, o, i, cact, c_prev, c, h_prev, rw, pf, pi, po, dh,
                                       dc, dzx, dh_prev, dc_prev, drw, dpf, dpi, dpo, drw_part,
                                       psum, B, H, act, gate, drw_slices, s);
  return run_backward<float>(a, f, o, i, cact, c_prev, c, h_prev, rw, pf, pi, po, dh, dc, dzx,
                             dh_prev, dc_prev, drw, dpf, dpi, dpo, drw_part, psum, B, H, act,
                             gate, drw_slices, s);
}
