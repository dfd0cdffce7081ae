// Fused pre-LN attention sublayer, backward of
//   y = x + W_o · MHA(LN(x) · W_qkv + b_qkv) + b_o.
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_block_attention.py::
// _make_bwd_ln_kernel, launched by _ln_bwd_call (the custom VJP of
// fused_ln_attention_residual), without and with the per-sequence bias.
// With the template flag LN off (entry attention_sublayer_bwd: K11) the
// same stages compute the backward of y = W_o · MHA(h · W_qkv + b_qkv) + b_o
// on a pre-normalised h, replacing the same file's _bwd_kernel and
// _bwd_kernel_biased (_block_attention_bwd, _block_attention_biased_bwd):
// h is read as it is, and dh (bf16) comes straight out of its product.
// Like the TPU kernel it saves nothing from the forward: LN, qkv and the
// probabilities are recomputed from x.  Outputs: dx (bf16) and, in fp32,
// dLN scale/bias, dW_qkv [3D, D], db_qkv, dW_o [D, D], db_o, each summed
// over all N·L rows.  The bias gets no gradient.
//
// Rounding points follow the TPU kernel one for one, so the plain PyTorch
// backward (ops/block_attention.py) can hold this one to a bf16-ulp bound:
//   h, qkv, scaled q, probs as in the forward; g (= dy) is bf16;
//   dattn = g · W_o rounded to bf16; dv = probs16^T · dattn,
//   dprobs = dattn · v^T, dlogits = probs32 · (dprobs - sum_k dprobs·probs32)
//   in fp32, (dlogits · hd^-0.5) rounded to bf16 for dq and dk (dk against
//   the unscaled bf16 q); dqkv rounded to bf16 for dh and dW_qkv but summed
//   in fp32 for db_qkv; dLN and dx from the fp32 dh; db_o from g in fp32.
//
// What bounds it on an H100: the six M-row products, 22·M·D² FLOP with the
// recompute (1.0 TFLOP per vision layer at M = 76,800, D = 768), on the
// bf16 tensor cores.
//
// Design: the stages of sublayer.cuh over all M rows at once; every
// operand is read as it lies (the transposed ones through wgmma's MN-major
// form), with no transposed copy anywhere:
//   1-3. forward_stages: h16 = LN(x) (K3), qkv, attn_out and lse (K8);
//   4. gemm: dattn[M, D] = g · W_o (W_o MN-major), bf16 out;
//   5. the attention backward per (sequence, head): K9's dQ and dK/dV
//      kernels (frame_attention.cuh), which also write the fp32 column sums
//      of dq, dk, dv per sequence (db_qkv's summands before rounding);
//   6. gemm: dh[M, D] = dqkv16 · W_qkv (W_qkv MN-major): fp32 (K3) or
//      straight into dx as bf16 (K11);
//   7. ln_bwd_rows_kernel, a warp per row: LN backward + residual -> dx,
//      and per-block partials of dLN scale/bias and db_o (K11: db_o only);
//   8. gemm: dW_qkv = dqkv16ᵀ · h16 and dW_o = g16ᵀ · attn_out16, both
//      operands MN-major, the M rows split into ranges whose fp32 copies
//      are added in range order;
//   9. reduce_rows8 over the partials of 5 and 7, in row order.
// No float atomics anywhere: two runs give the same bits.

#include "sublayer.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm backward + residual (LN), or db_o alone (!LN: K11, whose dx is
// dh itself), a warp per row, LN_ROWS rows per block; lane l takes column
// pairs 2l + 64i (D a multiple of 64)
// ---------------------------------------------------------------------------
constexpr size_t LN_SMEM = 227 * 1024;   // 8 warps x 3 x D fp32 sums

template <bool LN>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const float* __restrict__ dh, const float* __restrict__ ln_w,
                   bf16* __restrict__ dx, float* __restrict__ part, int M,
                   int D, float eps) {
  // per warp: running sums over its rows of dh·xhat, dh and g  [8][3][D]
  extern __shared__ __align__(16) float acc[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* a_gs = acc + (size_t)warp * 3 * D;
  float* a_gb = a_gs + D;
  float* a_bo = a_gb + D;
  for (int d = lane; d < 3 * D; d += 32) a_gs[d] = 0.f;
  __syncwarp();

  auto ld2 = [](const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  };
  const int row0 = blockIdx.x * LN_ROWS;
  const int row1 = min(M, row0 + LN_ROWS);
  for (int row = row0 + warp; row < row1; row += 8) {
    const bf16* gr = g + (size_t)row * D;
    if constexpr (!LN) {
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 gv = ld2(gr + d);
        a_bo[d] += gv.x;
        a_bo[d + 1] += gv.y;
      }
    } else {
      const bf16* xr = x + (size_t)row * D;
      const float* dr = dh + (size_t)row * D;
      float s = 0.f;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 xv = ld2(xr + d);
        s += xv.x + xv.y;
      }
      const float mean = warp_sum(s) / D;
      float ss = 0.f;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 xv = ld2(xr + d);
        ss += (xv.x - mean) * (xv.x - mean) + (xv.y - mean) * (xv.y - mean);
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
      float sa = 0.f, sb = 0.f;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 xv = ld2(xr + d);
        const float2 dv = *reinterpret_cast<const float2*>(dr + d);
        const float gd0 = dv.x * ln_w[d], gd1 = dv.y * ln_w[d + 1];
        sa += gd0 + gd1;
        sb += gd0 * ((xv.x - mean) * rstd) + gd1 * ((xv.y - mean) * rstd);
      }
      const float m1 = warp_sum(sa) / D, m2 = warp_sum(sb) / D;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 xv = ld2(xr + d);
        const float2 dv = *reinterpret_cast<const float2*>(dr + d);
        const float2 gv = ld2(gr + d);
        const float xh0 = (xv.x - mean) * rstd, xh1 = (xv.y - mean) * rstd;
        const float gd0 = dv.x * ln_w[d], gd1 = dv.y * ln_w[d + 1];
        store2(dx + (size_t)row * D + d, gv.x + rstd * (gd0 - m1 - xh0 * m2),
               gv.y + rstd * (gd1 - m1 - xh1 * m2));
        a_gs[d] += dv.x * xh0;
        a_gs[d + 1] += dv.y * xh1;
        a_gb[d] += dv.x;
        a_gb[d + 1] += dv.y;
        a_bo[d] += gv.x;
        a_bo[d + 1] += gv.y;
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 3 * D; d += 256) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += acc[(size_t)w * 3 * D + d];
    part[(size_t)blockIdx.x * 3 * D + d] = s;
  }
}

// LN: the backward of y = x + W_o · MHA(LN(x)) + b_o (K3); !LN: of
// y = W_o · MHA(x) + b_o (K11), where dx = dh and dLN stays zero
template <bool LN>
int sublayer_bwd(const void* x, const float* bias, const float* ln_w,
                 const float* ln_b, const void* w_qkv, const float* b_qkv,
                 const void* w_out, const void* g, void* work, void* dx,
                 float* dln, float* dw_qkv, float* db_qkv, float* dw_out,
                 int N, int L, int D, int H, float eps, void* stream) {
  if (bad_sublayer(N, L, D, H, LN)) return (int)cudaErrorInvalidValue;
  const int M = N * L;
  const int E = HD * H;     // the attention's width: D, or a TP part of it
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  bf16* dxb = static_cast<bf16*>(dx);
  Work w;
  carve(work, N, L, D, H, LN, true, w);
  const bf16* h = LN ? w.h16 : xb;

  // 1-3. h16, qkv, attn_out and lse, as the forward computes them
  if (int err = forward_stages<LN>(xb, bias, ln_w, ln_b, wq, b_qkv, w, N, L,
                                   D, H, eps, s))
    return err;
  // 4. dattn = g · W_o
  if (int err = gemm<false, true, false, false, bf16>(
          gb, static_cast<const bf16*>(w_out), w.dattn, nullptr, nullptr, M,
          E, D, nullptr, s))
    return err;
  // 5. the attention backward: dqkv (bf16) and its fp32 column sums
  if (int err = attention_bwd(w.qkv, bias, w.dattn, w.attn, w.lse, w.stats,
                              w.dqkv, w.part_db, N, L, E, H, s))
    return err;
  // 6. dh = dqkv16 · W_qkv
  int err = LN ? gemm<false, true, false, false, float>(
                     w.dqkv, wq, w.dh, nullptr, nullptr, M, D, 3 * E,
                     nullptr, s)
               : gemm<false, true, false, false, bf16>(
                     w.dqkv, wq, dxb, nullptr, nullptr, M, D, 3 * E, nullptr,
                     s);
  if (err) return err;
  // 7. LN backward + residual (or db_o alone): dx, partials of dLN and db_o
  const int nblk = (M + LN_ROWS - 1) / LN_ROWS;
  const size_t ln_smem = (size_t)8 * 3 * D * sizeof(float);
  static const cudaError_t e_ln = allow_smem(ln_bwd_rows_kernel<LN>, LN_SMEM);
  if (e_ln != cudaSuccess) return (int)e_ln;
  if (ln_smem > LN_SMEM) return (int)cudaErrorInvalidValue;
  ln_bwd_rows_kernel<LN><<<nblk, 256, ln_smem, s>>>(
      xb, gb, w.dh, ln_w, dxb, w.part_ln, M, D, eps);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  // 8. dW_qkv = dqkv16ᵀ · h16, dW_o = g16ᵀ · attn_out16
  if ((err = gemm<true, true, false, false, float>(
           w.dqkv, h, dw_qkv, nullptr, nullptr, 3 * E, D, M, w.part_w, s)))
    return err;
  if ((err = gemm<true, true, false, false, float>(
           gb, w.attn, dw_out, nullptr, nullptr, D, E, M, w.part_w, s)))
    return err;
  // 9. ordered sums of the row partials
  if (cudaError_t e = reduce_rows8(w.part_db, db_qkv, N, 3 * E, s))
    return (int)e;
  return (int)reduce_rows8(w.part_ln, dln, nblk, 3 * D, s);
}

}  // namespace

// bytes of scratch one call takes: ln = 1 for ln_attention_residual_bwd,
// 0 for attention_sublayer_bwd
extern "C" size_t ln_attention_residual_bwd_workspace(int N, int L, int D,
                                                      int H, int ln) {
  Work w;
  return carve(nullptr, N, L, D, H, ln != 0, true, w);
}

// Shapes (all contiguous):
//   in:  x, g [N, L, D] bf16; bias [N, L, L] fp32 or null; ln_w, ln_b [D],
//        b_qkv [3D] fp32; w_qkv [3D, D], w_out [D, D] bf16;
//   scratch: work, ln_attention_residual_bwd_workspace(N, L, D, H, 1) bytes,
//        256-byte aligned;
//   out: dx [N, L, D] bf16; dln [3, D] fp32 (dLN scale, dLN bias, db_o);
//        dw_qkv [3D, D], db_qkv [3D], dw_out [D, D] fp32.
// Requires D == 64 * H, 1 <= L <= 64, N·L <= 65535 · 128, D <= 2368.
extern "C" int ln_attention_residual_bwd(
    const void* x, const float* bias, const float* ln_w, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_out, const void* g,
    void* work, void* dx, float* dln, float* dw_qkv, float* db_qkv,
    float* dw_out, int N, int L, int D, int H, float eps, void* stream) {
  return sublayer_bwd<true>(x, bias, ln_w, ln_b, w_qkv, b_qkv, w_out, g, work,
                            dx, dln, dw_qkv, db_qkv, dw_out, N, L, D, H, eps,
                            stream);
}

// K11: the backward of attention_sublayer_fwd (neighborretr_tpu/ops/
// pallas_block_attention.py::_block_attention_bwd and
// _block_attention_biased_bwd): h in place of x, dh in place of dx, rows 0
// and 1 of dln zero; work of ln_attention_residual_bwd_workspace(N, L, D,
// H, 0) bytes; shapes and requirements as above, but that the H heads may
// be a part of the model's (tensor parallelism): with E = 64·H, w_qkv,
// dw_qkv [3E, D], b_qkv, db_qkv [3E], w_out, dw_out [D, E]; D a multiple
// of 64.
extern "C" int attention_sublayer_bwd(
    const void* h, const float* bias, const void* w_qkv, const float* b_qkv,
    const void* w_out, const void* g, void* work, void* dh, float* dln,
    float* dw_qkv, float* db_qkv, float* dw_out, int N, int L, int D, int H,
    void* stream) {
  return sublayer_bwd<false>(h, bias, nullptr, nullptr, w_qkv, b_qkv, w_out,
                             g, work, dh, dln, dw_qkv, db_qkv, dw_out, N, L, D,
                             H, 0.f, stream);
}

// The attention-backward stage alone, for its tests: K9's kernels on qkv
// [N, L, 3D], g [N, L, D] and the forward's out and lse → dqkv [N, L, 3D]
// bf16 and part_db [N, 3D] fp32, each sequence's column sums of dqkv before
// rounding; stats [N, H, 3, L] scratch.  1 <= L <= 64.
extern "C" int sublayer_core_bwd(const void* qkv, const float* bias,
                                 const void* g, const void* out,
                                 const float* lse, float* stats, void* dqkv,
                                 float* part_db, int N, int L, int D, int H,
                                 void* stream) {
  if (bad_sublayer(N, L, D, H, true)) return (int)cudaErrorInvalidValue;
  return attention_bwd(static_cast<const bf16*>(qkv), bias,
                       static_cast<const bf16*>(g),
                       static_cast<const bf16*>(out), lse, stats,
                       static_cast<bf16*>(dqkv), part_db, N, L, D, H,
                       (cudaStream_t)stream);
}
