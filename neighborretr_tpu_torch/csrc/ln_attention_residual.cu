// Fused pre-LN attention sublayer, forward:  y = x + W_o · MHA(LN(x)) + b_o.
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_block_attention.py::
// _make_fwd_ln_kernel, launched by _ln_core_call (public
// fused_ln_attention_residual), both without and with the additive
// per-sequence bias [N, L, L] (text causal∧padding, temporal key padding).
// The same stages without LayerNorm and residual (entry
// attention_sublayer_fwd: K10) replace the same file's _block_attention_core
// and _block_attention_biased_core (public fused_attention_sublayer):
// y = W_o · MHA(h) + b_o on a pre-normalised h.
//
// Rounding points follow the TPU kernel so that the plain PyTorch version
// (ops/block_attention.py) can hold this one to it:
//   x bf16 in; LayerNorm in fp32, h rounded to bf16;
//   qkv = h · W_qkv with bf16 operands and fp32 accumulation, + b_qkv (fp32),
//   rounded to bf16; q · hd^-0.5 rounded to bf16 (exact: hd^-0.5 = 2^-3);
//   logits fp32 (+ bias), softmax fp32 with its max subtracted, probs
//   rounded to bf16; attn_out accumulated in fp32, rounded to bf16;
//   y = attn_out · W_o (bf16 operands, fp32 accumulation) + b_o + x in fp32,
//   stored as bf16.
// Weights come in torch's layout: w_qkv is in_proj_weight [3D, D] (the
// transpose of the TPU kernel's input-major [D, 3D]; q|k|v blocks of D rows,
// head h at rows h·hd..(h+1)·hd of each block) and w_out is
// out_proj.weight [D, D] (out, in), both read as they lie.
//
// What bounds it on an H100: the two projections, 8·M·D² FLOP over the M =
// N·L rows (0.36 TFLOP at the vision train shape, N·L = 76,800, D = 768),
// on the bf16 tensor cores; the attention core adds 4·M·L·D.
//
// Design (sublayer.cuh): four stages over all M rows at once, each weight
// tile read once per 128-row tile of activations:
//   1. ln_rows: h16 = LN(x), written once (K1 only; K10 reads h as it is);
//   2. gemm: qkv [M, 3D] = h16 · W_qkvᵀ + b_qkv, TMA ring + wgmma, bf16 out;
//   3. the attention core per (sequence, head) on the packed qkv: K8's
//      forward kernel (frame_attention.cuh), which at L <= 64 holds the
//      whole row in one key tile and keeps the TPU's rounding;
//   4. gemm: y = attn_out · W_oᵀ + b_o (+ x), bias and residual added in
//      fp32 and rounded once.
// The caller gives one scratch buffer (ln_attention_residual_workspace
// bytes) for h16, qkv, attn_out and the core's lse.

#include "sublayer.cuh"

namespace {

// LN: y = x + W_o · MHA(LN(x)) + b_o (K1); !LN: y = W_o · MHA(x) + b_o (K10)
template <bool LN>
int sublayer_fwd(const void* x, const float* bias, const float* ln_w,
                 const float* ln_b, const void* w_qkv, const float* b_qkv,
                 const void* w_out, const float* b_out, void* work, void* y,
                 int N, int L, int D, int H, float eps, void* stream) {
  if (bad_sublayer(N, L, D, H, LN)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  Work w;
  carve(work, N, L, D, H, LN, false, w);
  if (int err = forward_stages<LN>(xb, bias, ln_w, ln_b,
                                   static_cast<const bf16*>(w_qkv), b_qkv, w,
                                   N, L, D, H, eps, s))
    return err;
  return gemm<false, false, true, LN, bf16>(
      w.attn, static_cast<const bf16*>(w_out), static_cast<bf16*>(y), b_out,
      xb, N * L, D, HD * H, nullptr, s);
}

}  // namespace

// bytes of scratch one call takes: ln = 1 for ln_attention_residual_fwd,
// 0 for attention_sublayer_fwd
extern "C" size_t ln_attention_residual_workspace(int N, int L, int D, int H,
                                                  int ln) {
  Work w;
  return carve(nullptr, N, L, D, H, ln != 0, false, w);
}

// x, y [N, L, D] bf16; bias [N, L, L] fp32 or null; ln_w, ln_b [D], b_qkv
// [3D], b_out [D] fp32; w_qkv [3D, D], w_out [D, D] bf16; work: scratch of
// ln_attention_residual_workspace(N, L, D, H, 1) bytes, 256-byte aligned;
// all contiguous.  Requires D == 64 * H, 1 <= L <= 64, N·L <= 65535 · 128.
// 0, a cudaError_t, or a tensor-map error code (hopper.cuh).
extern "C" int ln_attention_residual_fwd(
    const void* x, const float* bias, const float* ln_w, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_out,
    const float* b_out, void* work, void* y, int N, int L, int D, int H,
    float eps, void* stream) {
  return sublayer_fwd<true>(x, bias, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                            work, y, N, L, D, H, eps, stream);
}

// K10: the same without LayerNorm and residual, on a pre-normalised h
// [N, L, D] bf16 (neighborretr_tpu/ops/pallas_block_attention.py::
// _block_attention_core and _block_attention_biased_core); work of
// ln_attention_residual_workspace(N, L, D, H, 0) bytes.  The H heads may be
// a part of the model's (tensor parallelism): with E = 64·H, w_qkv is
// [3E, D] (this part's rows of q, k and v), b_qkv [3E], w_out [D, E] (its
// columns); D a multiple of 64.
extern "C" int attention_sublayer_fwd(
    const void* h, const float* bias, const void* w_qkv, const float* b_qkv,
    const void* w_out, const float* b_out, void* work, void* y, int N, int L,
    int D, int H, void* stream) {
  return sublayer_fwd<false>(h, bias, nullptr, nullptr, w_qkv, b_qkv, w_out,
                             b_out, work, y, N, L, D, H, 0.f, stream);
}

// The GEMM stage alone, for its tests: out[R, C] = A · B with the epilogue
// and orientation of one of the sublayer's products (`kind`):
//   0  A [R, K], B [C, K], + bias, bf16 out            (qkv; K10's y)
//   1  the same + res [R, C] bf16                        (K1's y)
//   2  A [R, K], B [K, C], bf16 out                      (dattn; K11's dh)
//   3  the same, fp32 out                                (K3's dh)
//   4  A [K, R], B [K, C], fp32 out, split over K into part (MAX_SPLITS ·
//      R · C fp32) and summed in range order             (dW_qkv, dW_o)
extern "C" int sublayer_gemm(const void* a, const void* b, void* out,
                             const float* bias, const void* res, float* part,
                             int R, int C, int K, int kind, void* stream) {
  if (R < 1 || C < 1 || K < 1 || C % 64 || (kind == 4 ? R : K) % 64 ||
      (R + GBM - 1) / GBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* X = static_cast<const bf16*>(res);
  bf16* o16 = static_cast<bf16*>(out);
  float* o32 = static_cast<float*>(out);
  switch (kind) {
    case 0: return gemm<false, false, true, false, bf16>(A, B, o16, bias, nullptr, R, C, K, nullptr, s);
    case 1: return gemm<false, false, true, true, bf16>(A, B, o16, bias, X, R, C, K, nullptr, s);
    case 2: return gemm<false, true, false, false, bf16>(A, B, o16, nullptr, nullptr, R, C, K, nullptr, s);
    case 3: return gemm<false, true, false, false, float>(A, B, o32, nullptr, nullptr, R, C, K, nullptr, s);
    case 4: return gemm<true, true, false, false, float>(A, B, o32, nullptr, nullptr, R, C, K, part, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
