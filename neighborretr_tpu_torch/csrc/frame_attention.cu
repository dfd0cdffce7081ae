// Multi-head self-attention on packed qkv, forward and backward:
//
//   out[n, :, h] = softmax(scale · q_h k_h^T + bias_n) v_h      per sequence n
//
// from the packed bf16 [N, L, 3D] output of the qkv projection (q, k, v of
// head h at columns h·64, D + h·64, 2D + h·64 of a row) straight into
// [N, L, D], with an optional additive fp32 bias [N, L, L]; head dim 64, any
// L >= 1.  The forward also writes each row's log-sum-exp, lse [N, H, L]
// fp32, which the backward reads with the forward's output.
//
// Replaces the six TPU kernels of neighborretr_tpu/ops/pallas_attention.py
// (public fused_frame_attention): _attention_core (:290) / _attention_bwd
// (:329) (several frames per grid cell under a frame-block-diagonal mask),
// _attention_core_rows (:430) / _attention_rows_bwd (:459) (query rows in
// chunks for long sequences) and _attention_core_biased (:496) /
// _attention_biased_bwd (:525).  The frame batching, the block-diagonal mask
// and the row chunking are TPU tiling devices; what they compute is the
// per-sequence function above, which one forward and one backward serve here
// at every L, with or without bias.
//
// Rounding points.  As the TPU kernels: q · hd^-0.5 is exact in bf16 (hd =
// 64, a power of two; the kernels scale the fp32 logits by 2^-3 instead);
// logits fp32 (+ bias); probabilities rounded to bf16 for probs · V; out
// accumulated in fp32 and stored as bf16; backward dV = probs16^T · g,
// dprobs = g · v^T in fp32, dlogits · scale rounded to bf16, dQ = dl16 · k,
// dK = dl16^T · q (unscaled), each accumulated in fp32 and rounded once.
// Where a row fits one 64-key tile (L <= 64: every ViT-B/32, text and
// temporal layer) that is all: the forward normalises each probability by
// its row's sum before rounding it, and the backward takes the row's max and
// sum from the tile and delta = sum_k dprobs · probs (fp32), as the TPU
// kernels do.  Past one tile two points move against the TPU kernels (and
// the plain versions in ops/attention.py, which keep the TPU's):
//   forward: the probabilities are rounded to bf16 UNNORMALISED, exp(s - m)
//     against the running row max m, and out is divided by the row's sum l
//     once, after probs · V;
//   backward: the probabilities are exp(s - lse) from the saved lse (fp32,
//     normalised), and delta is rowsum(g ∘ out) from the bf16 out.
// Both stay within the tolerances the plain versions hold the kernels to.
// The exponentials are the hardware's ex2.approx on logits in log2 units; a
// row's sum is applied as its reciprocal.
//
// The kernels and their design: frame_attention.cuh.

#include "frame_attention.cuh"

namespace {

bool bad_shape(int N, int L, int D, int H) {
  return N < 1 || N > 65535 || L < 1 || H < 1 || H > 65535 || D != HD * H;
}

}  // namespace

// qkv [N, L, 3D] bf16, out [N, L, D] bf16, lse [N, H, L] fp32, bias
// [N, L, L] fp32 or null; all contiguous and 16-byte aligned.  Requires
// D == 64 * H.  0, a cudaError_t, or ERR_TENSOR_MAP + libcuda's CUresult
// / ERR_NO_ENCODE where the TMA descriptor cannot be made.
extern "C" int frame_attention_fwd(const void* qkv, const float* bias,
                                   void* out, float* lse, int N, int L, int D,
                                   int H, void* stream) {
  if (bad_shape(N, L, D, H)) return (int)cudaErrorInvalidValue;
  return attention_fwd(static_cast<const bf16*>(qkv), bias,
                       static_cast<bf16*>(out), lse, N, L, D, H,
                       (cudaStream_t)stream);
}

// qkv [N, L, 3D], g [N, L, D], out [N, L, D] (the forward's), dqkv
// [N, L, 3D] bf16; lse [N, H, L] fp32 (the forward's); stats [N, H, 3, L]
// fp32 scratch; bias [N, L, L] fp32 or null; all contiguous, the bf16 ones
// 16-byte aligned.  Every element of dqkv is written.
extern "C" int frame_attention_bwd(const void* qkv, const float* bias,
                                   const void* g, const void* out,
                                   const float* lse, float* stats, void* dqkv,
                                   int N, int L, int D, int H, void* stream) {
  if (bad_shape(N, L, D, H)) return (int)cudaErrorInvalidValue;
  return attention_bwd(static_cast<const bf16*>(qkv), bias,
                       static_cast<const bf16*>(g),
                       static_cast<const bf16*>(out), lse, stats,
                       static_cast<bf16*>(dqkv), nullptr, N, L, D, H,
                       (cudaStream_t)stream);
}
