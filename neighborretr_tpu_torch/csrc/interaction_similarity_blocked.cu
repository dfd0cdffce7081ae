// Token-interaction similarity at long-token shapes (up to 64 words x 64
// frames), forward and backward: fp32 inputs and outputs, the forward's
// products on the TF32 tensor cores in a 3xTF32 split with fp32 sums.
//
// Replaces the TPU kernels of neighborretr_tpu/ops/pallas_similarity_blocked.py:
// _fwd_kernel (launched by _fwd_pallas, public
// pallas_interaction_similarity_blocked) and _bwd_text_kernel /
// _bwd_video_kernel (launched by _blocked_bwd).  The function is the flat
// kernel's (interaction_similarity.cu),
//
//   S[a,b] = 0.5 * ( sum_t tw[a,t] * max_v <tn[a,t], vn[b,v]>
//                  + sum_v vw[b,v] * max_t <tn[a,t], vn[b,v]> )
//
// on L2-normalised features with the padding masks folded in by the wrapper
// (masked tokens are zero rows whose logits are exactly 0 and take part in
// both maxima), at T, V <= 64.  Each max sends its gradient to the FIRST
// index that attains it; ties are the normal case.
//
// The TPU kernel walks the video-token axis as a sequential grid dimension,
// carries a running (max, first index) pair in scratch between grid steps,
// and in the backward multiplies dense 0/1 indicator slabs on the MXU in
// two grids that both recompute the logits.  Here nothing carries between
// blocks, so a block owns whole (caption, video) pairs:
//
// interaction_similarity_blocked_fwd: similarity_tile.cuh's tile kernel
// (K2's: the [A·T, D] x [D, B·V] product fed by TMA through a ring of
// shared stages, 3xTF32 products with a fresh accumulator per 32-column
// k-chunk added into fp32 sums, both max-reductions and the weighted sums
// in an epilogue over a logits tile in shared memory, with the plain
// version's ascending fmaxf chains, S's weighted sums in double), tiled
// for long tokens: a warpgroup's N = 128 columns are 128 / VP videos x VP
// token slots (VP = V padded to 16, 32 or 64: 2 videos at 64 frames), its
// rows 1-2 captions x 64 token slots (QB captions, MT <= 2 m-tiles: 64
// accumulator and 2 x 64 sum registers a thread).  The per-(row, video) max over v walks VP columns,
// the per-(caption, video, v) max over t the m-tiles' rows.  The forward
// writes S, and under autograd the backward's residuals: m1/i1 (the max
// over v per text token and its first index) and m2/i2 (the max over t per
// video token and its first index), fp32 + one byte, in the layouts of
// similarity_gather.cuh, with S's bits unchanged; an index whose max has a
// runner-up within TIE_GAP carries bit 7 (similarity_tile.cuh), which the
// wrapper resolves in float64 before any backward reads it.  The [A, T,
// B, V] logits never reach device memory.
//
// interaction_similarity_blocked_bwd: no recompute; from those residuals
// the gathers of similarity_gather.cuh, one per side autograd asks for,
// over partner tiles staged in shared memory, each adding the (T + V)
// routed rows per pair in a fixed order: no float atomics, two runs give
// the same bits.  That is 1/32 of the TPU kernel's dense indicator
// products at T = V = 64.
//
// What bounds it on an H100: the forward by the TF32 tensor cores, 3 x
// 2·A·T·B·V·D = 3 x 1.03 TFLOP at (128, 64, 1920, 64, 512), 6.25 ms at
// 494.7 TFLOP/s, and the operand traffic from L2 into shared memory that
// feeds them (48 KB a block per 32-column k-chunk: 16 KB of captions, 32 KB
// of videos); the backward by the gathers' instructions per routed row,
// 2·D FLOP per live (nonzero-weight) token of each pair, at most
// 2·A·B·(T+V)·D per side.

// The bf16 forms' entries (the `_bf16` C functions) are compiled apart:
// interaction_similarity_blocked_bf16.cu includes this file with
// SIMILARITY_BF16_ENTRIES defined, so that each library instantiates only
// the kernels of its own input type and the two build in parallel.

#include "similarity_tile.cuh"

namespace {

constexpr int MAX_TOKENS = 64;
constexpr int MT_MAX = 2;           // m-tiles a block: N = 128 columns

template <int VP, int MT, bool SAVE, typename In>
__global__ void __launch_bounds__(THREADS, 1)
blocked_similarity_kernel(const __grid_constant__ CUtensorMap tm_t,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ tw,
                          const float* __restrict__ vw,
                          float* __restrict__ out, Routing res, int A, int B,
                          int T, int V, int D, int QB, int stages) {
  similarity_tile<MAX_N / VP, VP, MT, SAVE, double, SAVE, In>(
      &tm_t, &tm_v, tw, vw, out, res, A, B, T, V, D, QB, STORE, stages);
}

template <int VP, int MT, bool SAVE, typename In>
int launch(const In* tn, const In* vn, const float* tw, const float* vw,
           float* out, const Routing& res, int A, int B, int T, int V, int D,
           int QB, cudaStream_t stream) {
  constexpr int VIDS = MAX_N / VP;
  CUtensorMap tm_t, tm_v;
  if (int e = tile_maps<VIDS, VP, MT, In>(&tm_t, &tm_v, tn, vn, A, B, T, V,
                                          D, QB))
    return e;
  using Smem = TileSmem<MAX_N, MT, In>;
  auto kern = blocked_similarity_kernel<VP, MT, SAVE, In>;
  static const cudaError_t e = allow_smem(kern, Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<tile_blocks(A, B, QB, VIDS), THREADS, Smem::bytes, stream>>>(
      tm_t, tm_v, tw, vw, out, res, A, B, T, V, D, QB, Smem::stages);
  return (int)cudaGetLastError();
}

template <int VP, bool SAVE, typename In>
int launch_mt(const In* tn, const In* vn, const float* tw, const float* vw,
              float* out, const Routing& r, int A, int B, int T, int V,
              int D, cudaStream_t s) {
  const int qb = block_queries(A, T, MT_MAX);
  return (qb * T + 63) / 64 == 1
             ? launch<VP, 1, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, qb,
                                   s)
             : launch<VP, 2, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, qb,
                                   s);
}

// V padded to 16, 32 or 64 token slots: 8, 4 or 2 videos a warpgroup
template <bool SAVE, typename In>
int launch_vp(const In* tn, const In* vn, const float* tw, const float* vw,
              float* out, const Routing& r, int A, int B, int T, int V,
              int D, cudaStream_t s) {
  if (V <= 16)
    return launch_mt<16, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
  if (V <= 32)
    return launch_mt<32, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
  return launch_mt<64, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
}

inline bool bad_shape(int A, int B, int T, int V, int D) {
  return T < 1 || T > MAX_TOKENS || V < 1 || V > MAX_TOKENS || D < 16 ||
         D % 16 != 0 || A < 1 || B < 1;
}

template <typename In>
int blocked_fwd(const In* tn, const In* vn, const float* tw, const float* vw,
                float* out, const Routing& r, int A, int B, int T, int V,
                int D, cudaStream_t st) {
  if (bad_shape(A, B, T, V, D) || bad_routing(r) ||
      (r.m1 != nullptr && (r.ct == nullptr || r.cv == nullptr)))
    return (int)cudaErrorInvalidValue;
  return r.m1 != nullptr
             ? launch_vp<true>(tn, vn, tw, vw, out, r, A, B, T, V, D, st)
             : launch_vp<false>(tn, vn, tw, vw, out, r, A, B, T, V, D, st);
}

}  // namespace

#ifndef SIMILARITY_BF16_ENTRIES

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned (TMA reads the features).  m1 [A, B, T] and
// m2 [A, B, V] (fp32),
// i1 [A, B, pad16(T)] and i2 [A, B, pad16(V)] (bytes) are the backward's
// residuals: pass all four, or null for all when no gradient will be asked
// for.  With them, ct [A, T] and cv [B, V] (bytes): each token's first
// identical token in its caption / video (near-tie flags skip those).
// Requires T, V <= 64 and D % 16 == 0 (the wrapper checks).
extern "C" int interaction_similarity_blocked_fwd(
    const float* tn, const float* vn, const float* tw, const float* vw,
    float* out, float* m1, unsigned char* i1, float* m2, unsigned char* i2,
    const unsigned char* ct, const unsigned char* cv, int A, int B, int T,
    int V, int D, void* stream) {
  return blocked_fwd(tn, vn, tw, vw, out, Routing{m1, i1, m2, i2, ct, cv}, A,
                     B, T, V, D, (cudaStream_t)stream);
}

// routed_gather_kernel launches made by this library so far.
extern "C" long long interaction_similarity_blocked_gather_launches() {
  return __atomic_load_n(&g_gather_launches, __ATOMIC_RELAXED);
}

// Floats of scratch interaction_similarity_blocked_bwd needs for the
// partial sums of split walks, for the outputs in `need` (1 dtn, 2 dvn,
// 4 dtw, 8 dvw).
extern "C" long long interaction_similarity_blocked_bwd_scratch(
    int A, int B, int T, int V, int D, int need) {
  return (long long)routed_scratch(A, B, T, V, D, need);
}

// Inputs as the forward's plus g [A, B] and the forward's residuals.  Out:
// dtn [A, T, D], dtw [A, T], dvn [B, V, D], dvw [B, V] fp32, each written
// when its pointer is not null; part holds
// interaction_similarity_blocked_bwd_scratch floats for the same outputs.
extern "C" int interaction_similarity_blocked_bwd(
    const float* tn, const float* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const unsigned char* i1, const float* m2,
    const unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  return (int)routed_backward<GATHER_FP32>(
      tn, vn, tw, vw, g, m1, i1, m2, i2, part, dtn, dtw, dvn, dvw, A, B, T, V,
      D, (cudaStream_t)stream);
}

#else  // the bf16 forms' entries

// The same with tn, vn in bf16 (the train step's sim_dtype="bfloat16": one
// bf16 wgmma a k-step, fp32 sums; ct / cv of the bf16 tokens).
extern "C" int interaction_similarity_blocked_fwd_bf16(
    const bf16* tn, const bf16* vn, const float* tw, const float* vw,
    float* out, float* m1, unsigned char* i1, float* m2, unsigned char* i2,
    const unsigned char* ct, const unsigned char* cv, int A, int B, int T,
    int V, int D, void* stream) {
  return blocked_fwd(tn, vn, tw, vw, out, Routing{m1, i1, m2, i2, ct, cv}, A,
                     B, T, V, D, (cudaStream_t)stream);
}

// The same from the bf16 features the bf16 forward read: where a logit is
// routed both ways (i1[a,b,t] = v and i2[a,b,v] = t) its two coefficients
// are added in fp32 before the one rounding to bf16, elsewhere each is
// rounded alone (↔ the TPU backward's `(d1 + d2).astype(dot_dtype)`); the
// outputs are fp32.
extern "C" int interaction_similarity_blocked_bwd_bf16(
    const bf16* tn, const bf16* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const unsigned char* i1, const float* m2,
    const unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  return (int)routed_backward<GATHER_BF16_SUM>(
      tn, vn, tw, vw, g, m1, i1, m2, i2, part, dtn, dtw, dvn, dvw, A, B, T, V,
      D, (cudaStream_t)stream);
}

#endif  // SIMILARITY_BF16_ENTRIES
