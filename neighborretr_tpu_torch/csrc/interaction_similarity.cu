// Token-interaction similarity, forward: fp32 inputs and outputs, the
// products on the TF32 tensor cores in a 3xTF32 split with fp32 sums.
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_similarity.py::_fwd_kernel
// (launched by _fwd_pallas, public pallas_interaction_similarity).  The tile
// kernel is similarity_tile.cuh's (the [A·T, D] x [D, B·V] product as a
// TMA-fed wgmma GEMM in a 3xTF32 split, with both max-reductions in its
// epilogue, so the [A, T, B, V] logits never reach device memory), here at
// the short shapes: T <= 64, V <= 16.
// - A block owns QB queries (8, fewer when A or the register budget asks
//   for it) against 16 videos: two warpgroups take 8 videos each, N = 8·VP
//   columns (VP = V rounded up to 4), MT <= 3 m-tiles of 64 text rows (3
//   x 48 sum registers and one accumulator at VP = 12: 249 registers, no
//   spills).  One block writes S [A, B] only.
//
// What bounds it on an H100: the TF32 tensor cores (3 x 189 GFLOP at Q=64,
// T=24, N=10,000, V=12, D=512: 1.14 ms at 494.7 TFLOP/s), and the shared-
// memory reads that feed them (wgmma reads B from shared memory for each
// of the three products); at Q=1 the corpus' 246 MB (0.07 ms).  It takes
// about 2.5 ms there through the wrapper; the wait for each m-tile's
// products before its sums costs about 8% of that (PERF.md, §6).
//
// The same tile kernel serves three more entry points:
//
// interaction_mean_fwd replaces _fwd_rowmean_kernel (_rowmean_core, public
// pallas_interaction_mean): the mean of S over axis 1 -> [A] or axis 0 ->
// [B], the memory-bank centrality, without S in device memory.  The tile's
// store becomes a sum over the reduced axis inside the block (its 16
// videos, or its QB queries, in order), written as one row of partials per
// block and summed in block order by reduce_rows: no float atomics, so two
// runs give the same bits.
//
// Under autograd (template SAVE) the epilogue also writes the backward's
// residuals beside S or the mean partials (m1/i1, m2/i2; see
// similarity_tile.cuh), with S's bits unchanged.  Without grad the kernels
// are the ones without SAVE.
//
// interaction_similarity_bwd replaces _bwd_text_kernel and
// _bwd_video_kernel (_similarity_bwd): from g [A, B] and those residuals
// the gradients dtn, dtw, dvn, dvw, each only if asked for.  The TPU kernel
// recomputes the logits in both of its grids and multiplies dense 0/1
// indicator matrices on the MXU; here nothing is recomputed and each side
// is one gather over partner tiles staged in shared memory
// (similarity_gather.cuh, shared with the blocked long-token kernels),
// plus the weight gradients' ordered sums over the maxima.  What bounds
// it: the gathers' instructions per routed row, 2·D fp32 FLOP per live
// (nonzero-weight) token of each pair, at most 2·A·B·(T+V)·D per side.

// The bf16 forms' entries (the `_bf16` C functions) are compiled apart:
// interaction_similarity_bf16.cu includes this file with
// SIMILARITY_BF16_ENTRIES defined, so that each library instantiates only
// the kernels of its own input type and the two build in parallel.

#include "similarity_tile.cuh"

namespace {

constexpr int VIDS = 8;             // videos a consumer warpgroup
constexpr int BLOCK_VIDS = CONSUMERS * VIDS;

template <int VP, int MT, bool SAVE, typename In>
__global__ void __launch_bounds__(THREADS, 1)
similarity_kernel(const __grid_constant__ CUtensorMap tm_t,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ tw, const float* __restrict__ vw,
                  float* __restrict__ out, Routing res, int A, int B, int T,
                  int V, int D, int QB, int mode, int stages) {
  similarity_tile<VIDS, VP, MT, SAVE, float, false, In>(
      &tm_t, &tm_v, tw, vw, out, res, A, B, T, V, D, QB, mode, stages);
}

inline bool bad_shape(int A, int B, int T, int V, int D) {
  return T < 1 || T > 64 || V < 1 || V > 16 || D < DK || D % DK != 0 ||
         A < 1 || B < 1;
}

// m-tiles a block at most: 3 up to VP = 12, 2 at VP = 16
constexpr int mt_max(int VP) { return VP <= 12 ? 3 : 2; }

inline int rounded_v(int V) { return (V + 3) / 4 * 4; }

template <int VP, int MT, bool SAVE, typename In>
int launch(const In* tn, const In* vn, const float* tw, const float* vw,
           float* out, const Routing& res, int A, int B, int T, int V, int D,
           int QB, int mode, cudaStream_t stream) {
  CUtensorMap tm_t, tm_v;
  if (int e = tile_maps<VIDS, VP, MT, In>(&tm_t, &tm_v, tn, vn, A, B, T, V,
                                          D, QB))
    return e;
  using Smem = TileSmem<VIDS * VP, MT, In>;
  auto kern = similarity_kernel<VP, MT, SAVE, In>;
  static const cudaError_t e = allow_smem(kern, Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<tile_blocks(A, B, QB, VIDS), THREADS, Smem::bytes, stream>>>(
      tm_t, tm_v, tw, vw, out, res, A, B, T, V, D, QB, mode, Smem::stages);
  return (int)cudaGetLastError();
}

template <int VP, bool SAVE, typename In>
int launch_mt(const In* tn, const In* vn, const float* tw, const float* vw,
              float* out, const Routing& r, int A, int B, int T, int V,
              int D, int mode, cudaStream_t s) {
  const int qb = block_queries(A, T, mt_max(VP));
  switch ((qb * T + 63) / 64) {
    case 1:
      return launch<VP, 1, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, qb,
                                 mode, s);
    case 2:
      return launch<VP, 2, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, qb,
                                 mode, s);
    default:
      if constexpr (VP <= 12)
        return launch<VP, 3, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, qb,
                                   mode, s);
      return (int)cudaErrorInvalidValue;
  }
}

template <bool SAVE, typename In>
int launch_vp(const In* tn, const In* vn, const float* tw, const float* vw,
              float* out, const Routing& r, int A, int B, int T, int V,
              int D, int mode, cudaStream_t s) {
  switch (rounded_v(V)) {
    case 4: return launch_mt<4, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s);
    case 8: return launch_mt<8, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s);
    case 12: return launch_mt<12, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s);
    default: return launch_mt<16, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s);
  }
}

// the kernel with the residual stores when res.m1 is set, without otherwise
template <typename In>
int launch_v(const In* tn, const In* vn, const float* tw, const float* vw,
             float* out, const Routing& r, int A, int B, int T, int V, int D,
             int mode, cudaStream_t s) {
  return r.m1 != nullptr
             ? launch_vp<true>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s)
             : launch_vp<false>(tn, vn, tw, vw, out, r, A, B, T, V, D, mode, s);
}

template <typename In>
int similarity_fwd(const In* tn, const In* vn, const float* tw,
                   const float* vw, float* out, const Routing& r, int A,
                   int B, int T, int V, int D, cudaStream_t s) {
  if (bad_shape(A, B, T, V, D) || bad_routing(r))
    return (int)cudaErrorInvalidValue;
  return launch_v(tn, vn, tw, vw, out, r, A, B, T, V, D, STORE, s);
}

template <typename In>
int mean_fwd(const In* tn, const In* vn, const float* tw, const float* vw,
             float* part, float* out, const Routing& r, int A, int B, int T,
             int V, int D, int axis, cudaStream_t s) {
  if (bad_shape(A, B, T, V, D) || bad_routing(r) || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const int qb = block_queries(A, T, mt_max(rounded_v(V)));
  const int rows = axis == 1 ? (B + BLOCK_VIDS - 1) / BLOCK_VIDS
                             : (A + qb - 1) / qb;
  const int err = launch_v(tn, vn, tw, vw, part, r, A, B, T, V, D,
                           axis == 1 ? MEAN_ROWS : MEAN_COLS, s);
  if (err != 0) return err;
  return (int)(axis == 1 ? reduce_rows(part, out, rows, A, (float)B, s)
                         : reduce_rows(part, out, rows, B, (float)A, s));
}

}  // namespace

#ifndef SIMILARITY_BF16_ENTRIES

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned (TMA reads the features).  m1 [A, B, T] and
// m2 [A, B, V] (fp32),
// i1 [A, B, pad16(T)] and i2 [A, B, pad16(V)] (bytes) are the backward's
// residuals: pass all four, or null for all when no gradient will be asked
// for.  Requires T <= 64, V <= 16, D % 32 == 0 (the wrapper checks).  Returns
// 0, a cudaError_t, or a tensor-map error of hopper.cuh.
extern "C" int interaction_similarity_fwd(const float* tn, const float* vn,
                                          const float* tw, const float* vw,
                                          float* out, float* m1,
                                          unsigned char* i1, float* m2,
                                          unsigned char* i2, int A, int B,
                                          int T, int V, int D, void* stream) {
  return similarity_fwd(tn, vn, tw, vw, out, Routing{m1, i1, m2, i2}, A, B,
                        T, V, D, (cudaStream_t)stream);
}

// The number of per-block partial rows interaction_mean_fwd writes for
// these sizes, at most (over axis 0 it also depends on V): the caller
// allocates part [rows, A] (axis 1) or [rows, B] (axis 0).
extern "C" int interaction_mean_partial_rows(int A, int B, int T, int axis) {
  const int qb = block_queries(A, T, mt_max(16));
  return axis == 1 ? (B + BLOCK_VIDS - 1) / BLOCK_VIDS : (A + qb - 1) / qb;
}

// Inputs and residuals as above; out [A] = mean of S over axis 1, or
// out [B] = mean over axis 0; part is scratch (see
// interaction_mean_partial_rows).
extern "C" int interaction_mean_fwd(const float* tn, const float* vn,
                                    const float* tw, const float* vw,
                                    float* part, float* out, float* m1,
                                    unsigned char* i1, float* m2,
                                    unsigned char* i2, int A, int B, int T,
                                    int V, int D, int axis, void* stream) {
  return mean_fwd(tn, vn, tw, vw, part, out, Routing{m1, i1, m2, i2}, A, B,
                  T, V, D, axis, (cudaStream_t)stream);
}

// routed_gather_kernel launches made by this library so far.
extern "C" long long interaction_similarity_gather_launches() {
  return __atomic_load_n(&g_gather_launches, __ATOMIC_RELAXED);
}

// Floats of scratch interaction_similarity_bwd needs for the partial sums
// of split walks, for the outputs in `need` (1 dtn, 2 dvn, 4 dtw, 8 dvw).
extern "C" long long interaction_similarity_bwd_scratch(int A, int B, int T,
                                                        int V, int D,
                                                        int need) {
  return (long long)routed_scratch(A, B, T, V, D, need);
}

// Inputs as above plus g [A, B] and the forward's residuals.  Out: dtn
// [A, T, D], dtw [A, T], dvn [B, V, D], dvw [B, V] fp32, each written when
// its pointer is not null; part holds interaction_similarity_bwd_scratch
// floats for the same outputs.
extern "C" int interaction_similarity_bwd(
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

// The same with tn, vn in bf16 (the train step's sim_dtype="bfloat16": the
// features rounded once by the wrapper, one bf16 wgmma a k-step, fp32 sums).
extern "C" int interaction_similarity_fwd_bf16(
    const bf16* tn, const bf16* vn, const float* tw, const float* vw,
    float* out, float* m1, unsigned char* i1, float* m2, unsigned char* i2,
    int A, int B, int T, int V, int D, void* stream) {
  return similarity_fwd(tn, vn, tw, vw, out, Routing{m1, i1, m2, i2}, A, B,
                        T, V, D, (cudaStream_t)stream);
}

// The same with tn, vn in bf16.
extern "C" int interaction_mean_fwd_bf16(
    const bf16* tn, const bf16* vn, const float* tw, const float* vw,
    float* part, float* out, float* m1, unsigned char* i1, float* m2,
    unsigned char* i2, int A, int B, int T, int V, int D, int axis,
    void* stream) {
  return mean_fwd(tn, vn, tw, vw, part, out, Routing{m1, i1, m2, i2}, A, B,
                  T, V, D, axis, (cudaStream_t)stream);
}

// The same from the bf16 features the bf16 forward read: each routed
// coefficient is rounded to bf16 before it multiplies its row (↔ the TPU
// backward's `d1_v` / `d2_t` cast to dot_dtype, each direction apart);
// the outputs are fp32.
extern "C" int interaction_similarity_bwd_bf16(
    const bf16* tn, const bf16* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const unsigned char* i1, const float* m2,
    const unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  return (int)routed_backward<GATHER_BF16_EACH>(
      tn, vn, tw, vw, g, m1, i1, m2, i2, part, dtn, dtw, dvn, dvw, A, B, T, V,
      D, (cudaStream_t)stream);
}

#endif  // SIMILARITY_BF16_ENTRIES
