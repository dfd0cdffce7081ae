// Token-interaction similarity, forward (fp32 end to end).
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_similarity.py::_fwd_kernel
// (launched by _fwd_pallas, public pallas_interaction_similarity).  Computes
//
//   S[a,b] = 0.5 * ( sum_t tw[a,t] * max_v <tn[a,t], vn[b,v]>
//                  + sum_v vw[b,v] * max_t <tn[a,t], vn[b,v]> )
//
// on L2-normalised features whose padding masks the wrapper has already
// folded in (masked tokens are zero rows, so their logits are 0 and still
// take part in the max — the reference's multiplicative masking).
//
// Design: the [A·T, D] x [D, B·V] product of a register-tiled fp32 GEMM,
// with both max-reductions in its epilogue, so the [A, T, B, V] logits
// never reach device memory (what the TPU kernel was built for).  A block
// covers QB queries x 32 videos, one video per lane; warp (query q, row
// group g) owns tokens t = 6g..6g+5 of its query, so each thread holds the
// 6 x VP logits of one (query, video, row group) in registers.  D streams
// through shared memory in chunks of 32, double-buffered: 16-byte cp.async
// copies of chunk c+1 are in flight while chunk c is multiplied.  Every
// shared read is a float4: the 6 token rows (one address per warp) and the
// VP rows of the lane's video (per-video stride = 4 mod 32 words, so each
// quarter-warp's 16-byte reads fall in distinct banks) feed 6·VP·4 FMAs.
// The epilogue takes max over v in registers, max over t across row groups
// through shared memory, and writes S [A, B] only.
//
// What bounds it on an H100: fp32 FMAs outside the tensor cores (serving
// runs sim_dtype="float32"; no TF32, no bf16): 94 GFMA at Q=64, T=24,
// N=10,000, V=12, D=512, 2.8 ms at the 67 TFLOP/s fp32 peak.  Scalar shared
// loads (one per 4 FMAs) held an earlier version to a third of that; with
// float4 loads it reaches about half.  What is left: one 256-thread block
// per SM (168 registers per thread), so little latency is hidden beyond
// the double buffer; each video's tokens are re-read from L2 once per
// ceil(A/QB) blocks.  Left for later PRs: more queries per block, a
// persistent grid, and a 3xTF32 tensor-core split that keeps fp32 accuracy.
//
// The same tile kernel serves three more entry points (template MODE):
//
// interaction_mean_fwd replaces _fwd_rowmean_kernel (_rowmean_core, public
// pallas_interaction_mean): the mean of S over axis 1 -> [A] or axis 0 ->
// [B], the memory-bank centrality, without S in device memory.  The tile's
// store becomes a sum over the reduced axis inside the block (a warp
// shuffle over the 32 videos, or shared memory over the block's queries),
// written as one row of partials per block and summed in block order by
// reduce_rows: no float atomics, so two runs give the same bits.
//
// Under autograd (template SAVE) the epilogue also writes the backward's
// residuals beside S or the mean partials: per (query, video) the max over
// v of each query token's logits and its FIRST index (m1, i1) and the max
// over t of each video token's and its first index (m2, i2), in the
// layouts of similarity_gather.cuh.  The maxima are the ones S is built
// from (the same fmaxf chains; an index moves only where fmaxf changes the
// running max), so S keeps its bits, and the routing is the forward's own.
// Ties are the normal case: masked tokens are zero rows and their logits
// are exactly 0.  Without grad the kernels are the ones without SAVE.
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

#include "similarity_gather.cuh"

namespace {

constexpr int TPT = 6;   // token rows per thread
constexpr int VIDS = 32; // videos per block, one per lane
constexpr int DK = 32;   // D-chunk staged in shared memory

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past A/B/T/V)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// what the tile's epilogue does with its [QB, 32] block of S
constexpr int STORE = 0;      // out [A, B] = S
constexpr int MEAN_ROWS = 1;  // out [gridDim.y, A]: sums over the tile's videos
constexpr int MEAN_COLS = 2;  // out [gridDim.x, B]: sums over the tile's queries

// the backward's residuals, written under SAVE (similarity_gather.cuh)
struct Routing {
  float* m1;           // [A, B, T]
  unsigned char* i1;   // [A, B, pad16(T)]
  float* m2;           // [A, B, V]
  unsigned char* i2;   // [A, B, pad16(V)]
};

template <int VP, int MODE, bool SAVE>
__global__ void __launch_bounds__(384)
similarity_kernel(const float* __restrict__ tn, const float* __restrict__ vn,
                  const float* __restrict__ tw, const float* __restrict__ vw,
                  float* __restrict__ out, Routing res, int A, int B, int T,
                  int V, int D, int RG, int QB) {
  extern __shared__ __align__(16) float smem[];
  const int TP = RG * TPT;            // padded token rows per query
  const int VS = VP * DK + 4;         // per-video stride, 4 mod 32
  const int TS = QB * TP * DK;        // token tile [QB][TP][DK]
  const int STAGE = TS + VIDS * VS;   // + video tile [VIDS][VS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = warp / RG, rg = warp % RG;
  const int a0 = blockIdx.x * QB, b0 = blockIdx.y * VIDS;
  const int a = a0 + qi, b = b0 + lane;

  auto load = [&](int stage, int d0) {
    float* ts = smem + stage * STAGE;
    float* vs = ts + TS;
    for (int i = threadIdx.x; i < QB * TP * (DK / 4); i += blockDim.x) {
      const int c4 = i % (DK / 4), row = i / (DK / 4);
      const int q = row / TP, t = row % TP;
      const bool ok = a0 + q < A && t < T;
      cp_async16(ts + row * DK + c4 * 4,
                 ok ? tn + ((size_t)(a0 + q) * T + t) * D + d0 + c4 * 4 : tn,
                 ok);
    }
    for (int i = threadIdx.x; i < VIDS * VP * (DK / 4); i += blockDim.x) {
      const int c4 = i % (DK / 4), row = i / (DK / 4);
      const int vid = row / VP, v = row % VP;
      const bool ok = b0 + vid < B && v < V;
      cp_async16(vs + vid * VS + v * DK + c4 * 4,
                 ok ? vn + ((size_t)(b0 + vid) * V + v) * D + d0 + c4 * 4 : vn,
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[TPT][VP];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < VP; ++j) acc[i][j] = 0.f;

  const int nchunks = D / DK;
  load(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load((c + 1) & 1, (c + 1) * DK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* ts = smem + (c & 1) * STAGE;
    const float* tq = ts + (qi * TP + rg * TPT) * DK;
    const float* vl = ts + TS + lane * VS;
#pragma unroll 1
    for (int d4 = 0; d4 < DK; d4 += 4) {
      float4 t4[TPT];
#pragma unroll
      for (int i = 0; i < TPT; ++i)
        t4[i] = *reinterpret_cast<const float4*>(tq + i * DK + d4);
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(vl + j * DK + d4);
#pragma unroll
        for (int i = 0; i < TPT; ++i) {
          acc[i][j] = fmaf(t4[i].x, v4.x, acc[i][j]);
          acc[i][j] = fmaf(t4[i].y, v4.y, acc[i][j]);
          acc[i][j] = fmaf(t4[i].z, v4.z, acc[i][j]);
          acc[i][j] = fmaf(t4[i].w, v4.w, acc[i][j]);
        }
      }
    }
    __syncthreads();   // the next iteration's copies overwrite this stage
  }

  // t2v over this row group's tokens; v2t partial maxima over them.  Under
  // SAVE the first index of each running max: it moves only where fmaxf
  // changes the max, so the maxima are the ones S is built from
  float s_t = 0.f, m2[VP];
  unsigned t2[(VP + 3) / 4];   // SAVE: m2's first token, one byte each
#pragma unroll
  for (int j = 0; j < VP; ++j) m2[j] = -INFINITY;
#pragma unroll
  for (int w = 0; w < (VP + 3) / 4; ++w) t2[w] = 0;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int t = rg * TPT + i;
    if (t >= T) continue;
    float m1 = -INFINITY;
    int v1 = 0;
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      if (j < V) {
        const float nm = fmaxf(m1, acc[i][j]);
        if (SAVE && nm != m1) v1 = j;
        m1 = nm;
      }
      const float nm = fmaxf(m2[j], acc[i][j]);
      if (SAVE && nm != m2[j])
        t2[j / 4] = (t2[j / 4] & ~(0xffu << (8 * (j % 4)))) |
                    ((unsigned)t << (8 * (j % 4)));
      m2[j] = nm;
    }
    if (a < A) s_t += tw[(size_t)a * T + t] * m1;
    if (SAVE && a < A && b < B) {
      const size_t pair = (size_t)a * B + b;
      res.m1[pair * T + t] = m1;
      res.i1[pair * pad16(T) + t] = (unsigned char)v1;
    }
  }
  // per (query, row group, video): [s_t | m2... | SAVE: t2 words]
  constexpr int NW = SAVE ? (VP + 3) / 4 : 0;
  constexpr int SLOT = VP + 1 + NW;
  float* red = smem;  // [QB][RG][VIDS][SLOT], reusing the tiles
  float* mine = red + ((qi * RG + rg) * VIDS + lane) * SLOT;
  mine[0] = s_t;
#pragma unroll
  for (int j = 0; j < VP; ++j) mine[1 + j] = m2[j];
#pragma unroll
  for (int w = 0; w < NW; ++w) mine[1 + VP + w] = __uint_as_float(t2[w]);
  __syncthreads();

  float val = 0.f;   // S[a, b], or 0 outside the matrix
  if (rg == 0 && a < A && b < B) {
    float s = 0.f, mv[VP];
    int tv[VP];
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      mv[j] = -INFINITY;
      tv[j] = 0;
    }
    // row groups hold ascending token ranges: the first that raises the
    // max holds its first index
    for (int g = 0; g < RG; ++g) {
      const float* r = red + ((qi * RG + g) * VIDS + lane) * SLOT;
      s += r[0];
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        const float nm = fmaxf(mv[j], r[1 + j]);
        if (SAVE && nm != mv[j])
          tv[j] = (__float_as_uint(r[1 + VP + j / 4]) >> (8 * (j % 4))) & 0xff;
        mv[j] = nm;
      }
    }
    float s_v = 0.f;
#pragma unroll
    for (int j = 0; j < VP; ++j)
      if (j < V) s_v += vw[(size_t)b * V + j] * mv[j];
    val = 0.5f * (s + s_v);
    if constexpr (MODE == STORE) out[(size_t)a * B + b] = val;
    if (SAVE) {
      const size_t pair = (size_t)a * B + b;
#pragma unroll
      for (int j = 0; j < VP; ++j)
        if (j < V) {
          res.m2[pair * V + j] = mv[j];
          res.i2[pair * pad16(V) + j] = (unsigned char)tv[j];
        }
    }
  }
  if constexpr (MODE == MEAN_ROWS) {
    if (rg == 0) {                       // warp-uniform: one warp per query
      const float r = warp_sum(val);
      if (lane == 0 && a < A) out[(size_t)blockIdx.y * A + a] = r;
    }
  }
  if constexpr (MODE == MEAN_COLS) {
    __syncthreads();                     // every read of red is done
    if (rg == 0) smem[qi * VIDS + lane] = val;
    __syncthreads();
    if (warp == 0 && b < B) {
      float r = 0.f;
      for (int q = 0; q < QB; ++q) r += smem[q * VIDS + lane];
      out[(size_t)blockIdx.x * B + b] = r;
    }
  }
}

__host__ __device__ inline int row_groups(int T) { return (T + TPT - 1) / TPT; }
// queries per block: 8 warps' worth of row groups
__host__ __device__ inline int tile_queries(int T) {
  const int RG = row_groups(T);
  return RG < 8 ? 8 / RG : 1;
}

template <int VP, int MODE, bool SAVE>
cudaError_t launch(const float* tn, const float* vn, const float* tw,
                   const float* vw, float* out, const Routing& res, int A,
                   int B, int T, int V, int D, cudaStream_t stream) {
  const int RG = row_groups(T);
  const int QB = tile_queries(T);
  constexpr int SLOT = VP + 1 + (SAVE ? (VP + 3) / 4 : 0);
  const size_t stage =
      (size_t)QB * RG * TPT * DK + (size_t)VIDS * (VP * DK + 4);
  const size_t red = (size_t)QB * RG * VIDS * SLOT;
  const size_t smem = sizeof(float) * (2 * stage > red ? 2 * stage : red);
  auto kern = similarity_kernel<VP, MODE, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((A + QB - 1) / QB, (B + VIDS - 1) / VIDS);
  kern<<<grid, QB * RG * 32, smem, stream>>>(tn, vn, tw, vw, out, res, A, B,
                                             T, V, D, RG, QB);
  return cudaGetLastError();
}

template <int MODE, bool SAVE>
cudaError_t launch_vp(const float* tn, const float* vn, const float* tw,
                      const float* vw, float* out, const Routing& r, int A,
                      int B, int T, int V, int D, cudaStream_t s) {
  switch ((V + 3) / 4) {
    case 1: return launch<4, MODE, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
    case 2: return launch<8, MODE, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
    case 3: return launch<12, MODE, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
    default: return launch<16, MODE, SAVE>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
  }
}

// the kernel with the residual stores when res.m1 is set, without otherwise
template <int MODE>
cudaError_t launch_v(const float* tn, const float* vn, const float* tw,
                     const float* vw, float* out, const Routing& r, int A,
                     int B, int T, int V, int D, cudaStream_t s) {
  return r.m1 != nullptr
             ? launch_vp<MODE, true>(tn, vn, tw, vw, out, r, A, B, T, V, D, s)
             : launch_vp<MODE, false>(tn, vn, tw, vw, out, r, A, B, T, V, D, s);
}

inline bool bad_shape(int A, int B, int T, int V, int D) {
  return T < 1 || T > 64 || V < 1 || V > 16 || D % DK != 0 || A < 1 || B < 1;
}

inline bool bad_routing(const Routing& r) {
  const bool none = !r.m1 && !r.i1 && !r.m2 && !r.i2;
  return !none && !(r.m1 && r.i1 && r.m2 && r.i2);
}

}  // namespace

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned.  m1 [A, B, T] and m2 [A, B, V] (fp32),
// i1 [A, B, pad16(T)] and i2 [A, B, pad16(V)] (bytes) are the backward's
// residuals: pass all four, or null for all when no gradient will be asked
// for.  Requires T <= 64, V <= 16, D % 32 == 0 (the wrapper checks).
extern "C" int interaction_similarity_fwd(const float* tn, const float* vn,
                                          const float* tw, const float* vw,
                                          float* out, float* m1,
                                          unsigned char* i1, float* m2,
                                          unsigned char* i2, int A, int B,
                                          int T, int V, int D, void* stream) {
  const Routing r{m1, i1, m2, i2};
  if (bad_shape(A, B, T, V, D) || bad_routing(r))
    return (int)cudaErrorInvalidValue;
  return (int)launch_v<STORE>(tn, vn, tw, vw, out, r, A, B, T, V, D,
                              (cudaStream_t)stream);
}

// The number of per-block partial rows interaction_mean_fwd writes for
// these sizes: the caller allocates part [rows, A] (axis 1) or [rows, B]
// (axis 0).
extern "C" int interaction_mean_partial_rows(int A, int B, int T, int axis) {
  const int QB = tile_queries(T);
  return axis == 1 ? (B + VIDS - 1) / VIDS : (A + QB - 1) / QB;
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
  const Routing r{m1, i1, m2, i2};
  if (bad_shape(A, B, T, V, D) || bad_routing(r) || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = interaction_mean_partial_rows(A, B, T, axis);
  cudaError_t err =
      axis == 1
          ? launch_v<MEAN_ROWS>(tn, vn, tw, vw, part, r, A, B, T, V, D, s)
          : launch_v<MEAN_COLS>(tn, vn, tw, vw, part, r, A, B, T, V, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(axis == 1 ? reduce_rows(part, out, rows, A, (float)B, s)
                         : reduce_rows(part, out, rows, B, (float)A, s));
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
  return (int)routed_backward(tn, vn, tw, vw, g, m1, i1, m2, i2, part, dtn,
                              dtw, dvn, dvw, A, B, T, V, D,
                              (cudaStream_t)stream);
}
