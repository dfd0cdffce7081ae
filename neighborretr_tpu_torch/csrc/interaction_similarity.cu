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
// interaction_similarity_bwd replaces _bwd_text_kernel and
// _bwd_video_kernel (_similarity_bwd): from g [A, B] the gradients dtn, dtw,
// dvn, dvw.  Each max sends its gradient to the FIRST index that attains
// it; ties are the normal case, since masked tokens are zero rows and their
// logits are exactly 0.  The TPU kernel recomputes the logits in both of
// its grids and multiplies dense 0/1 indicator matrices on the MXU.  Here
// the logits are recomputed once, in the forward's arithmetic order, and
// the tile's epilogue writes only the reduced maxima and their first-index
// arguments (m1, i1 over v: [A, T, B]; m2, i2 over t: [A, B, V]; 1/V and
// 1/T of the logits).  Two gather kernels then own their outputs: a block
// of bwd_text_kernel owns one caption's dtn slab and walks the videos, a
// block of bwd_video_kernel owns one video's dvn slab and walks the
// captions, each adding the (T + V) routed rows per pair in a fixed order.
// What bounds it: the recompute, as the forward; the gathers by their
// chains of index, row and shared-memory instructions.

#include "common.cuh"

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
constexpr int ARGMAX = 3;     // out = m1 [A, T, B], out2 = m2 [A, B, V] and
                              // their first-index arguments i1, i2

template <int VP, int MODE>
__global__ void __launch_bounds__(384)
similarity_kernel(const float* __restrict__ tn, const float* __restrict__ vn,
                  const float* __restrict__ tw, const float* __restrict__ vw,
                  float* __restrict__ out, float* __restrict__ out2,
                  unsigned char* __restrict__ i1, unsigned char* __restrict__ i2,
                  int A, int B, int T, int V, int D, int RG, int QB) {
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

  // t2v over this row group's tokens; v2t partial maxima over them
  float s_t = 0.f, m2[VP];
  int t2[VP];   // ARGMAX: first token of this row group that attains m2
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    m2[j] = -INFINITY;
    t2[j] = 0;
  }
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int t = rg * TPT + i;
    if (t >= T) continue;
    if constexpr (MODE == ARGMAX) {
      float m1 = acc[i][0];
      int v1 = 0;
#pragma unroll
      for (int j = 1; j < VP; ++j)
        if (j < V && acc[i][j] > m1) {   // strict: the first index wins
          m1 = acc[i][j];
          v1 = j;
        }
#pragma unroll
      for (int j = 0; j < VP; ++j)
        if (acc[i][j] > m2[j]) {
          m2[j] = acc[i][j];
          t2[j] = t;
        }
      if (a < A && b < B) {
        const size_t o = ((size_t)a * T + t) * B + b;
        out[o] = m1;
        i1[o] = (unsigned char)v1;
      }
    } else {
      float m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        if (j < V) m1 = fmaxf(m1, acc[i][j]);
        m2[j] = fmaxf(m2[j], acc[i][j]);
      }
      if (a < A) s_t += tw[(size_t)a * T + t] * m1;
    }
  }
  // per (query, row group, video): [s_t | m2...], and for ARGMAX [m2 | t2]
  constexpr int SLOT = MODE == ARGMAX ? 2 * VP : VP + 1;
  float* red = smem;  // [QB][RG][VIDS][SLOT], reusing the tiles
  float* mine = red + ((qi * RG + rg) * VIDS + lane) * SLOT;
  if constexpr (MODE == ARGMAX) {
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      mine[j] = m2[j];
      mine[VP + j] = __int_as_float(t2[j]);
    }
  } else {
    mine[0] = s_t;
#pragma unroll
    for (int j = 0; j < VP; ++j) mine[1 + j] = m2[j];
  }
  __syncthreads();

  if constexpr (MODE == ARGMAX) {
    if (rg == 0 && a < A && b < B) {
      // row groups hold ascending token ranges: strict > keeps the first
      for (int j = 0; j < VP; ++j) {
        if (j >= V) break;
        float mv = -INFINITY;
        int tv = 0;
        for (int g = 0; g < RG; ++g) {
          const float* r = red + ((qi * RG + g) * VIDS + lane) * SLOT;
          if (r[j] > mv) {
            mv = r[j];
            tv = __float_as_int(r[VP + j]);
          }
        }
        const size_t o = ((size_t)a * B + b) * V + j;
        out2[o] = mv;
        i2[o] = (unsigned char)tv;
      }
    }
  } else {
    float val = 0.f;   // S[a, b], or 0 outside the matrix
    if (rg == 0 && a < A && b < B) {
      float s = 0.f, mv[VP];
#pragma unroll
      for (int j = 0; j < VP; ++j) mv[j] = -INFINITY;
      for (int g = 0; g < RG; ++g) {
        const float* r = red + ((qi * RG + g) * VIDS + lane) * SLOT;
        s += r[0];
#pragma unroll
        for (int j = 0; j < VP; ++j) mv[j] = fmaxf(mv[j], r[1 + j]);
      }
      float s_v = 0.f;
#pragma unroll
      for (int j = 0; j < VP; ++j)
        if (j < V) s_v += vw[(size_t)b * V + j] * mv[j];
      val = 0.5f * (s + s_v);
      if constexpr (MODE == STORE) out[(size_t)a * B + b] = val;
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
}

__host__ __device__ inline int row_groups(int T) { return (T + TPT - 1) / TPT; }
// queries per block: 8 warps' worth of row groups
__host__ __device__ inline int tile_queries(int T) {
  const int RG = row_groups(T);
  return RG < 8 ? 8 / RG : 1;
}

template <int VP, int MODE>
cudaError_t launch(const float* tn, const float* vn, const float* tw,
                   const float* vw, float* out, float* out2, unsigned char* i1,
                   unsigned char* i2, int A, int B, int T, int V, int D,
                   cudaStream_t stream) {
  const int RG = row_groups(T);
  const int QB = tile_queries(T);
  constexpr int SLOT = MODE == ARGMAX ? 2 * VP : VP + 1;
  const size_t stage =
      (size_t)QB * RG * TPT * DK + (size_t)VIDS * (VP * DK + 4);
  const size_t red = (size_t)QB * RG * VIDS * SLOT;
  const size_t smem = sizeof(float) * (2 * stage > red ? 2 * stage : red);
  auto kern = similarity_kernel<VP, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((A + QB - 1) / QB, (B + VIDS - 1) / VIDS);
  kern<<<grid, QB * RG * 32, smem, stream>>>(tn, vn, tw, vw, out, out2, i1, i2,
                                             A, B, T, V, D, RG, QB);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_v(const float* tn, const float* vn, const float* tw,
                     const float* vw, float* out, float* out2,
                     unsigned char* i1, unsigned char* i2, int A, int B, int T,
                     int V, int D, cudaStream_t s) {
  switch ((V + 3) / 4) {
    case 1: return launch<4, MODE>(tn, vn, tw, vw, out, out2, i1, i2, A, B, T, V, D, s);
    case 2: return launch<8, MODE>(tn, vn, tw, vw, out, out2, i1, i2, A, B, T, V, D, s);
    case 3: return launch<12, MODE>(tn, vn, tw, vw, out, out2, i1, i2, A, B, T, V, D, s);
    default: return launch<16, MODE>(tn, vn, tw, vw, out, out2, i1, i2, A, B, T, V, D, s);
  }
}

inline bool bad_shape(int A, int B, int T, int V, int D) {
  return T < 1 || T > 64 || V < 1 || V > 16 || D % DK != 0 || A < 1 || B < 1;
}

// ---------------------------------------------------------------------------
// backward gathers: thread = one feature column, accumulators in shared
// memory indexed by the routed token (each thread touches only its column).
// The walk over the other side is cut into `splits` ranges, one block each,
// so that short sides still fill the card; a split run writes partials that
// reduce_rows sums in range order.  Inside a range the routed rows are
// loaded GU at a time ahead of their shared-memory updates: the index →
// row → update chains of one pair are independent of each other.  (Giving a
// block several captions or videos, so that each row read from L2 serves
// them all, halved the speed on an H100: these kernels are bound by their
// instruction chains and want many small blocks, not fewer bytes.)
// ---------------------------------------------------------------------------
constexpr int GD = 128;   // feature columns per block; >= the largest T
constexpr int GU = 8;     // routed rows in flight per thread

// how many ranges to cut `other` into when `own` x slabs blocks are too few
inline int gather_splits(int own, int slabs, int other) {
  int s = 2048 / (own * slabs);
  if (s > 16) s = 16;
  if (s > other / 32) s = other / 32;
  return s < 1 ? 1 : s;
}

// block (a, slab, range): out[range][a, :, slab]; slab 0 of range 0 also
// dtw[a, :]
__global__ void __launch_bounds__(GD)
bwd_text_kernel(const float* __restrict__ vn, const float* __restrict__ tw,
                const float* __restrict__ vw, const float* __restrict__ g,
                const float* __restrict__ m1, const unsigned char* __restrict__ i1,
                const unsigned char* __restrict__ i2, float* __restrict__ out,
                float* __restrict__ dtw, int A, int B, int T, int V, int D) {
  extern __shared__ __align__(16) float sm[];
  float* acc = sm;              // [T][GD]
  float* tws = sm + T * GD;     // [T]
  const int a = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * GD + tid;
  const int per = (B + gridDim.z - 1) / gridDim.z;
  const int b_lo = blockIdx.z * per, b_hi = min(B, b_lo + per);
  if (tid < T) tws[tid] = tw[(size_t)a * T + tid];
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid < T) {
    const float* mr = m1 + ((size_t)a * T + tid) * B;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += g[(size_t)a * B + b] * mr[b];
    dtw[(size_t)a * T + tid] = 0.5f * s;
  }
  __syncthreads();
  if (d >= D) return;
  for (int t = 0; t < T; ++t) acc[t * GD + tid] = 0.f;
  const unsigned char* i1a = i1 + (size_t)a * T * B;
  for (int b = b_lo; b < b_hi; ++b) {
    const float gab = 0.5f * g[(size_t)a * B + b];
    const float* vb = vn + (size_t)b * V * D + d;
    // max over v: token t of the caption sends its share to video token i1
    for (int t0 = 0; t0 < T; t0 += GU) {
      float x[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int t = t0 + u;
        x[u] = t < T ? gab * tws[t] * vb[(size_t)i1a[(size_t)t * B + b] * D]
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u)
        if (t0 + u < T) acc[(t0 + u) * GD + tid] += x[u];
    }
    // max over t: video token v sends its share to caption token i2
    const unsigned char* i2ab = i2 + ((size_t)a * B + b) * V;
    for (int v0 = 0; v0 < V; v0 += GU) {
      float x[GU];
      int tt[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int v = v0 + u;
        tt[u] = v < V ? i2ab[v] : 0;
        x[u] = v < V ? gab * vw[(size_t)b * V + v] * vb[(size_t)v * D] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u)
        if (v0 + u < V) acc[tt[u] * GD + tid] += x[u];
    }
  }
  float* o = out + (size_t)blockIdx.z * A * T * D;
  for (int t = 0; t < T; ++t)
    o[((size_t)a * T + t) * D + d] = acc[t * GD + tid];
}

// block (b, slab, range): out[range][b, :, slab]; slab 0 of range 0 also
// dvw[b, :]
__global__ void __launch_bounds__(GD)
bwd_video_kernel(const float* __restrict__ tn, const float* __restrict__ tw,
                 const float* __restrict__ vw, const float* __restrict__ g,
                 const float* __restrict__ m2, const unsigned char* __restrict__ i1,
                 const unsigned char* __restrict__ i2, float* __restrict__ out,
                 float* __restrict__ dvw, int A, int B, int T, int V, int D) {
  extern __shared__ __align__(16) float sm[];
  float* acc = sm;              // [V][GD]
  float* vws = sm + V * GD;     // [V]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * GD + tid;
  const int per = (A + gridDim.z - 1) / gridDim.z;
  const int a_lo = blockIdx.z * per, a_hi = min(A, a_lo + per);
  if (tid < V) vws[tid] = vw[(size_t)b * V + tid];
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid < V) {
    float s = 0.f;
    for (int a = 0; a < A; ++a)
      s += g[(size_t)a * B + b] * m2[((size_t)a * B + b) * V + tid];
    dvw[(size_t)b * V + tid] = 0.5f * s;
  }
  __syncthreads();
  if (d >= D) return;
  for (int v = 0; v < V; ++v) acc[v * GD + tid] = 0.f;
  for (int a = a_lo; a < a_hi; ++a) {
    const float gab = 0.5f * g[(size_t)a * B + b];
    const float* ta = tn + (size_t)a * T * D + d;
    const float* twa = tw + (size_t)a * T;
    const unsigned char* i1a = i1 + (size_t)a * T * B + b;
    for (int t0 = 0; t0 < T; t0 += GU) {
      float x[GU];
      int vv[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int t = t0 + u;
        vv[u] = t < T ? i1a[(size_t)t * B] : 0;
        x[u] = t < T ? gab * twa[t] * ta[(size_t)t * D] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u)
        if (t0 + u < T) acc[vv[u] * GD + tid] += x[u];
    }
    const unsigned char* i2ab = i2 + ((size_t)a * B + b) * V;
    for (int v0 = 0; v0 < V; v0 += GU) {
      float x[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int v = v0 + u;
        x[u] = v < V ? gab * vws[v] * ta[(size_t)i2ab[v] * D] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u)
        if (v0 + u < V) acc[(v0 + u) * GD + tid] += x[u];
    }
  }
  float* o = out + (size_t)blockIdx.z * B * V * D;
  for (int v = 0; v < V; ++v)
    o[((size_t)b * V + v) * D + d] = acc[v * GD + tid];
}

}  // namespace

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned.  Requires T <= 64, V <= 16, D % 32 == 0
// (the wrapper checks).
extern "C" int interaction_similarity_fwd(const float* tn, const float* vn,
                                          const float* tw, const float* vw,
                                          float* out, int A, int B, int T,
                                          int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  return (int)launch_v<STORE>(tn, vn, tw, vw, out, nullptr, nullptr, nullptr,
                              A, B, T, V, D, (cudaStream_t)stream);
}

// The number of per-block partial rows interaction_mean_fwd writes for
// these sizes: the caller allocates part [rows, A] (axis 1) or [rows, B]
// (axis 0).
extern "C" int interaction_mean_partial_rows(int A, int B, int T, int axis) {
  const int QB = tile_queries(T);
  return axis == 1 ? (B + VIDS - 1) / VIDS : (A + QB - 1) / QB;
}

// Inputs as above; out [A] = mean of S over axis 1, or out [B] = mean over
// axis 0; part is scratch (see interaction_mean_partial_rows).
extern "C" int interaction_mean_fwd(const float* tn, const float* vn,
                                    const float* tw, const float* vw,
                                    float* part, float* out, int A, int B,
                                    int T, int V, int D, int axis,
                                    void* stream) {
  if (bad_shape(A, B, T, V, D) || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = interaction_mean_partial_rows(A, B, T, axis);
  cudaError_t err =
      axis == 1 ? launch_v<MEAN_ROWS>(tn, vn, tw, vw, part, nullptr, nullptr,
                                      nullptr, A, B, T, V, D, s)
                : launch_v<MEAN_COLS>(tn, vn, tw, vw, part, nullptr, nullptr,
                                      nullptr, A, B, T, V, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(axis == 1 ? reduce_rows(part, out, rows, A, (float)B, s)
                         : reduce_rows(part, out, rows, B, (float)A, s));
}

// Floats of scratch interaction_similarity_bwd needs for the partial sums
// of its gather kernels at these sizes (0 when neither walk is split).
extern "C" int interaction_similarity_bwd_scratch(int A, int B, int T, int V,
                                                  int D) {
  const int slabs = (D + GD - 1) / GD;
  const int st = gather_splits(A, slabs, B), sv = gather_splits(B, slabs, A);
  return (st > 1 ? st * A * T * D : 0) + (sv > 1 ? sv * B * V * D : 0);
}

// Inputs as above plus g [A, B].  Scratch: m1 [A, T, B], m2 [A, B, V] fp32,
// i1 [A, T, B], i2 [A, B, V] bytes, part (interaction_similarity_bwd_scratch
// floats, unused when that is 0).  Out: dtn [A, T, D], dtw [A, T],
// dvn [B, V, D], dvw [B, V] fp32.
extern "C" int interaction_similarity_bwd(
    const float* tn, const float* vn, const float* tw, const float* vw,
    const float* g, float* m1, float* m2, unsigned char* i1, unsigned char* i2,
    float* part, float* dtn, float* dtw, float* dvn, float* dvw, int A, int B,
    int T, int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      launch_v<ARGMAX>(tn, vn, tw, vw, m1, m2, i1, i2, A, B, T, V, D, s);
  if (err != cudaSuccess) return (int)err;
  const int slabs = (D + GD - 1) / GD;
  const int st = gather_splits(A, slabs, B), sv = gather_splits(B, slabs, A);
  float* part_t = part;
  float* part_v = part + (st > 1 ? (size_t)st * A * T * D : 0);

  const size_t smem_t = (size_t)(T * GD + T) * sizeof(float);
  bwd_text_kernel<<<dim3(A, slabs, st), GD, smem_t, s>>>(
      vn, tw, vw, g, m1, i1, i2, st > 1 ? part_t : dtn, dtw, A, B, T, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (st > 1) {
    err = reduce_rows(part_t, dtn, st, A * T * D, 1.f, s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem_v = (size_t)(V * GD + V) * sizeof(float);
  bwd_video_kernel<<<dim3(B, slabs, sv), GD, smem_v, s>>>(
      tn, tw, vw, g, m2, i1, i2, sv > 1 ? part_v : dvn, dvw, A, B, T, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sv > 1) return (int)reduce_rows(part_v, dvn, sv, B * V * D, 1.f, s);
  return (int)cudaSuccess;
}
