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

#include <cuda_runtime.h>
#include <math.h>

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

template <int VP>
__global__ void __launch_bounds__(384)
similarity_kernel(const float* __restrict__ tn, const float* __restrict__ vn,
                  const float* __restrict__ tw, const float* __restrict__ vw,
                  float* __restrict__ out, int A, int B, int T, int V, int D,
                  int RG, int QB) {
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
#pragma unroll
  for (int j = 0; j < VP; ++j) m2[j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int t = rg * TPT + i;
    if (t >= T) continue;
    float m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      if (j < V) m1 = fmaxf(m1, acc[i][j]);
      m2[j] = fmaxf(m2[j], acc[i][j]);
    }
    if (a < A) s_t += tw[(size_t)a * T + t] * m1;
  }
  float* red = smem;  // [QB][RG][VIDS][VP + 1], reusing the tiles
  float* mine = red + ((qi * RG + rg) * VIDS + lane) * (VP + 1);
  mine[0] = s_t;
#pragma unroll
  for (int j = 0; j < VP; ++j) mine[1 + j] = m2[j];
  __syncthreads();

  if (rg == 0 && a < A && b < B) {
    float s = 0.f, mv[VP];
#pragma unroll
    for (int j = 0; j < VP; ++j) mv[j] = -INFINITY;
    for (int g = 0; g < RG; ++g) {
      const float* r = red + ((qi * RG + g) * VIDS + lane) * (VP + 1);
      s += r[0];
#pragma unroll
      for (int j = 0; j < VP; ++j) mv[j] = fmaxf(mv[j], r[1 + j]);
    }
    float s_v = 0.f;
#pragma unroll
    for (int j = 0; j < VP; ++j)
      if (j < V) s_v += vw[(size_t)b * V + j] * mv[j];
    out[(size_t)a * B + b] = 0.5f * (s + s_v);
  }
}

template <int VP>
cudaError_t launch(const float* tn, const float* vn, const float* tw,
                   const float* vw, float* out, int A, int B, int T, int V,
                   int D, cudaStream_t stream) {
  const int RG = (T + TPT - 1) / TPT;
  const int QB = RG < 8 ? 8 / RG : 1;
  const size_t stage =
      (size_t)QB * RG * TPT * DK + (size_t)VIDS * (VP * DK + 4);
  const size_t red = (size_t)QB * RG * VIDS * (VP + 1);
  const size_t smem = sizeof(float) * (2 * stage > red ? 2 * stage : red);
  auto kern = similarity_kernel<VP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((A + QB - 1) / QB, (B + VIDS - 1) / VIDS);
  kern<<<grid, QB * RG * 32, smem, stream>>>(tn, vn, tw, vw, out, A, B, T, V,
                                             D, RG, QB);
  return cudaGetLastError();
}

}  // namespace

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned.  Requires T <= 64, V <= 16, D % 32 == 0
// (the wrapper checks).
extern "C" int interaction_similarity_fwd(const float* tn, const float* vn,
                                          const float* tw, const float* vw,
                                          float* out, int A, int B, int T,
                                          int V, int D, void* stream) {
  if (T < 1 || T > 64 || V < 1 || V > 16 || D % DK != 0 || A < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((V + 3) / 4) {
    case 1: return (int)launch<4>(tn, vn, tw, vw, out, A, B, T, V, D, s);
    case 2: return (int)launch<8>(tn, vn, tw, vw, out, A, B, T, V, D, s);
    case 3: return (int)launch<12>(tn, vn, tw, vw, out, A, B, T, V, D, s);
    default: return (int)launch<16>(tn, vn, tw, vw, out, A, B, T, V, D, s);
  }
}
