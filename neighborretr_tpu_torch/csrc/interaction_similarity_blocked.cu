// Token-interaction similarity at long-token shapes (up to 64 words x 64
// frames), forward and backward, fp32 end to end.
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
// both maxima), at T, V <= 64, where the flat kernel's V <= 16 maxima per
// thread no longer fit registers.  Each max sends its gradient to the FIRST
// index that attains it; ties are the normal case.
//
// The TPU kernel walks the video-token axis as a sequential grid dimension,
// carries a running (max, first index) pair in scratch between grid steps,
// and in the backward multiplies dense 0/1 indicator slabs on the MXU in
// two grids that both recompute the logits.  Here nothing carries between
// blocks, so a block owns whole (caption, video) pairs:
//
// blocked_tile_kernel: one 128 x 128 tile of the [A·T, B·V] logits per
// block, rows = 128/TP captions x TP token slots, columns = 128/VP videos x
// VP token slots (TP, VP = T, V padded to a power of two >= 8; the padded
// slots are skipped by both reductions).  The product is a register-tiled
// fp32 GEMM: 256 threads, 8 x 8 logits each (two 4-wide groups 64 apart, so
// every shared read is a conflict-free float4), D streamed in chunks of 16
// through two k-major shared stages, the next chunk's global loads in
// flight in registers while the current one is multiplied.  Each logit is
// one thread's fmaf chain over d = 0..D-1, so the forward and the
// backward's recompute give the same bits and ties route consistently.  The
// tile then goes to shared memory once and three short passes reduce it:
// per (row, video) the max over v with its first index (m1, i1), per
// (caption, column) the max over t with its first index (m2, i2), per pair
// the two weighted sums.  The forward writes S, and under autograd m1/i1
// ([A, B, T]: what the backward's text side routes by, fp32 + one byte);
// the backward's call writes m2/i2 ([A, B, V]) only.  The [A, T, B, V]
// logits never reach device memory.
//
// interaction_similarity_blocked_bwd: the recompute above, then the two
// gather kernels of similarity_gather.cuh, which own a caption's / a
// video's gradient slab and add the (T + V) routed rows per pair in a fixed
// order: no float atomics, two runs give the same bits.  That is 1/32 of
// the TPU kernel's dense indicator products at T = V = 64.
//
// What bounds it on an H100: fp32 FMAs outside the tensor cores,
// 2·A·T·B·V·D = 1.03 TFLOP at (128, 64, 1920, 64, 512), 15.4 ms at 67
// TFLOP/s; the gathers by their index -> row -> shared-memory chains.  Left
// for later PRs: TF32x3 or bf16 tensor-core products (wgmma), TMA loads,
// cp.async in place of the register staging.

#include "similarity_gather.cuh"

namespace {

constexpr int BM = 128;      // logit rows per block
constexpr int BN = 128;      // logit columns per block
constexpr int BK = 16;       // D-chunk per shared stage
constexpr int NT = 256;      // threads: 16 x 16, 8 x 8 logits each
constexpr int LDT = BM + 4;  // k-major stage stride (keeps float4 alignment)
constexpr int LDC = BN + 1;  // logits tile stride (row walks hit 32 banks)
constexpr int MAXC = 16;     // most captions / videos per tile (TP, VP >= 8)
constexpr int MAX_TOKENS = 64;

inline int pad_pow2(int n) {
  int p = 8;
  while (p < n) p <<= 1;
  return p;
}

constexpr size_t TILE_SMEM =
    sizeof(float) * (BM * LDC + BM * MAXC + MAXC * BN);

// out [A, B] or null; m1/i1 [A, B, T] or null; m2/i2 [A, B, V] or null.
__global__ void __launch_bounds__(NT, 2)
blocked_tile_kernel(const float* __restrict__ tn, const float* __restrict__ vn,
                    const float* __restrict__ tw, const float* __restrict__ vw,
                    float* __restrict__ out, float* __restrict__ m1,
                    unsigned char* __restrict__ i1, float* __restrict__ m2,
                    unsigned char* __restrict__ i2, int A, int B, int T, int V,
                    int D, int TP, int VP, int tilesA, int tilesB, int fastA) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [2][BK][LDT]
  float* Bs = smem + 2 * BK * LDT;   // [2][BK][LDT]
  float* Cs = smem;                  // [BM][LDC], once the product is done
  float* P1 = smem + BM * LDC;       // [BM][CB]: tw · max over v
  float* P2 = P1 + BM * MAXC;        // [CA][BN]: vw · max over t

  const int tid = threadIdx.x;
  const int bid = blockIdx.x;
  // the side with fewer tiles varies fastest, so the blocks in flight
  // together re-read a working set that fits L2
  const int ia = fastA ? bid % tilesA : bid / tilesB;
  const int ib = fastA ? bid / tilesA : bid % tilesB;
  const int CA = BM / TP, CB = BN / VP;
  const int a0 = ia * CA, b0 = ib * CB;

  // loader: this thread copies k-quad kq of tile rows lr and lr + 64 on
  // both sides; slots past A/B/T/V load zeros
  const int lr = tid >> 2, kq = tid & 3;
  const float* arow[2];
  const float* brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lr + 64 * h;
    const int a = a0 + r / TP, t = r % TP;
    arow[h] = (a < A && t < T) ? tn + ((size_t)a * T + t) * D + kq * 4
                               : nullptr;
    const int b = b0 + r / VP, v = r % VP;
    brow[h] = (b < B && v < V) ? vn + ((size_t)b * V + v) * D + kq * 4
                               : nullptr;
  }
  float4 ra[2], rb[2];
  auto gload = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = arow[h] ? __ldg(reinterpret_cast<const float4*>(arow[h] + k0))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[h] = brow[h] ? __ldg(reinterpret_cast<const float4*>(brow[h] + k0))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto sstore = [&](int stage) {
    float* as = As + stage * BK * LDT + (kq * 4) * LDT + lr;
    float* bs = Bs + stage * BK * LDT + (kq * 4) * LDT + lr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      as[0 * LDT + 64 * h] = ra[h].x;
      as[1 * LDT + 64 * h] = ra[h].y;
      as[2 * LDT + 64 * h] = ra[h].z;
      as[3 * LDT + 64 * h] = ra[h].w;
      bs[0 * LDT + 64 * h] = rb[h].x;
      bs[1 * LDT + 64 * h] = rb[h].y;
      bs[2 * LDT + 64 * h] = rb[h].z;
      bs[3 * LDT + 64 * h] = rb[h].w;
    }
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = D / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) gload((c + 1) * BK);
    const float* as = As + (c & 1) * BK * LDT + ty * 4;
    const float* bs = Bs + (c & 1) * BK * LDT + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(as + k * LDT);
      const float4 a_hi = *reinterpret_cast<const float4*>(as + k * LDT + 64);
      const float4 b_lo = *reinterpret_cast<const float4*>(bs + k * LDT);
      const float4 b_hi = *reinterpret_cast<const float4*>(bs + k * LDT + 64);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (c + 1 < nk) sstore((c + 1) & 1);
    __syncthreads();   // stage (c+1)&1 is full; stage c&1 is free again
  }

  // the logits tile, once, into shared memory (over the dead stages)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 60) + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 60) + tx * 4 + j;
      Cs[r * LDC + c] = acc[i][j];
    }
  }
  __syncthreads();

  // pass 1, per (row, video): max over v, first index (strict >)
  if (out != nullptr || m1 != nullptr) {
    for (int task = tid; task < BM * CB; task += NT) {
      const int r = task % BM, j = task / BM;
      const int a = a0 + r / TP, t = r % TP, b = b0 + j;
      float p = 0.f;
      if (a < A && t < T && b < B) {
        const float* row = Cs + r * LDC + j * VP;
        float m = row[0];
        int iv = 0;
        for (int v = 1; v < V; ++v) {
          const float x = row[v];
          if (x > m) {
            m = x;
            iv = v;
          }
        }
        p = tw[(size_t)a * T + t] * m;
        if (m1 != nullptr) {
          const size_t o = ((size_t)a * B + b) * T + t;
          m1[o] = m;
          i1[o] = (unsigned char)iv;
        }
      }
      P1[r * CB + j] = p;
    }
  }
  // pass 2, per (caption, column): max over t, first index
  for (int task = tid; task < CA * BN; task += NT) {
    const int c = task % BN, i = task / BN;
    const int a = a0 + i, j = c / VP, v = c % VP, b = b0 + j;
    float p = 0.f;
    if (a < A && b < B && v < V) {
      const float* col = Cs + (i * TP) * LDC + c;
      float m = col[0];
      int it = 0;
      for (int t = 1; t < T; ++t) {
        const float x = col[t * LDC];
        if (x > m) {
          m = x;
          it = t;
        }
      }
      p = vw[(size_t)b * V + v] * m;
      if (m2 != nullptr) {
        const size_t o = ((size_t)a * B + b) * V + v;
        m2[o] = m;
        i2[o] = (unsigned char)it;
      }
    }
    P2[i * BN + c] = p;
  }
  __syncthreads();

  // pass 3, per pair: both weighted sums in token order
  if (out != nullptr && tid < CA * CB) {
    const int i = tid / CB, j = tid % CB;
    const int a = a0 + i, b = b0 + j;
    if (a < A && b < B) {
      float st = 0.f, sv = 0.f;
      for (int t = 0; t < T; ++t) st += P1[(i * TP + t) * CB + j];
      for (int v = 0; v < V; ++v) sv += P2[i * BN + j * VP + v];
      out[(size_t)a * B + b] = 0.5f * (st + sv);
    }
  }
}

inline bool bad_shape(int A, int B, int T, int V, int D) {
  return T < 1 || T > MAX_TOKENS || V < 1 || V > MAX_TOKENS || D < BK ||
         D % BK != 0 || A < 1 || B < 1;
}

cudaError_t launch_tile(const float* tn, const float* vn, const float* tw,
                        const float* vw, float* out, float* m1,
                        unsigned char* i1, float* m2, unsigned char* i2, int A,
                        int B, int T, int V, int D, cudaStream_t stream) {
  const int TP = pad_pow2(T), VP = pad_pow2(V);
  const int CA = BM / TP, CB = BN / VP;
  const int tilesA = (A + CA - 1) / CA, tilesB = (B + CB - 1) / CB;
  const long long blocks = (long long)tilesA * tilesB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      blocked_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TILE_SMEM);
  if (err != cudaSuccess) return err;
  blocked_tile_kernel<<<(unsigned)blocks, NT, TILE_SMEM, stream>>>(
      tn, vn, tw, vw, out, m1, i1, m2, i2, A, B, T, V, D, TP, VP, tilesA,
      tilesB, tilesA <= tilesB ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// tn [A, T, D], vn [B, V, D], tw [A, T], vw [B, V], out [A, B]; all fp32,
// contiguous, 16-byte aligned.  m1 (fp32) and i1 (bytes), both [A, B, T],
// are the backward's residuals: the max over v and its first index; pass
// null for both when no gradient will be asked for.  Requires T, V <= 64
// and D % 16 == 0 (the wrapper checks).
extern "C" int interaction_similarity_blocked_fwd(
    const float* tn, const float* vn, const float* tw, const float* vw,
    float* out, float* m1, unsigned char* i1, int A, int B, int T, int V,
    int D, void* stream) {
  if (bad_shape(A, B, T, V, D) || (m1 == nullptr) != (i1 == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_tile(tn, vn, tw, vw, out, m1, i1, nullptr, nullptr, A, B,
                          T, V, D, (cudaStream_t)stream);
}

// Floats of scratch interaction_similarity_blocked_bwd needs for the
// partial sums of its gather kernels (0 when neither walk is split).
extern "C" int interaction_similarity_blocked_bwd_scratch(int A, int B, int T,
                                                          int V, int D) {
  return gather_scratch(A, B, T, V, D);
}

// Inputs as the forward's plus g [A, B] and the forward's residuals m1, i1
// [A, B, T].  Scratch: m2 [A, B, V] fp32, i2 [A, B, V] bytes, part
// (interaction_similarity_blocked_bwd_scratch floats, unused when that is
// 0).  Out: dtn [A, T, D], dtw [A, T], dvn [B, V, D], dvw [B, V] fp32.
extern "C" int interaction_similarity_blocked_bwd(
    const float* tn, const float* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const unsigned char* i1, float* m2,
    unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, void* stream) {
  if (bad_shape(A, B, T, V, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_tile(tn, vn, tw, vw, nullptr, nullptr, nullptr, m2,
                                i2, A, B, T, V, D, s);
  if (err != cudaSuccess) return (int)err;
  // m1/i1 are [A, B, T] here: token stride 1, video stride T
  return (int)gather_backward(tn, vn, tw, vw, g, m1, m2, i1, i2, part, dtn,
                              dtw, dvn, dvw, A, B, T, V, D, 1, T, s);
}
