// Multi-head self-attention on packed qkv, forward and backward:
//
//   out[n, :, h] = softmax(scale · q_h k_h^T + bias_n) v_h      per sequence n
//
// from the packed bf16 [N, L, 3D] output of the qkv projection (q, k, v of
// head h at columns h·64, D + h·64, 2D + h·64 of a row) straight into
// [N, L, D], with an optional additive fp32 bias [N, L, L]; head dim 64, any
// L >= 1.
//
// Replaces the six TPU kernels of neighborretr_tpu/ops/pallas_attention.py
// (public fused_frame_attention): _attention_core / _attention_bwd (several
// frames per grid cell under a frame-block-diagonal mask), _attention_core_
// rows / _attention_rows_bwd (query rows in chunks for long sequences) and
// _attention_core_biased / _attention_biased_bwd.  The frame batching, the
// block-diagonal mask and the row chunking are TPU tiling devices; what they
// compute is the per-sequence function above, which two kernels serve here
// at every L, with or without bias.
//
// Rounding points follow the TPU kernels, so that the plain PyTorch version
// (ops/attention.py) can hold these to it:
//   q · hd^-0.5 in fp32, rounded to bf16 (hd = 64: a power of two, so the
//   scaling is exact and commutes with the product; the kernels multiply the
//   unscaled q and scale the fp32 logits by 2^-3);
//   logits fp32 (+ bias), softmax fp32 with its max subtracted, each
//   probability normalised by the row's sum (times its reciprocal; the
//   exponential is the hardware's ex2-based __expf: both differ from the
//   plain version's below fp32's last bits, far under the bf16 rounding that
//   follows) and then rounded to bf16 for probs·V; out accumulated in fp32,
//   stored as bf16;
//   backward: dV = probs16^T · g, dprobs = g · v^T in fp32,
//   dlogits = probs32 · (dprobs - sum_k dprobs · probs32), dlogits · scale
//   rounded to bf16, dQ = dl16 · k, dK = dl16^T · q (unscaled), all three
//   accumulated in fp32 and rounded once.
//
// Design.  A block of 4 warps owns one 64-row tile of one (sequence, head)
// and loops over 64-row tiles of the other side; a warp owns 16 rows and
// holds its A fragments (q, g, or k, v) in registers; products are bf16
// mma.sync m16n8k16 with fp32 accumulation; the "col" operand is a row-major
// shared-memory tile read as it lies (x · y^T) or through ldmatrix.trans
// (x · y).  No [L, L] matrix is ever stored: the softmax is exact (every
// probability is normalised by its row's full sum before it is rounded), so
// the keys are walked twice, once for the row's max and sum (kept online,
// which perturbs them at fp32 rounding level only) and once for the products.
//   forward:  pass 1 max/sum, pass 2 probs · V.
//   backward: kernel dq (block owns a query tile): pass 1 max, sum and
//             delta = sum_k dprobs · probs (online too), written to a small
//             fp32 scratch [N, H, 3, L]; pass 2 dQ.  Kernel dkv (block owns
//             a key tile, loops over query tiles in ascending order): the
//             transposed tiles K · Q^T and V · g^T, the scratch's row
//             statistics, dV and dK accumulated in registers.  Every sum over
//             tiles is taken inside one block in a fixed order: no float
//             atomics, two runs give the same bits.
//
// What bounds it on an H100: operations (4·N·L^2·D forward, 10·N·L^2·D
// backward with one recompute, on the bf16 tensor cores; the bytes are the
// packed buffer once in and the output once out).  This first version does
// 6·N·L^2·D forward and 18·N·L^2·D backward (the second walk; dQ and dK/dV
// in separate kernels), pads L to a multiple of 64 on both sides (whole
// 8-column tiles and 16-row warps past L are skipped), reaches the tensor
// cores through mma.sync without a cp.async/TMA pipeline, and re-reads each
// head's K and V from L2 once per query tile.  Not done yet: wgmma with
// TMA-fed rings, one walk with the statistics saved by the forward, 128-row
// tiles.

#include "common.cuh"

namespace {

constexpr int HD = 64;            // head dim: every CLIP tower here
constexpr int BT = 64;            // rows of a tile, both sides
constexpr int TS = HD + 8;        // shared row stride (bf16): 144-byte rows,
                                  // fragment loads and ldmatrix conflict-free
constexpr int NTH = 128;          // 4 warps, 16 rows each
constexpr float SCALE = 0.125f;   // HD^-0.5

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows r0..r0+63 of 64 columns starting at src (row stride ld) -> a shared
// tile; rows past L are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld,
                                          int r0, int L) {
  for (int i = threadIdx.x; i < BT * (HD / 8); i += NTH) {
    const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c8);
    *reinterpret_cast<uint4*>(dst + r * TS + c8) = v;
  }
}

// the A fragments of a warp's 16 rows of a tile, all four k-steps
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int row0, int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* r0 = tile + (row0 + g) * TS + kk * 16 + 2 * tq;
    const bf16* r1 = r0 + 8 * TS;
    a[kk][0] = ld32(r0);
    a[kk][1] = ld32(r1);
    a[kk][2] = ld32(r0 + 8);
    a[kk][3] = ld32(r1 + 8);
  }
}

// c[16, 64] = a[16, 64] · y^T for a row-major tile y [64, 64]; only the
// first nlive 8-column tiles are multiplied, the rest stay zero
__device__ __forceinline__ void mma_xyt(float (&c)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* y, int nlive, int g,
                                        int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt < nlive) {
        const bf16* p = y + (nt * 8 + g) * TS + kk * 16 + 2 * tq;
        mma16816(c[nt], a[kk][0], a[kk][1], a[kk][2], a[kk][3], ld32(p),
                 ld32(p + 8));
      }
}

// fp32 [16, 64] accumulator fragments -> bf16 A fragments of the next
// product (the accumulator's 8-column tiles 2kk, 2kk+1 are k-step kk)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// o[16, 64] += a[16, 64] · y for a row-major tile y [64, 64] (its rows are
// the contraction), the "col" operand through ldmatrix.trans; only the first
// klive rows of y count (a is zero past them)
__device__ __forceinline__ void mma_xy(float (&o)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* y, int klive, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk * 16 < klive) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, y + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1))
                                     * TS + np * 16 + 8 * (lane >> 4));
        mma16816(o[2 * np], a[kk][0], a[kk][1], a[kk][2], a[kk][3], b[0],
                 b[1]);
        mma16816(o[2 * np + 1], a[kk][0], a[kk][1], a[kk][2], a[kk][3], b[2],
                 b[3]);
      }
    }
}

// logits of a warp's 16 query rows against one key tile: acc · scale + bias,
// -inf at key columns past L.  b_lo/b_hi: the bias rows of this thread's two
// query rows, or null
__device__ __forceinline__ void logits(float (&s)[8][4],
                                       const uint32_t (&qa)[4][4],
                                       const bf16* ks, const float* b_lo,
                                       const float* b_hi, int k0, int L,
                                       int g, int tq) {
  const int nlive = min(8, (L - k0 + 7) / 8);
  mma_xyt(s, qa, ks, nlive, g, tq);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * tq + (e & 1);
      const float* b = (e & 2) ? b_hi : b_lo;
      s[nt][e] = col < L ? s[nt][e] * SCALE + (b ? b[col] : 0.f) : -INFINITY;
    }
}

// ---------------------------------------------------------------------------
// forward: block = (query tile, head, sequence)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTH)
frame_attention_fwd_kernel(const bf16* __restrict__ qkv,
                           const float* __restrict__ bias,
                           bf16* __restrict__ out, int L, int D) {
  __shared__ __align__(16) bf16 qs[BT * TS];
  __shared__ __align__(16) bf16 ks[BT * TS];
  __shared__ __align__(16) bf16 vs[BT * TS];
  const int q0 = blockIdx.x * BT, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* base = qkv + (size_t)n * L * 3 * D + h * HD;
  const bool live = q0 + warp * 16 < L;       // a warp past L only loads

  load_tile(qs, base, 3 * D, q0, L);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, qs, warp * 16, g, tq);
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float* b_lo = (bias && row_lo < L)
                          ? bias + ((size_t)n * L + row_lo) * L : nullptr;
  const float* b_hi = (bias && row_hi < L)
                          ? bias + ((size_t)n * L + row_hi) * L : nullptr;

  // ---- pass 1: each row's max and sum over all keys ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[8][4];
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_tile(ks, base + D, 3 * D, k0, L);
    __syncthreads();
    if (!live) continue;
    logits(s, qa, ks, b_lo, b_hi, k0, L, g, tq);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sum[0] += __expf(s[nt][0] - mx[0]) + __expf(s[nt][1] - mx[0]);
      sum[1] += __expf(s[nt][2] - mx[1]) + __expf(s[nt][3] - mx[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * __expf(m[i] - mx[i]) + quad_sum(sum[i]);
      m[i] = mx[i];
    }
  }

  // ---- pass 2: probs (normalised, then rounded) · V ----
  const float il[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_tile(ks, base + D, 3 * D, k0, L);
    load_tile(vs, base + 2 * D, 3 * D, k0, L);
    __syncthreads();
    if (!live) continue;
    logits(s, qa, ks, b_lo, b_hi, k0, L, g, tq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * il[e >> 1];
    uint32_t pa[4][4];
    to_a(pa, s);
    mma_xy(o, pa, vs, L - k0, lane);
  }
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * HD + nt * 8 + 2 * tq;
    if (row_lo < L)
      store2(out + ((size_t)n * L + row_lo) * D + col, o[nt][0], o[nt][1]);
    if (row_hi < L)
      store2(out + ((size_t)n * L + row_hi) * D + col, o[nt][2], o[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ and the row statistics: block = (query tile, head, sequence)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTH)
frame_attention_bwd_dq_kernel(const bf16* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const bf16* __restrict__ gout,
                              float* __restrict__ stats,
                              bf16* __restrict__ dqkv, int L, int D) {
  __shared__ __align__(16) bf16 qs[BT * TS];   // q, then g
  __shared__ __align__(16) bf16 ks[BT * TS];
  __shared__ __align__(16) bf16 vs[BT * TS];
  const int q0 = blockIdx.x * BT, h = blockIdx.y, n = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* base = qkv + (size_t)n * L * 3 * D + h * HD;
  const bool live = q0 + warp * 16 < L;

  uint32_t qa[4][4], ga[4][4];
  load_tile(qs, base, 3 * D, q0, L);
  __syncthreads();
  load_a(qa, qs, warp * 16, g, tq);
  __syncthreads();
  load_tile(qs, gout + (size_t)n * L * D + h * HD, D, q0, L);
  __syncthreads();
  load_a(ga, qs, warp * 16, g, tq);
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float* b_lo = (bias && row_lo < L)
                          ? bias + ((size_t)n * L + row_lo) * L : nullptr;
  const float* b_hi = (bias && row_hi < L)
                          ? bias + ((size_t)n * L + row_hi) * L : nullptr;

  // ---- pass 1: max, sum and sum_k exp · dprobs of each row, online ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_tile(ks, base + D, 3 * D, k0, L);
    load_tile(vs, base + 2 * D, 3 * D, k0, L);
    __syncthreads();
    if (!live) continue;
    logits(s, qa, ks, b_lo, b_hi, k0, L, g, tq);
    mma_xyt(dp, ga, vs, min(8, (L - k0 + 7) / 8), g, tq);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = __expf(s[nt][e] - mx[e >> 1]);
        sum[e >> 1] += ex;
        dsum[e >> 1] += ex * dp[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float corr = __expf(m[i] - mx[i]);
      l[i] = l[i] * corr + quad_sum(sum[i]);
      dl[i] = dl[i] * corr + quad_sum(dsum[i]);
      m[i] = mx[i];
    }
  }
  float delta[2] = {0.f, 0.f};
  if (live) {
    delta[0] = dl[0] / l[0];
    delta[1] = dl[1] / l[1];
    if (tq == 0) {
      float* st = stats + ((size_t)n * H + h) * 3 * L;
      if (row_lo < L) {
        st[row_lo] = m[0];
        st[L + row_lo] = l[0];
        st[2 * L + row_lo] = delta[0];
      }
      if (row_hi < L) {
        st[row_hi] = m[1];
        st[L + row_hi] = l[1];
        st[2 * L + row_hi] = delta[1];
      }
    }
  }

  // ---- pass 2: dQ = bf16(probs · (dprobs - delta) · scale) · K ----
  const float il[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_tile(ks, base + D, 3 * D, k0, L);
    load_tile(vs, base + 2 * D, 3 * D, k0, L);
    __syncthreads();
    if (!live) continue;
    logits(s, qa, ks, b_lo, b_hi, k0, L, g, tq);
    mma_xyt(dp, ga, vs, min(8, (L - k0 + 7) / 8), g, tq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]) * il[e >> 1];
        s[nt][e] = p * (dp[nt][e] - delta[e >> 1]) * SCALE;
      }
    uint32_t da[4][4];
    to_a(da, s);
    mma_xy(dq, da, ks, L - k0, lane);
  }
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * HD + nt * 8 + 2 * tq;
    if (row_lo < L)
      store2(dqkv + ((size_t)n * L + row_lo) * 3 * D + col, dq[nt][0],
             dq[nt][1]);
    if (row_hi < L)
      store2(dqkv + ((size_t)n * L + row_hi) * 3 * D + col, dq[nt][2],
             dq[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: block = (key tile, head, sequence); query tiles in
// ascending order, the sums over them in registers
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTH)
frame_attention_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               const bf16* __restrict__ gout,
                               const float* __restrict__ stats,
                               bf16* __restrict__ dqkv, int L, int D) {
  __shared__ __align__(16) bf16 qs[BT * TS];   // k, then the q tiles
  __shared__ __align__(16) bf16 gs[BT * TS];   // v, then the g tiles
  __shared__ float sm[3][BT];                  // max, 1/sum, delta per query
  const int k0 = blockIdx.x * BT, h = blockIdx.y, n = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* base = qkv + (size_t)n * L * 3 * D + h * HD;
  const bf16* gbase = gout + (size_t)n * L * D + h * HD;
  const float* st = stats + ((size_t)n * H + h) * 3 * L;
  const bool live = k0 + warp * 16 < L;

  uint32_t ka[4][4], va[4][4];
  load_tile(qs, base + D, 3 * D, k0, L);
  load_tile(gs, base + 2 * D, 3 * D, k0, L);
  __syncthreads();
  load_a(ka, qs, warp * 16, g, tq);
  load_a(va, gs, warp * 16, g, tq);
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  float pt[8][4], dpt[8][4];
  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();
    load_tile(qs, base, 3 * D, q0, L);
    load_tile(gs, gbase, D, q0, L);
    if (threadIdx.x < BT) {
      const int r = q0 + threadIdx.x;
      sm[0][threadIdx.x] = r < L ? st[r] : 0.f;
      sm[1][threadIdx.x] = r < L ? __frcp_rn(st[L + r]) : 1.f;
      sm[2][threadIdx.x] = r < L ? st[2 * L + r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    // the transposed tiles: rows are this warp's keys, columns the queries
    const int nlive = min(8, (L - q0 + 7) / 8);
    mma_xyt(pt, ka, qs, nlive, g, tq);       // k · q^T
    mma_xyt(dpt, va, gs, nlive, g, tq);      // v · g^T = dprobs^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * tq + (e & 1);
        const int query = q0 + qi;
        const int key = (e & 2) ? key_hi : key_lo;
        float p = 0.f, ds = 0.f;
        if (query < L && key < L) {
          float lg = pt[nt][e] * SCALE;
          if (bias) lg += bias[((size_t)n * L + query) * L + key];
          p = __expf(lg - sm[0][qi]) * sm[1][qi];
          ds = p * (dpt[nt][e] - sm[2][qi]) * SCALE;
        }
        pt[nt][e] = p;
        dpt[nt][e] = ds;
      }
    uint32_t pa[4][4];
    to_a(pa, pt);
    mma_xy(dv, pa, gs, L - q0, lane);        // probs^T · g
    to_a(pa, dpt);
    mma_xy(dk, pa, qs, L - q0, lane);        // dlogits^T · q (unscaled)
  }
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * HD + nt * 8 + 2 * tq;
    if (key_lo < L) {
      bf16* row = dqkv + ((size_t)n * L + key_lo) * 3 * D + col;
      store2(row + D, dk[nt][0], dk[nt][1]);
      store2(row + 2 * D, dv[nt][0], dv[nt][1]);
    }
    if (key_hi < L) {
      bf16* row = dqkv + ((size_t)n * L + key_hi) * 3 * D + col;
      store2(row + D, dk[nt][2], dk[nt][3]);
      store2(row + 2 * D, dv[nt][2], dv[nt][3]);
    }
  }
}

bool bad_shape(int N, int L, int D, int H) {
  return N < 1 || N > 65535 || L < 1 || H < 1 || H > 65535 || D != HD * H;
}

}  // namespace

// qkv [N, L, 3D] bf16, out [N, L, D] bf16, bias [N, L, L] fp32 or null; all
// contiguous and 16-byte aligned.  Requires D == 64 * H.
extern "C" int frame_attention_fwd(const void* qkv, const float* bias,
                                   void* out, int N, int L, int D, int H,
                                   void* stream) {
  if (bad_shape(N, L, D, H)) return (int)cudaErrorInvalidValue;
  dim3 grid((L + BT - 1) / BT, H, N);
  frame_attention_fwd_kernel<<<grid, NTH, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), bias, static_cast<bf16*>(out), L, D);
  return (int)cudaGetLastError();
}

// qkv [N, L, 3D], g [N, L, D], dqkv [N, L, 3D] bf16; bias [N, L, L] fp32 or
// null; stats [N, H, 3, L] fp32 scratch; all contiguous, the bf16 ones
// 16-byte aligned.  Every element of dqkv is written.
extern "C" int frame_attention_bwd(const void* qkv, const float* bias,
                                   const void* g, float* stats, void* dqkv,
                                   int N, int L, int D, int H, void* stream) {
  if (bad_shape(N, L, D, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((L + BT - 1) / BT, H, N);
  const bf16* qb = static_cast<const bf16*>(qkv);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* db = static_cast<bf16*>(dqkv);
  frame_attention_bwd_dq_kernel<<<grid, NTH, 0, s>>>(qb, bias, gb, stats, db,
                                                     L, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  frame_attention_bwd_dkv_kernel<<<grid, NTH, 0, s>>>(qb, bias, gb, stats, db,
                                                      L, D);
  return (int)cudaGetLastError();
}
