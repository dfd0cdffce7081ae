// Fused pre-LN attention sublayer, forward:  y = x + W_o · MHA(LN(x)) + b_o.
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_block_attention.py::
// _make_fwd_ln_kernel, launched by _ln_core_call (public
// fused_ln_attention_residual), both without and with the additive
// per-sequence bias [N, L, L] (text causal∧padding, temporal key padding).
// The same kernels without LayerNorm and residual (the template flag LN and
// RES off, entry attention_sublayer_fwd: K10) replace the same file's
// _block_attention_core and _block_attention_biased_core (public
// fused_attention_sublayer): y = W_o · MHA(h) + b_o on a pre-normalised h.
//
// Rounding points follow the TPU kernel so that the plain PyTorch version
// (ops/block_attention.py) can hold this one to it:
//   x bf16 in; LayerNorm in fp32, h rounded to bf16;
//   qkv = h · W_qkv with bf16 operands and fp32 accumulation, + b_qkv (fp32),
//   rounded to bf16; q · hd^-0.5 in fp32, rounded to bf16;
//   logits fp32 (+ bias), softmax fp32 with its max subtracted, probs
//   rounded to bf16; attn_out accumulated in fp32, rounded to bf16;
//   y = attn_out · W_o (bf16 operands, fp32 accumulation) + b_o + x in fp32,
//   stored as bf16.
// Weights come in torch's layout: w_qkv is in_proj_weight [3D, D] (the
// transpose of the TPU kernel's input-major [D, 3D]; q|k|v blocks of D rows,
// head h at rows h·hd..(h+1)·hd of each block) and w_out is
// out_proj.weight [D, D] (out, in).  Both are "col" operands of mma.sync
// as they lie: each output column's K values are contiguous.
//
// Design: two kernels.
//   A. attn_heads_kernel, one block per (sequence, head), 8 warps.
//      LayerNorm of the sequence (or, for K10, h as it is) into shared
//      memory (bf16, L padded to a multiple of 16, padded rows zero); the head's q/k/v columns [Lp, 192]
//      as bf16 mma.sync m16n8k16 products (warp w owns 3 of the 24 n-tiles,
//      all m-tiles; W_qkv fragments stream from L2 one k-step ahead); then
//      q·k^T and probs·V as mma.sync tiles too (v stored transposed, the
//      "col" operand), the biased softmax in fp32 between them, one warp per
//      row; writes attn_out bf16.
//   B. out_proj_kernel, a 64x64-tile mma.sync GEMM over the N·L rows with
//      the bias and (K1 only) the residual fused into its epilogue.
//
// What bounds it on an H100: at the vision shape (N·L = 38400 rows at
// index batch 64, D = 768) the two projections are ~0.2 TFLOP per layer, so
// the tensor cores bound it; this first version reaches them only through
// mma.sync without a cp.async/TMA pipeline, re-reads each head's W_qkv
// slice from L2 once per sequence, recomputes the LayerNorm once per head,
// and round-trips attn_out through device memory between A and B.  Left
// for later PRs: several sequences per block (weight reuse), keeping
// attn_out on chip, wgmma with TMA-fed shared-memory rings.

#include "common.cuh"

namespace {

constexpr int HD = 64;              // head dim: every CLIP tower here
constexpr int A_WARPS = 8;
constexpr int NT_PER_WARP = 3;      // 3 * HD / 8 = 24 n-tiles over 8 warps
constexpr int QS = HD + 8;          // q/k shared row stride (bf16)
static_assert(A_WARPS * 8 == HD, "probs·V: one 8-column n-tile per warp");

// ---------------------------------------------------------------------------
// kernel A: LN -> head's q/k/v -> softmax(q k^T + bias) v  (per sequence, head)
// ---------------------------------------------------------------------------
template <int MT, bool LN>
__global__ void __launch_bounds__(A_WARPS * 32)
attn_heads_kernel(const bf16* __restrict__ x, const float* __restrict__ bias,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const bf16* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                  bf16* __restrict__ attn, int L, int D, float eps,
                  float scale) {
  constexpr int LP = 16 * MT;
  constexpr int KS = LP + 8;   // row stride of v^T and probs (bf16)
  constexpr int PS = LP + 4;   // row stride of the fp32 logits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HS = D + 8;  // h row stride: 8 rows land in 8 distinct banks
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);            // [LP][D + 8]
  // reused once h is consumed (strides keep mma fragment loads free of
  // bank conflicts):
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [LP][QS]
  bf16* ks = qs + LP * QS;                                 // [LP][QS]
  bf16* vt = ks + LP * QS;                                 // [HD][KS], v^T
  bf16* pb = vt + HD * KS;                                 // [LP][KS] probs
  float* ps = reinterpret_cast<float*>(pb + LP * KS);      // [LP][PS]

  const int n = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  // ---- LayerNorm (fp32 island) or h as it is -> bf16 rows in shared memory
  load_rows<LN>(x + (size_t)n * L * D, hs, HS, L, LP, D, ln_w, ln_b, eps, warp,
                A_WARPS, lane);
  __syncthreads();

  // ---- q/k/v for head h: [LP, D] x [D, 3*HD] on the tensor cores ----
  float acc[MT][NT_PER_WARP][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT_PER_WARP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const bf16* wrow[NT_PER_WARP];
#pragma unroll
  for (int j = 0; j < NT_PER_WARP; ++j) {
    int c = (warp * NT_PER_WARP + j) * 8 + g;      // column within q|k|v
    int part = c / HD, within = c % HD;
    wrow[j] = w_qkv + ((size_t)part * D + h * HD + within) * D;
  }

  // W_qkv fragments stream from L2 one k-step ahead of the products that
  // use them (two register sets, D % 32 == 0)
  uint32_t bx[NT_PER_WARP][2], by[NT_PER_WARP][2];
  auto load_b = [&](uint32_t (&b)[NT_PER_WARP][2], int k0) {
#pragma unroll
    for (int j = 0; j < NT_PER_WARP; ++j) {
      b[j][0] = ldg32(wrow[j] + k0 + 2 * tq);
      b[j][1] = ldg32(wrow[j] + k0 + 2 * tq + 8);
    }
  };
  auto mma_step = [&](const uint32_t (&b)[NT_PER_WARP][2], int k0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* r0 = hs + (m * 16 + g) * HS + k0 + 2 * tq;
      const bf16* r1 = r0 + 8 * HS;
      uint32_t a0 = ld32(r0), a1 = ld32(r1), a2 = ld32(r0 + 8),
               a3 = ld32(r1 + 8);
#pragma unroll
      for (int j = 0; j < NT_PER_WARP; ++j)
        mma16816(acc[m][j], a0, a1, a2, a3, b[j][0], b[j][1]);
    }
  };
  load_b(bx, 0);
  for (int k0 = 0; k0 < D; k0 += 32) {
    load_b(by, k0 + 16);
    mma_step(bx, k0);
    if (k0 + 32 < D) load_b(bx, k0 + 32);
    mma_step(by, k0 + 16);
  }
  __syncthreads();  // every warp is done with hs: reuse it for q/k/v

#pragma unroll
  for (int j = 0; j < NT_PER_WARP; ++j) {
    const int c0 = (warp * NT_PER_WARP + j) * 8 + 2 * tq;
    const int part = c0 / HD, within = c0 % HD;
    const float bias0 = b_qkv[part * D + h * HD + within];
    const float bias1 = b_qkv[part * D + h * HD + within + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + 8 * half;
        float v0 = round_bf16(acc[m][j][2 * half] + bias0);
        float v1 = round_bf16(acc[m][j][2 * half + 1] + bias1);
        if (part == 0) {          // q · hd^-0.5 in fp32, rounded again
          qs[r * QS + within] = __float2bfloat16(v0 * scale);
          qs[r * QS + within + 1] = __float2bfloat16(v1 * scale);
        } else if (part == 1) {
          ks[r * QS + within] = __float2bfloat16(v0);
          ks[r * QS + within + 1] = __float2bfloat16(v1);
        } else {                  // v stored transposed: the "col" operand
          vt[within * KS + r] = __float2bfloat16(v0);
          vt[(within + 1) * KS + r] = __float2bfloat16(v1);
        }
      }
    }
  }
  __syncthreads();

  // ---- logits = q · k^T (fp32 accumulation) on the tensor cores ----
  // 16x8 tiles over [LP, LP], spread across the warps; padded key columns
  // (j >= L) are computed and then left out of the softmax
  for (int t = warp; t < MT * 2 * MT; t += A_WARPS) {
    const int m = t / (2 * MT), nt = t % (2 * MT);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      const bf16* r0 = qs + (m * 16 + g) * QS + k0 + 2 * tq;
      const bf16* r1 = r0 + 8 * QS;
      const bf16* kb = ks + (nt * 8 + g) * QS + k0 + 2 * tq;
      mma16816(c, ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8), ld32(kb),
               ld32(kb + 8));
    }
    float* p0 = ps + (m * 16 + g) * PS + nt * 8 + 2 * tq;
    p0[0] = c[0];
    p0[1] = c[1];
    p0[8 * PS] = c[2];
    p0[8 * PS + 1] = c[3];
  }
  __syncthreads();

  // ---- + bias, softmax per row (fp32, max subtracted), probs -> bf16 ----
  const float* bn = bias ? bias + (size_t)n * L * L : nullptr;
  for (int i = warp; i < LP; i += A_WARPS) {
    bf16* prow = pb + i * KS;
    if (i >= L) {
      for (int j = lane; j < LP; j += 32) prow[j] = __float2bfloat16(0.f);
      continue;
    }
    const float* lr = ps + i * PS;
    float e[2];                     // L <= 64: two keys per lane
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      e[u] = j < L ? lr[j] + (bn ? bn[i * L + j] : 0.f) : -INFINITY;
      m = fmaxf(m, e[u]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e[u] = lane + 32 * u < L ? expf(e[u] - m) : 0.f;
      sum += e[u];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j < LP) prow[j] = __float2bfloat16(e[u] / sum);
    }
  }
  __syncthreads();

  // ---- attn_out = probs · v (fp32 accumulation), bf16 to device memory ----
  // warp w owns head columns 8w..8w+7, all query rows
  {
    float c[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) c[m][e2] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < LP; k0 += 16) {
      const bf16* vb = vt + (warp * 8 + g) * KS + k0 + 2 * tq;
      const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const bf16* r0 = pb + (m * 16 + g) * KS + k0 + 2 * tq;
        const bf16* r1 = r0 + 8 * KS;
        mma16816(c[m], ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8), b0, b1);
      }
    }
    const int col = h * HD + warp * 8 + 2 * tq;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + 8 * half;
        if (r < L)
          *reinterpret_cast<__nv_bfloat162*>(
              attn + ((size_t)n * L + r) * D + col) =
              __floats2bfloat162_rn(c[m][2 * half], c[m][2 * half + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// kernel B: y = attn_out · W_o^T + b_o (+ x where RES)   (64x64 tiles, 4
// warps of 32x32)
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 32, SK = BK + 8;

template <bool RES>
__global__ void __launch_bounds__(128)
out_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                const float* __restrict__ b_out, const bf16* __restrict__ x,
                bf16* __restrict__ y, int M, int D) {
  __shared__ __align__(16) bf16 as[BM * SK];
  __shared__ __align__(16) bf16 ws[BN * SK];
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp / 2, wn = warp % 2;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = threadIdx.x + it * 128;
      const int r = idx / 4, c8 = (idx % 4) * 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      if (bm + r < M)
        va = *reinterpret_cast<const uint4*>(a + (size_t)(bm + r) * D + k0 + c8);
      *reinterpret_cast<uint4*>(as + r * SK + c8) = va;
      *reinterpret_cast<uint4*>(ws + r * SK + c8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(bn + r) * D + k0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* r0 = as + (wm * 32 + i * 16 + g) * SK + kk + 2 * tq;
        const bf16* r1 = r0 + 8 * SK;
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r1);
        af[i][2] = ld32(r0 + 8);
        af[i][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* wr = ws + (wn * 32 + j * 8 + g) * SK + kk + 2 * tq;
        uint32_t b0 = ld32(wr), b1 = ld32(wr + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = bn + wn * 32 + j * 8 + 2 * tq;
      const float bo0 = b_out[c], bo1 = b_out[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = bm + wm * 32 + i * 16 + g + 8 * half;
        if (r >= M) continue;
        float y0 = acc[i][j][2 * half] + bo0;
        float y1 = acc[i][j][2 * half + 1] + bo1;
        if constexpr (RES) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * D + c));
          y0 += xf.x;
          y1 += xf.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * D + c) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

template <int MT, bool LN>
cudaError_t launch_heads(const bf16* x, const float* bias, const float* ln_w,
                         const float* ln_b, const bf16* w_qkv,
                         const float* b_qkv, bf16* attn, int N, int L, int D,
                         int H, float eps, float scale, cudaStream_t s) {
  constexpr int LP = 16 * MT;
  size_t h_bytes = (size_t)LP * (D + 8) * sizeof(bf16);
  size_t qkvp_bytes = ((size_t)2 * LP * QS + (size_t)(HD + LP) * (LP + 8)) *
                          sizeof(bf16) +
                      (size_t)LP * (LP + 4) * sizeof(float);
  size_t smem = h_bytes > qkvp_bytes ? h_bytes : qkvp_bytes;
  auto kern = attn_heads_kernel<MT, LN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N, H), A_WARPS * 32, smem, s>>>(x, bias, ln_w, ln_b, w_qkv,
                                              b_qkv, attn, L, D, eps, scale);
  return cudaGetLastError();
}

// LN: y = x + W_o · MHA(LN(x)) + b_o (K1); !LN: y = W_o · MHA(x) + b_o (K10)
template <bool LN>
int sublayer_fwd(const void* x, const float* bias, const float* ln_w,
                 const float* ln_b, const void* w_qkv, const float* b_qkv,
                 const void* w_out, const float* b_out, void* attn, void* y,
                 int N, int L, int D, int H, float eps, float scale,
                 void* stream) {
  if (N < 1 || L < 1 || L > 64 || D != HD * H || D % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  bf16* ab = static_cast<bf16*>(attn);
  cudaError_t err;
  switch ((L + 15) / 16) {
    case 1: err = launch_heads<1, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, ab, N, L, D, H, eps, scale, s); break;
    case 2: err = launch_heads<2, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, ab, N, L, D, H, eps, scale, s); break;
    case 3: err = launch_heads<3, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, ab, N, L, D, H, eps, scale, s); break;
    default: err = launch_heads<4, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, ab, N, L, D, H, eps, scale, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int M = N * L;
  dim3 grid((M + BM - 1) / BM, D / BN);
  out_proj_kernel<LN><<<grid, 128, 0, s>>>(
      ab, static_cast<const bf16*>(w_out), b_out, xb, static_cast<bf16*>(y), M,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y, attn (scratch) [N, L, D] bf16; bias [N, L, L] fp32 or null;
// ln_w, ln_b [D], b_qkv [3D], b_out [D] fp32; w_qkv [3D, D], w_out [D, D]
// bf16; all contiguous.  Requires D == 64 * H, D % 64 == 0, 1 <= L <= 64.
extern "C" int ln_attention_residual_fwd(
    const void* x, const float* bias, const float* ln_w, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_out,
    const float* b_out, void* attn, void* y, int N, int L, int D, int H,
    float eps, float scale, void* stream) {
  return sublayer_fwd<true>(x, bias, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                            attn, y, N, L, D, H, eps, scale, stream);
}

// K10: the same without LayerNorm and residual, on a pre-normalised h
// [N, L, D] bf16 (neighborretr_tpu/ops/pallas_block_attention.py::
// _block_attention_core and _block_attention_biased_core); shapes and
// requirements as above, without the LN parameters.
extern "C" int attention_sublayer_fwd(
    const void* h, const float* bias, const void* w_qkv, const float* b_qkv,
    const void* w_out, const float* b_out, void* attn, void* y, int N, int L,
    int D, int H, float scale, void* stream) {
  return sublayer_fwd<false>(h, bias, nullptr, nullptr, w_qkv, b_qkv, w_out,
                             b_out, attn, y, N, L, D, H, 0.f, scale, stream);
}
