// Fused pre-LN attention sublayer, backward of
//   y = x + W_o · MHA(LN(x) · W_qkv + b_qkv) + b_o.
//
// Replaces the TPU kernel neighborretr_tpu/ops/pallas_block_attention.py::
// _make_bwd_ln_kernel, launched by _ln_bwd_call (the custom VJP of
// fused_ln_attention_residual), without and with the per-sequence bias.
// With the template flag LN off (entry attention_sublayer_bwd: K11) the
// same kernels compute the backward of y = W_o · MHA(h · W_qkv + b_qkv) + b_o
// on a pre-normalised h, replacing the same file's _bwd_kernel and
// _bwd_kernel_biased (_block_attention_bwd, _block_attention_biased_bwd):
// h is loaded as it is, and step 4 writes dh (bf16) with no LN backward.
// Like the TPU kernel it saves nothing from the forward: LN, qkv and the
// probabilities are recomputed from x.  Outputs: dx (bf16) and, in fp32,
// dLN scale/bias, dW_qkv [3D, D], db_qkv, dW_o [D, D], db_o, each summed
// over all N·L rows.  The bias gets no gradient.
//
// Rounding points follow the TPU kernel one for one, so the plain PyTorch
// backward (ops/block_attention.py) can hold this one to a bf16-ulp bound:
//   h, qkv, scaled q, probs as in the forward; g (= dy) is bf16;
//   dattn = g · W_o rounded to bf16; dv = probs16^T · dattn,
//   dprobs = dattn · v^T, dlogits = probs32 · (dprobs - sum_k dprobs·probs32)
//   in fp32, (dlogits · hd^-0.5) rounded to bf16 for dq and dk (dk against
//   the unscaled bf16 q); dqkv rounded to bf16 for dh and dW_qkv but summed
//   in fp32 for db_qkv; dLN and dx from the fp32 dh; db_o from g in fp32.
//
// Design: a TPU grid step holds a few hundred rows and all the weights in
// VMEM and adds its weight gradients into a block it revisits.  A Hopper
// block cannot, so the work is cut the way the forward is:
//   1. gemm_nt:  dattn[M, D] = g · W_o                      (bf16 out)
//   2. attn_bwd_heads_kernel, one block per (sequence, head): recomputes
//      LN, the head's q/k/v and probs as the forward does, then the five
//      small products of the attention backward as mma.sync tiles; every
//      operand sits in shared memory in the orientation its product reads
//      ("col" operands k-contiguous), stored twice where two products read
//      it differently.  Writes the head's dqkv (bf16) row-major [M, 3D] for
//      dh and transposed [3D, Mp] for dW_qkv, the recomputed h and attn_out
//      transposed [D, Mp], and the head's fp32 column sums of dqkv as one
//      row of partials [N, 3D].
//   3. gemm_nt:  dh[M, D] = dqkv16 · W_qkv                  (fp32 out)
//   4. ln_bwd_rows_kernel, a warp per row: LN backward + residual -> dx,
//      g transposed [D, Mp], and per-block partials of dLN scale/bias and
//      db_o.
//   5. gemm_nt over the transposed operands:  dW_qkv = dqkv16^T · h16 and
//      dW_o = g16^T · attn_out16.  One block owns a 128x128 output tile
//      over one of a few ranges of the M rows; the ranges' copies are added
//      in order.
//   6. reduce_rows over the partials of 2, 4 and 5, in block order.
// No float atomics anywhere: two runs give the same bits.  Mp is M rounded
// up to 64; columns M..Mp of the transposed buffers are zeroed by the
// caller, and rows past L of every tile are zero before a product
// contracts over them.
//
// What bounds it on an H100: the four M-row products are 8·M·D^2 FLOP
// each way (0.72 TFLOP per vision layer at M = 76,800, D = 768), so the
// tensor cores bound it.  gemm_nt is an mma.sync loop over 128x128 tiles
// with ldmatrix fragment loads, whose next k-tile is fetched into registers
// during the products; the transposed copies and dh cost extra device
// memory traffic.  Left open: a cp.async/TMA pipeline with wgmma,
// ldmatrix.trans instead of transposed copies, and LN backward in the dh
// epilogue.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int B_WARPS = 8;
constexpr int NT_PER_WARP = 3;   // 3 * HD / 8 = 24 n-tiles over 8 warps
constexpr int QS = HD + 8;       // row stride of the [rows][HD] tiles (bf16)

// ---------------------------------------------------------------------------
// C[r][c] = sum_k A[r][k] · W[c][k]
// A [R, K] with leading dimension lda, W [C, K] with ldw; rows past R and
// columns past C read as zero and are not stored.  C even; K a multiple of
// 32; lda and ldw multiples of 8 (16-byte loads).  A block of WM x WN warps
// owns a (WM·16·MT) x (WN·8·NT) tile; fragments come out of shared memory
// through ldmatrix (one x4 per 16x16 of A, one per two 8-column tiles of
// W), and the next k-tile travels from device memory into registers while
// this one is multiplied.
// ---------------------------------------------------------------------------
constexpr int BK = 32, SK = BK + 8;   // 80-byte rows: ldmatrix conflict-free

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <typename OutT, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
gemm_nt_kernel(const bf16* __restrict__ a, int lda, const bf16* __restrict__ w,
               int ldw, OutT* __restrict__ c, int ldc, int R, int C, int K,
               int Kc) {
  constexpr int TM = WM * 16 * MT, TN = WN * 8 * NT, THREADS = 32 * WM * WN;
  constexpr int LA = TM * 4 / THREADS, LW = TN * 4 / THREADS;
  static_assert(NT % 2 == 0 && TM * 4 % THREADS == 0 && TN * 4 % THREADS == 0,
                "tile shape");
  __shared__ __align__(16) bf16 as[TM * SK];
  __shared__ __align__(16) bf16 ws[TN * SK];
  const int bm = blockIdx.x * TM, bn = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm0 = (warp / WN) * 16 * MT, wn0 = (warp % WN) * 8 * NT;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra[LA], rw[LW];
  auto gload = [&](int k0) {
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / 4, c8 = (idx % 4) * 8;
      ra[it] = make_uint4(0u, 0u, 0u, 0u);
      if (bm + r < R)
        ra[it] = *reinterpret_cast<const uint4*>(a + (size_t)(bm + r) * lda +
                                                 k0 + c8);
    }
#pragma unroll
    for (int it = 0; it < LW; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / 4, c8 = (idx % 4) * 8;
      rw[it] = make_uint4(0u, 0u, 0u, 0u);
      if (bn + r < C)
        rw[it] = *reinterpret_cast<const uint4*>(w + (size_t)(bn + r) * ldw +
                                                 k0 + c8);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      *reinterpret_cast<uint4*>(as + (idx / 4) * SK + (idx % 4) * 8) = ra[it];
    }
#pragma unroll
    for (int it = 0; it < LW; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      *reinterpret_cast<uint4*>(ws + (idx / 4) * SK + (idx % 4) * 8) = rw[it];
    }
  };
  // ldmatrix row addresses of this lane: A 16x16 = rows lane%16, k-half
  // lane/16; W two 8-column tiles = rows lane%8 + 8·(lane/16), k-half
  // (lane/8)%2
  const bf16* a_lane = as + (wm0 + lane % 16) * SK + (lane / 16) * 8;
  const bf16* w_lane =
      ws + (wn0 + lane % 8 + (lane / 16) * 8) * SK + ((lane / 8) % 2) * 8;

  // blockIdx.z owns the k-range [z·Kc, z·Kc + Kc) and its own copy of C
  const int k_lo = blockIdx.z * Kc, k_hi = min(K, k_lo + Kc);
  c += (size_t)blockIdx.z * R * ldc;
  gload(k_lo);
  sstore();
  __syncthreads();
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const bool more = k0 + BK < k_hi;
    if (more) gload(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(af[i], a_lane + i * 16 * SK + kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4(bfr[j], w_lane + j * 16 * SK + kk);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                   bfr[j / 2][2 * (j % 2)], bfr[j / 2][2 * (j % 2) + 1]);
    }
    __syncthreads();
    if (more) {
      sstore();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = bn + wn0 + j * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = bm + wm0 + i * 16 + g + 8 * half;
        if (r < R && col < C)
          store2(c + (size_t)r * ldc + col, acc[i][j][2 * half],
                 acc[i][j][2 * half + 1]);
      }
    }
}

// many rows (the activations' products): 128x128 tiles, 8 warps of 64x32
template <typename OutT>
cudaError_t gemm_nt_rows(const bf16* a, int lda, const bf16* w, int ldw,
                         OutT* c, int ldc, int R, int C, int K,
                         cudaStream_t s) {
  dim3 grid((R + 127) / 128, (C + 127) / 128);
  gemm_nt_kernel<OutT, 4, 4, 2, 4><<<grid, 256, 0, s>>>(a, lda, w, ldw, c, ldc,
                                                       R, C, K, K);
  return cudaGetLastError();
}

// few rows, long K (the weight gradients, C == ldc): the same 128x128
// tiles, K cut into up to DEEP_SPLITS ranges so that a [3D, D] output still
// gives every SM a block; each range writes its own copy of C into `part`
// and reduce_rows adds the copies in range order (no atomics)
constexpr int DEEP_SPLITS = 8;

inline cudaError_t gemm_nt_deep(const bf16* a, int lda, const bf16* w, int ldw,
                                float* c, float* part, int R, int C, int K,
                                cudaStream_t s) {
  dim3 grid((R + 127) / 128, (C + 127) / 128);
  int splits = (2 * 132 + (int)(grid.x * grid.y) - 1) / (int)(grid.x * grid.y);
  if (splits > DEEP_SPLITS) splits = DEEP_SPLITS;
  const int Kc = ((K / BK + splits - 1) / splits) * BK;
  splits = (K + Kc - 1) / Kc;
  grid.z = splits;
  gemm_nt_kernel<float, 4, 4, 2, 4><<<grid, 256, 0, s>>>(
      a, lda, w, ldw, splits > 1 ? part : c, C, R, C, K, Kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_rows(part, c, splits, R * C, 1.f, s);
}

// ---------------------------------------------------------------------------
// per (sequence, head): recompute the forward, then the attention backward
// ---------------------------------------------------------------------------

// out[LP x LP] (fp32, stride PS) = A[LP x HD] · B[LP x HD]^T, both tiles
// row-major with stride QS; 16x8 output tiles spread over the warps
template <int MT>
__device__ __forceinline__ void mm_square(const bf16* A, const bf16* B,
                                          float* out, int PS, int warp, int g,
                                          int tq) {
  for (int t = warp; t < MT * 2 * MT; t += B_WARPS) {
    const int m = t / (2 * MT), nt = t % (2 * MT);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      const bf16* r0 = A + (m * 16 + g) * QS + k0 + 2 * tq;
      const bf16* r1 = r0 + 8 * QS;
      const bf16* kb = B + (nt * 8 + g) * QS + k0 + 2 * tq;
      mma16816(c, ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8), ld32(kb),
               ld32(kb + 8));
    }
    float* p0 = out + (m * 16 + g) * PS + nt * 8 + 2 * tq;
    p0[0] = c[0];
    p0[1] = c[1];
    p0[8 * PS] = c[2];
    p0[8 * PS + 1] = c[3];
  }
}

// c[m] = rows 16m.. of  A[LP x LP] · Bt[HD x LP]^T  restricted to the
// warp's 8 output columns; A and Bt row-major with stride KS = LP + 8
template <int MT>
__device__ __forceinline__ void mm_to_head(const bf16* A, const bf16* Bt,
                                           int warp, int g, int tq,
                                           float (&c)[MT][4]) {
  constexpr int LP = 16 * MT, KS = LP + 8;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[m][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < LP; k0 += 16) {
    const bf16* vb = Bt + (warp * 8 + g) * KS + k0 + 2 * tq;
    const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* r0 = A + (m * 16 + g) * KS + k0 + 2 * tq;
      const bf16* r1 = r0 + 8 * KS;
      mma16816(c[m], ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8), b0, b1);
    }
  }
}

// the head's [L x 8·warps] slice of dq, dk or dv: bf16 into dqkv (row-major)
// and dqkv_t (transposed), fp32 column sums into this sequence's partials
template <int MT>
__device__ __forceinline__ void store_dqkv(const float (&c)[MT][4], int col0,
                                           int n, int L, int D, int Mp,
                                           bf16* dqkv, bf16* dqkv_t,
                                           float* part_db, int warp, int g,
                                           int tq, int lane) {
  const int col = col0 + warp * 8 + 2 * tq;   // column within [0, 3D)
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + g + 8 * half;
      const float v0 = c[m][2 * half], v1 = c[m][2 * half + 1];
      s0 += v0;   // rows past L are exact zeros
      s1 += v1;
      if (r < L) {
        const size_t row = (size_t)n * L + r;
        store2(dqkv + row * 3 * D + col, v0, v1);
        dqkv_t[(size_t)col * Mp + row] = __float2bfloat16(v0);
        dqkv_t[(size_t)(col + 1) * Mp + row] = __float2bfloat16(v1);
      }
    }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (lane < 4) {
    part_db[(size_t)n * 3 * D + col] = s0;
    part_db[(size_t)n * 3 * D + col + 1] = s1;
  }
}

template <int MT, bool LN>
__global__ void __launch_bounds__(B_WARPS * 32)
attn_bwd_heads_kernel(const bf16* __restrict__ x, const float* __restrict__ bias,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b,
                      const bf16* __restrict__ w_qkv,
                      const float* __restrict__ b_qkv,
                      const bf16* __restrict__ dattn, bf16* __restrict__ h_t,
                      bf16* __restrict__ attn_t, bf16* __restrict__ dqkv,
                      bf16* __restrict__ dqkv_t, float* __restrict__ part_db,
                      int L, int D, int Mp, float eps, float scale) {
  constexpr int LP = 16 * MT;
  constexpr int KS = LP + 8;   // row stride of the [..][LP] tiles (bf16)
  constexpr int PS = LP + 4;   // row stride of the fp32 tiles
  static_assert(KS <= QS, "the softmax pass's tiles reuse the q/k/v tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HS = D + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);   // [LP][D + 8], LN output
  // everything below reuses the h tile once the q/k/v products are done
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [LP][QS] q · hd^-0.5
  bf16* ks = qs + LP * QS;                        // [LP][QS] k
  bf16* vs = ks + LP * QS;                        // [LP][QS] v
  bf16* gs = vs + LP * QS;                        // [LP][QS] dattn slice
  bf16* qut = gs + LP * QS;                       // [HD][KS] q^T, unscaled
  bf16* kt = qut + HD * KS;                       // [HD][KS] k^T
  bf16* vt = kt + HD * KS;                        // [HD][KS] v^T
  bf16* gt = vt + HD * KS;                        // [HD][KS] dattn slice^T
  float* ps = reinterpret_cast<float*>(gt + HD * KS);     // [LP][PS] probs
  float* dp = ps + LP * PS;                               // [LP][PS] dprobs
  // written by the softmax pass, when q, k, v and the dattn slice have been
  // multiplied and are dead (KS <= QS): two blocks fit an SM this way
  bf16* dl = qs;                                  // [LP][KS] dlogits·scale
  bf16* dlt = ks;                                 // [LP][KS] its transpose
  bf16* pb = vs;                                  // [LP][KS] probs
  bf16* pbt = gs;                                 // [LP][KS] probs^T

  const int n = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  // ---- LayerNorm (fp32 island) or h as it is -> bf16 rows in shared memory
  load_rows<LN>(x + (size_t)n * L * D, hs, HS, L, LP, D, ln_w, ln_b, eps, warp,
                B_WARPS, lane);
  __syncthreads();

  // this head's 64 columns of h, transposed, for dW_qkv
  for (int i = threadIdx.x; i < HD * L; i += B_WARPS * 32) {
    const int c = i / L, r = i % L;
    h_t[(size_t)(h * HD + c) * Mp + (size_t)n * L + r] = hs[r * HS + h * HD + c];
  }

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
    int c = (warp * NT_PER_WARP + j) * 8 + g;
    int part = c / HD, within = c % HD;
    wrow[j] = w_qkv + ((size_t)part * D + h * HD + within) * D;
  }
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t b[NT_PER_WARP][2];
#pragma unroll
    for (int j = 0; j < NT_PER_WARP; ++j) {
      b[j][0] = ldg32(wrow[j] + k0 + 2 * tq);
      b[j][1] = ldg32(wrow[j] + k0 + 2 * tq + 8);
    }
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
  }
  __syncthreads();  // every warp is done with hs: reuse it

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
        const float v0 = round_bf16(acc[m][j][2 * half] + bias0);
        const float v1 = round_bf16(acc[m][j][2 * half + 1] + bias1);
        const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
        if (part == 0) {          // q · hd^-0.5 in fp32, rounded again
          qs[r * QS + within] = __float2bfloat16(v0 * scale);
          qs[r * QS + within + 1] = __float2bfloat16(v1 * scale);
          qut[within * KS + r] = h0;
          qut[(within + 1) * KS + r] = h1;
        } else if (part == 1) {
          ks[r * QS + within] = h0;
          ks[r * QS + within + 1] = h1;
          kt[within * KS + r] = h0;
          kt[(within + 1) * KS + r] = h1;
        } else {
          vs[r * QS + within] = h0;
          vs[r * QS + within + 1] = h1;
          vt[within * KS + r] = h0;
          vt[(within + 1) * KS + r] = h1;
        }
      }
    }
  }
  // the head's slice of dattn, both ways; rows past L are zero
  for (int i = threadIdx.x; i < LP * HD; i += B_WARPS * 32) {
    const int r = i / HD, d = i % HD;
    bf16 v = __float2bfloat16(0.f);
    if (r < L) v = dattn[((size_t)n * L + r) * D + h * HD + d];
    gs[r * QS + d] = v;
    gt[d * KS + r] = v;
  }
  __syncthreads();

  // ---- logits = q · k^T, dprobs = dattn · v^T (fp32) ----
  mm_square<MT>(qs, ks, ps, PS, warp, g, tq);
  mm_square<MT>(gs, vs, dp, PS, warp, g, tq);
  __syncthreads();

  // ---- softmax (fp32, max subtracted) and its backward, one warp per row --
  const float* bn = bias ? bias + (size_t)n * L * L : nullptr;
  for (int i = warp; i < LP; i += B_WARPS) {
    float e[2], dpr[2];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      const bool ok = i < L && j < L;
      e[u] = ok ? ps[i * PS + j] + (bn ? bn[i * L + j] : 0.f) : -INFINITY;
      dpr[u] = ok ? dp[i * PS + j] : 0.f;
      mx = fmaxf(mx, e[u]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e[u] = (i < L && lane + 32 * u < L) ? expf(e[u] - mx) : 0.f;
      sum += e[u];
    }
    sum = warp_sum(sum);
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e[u] = i < L ? e[u] / sum : 0.f;      // fp32 probs
      dot += e[u] * dpr[u];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j >= LP) continue;
      const bf16 p16 = __float2bfloat16(e[u]);
      const bf16 d16 = __float2bfloat16(e[u] * (dpr[u] - dot) * scale);
      pb[i * KS + j] = p16;
      pbt[j * KS + i] = p16;
      dl[i * KS + j] = d16;
      dlt[j * KS + i] = d16;
    }
  }
  __syncthreads();

  // ---- the four [LP, HD] products; warp w owns head columns 8w..8w+7 ----
  float c[MT][4];
  // attn_out = probs · v, transposed to device memory for dW_o
  mm_to_head<MT>(pb, vt, warp, g, tq, c);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + g + 8 * half;
      if (r < L) {
        const size_t col = (size_t)h * HD + warp * 8 + 2 * tq;
        const size_t row = (size_t)n * L + r;
        attn_t[col * Mp + row] = __float2bfloat16(c[m][2 * half]);
        attn_t[(col + 1) * Mp + row] = __float2bfloat16(c[m][2 * half + 1]);
      }
    }
  // dq = dl · k
  mm_to_head<MT>(dl, kt, warp, g, tq, c);
  store_dqkv<MT>(c, h * HD, n, L, D, Mp, dqkv, dqkv_t, part_db, warp, g, tq,
                 lane);
  // dk = dl^T · q (unscaled)
  mm_to_head<MT>(dlt, qut, warp, g, tq, c);
  store_dqkv<MT>(c, D + h * HD, n, L, D, Mp, dqkv, dqkv_t, part_db, warp, g,
                 tq, lane);
  // dv = probs^T · dattn
  mm_to_head<MT>(pbt, gt, warp, g, tq, c);
  store_dqkv<MT>(c, 2 * D + h * HD, n, L, D, Mp, dqkv, dqkv_t, part_db, warp,
                 g, tq, lane);
}

template <int MT, bool LN>
cudaError_t launch_bwd_heads(const bf16* x, const float* bias,
                             const float* ln_w, const float* ln_b,
                             const bf16* w_qkv, const float* b_qkv,
                             const bf16* dattn, bf16* h_t, bf16* attn_t,
                             bf16* dqkv, bf16* dqkv_t, float* part_db, int N,
                             int L, int D, int H, int Mp, float eps,
                             float scale, cudaStream_t s) {
  constexpr int LP = 16 * MT;
  const size_t h_bytes = (size_t)LP * (D + 8) * sizeof(bf16);
  const size_t tiles =
      ((size_t)4 * LP * QS + (size_t)4 * HD * (LP + 8)) * sizeof(bf16) +
      (size_t)2 * LP * (LP + 4) * sizeof(float);
  const size_t smem = h_bytes > tiles ? h_bytes : tiles;
  auto kern = attn_bwd_heads_kernel<MT, LN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N, H), B_WARPS * 32, smem, s>>>(
      x, bias, ln_w, ln_b, w_qkv, b_qkv, dattn, h_t, attn_t, dqkv, dqkv_t,
      part_db, L, D, Mp, eps, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm backward + residual (LN), or dx = dh (!LN: K11), a warp per row;
// LN_ROWS rows per block
// ---------------------------------------------------------------------------
constexpr int LN_ROWS = 64;

template <bool LN>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const float* __restrict__ dh, const float* __restrict__ ln_w,
                   bf16* __restrict__ dx, bf16* __restrict__ g_t,
                   float* __restrict__ part, int M, int D, int Mp, float eps) {
  // per warp: running sums over its rows of dh·xhat, dh and g  [8][3][D]
  extern __shared__ __align__(16) float acc[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* a_gs = acc + (size_t)warp * 3 * D;
  float* a_gb = a_gs + D;
  float* a_bo = a_gb + D;
  for (int d = lane; d < 3 * D; d += 32) a_gs[d] = 0.f;
  __syncwarp();

  const int row0 = blockIdx.x * LN_ROWS;
  const int row1 = min(M, row0 + LN_ROWS);
  for (int row = row0 + warp; row < row1; row += 8) {
    const bf16* xr = x + (size_t)row * D;
    const bf16* gr = g + (size_t)row * D;
    const float* dr = dh + (size_t)row * D;
    if constexpr (!LN) {
      for (int d = lane; d < D; d += 32) {
        dx[(size_t)row * D + d] = __float2bfloat16(dr[d]);
        g_t[(size_t)d * Mp + row] = gr[d];
        a_bo[d] += __bfloat162float(gr[d]);
      }
    } else {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += __bfloat162float(xr[d]);
      const float mean = warp_sum(s) / D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float c = __bfloat162float(xr[d]) - mean;
        ss += c * c;
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
      float sa = 0.f, sb = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float xh = (__bfloat162float(xr[d]) - mean) * rstd;
        const float gd = dr[d] * ln_w[d];
        sa += gd;
        sb += gd * xh;
      }
      const float m1 = warp_sum(sa) / D, m2 = warp_sum(sb) / D;
      for (int d = lane; d < D; d += 32) {
        const float xh = (__bfloat162float(xr[d]) - mean) * rstd;
        const float dhv = dr[d];
        const float gv = __bfloat162float(gr[d]);
        const float gd = dhv * ln_w[d];
        dx[(size_t)row * D + d] =
            __float2bfloat16(gv + rstd * (gd - m1 - xh * m2));
        g_t[(size_t)d * Mp + row] = gr[d];
        a_gs[d] += dhv * xh;
        a_gb[d] += dhv;
        a_bo[d] += gv;
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 3 * D; d += 256) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += acc[(size_t)w * 3 * D + d];
    part[(size_t)blockIdx.x * 3 * D + d] = s;
  }
}

// LN: the backward of y = x + W_o · MHA(LN(x)) + b_o (K3); !LN: of
// y = W_o · MHA(x) + b_o (K11), where dx = dh and dLN stays zero
template <bool LN>
int sublayer_bwd(const void* x, const float* bias, const float* ln_w,
                 const float* ln_b, const void* w_qkv, const float* b_qkv,
                 const void* w_qkv_t, const void* w_out_t, const void* g,
                 void* dattn, void* tbuf, void* dqkv, float* dh,
                 float* part_db, float* part_ln, float* part_w, void* dx,
                 float* dln, float* dw_qkv, float* db_qkv, float* dw_out,
                 int N, int L, int D, int H, int Mp, float eps, float scale,
                 void* stream) {
  const int M = N * L;
  if (N < 1 || L < 1 || L > 64 || D != HD * H || Mp % 64 != 0 || Mp < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  bf16* da = static_cast<bf16*>(dattn);
  bf16* dq = static_cast<bf16*>(dqkv);
  bf16* dqkv_t = static_cast<bf16*>(tbuf);
  bf16* h_t = dqkv_t + (size_t)3 * D * Mp;
  bf16* attn_t = h_t + (size_t)D * Mp;
  bf16* g_t = attn_t + (size_t)D * Mp;
  cudaError_t err;

  // 1. dattn = g · W_o
  err = gemm_nt_rows<bf16>(gb, D, static_cast<const bf16*>(w_out_t), D, da, D,
                           M, D, D, s);
  if (err != cudaSuccess) return (int)err;
  // 2. per (sequence, head): recompute + attention backward
  switch ((L + 15) / 16) {
    case 1: err = launch_bwd_heads<1, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, da, h_t, attn_t, dq, dqkv_t, part_db, N, L, D, H, Mp, eps, scale, s); break;
    case 2: err = launch_bwd_heads<2, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, da, h_t, attn_t, dq, dqkv_t, part_db, N, L, D, H, Mp, eps, scale, s); break;
    case 3: err = launch_bwd_heads<3, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, da, h_t, attn_t, dq, dqkv_t, part_db, N, L, D, H, Mp, eps, scale, s); break;
    default: err = launch_bwd_heads<4, LN>(xb, bias, ln_w, ln_b, wq, b_qkv, da, h_t, attn_t, dq, dqkv_t, part_db, N, L, D, H, Mp, eps, scale, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  // 3. dh = dqkv16 · W_qkv
  err = gemm_nt_rows<float>(dq, 3 * D, static_cast<const bf16*>(w_qkv_t),
                            3 * D, dh, D, M, D, 3 * D, s);
  if (err != cudaSuccess) return (int)err;
  // 4. LN backward + residual (or dx = dh), g^T, partials of dLN and db_o
  const int nblk = (M + LN_ROWS - 1) / LN_ROWS;
  const size_t ln_smem = (size_t)8 * 3 * D * sizeof(float);
  err = cudaFuncSetAttribute(ln_bwd_rows_kernel<LN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ln_smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_rows_kernel<LN><<<nblk, 256, ln_smem, s>>>(
      xb, gb, dh, ln_w, static_cast<bf16*>(dx), g_t, part_ln, M, D, Mp, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 5. dW_qkv = dqkv16^T · h16, dW_o = g16^T · attn_out16
  err = gemm_nt_deep(dqkv_t, Mp, h_t, Mp, dw_qkv, part_w, 3 * D, D, Mp, s);
  if (err != cudaSuccess) return (int)err;
  err = gemm_nt_deep(g_t, Mp, attn_t, Mp, dw_out, part_w, D, D, Mp, s);
  if (err != cudaSuccess) return (int)err;
  // 6. ordered sums of the partials
  err = reduce_rows(part_db, db_qkv, N, 3 * D, 1.f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(part_ln, dln, nblk, 3 * D, 1.f, s);
}

}  // namespace

// Shapes (all contiguous; M = N·L, Mp = M rounded up to 64):
//   in:  x, g [N, L, D] bf16; bias [N, L, L] fp32 or null; ln_w, ln_b [D],
//        b_qkv [3D] fp32; w_qkv [3D, D], w_qkv_t [D, 3D], w_out_t [D, D]
//        bf16 (the transposes are plain copies made by the caller);
//   scratch: dattn [M, D] bf16; tbuf [6D, Mp] bf16 with columns M..Mp zero
//        (rows: dqkv^T 3D, h^T D, attn_out^T D, g^T D); dqkv [M, 3D] bf16;
//        dh [M, D] fp32; part_db [N, 3D] fp32; part_ln [ceil(M/64), 3D] fp32;
//        part_w [8, 3D, D] fp32 (the weight gradients' k-range copies);
//   out: dx [N, L, D] bf16; dln [3, D] fp32 (dLN scale, dLN bias, db_o);
//        dw_qkv [3D, D], db_qkv [3D], dw_out [D, D] fp32.
// Requires D == 64 * H, 1 <= L <= 64.
extern "C" int ln_attention_residual_bwd(
    const void* x, const float* bias, const float* ln_w, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_qkv_t,
    const void* w_out_t, const void* g, void* dattn, void* tbuf, void* dqkv,
    float* dh, float* part_db, float* part_ln, float* part_w, void* dx,
    float* dln,
    float* dw_qkv, float* db_qkv, float* dw_out, int N, int L, int D, int H,
    int Mp, float eps, float scale, void* stream) {
  return sublayer_bwd<true>(x, bias, ln_w, ln_b, w_qkv, b_qkv, w_qkv_t,
                            w_out_t, g, dattn, tbuf, dqkv, dh, part_db,
                            part_ln, part_w, dx, dln, dw_qkv, db_qkv, dw_out,
                            N, L, D, H, Mp, eps, scale, stream);
}

// K11: the backward of attention_sublayer_fwd (neighborretr_tpu/ops/
// pallas_block_attention.py::_block_attention_bwd and
// _block_attention_biased_bwd): h in place of x, dh in place of dx, rows 0
// and 1 of dln zero; shapes and requirements as above.
extern "C" int attention_sublayer_bwd(
    const void* h, const float* bias, const void* w_qkv, const float* b_qkv,
    const void* w_qkv_t, const void* w_out_t, const void* g, void* dattn,
    void* tbuf, void* dqkv, float* dh32, float* part_db, float* part_ln,
    float* part_w, void* dh, float* dln, float* dw_qkv, float* db_qkv,
    float* dw_out, int N, int L, int D, int H, int Mp, float scale,
    void* stream) {
  return sublayer_bwd<false>(h, bias, nullptr, nullptr, w_qkv, b_qkv, w_qkv_t,
                             w_out_t, g, dattn, tbuf, dqkv, dh32, part_db,
                             part_ln, part_w, dh, dln, dw_qkv, db_qkv, dw_out,
                             N, L, D, H, Mp, 0.f, scale, stream);
}
