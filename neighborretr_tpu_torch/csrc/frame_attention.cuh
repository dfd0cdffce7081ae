// K8/K9's kernels: multi-head self-attention on packed qkv [N, L, 3D],
// forward and backward (what they compute, and their rounding points:
// frame_attention.cu).  A header so that the attention sublayer's sources
// (ln_attention_residual*.cu) run the same device code as their core.
//
// What bounds it on an H100: operations, 4·N·L^2·D forward and 10·N·L^2·D
// backward (S recomputed once) on the bf16 tensor cores; the bytes are the
// packed buffer, the bias and the cotangent once in and the outputs once
// out, 3-4x below that at L = 197 and 577.
//
// Design.  Every kernel is a block of consumer warpgroups (64 rows each) and
// one producer warp: the forward takes two warpgroups past L = 64 (two
// blocks per SM) and one at L <= 64, both backward kernels one (two blocks
// per SM).  The producer fills the block's own tile once and streams the
// other side's 64-row tiles through a ring of shared-memory stages with TMA
// (a 3-D tensor map over [N, L, C] bf16, boxes of 64 rows x 64 columns = 128
// B rows in the 128-byte swizzle; rows past L are zero-filled by the
// hardware, never read from the next sequence), completed on mbarriers;
// consumers release a stage on an "empty" mbarrier when their products have
// read it.  Every product is a wgmma m64n64k16 (bf16 in, fp32 accumulated in
// registers), both operands in shared memory or A in registers
// (probabilities and dlogits straight from the accumulators, repacked as
// bf16); an operand whose contraction runs down its rows (V in P·V, K in
// dS·K, Q and g in the dK/dV products) is read through the transposed-B form
// of the instruction, never copied.  Each kernel walks the other side once:
//   forward (K8): a block owns a query tile and walks the key tiles with an
//     online softmax (running fp32 max and sum per row, the accumulator
//     rescaled when the max moves), then writes out and lse;
//   backward (K9): kernel dq owns a query tile and walks the key tiles: S,
//     P, dP = g · V^T, dS = P ∘ (dP - delta), dQ += dS16 · K; it writes each
//     row's P = ex2(x - ls) · sc and delta for kernel dkv to a small fp32
//     scratch [N, H, 3, L].  Kernel dkv owns a key tile and walks the query
//     tiles in ascending order: S^T = K · Q^T, P^T, dV += P16^T · g, dP^T =
//     V · g^T, dK += dS16^T · Q.  14·N·L^2·D in all (S and dP in both).  No
//     float atomics: every sum is taken inside one block in a fixed order,
//     so two runs give the same bits.
// Not done yet: overlapping one warpgroup's softmax with the other's
// products (FlashAttention-3's ping-pong), a persistent grid, key tiles
// narrower than 64 at L <= 64 (L = 50 computes 64 x 64 tiles).

#pragma once

#include "hopper.cuh"

namespace {

constexpr int HD = 64;                    // head dim: every CLIP tower here
constexpr int TILE = 64;                  // rows of a box and of a warpgroup
constexpr int TILE_BYTES = TILE * HD * 2; // 8 KB: 64 rows of 128 B
constexpr float SCALE = 0.125f;           // HD^-0.5
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float SL2 = SCALE * LOG2E;      // logits in log2 units
constexpr int FWD_STAGES = 3;
constexpr int BWD_STAGES = 2;
constexpr int STAT_BYTES = 1024;          // a dkv stage's ls, sc, delta rows

// d = A · B^T over the 64-wide head dim, A and B K-major tiles
__device__ __forceinline__ void mma_abt(float (&d)[32], uint64_t da,
                                        uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss<0>(d, da + 2 * kk, db + 2 * kk, kk);
}

// d += A · B for A in registers (4 k-steps of 16 rows of B) and B an
// MN-major tile of 64 rows
__device__ __forceinline__ void mma_ab(float (&d)[32],
                                       const uint32_t (&a)[4][4],
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, a[kk], db + 128 * kk, 1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// fp32 accumulator [64 x 64] -> bf16 A fragments of the next product (the
// accumulator's 8-column chunks 2kk, 2kk+1 are k-step kk)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Accumulator layout of m64n64: thread (warp w of the warpgroup, lane: g =
// lane / 4, t = lane % 4) holds d[4j + e] at row 16w + g + 8·(e >> 1),
// column 8j + 2t + (e & 1).

template <int NWG>
constexpr int threads() { return NWG * 128 + 32; }

// dst[c] = sum over this block's rows r < L of the [64·NWG x 64] accumulator
// tile c, in fp32 and in a fixed order: a warp's 16 rows by shuffles, then
// the warps in ascending order through `red` ([4·NWG][64] in shared memory),
// the consumer warpgroups meeting on named barrier 1.  Called by every
// consumer thread; `row` is the thread's two rows (the accumulator layout)
template <int NWG>
__device__ __forceinline__ void col_sums(const float (&c)[32],
                                         const int (&row)[2], int L,
                                         float* red, float* dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      s[2 * j + b] = (row[0] < L ? c[4 * j + b] : 0.f) +
                     (row[1] < L ? c[4 * j + 2 + b] : 0.f);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp * 64 + 8 * j + 2 * lane] = s[2 * j];
      red[warp * 64 + 8 * j + 2 * lane + 1] = s[2 * j + 1];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  if (threadIdx.x < 64) {
    float sum = 0.f;
    for (int w = 0; w < 4 * NWG; ++w) sum += red[w * 64 + threadIdx.x];
    dst[threadIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// forward: block = (query tile of 64·NWG rows, head, sequence)
// ---------------------------------------------------------------------------
template <int NWG, int MINB, bool BIAS>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
fwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
           const float* __restrict__ bias, bf16* __restrict__ out,
           float* __restrict__ lse, int L, int H) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * FWD_STAGES];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem + NWG * TILE_BYTES;        // stage s: K, then V
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + FWD_STAGES;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NWG * TILE;
  const int D = H * HD, nkt = (L + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], NWG * 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warp
    if (threadIdx.x == NWG * 128) {
      bar_arrive_tx(q_full, NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load3(smem + w * TILE_BYTES, &tm_qkv, q_full, h * HD,
                 q0 + w * TILE, n);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % FWD_STAGES;
        if (kt >= FWD_STAGES) bar_wait(&empty[s], (kt / FWD_STAGES - 1) & 1);
        uint8_t* st = ring + s * 2 * TILE_BYTES;
        bar_arrive_tx(&full[s], 2 * TILE_BYTES);
        tma_load3(st, &tm_qkv, &full[s], D + h * HD, kt * TILE, n);
        tma_load3(st + TILE_BYTES, &tm_qkv, &full[s], 2 * D + h * HD,
                 kt * TILE, n);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r_lo = q0 + wg * TILE + warp * 16 + g, r_hi = r_lo + 8;
  const float* b_row[2] = {nullptr, nullptr};
  if (BIAS) {
    if (r_lo < L) b_row[0] = bias + ((size_t)n * L + r_lo) * L;
    if (r_hi < L) b_row[1] = bias + ((size_t)n * L + r_hi) * L;
  }
  const uint64_t dq = desc(smem + wg * TILE_BYTES);
  constexpr float XS = BIAS ? 1.f : SL2;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t pa[4][4];

  bar_wait(q_full, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % FWD_STAGES;
    bar_wait(&full[st], (kt / FWD_STAGES) & 1);
    const uint8_t* ks = ring + st * 2 * TILE_BYTES;
    wg_fence();
    mma_abt(s, dq, desc(ks));
    wg_commit();
    wg_wait0();
    reg_fence(s);

    // x · XS is the logit in log2 units: x is the raw S without a bias (the
    // scale folds into the exponent's FFMA), the scaled S plus the bias with
    // one; keys past L (only in the last tile) are -inf
    const int k0 = kt * TILE;
    if (BIAS) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          float x = s[4 * j + e] * SL2;
          if (b_row[e >> 1] && col < L)
            x = fmaf(__ldg(b_row[e >> 1] + col), LOG2E, x);
          s[4 * j + e] = x;
        }
    }
    if (k0 + TILE > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= L) s[4 * j + e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mref[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      mref[i] = mx[i] == -INFINITY ? 0.f : mx[i] * XS;
      alpha[i] = ex2(m[i] * XS - mref[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(s[i] * XS - mref[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += p;
      s[i] = p;
      o[i] *= alpha[(i >> 1) & 1];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    if (nkt == 1) {
      // the whole row is in this one tile: normalise, then round, as the
      // TPU kernels do
      const float il0 = 1.f / quad_sum(l[0]), il1 = 1.f / quad_sum(l[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= ((i >> 1) & 1) ? il1 : il0;
    }
    to_a(pa, s);                    // the probabilities, bf16
    wg_fence();
    mma_ab(o, pa, desc(ks + TILE_BYTES));
    wg_commit();
    wg_wait0();
    reg_fence(o);
    bar_arrive(&empty[st]);
  }

  const int row[2] = {r_lo, r_hi};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    if (row[i] >= L) continue;
    const float il = nkt == 1 ? 1.f : 1.f / l[i];
    bf16* dst = out + ((size_t)n * L + row[i]) * D + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store2(dst + 8 * j, o[4 * j + 2 * i] * il, o[4 * j + 2 * i + 1] * il);
    if (t == 0)
      lse[((size_t)n * H + h) * L + row[i]] = m[i] * XS * LN2 + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: block = (query tile of 64·NWG rows, head, sequence); also
// each row's (ls, sc, delta) for the dK/dV kernel: P = ex2(x - ls) · sc
// ---------------------------------------------------------------------------
template <int NWG, int MINB, bool BIAS>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_qkv,
              const __grid_constant__ CUtensorMap tm_g,
              const float* __restrict__ bias, const bf16* __restrict__ gout,
              const bf16* __restrict__ out, const float* __restrict__ lse,
              float* __restrict__ stats, bf16* __restrict__ dqkv,
              float* __restrict__ part_db, int L, int H) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * BWD_STAGES];
  uint8_t* smem = align1024(smem_raw);            // q tiles, then g tiles
  uint8_t* ring = smem + 2 * NWG * TILE_BYTES;    // stage s: K, then V
  uint64_t* qg_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BWD_STAGES;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NWG * TILE;
  const int D = H * HD, nkt = (L + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    bar_init(qg_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], NWG * 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warp
    if (threadIdx.x == NWG * 128) {
      bar_arrive_tx(qg_full, 2 * NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w) {
        tma_load3(smem + w * TILE_BYTES, &tm_qkv, qg_full, h * HD,
                 q0 + w * TILE, n);
        tma_load3(smem + (NWG + w) * TILE_BYTES, &tm_g, qg_full, h * HD,
                 q0 + w * TILE, n);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % BWD_STAGES;
        if (kt >= BWD_STAGES) bar_wait(&empty[s], (kt / BWD_STAGES - 1) & 1);
        uint8_t* st = ring + s * 2 * TILE_BYTES;
        bar_arrive_tx(&full[s], 2 * TILE_BYTES);
        tma_load3(st, &tm_qkv, &full[s], D + h * HD, kt * TILE, n);
        tma_load3(st + TILE_BYTES, &tm_qkv, &full[s], 2 * D + h * HD,
                 kt * TILE, n);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row[2] = {q0 + wg * TILE + warp * 16 + g,
                      q0 + wg * TILE + warp * 16 + g + 8};
  const float* b_row[2] = {nullptr, nullptr};
  // P = ex2(x - ls) · sc with x the logit in log2 units; dl = delta
  float dl[2] = {0.f, 0.f}, ls[2] = {0.f, 0.f}, sc[2] = {1.f, 1.f};
  float* st_row = stats + ((size_t)n * H + h) * 3 * L;   // ls, sc, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // past one key tile: ls = the saved lse, delta = rowsum(g ∘ out), a
    // quad's four threads taking 16 columns each
    float acc = 0.f;
    if (row[i] < L) {
      if (nkt > 1) {
        const size_t off = ((size_t)n * L + row[i]) * D + h * HD + 16 * t;
#pragma unroll
        for (int c = 0; c < 16; c += 8) {
          const uint4 gv =
              __ldg(reinterpret_cast<const uint4*>(gout + off + c));
          const uint4 ov =
              __ldg(reinterpret_cast<const uint4*>(out + off + c));
          const __nv_bfloat162* gp =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
          const __nv_bfloat162* op =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(gp[e]);
            const float2 b = __bfloat1622float2(op[e]);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
          }
        }
        ls[i] = lse[((size_t)n * H + h) * L + row[i]] * LOG2E;
      }
      if (BIAS) b_row[i] = bias + ((size_t)n * L + row[i]) * L;
    }
    if (nkt > 1) {
      dl[i] = quad_sum(acc);
      if (t == 0 && row[i] < L) {
        st_row[row[i]] = ls[i];
        st_row[L + row[i]] = 1.f;
        st_row[2 * L + row[i]] = dl[i];
      }
    }
  }
  const uint64_t dqs = desc(smem + wg * TILE_BYTES);
  const uint64_t dgs = desc(smem + (NWG + wg) * TILE_BYTES);
  float s[32], dp[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t da[4][4];

  bar_wait(qg_full, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % BWD_STAGES;
    bar_wait(&full[st], (kt / BWD_STAGES) & 1);
    const uint8_t* ks = ring + st * 2 * TILE_BYTES;
    const uint64_t dk = desc(ks);
    wg_fence();
    mma_abt(s, dqs, dk);                        // S = Q · K^T
    mma_abt(dp, dgs, desc(ks + TILE_BYTES));    // dP = g · V^T
    wg_commit();
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);
    // keys past L are only in the last tile: their P is 0.  A row past L
    // has q = g = 0, so its dS is 0
    const int k0 = kt * TILE;
    const bool edge = k0 + TILE > L;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[4 * j + e] * SL2;
        if (BIAS && b_row[e >> 1] && col < L)
          x = fmaf(__ldg(b_row[e >> 1] + col), LOG2E, x);
        s[4 * j + e] = (edge && col >= L) ? -INFINITY : x;
      }
    if (nkt == 1) {
      // the whole row is in this one tile: its own max and sum, as in the
      // forward, and delta = sum_k P·dP, as the TPU kernels take it
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int i = 0; i < 2; ++i) ls[i] = quad_max(mx[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sum[(i >> 1) & 1] += ex2(s[i] - ls[(i >> 1) & 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) sc[i] = 1.f / quad_sum(sum[i]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = ex2(s[i] - ls[(i >> 1) & 1]) * sc[(i >> 1) & 1];
    if (nkt == 1) {
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[(i >> 1) & 1] = fmaf(s[i], dp[i], acc[(i >> 1) & 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dl[i] = quad_sum(acc[i]);
        if (t == 0 && row[i] < L) {
          st_row[row[i]] = ls[i];
          st_row[L + row[i]] = sc[i];
          st_row[2 * L + row[i]] = dl[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * SCALE;
    to_a(da, s);
    wg_fence();
    mma_ab(dq, da, dk);                         // dQ += dS16 · K
    wg_commit();
    wg_wait0();
    reg_fence(dq);
    bar_arrive(&empty[st]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    bf16* dst = dqkv + ((size_t)n * L + row[i]) * 3 * D + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store2(dst + 8 * j, dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
  }
  if (part_db) {          // the sublayer's db_qkv sums dq before rounding
    __shared__ float red[4 * NWG * 64];
    col_sums<NWG>(dq, row, L, red,
                  part_db + ((size_t)n * gridDim.x + blockIdx.x) * 3 * D +
                      h * HD);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: block = (key tile of 64·NWG rows, head, sequence);
// query tiles in ascending order, the sums over them in registers
// ---------------------------------------------------------------------------
template <int NWG, int MINB, bool BIAS>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_qkv,
               const __grid_constant__ CUtensorMap tm_g,
               const float* __restrict__ bias,
               const float* __restrict__ stats, bf16* __restrict__ dqkv,
               float* __restrict__ part_db, int L, int H) {
  constexpr int STAGE = 2 * TILE_BYTES + STAT_BYTES;   // Q, g, ls, sc, delta
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * BWD_STAGES];
  uint8_t* smem = align1024(smem_raw);            // k tiles, then v tiles
  uint8_t* ring = smem + 2 * NWG * TILE_BYTES;
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BWD_STAGES;
  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * NWG * TILE;
  const int D = H * HD, nqt = (L + TILE - 1) / TILE;
  const float* st_row = stats + ((size_t)n * H + h) * 3 * L;
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], NWG * 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      bar_arrive_tx(kv_full, 2 * NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w) {
        tma_load3(smem + w * TILE_BYTES, &tm_qkv, kv_full, D + h * HD,
                 k0 + w * TILE, n);
        tma_load3(smem + (NWG + w) * TILE_BYTES, &tm_qkv, kv_full,
                 2 * D + h * HD, k0 + w * TILE, n);
      }
    }
    for (int qt = 0; qt < nqt; ++qt) {
      const int s = qt % BWD_STAGES;
      if (qt >= BWD_STAGES) bar_wait(&empty[s], (qt / BWD_STAGES - 1) & 1);
      uint8_t* st = ring + s * STAGE;
      float* stat = reinterpret_cast<float*>(st + 2 * TILE_BYTES);
      for (int i = lane; i < TILE; i += 32) {
        const int r = qt * TILE + i;          // a row past L gets P = 0
        stat[i] = r < L ? st_row[r] : 0.f;
        stat[TILE + i] = r < L ? st_row[L + r] : 0.f;
        stat[2 * TILE + i] = r < L ? st_row[2 * L + r] : 0.f;
      }
      if (lane == 0) {
        bar_arrive_tx(&full[s], 2 * TILE_BYTES);
        tma_load3(st, &tm_qkv, &full[s], h * HD, qt * TILE, n);
        tma_load3(st + TILE_BYTES, &tm_g, &full[s], h * HD, qt * TILE, n);
      } else {
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int key[2] = {k0 + wg * TILE + warp * 16 + g,
                      k0 + wg * TILE + warp * 16 + g + 8};
  const uint64_t dks = desc(smem + wg * TILE_BYTES);
  const uint64_t dvs = desc(smem + (NWG + wg) * TILE_BYTES);
  float pt[32], dpt[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[4][4], da[4][4];

  bar_wait(kv_full, 0);
  for (int qt = 0; qt < nqt; ++qt) {
    const int st = qt % BWD_STAGES;
    bar_wait(&full[st], (qt / BWD_STAGES) & 1);
    const uint8_t* base = ring + st * STAGE;
    const float* stat = reinterpret_cast<const float*>(base + 2 * TILE_BYTES);
    const uint64_t dqt = desc(base), dgt = desc(base + TILE_BYTES);
    wg_fence();
    mma_abt(pt, dks, dqt);                      // S^T = K · Q^T
    mma_abt(dpt, dvs, dgt);                     // dP^T = V · g^T
    wg_commit();
    wg_wait0();
    reg_fence(pt);
    reg_fence(dpt);
    // a query past L has P = 0 (sc = 0); a key past L only fills its own
    // accumulator rows, which are not stored
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1), q = qt * TILE + qi;
        const int k = key[e >> 1];
        float x = pt[4 * j + e] * SL2;
        if (BIAS && q < L && k < L)
          x = fmaf(__ldg(bias + ((size_t)n * L + q) * L + k), LOG2E, x);
        const float p = ex2(x - stat[qi]) * stat[TILE + qi];
        pt[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - stat[2 * TILE + qi]) * SCALE;
      }
    to_a(pa, pt);
    to_a(da, dpt);
    wg_fence();
    mma_ab(dv, pa, dgt);                        // dV += P16^T · g
    mma_ab(dk, da, dqt);                        // dK += dS16^T · Q
    wg_commit();
    wg_wait0();
    reg_fence(dv);
    reg_fence(dk);
    bar_arrive(&empty[st]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= L) continue;
    bf16* dst = dqkv + ((size_t)n * L + key[i]) * 3 * D + D + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store2(dst + 8 * j, dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      store2(dst + D + 8 * j, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
  if (part_db) {          // keys past L hold no gradient: col_sums skips them
    __shared__ float red[2][4 * NWG * 64];
    float* dst = part_db + ((size_t)n * gridDim.x + blockIdx.x) * 3 * D +
                 D + h * HD;
    col_sums<NWG>(dk, key, L, red[0], dst);
    col_sums<NWG>(dv, key, L, red[1], dst + D);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a [N, L, C] bf16 tensor read in boxes of 64 rows x 64 columns, 128-byte
// swizzle, rows past L (and columns past C) zero-filled → 0 or an error code
inline int tensor_map(CUtensorMap* map, const void* base, int N, int L,
                      int C) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * 2 * L};
  const cuuint32_t box[3] = {HD, TILE, 1};
  return encode_map(map, base, 3, dims, strides, box);
}

constexpr size_t fwd_smem(int nwg) {
  return 1024 + (size_t)nwg * TILE_BYTES + FWD_STAGES * 2 * TILE_BYTES;
}
constexpr size_t dq_smem(int nwg) {
  return 1024 + (size_t)2 * nwg * TILE_BYTES + BWD_STAGES * 2 * TILE_BYTES;
}
constexpr size_t dkv_smem(int nwg) {
  return 1024 + (size_t)2 * nwg * TILE_BYTES +
         BWD_STAGES * (2 * TILE_BYTES + STAT_BYTES);
}

template <int NWG, int MINB, bool BIAS>
int launch_fwd(const CUtensorMap& tm, const float* bias, bf16* out,
               float* lse, int N, int L, int H, cudaStream_t s) {
  auto k = fwd_kernel<NWG, MINB, BIAS>;
  static const cudaError_t e = allow_smem(k, fwd_smem(NWG));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + NWG * TILE - 1) / (NWG * TILE), H, N);
  k<<<grid, threads<NWG>(), fwd_smem(NWG), s>>>(tm, bias, out, lse, L, H);
  return (int)cudaGetLastError();
}

template <int NWG, int MINB, bool BIAS>
int launch_bwd(const CUtensorMap& tq, const CUtensorMap& tg,
               const float* bias, const bf16* g, const bf16* out,
               const float* lse, float* stats, bf16* dqkv, float* part_db,
               int N, int L, int H, cudaStream_t s) {
  auto kq = bwd_dq_kernel<NWG, MINB, BIAS>;
  auto kkv = bwd_dkv_kernel<NWG, MINB, BIAS>;
  static const cudaError_t e_q = allow_smem(kq, dq_smem(NWG));
  static const cudaError_t e_kv = allow_smem(kkv, dkv_smem(NWG));
  if (e_q != cudaSuccess) return (int)e_q;
  if (e_kv != cudaSuccess) return (int)e_kv;
  dim3 grid((L + NWG * TILE - 1) / (NWG * TILE), H, N);
  kq<<<grid, threads<NWG>(), dq_smem(NWG), s>>>(tq, tg, bias, g, out, lse,
                                                 stats, dqkv, part_db, L, H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<grid, threads<NWG>(), dkv_smem(NWG), s>>>(tq, tg, bias, stats, dqkv,
                                                   part_db, L, H);
  return (int)cudaGetLastError();
}

// the grid's z dimension holds at most this many sequences: the host
// functions below launch longer batches in chunks
constexpr int MAX_SEQ = 65535;

// K8 on qkv [N, L, 3D] → out [N, L, D], lse [N, H, L]; bias [N, L, L] or
// null.  0, a cudaError_t or a tensor-map error code
inline int attention_fwd(const bf16* qkv, const float* bias, bf16* out,
                         float* lse, int N, int L, int D, int H,
                         cudaStream_t s) {
  for (int n0 = 0; n0 < N; n0 += MAX_SEQ) {
    const int n = N - n0 < MAX_SEQ ? N - n0 : MAX_SEQ;
    CUtensorMap tm;
    if (int err = tensor_map(&tm, qkv + (size_t)n0 * L * 3 * D, n, L, 3 * D))
      return err;
    const float* b = bias ? bias + (size_t)n0 * L * L : nullptr;
    bf16* o = out + (size_t)n0 * L * D;
    float* ls = lse + (size_t)n0 * H * L;
    int err;
    if (L <= TILE)
      err = b ? launch_fwd<1, 3, true>(tm, b, o, ls, n, L, H, s)
              : launch_fwd<1, 3, false>(tm, b, o, ls, n, L, H, s);
    else
      err = b ? launch_fwd<2, 2, true>(tm, b, o, ls, n, L, H, s)
              : launch_fwd<2, 2, false>(tm, b, o, ls, n, L, H, s);
    if (err) return err;
  }
  return 0;
}

// K9 on qkv, g = dout [N, L, D] and the forward's out and lse → dqkv
// [N, L, 3D]; stats [N, H, 3, L] scratch.  part_db (or null): the fp32
// column sums of dqkv before its rounding, one row of 3D per (sequence,
// 64-row tile), [N · ceil(L / 64), 3D]
inline int attention_bwd(const bf16* qkv, const float* bias, const bf16* g,
                         const bf16* out, const float* lse, float* stats,
                         bf16* dqkv, float* part_db, int N, int L, int D,
                         int H, cudaStream_t s) {
  const int tiles = (L + TILE - 1) / TILE;
  for (int n0 = 0; n0 < N; n0 += MAX_SEQ) {
    const int n = N - n0 < MAX_SEQ ? N - n0 : MAX_SEQ;
    CUtensorMap tq, tg;
    if (int err = tensor_map(&tq, qkv + (size_t)n0 * L * 3 * D, n, L, 3 * D))
      return err;
    if (int err = tensor_map(&tg, g + (size_t)n0 * L * D, n, L, D))
      return err;
    const float* b = bias ? bias + (size_t)n0 * L * L : nullptr;
    const size_t r = (size_t)n0 * L, st = (size_t)n0 * H * L;
    float* pd = part_db ? part_db + (size_t)n0 * tiles * 3 * D : nullptr;
    const int err =
        b ? launch_bwd<1, 2, true>(tq, tg, b, g + r * D, out + r * D,
                                   lse + st, stats + 3 * st, dqkv + r * 3 * D,
                                   pd, n, L, H, s)
          : launch_bwd<1, 2, false>(tq, tg, b, g + r * D, out + r * D,
                                    lse + st, stats + 3 * st,
                                    dqkv + r * 3 * D, pd, n, L, H, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace
