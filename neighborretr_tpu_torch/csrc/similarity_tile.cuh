// The token-interaction similarity's tile: a TMA-fed TF32 wgmma GEMM in a
// 3xTF32 split with both max-reductions in its epilogue, shared by
// interaction_similarity.cu (K2/K4: V <= 16, 8 videos a warpgroup) and
// interaction_similarity_blocked.cu (K6: T, V <= 64, 128 / VP videos a
// warpgroup).  One block computes, for QB captions against 2·VIDS videos,
//
//   S[a,b] = 0.5 * ( sum_t tw[a,t] * max_v <tn[a,t], vn[b,v]>
//                  + sum_v vw[b,v] * max_t <tn[a,t], vn[b,v]> )
//
// on L2-normalised features whose padding masks the wrapper has already
// folded in (masked tokens are zero rows, so their logits are 0 and still
// take part in the max — the reference's multiplicative masking).  The
// [A, T, B, V] logits never reach device memory.
//
// - Arithmetic: each operand x is split into hi = tf32(x) and lo =
//   tf32(x - hi) (round to nearest, ties away: cvt.rna), and every logit
//   is hi·lo + lo·hi + hi·hi (the small products first) on the TF32 tensor
//   cores (the dropped lo·lo term is about 2^-22 of |x||y|), at a 2.5x
//   higher peak than fp32 FMAs (3 x 2·A·T·B·V·D FLOP at 494.7 TFLOP/s).
//   The tensor cores truncate where they add into their accumulator, so
//   each m-tile's products of one 32-column k-chunk go into a fresh
//   accumulator that is then added, rounded, into fp32 sums in registers.
//   At D = 512 the maxima lie within 9e-8 of float64, cuBLAS's fp32 GEMM's
//   within 2.7e-7; one accumulator over all of D drifted 1.05e-6 (H100,
//   tools/similarity_probe.py's accuracy report).
//   ops/similarity.py::similarity_tf32x3 is the split written out in
//   PyTorch.
// - bf16 operands (In = bf16, the train step's sim_dtype="bfloat16", ↔ the
//   TPU kernel's dot_dtype: `_tile_logits` casts each tile to bf16 and
//   accumulates in fp32): the wrapper rounds the features once (to
//   nearest even), TMA brings 64-column k-chunks (still 128-byte rows),
//   and each k-step is ONE wgmma m64nNk16 (bf16 in, fp32 accumulate): no
//   split, no lo tile.  Products of bf16 values are exact in fp32, so the
//   logits are the float64 logits of the rounded operands up to fp32
//   summation order; the chunking and the epilogue are the TF32 form's.
// - Tiles: two consumer warpgroups take VIDS videos each, and one thread
//   streams 32-column k-chunks of both sides through a ring of shared-
//   memory stages with TMA (fp32 boxes of 128-byte rows in the 128-byte
//   swizzle; columns past D are zero-filled, so D need only be a multiple
//   of 16), refilling a stage when both warpgroups have released it.  The
//   text rows are t-major, r = t·QB + q (a 3-D tensor map over [D, A, T]),
//   MT m-tiles of 64 rows; the video rows v-major, n = v·VIDS + video, N =
//   VIDS·VP columns a warpgroup (VP = V padded; slots past V are zero rows
//   that both reductions skip).
//   A consumer first splits its landed video tile in shared memory (hi in
//   place, lo beside it), then, one m-tile after another, per k-step of 8
//   loads its text fragments from the swizzled tile, splits them in
//   registers (the next k-step's while this one's products run) and
//   issues the three wgmma m64nNk8 (A from registers, B from shared
//   memory); after an m-tile's last k-step it waits for them and adds the
//   accumulator into that m-tile's sums (MT x N/2 sum registers and one
//   N/2-register accumulator: 192 of them at N = 96, MT = 3 or N = 128,
//   MT = 2).  No producer warp: at 256 threads a block a thread may hold
//   up to 255 registers (ptxas caps a block of 288 or 384 threads at 168,
//   and the m-tiles then spill).
// - Epilogue: the sums go to shared memory as a [rows, N] logits tile,
//   and the reductions run there as the plain version's sequential
//   chains: per (token t, video) the max over v, per (query, video, token
//   v) the max over t, each in ascending order, then S's two weighted sums
//   in token order, in the type Sum (K6 takes double: at 64 tokens a side
//   fp32 chains took S 1.7x as far from float64 as the plain version's).
// - Under SAVE the epilogue also writes the backward's residuals: per
//   (query, video) the max over v of each query token's logits and its
//   FIRST index (m1, i1) and the max over t of each video token's and its
//   first index (m2, i2), in the layouts of similarity_gather.cuh.  The
//   maxima are the ones S is built from (the same fmaxf chains; an index
//   moves only where fmaxf changes the running max), so S keeps its bits,
//   and the routing is the forward's own.  Ties are the normal case:
//   masked tokens are zero rows and their logits are exactly 0.
// - Under TIES (K6) a max whose runner-up lies within TIE_GAP of it (a
//   tie, or a near-tie the fp32 logits may have ordered otherwise than
//   exact arithmetic) gets bit 7 of its index byte set; the wrapper
//   re-picks those indices as the first argmax of float64 logits and
//   clears the bit (ops/similarity.py::resolve_near_ties) before a
//   backward reads them.  The runner-up is tracked beside the max without
//   branches (the top two values), over the tokens that are not identical
//   to an earlier token of their caption / video (res.ct / res.cv: each
//   token's first identical token; such a token's logit is -inf for the
//   runner-up): an identical token's logit equals the earlier one's in any
//   arithmetic and can move neither the max nor its first index.  A max
//   and runner-up both exactly 0 (the logits of masked, zero tokens) are
//   not flagged either.  The maxima and S keep their bits.
// - Both reductions run two rows' chains a thread at a time (independent
//   fmaxf chains in flight together; each row's order is unchanged).
// - Grid: one block per (query group, video tile), the side with fewer
//   tiles varying fastest so that blocks running together share the other
//   side's tiles in L2.  No float atomics: two runs give the same bits.

#pragma once

#include "hopper.cuh"
#include "similarity_gather.cuh"

namespace {

constexpr int DK = 32;              // fp32 columns a k-chunk: one 128 B row
constexpr int CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128;
constexpr int MAX_STAGES = 4;
constexpr int MAX_ROWS = 192;       // text rows of a block: 3 m-tiles
constexpr int MAX_QB = 8;           // queries of a block
constexpr int MAX_N = 128;          // columns of a warpgroup's tile
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on an H100
constexpr int STATIC_SMEM = 4096;   // room left for the static arrays
// a runner-up this close to the max is flagged under TIES: the 3xTF32
// maxima lie within 8.25e-8 of float64 at the bank shapes (H100,
// tools/similarity_probe.py), so two logits can swap order only within
// twice that; 1e-6 leaves a factor of 6
constexpr float TIE_GAP = 1e-6f;
constexpr unsigned char TIE_FLAG = 0x80;

// what the tile's epilogue does with its [QB, 2·VIDS] block of S
constexpr int STORE = 0;      // out [A, B] = S
constexpr int MEAN_ROWS = 1;  // out [video tiles, A]: sums over the videos
constexpr int MEAN_COLS = 2;  // out [query groups, B]: sums over the queries

// the backward's residuals, written under SAVE (similarity_gather.cuh)
struct Routing {
  float* m1;           // [A, B, T]
  unsigned char* i1;   // [A, B, pad16(T)]
  float* m2;           // [A, B, V]
  unsigned char* i2;   // [A, B, pad16(V)]
  // under TIES: per token the index of the first identical token of its
  // caption [A, T] / video [B, V]
  const unsigned char* ct = nullptr;
  const unsigned char* cv = nullptr;
};

// N = VIDS·VP columns a warpgroup, MT m-tiles
__host__ __device__ constexpr int stage_bytes(int N, int MT) {
  return MT * 64 * 128 + CONSUMERS * N * 128;
}
// floats of one warpgroup's epilogue: the logits tile (rows padded by 8,
// whose last 8 columns then hold the per-row maxima: VIDS <= 8) and the
// column maxima, [query][v][video]
__host__ __device__ constexpr int epilogue_floats(int N, int MT) {
  return MT * 64 * (N + 8) + MAX_QB * MAX_N;
}

// The tile of the block blockIdx.x; tm_t / tm_v are the kernel's
// __grid_constant__ tensor maps (tile_maps), `stages` the ring's depth.
__device__ __forceinline__ unsigned char routed_index(int ix, float m,
                                                      float second,
                                                      bool ties) {
  const bool near = ties && m - second < TIE_GAP &&
                    !(m == 0.f && second == 0.f);
  return (unsigned char)(ix | (near ? TIE_FLAG : 0));
}


template <int VIDS, int VP, int MT, bool SAVE, typename Sum = float,
          bool TIES = false, typename In = float>
__device__ __forceinline__ void similarity_tile(
    const CUtensorMap* tm_t, const CUtensorMap* tm_v,
    const float* __restrict__ tw, const float* __restrict__ vw,
    float* __restrict__ out, const Routing& res, int A, int B, int T, int V,
    int D, int QB, int mode, int stages) {
  constexpr int N = VIDS * VP;            // columns of a warpgroup's tile
  constexpr int BV = CONSUMERS * VIDS;    // videos of a block
  constexpr int TB = MT * 64 * 128;       // text tile bytes
  constexpr int VB = N * 128;             // one warpgroup's video tile
  constexpr int SB = stage_bytes(N, MT);
  constexpr int LS = N + 8;               // logits row stride (floats)
  constexpr bool BF16 = sizeof(In) == 2;
  constexpr int KC = 128 / sizeof(In);    // columns of a k-chunk
  static_assert(VIDS <= 8 && N <= MAX_N && MT * 64 <= MAX_ROWS,
                "the epilogue's padding and static arrays");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES];
  __shared__ float tw_s[MAX_ROWS];        // [q][t] of the block's queries
  __shared__ float vw_s[BV * VP];         // [video][v]
  __shared__ float s_blk[MAX_QB * BV];    // S of the block, [q][video]
  // under TIES: -inf where a token is identical to an earlier token of its
  // caption / video (it takes no part in the runner-up), else 0
  __shared__ float pen_t[TIES ? MT * 64 : 1];           // [q][t]
  __shared__ float pen_v[TIES ? BV * VP : 1];           // [video][v]
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;

  const int nq = (A + QB - 1) / QB, nv = (B + BV - 1) / BV;
  const int tile = blockIdx.x;
  const int qg = nq <= nv ? tile % nq : tile / nv;
  const int vt = nq <= nv ? tile / nq : tile % nv;
  const int a0 = qg * QB, b0 = vt * BV;
  const int nk = (D + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS * 128);
    }
    bar_init_fence();
  }
  for (int i = threadIdx.x; i < QB * T; i += THREADS) {
    const int a = a0 + i / T;
    tw_s[i] = a < A ? tw[(size_t)a * T + i % T] : 0.f;
  }
  for (int i = threadIdx.x; i < BV * V; i += THREADS) {
    const int b = b0 + i / V;
    vw_s[(i / V) * VP + i % V] = b < B ? vw[(size_t)b * V + i % V] : 0.f;
  }
  if (TIES) {
    for (int i = threadIdx.x; i < QB * T; i += THREADS) {
      const int a = a0 + i / T, t = i % T;
      pen_t[i] = a < A && res.ct[(size_t)a * T + t] != t ? -INFINITY : 0.f;
    }
    for (int i = threadIdx.x; i < BV * VP; i += THREADS) {
      const int b = b0 + i / VP, v = i % VP;
      pen_v[i] = b < B && v < V && res.cv[(size_t)b * V + v] != v ? -INFINITY
                                                                 : 0.f;
    }
  }
  // thread 0 issues the loads: k-chunk c into stage c % stages
  auto load = [&](int c) {
    const int s = c % stages;
    uint8_t* st = ring + s * SB;
    bar_arrive_tx(&full[s], SB);
    tma_load3(st, tm_t, &full[s], c * KC, a0, 0);
    tma_load3(st + TB, tm_v, &full[s], c * KC, b0, 0);
    tma_load3(st + TB + VB, tm_v, &full[s], c * KC, b0 + VIDS, 0);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < stages && c < nk; ++c) load(c);
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  // the logits, summed in fp32 over the k-chunks; acc holds one m-tile's
  // products of one k-chunk
  float sum[MT][N / 2], acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) sum[i][j] = 0.f;
  }
  uint8_t* lo = ring + stages * SB + wg * VB;

  for (int c = 0; c < nk; ++c) {
    const int s = c % stages;
    // refill the stage that chunk c - 1 used once both warpgroups are done
    // with it
    if (threadIdx.x == 0 && c > 0 && c - 1 + stages < nk) {
      bar_wait(&empty[(c - 1) % stages], ((c - 1) / stages) & 1);
      load(c - 1 + stages);
    }
    bar_wait(&full[s], (c / stages) & 1);
    uint8_t* st = ring + s * SB;
    float4* vh = reinterpret_cast<float4*>(st + TB + wg * VB);
    // every warp's products of the previous chunk are done: lo is free
    if constexpr (!BF16) named_sync(1 + wg, 128);
    // split this warpgroup's video tile: hi in place, lo beside it
#pragma unroll
    for (int i = tid; i < (BF16 ? 0 : VB / 16); i += 128) {
      const float4 x = vh[i];
      float4 h, l;
      h.x = __uint_as_float(tf32_rna(x.x));
      h.y = __uint_as_float(tf32_rna(x.y));
      h.z = __uint_as_float(tf32_rna(x.z));
      h.w = __uint_as_float(tf32_rna(x.w));
      l.x = __uint_as_float(tf32_rna(x.x - h.x));
      l.y = __uint_as_float(tf32_rna(x.y - h.y));
      l.z = __uint_as_float(tf32_rna(x.z - h.z));
      l.w = __uint_as_float(tf32_rna(x.w - h.w));
      vh[i] = h;
      reinterpret_cast<float4*>(lo)[i] = l;
    }
    if constexpr (!BF16) {
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }
    const uint64_t dh = desc(vh), dl = desc(lo);
    // text fragments of m-tile i, k-step kk, split: rows i·64 + 16w + g
    // (+ 8), columns 8kk + tq (+ 4), in the 128-byte swizzle (16-byte chunk
    // index XOR row % 8, and row % 8 = g).  Two register sets: the next
    // k-step's are loaded and split while this one's products run
    // (wait_group 1 has retired the previous k-step's, the set it
    // overwrites)
    uint32_t ah[2][4], al[2][4];
    auto frag = [&](int i, int kk, int bi) {
      const int c0 = ((2 * kk) ^ g) * 16 + tq * 4;
      const int c1 = ((2 * kk + 1) ^ g) * 16 + tq * 4;
      const uint8_t* r0 = st + (i * 64 + 16 * w + g) * 128;
      if constexpr (BF16) {      // two bf16 a register, as they lie
        const int off[4] = {c0, 1024 + c0, c1, 1024 + c1};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ah[bi][e] = *reinterpret_cast<const uint32_t*>(r0 + off[e]);
        return;
      }
      const float x[4] = {*reinterpret_cast<const float*>(r0 + c0),
                          *reinterpret_cast<const float*>(r0 + 1024 + c0),
                          *reinterpret_cast<const float*>(r0 + c1),
                          *reinterpret_cast<const float*>(r0 + 1024 + c1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[bi][e] = tf32_rna(x[e]);
        al[bi][e] = tf32_rna(x[e] - __uint_as_float(ah[bi][e]));
      }
    };
    // one m-tile at a time: its 3 x DK/8 products of this k-chunk into acc,
    // started from zero (scale-d 0), then acc added into the m-tile's sums:
    // the tensor cores' truncation then acts on a chunk's partial sums, not
    // on the whole logit, and the chunks are added with rounding
    frag(0, 0, 0);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        const int bi = kk & 1;
        wg_fence();
        if constexpr (BF16) {
          wgmma_bf16_rs<N>(acc, ah[bi], dh + 2 * kk, kk > 0);
        } else {
          wgmma_tf32_rs<N>(acc, ah[bi], dl + 2 * kk, kk > 0);
          wgmma_tf32_rs<N>(acc, al[bi], dh + 2 * kk, 1);
          wgmma_tf32_rs<N>(acc, ah[bi], dh + 2 * kk, 1);
        }
        wg_commit();
        if (kk + 1 < DK / 8) {
          wg_wait1();
          frag(i, kk + 1, bi ^ 1);
        } else if (i + 1 < MT) {
          wg_wait1();
          frag(i + 1, 0, bi ^ 1);
        }
      }
      wg_wait0();
      reg_fence(acc);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) sum[i][j] += acc[j];
    }
    bar_arrive(&empty[s]);
  }

  // epilogue.  Both warpgroups' products are done: the ring is free
  named_sync(3, CONSUMERS * 128);
  float* L = reinterpret_cast<float*>(ring) + wg * epilogue_floats(N, MT);
  float* M2 = L + MT * 64 * LS;           // [q][v][video]
  // sum[i][4j + e] (an accumulator's layout) of m-tile i: row i·64 + 16w +
  // g + 8(e >> 1), column 8j + 2tq + (e & 1) = v·VIDS + video
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(L + (i * 64 + 16 * w + g + 8 * h) * LS + 8 * j + 2 * tq,
               sum[i][4 * j + 2 * h], sum[i][4 * j + 2 * h + 1]);
  named_sync(1 + wg, 128);

  // per (row r = t·QB + q, video): max over v, first index; two rows a
  // thread at a time (independent chains)
  {
    const int n1 = QB * T * VIDS;
    for (int base = tid; base < n1; base += 256) {
      int r[2], vid[2];
      const float* x[2];
      const float* pv[2];
      float m[2], second[2];
      int ix[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int it = base + 128 * k < n1 ? base + 128 * k : base;
        r[k] = it / VIDS;
        vid[k] = it % VIDS;
        x[k] = L + r[k] * LS + vid[k];
        pv[k] = pen_v + (wg * VIDS + vid[k]) * VP;
        m[k] = -INFINITY;
        second[k] = -INFINITY;
        ix[k] = 0;
      }
#pragma unroll
      for (int v = 0; v < VP; ++v)
        if (v < V) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float xv = x[k][VIDS * v];
            const float nm = fmaxf(m[k], xv);
            // the top two values: an identical token's -inf adds nothing
            if (TIES)
              second[k] = fmaxf(second[k], fminf(m[k], xv + pv[k][v]));
            if (SAVE && nm != m[k]) ix[k] = v;
            m[k] = nm;
          }
        }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (base + 128 * k >= n1) continue;
        L[r[k] * LS + N + vid[k]] = m[k];
        const int a = a0 + r[k] % QB, b = b0 + wg * VIDS + vid[k];
        const int t = r[k] / QB;
        if (SAVE && a < A && b < B) {
          const size_t pair = (size_t)a * B + b;
          res.m1[pair * T + t] = m[k];
          res.i1[pair * pad16(T) + t] =
              routed_index(ix[k], m[k], second[k], TIES);
        }
      }
    }
  }
  // per (query, token v, video): max over t, first index; two a thread at
  // a time
  {
    const int n2 = QB * VP * VIDS;
    for (int base = tid; base < n2; base += 256) {
      int it[2], v[2], q[2];
      const float* x[2];
      float m[2], second[2];
      int ix[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        it[k] = base + 128 * k < n2 ? base + 128 * k : base;
        v[k] = (it[k] / VIDS) % VP;
        q[k] = it[k] / (VIDS * VP);
        x[k] = L + q[k] * LS + VIDS * v[k] + it[k] % VIDS;
        m[k] = -INFINITY;
        second[k] = -INFINITY;
        ix[k] = 0;
      }
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float xt = x[k][t * QB * LS];
          const float nm = fmaxf(m[k], xt);
          if (TIES)
            second[k] =
                fmaxf(second[k], fminf(m[k], xt + pen_t[q[k] * T + t]));
          if (SAVE && nm != m[k]) ix[k] = t;
          m[k] = nm;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (base + 128 * k >= n2 || v[k] >= V) continue;
        M2[it[k]] = m[k];
        const int a = a0 + q[k], b = b0 + wg * VIDS + it[k] % VIDS;
        if (SAVE && a < A && b < B) {
          const size_t pair = (size_t)a * B + b;
          res.m2[pair * V + v[k]] = m[k];
          res.i2[pair * pad16(V) + v[k]] =
              routed_index(ix[k], m[k], second[k], TIES);
        }
      }
    }
  }
  named_sync(1 + wg, 128);

  // S of (query q, video): the two weighted sums in token order
  const int q = tid / VIDS, vid = tid % VIDS;
  const int a = a0 + q, b = b0 + wg * VIDS + vid;
  const bool mine = tid < QB * VIDS;
  float val = 0.f;
  if (mine && a < A && b < B) {
    Sum s_t = 0, s_v = 0;
    for (int t = 0; t < T; ++t)
      s_t += (Sum)tw_s[q * T + t] * (Sum)L[(t * QB + q) * LS + N + vid];
#pragma unroll
    for (int v = 0; v < VP; ++v)
      if (v < V)
        s_v += (Sum)vw_s[(wg * VIDS + vid) * VP + v] *
               (Sum)M2[(q * VP + v) * VIDS + vid];
    val = (float)((Sum)0.5 * (s_t + s_v));
    if (mode == STORE) out[(size_t)a * B + b] = val;
  }
  if (mode == STORE) return;
  if (mine) s_blk[q * BV + wg * VIDS + vid] = val;
  if (mode == MEAN_ROWS) {
    named_sync(3, CONSUMERS * 128);
    if (threadIdx.x < QB && a0 + threadIdx.x < A) {
      float r = 0.f;
      for (int k = 0; k < BV; ++k) r += s_blk[threadIdx.x * BV + k];
      out[(size_t)vt * A + a0 + threadIdx.x] = r;
    }
  } else {                                  // MEAN_COLS
    named_sync(1 + wg, 128);
    const int bb = b0 + wg * VIDS + tid;
    if (tid < VIDS && bb < B) {
      float r = 0.f;
      for (int k = 0; k < QB; ++k) r += s_blk[k * BV + wg * VIDS + tid];
      out[(size_t)qg * B + bb] = r;
    }
  }
}

// queries a block: at most 8, fewer where T leaves too many rows for the
// accumulators (at most mt_max m-tiles of 64 rows) or A is small (a single
// query fills 64 rows with its own tokens)
__host__ __device__ inline int block_queries(int A, int T, int mt_max) {
  int qb = 8;
  while (qb > 1 && ((qb * T + 63) / 64 > mt_max || qb / 2 >= A)) qb /= 2;
  return qb;
}

// The ring's depth and the dynamic shared memory of a tile of N = VIDS·VP
// columns and MT m-tiles: the ring and the split video tiles (fp32 only),
// or the epilogue's, whichever is larger
template <int N, int MT, typename In = float>
struct TileSmem {
  static constexpr int lo_bytes = sizeof(In) == 4 ? CONSUMERS * N * 128 : 0;
  static constexpr int fit =
      (SMEM_LIMIT - 1024 - STATIC_SMEM - lo_bytes) / stage_bytes(N, MT);
  static constexpr int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  static_assert(stages >= 2, "two stages must fit");
  static constexpr size_t ring =
      (size_t)stages * stage_bytes(N, MT) + lo_bytes;
  static constexpr size_t epi =
      sizeof(float) * CONSUMERS * epilogue_floats(N, MT);
  static constexpr size_t bytes = 1024 + (ring > epi ? ring : epi);
};

// The tile's tensor maps: text [A, T, D] as [D, A, T], a box of QB queries
// x MT·64/QB tokens (rows t·QB + q); video [B, V, D] as [D, B, V], a box of
// VIDS videos x VP tokens (rows v·VIDS + video); a box row is 128 bytes
// (32 fp32 or 64 bf16) → 0 or an error code
template <int VIDS, int VP, int MT, typename In = float>
int tile_maps(CUtensorMap* tm_t, CUtensorMap* tm_v, const In* tn,
              const In* vn, int A, int B, int T, int V, int D, int QB) {
  constexpr cuuint64_t E = sizeof(In);
  constexpr cuuint32_t KC = 128 / sizeof(In);
  constexpr CUtensorMapDataType type = sizeof(In) == 4
                                           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)A, (cuuint64_t)T};
    const cuuint64_t strides[2] = {(cuuint64_t)T * D * E, (cuuint64_t)D * E};
    const cuuint32_t box[3] = {KC, (cuuint32_t)QB, (cuuint32_t)(MT * 64 / QB)};
    if (int e = encode_map(tm_t, tn, 3, dims, strides, box, type)) return e;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)B, (cuuint64_t)V};
  const cuuint64_t strides[2] = {(cuuint64_t)V * D * E, (cuuint64_t)D * E};
  const cuuint32_t box[3] = {KC, VIDS, VP};
  return encode_map(tm_v, vn, 3, dims, strides, box, type);
}

// blocks of the grid: query groups x video tiles
inline int tile_blocks(int A, int B, int QB, int VIDS) {
  const int bv = CONSUMERS * VIDS;
  return ((A + QB - 1) / QB) * ((B + bv - 1) / bv);
}

inline bool bad_routing(const Routing& r) {
  const bool none = !r.m1 && !r.i1 && !r.m2 && !r.i2;
  return !none && !(r.m1 && r.i1 && r.m2 && r.i2);
}

}  // namespace
