// Backward of the token-interaction similarity from the forward's saved
// routing, shared by interaction_similarity.cu (K5: T <= 64, V <= 16) and
// interaction_similarity_blocked.cu (K7: T, V <= 64).
//
// The forward saves, per (caption a, video b), the reduced maxima of the
// logits and their FIRST-index arguments:
//   m1, i1 [A, B, T]: per caption token, the max over video tokens;
//   m2, i2 [A, B, V]: per video token, the max over caption tokens;
// m1/m2 fp32, unpadded; i1/i2 one byte each, rows padded to 16 bytes
// (pad16(T), pad16(V)) so that a pair's routing is one aligned copy.  The
// gradients are then sums of routed rows:
//
//   dtn[a,t] = sum_b 0.5 g[a,b] ( tw[a,t] vn[b, i1[a,b,t]]
//                               + sum_{v: i2[a,b,v] == t} vw[b,v] vn[b,v] )
//   dvn[b,v] = sum_a 0.5 g[a,b] ( vw[b,v] tn[a, i2[a,b,v]]
//                               + sum_{t: i1[a,b,t] == v} tw[a,t] tn[a,t] )
//   dtw[a,t] = 0.5 sum_b g[a,b] m1[a,b,t],  dvw[b,v] = 0.5 sum_a g[a,b] m2[a,b,v]
//
// Both feature gradients have one form: an OWNER (a caption for dtn, a
// video for dvn) walks its PARTNERS (the other side), and per pair adds
// (a) for each of its tokens the partner row its max routed to, and (b)
// each partner row whose max routed to one of its tokens.  routed_gather
// computes one side; a side autograd does not ask for is not launched.
//
// Design.  What bounds it on an H100 (PERF.md, §6): not bytes, since the
// staging alone takes about a third of the time, but each warp's chains of
// routing byte -> row load -> FMAs, whose latency only many warps hide:
// - a block owns QA owners x one slab of GW = 128 columns and walks a
//   range of partners in order, in tiles of PT partners: each partner's
//   [TP, 128] rows, its token weights, the QA cotangents and the QA x
//   (TO + TP) routing bytes come through a ring of GSTAGES shared-memory
//   stages of one tile each (16-byte cp.async, one commit group and one
//   barrier per tile), so a partner row is read from L2 once per QA owners,
//   not once per routed use.  A tile holds about 32 KB (PT = 1 at 64 x 64
//   tokens, 2-4 at 24 x 12), enough work between two barriers to keep the
//   loads of the next five tiles in flight;
// - a warp owns TG <= 8 of one owner's tokens, a lane 4 consecutive
//   columns (float4): the accumulators are TG float4 registers and the
//   owners' token weights sit in shared memory, so that 64 registers a
//   thread, 32 warps on an SM, suffice.  The NG warps of an owner
//   interleave its tokens in quads (warp g holds quads g and g + NG), so
//   that the live tokens, a prefix of a caption or a video, spread evenly
//   over them;
//   (a) has static targets: owner token j adds its routed row to acc[j];
//   (b) has dynamic targets: per token j a ballot over the partner tokens
//   (lanes hold their targets) finds the rows routed to it, added to acc[j]
//   in ascending order: no shared-memory accumulators, no read-modify-write
//   chains.  A token of weight 0 (masked) adds exact zeros and is skipped;
// - where too few owner tiles fill the card, the partner walk is cut into
//   ranges whose partial sums reduce_rows adds in range order.
// Every output element is one fixed sequence of fp32 additions (no float
// atomics): two runs give the same bits, and a one-side run the bits of
// the both-side run's side.
//
// bf16 (the train step's sim_dtype="bfloat16"): the partner rows are the
// bf16 features the bf16 forward read (half the staged bytes), and each
// routed coefficient 0.5·g·w is rounded to bf16 (to nearest even) before
// its fmaf, as the TPU backward casts its routed cotangents to the dot
// dtype; a product of two bf16 values is exact in fp32.  The short
// kernel's backward (K5, GATHER_BF16_EACH) rounds the two directions' coef-
// ficients apart; the blocked one's (K7, GATHER_BF16_SUM) adds a logit's
// two coefficients in fp32 first where it is routed both ways (owner token
// j's max routed to partner token r, and r's to j), so (a) takes that row
// with the sum and (b) skips it.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GW = 128;       // feature columns per slab: 32 lanes x float4
constexpr int GWARPS = 32;    // warps per block: QA owners x NG token groups
constexpr int GSTAGES = 6;    // partner tiles in the ring
constexpr int GMAX_TOKENS = 64;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// what a gather reads and how it rounds (see the header)
constexpr int GATHER_FP32 = 0, GATHER_BF16_EACH = 1, GATHER_BF16_SUM = 2;

// one side's gather: owners o (NO of them, TO tokens) walk partners p (NP,
// TP tokens); the pair (o, p) is entry o*so + p*sp of g and of the routing
struct RoutedSide {
  const void* pf;             // partner features [NP, TP, D], fp32 or bf16
  const float* wo;            // owner token weights [NO, TO]
  const float* wp;            // partner token weights [NP, TP]
  const float* g;             // cotangent, pair-indexed
  const unsigned char* ro;    // per owner token: the partner token it routed
                              // to, [pair][pad16(TO)]
  const unsigned char* rp;    // per partner token: the owner token it routed
                              // to, [pair][pad16(TP)]
  float* out;                 // [splits][NO, TO, D]
  int NO, NP, TO, TP, D, so, sp;
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  // src-size 0 zero-fills (rows past the edge)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// bytes of one ring stage, and the offsets of its parts (partner rows of
// `esize`-byte elements)
struct StageLayout {
  int rows, wp, g, ro, rp, bytes;
  __host__ __device__ StageLayout(int TO, int TP, int QA, int esize) {
    rows = 0;                                     // [TP][GW]
    wp = rows + TP * GW * esize;                  // [pad4(TP)] fp32
    g = wp + ((TP + 3) & ~3) * 4;                 // [pad4(QA)] fp32
    ro = g + ((QA + 3) & ~3) * 4;                 // [QA][pad16(TO)]
    rp = ro + QA * pad16(TO);                     // [QA][pad16(TP)]
    bytes = rp + QA * pad16(TP);
  }
};

// four consecutive staged elements as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);     // one 8-byte load
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// a routed coefficient as the gather of MODE multiplies it
template <int MODE>
__device__ __forceinline__ float coef(float c) {
  return MODE == GATHER_FP32 ? c : __bfloat162float(__float2bfloat16_rn(c));
}

// acc += gab·wps[v]·rows[v] for the partner tokens v = base + the set bits
// of m, ascending; two rows per round, so that their loads overlap
template <int MODE, typename F>
__device__ __forceinline__ void add_routed(float4& acc, unsigned m, int base,
                                           float gab, const float* wps,
                                           const F* rows) {
  while (m) {
    const int v = base + __ffs(m) - 1;
    m &= m - 1;
    const bool two = m != 0;
    const int v2 = two ? base + __ffs(m) - 1 : v;
    m &= m - 1;
    const float c = coef<MODE>(gab * wps[v]), c2 = coef<MODE>(gab * wps[v2]);
    const float4 x = load4(rows + v * GW);
    const float4 x2 = load4(rows + v2 * GW);
    acc.x = fmaf(c, x.x, acc.x);
    acc.y = fmaf(c, x.y, acc.y);
    acc.z = fmaf(c, x.z, acc.z);
    acc.w = fmaf(c, x.w, acc.w);
    if (two) {
      acc.x = fmaf(c2, x2.x, acc.x);
      acc.y = fmaf(c2, x2.y, acc.y);
      acc.z = fmaf(c2, x2.z, acc.z);
      acc.w = fmaf(c2, x2.w, acc.w);
    }
  }
}

// grid (owner tiles, slabs, partner ranges of `per`); blockDim QA·NG·32;
// PT partners per ring stage
template <int TG, int MODE>
__global__ void __launch_bounds__(GWARPS * 32)
routed_gather_kernel(RoutedSide s, int QA, int NG, int per, int PT) {
  using F = typename std::conditional<MODE == GATHER_FP32, float, bf16>::type;
  constexpr int EPC = 16 / sizeof(F);      // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char gsm[];
  const StageLayout L(s.TO, s.TP, QA, sizeof(F));
  const F* pf = static_cast<const F*>(s.pf);
  const int TOP = pad16(s.TO), TPP = pad16(s.TP);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q = warp / NG, grp = warp % NG;
  const int o0 = blockIdx.x * QA, o = o0 + q;
  const int c0 = blockIdx.y * GW, col = c0 + lane * 4;
  const int p_lo = blockIdx.z * per, p_hi = min(s.NP, p_lo + per);
  const int n = max(0, p_hi - p_lo);
  // warp-uniform (the ballots need every lane); lanes past D add zeros
  const bool live = o < s.NO;

  const int SB = PT * L.bytes;   // one stage: PT partner layouts
  auto load1 = [&](unsigned char* st, int p) {
    for (int i = tid; i < s.TP * (GW / EPC); i += nthreads) {
      const int r = i / (GW / EPC), c = (i % (GW / EPC)) * EPC;
      const bool ok = c0 + c < s.D;
      cp_async_16(st + L.rows + (r * GW + c) * sizeof(F),
                  ok ? pf + ((size_t)p * s.TP + r) * s.D + c0 + c : pf, ok);
    }
    for (int i = tid; i < s.TP; i += nthreads)
      cp_async_4(st + L.wp + i * 4, s.wp + (size_t)p * s.TP + i, true);
    for (int i = tid; i < QA; i += nthreads) {
      const bool ok = o0 + i < s.NO;
      cp_async_4(st + L.g + i * 4,
                 ok ? s.g + (size_t)(o0 + i) * s.so + (size_t)p * s.sp : s.g,
                 ok);
    }
    const int cro = TOP / 16, crp = TPP / 16;
    for (int i = tid; i < QA * (cro + crp); i += nthreads) {
      const int qq = i / (cro + crp), c = i % (cro + crp);
      const bool ok = o0 + qq < s.NO;
      const size_t pair = (size_t)(o0 + qq) * s.so + (size_t)p * s.sp;
      if (c < cro)
        cp_async_16(st + L.ro + qq * TOP + c * 16,
                    ok ? s.ro + pair * TOP + c * 16 : s.ro, ok);
      else
        cp_async_16(st + L.rp + qq * TPP + (c - cro) * 16,
                    ok ? s.rp + pair * TPP + (c - cro) * 16 : s.rp, ok);
    }
  };
  // the tile of partners k·PT .. of this range into stage k % GSTAGES
  auto load = [&](int k) {
    for (int u = 0; u < PT && p_lo + k * PT + u < p_hi; ++u)
      load1(gsm + (k % GSTAGES) * SB + u * L.bytes, p_lo + k * PT + u);
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  // accumulator j holds owner token tok(j): quad grp + NG·(j / 4)
  auto tok = [&](int j) { return 4 * (grp + NG * (j / 4)) + j % 4; };
  // the owners' token weights [QA][NG·TG] in shared memory past the ring
  // (registers are the scarce resource at 32 warps an SM)
  float* wos = reinterpret_cast<float*>(gsm + GSTAGES * SB) + q * NG * TG;
  float4 acc[TG];
  unsigned quad_live = 0;
#pragma unroll
  for (int j = 0; j < TG; ++j) {
    const float w = live && tok(j) < s.TO ? s.wo[(size_t)o * s.TO + tok(j)]
                                          : 0.f;
    if (lane == 0) wos[grp * TG + j] = w;
    quad_live |= (w != 0.f) << (j / 4);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* wo = wos + grp * TG;

  const int ntiles = (n + PT - 1) / PT;
  for (int k = 0; k < GSTAGES - 1; ++k) {
    if (k < ntiles) load(k);
    commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GSTAGES - 2));
    __syncthreads();   // tile i is in; every warp is done with tile i - 1
    if (i + GSTAGES - 1 < ntiles) load(i + GSTAGES - 1);
    commit();
    if (!live) continue;
    for (int pt = 0; pt < PT && i * PT + pt < n; ++pt) {
      const unsigned char* st = gsm + (i % GSTAGES) * SB + pt * L.bytes;
      const F* rows = reinterpret_cast<const F*>(st + L.rows) + lane * 4;
      const float* wps = reinterpret_cast<const float*>(st + L.wp);
      const float gab = 0.5f * reinterpret_cast<const float*>(st + L.g)[q];
      const unsigned* ro =
          reinterpret_cast<const unsigned*>(st + L.ro + q * TOP);
      const unsigned char* rp = st + L.rp + q * TPP;

      // (a) owner token tok(j) takes the partner row its max routed to.  A
      // quad of weight-0 tokens (masked, or past TO) adds exact zeros and
      // is skipped; inside a live quad the four loads go out together (a
      // weight-0 token adds 0 · a row, its index clamped into the tile)
#pragma unroll
      for (int j4 = 0; j4 < TG / 4; ++j4) {
        if (!(quad_live >> j4 & 1)) continue;
        const unsigned w = ro[grp + NG * j4];   // the routing of one quad
        float4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = load4(rows + min((int)(w >> (8 * u)) & 0xff, s.TP - 1) * GW);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4& a = acc[j4 * 4 + u];
          // GATHER_BF16_SUM: where the partner token r this owner token's max
          // routed to routes back to it, the two coefficients' sum, which
          // (b) then skips
          const int r = (w >> (8 * u)) & 0xff;
          float c = gab * wo[j4 * 4 + u];
          if (MODE == GATHER_BF16_SUM && c != 0.f && r < s.TP &&
              rp[r] == tok(j4 * 4 + u))
            c += gab * wps[r];
          c = coef<MODE>(c);
          a.x = fmaf(c, x[u].x, a.x);
          a.y = fmaf(c, x[u].y, a.y);
          a.z = fmaf(c, x[u].z, a.z);
          a.w = fmaf(c, x[u].w, a.w);
        }
      }
      // (b) partner tokens whose max routed to owner token tok(j), in order;
      // lane l holds the accumulator index j that partner tokens l and
      // l + 32 route to in this warp, or -1 (another warp's token, or a
      // partner token of weight 0, whose rows add exact zeros)
      auto slot = [&](int v) {
        if (v >= s.TP || wps[v] == 0.f) return -1;
        const int t = rp[v], k = (t >> 2) - grp;   // quad grp + NG·k
        const int j = k == 0 ? (t & 3) : k == NG && TG > 4 ? 4 + (t & 3) : -1;
        if (MODE == GATHER_BF16_SUM && j >= 0 && gab * wo[j] != 0.f &&
            reinterpret_cast<const unsigned char*>(ro)[t] == v)
          return -1;                               // (a) added it
        return j;
      };
      const int j0 = slot(lane), j1 = slot(lane + 32);
      const unsigned hit0 = __reduce_or_sync(~0u, j0 < 0 ? 0u : 1u << j0);
      const unsigned hit1 = __reduce_or_sync(~0u, j1 < 0 ? 0u : 1u << j1);
      if ((hit0 | hit1) == 0) continue;
#pragma unroll
      for (int j = 0; j < TG; ++j) {
        if (hit0 >> j & 1)
          add_routed<MODE>(acc[j], __ballot_sync(~0u, j0 == j), 0, gab, wps,
                           rows);
        if (hit1 >> j & 1)
          add_routed<MODE>(acc[j], __ballot_sync(~0u, j1 == j), 32, gab, wps,
                           rows);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (!live || col >= s.D) return;
  float* out = s.out + (size_t)blockIdx.z * s.NO * s.TO * s.D;
#pragma unroll
  for (int j = 0; j < TG; ++j)
    if (tok(j) < s.TO)
      *reinterpret_cast<float4*>(out + ((size_t)o * s.TO + tok(j)) * s.D +
                                 col) = acc[j];
}

// out[split][o, k] = sum over this split's partners p of g[pair] m[pair, k]
// (pair = o*so + p*sp, m rows of K floats); unsplit, already halved
__global__ void routed_weight_grad_kernel(const float* __restrict__ g,
                                          const float* __restrict__ m,
                                          float* __restrict__ out, int NO,
                                          int NP, int K, int so, int sp,
                                          int per, float scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NO * K) return;
  const int o = idx / K, k = idx % K;
  const int p_lo = blockIdx.y * per, p_hi = min(NP, p_lo + per);
  float acc = 0.f;
  for (int p = p_lo; p < p_hi; ++p) {
    const size_t pair = (size_t)o * so + (size_t)p * sp;
    acc += g[pair] * m[pair * K + k];
  }
  out[(size_t)blockIdx.y * NO * K + idx] = scale * acc;
}

// ---------------------------------------------------------------------------
// host side: how each side is cut, its scratch, its launches
// ---------------------------------------------------------------------------

struct GatherPlan {
  int NG, TG, QA, tiles, slabs, splits, per, PT, smem;
};

inline GatherPlan plan_gather(int NO, int NP, int TO, int TP, int D,
                              int esize = 4) {
  GatherPlan P;
  P.NG = (TO + 7) / 8;                              // token groups per owner
  P.TG = (((TO + P.NG - 1) / P.NG) + 3) & ~3;       // 4 or 8
  P.QA = GWARPS / P.NG;                             // owners per block
  P.tiles = (NO + P.QA - 1) / P.QA;
  P.slabs = (D + GW - 1) / GW;
  // two blocks' worth of work per SM of an H100 (132), in ranges of at
  // least 8 partners
  const int blocks = P.tiles * P.slabs;
  int sp = (264 + blocks - 1) / blocks;
  if (sp > 16) sp = 16;
  if (sp > NP / 8) sp = NP / 8;
  P.splits = sp < 1 ? 1 : sp;
  P.per = (NP + P.splits - 1) / P.splits;
  P.splits = (NP + P.per - 1) / P.per;
  // about 32 KB of partners per ring stage (at most 6 x 33.6 KB)
  const int one = StageLayout(TO, TP, P.QA, esize).bytes;
  P.PT = 32768 / one;
  P.PT = P.PT < 1 ? 1 : P.PT > 8 ? 8 : P.PT;
  P.smem = GSTAGES * P.PT * one + GWARPS * 8 * 4;   // + token weights
  return P;
}

struct WeightPlan {
  int splits, per;
};

inline WeightPlan plan_weight(int NO, int NP, int K) {
  WeightPlan W;
  int sp = 65536 / (NO * K);
  if (sp > 16) sp = 16;
  if (sp > NP / 16) sp = NP / 16;
  W.splits = sp < 1 ? 1 : sp;
  W.per = (NP + W.splits - 1) / W.splits;
  W.splits = (NP + W.per - 1) / W.per;
  return W;
}

// which outputs a backward call asks for
constexpr int NEED_DTN = 1, NEED_DVN = 2, NEED_DTW = 4, NEED_DVW = 8;

// floats of scratch routed_backward needs for the partial sums of split
// walks, for the outputs in `need`
inline size_t routed_scratch(int A, int B, int T, int V, int D, int need) {
  size_t n = 0;
  if (need & NEED_DTN) {
    const GatherPlan P = plan_gather(A, B, T, V, D);
    if (P.splits > 1) n += (size_t)P.splits * A * T * D;
  }
  if (need & NEED_DVN) {
    const GatherPlan P = plan_gather(B, A, V, T, D);
    if (P.splits > 1) n += (size_t)P.splits * B * V * D;
  }
  if (need & NEED_DTW) {
    const WeightPlan W = plan_weight(A, B, T);
    if (W.splits > 1) n += (size_t)W.splits * A * T;
  }
  if (need & NEED_DVW) {
    const WeightPlan W = plan_weight(B, A, V);
    if (W.splits > 1) n += (size_t)W.splits * B * V;
  }
  return n;
}

// routed_gather_kernel launches this library has made (each library that
// includes this header has its own count), read through its C entry
// <lib>_gather_launches: a count taken where the launches are made, for
// tests that need the number of kernels a call launched
long long g_gather_launches = 0;

template <int MODE>
cudaError_t launch_gather(const RoutedSide& s0, float* out, float* part,
                          cudaStream_t st) {
  RoutedSide s = s0;
  const GatherPlan P = plan_gather(s.NO, s.NP, s.TO, s.TP, s.D,
                                   MODE == GATHER_FP32 ? 4 : 2);
  s.out = P.splits > 1 ? part : out;
  const int smem = P.smem;
  const dim3 grid(P.tiles, P.slabs, P.splits);
  const int threads = P.QA * P.NG * 32;
  cudaError_t err = cudaSuccess;
  auto go = [&](auto kern) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return;
    kern<<<grid, threads, smem, st>>>(s, P.QA, P.NG, P.per, P.PT);
    err = cudaGetLastError();
    if (err == cudaSuccess) __atomic_add_fetch(&g_gather_launches, 1,
                                               __ATOMIC_RELAXED);
  };
  if (P.TG == 4)
    go(routed_gather_kernel<4, MODE>);
  else
    go(routed_gather_kernel<8, MODE>);
  if (err != cudaSuccess || P.splits == 1) return err;
  return reduce_rows(part, out, P.splits, s.NO * s.TO * s.D, 1.f, st);
}

inline cudaError_t launch_weight(const float* g, const float* m, float* out,
                                 float* part, int NO, int NP, int K, int so,
                                 int sp, cudaStream_t st) {
  const WeightPlan W = plan_weight(NO, NP, K);
  const dim3 grid((NO * K + 127) / 128, W.splits);
  routed_weight_grad_kernel<<<grid, 128, 0, st>>>(
      g, m, W.splits > 1 ? part : out, NO, NP, K, so, sp, W.per,
      W.splits > 1 ? 1.f : 0.5f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || W.splits == 1) return err;
  return reduce_rows(part, out, W.splits, NO * K, 2.f, st);
}

// The backward from the routing: tn [A, T, D], vn [B, V, D] (fp32, or bf16
// under a bf16 MODE), tw [A, T], vw [B, V], g [A, B], the residuals as
// above; each of dtn [A, T, D], dvn [B, V, D], dtw [A, T], dvw [B, V]
// (fp32) is computed when its pointer is not null.  part holds
// routed_scratch(..., need) floats.
template <int MODE>
cudaError_t routed_backward(
    const void* tn, const void* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const unsigned char* i1, const float* m2,
    const unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, cudaStream_t st) {
  if (T < 1 || T > GMAX_TOKENS || V < 1 || V > GMAX_TOKENS || D % 4 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (dtn != nullptr) {   // captions own, videos are the partners
    const RoutedSide s{vn, tw, vw, g, i1, i2, nullptr, A, B, T, V, D, B, 1};
    err = launch_gather<MODE>(s, dtn, part, st);
    if (err != cudaSuccess) return err;
    const GatherPlan P = plan_gather(A, B, T, V, D);
    if (P.splits > 1) part += (size_t)P.splits * A * T * D;
  }
  if (dvn != nullptr) {   // videos own, captions are the partners
    const RoutedSide s{tn, vw, tw, g, i2, i1, nullptr, B, A, V, T, D, 1, B};
    err = launch_gather<MODE>(s, dvn, part, st);
    if (err != cudaSuccess) return err;
    const GatherPlan P = plan_gather(B, A, V, T, D);
    if (P.splits > 1) part += (size_t)P.splits * B * V * D;
  }
  if (dtw != nullptr) {
    err = launch_weight(g, m1, dtw, part, A, B, T, B, 1, st);
    if (err != cudaSuccess) return err;
    const WeightPlan W = plan_weight(A, B, T);
    if (W.splits > 1) part += (size_t)W.splits * A * T;
  }
  if (dvw != nullptr) err = launch_weight(g, m2, dvw, part, B, A, V, 1, B, st);
  return err;
}

}  // namespace
