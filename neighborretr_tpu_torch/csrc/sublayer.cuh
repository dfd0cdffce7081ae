// The stages of the attention sublayer, y = (x +) W_o · MHA(LN(x) · W_qkv +
// b_qkv) + b_o, shared by its forward (ln_attention_residual.cu) and its
// backward (ln_attention_residual_bwd.cu):
//
//   * gemm: C[R, C] = A · B over all M = N·L rows at once, bf16 operands,
//     fp32 accumulation, with an epilogue that adds a bias over the columns
//     and a bf16 residual in fp32 and rounds once (bf16 out), or stores
//     fp32.  A is [R, K] or (TA) [K, R], B is [C, K] (torch's weight
//     layout) or (TB) [K, C]: every operand is read as it lies in device
//     memory, the transposed ones through wgmma's MN-major form, never
//     copied.  A split over K (the weight gradients, K = M rows) writes one
//     fp32 copy of C per range into a scratch and adds them in range order.
//   * ln_rows: LayerNorm as an fp32 island, h rounded to bf16, a warp per
//     row, written once [M, D];
//   * reduce_rows8: the ordered sum of many rows of fp32 partials.
//   * forward_stages: LN, the qkv projection and the attention core (K8's
//     kernel, frame_attention.cuh), which the backward recomputes.
//
// GEMM design (what bounds the sublayer on an H100: its products over the
// M rows, 8·M·D² FLOP forward and 16·M·D² more backward, on the bf16
// tensor cores).  A block owns a 128 x 128 tile of C: two consumer
// warpgroups of 64 rows each and one producer warp.  The producer streams
// 64-deep k-slices of A and B through a ring of G_STAGES shared-memory
// stages with TMA (2-D tensor maps, boxes of 64 columns = 128-byte rows in
// the 128-byte swizzle, rows and columns past the tensor's end zero-filled:
// M is ragged); consumers issue wgmma m64n128k16 on each stage, keep one
// stage's products in flight (wait_group 1) and release a stage on its
// "empty" mbarrier when the products that read it are done.  Two blocks
// share an SM, so one block's epilogue overlaps the other's products.
// Every mbarrier wait traps after ~8 s instead of holding the card.  No
// float atomics anywhere: every sum runs inside one thread or block in a
// fixed order, so two runs give the same bits.

#pragma once

#include "frame_attention.cuh"

namespace {

// C tile GBM x GBN and k-slice, a 3-stage ring, two blocks per SM (128 x
// 256 tiles in a 4-stage ring, one block per SM, measured slower in the
// forward and at every small shape on an H100)
constexpr int GBM = 128, GBN = 128, GBK = 64;
constexpr int G_STAGES = 3;
constexpr int G_MINB = 2;                        // blocks per SM
constexpr int G_CONSUMERS = 2;                   // warpgroups of 64 rows
constexpr int G_THREADS = G_CONSUMERS * 128 + 32;
constexpr int G_BOX = 64 * 64 * 2;               // 8 KB: 64 rows of 128 B
constexpr int G_STAGE = 4 * G_BOX;               // A 128 x 64, B 64 x 128
constexpr size_t G_SMEM = 1024 + (size_t)G_STAGES * G_STAGE;
constexpr int MAX_SPLITS = 8;

// C (+ blockIdx.z · R · C) = A · B over k in [z·kc, z·kc + kc)
template <bool TA, bool TB, bool BIAS, bool RES, typename OutT>
__global__ void __launch_bounds__(G_THREADS, G_MINB)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_b, OutT* __restrict__ out,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            int R, int C, int K, int kc) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * G_STAGES];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = bars;
  uint64_t* empty = bars + G_STAGES;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int k_lo = blockIdx.z * kc;
  const int nk = (min(K, k_lo + kc) - k_lo + GBK - 1) / GBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], G_CONSUMERS * 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= G_CONSUMERS * 128) {          // the producer warp
    if (threadIdx.x == G_CONSUMERS * 128) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % G_STAGES;
        if (ks >= G_STAGES) bar_wait(&empty[s], (ks / G_STAGES - 1) & 1);
        uint8_t* st = ring + s * G_STAGE;
        const int k0 = k_lo + ks * GBK;
        bar_arrive_tx(&full[s], G_STAGE);
        // A: rows m0.., one box of 128 rows (K-major) or two boxes of 64
        // columns (MN-major); then B the same way over columns n0..
        if (TA) {
          tma_load2(st, &tm_a, &full[s], m0, k0);
          tma_load2(st + G_BOX, &tm_a, &full[s], m0 + 64, k0);
        } else {
          tma_load2(st, &tm_a, &full[s], k0, m0);
        }
        if (TB) {
          tma_load2(st + 2 * G_BOX, &tm_b, &full[s], n0, k0);
          tma_load2(st + 3 * G_BOX, &tm_b, &full[s], n0 + 64, k0);
        } else {
          tma_load2(st + 2 * G_BOX, &tm_b, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % G_STAGES;
    bar_wait(&full[s], (ks / G_STAGES) & 1);
    const uint8_t* st = ring + s * G_STAGE;
    // this warpgroup's 64 rows of A; B's two 64-column atoms 8 KB apart
    const uint64_t da = desc(st + wg * G_BOX);
    const uint64_t db = desc(st + 2 * G_BOX, TB ? G_BOX : 16);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk)
      wgmma_n128<TA, TB>(acc, da + kstep<TA>() * kk, db + kstep<TB>() * kk);
    wg_commit();
    wg_wait1();                 // the previous slice's products are done
    if (ks > 0) bar_arrive(&empty[(ks - 1) % G_STAGES]);
  }
  wg_wait0();
  reg_fence(acc);

  // epilogue: bias and residual in fp32, one rounding; rows past R and
  // columns past C are not stored
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  out += (size_t)blockIdx.z * R * C;
#pragma unroll
  for (int j = 0; j < GBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= C) continue;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (BIAS) {
      b0 = __ldg(bias + col);
      b1 = __ldg(bias + col + 1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= R) continue;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (BIAS) {
        v0 += b0;
        v1 += b1;
      }
      if constexpr (RES) {
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)r * C +
                                                     col));
        v0 += xf.x;
        v1 += xf.y;
      }
      store2(out + (size_t)r * C + col, v0, v1);
    }
  }
}

// out[c] = sum_r part[r][c], r in ascending order within each of 8 row
// groups (r mod 8), then the groups in order: the ordered sum of many rows
// of partials (no float atomics)
__global__ void __launch_bounds__(256)
reduce_rows8_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int rows, int ncols) {
  __shared__ float red[8][32];
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + x;
  float s = 0.f;
  if (c < ncols)
    for (int r = y; r < rows; r += 8) s += part[(size_t)r * ncols + c];
  red[y][x] = s;
  __syncthreads();
  if (y == 0 && c < ncols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][x];
    out[c] = t;
  }
}

inline cudaError_t reduce_rows8(const float* part, float* out, int rows,
                                int ncols, cudaStream_t s) {
  reduce_rows8_kernel<<<(ncols + 31) / 32, 256, 0, s>>>(part, out, rows,
                                                        ncols);
  return cudaGetLastError();
}

// h = LayerNorm(x) · w + b in fp32, rounded to bf16: a warp per row, 8
// rows per block, 16-byte loads (D a multiple of 8)
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, bf16* __restrict__ h, int M,
               int D, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  const int nv = D / 8;
  auto unpack = [](const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(p[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  };
  float f[8], s = 0.f;
  for (int v = lane; v < nv; v += 32) {
    unpack(__ldg(xr + v), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mean = warp_sum(s) / D;
  float ss = 0.f;
  for (int v = lane; v < nv; v += 32) {
    unpack(__ldg(xr + v), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);
  uint4* hr = reinterpret_cast<uint4*>(h + (size_t)row * D);
  for (int v = lane; v < nv; v += 32) {
    unpack(__ldg(xr + v), f);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * v + 2 * e;
      op[e] = pack_bf16((f[2 * e] - mean) * rstd * __ldg(w + d) + __ldg(b + d),
                        (f[2 * e + 1] - mean) * rstd * __ldg(w + d + 1) +
                            __ldg(b + d + 1));
    }
    hr[v] = o;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// splits of K for a product with `tiles` output tiles and `ksteps` k-slices:
// about one block per slot of the card (G_MINB per SM)
inline int pick_splits(int tiles, int ksteps) {
  int s = (G_MINB * sm_count() + tiles / 2) / tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > ksteps) s = ksteps;
  return s < 1 ? 1 : s;
}

// out[R, C] = A · B (+ bias) (+ res); A [R, K] or (TA) [K, R], B [C, K] or
// (TB) [K, C], bf16, contiguous, widths multiples of 8.  part: fp32
// scratch of MAX_SPLITS · R · C for a split over K (fp32 out only), or
// null for none
template <bool TA, bool TB, bool BIAS, bool RES, typename OutT>
int gemm(const bf16* a, const bf16* b, OutT* out, const float* bias,
         const bf16* res, int R, int C, int K, float* part, cudaStream_t s) {
  CUtensorMap ta, tb;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)(TA ? R : K),
                                (cuuint64_t)(TA ? K : R)};
    const cuuint64_t strides[1] = {(cuuint64_t)dims[0] * 2};
    const cuuint32_t box[2] = {64, TA ? 64u : (cuuint32_t)GBM};
    if (int err = encode_map(&ta, a, 2, dims, strides, box)) return err;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)(TB ? C : K),
                                (cuuint64_t)(TB ? K : C)};
    const cuuint64_t strides[1] = {(cuuint64_t)dims[0] * 2};
    const cuuint32_t box[2] = {64, TB ? 64u : (cuuint32_t)GBN};
    if (int err = encode_map(&tb, b, 2, dims, strides, box)) return err;
  }
  auto k = gemm_kernel<TA, TB, BIAS, RES, OutT>;
  static const cudaError_t e = allow_smem(k, G_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + GBN - 1) / GBN, (R + GBM - 1) / GBM, 1);
  const int ksteps = (K + GBK - 1) / GBK;
  int splits = part ? pick_splits(grid.x * grid.y, ksteps) : 1;
  const int kc = ((ksteps + splits - 1) / splits) * GBK;
  splits = (K + kc - 1) / kc;
  grid.z = splits;
  k<<<grid, G_THREADS, G_SMEM, s>>>(ta, tb, splits > 1 ? (OutT*)part : out,
                                    bias, res, R, C, K, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)reduce_rows(part, (float*)out, splits, R * C, 1.f, s);
}

// one sublayer call's scratch, carved from one device buffer in 256-byte
// aligned slices; `ln`: the LayerNorm's h16 (K1/K3; K10/K11 read h as it
// is), `bwd`: the backward's buffers
struct Work {
  bf16 *h16, *qkv, *attn, *dattn, *dqkv;
  float *lse, *stats, *dh, *part_db, *part_ln, *part_w;
};

constexpr int LN_ROWS = 64;   // rows of a LayerNorm-backward block

inline size_t carve(void* base, int N, int L, int D, int H, bool ln, bool bwd,
                    Work& w) {
  const size_t M = (size_t)N * L;
  const size_t E = (size_t)HD * H;   // the attention's width (D unless split)
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = base ? static_cast<uint8_t*>(base) + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  w = Work{};
  if (ln) w.h16 = static_cast<bf16*>(take(M * D * 2));
  w.qkv = static_cast<bf16*>(take(M * 3 * E * 2));
  w.attn = static_cast<bf16*>(take(M * E * 2));
  w.lse = static_cast<float*>(take((size_t)N * H * L * 4));
  if (bwd) {
    w.stats = static_cast<float*>(take((size_t)N * H * 3 * L * 4));
    w.dattn = static_cast<bf16*>(take(M * E * 2));
    w.dqkv = static_cast<bf16*>(take(M * 3 * E * 2));
    if (ln) w.dh = static_cast<float*>(take(M * D * 4));
    w.part_db = static_cast<float*>(take((size_t)N * 3 * E * 4));
    w.part_ln = static_cast<float*>(
        take((M + LN_ROWS - 1) / LN_ROWS * 3 * D * 4));
    w.part_w = static_cast<float*>(take((size_t)MAX_SPLITS * 3 * E * D * 4));
  }
  return off;
}

// what these kernels take: 1 <= L <= 64 (one key tile: K8/K9 keep the TPU's
// rounding there), head dim 64, at most 65535 row tiles.  `ln`: the model
// width D is the attention's, 64·H (K1/K3, whose residual and LayerNorm
// need it); else (K10/K11) the H heads may be a part of the model's, as
// under tensor parallelism (W_qkv [3·64H, D], W_o [D, 64H]), D a multiple
// of 64
inline bool bad_sublayer(int N, int L, int D, int H, bool ln) {
  return N < 1 || L < 1 || L > TILE || H < 1 ||
         (ln ? D != HD * H : D % HD != 0) ||
         (long long)N * L > 65535ll * GBM;
}

// the forward up to the attention core, which the backward recomputes:
// h16 = LN(x) (LN), qkv = h · W_qkvᵀ + b_qkv, attn_out and lse (K8)
template <bool LN>
int forward_stages(const bf16* x, const float* bias, const float* ln_w,
                   const float* ln_b, const bf16* w_qkv, const float* b_qkv,
                   const Work& w, int N, int L, int D, int H, float eps,
                   cudaStream_t s) {
  const int M = N * L;
  const bf16* h = x;
  if constexpr (LN) {
    ln_rows_kernel<<<(M + 7) / 8, 256, 0, s>>>(x, ln_w, ln_b, w.h16, M, D,
                                               eps);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    h = w.h16;
  }
  const int E = HD * H;
  if (int err = gemm<false, false, true, false, bf16>(
          h, w_qkv, w.qkv, b_qkv, nullptr, M, 3 * E, D, nullptr, s))
    return err;
  return attention_fwd(w.qkv, bias, w.attn, w.lse, N, L, E, H, s);
}

}  // namespace
