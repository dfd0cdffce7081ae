// Backward gathers of the token-interaction similarity, shared by
// interaction_similarity.cu (T <= 64, V <= 16) and
// interaction_similarity_blocked.cu (T, V <= 64).
//
// Given the reduced maxima of the logits and their first-index arguments
// (m1, i1 over v per (caption, token, video); m2, i2 over t per (caption,
// video, video token)) the gradients are sums of routed rows:
//
//   dtn[a,t] = sum_b 0.5 g[a,b] ( tw[a,t] vn[b, i1[a,t,b]]
//                               + sum_{v: i2[a,b,v] == t} vw[b,v] vn[b,v] )
//   dvn[b,v] = sum_a 0.5 g[a,b] ( sum_{t: i1[a,t,b] == v} tw[a,t] tn[a,t]
//                               + vw[b,v] tn[a, i2[a,b,v]] )
//   dtw[a,t] = 0.5 sum_b g[a,b] m1[a,t,b],  dvw[b,v] = 0.5 sum_a g[a,b] m2[a,b,v]
//
// m2/i2 are [A, B, V]; m1/i1 hold entry (a, t, b) at a·T·B + t·s1t + b·s1b,
// so each caller keeps the layout its tile kernel writes best ([A, T, B]:
// s1t = B, s1b = 1; [A, B, T]: s1t = 1, s1b = T).
//
// Thread = one feature column, accumulators in shared memory indexed by the
// routed token (each thread touches only its column).  The walk over the
// other side is cut into `splits` ranges, one block each, so that short
// sides still fill the card; a split run writes partials that reduce_rows
// sums in range order: no float atomics, two runs give the same bits.
// Inside a range the routed rows are loaded GU at a time ahead of their
// shared-memory updates: the index → row → update chains of one pair are
// independent of each other.  (Giving a block several captions or videos,
// so that each row read from L2 serves them all, halved the speed on an
// H100: these kernels are bound by their instruction chains and want many
// small blocks, not fewer bytes.)

#pragma once

#include "common.cuh"

namespace {

constexpr int GD = 128;   // feature columns per block; >= the largest T, V
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
                float* __restrict__ dtw, int A, int B, int T, int V, int D,
                int s1t, int s1b) {
  extern __shared__ __align__(16) float sm[];
  float* acc = sm;              // [T][GD]
  float* tws = sm + T * GD;     // [T]
  const int a = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * GD + tid;
  const int per = (B + gridDim.z - 1) / gridDim.z;
  const int b_lo = blockIdx.z * per, b_hi = min(B, b_lo + per);
  if (tid < T) tws[tid] = tw[(size_t)a * T + tid];
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid < T) {
    const float* mr = m1 + (size_t)a * T * B + (size_t)tid * s1t;
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      s += g[(size_t)a * B + b] * mr[(size_t)b * s1b];
    dtw[(size_t)a * T + tid] = 0.5f * s;
  }
  __syncthreads();
  if (d >= D) return;
  for (int t = 0; t < T; ++t) acc[t * GD + tid] = 0.f;
  const unsigned char* i1a = i1 + (size_t)a * T * B;
  for (int b = b_lo; b < b_hi; ++b) {
    const float gab = 0.5f * g[(size_t)a * B + b];
    const float* vb = vn + (size_t)b * V * D + d;
    const unsigned char* i1ab = i1a + (size_t)b * s1b;
    // max over v: token t of the caption sends its share to video token i1
    for (int t0 = 0; t0 < T; t0 += GU) {
      float x[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int t = t0 + u;
        x[u] = t < T ? gab * tws[t] * vb[(size_t)i1ab[(size_t)t * s1t] * D]
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
                 float* __restrict__ dvw, int A, int B, int T, int V, int D,
                 int s1t, int s1b) {
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
    const unsigned char* i1ab = i1 + (size_t)a * T * B + (size_t)b * s1b;
    for (int t0 = 0; t0 < T; t0 += GU) {
      float x[GU];
      int vv[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int t = t0 + u;
        vv[u] = t < T ? i1ab[(size_t)t * s1t] : 0;
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

// Floats of scratch gather_backward needs for its partial sums at these
// sizes (0 when neither walk is split).
inline int gather_scratch(int A, int B, int T, int V, int D) {
  const int slabs = (D + GD - 1) / GD;
  const int st = gather_splits(A, slabs, B), sv = gather_splits(B, slabs, A);
  return (st > 1 ? st * A * T * D : 0) + (sv > 1 ? sv * B * V * D : 0);
}

// Both gathers (and their ordered reduces where a walk is split): dtn
// [A, T, D], dtw [A, T], dvn [B, V, D], dvw [B, V] from the maxima, their
// arguments and g [A, B]; part holds gather_scratch floats.
inline cudaError_t gather_backward(
    const float* tn, const float* vn, const float* tw, const float* vw,
    const float* g, const float* m1, const float* m2, const unsigned char* i1,
    const unsigned char* i2, float* part, float* dtn, float* dtw, float* dvn,
    float* dvw, int A, int B, int T, int V, int D, int s1t, int s1b,
    cudaStream_t s) {
  const int slabs = (D + GD - 1) / GD;
  const int st = gather_splits(A, slabs, B), sv = gather_splits(B, slabs, A);
  float* part_t = part;
  float* part_v = part + (st > 1 ? (size_t)st * A * T * D : 0);

  const size_t smem_t = (size_t)(T * GD + T) * sizeof(float);
  bwd_text_kernel<<<dim3(A, slabs, st), GD, smem_t, s>>>(
      vn, tw, vw, g, m1, i1, i2, st > 1 ? part_t : dtn, dtw, A, B, T, V, D,
      s1t, s1b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (st > 1) {
    err = reduce_rows(part_t, dtn, st, A * T * D, 1.f, s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem_v = (size_t)(V * GD + V) * sizeof(float);
  bwd_video_kernel<<<dim3(B, slabs, sv), GD, smem_v, s>>>(
      tn, tw, vw, g, m2, i1, i2, sv > 1 ? part_v : dvn, dvw, A, B, T, V, D,
      s1t, s1b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (sv > 1) return reduce_rows(part_v, dvn, sv, B * V * D, 1.f, s);
  return cudaSuccess;
}

}  // namespace
