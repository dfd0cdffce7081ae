// Helpers shared by the hand-written kernels: bf16 mma.sync fragments,
// warp reductions, a sequence's rows into shared memory (with or without
// LayerNorm), and the ordered reduction of per-block partial sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One sequence's rows 0..LP into shared memory as bf16 (row stride HS),
// one warp per row, rows past L zero.  LN: the LayerNorm of x in fp32 (an
// fp32 island, h rounded to bf16), as the K1/K3 sublayers take it; !LN: x
// as it is (K10/K11's pre-normalised h).
template <bool LN>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ xs,
                                          bf16* hs, int HS, int L, int LP,
                                          int D, const float* ln_w,
                                          const float* ln_b, float eps,
                                          int warp, int n_warps, int lane) {
  for (int i = warp; i < LP; i += n_warps) {
    bf16* row = hs + i * HS;
    if (i >= L) {
      for (int d = lane; d < D; d += 32) row[d] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = xs + (size_t)i * D;
    if constexpr (!LN) {
      for (int d = lane; d < D; d += 32) row[d] = xr[d];
    } else {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) {
        bf16 v = xr[d];
        row[d] = v;
        s += __bfloat162float(v);
      }
      const float mean = warp_sum(s) / D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) {
        float c = __bfloat162float(row[d]) - mean;
        ss += c * c;
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
      for (int d = lane; d < D; d += 32) {
        float xh = (__bfloat162float(row[d]) - mean) * rstd;
        row[d] = __float2bfloat16(xh * ln_w[d] + ln_b[d]);
      }
    }
  }
}

// out[c] = (sum_b part[b][c]) / div, b in ascending order: the second pass
// of every cross-block sum here (no float atomics, so two runs give the
// same bits).  part is [nblk, ncols], one thread per column.
__global__ void reduce_rows_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nblk,
                                   int ncols, float div) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * ncols + c];
  out[c] = s / div;
}

inline cudaError_t reduce_rows(const float* part, float* out, int nblk,
                               int ncols, float div, cudaStream_t s) {
  reduce_rows_kernel<<<(ncols + 127) / 128, 128, 0, s>>>(part, out, nblk,
                                                         ncols, div);
  return cudaGetLastError();
}

}  // namespace
