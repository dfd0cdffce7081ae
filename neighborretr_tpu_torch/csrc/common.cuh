// Helpers shared by the hand-written kernels: a warp's sum, and the
// ordered reduction of per-block partial sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
