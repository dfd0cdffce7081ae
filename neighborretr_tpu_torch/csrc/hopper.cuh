// Hopper building blocks shared by the kernels that feed wgmma from the
// Tensor Memory Accelerator (frame_attention.cuh, sublayer.cuh,
// similarity_tile.cuh):
// mbarriers whose waits trap instead of holding the card, TMA tile loads,
// wgmma shared-memory descriptors and instructions, and on the host the
// tensor-map encoder (libcuda's cuTensorMapEncodeTiled, reached through the
// runtime: no -lcuda).
//
// Every tile these kernels hand to wgmma is a TMA box whose rows are 128
// bytes (64 bf16, or 32 fp32 read as TF32) in the 128-byte swizzle,
// 1024-byte aligned.  One
// descriptor form serves both operand orientations:
//   K-major (the contraction runs along a row): 8-row groups 1024 B apart
//     (SBO); a k-step of 16 advances the start by 32 B;
//   MN-major (the contraction runs down the rows, the transpose flag set):
//     8-row groups 1024 B apart (SBO), 64-column atoms LBO apart; a k-step
//     of 16 advances the start by 16 rows = 2048 B.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

// error codes beside cudaError_t's
constexpr int ERR_NO_ENCODE = 20000;      // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 10000;     // + its CUresult

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sm(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (sm(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sm(b))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(sm(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(sm(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// waits for the completion of the phase of parity `parity`; a protocol
// fault aborts the launch after ~8 s instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  if (bar_try(b, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(b, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one box of a 3-D tensor map at (c, r, n) into shared memory, completed on
// mbarrier b
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* b, int c, int r, int n) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(sm(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm(b)), "r"(c), "r"(r),
      "r"(n)
      : "memory");
}

// one box of a 2-D tensor map at (inner c, outer r)
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint64_t* b, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm(b)), "r"(c), "r"(r)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 1024-aligned tile of 128-byte rows in the 128-byte
// swizzle: 8-row groups 1024 B apart (SBO), 64-column atoms `lbo` bytes
// apart (MN-major operands wider than 64 only; K-major ignores it)
__device__ __forceinline__ uint64_t desc(const void* tile, uint32_t lbo = 16) {
  return (uint64_t)((sm(tile) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// start-address step of a k-step of 16: K-major 32 B, MN-major 2048 B
template <bool MN>
__host__ __device__ constexpr uint64_t kstep() { return MN ? 128 : 2; }

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the accumulators are written asynchronously: nothing may read them before
// the wait, and this pins every read after it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_REGS32                                                            \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define WG_OUT8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUTS32 WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)

// d[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B from shared memory; TB:
// B is MN-major (its rows are the contraction)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : WG_OUTS32
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// the same with A from registers (mma.sync's m16n8k16 A fragment per warp)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : WG_OUTS32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// d[64 x 128] += A[64 x 16] · B[16 x 128], both from shared memory; TA / TB:
// the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, %67,"
      " %68;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24), WG_OUT8(32),
        WG_OUT8(40), WG_OUT8(48), WG_OUT8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// TF32: d[64 x N] += A[64 x 8] · B[8 x N] in fp32, A from registers (per
// warp the m16n8k8 tf32 fragment: a0 (row g, col t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane % 4), B K-major from
// shared memory in the 128-byte swizzle: 32 fp32 a row, so a k-step of 8
// advances the descriptor by 32 B, as bf16's k-step of 16 does.  Operands
// are passed already rounded (tf32_rna: the low 13 bits zero), so that no
// rounding of the hardware's enters the products.  acc = 0 discards d's old
// value: d = A · B.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
      ", {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
      ", {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<96>(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,"
      "%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}"
      ", {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24), WG_OUT8(32),
        WG_OUT8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,"
      "%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,"
      "%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
      ", {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24), WG_OUT8(32),
        WG_OUT8(40), WG_OUT8(48), WG_OUT8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// bf16: d[64 x N] += A[64 x 16] · B[16 x N] with fp32 accumulation, A from
// registers (per warp the m16n8k16 bf16 fragment: four 32-bit registers of
// two bf16 each, a0 (row g, cols 2t, 2t + 1), a1 (g + 8, 2t ..), a2 (g,
// 2t + 8 ..), a3 (g + 8, 2t + 8 ..)), B K-major from shared memory in the
// 128-byte swizzle: a k-step of 16 advances the descriptor by 32 B, and
// the fragments sit at the byte offsets of the TF32 form's.  acc = 0
// discards d's old value: d = A · B.
template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
      ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
      ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<96>(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,"
      "%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}"
      ", {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24),
        WG_OUT8(32), WG_OUT8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,"
      "%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,"
      "%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
      ", {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24),
        WG_OUT8(32), WG_OUT8(40), WG_OUT8(48), WG_OUT8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef WG_REGS32
#undef WG_OUT8
#undef WG_OUTS32

// Accumulator layout of m64nN: thread (warp w of the warpgroup, lane: g =
// lane / 4, t = lane % 4) holds d[4j + e] at row 16w + g + 8·(e >> 1),
// column 8j + 2t + (e & 1).

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero;
// the low 13 bits of the result are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// orders this thread's shared-memory writes before the async proxy's reads
// (wgmma, TMA) that a barrier publishes them to
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `n` threads, a multiple of 32
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (or `type`) tensor of `rank` dimensions (innermost first, strides
// in bytes of dimensions 1..rank-1) read in boxes `box` in the 128-byte
// swizzle (a box row of 128 bytes: 64 bf16, 32 fp32); elements past a
// dimension's end are zero-filled → 0 or an error code
inline int encode_map(
    CUtensorMap* map, const void* base, cuuint32_t rank,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// past 48 KB a block's dynamic shared memory is opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
