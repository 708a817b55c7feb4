// Hopper (sm_90a) building blocks shared by the kernels that use TMA,
// mbarriers and wgmma: ln_linear.cu (K8), the attention rings of flash_fwd.cu
// and flash_bwd.cu, and the lab rings of lab.cu.
//
//   * mbarriers: init, arrive, arrive with an expected transaction count, and
//     a parity wait;
//   * 1-D bulk copies of contiguous bytes into shared memory (no tensor map:
//     for rows whose stride is not a multiple of 16 bytes);
//   * TMA copies of 2-D and 3-D boxes into shared memory, reported to an
//     mbarrier, 3-D TMA stores from shared memory, and the host-side encoder
//     of their tensor maps
//     (cuTensorMapEncodeTiled, fetched through the runtime so that a library
//     links against libcudart alone), bf16 boxes 64 values (128 bytes) wide
//     in the 128-byte swizzle;
//   * wgmma m64nNk16 (bf16 in, f32 accumulate) with A in shared memory (ss,
//     N = 32, 64, 128) or in registers (rs, N = 16, 64, 128), and the descriptors of
//     operands in the 128-byte swizzle: K-major (rows of 64 values along the
//     reduction, 8-row groups 1024 B apart) and MN-major (the transposed B:
//     rows along the reduction, 64 values of N each; 8-row groups 1024 B
//     apart, 64-value blocks of N `lbo` bytes apart);
//   * fence_operands, which keeps the registers of an asynchronous wgmma
//     out of the compiler's reach until its wait;
//   * the warp and quad-of-lanes shuffles of the epilogues.
//
// Fragments. A register A operand is the mma.sync m16n8k16 A fragment of
// each warp's 16 rows (common.cuh); accumulator 4j + e holds row lane / 4
// (e < 2) or lane / 4 + 8 of the warp's 16 rows, column 8j + 2 (lane % 4) +
// e % 2. Two neighbouring 8-column blocks of an accumulator therefore repack
// into one A fragment for the next product, as with mma.sync.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

namespace latteclip {

constexpr int SW128_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows of 128 B
constexpr int SW128_ROW = 128;     // bytes of one swizzled row: 64 bf16 values

// -- mbarriers -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma operands written by the threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads of the CTA (a multiple of 32), id 1..15.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- TMA ---------------------------------------------------------------------------

// One 2-D TMA copy of the box at (c0 inner, c1 outer) into dst, reported to bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One 3-D TMA copy of the box at (c0 inner, c1, c2 outer) into dst, reported to bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One 1-D bulk copy (TMA without a tensor map) of `bytes` contiguous bytes
// from src into dst, reported to bar: src, dst and bytes multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One 3-D TMA store of the box at (c0 inner, c1, c2 outer) from src, in
// the issuing thread's bulk group; elements outside the tensor are not
// written. bulk_commit closes the group; bulk_wait_read<N> waits until at
// most N of the thread's groups still read shared memory.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ldmatrix x4 at a shared-memory address (for swizzled tiles whose lane
// addresses are computed as addresses).
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ldmatrix x4 .trans at a shared-memory address.
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row r in a panel of
// 128-byte rows in the 128-byte swizzle (a 1024-byte aligned panel).
__device__ __forceinline__ uint32_t sw128_offset(int r, int chunk) {
  return (uint32_t)r * SW128_ROW + (((chunk ^ (r % 8)) & 7) << 4);
}

// -- wgmma -------------------------------------------------------------------------

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (SBO), the leading offset unused (1), layout 1.
// A k-step of 16 values (32 bytes) adds 2.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Descriptor of an MN-major (transposed) B operand in the 128-byte swizzle:
// each row of 128 B holds 64 values of N for one index of the reduction,
// 8-row groups 1024 B apart (SBO), blocks of 64 values of N `lbo` bytes apart
// (LBO), layout 1. A k-step of 16 rows adds 2048 B.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma_ss<N>: d[0 .. N/2) (+)= A[64 x 16] . B[N x 16]^T with A and B in
// shared memory; wgmma_rs<N>: the same with A in registers. TB = 1 reads B
// MN-major (transposed). scale_d = 0 overwrites d instead of adding to it.
template <int TB, int K>
__device__ __forceinline__ void wgmma_ss32(float (&d)[K], uint64_t da, uint64_t db, int scale_d) {
  static_assert(K >= 16, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB, int K>
__device__ __forceinline__ void wgmma_rs16(float (&d)[K], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(K >= 8, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, {%8,%9,%10,%11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB, int K>
__device__ __forceinline__ void wgmma_ss64(float (&d)[K], uint64_t da, uint64_t db, int scale_d) {
  static_assert(K >= 32, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB, int K>
__device__ __forceinline__ void wgmma_rs64(float (&d)[K], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(K >= 32, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB, int K>
__device__ __forceinline__ void wgmma_ss128(float (&d)[K], uint64_t da, uint64_t db, int scale_d) {
  static_assert(K >= 64, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB, int K>
__device__ __forceinline__ void wgmma_rs128(float (&d)[K], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(K >= 64, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}


// Keep registers that an asynchronous wgmma reads or writes out of the
// compiler's reach until its wait: an empty asm that claims to change them.
template <int K>
__device__ __forceinline__ void fence_operands(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// -- shuffles ----------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Within each quad of lanes (4q .. 4q + 3), v[j] of lane 4q + k becomes v[k]
// of lane 4q + j: a 4 x 4 transpose in three shuffles. In round r lane s
// sends its v[(s + r) % 4] and lane t takes it from lane (t - r) % 4.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int lane) {
  const int t = lane % 4;
  uint32_t w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = (t + r) % 4, k = (t - r + 4) % 4;
    const uint32_t send = i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
    const uint32_t got = r == 0 ? send : __shfl_sync(0xffffffffu, send, (lane & ~3) | k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r == 0) w[e] = k == e ? got : 0u;
      else w[e] = k == e ? got : w[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = w[e];
}

// Store the bf16 rows of a 64 x (8 * J) accumulator tile that a warp holds
// (rows ra = lane / 4 and rb = ra + 8 of its 16, values already packed as
// pairs: a[j] for row ra's columns 8j + 2t, 8j + 2t + 1, b[j] for row rb's),
// 16 bytes a lane after a transpose within each quad of lanes: lane t of a
// quad writes the 8 values of block 4g + t. `pa` and `pb` point at column 0
// of the two rows, or are null for a row that is not stored.
template <int J>
__device__ __forceinline__ void store_rows_bf16(const uint32_t (&a)[J], const uint32_t (&b)[J],
                                                __nv_bfloat16* pa, __nv_bfloat16* pb, int lane) {
  static_assert(J % 4 == 0, "whole groups of four 8-column blocks");
  const int t = lane % 4;
#pragma unroll
  for (int g = 0; g < J / 4; ++g) {
    uint32_t va[4] = {a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]};
    uint32_t vb[4] = {b[4 * g], b[4 * g + 1], b[4 * g + 2], b[4 * g + 3]};
    quad_transpose(va, lane);
    quad_transpose(vb, lane);
    const int col = (4 * g + t) * 8;
    if (pa) *reinterpret_cast<uint4*>(pa + col) = make_uint4(va[0], va[1], va[2], va[3]);
    if (pb) *reinterpret_cast<uint4*>(pb + col) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
  }
}

// -- tensor maps (host) ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A bf16 map of a row-major tensor of `rank` (2 or 3) dimensions, innermost
// first (dims[0] values of 2 bytes, a multiple of 8), boxes of 64 values x
// box[1] (x 1) in the 128-byte swizzle; whatever lies outside the tensor
// reads as zeros.
inline bool tensor_map_bf16(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                            int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode || rank < 2 || rank > 3) return false;
  cuuint64_t d[3], strides[2];
  for (int i = 0; i < rank; ++i) d[i] = dims[i];
  strides[0] = d[0] * 2;
  if (rank == 3) strides[1] = strides[0] * d[1];
  const cuuint32_t box[3] = {SW128_ROW / 2, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace latteclip
