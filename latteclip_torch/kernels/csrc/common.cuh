// Device helpers shared by the flash-attention kernels (sm_90a): cp.async
// copies, ldmatrix loads and the bf16 mma.sync m16n8k16 product.
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A [16 x 16], row-major: a0 (row g, cols 2t..2t+1), a1 (row g+8, cols 2t..),
//     a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B [16 x 8]: b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8.., col g);
//   C [16 x 8], f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// Two neighbouring C tiles (16 columns) repack into one A fragment, which is
// how p and ds feed the next product without going through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace latteclip {

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; copies zeros when !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets within a 16 x 16 block of a row-major shared tile for an
// ldmatrix x4: the A pattern (rows M, columns K; with .trans also a B
// operand stored [K][N]) and the B pattern (rows N, columns K, no .trans).
__device__ __forceinline__ int a_row(int lane) { return (lane % 8) + 8 * ((lane / 8) % 2); }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int b_row(int lane) { return (lane % 8) + 8 * (lane / 16); }
__device__ __forceinline__ int b_col(int lane) { return 8 * ((lane / 8) % 2); }

// Maximum and sum over the four lanes that hold one fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// Two f32 values rounded to one packed bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// A bf16 pair scaled in f32 and rounded back to bf16, as the TPU kernels
// scale q: bf16(f32(q) * qscale).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(as_bf162(v));
  return pack_bf16(f.x * s, f.y * s);
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22, subnormal results
// flushed to 0), ahead of p's rounding to bf16.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int MAX_DEVICES = 64;

// Allow `bytes` of dynamic shared memory for `kernel` on the current device,
// once: `allowed` is a static array owned by the caller's launch function,
// one flag per device, since the setting belongs to the device's context.
// With max_carveout, also ask for as much of the SM's memory as shared
// memory as it offers, so that several CTAs with large tiles fit an SM.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&allowed)[MAX_DEVICES],
                       bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev]) return cudaSuccess;
  if (max_carveout) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = true;
  return err;
}

}  // namespace latteclip
