// LayerNorm then a linear layer, fused, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel latteclip_tpu/kernels/fused_ln_linear.py::_kernel:
//   latteclip_ln_linear  <- _kernel (via _fwd_pallas)
// For x [M, D] bf16 (M = B * L tokens), the LayerNorm's scale and bias
// [D] f32, the weight W [O, D] f32 (torch's orientation: row o holds the
// D inputs of output o) and the bias wb [O] f32, it writes
//   xn = bf16((x - mean) / sqrt(var + eps) * scale + bias)   (f32 statistics,
//        population variance, two passes over the row, as jnp.var)
//   y  = bf16(xn . bf16(W)^T + wb)                           [M, O]
// with the product accumulated in f32 and the bias added to the f32
// accumulator before the one rounding, as the TPU kernel does (the unfused
// route rounds the product first and adds the bias in bf16).
//
// Bound. The product dominates: at the train step's pairs, vision
// 25600 x 768 -> 2304 does 90.6 GFLOP against 162 MB of x, W and y, 560
// FLOP/byte, above the H100's ~295 at which the bf16 tensor cores (989
// TFLOP/s) rather than HBM (3.35 TB/s) become the limit. So the design
// keeps the normalised rows on chip and feeds the tensor cores from shared
// memory:
//   * one CTA owns BM = 128 rows (64 where the row does not fit): it copies
//     them into shared memory with 16-byte cp.async copies, one warp per row
//     takes the mean and the variance in f32 and writes the normalised bf16
//     row back in place (128 x 768 x 2 B = 194 KB with its padding), so xn
//     never touches device memory;
//   * the CTA then sweeps its share of W in 64 x 64 tiles: each thread loads
//     16-byte pieces of the f32 tiles into a ring of registers three tiles
//     ahead (48 KB in flight on the SM, enough to cover L2's latency under
//     load; with one tile ahead the SM waited on L2 most of the time), rounds
//     them to bf16 and stores them into one of two shared buffers, so the
//     per-call bf16 copy of W that the unfused route makes never exists;
//   * each warp owns 16 rows x 64 columns and multiplies with mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), fragments loaded with ldmatrix
//     from rows padded by 16 bytes (no bank conflicts);
//   * each CTA re-reads W once (in f32, from L2), so W's traffic is
//     M / BM times its size; the row tiles are split over the output columns
//     where there are too few of them to fill the card (the short template
//     stream), each split recomputing the cheap LayerNorm.
// No cuBLAS. wgmma, TMA and a bf16 W kept resident are left for later work.
//
// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape it does not take (D a
// multiple of 64 and small enough for a 64-row tile, O a multiple of 8).

#include <climits>

#include "common.cuh"

namespace {

using namespace latteclip;

constexpr int BN = 64;           // output columns per W tile
constexpr int BK = 64;           // inputs per W tile
constexpr int W_STRIDE = BK + 8; // padded shared row of a W tile, in bf16 elements
constexpr int DEPTH = 4;         // register sets of W tiles: DEPTH - 1 in flight ahead
constexpr int SMEM_MAX = 232448; // shared memory a CTA can take on an H100

template <int BM>
constexpr size_t smem_bytes(int D) {
  return (size_t)BM * (D + 8) * 2 + 2 * (size_t)BN * W_STRIDE * 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per 16 rows. The CTA's output tiles are tiles [nt_begin, nt_end)
// of 64 columns, for row tile blockIdx.x / n_splits.
template <int BM>
__global__ void __launch_bounds__(BM * 2, 1)
    ln_linear_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const float* __restrict__ w,
                     const float* __restrict__ wb, __nv_bfloat16* __restrict__ y, int M, int D,
                     int O, float eps, int n_splits) {
  constexpr int THREADS = BM * 2;
  constexpr int WARPS = THREADS / 32;
  constexpr int PIECES = BN * BK / 4 / THREADS;  // float4 pieces of a W tile per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = D + 8;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = sA + BM * SA;  // two [BN][W_STRIDE] buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % n_splits;
  const long row0 = (long)(blockIdx.x / n_splits) * BM;
  const int n_tiles = (O + BN - 1) / BN;
  const int nt_begin = (int)((long)split * n_tiles / n_splits);
  const int nt_end = (int)((long)(split + 1) * n_tiles / n_splits);
  const int k_tiles = D / BK;
  const int steps = (nt_end - nt_begin) * k_tiles;

  // 1. the CTA's rows of x, zero-filled beyond M
  const int chunks = D / 8;
  for (int c = tid; c < BM * chunks; c += THREADS) {
    const int r = c / chunks, col = (c % chunks) * 8;
    const bool valid = row0 + r < M;
    cp_async_16(&sA[r * SA + col], x + (valid ? row0 + r : 0) * D + col, valid);
  }
  cp_async_commit();

  // W tile of step i (output tile nt_begin + i / k_tiles, input tile
  // i % k_tiles) into a register set, and from a set into buffer buf as bf16
  float4 wr[DEPTH][PIECES];
  auto fetch = [&](int i, float4 (&r)[PIECES]) {
    const int n0 = (nt_begin + i / k_tiles) * BN, k0 = (i % k_tiles) * BK;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const int c = tid + j * THREADS;
      const int n = n0 + c / (BK / 4);
      r[j] = n < O ? __ldg(reinterpret_cast<const float4*>(w + (long)n * D + k0) + c % (BK / 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf, const float4 (&r)[PIECES]) {
    __nv_bfloat16* dst = sW + buf * BN * W_STRIDE;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const int c = tid + j * THREADS;
      uint2 v;
      v.x = pack_bf16(r[j].x, r[j].y);
      v.y = pack_bf16(r[j].z, r[j].w);
      *reinterpret_cast<uint2*>(&dst[(c / (BK / 4)) * W_STRIDE + (c % (BK / 4)) * 4]) = v;
    }
  };
#pragma unroll
  for (int j = 0; j < DEPTH - 1; ++j)
    if (j < steps) fetch(j, wr[j]);  // in flight during the LayerNorm
  cp_async_wait<0>();
  __syncthreads();

  // 2. LayerNorm in place, one warp per row: mean, then the mean square of
  //    x - mean, both in f32, then the affine map and one rounding
  for (int r = warp; r < BM; r += WARPS) {
    __nv_bfloat16* row = sA + r * SA;
    float sum = 0.f;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&row[c]));
      sum += f.x + f.y;
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&row[c]));
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / D + eps);
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&row[c]));
      const float2 g = *reinterpret_cast<const float2*>(&ln_w[c]);
      const float2 b = *reinterpret_cast<const float2*>(&ln_b[c]);
      *reinterpret_cast<uint32_t*>(&row[c]) =
          pack_bf16((f.x - mean) * rstd * g.x + b.x, (f.y - mean) * rstd * g.y + b.y);
    }
  }
  if (steps > 0) stash(0, wr[0]);
  __syncthreads();

  // 3. y = xn . W^T + wb, one 64-column output tile after another
  const int g = lane / 4, t = lane % 4;
  const int a_row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);
  float acc[BN / 8][4];
  // unrolled by DEPTH so that every register set has a compile-time index:
  // step i multiplies tile i, fetches tile i + DEPTH - 1 into the set tile
  // i - 1 left, and stashes tile i + 1, fetched DEPTH - 2 steps earlier
  for (int i0 = 0; i0 < steps; i0 += DEPTH)
#pragma unroll
  for (int u = 0; u < DEPTH; ++u) {
    const int i = i0 + u;
    if (i >= steps) break;
    const int kt = i % k_tiles;
    if (kt == 0) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    if (i + DEPTH - 1 < steps) fetch(i + DEPTH - 1, wr[(u + DEPTH - 1) % DEPTH]);
    const __nv_bfloat16* tW = sW + (i % 2) * BN * W_STRIDE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, &sA[a_row * SA + kt * BK + kk * 16 + a_col]);
#pragma unroll
      for (int n2 = 0; n2 < BN / 16; ++n2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &tW[(n2 * 16 + b_row) * W_STRIDE + kk * 16 + b_col]);
        mma_bf16(acc[2 * n2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
    // the other buffer was last read in step i - 1, before that step's barrier
    if (i + 1 < steps) stash((i + 1) % 2, wr[(u + 1) % DEPTH]);
    if (kt == k_tiles - 1) {
      const int n0 = (nt_begin + i / k_tiles) * BN;
      const long ra = row0 + warp * 16 + g, rb = ra + 8;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int col = n0 + n * 8 + 2 * t;
        if (col >= O) continue;
        const float b0 = wb[col], b1 = wb[col + 1];
        if (ra < M)
          *reinterpret_cast<uint32_t*>(&y[ra * O + col]) = pack_bf16(acc[n][0] + b0, acc[n][1] + b1);
        if (rb < M)
          *reinterpret_cast<uint32_t*>(&y[rb * O + col]) = pack_bf16(acc[n][2] + b0, acc[n][3] + b1);
      }
    }
    __syncthreads();
  }
}

template <int BM>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* wb,
           void* y, int M, int D, int O, float eps, cudaStream_t stream) {
  auto kernel = ln_linear_kernel<BM>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, SMEM_MAX, allowed);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // one CTA fits an SM: split the columns until there are about four waves
  const long row_tiles = (M + BM - 1) / BM;
  const int n_tiles = (O + BN - 1) / BN;
  const long want = (4L * sms + row_tiles - 1) / row_tiles;
  const int n_splits = (int)(want < n_tiles ? want : n_tiles);
  const long blocks = row_tiles * n_splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, BM * 2, smem_bytes<BM>(D), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w),
      static_cast<const float*>(wb), static_cast<__nv_bfloat16*>(y), M, D, O, eps, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int latteclip_ln_linear(const void* x, const void* ln_w, const void* ln_b,
                                   const void* w, const void* wb, void* y, int M, int D, int O,
                                   float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || O <= 0 || D % BK || O % 8) return (int)cudaErrorInvalidValue;
  if (smem_bytes<128>(D) <= SMEM_MAX)
    return launch<128>(x, ln_w, ln_b, w, wb, y, M, D, O, eps, s);
  if (smem_bytes<64>(D) <= SMEM_MAX) return launch<64>(x, ln_w, ln_b, w, wb, y, M, D, O, eps, s);
  return (int)cudaErrorInvalidValue;
}
