// LayerNorm then a linear layer, fused, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel latteclip_tpu/kernels/fused_ln_linear.py::_kernel:
//   latteclip_ln_linear  <- _kernel (via _fwd_pallas)
// For x [M, D] bf16 (M = B * L tokens), the LayerNorm's scale and bias
// [D] f32, the weight W [O, D] in bf16 (torch's orientation: row o holds the
// D inputs of output o; the caller rounds the f32 parameter once per
// forward, the rounding the TPU kernel applies as it reads W) and the bias
// wb [O] f32, it writes
//   xn = bf16((x - mean) / sqrt(var + eps) * scale + bias)   (f32 statistics,
//        population variance, two passes over the row, as jnp.var)
//   y  = bf16(xn . W^T + wb)                                 [M, O]
// with the product accumulated in f32 and the bias added to the f32
// accumulator before the one rounding, as the TPU kernel does (the unfused
// route rounds the product first and adds the bias in bf16).
//
// Bound. The product dominates: at the train step's pairs, vision
// 25600 x 768 -> 3072 does 121 GFLOP against 62 MB of x, W and y, ~2000
// FLOP/byte, far above the H100's ~295 at which the bf16 tensor cores (989
// TFLOP/s) rather than HBM (3.35 TB/s) become the limit. So the design feeds
// wgmma from shared memory and keeps the normalised rows on chip:
//   * one CTA owns BM rows (128, or 64 where the row does not fit): a
//     producer warp copies them in with TMA, as D / 64 panels of [BM rows x
//     64 inputs] in the 128-byte swizzle that wgmma reads (rows beyond M
//     arrive as zeros), and two consumer warpgroups (one at BM = 64) take
//     the mean and the variance of each row in f32, one warp two rows at a
//     time, and write the normalised bf16 row back in place, so xn never
//     touches device memory;
//   * the producer warp then keeps TMA copies of W tiles [BN outputs x 64
//     inputs] in flight through a ring of `stages` shared buffers, each
//     guarded by a `full` mbarrier (the copy's bytes have landed) and an
//     `empty` one (the warpgroups' products on it have retired). A stage is
//     reloaded only when the products on it retire, so the ring must cover
//     the latency of a copy from L2: at D = 512 three stages or more beat
//     two (tools/ln_linear_plans.py times the plans). At D = 768 only two
//     fit; tiles of 64 outputs with four stages were no faster there, nor
//     were two CTAs sharing each W tile by TMA multicast in a cluster (half
//     W's L2 traffic, but every stage then waits on two SMs' copies);
//   * each consumer warpgroup owns 64 rows and issues wgmma m64nBNk16, A (xn)
//     and B (the W tile) both read from shared memory through descriptors,
//     accumulating in f32 registers; it retires one stage behind the stage
//     it issues, so one W tile is in flight while the other is multiplied;
//   * after the last of the D / 64 panels it adds the f32 bias to the
//     accumulator, rounds once, and stores straight from registers, 16 bytes
//     a lane after a transpose within each quad of lanes (4-byte stores, a
//     warp's covering half of each 32-byte sector, took more of the kernel's
//     time than its products).
// Budget, per CTA (232,448 B of shared memory at most): xn takes BM * D * 2
// bytes, each stage BN * 128, plus 1 KB to align the swizzled buffers to
// 1024 B and 8 B per mbarrier. At D = 768, BM = 128, BN = 128: 196,608 +
// 2 x 16,384 + 1,024 + 40 = 230,440 B, two stages; at D = 512: 131,072 + 6
// stages; past D = 768 BM drops to 64 (six stages of 128 outputs up to D =
// 1024, two of 64 outputs up to D = 1664). One CTA fits an SM.
// The CTA walks the output tiles [nt_begin, nt_end) of its row tile: the
// launch plan (fused_ln_linear.py::ln_linear_plan) splits a row tile's
// columns over n_splits CTAs where that fills the 132 SMs in fewer waves,
// each split recomputing the cheap LayerNorm. W is read M / BM times from L2.
// No cuBLAS and no CUTLASS GEMM: TMA, mbarrier and wgmma in PTX.
//
// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape or a plan it does not take
// (D a multiple of 64, O a multiple of 8, 16-byte aligned x and W; a plan
// whose tile, stages, splits or shared memory the kernel cannot run).

#include <climits>

#include "hopper.cuh"

namespace {

using namespace latteclip;

constexpr int PANEL = 64;           // inputs per panel and per W tile (128 bytes of bf16)
constexpr int PANEL_BYTES_ROW = SW128_ROW;
constexpr int ALIGN = SW128_ALIGN;
constexpr int MAX_STAGES = 8;
constexpr int MAX_CHUNKS = 7;       // 16-byte chunks of one row a lane holds: D <= 7 * 256
constexpr int SMEM_MAX = 232448;    // shared memory a CTA can take on an H100

size_t smem_bytes(int bm, int bn, int D, int stages) {
  return ALIGN + (size_t)bm * D * 2 + (size_t)stages * bn * PANEL_BYTES_ROW + 8 * (2 * stages + 1);
}

// -- the kernel ----------------------------------------------------------------

// Byte offset of the 16-byte chunk `chunk` (8 inputs) of row r in the xn
// panels: panel chunk / 8, then the 128-byte swizzle of the chunk within its row.
template <int BM>
__device__ __forceinline__ uint32_t xn_offset(int r, int chunk) {
  return (uint32_t)(chunk / 8) * BM * PANEL_BYTES_ROW + r * PANEL_BYTES_ROW +
         (((chunk % 8) ^ (r % 8)) << 4);
}

// LayerNorm of rows r0 and r1 of the swizzled panels, in place, by one warp
// (two rows for twice the independent work and one load of the scale and
// bias): mean, then the mean square of x - mean, both in f32, then the
// affine map and one rounding to bf16.
template <int BM>
__device__ void layer_norm_rows(unsigned char* xn, int r0, int r1, int D,
                                const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                                float eps) {
  const int lane = threadIdx.x % 32;
  const int chunks = D / 8;
  const int rows[2] = {r0, r1};
  uint4 v[2][MAX_CHUNKS];
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, mean[2], rstd[2];
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q][j] = *reinterpret_cast<const uint4*>(xn + xn_offset<BM>(rows[q], c));
        const uint32_t w[4] = {v[q][j].x, v[q][j].y, v[q][j].z, v[q][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf162(w[e]));
          sum[q] += f.x + f.y;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) mean[q] = warp_sum(sum[q]) / D;
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    if (lane + 32 * j < chunks) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t w[4] = {v[q][j].x, v[q][j].y, v[q][j].z, v[q][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf162(w[e]));
          sq[q] += (f.x - mean[q]) * (f.x - mean[q]) + (f.y - mean[q]) * (f.y - mean[q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) rstd[q] = 1.f / sqrtf(warp_sum(sq[q]) / D + eps);
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
      const float4* g4 = reinterpret_cast<const float4*>(ln_w + c * 8);
      const float4* b4 = reinterpret_cast<const float4*>(ln_b + c * 8);
      const float4 g[2] = {__ldg(g4), __ldg(g4 + 1)}, b[2] = {__ldg(b4), __ldg(b4 + 1)};
      const float gs[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
      const float bs[8] = {b[0].x, b[0].y, b[0].z, b[0].w, b[1].x, b[1].y, b[1].z, b[1].w};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t w[4] = {v[q][j].x, v[q][j].y, v[q][j].z, v[q][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf162(w[e]));
          w[e] = pack_bf16((f.x - mean[q]) * rstd[q] * gs[2 * e] + bs[2 * e],
                           (f.y - mean[q]) * rstd[q] * gs[2 * e + 1] + bs[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(xn + xn_offset<BM>(rows[q], c)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// The consumer warpgroups: LayerNorm of the CTA's rows, then the products
// and the epilogue of output tiles [nt_begin, nt_end).
template <int BM, int BN>
__device__ __forceinline__ void consume(unsigned char* xn, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* xbar,
                                        const float* __restrict__ ln_w,
                                        const float* __restrict__ ln_b,
                                        const float* __restrict__ wb, __nv_bfloat16* __restrict__ y,
                                        int M, int D, int O, float eps, int row0, int nt_begin,
                                        int nt_end, int k_tiles, int stages) {
  constexpr int CONSUMERS = BM * 2;
  constexpr int STAGE_BYTES = BN * PANEL_BYTES_ROW;
  const int tid = threadIdx.x;

  // 1. LayerNorm of the CTA's rows, in place: warp w takes rows w and w +
  //    warps, then w + 2 warps and w + 3 warps, ... (BM / warps = 16 rows)
  constexpr int NW = CONSUMERS / 32;
  const int warp = tid / 32, lane = tid % 32;
  mbar_wait(xbar, 0);
  for (int r = warp; r < BM; r += 2 * NW) layer_norm_rows<BM>(xn, r, r + NW, D, ln_w, ln_b, eps);
  // the generic-proxy stores of xn, before wgmma reads them through the async proxy
  fence_proxy_async();
  named_barrier(1, CONSUMERS);

  // 2. y = xn . W^T + wb, one BN-column output tile after another
  const int wg = tid / 128;
  const uint32_t a_base = smem_addr(xn) + wg * 64 * PANEL_BYTES_ROW;
  const uint32_t ring_base = smem_addr(ring);
  const bool signals = tid % 128 == 0;  // one arrival a warpgroup on `empty`
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  const long ra = row0 + wg * 64 + (warp % 4) * 16 + lane / 4, rb = ra + 8;
  int i = 0;
  for (int nt = nt_begin; nt < nt_end; ++nt) {
    for (int kt = 0; kt < k_tiles; ++kt, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      wgmma_fence();
      const uint64_t da = sw128_desc(a_base + kt * BM * PANEL_BYTES_ROW);
      const uint64_t db = sw128_desc(ring_base + s * STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {  // 16 inputs = 32 bytes = 2 descriptor units
        if constexpr (BN == 128)
          wgmma_ss128<0>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        else
          wgmma_ss64<0>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      }
      wgmma_commit();
      if (kt > 0) {  // the previous stage's products have retired: release it
        wgmma_wait<1>();
        if (signals) mbar_arrive(&empty[(i - 1) % stages]);
      }
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(&empty[(i - 1) % stages]);
    // accumulator 4 jb + e: 8-column block jb, row ra (e < 2) or rb, columns
    // 2 (lane % 4) + e % 2. The bias joins the f32 sum before the one
    // rounding; then each quad of lanes (one row) transposes its bf16 pairs
    // so that lane t of the quad holds the 8 outputs of block 4 g + t and
    // stores them as 16 bytes: a warp writes 8 rows x 64 contiguous bytes.
    const int t = lane % 4;
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      uint32_t va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jb = 4 * g + j, col = nt * BN + jb * 8 + 2 * t;
        const float2 b = col < O ? *reinterpret_cast<const float2*>(&wb[col]) : make_float2(0.f, 0.f);
        va[j] = pack_bf16(acc[4 * jb] + b.x, acc[4 * jb + 1] + b.y);
        vb[j] = pack_bf16(acc[4 * jb + 2] + b.x, acc[4 * jb + 3] + b.y);
      }
      quad_transpose(va, lane);
      quad_transpose(vb, lane);
      const int col = nt * BN + (4 * g + t) * 8;
      if (col >= O) continue;
      if (ra < M) *reinterpret_cast<uint4*>(&y[ra * O + col]) = make_uint4(va[0], va[1], va[2], va[3]);
      if (rb < M) *reinterpret_cast<uint4*>(&y[rb * O + col]) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
    }
  }
}

// BM / 64 consumer warpgroups, then one producer warp. Block b takes row
// tile b / n_splits and its output tiles [nt_begin, nt_end) of split b % n_splits.
template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2 + 32, 1)
    ln_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const float* __restrict__ wb,
                     __nv_bfloat16* __restrict__ y, int M, int D, int O, float eps, int n_splits,
                     int stages) {
  constexpr int CONSUMERS = BM * 2;  // threads of the consumer warpgroups
  constexpr int STAGE_BYTES = BN * PANEL_BYTES_ROW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* xn = smem_raw + (((raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - raw);
  const int k_tiles = D / PANEL;
  unsigned char* ring = xn + (size_t)k_tiles * BM * PANEL_BYTES_ROW;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * STAGE_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* xbar = empty + stages;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % n_splits;
  const int row0 = (blockIdx.x / n_splits) * BM;
  const int n_tiles = (O + BN - 1) / BN;
  const int nt_begin = (int)((long)split * n_tiles / n_splits);
  const int nt_end = (int)((long)(split + 1) * n_tiles / n_splits);
  const int steps = (nt_end - nt_begin) * k_tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BM / 64);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(xbar, (uint32_t)BM * D * 2);
      for (int kt = 0; kt < k_tiles; ++kt)
        tma_load(xn + (size_t)kt * BM * PANEL_BYTES_ROW, &x_map, xbar, kt * PANEL, row0);
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(ring + (size_t)s * STAGE_BYTES, &w_map, &full[s], (i % k_tiles) * PANEL,
                 (nt_begin + i / k_tiles) * BN);
      }
    }
  } else {
    consume<BM, BN>(xn, ring, full, empty, xbar, ln_w, ln_b, wb, y, M, D, O, eps, row0,
                    nt_begin, nt_end, k_tiles, stages);
  }
}

// -- host side -----------------------------------------------------------------

template <int BM, int BN>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* wb, void* y,
           int M, int D, int O, float eps, int n_splits, int stages, cudaStream_t stream) {
  auto kernel = ln_linear_kernel<BM, BN>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, SMEM_MAX, allowed);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((M + BM - 1) / BM) * n_splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {(uint64_t)D, (uint64_t)M}, w_dims[2] = {(uint64_t)D, (uint64_t)O};
  if (!tensor_map_bf16(&x_map, x, 2, x_dims, BM) || !tensor_map_bf16(&w_map, w, 2, w_dims, BN))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, BM * 2 + 32, smem_bytes(BM, BN, D, stages), stream>>>(
      x_map, w_map, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const float*>(wb), static_cast<__nv_bfloat16*>(y), M, D, O, eps, n_splits, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (bm, bn, n_splits, stages) is fused_ln_linear.py::ln_linear_plan:
// tiles (128, 128), (64, 128) or (64, 64), 2..8 stages, 1..ceil(O / bn)
// splits, within a CTA's shared memory.
extern "C" int latteclip_ln_linear(const void* x, const void* ln_w, const void* ln_b,
                                   const void* w, const void* wb, void* y, int M, int D, int O,
                                   float eps, int bm, int bn, int n_splits, int stages,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || O <= 0 || D % PANEL || O % 8 || D > MAX_CHUNKS * 256 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  if ((bm != 128 && bm != 64) || (bn != 128 && bn != 64) || stages < 2 || stages > MAX_STAGES ||
      n_splits < 1 || n_splits > (O + bn - 1) / bn || smem_bytes(bm, bn, D, stages) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch<128, 128>(x, ln_w, ln_b, w, wb, y, M, D, O, eps, n_splits, stages, s);
  if (bm == 64 && bn == 128)
    return launch<64, 128>(x, ln_w, ln_b, w, wb, y, M, D, O, eps, n_splits, stages, s);
  if (bm == 64 && bn == 64)
    return launch<64, 64>(x, ln_w, ln_b, w, wb, y, M, D, O, eps, n_splits, stages, s);
  return (int)cudaErrorInvalidValue;
}
