// Forward flash attention for the CLIP towers on Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of latteclip_tpu/kernels/attention.py:
//   latteclip_flash_fwd      <- _fwd_kernel      (whole-row, optional causal)
//   latteclip_flash_fwd_seg  <- _fwd_kernel_seg  (segment-masked rows, optional causal)
//   latteclip_flash_fwd_hs   <- _fwd_kernel_hs   (head-split: whole-row, lse2 per head group)
//   latteclip_flash_fwd_bd   <- _fwd_kernel_bd   (block-diagonal: rows <= 128, own rounding)
// All compute, per (row b, head h), base-2 softmax attention straight from
// the packed in-projection output qkv [B, L, 3*H*D] (laid out [q | k | v],
// bf16) and write out [B, L, H*D] bf16 plus the base-2 logsumexp lse2 f32
// that the backward kernels will consume: [B, H, L], or for the head-split
// kernel [H/HP, HP, B, L], which is [H, B, L] in memory.
//
// Numerics follow the TPU kernel step by step: q is scaled by
// D^-1/2 * log2(e) in f32 and rounded to bf16; scores accumulate in f32;
// masked entries get -1e9; p = exp2(s - m) is rounded to bf16; the
// denominator is the f32 sum of those bf16 values; out = (P V in f32) / l.
// p is rounded against the maximum of the whole row, as on the TPU (an
// online softmax would round it against a running maximum and move lse2 by
// up to ~2e-3). Only the f32 summation order differs (and, on the long
// rows, exp2 is ex2.approx, ~2^-22 relative, well below p's bf16 rounding).
//
// The head-split kernel computes the same function. On the TPU its grid
// also ranges over groups of HP = 128/D heads so that each program copies
// only those heads' lanes, and it stores lse2 per head group; here every CTA
// already reads one head's columns only, so the port keeps the
// per-(row, head) CTAs and changes only where lse2 is stored.
//
// The block-diagonal kernel (rows of at most 128 tokens) rounds as the TPU's
// _fwd_kernel_bd does: p = exp2(s - m) stays f32, l is the f32 sum of the
// unrounded p, pb = bf16(p / l) feeds the PV product, and out is that
// product rounded, with no division after it. The TPU kernel folds every
// head into one product against block-diagonal K and V copies to hide its
// matrix unit's latency; that is a device of the TPU, so the port computes
// the same function on the one-CTA-per-(row, head) short-row design, where
// a warp holds its rows' every score in registers and l is complete before
// p is rounded (the short-row ring below was 4-27% slower with this
// rounding at head width 64, PERF.md).
//
// Bound. Every case the towers give these kernels is memory-bound: text at
// B=1000, L=77, H=8, D=64 does 12.1 GFLOP (4*B*H*L^2*D) against about
// 318 MB read and written, 38 FLOP/byte; ViT-B/16 vision at [64, 197, 12 x
// 64] does 11.5 GFLOP with the scores computed twice against 77.5 MB, 148
// FLOP/byte; both sit below the ~295 FLOP/byte at which an H100's bf16
// tensor cores (989 TFLOP/s) rather than its memory (3.35 TB/s) become the
// limit. So the design goal is to read q, k and v of each (row, head) once
// from device memory, to keep scores and probabilities on chip, and to keep
// copies in flight while the tensor cores work:
//   * rows of at most 128 tokens (ViT-B/32 vision at 50, its image pairs at
//     100, packed text at 128) take flash_fwd_ring_kernel: persistent CTAs,
//     each walking (row, head) items with one producer warp that keeps the
//     items' Q, K and V in flight by TMA (boxes of 64 or 128 token rows, zeros
//     past L, in the 128-byte swizzle) through a ring of full/empty mbarrier
//     slots, and one consumer warpgroup per 64 query rows that takes S = Qs
//     K^T and P V with wgmma, Qs and p in registers, K and V (MN-major) in
//     shared memory. Every score of a row stays in registers, so the row
//     maximum is exact in one pass; the slot is released when P V retires,
//     so the next item's copy overlaps the epilogue. An item's time is one
//     chain of products, masks and exp2 per warpgroup, so the time falls
//     with the warpgroups an SM holds: the launch plan
//     (attention.py::short_row_plan) runs as many CTAs an SM as the
//     registers allow (four of one warpgroup at D=64, two of two), with one
//     stage each, and every wgmma has a fixed shape (a wgmma behind a branch
//     made ptxas serialise them all). Rows of 65..96 tokens (text at 77),
//     and the block-diagonal kernel's rows, keep flash_fwd_kernel, one CTA
//     per (row, head) with one warp per 16 query rows and K and V of the
//     row in shared memory: at 65..96 tokens the ring's second warpgroup
//     would spend most of its work on padding;
//   * longer rows (ViT-B/16 at 197, 336 px at 577) take flash_fwd_long_kernel.
//     Its CTA holds K and V of the whole row in shared memory (the
//     "resident" form: 59,904 B at D=64, L=197; 113,152 B at D=128, L=197;
//     170,496 B at D=64, L=577) and its warps walk 16-row query blocks over
//     them, so that K and V are read once per CTA, not once per 64-row query
//     tile as in the first port (8x K's bytes and 4x V's at L=197, 20x and
//     10x at L=577), and a ragged row costs 16-row granularity (208 rows of
//     products at L=197, not 256). K is copied in 64-key stages, each its
//     own cp.async group, so the first pass (the exact row maxima) starts on
//     the first keys while the rest land; V is committed last and lands
//     behind that pass. Where K and V do not fit (D=128 beyond 384 tokens,
//     D=64 beyond about 800) the same kernel streams them through a ring of
//     two 64-key slots (the "streamed" form): every warp of the CTA walks the
//     key tiles in step, the copy of the next tile overlapping the products
//     of this one, K once for the maxima and K with V again for p and P V;
//   * the launch plan (attention.py::long_row_plan) picks the form, the warps
//     of a CTA (warp w takes the 16-row blocks w, w + warps, ...) and the
//     CTAs per (row, head). The time falls with the warps an SM holds, up to
//     the 16 that 128 registers a thread allow: 8 a CTA where two CTAs fit an
//     SM's shared memory (D=64, L=197), else up to 16. A (row, head) is split
//     across CTAs only where B * H would leave half the SMs idle: each split
//     reads K and V again from L2, and at [8, 577, 16] (128 pairs for 132
//     SMs) one CTA of 16 warps a pair beat three of 12;
//   * each warp takes 32 keys (D=64) or 64 keys (D=128) of its block at a
//     time, so that several mma chains are in flight; at D=64 it keeps its Q
//     fragments in registers, at D=128 it re-reads them from shared memory at
//     every k-step (acc alone takes 64 registers there);
//   * p = exp2(s - m) on the SFU (ex2.approx, ~2^-22 relative, well below
//     p's bf16 rounding), and l by one more mma, P times a column of ones:
//     the f32 sum of the bf16 p without unpacking them;
//   * Q, K and V move with 16-byte cp.async copies; the ragged edge is
//     zero-filled to a multiple of 16 keys and masked, so keys beyond L
//     contribute exactly 0; blocks of 16 keys past the edge are skipped;
//   * the long-row and one-CTA kernels run their products on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); shared-memory
//     rows are padded by 16 bytes so that the ldmatrix reads are free of
//     bank conflicts; the output goes back through shared memory so that it
//     too is stored 16 bytes a thread (the ring stores 16 bytes a lane after
//     a transpose within each quad of lanes);
//   * causal CTAs stop at the last key their rows can see; every causal or
//     segment row keeps its own diagonal, so its maximum is finite.
// What bounds the long-row kernel is not settled (no profiler runs on the
// card): it reaches a third of its memory bound at ViT-B/16's rows and a
// sixth at 577 tokens (PERF.md), and computes every score twice. Trial
// builds that dropped the first pass or the exp2, prefetched the next (row,
// head) into a second buffer, or gave each warp 32-row tiles (half the
// ldmatrix reads) were not faster. wgmma, TMA multicast across a cluster
// and warp specialisation are left for later work on the long rows.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape or
// plan it does not take.

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace latteclip;
using bf16 = __nv_bfloat16;

constexpr int SHORT_ROW = 128;  // rows up to this many tokens stay whole in one key tile
constexpr int SHORT_THREADS = 2 * SHORT_ROW;  // one warp per 16 query rows
constexpr int TILE = 64;            // keys per copy stage and per ring slot, long rows
constexpr int LONG_MAX_WARPS = 16;  // 128 registers a thread
constexpr int STREAM_SLOTS = 2;     // ring slots of the streamed form
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a CTA may use on an H100
constexpr float MASKED = -1e9f;

// ---- rows of at most 128 tokens ---------------------------------------------

// Shared memory of the short-row kernel: seg ids, then Q (later the output), K, V.
template <int D, int BLOCK_N>
constexpr size_t short_smem_bytes(int L) {
  return BLOCK_N * sizeof(int) + (size_t)3 * round16(L) * (D + 8) * 2;
}

// One CTA per (row, head), one warp per 16 query rows, one key tile of
// BLOCK_N keys (64 for rows of up to 64 tokens, 128 up to 128). Registers
// are held to 128 a thread (two CTAs in flight on an SM), except for 64-key
// tiles at D=128. BD selects the block-diagonal kernel's rounding.
// lse2[b, h, l] is stored at lse[b * lse_b + h * lse_h + l].
template <int D, int BLOCK_N, bool SEG, bool CAUSAL, bool BD>
__global__ void __launch_bounds__(SHORT_THREADS, D == 64 || BLOCK_N == SHORT_ROW ? 2 : 1)
    flash_fwd_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                     bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                     float qscale, long lse_b, long lse_h) {
  constexpr int STRIDE = D + 8;   // padded shared row, in bf16 elements
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row of one head
  constexpr int KSTEPS = D / 16;  // mma k-steps over the head dimension
  constexpr int NT = BLOCK_N / 8; // 8-key score tiles per key tile
  constexpr int DT = D / 8;       // 8-wide output tiles

  const int rows = round16(L);    // query and key rows held, zero-filled past L
  extern __shared__ __align__(16) unsigned char smem[];
  int* sSeg = reinterpret_cast<int*>(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + BLOCK_N * sizeof(int));
  bf16* sK = sQ + rows * STRIDE;
  bf16* sV = sK + rows * STRIDE;

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int HD = H * D;
  const long tok_stride = 3L * HD;  // elements between consecutive tokens
  const bf16* qbase = qkv + (long)b * L * tok_stride + (long)h * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within the warp's 16 rows
  const int t = lane % 4;  // fragment column pair
  const int row_a = warp * 16 + g;
  const int row_b = row_a + 8;

  // Copy n token rows (one head's columns at offset ofs) into dst, 16 bytes
  // a thread at a time; rows beyond L are zero-filled.
  auto copy_rows = [&](bf16* dst, int n, long ofs) {
    for (int c = tid; c < n * CHUNKS; c += blockDim.x) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      const bool valid = r < L;
      cp_async_16(&dst[r * STRIDE + col], qbase + (long)(valid ? r : 0) * tok_stride + ofs + col,
                  valid);
    }
  };

  int seg_a = 0, seg_b = 0;
  if (SEG) {
    seg_a = row_a < L ? seg[(long)b * L + row_a] : -1;
    seg_b = row_b < L ? seg[(long)b * L + row_b] : -1;
  }

  // Q and K in one copy group, V in another that lands behind the scores;
  // the keys' seg ids are fetched once the copies are in flight.
  copy_rows(sQ, rows, 0);
  copy_rows(sK, rows, HD);
  if (SEG)
    for (int i = tid; i < BLOCK_N; i += blockDim.x) sSeg[i] = i < L ? seg[(long)b * L + i] : -2;
  cp_async_commit();
  copy_rows(sV, rows, 2L * HD);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q fragments of this warp's 16 rows, scaled by qscale in f32 and rounded
  // to bf16, as the TPU kernel scales q.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldmatrix_x4(qf[kk], &sQ[(warp * 16 + a_row(lane)) * STRIDE + kk * 16 + a_col(lane)]);
#pragma unroll
    for (int e = 0; e < 4; ++e) qf[kk][e] = scale_bf16x2(qf[kk][e], qscale);
  }

  // s = Qs K^T for this warp's 16 rows and every key, masked.
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int n2 = 0; n2 < NT / 2; ++n2) {
    if (n2 * 16 >= rows) break;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, &sK[(n2 * 16 + b_row(lane)) * STRIDE + kk * 16 + b_col(lane)]);
      mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
    }
  }
  if (CAUSAL || SEG || L < BLOCK_N) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        bool visible = j < L;
        if (CAUSAL) visible = visible && j <= (e < 2 ? row_a : row_b);
        if (SEG) visible = visible && sSeg[j] == (e < 2 ? seg_a : seg_b);
        if (!visible) s[n][e] = MASKED;
      }
    }
  }

  // The row maxima over every key, as the TPU kernel takes them over its
  // whole row, so that p is rounded against the same maximum.
  const float neg_inf = __int_as_float(0xff800000);
  float m_row[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m_row[0] = fmaxf(m_row[0], fmaxf(s[n][0], s[n][1]));
    m_row[1] = fmaxf(m_row[1], fmaxf(s[n][2], s[n][3]));
  }
  m_row[0] = quad_max(m_row[0]);
  m_row[1] = quad_max(m_row[1]);

  // p = bf16(exp2(s - m)), l = sum of those bf16 values, acc = P V.
  // With BD: p = exp2(s - m) in f32, l = its sum, pb = bf16(p / l).
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pf[NT / 2][4];  // p packed straight into mma A fragments
  if constexpr (BD) {
    // 8-key tiles past the row's last block of 16 keys hold masked scores
    // only: p is 0 there, with no exp2 and no division
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = n * 8 < rows ? exp2f(s[n][e] - m_row[e / 2]) : 0.f;
        l_run[e / 2] += s[n][e];
      }
    float rcp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = quad_sum(l_run[r]);
      rcp[r] = __frcp_rn(l_run[r]);
    }
    // p / l correctly rounded, as IEEE division gives it, from the row's
    // correctly rounded reciprocal and one exact FMA residual (Markstein):
    // three instructions an element in place of a division each
    auto divide = [&](float p, int r) {
      const float q = p * rcp[r];
      return fmaf(fmaf(-q, l_run[r], p), rcp[r], q);
    };
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 >= rows) {
        pf[n / 2][(n % 2) * 2 + 0] = pf[n / 2][(n % 2) * 2 + 1] = 0u;
        continue;
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(divide(s[n][0], 0), divide(s[n][1], 0));
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(divide(s[n][2], 1), divide(s[n][3], 1));
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat162 pa =
          __floats2bfloat162_rn(exp2f(s[n][0] - m_row[0]), exp2f(s[n][1] - m_row[0]));
      const __nv_bfloat162 pb =
          __floats2bfloat162_rn(exp2f(s[n][2] - m_row[1]), exp2f(s[n][3] - m_row[1]));
      const float2 fa = __bfloat1622float2(pa);
      const float2 fb = __bfloat1622float2(pb);
      l_run[0] += fa.x + fa.y;
      l_run[1] += fb.x + fb.y;
      pf[n / 2][(n % 2) * 2 + 0] = as_u32(pa);
      pf[n / 2][(n % 2) * 2 + 1] = as_u32(pb);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk * 16 >= rows) break;  // p is exactly 0 there
#pragma unroll
    for (int d2 = 0; d2 < DT / 2; ++d2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, &sV[(kk * 16 + a_row(lane)) * STRIDE + d2 * 16 + a_col(lane)]);
      mma_bf16(acc[2 * d2], pf[kk], vf[0], vf[1]);
      mma_bf16(acc[2 * d2 + 1], pf[kk], vf[2], vf[3]);
    }
  }
  if constexpr (!BD) {
    l_run[0] = quad_sum(l_run[0]);
    l_run[1] = quad_sum(l_run[1]);
  }

  // out = acc / l (with BD, acc as it is) in bf16, through this warp's own
  // 16 rows of sQ, then stored 16 bytes a thread.
  bf16* sO = sQ + warp * 16 * STRIDE;
  auto finish = [&](float a, float l) { return BD ? a : a / l; };
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(&sO[g * STRIDE + col]) =
        __floats2bfloat162_rn(finish(acc[d][0], l_run[0]), finish(acc[d][1], l_run[0]));
    *reinterpret_cast<__nv_bfloat162*>(&sO[(g + 8) * STRIDE + col]) =
        __floats2bfloat162_rn(finish(acc[d][2], l_run[1]), finish(acc[d][3], l_run[1]));
  }
  __syncwarp();
  bf16* obase = out + (long)b * L * HD + (long)h * D;
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const int row = warp * 16 + r;
    if (row < L)
      *reinterpret_cast<uint4*>(obase + (long)row * HD + col) =
          *reinterpret_cast<const uint4*>(&sO[r * STRIDE + col]);
  }
  if (t == 0) {
    float* lbase = lse + b * lse_b + h * lse_h;
    if (row_a < L) lbase[row_a] = m_row[0] + log2f(l_run[0]);
    if (row_b < L) lbase[row_b] = m_row[1] + log2f(l_run[1]);
  }
}

// ---- rows of at most 128 tokens: persistent CTAs fed by a TMA ring ----------

constexpr int RING_MAX_STAGES = 4;

// Shared memory of the ring kernel (attention.py::short_row_smem_bytes
// mirrors it): 1 KB to align the swizzled tiles, then per stage Q, K and V of
// one (row, head), D / 64 panels of `box` token rows x 128 B each, then the
// stages' seg ids (SEG) and the full and empty mbarriers.
template <int D>
constexpr size_t ring_smem_bytes(int box, int stages, bool seg) {
  return SW128_ALIGN + (size_t)stages * (3 * D * box * 2 + (seg ? box * 4 : 0)) + 16 * (size_t)stages;
}

// CTAs an SM that the ring kernel's registers must allow: the time of a
// ring falls with the warpgroups an SM holds (each item's products, masks
// and exp2 are one dependent chain per warpgroup), so at D = 64 one
// warpgroup's CTAs take at most 102 registers a thread (four an SM) and two
// warpgroups' at most 112 (two an SM, though ptxas then serialises the
// wgmma for want of registers: still faster than one CTA); at D = 128 one
// warpgroup's take two an SM and two warpgroups' one.
__host__ __device__ constexpr int ring_min_ctas(int D, int NWG) {
  return NWG == 1 ? (D == 64 ? 4 : 2) : (D == 64 ? 2 : 1);
}

// NWG consumer warpgroups (one for rows of at most 64 tokens, two up to 128),
// each owning 64 query rows, then one producer warp. CTA x takes the (row,
// head) items x, x + gridDim.x, ...; the producer keeps them in flight
// through `stages` ring slots, each holding Q, K and V of one item as TMA
// boxes of 64 * NWG token rows (zeros past L) in the 128-byte swizzle. Per
// item a warpgroup loads its Q fragments (scaled by qscale in f32, rounded
// to bf16), takes S = Qs K^T with wgmma (Qs in registers, K from shared
// memory, every key of the box), masks S, takes the exact row maxima in
// registers, forms p (exp2 only on the 16-key chunks its rows can see), and
// takes P V with a second wgmma (p repacked in registers as A, V read
// MN-major). It releases the slot as
// soon as P V has retired, then stores out and lse2 from registers, so the
// producer refills the slot while the epilogue runs. lse2[b, h, l] is
// stored at lse[b * lse_b + h * lse_h + l].
template <int D, int NWG, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(NWG * 128 + 32, ring_min_ctas(D, NWG))
    flash_fwd_ring_kernel(const __grid_constant__ CUtensorMap qkv_map, const int* __restrict__ seg,
                          bf16* __restrict__ out, float* __restrict__ lse, int B, int L, int H,
                          float qscale, long lse_b, long lse_h, int stages) {
  constexpr int BOX = 64 * NWG;           // token rows of a box
  constexpr int P = D / 64;               // 64-value panels of one head
  constexpr int PANEL = BOX * SW128_ROW;  // bytes of one panel
  constexpr int TILE_BYTES = P * PANEL;   // Q, K or V of one item
  constexpr int STAGE = 3 * TILE_BYTES;
  constexpr int CONSUMERS = NWG * 128;
  constexpr int KSTEPS = D / 16;
  constexpr int CHUNKS = BOX / 16;        // 16-key chunks of a box

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  int* sseg = reinterpret_cast<int*>(ring + (size_t)stages * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sseg + (SEG ? stages * BOX : 0));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int items = B * H;
  const int HD = H * D;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    const int lane = tid % 32;
    int n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int s = n % stages;
      if (n >= stages) mbar_wait(&empty[s], (n / stages - 1) & 1);
      const int b = item / H, h = item % H;
      if (SEG) {  // the item's seg ids, -2 past L, by the warp's lanes
        for (int i = lane; i < BOX; i += 32) sseg[s * BOX + i] = i < L ? seg[(long)b * L + i] : -2;
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* dst = ring + (size_t)s * STAGE;
        for (int part = 0; part < 3; ++part)  // q, k, v
          for (int p = 0; p < P; ++p)
            tma_load_3d(dst + part * TILE_BYTES + p * PANEL, &qkv_map, &full[s], part * HD + h * D + p * 64,
                        0, b);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = wg * 64 + (warp % 4) * 16 + g, row_b = row_a + 8;
  const int rows = round16(L);
  // the 16-key chunks this warpgroup's rows can see; causal rows stop at the diagonal
  const int nch = (CAUSAL ? min(rows, (wg + 1) * 64) : rows) / 16;
  const int qr = wg * 64 + (warp % 4) * 16 + a_row(lane);  // this lane's ldmatrix row of Q
  const uint32_t ring_base = smem_addr(ring);
  const float neg_inf = __int_as_float(0xff800000);

  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int s = n % stages;
    const int b = item / H, h = item % H;
    const uint32_t qbase = ring_base + s * STAGE, kbase = qbase + TILE_BYTES, vbase = kbase + TILE_BYTES;
    const int* ss = sseg + s * BOX;
    mbar_wait(&full[s], (n / stages) & 1);

    // Q fragments of this warp's 16 rows, scaled by qscale in f32 and rounded
    // to bf16, as the TPU kernel scales q.
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldmatrix_x4_at(qf[kk], qbase + (kk / 4) * PANEL + sw128_offset(qr, (kk % 4) * 2 + lane / 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[kk][e] = scale_bf16x2(qf[kk][e], qscale);
    }

    // S = Qs K^T over the box's keys, 64 keys (one accumulator half) at a
    // time. Every wgmma of the item has a fixed shape and runs unconditionally:
    // a wgmma behind a branch or of a shape chosen at run time makes ptxas
    // serialise the pipeline. Keys past the visible ones are zeros or masked.
    float sc[NWG][32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t kp = kbase + (kk / 4) * PANEL;
#pragma unroll
      for (int hk = 0; hk < NWG; ++hk)
        wgmma_rs64<0>(sc[hk], qf[kk], sw128_desc(kp + hk * 64 * SW128_ROW) + 2 * (kk % 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // Masks and the exact row maxima over every key.
    int seg_a = 0, seg_b = 0;
    if (SEG) {
      seg_a = row_a < L ? ss[row_a] : -1;
      seg_b = row_b < L ? ss[row_b] : -1;
    }
    float m_row[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int hk = 0; hk < NWG; ++hk)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int j0 = hk * 64 + jb * 8 + 2 * t;  // this lane's two keys of the block
        int2 sk = make_int2(0, 0);
        if (SEG) sk = *reinterpret_cast<const int2*>(&ss[j0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + (e & 1);
          bool visible = j < L;
          if (CAUSAL) visible = visible && j <= (e < 2 ? row_a : row_b);
          if (SEG) visible = visible && (e & 1 ? sk.y : sk.x) == (e < 2 ? seg_a : seg_b);
          if (!visible) sc[hk][4 * jb + e] = MASKED;
          m_row[e / 2] = fmaxf(m_row[e / 2], sc[hk][4 * jb + e]);
        }
      }
    m_row[0] = quad_max(m_row[0]);
    m_row[1] = quad_max(m_row[1]);

    // p = bf16(exp2(s - m)), l = the f32 sum of those bf16 values. Chunks
    // past the visible ones hold masked scores only: p is 0 there.
    float l_run[2] = {0.f, 0.f};
    uint32_t pf[CHUNKS][4];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = (c % 4) * 8 + half * 4;
        __nv_bfloat162 pa = __floats2bfloat162_rn(0.f, 0.f), pb = pa;
        if (c < nch) {
          pa = __floats2bfloat162_rn(exp2f(sc[c / 4][i] - m_row[0]), exp2f(sc[c / 4][i + 1] - m_row[0]));
          pb = __floats2bfloat162_rn(exp2f(sc[c / 4][i + 2] - m_row[1]), exp2f(sc[c / 4][i + 3] - m_row[1]));
        }
        const float2 fa = __bfloat1622float2(pa), fb = __bfloat1622float2(pb);
        l_run[0] += fa.x + fa.y;
        l_run[1] += fb.x + fb.y;
        pf[c][half * 2 + 0] = as_u32(pa);
        pf[c][half * 2 + 1] = as_u32(pb);
      }

    // acc = P V over the box's keys (p is 0 past the visible ones): V is the
    // MN-major B, 16 key rows a k-step.
    float acc[D / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const uint64_t db = sw128_mn_desc(vbase + c * 16 * SW128_ROW, PANEL);
      if constexpr (D == 64)
        wgmma_rs64<1>(acc, pf[c], db, c > 0);
      else
        wgmma_rs128<1>(acc, pf[c], db, c > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (tid % 128 == 0) mbar_arrive(&empty[s]);  // the slot is free: the epilogue reads registers only

    // out = acc / l in bf16, 16 bytes a lane; the quotient correctly
    // rounded, as IEEE division gives it, from the row's correctly rounded
    // reciprocal and one exact FMA residual
    float rcp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = quad_sum(l_run[r]);
      rcp[r] = __frcp_rn(l_run[r]);
    }
    auto finish = [&](float a, int r) {
      const float q = a * rcp[r];
      return fmaf(fmaf(-q, l_run[r], a), rcp[r], q);
    };
    uint32_t oa[D / 8], ob[D / 8];
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      oa[jb] = pack_bf16(finish(acc[4 * jb], 0), finish(acc[4 * jb + 1], 0));
      ob[jb] = pack_bf16(finish(acc[4 * jb + 2], 1), finish(acc[4 * jb + 3], 1));
    }
    bf16* obase = out + (long)b * L * HD + (long)h * D;
    store_rows_bf16<D / 8>(oa, ob, row_a < L ? obase + (long)row_a * HD : nullptr,
                           row_b < L ? obase + (long)row_b * HD : nullptr, lane);
    if (t == 0) {
      float* lbase = lse + b * lse_b + h * lse_h;
      if (row_a < L) lbase[row_a] = m_row[0] + log2f(l_run[0]);
      if (row_b < L) lbase[row_b] = m_row[1] + log2f(l_run[1]);
    }
  }
}

// ---- rows of more than 128 tokens -------------------------------------------

// cp.async.wait_group with a count known only at run time: wait until at
// most n of this thread's copy groups are pending (at most 12: a larger n
// waits for more than it must, which is still correct).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    default: cp_async_wait<12>(); break;
  }
}

constexpr uint32_t ONES_BF16X2 = 0x3f803f80u;  // two bf16 1.0


// Shared memory of the long-row kernel: the seg ids (SEG) and K and V of the
// whole row, or of STREAM_SLOTS tiles of TILE keys, then 16 rows a warp for
// its Q block and its output. attention.py::long_row_smem_bytes mirrors it.
template <int D>
size_t long_smem_bytes(int L, int warps, bool seg, bool resident) {
  const size_t kv_rows = resident ? round16(L) : (size_t)STREAM_SLOTS * TILE;
  return (seg ? kv_rows * sizeof(int) : 0) + (2 * kv_rows + 16 * (size_t)warps) * (D + 8) * 2;
}

// CTA x of the grid is split x % splits of (row, head) x / splits; the
// split takes 16-row query blocks [split * nblk / splits, (split + 1) *
// nblk / splits), and warp w the blocks w, w + warps, ... of those. The
// launch guarantees every warp a block in its first round.
template <int D, bool SEG, bool CAUSAL, bool RESIDENT>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 1)
    flash_fwd_long_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                          bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                          float qscale, long lse_b, long lse_h, int splits) {
  constexpr int S = D + 8;        // padded shared row, in bf16 elements
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row of one head
  constexpr int KSTEPS = D / 16;  // mma k-steps over the head dimension
  constexpr int DT = D / 8;       // 8-wide output tiles
  constexpr bool Q_IN_REGS = D == 64;
  constexpr int STEP = D == 64 ? 2 : 4;  // chunks of 16 keys taken at once

  const int rows = round16(L);
  const int nblk = rows / 16;
  const int nw = blockDim.x / 32;
  const int split = blockIdx.x % splits;
  const int bh = blockIdx.x / splits;
  const int h = bh % H;
  const int b = bh / H;
  const int qb_begin = (int)((long)split * nblk / splits);
  const int qb_end = (int)((long)(split + 1) * nblk / splits);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within a 16-row block
  const int t = lane % 4;  // fragment column pair

  extern __shared__ __align__(16) unsigned char smem[];
  const int kv_rows = RESIDENT ? rows : STREAM_SLOTS * TILE;
  int* sSeg = reinterpret_cast<int*>(smem);  // the seg ids of the keys in sK
  bf16* sK = reinterpret_cast<bf16*>(smem + (SEG ? kv_rows * sizeof(int) : 0));
  bf16* sV = sK + kv_rows * S;
  bf16* sW = sV + kv_rows * S + warp * 16 * S;  // this warp's Q block, then its output

  const int HD = H * D;
  const long tok = 3L * HD;  // elements between consecutive tokens
  const bf16* base = qkv + (long)b * L * tok + (long)h * D;

  // Copy n token rows from r0 on (one head's columns at offset ofs) into dst,
  // 16 bytes a thread, threads i0, i0 + step, ...; rows from L on are zero-filled.
  auto copy_rows = [&](bf16* dst, int r0, int n, long ofs, int i0, int step) {
    for (int c = i0; c < n * CHUNKS; c += step) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      const bool valid = r0 + r < L;
      cp_async_16(&dst[r * S + col], base + (long)(valid ? r0 + r : 0) * tok + ofs + col, valid);
    }
  };
  auto copy_q = [&](int qb) { copy_rows(sW, qb * 16, 16, 0, lane, 32); };

  // seg ids of the n keys from j0 into sSeg from slot0 on (-2 past L)
  auto load_seg = [&](int slot0, int j0, int n) {
    for (int i = tid; i < n; i += blockDim.x)
      sSeg[slot0 + i] = j0 + i < L ? seg[(long)b * L + j0 + i] : -2;
  };

  // State of the warp's current 16-row query block.
  int r0 = 0, n_chunks = 0, seg_a = 0, seg_b = 0;
  const float neg_inf = __int_as_float(0xff800000);
  float m_row[2], l_acc[4], acc[DT][4];
  uint32_t qf[KSTEPS][4];
  auto begin_block = [&](int qb) {
    r0 = qb * 16;
    n_chunks = CAUSAL ? (min(L, r0 + 16) + 15) / 16 : nblk;
    if (SEG) {
      seg_a = r0 + g < L ? seg[(long)b * L + r0 + g] : -1;
      seg_b = r0 + g + 8 < L ? seg[(long)b * L + r0 + g + 8] : -1;
    }
    m_row[0] = m_row[1] = neg_inf;
    l_acc[0] = l_acc[1] = l_acc[2] = l_acc[3] = 0.f;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  };
  // Once the Q block has landed in sW: scale it in place by qscale in f32,
  // rounded to bf16, as the TPU kernel scales q; at D=64 keep its fragments.
  auto prepare_q = [&]() {
    for (int c = lane; c < 16 * D / 2; c += 32) {
      uint32_t* p = reinterpret_cast<uint32_t*>(&sW[(c / (D / 2)) * S + (c % (D / 2)) * 2]);
      *p = scale_bf16x2(*p, qscale);
    }
    __syncwarp();
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], &sW[a_row(lane) * S + kk * 16 + a_col(lane)]);
    }
  };

  // s = Qs K^T for the N chunks of 16 keys from key0, whose rows start at
  // kp; masked. N chunks at once give 2N independent mma chains.
  auto scores = [&](const bf16* kp, int key0, auto& s) {
    constexpr int N = std::extent<std::remove_reference_t<decltype(s)>>::value;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, &sW[a_row(lane) * S + kk * 16 + a_col(lane)]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &kp[(i * 16 + b_row(lane)) * S + kk * 16 + b_col(lane)]);
        mma_bf16(s[i][0], a, kf[0], kf[1]);
        mma_bf16(s[i][1], a, kf[2], kf[3]);
      }
    }
    if (!CAUSAL && !SEG && key0 + 16 * N <= L) return;  // every key visible
    const int* segp = sSeg + (kp - sK) / S;  // the seg id of key key0 + x is segp[x]
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = key0 + i * 16 + n * 8 + 2 * t + (e & 1);
          const int row = r0 + g + (e < 2 ? 0 : 8);
          bool visible = j < L;
          if (CAUSAL) visible = visible && j <= row;
          if (SEG) visible = visible && segp[j - key0] == (e < 2 ? seg_a : seg_b);
          if (!visible) s[i][n][e] = MASKED;
        }
  };
  // Pass 1, N chunks: the row maxima.
  auto max_step = [&](auto n_chunks_tag, const bf16* kp, int key0) {
    constexpr int N = decltype(n_chunks_tag)::value;
    float s[N][2][4];
    scores(kp, key0, s);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        m_row[0] = fmaxf(m_row[0], fmaxf(s[i][n][0], s[i][n][1]));
        m_row[1] = fmaxf(m_row[1], fmaxf(s[i][n][2], s[i][n][3]));
      }
  };
  auto end_max = [&]() {
    m_row[0] = quad_max(m_row[0]);
    m_row[1] = quad_max(m_row[1]);
  };
  // Pass 2, N chunks: p = bf16(exp2(s - m)), l += those bf16 values (one
  // more mma, P times a column of ones), acc += P V.
  auto pv_step = [&](auto n_chunks_tag, const bf16* kp, const bf16* vp, int key0) {
    constexpr int N = decltype(n_chunks_tag)::value;
    float s[N][2][4];
    scores(kp, key0, s);
    uint32_t pf[N][4];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        pf[i][2 * n] = pack_bf16(exp2_approx(s[i][n][0] - m_row[0]), exp2_approx(s[i][n][1] - m_row[0]));
        pf[i][2 * n + 1] =
            pack_bf16(exp2_approx(s[i][n][2] - m_row[1]), exp2_approx(s[i][n][3] - m_row[1]));
      }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mma_bf16(l_acc, pf[i], ONES_BF16X2, ONES_BF16X2);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vp[(i * 16 + a_row(lane)) * S + d2 * 16 + a_col(lane)]);
        mma_bf16(acc[2 * d2], pf[i], vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], pf[i], vf[2], vf[3]);
      }
    }
  };
  // fn(tag, c) over the chunks [c0, c1): STEP chunks at a time, then one at a time.
  auto walk = [&](int c0, int c1, auto&& fn) {
    int c = c0;
    for (; c + STEP <= c1; c += STEP) fn(std::integral_constant<int, STEP>{}, c);
    for (; c < c1; ++c) fn(std::integral_constant<int, 1>{}, c);
  };
  auto max_at = [&](auto tag, int c) { max_step(tag, sK + c * 16 * S, c * 16); };
  auto pv_at = [&](auto tag, int c) { pv_step(tag, sK + c * 16 * S, sV + c * 16 * S, c * 16); };
  // out = acc / l in bf16 through sW, stored 16 bytes a thread, and lse2.
  auto finish_block = [&]() {
    __syncwarp();  // every lane is done reading its Q block from sW
    const float l_run[2] = {l_acc[0], l_acc[2]};  // every column of P times ones is l
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(&sW[g * S + col]) =
          __floats2bfloat162_rn(acc[d][0] / l_run[0], acc[d][1] / l_run[0]);
      *reinterpret_cast<__nv_bfloat162*>(&sW[(g + 8) * S + col]) =
          __floats2bfloat162_rn(acc[d][2] / l_run[1], acc[d][3] / l_run[1]);
    }
    __syncwarp();
    bf16* obase = out + (long)b * L * HD + (long)h * D;
    for (int c = lane; c < 16 * CHUNKS; c += 32) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      if (r0 + r < L)
        *reinterpret_cast<uint4*>(obase + (long)(r0 + r) * HD + col) =
            *reinterpret_cast<const uint4*>(&sW[r * S + col]);
    }
    if (t == 0) {
      float* lbase = lse + b * lse_b + h * lse_h;
      if (r0 + g < L) lbase[r0 + g] = m_row[0] + log2f(l_run[0]);
      if (r0 + g + 8 < L) lbase[r0 + g + 8] = m_row[1] + log2f(l_run[1]);
    }
    __syncwarp();  // sW is read; the next Q block may land there
  };

  if constexpr (RESIDENT) {
    // Keys the CTA's rows can see, copied once: the warp's first Q block and
    // K tile 0 in copy group 0, K tiles 1.. in groups 1.., V in the last.
    const int kv_end = CAUSAL ? min(L, qb_end * 16) : L;
    const int krows = round16(kv_end);
    const int n_tiles = (krows + TILE - 1) / TILE;
    int qb = qb_begin + warp;
    copy_q(qb);
    for (int kt = 0; kt < n_tiles; ++kt) {
      copy_rows(sK + kt * TILE * S, kt * TILE, min(TILE, krows - kt * TILE), HD, tid, blockDim.x);
      cp_async_commit();
    }
    copy_rows(sV, 0, krows, 2L * HD, tid, blockDim.x);
    cp_async_commit();
    if (SEG) load_seg(0, 0, rows);  // while the copies are in flight

    // First round: the maxima tile by tile, as K lands, then p and P V once
    // V has landed.
    begin_block(qb);
    for (int kt = 0; kt < n_tiles; ++kt) {
      cp_async_wait_pending(n_tiles - kt);  // groups 0..kt have landed
      __syncthreads();
      if (kt == 0) prepare_q();
      walk(kt * (TILE / 16), min((kt + 1) * (TILE / 16), n_chunks), max_at);
    }
    end_max();
    cp_async_wait<0>();
    __syncthreads();
    walk(0, n_chunks, pv_at);
    finish_block();

    // Later rounds: K and V are resident, so each warp goes on alone.
    for (qb += nw; qb < qb_end; qb += nw) {
      copy_q(qb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      begin_block(qb);
      prepare_q();
      walk(0, n_chunks, max_at);
      end_max();
      walk(0, n_chunks, pv_at);
      finish_block();
    }
  } else {
    // Streamed: per round of one block a warp, the warps walk the key tiles
    // in step through a ring of STREAM_SLOTS slots, K alone for the maxima
    // (items 0..n_tiles-1), then K and V for p and P V (items n_tiles..);
    // item i + 1 is copied while item i is used.
    for (int first = qb_begin; first < qb_end; first += nw) {
      const int qb = first + warp;
      const bool has = qb < qb_end;
      const int last_row = min(qb_end, first + nw) * 16;
      const int kv_end = CAUSAL ? min(L, last_row) : L;
      const int krows = round16(kv_end);
      const int n_tiles = (krows + TILE - 1) / TILE;
      const int n_items = 2 * n_tiles;
      auto issue = [&](int i) {
        const int kt = i % n_tiles, slot = i % STREAM_SLOTS;
        const int n = min(TILE, krows - kt * TILE);
        copy_rows(sK + slot * TILE * S, kt * TILE, n, HD, tid, blockDim.x);
        if (i >= n_tiles) copy_rows(sV + slot * TILE * S, kt * TILE, n, 2L * HD, tid, blockDim.x);
        if (SEG) load_seg(slot * TILE, kt * TILE, n);
      };
      __syncthreads();  // every warp is done with the ring
      if (has) {
        copy_q(qb);
        begin_block(qb);
      }
      issue(0);
      cp_async_commit();
      for (int i = 0; i < n_items; ++i) {
        cp_async_wait<0>();
        __syncthreads();  // item i has landed; every warp is done with item i - 1
        if (i + 1 < n_items) issue(i + 1);
        cp_async_commit();
        if (!has) continue;
        if (i == 0) prepare_q();
        const int kt = i % n_tiles, slot = i % STREAM_SLOTS;
        const bf16* kp = sK + slot * TILE * S;
        const bf16* vp = sV + slot * TILE * S;
        walk(kt * (TILE / 16), min((kt + 1) * (TILE / 16), n_chunks), [&](auto tag, int c) {
          const int local = (c - kt * (TILE / 16)) * 16 * S;
          if (i < n_tiles)
            max_step(tag, kp + local, c * 16);
          else
            pv_step(tag, kp + local, vp + local, c * 16);
        });
        if (i == n_tiles - 1) end_max();
      }
      if (has) finish_block();
    }
  }
}

// lse_head_major stores lse2 as [H, B, L] (the head-split kernel's
// [H/HP, HP, B, L]), otherwise as [B, H, L].
template <int D, int BLOCK_N, bool SEG, bool CAUSAL, bool BD>
int launch_short(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                 float qscale, bool lse_head_major, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, BLOCK_N, SEG, CAUSAL, BD>;
  // the most dynamic shared memory this instantiation can take
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, (int)short_smem_bytes<D, BLOCK_N>(BLOCK_N), allowed);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * H;
  if (B <= 0 || L <= 0 || H <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<(unsigned)blocks, 2 * round16(L), short_smem_bytes<D, BLOCK_N>(L), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), L, H, qscale, lse_b, lse_h);
  return (int)cudaGetLastError();
}

// The ring kernel on `grid` persistent CTAs with `stages` ring slots.
template <int D, int NWG, bool SEG, bool CAUSAL>
int launch_ring(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                float qscale, bool lse_head_major, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_fwd_ring_kernel<D, NWG, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_smem_bytes<D>(64 * NWG, stages, SEG);
  if (B <= 0 || H <= 0 || (long)B * H > INT_MAX || grid < 1 || stages < 1 ||
      stages > RING_MAX_STAGES || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;  // qkv as [B][L][3 * H * D]: box rows past L read as zeros
  const uint64_t dims[3] = {(uint64_t)3 * H * D, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&map, qkv, 3, dims, 64 * NWG)) return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      map, static_cast<const int*>(seg), static_cast<bf16*>(out), static_cast<float*>(lse), B, L, H,
      qscale, lse_b, lse_h, stages);
  return (int)cudaGetLastError();
}

template <int D, bool SEG, bool CAUSAL, bool RESIDENT>
int launch_long(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                float qscale, bool lse_head_major, int warps, int splits, cudaStream_t stream) {
  auto kernel = flash_fwd_long_kernel<D, SEG, CAUSAL, RESIDENT>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const int nblk = round16(L) / 16;
  const size_t smem = long_smem_bytes<D>(L, warps, SEG, RESIDENT);
  const long blocks = (long)B * H * splits;
  if (B <= 0 || H <= 0 || warps < 1 || warps > LONG_MAX_WARPS || splits < 1 ||
      warps > nblk / splits || smem > (size_t)MAX_SMEM || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), L, H, qscale, lse_b, lse_h, splits);
  return (int)cudaGetLastError();
}

// The launch plan: for rows of more than SHORT_ROW tokens (warps, splits,
// resident) of the long-row kernel; for shorter rows `warps` carries the
// ring's grid of persistent CTAs and `splits` its stages, and a grid of 0
// selects the one-CTA-per-(row, head) kernel, which the block-diagonal
// forward always takes.
template <int D, bool SEG, bool BD>
int launch_rows(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                int causal, float qscale, bool hm, int warps, int splits, int resident,
                cudaStream_t s) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  if (!BD && L <= SHORT_ROW && warps > 0) {
    const int grid = warps, stages = splits;
    if (L <= 64)
      return causal ? launch_ring<D, 1, SEG, true>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s)
                    : launch_ring<D, 1, SEG, false>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
    return causal ? launch_ring<D, 2, SEG, true>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s)
                  : launch_ring<D, 2, SEG, false>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
  }
  if (L <= TILE)
    return causal ? launch_short<D, TILE, SEG, true, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s)
                  : launch_short<D, TILE, SEG, false, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s);
  if (L <= SHORT_ROW)
    return causal ? launch_short<D, SHORT_ROW, SEG, true, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s)
                  : launch_short<D, SHORT_ROW, SEG, false, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s);
  if constexpr (BD) {
    return (int)cudaErrorInvalidValue;  // BD takes one key tile
  } else {
    if (resident)
      return causal ? launch_long<D, SEG, true, true>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, s)
                    : launch_long<D, SEG, false, true>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, s);
    return causal ? launch_long<D, SEG, true, false>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, s)
                  : launch_long<D, SEG, false, false>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, s);
  }
}

template <bool SEG, bool BD>
int dispatch(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H, int D,
             int causal, float qscale, bool lse_head_major, int warps, int splits, int resident,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_rows<64, SEG, BD>(qkv, seg, out, lse, B, L, H, causal, qscale, lse_head_major,
                                    warps, splits, resident, s);
  if (D == 128)
    return launch_rows<128, SEG, BD>(qkv, seg, out, lse, B, L, H, causal, qscale, lse_head_major,
                                     warps, splits, resident, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// warps, splits and resident: the launch plan, attention.py::long_row_plan
// for rows longer than 128 tokens; for shorter rows attention.py::short_row_plan
// gives (grid, stages, 0) of the ring kernel, or (0, 0, 0) for the
// one-CTA-per-(row, head) kernel.
extern "C" int latteclip_flash_fwd(const void* qkv, void* out, void* lse, int B, int L, int H,
                                   int D, int causal, float qscale, int warps, int splits,
                                   int resident, void* stream) {
  return dispatch<false, false>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, false, warps,
                                splits, resident, stream);
}

extern "C" int latteclip_flash_fwd_seg(const void* qkv, const void* seg, void* out, void* lse,
                                       int B, int L, int H, int D, int causal, float qscale,
                                       int warps, int splits, int resident, void* stream) {
  return dispatch<true, false>(qkv, seg, out, lse, B, L, H, D, causal, qscale, false, warps,
                               splits, resident, stream);
}

// lse2 as [H/HP, HP, B, L], which is [H, B, L] in memory
extern "C" int latteclip_flash_fwd_hs(const void* qkv, void* out, void* lse, int B, int L, int H,
                                      int D, int causal, float qscale, int warps, int splits,
                                      int resident, void* stream) {
  return dispatch<false, false>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, true, warps,
                                splits, resident, stream);
}

// rows of at most 128 tokens; longer rows return cudaErrorInvalidValue
extern "C" int latteclip_flash_fwd_bd(const void* qkv, void* out, void* lse, int B, int L, int H,
                                      int D, int causal, float qscale, void* stream) {
  return dispatch<false, true>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, false, 0, 0, 0,
                               stream);
}
