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
// 318 MB read and written, 38 FLOP/byte; ViT-B/16 vision at [256, 197, 12 x
// 64] does 30.5 GFLOP against 309 MB, 99 FLOP/byte; both sit below the ~295
// FLOP/byte at which an H100's bf16 tensor cores (989 TFLOP/s) rather than
// its memory (3.35 TB/s) become the limit (SigLIP-512's [16, 1024, 12 x 64],
// whose scores the stream ring computes twice, is the exception: 77 GFLOP,
// 0.078 ms at peak, against 0.052 ms of bytes). So the design goal is to read
// q, k and v of each (row, head) once from device memory, to keep scores and
// probabilities on chip, and to keep copies in flight while the tensor cores
// work:
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
//     made ptxas serialise them all). The block-diagonal kernel's rows, and
//     rows of 65..96 tokens at D=128, keep flash_fwd_kernel, one CTA per
//     (row, head) with one warp per 16 query rows and K and V of the row in
//     shared memory;
//   * rows of 65..96 tokens at D=64 (text at 77) take
//     flash_fwd_warp_ring_kernel: a 64-row wgmma would pad 77 tokens to 128
//     rows and spend most of the second warpgroup's products, masks and
//     exp2 on padding (1.3x the one-CTA form's time), so the warp ring keeps
//     the one-CTA form's warps (one per 16 query rows: 80 rows at 77 tokens)
//     and its mma.sync m16n8k16 products, and puts them on persistent CTAs
//     (two an SM, of five consumer warps at 65..80 tokens, of six at
//     81..96) whose producer warp keeps the items' Q, K and V in flight by
//     TMA (boxes of round16(L) rows, zeros past L, in the 128-byte swizzle)
//     through full/empty mbarrier slots, so the next item's copy lands while
//     this one computes (at 38 FLOP a byte the band is bound by the bytes in
//     flight, not by the tensor cores). Each warp reads its fragments from
//     the swizzled slot, takes every key of the row as the one-CTA form does
//     (masked past a causal diagonal: a warp that stopped there would wait
//     for the slot's last warp, and ran slower), releases the slot once P V
//     is issued, and stores
//     out through its 16 rows of an output tile by TMA; its products and
//     sums run in the one-CTA form's order, so the two give the same bits.
//     D=128 keeps the one-CTA form: a slot of Q, K and V of 80 rows is 60 KB
//     there, so two slots and the output tile hold one CTA of five warps an
//     SM where the one-CTA form runs two;
//   * rows of 129..272 tokens at D=64 (ViT-B/16 at 197, ViT-L/14 at 257,
//     ViT-medium at 256) take flash_fwd_row_ring_kernel, in one pass:
//     persistent CTAs (one an SM) of two consumer warpgroups and no
//     producer warp, walking (row, head) items through two slots that each
//     hold Q, K and V of one item as TMA boxes (KC rows: 208 up to 208
//     tokens, 272 up to 272; zeros past L). K and V of a row stay resident
//     while the warpgroups walk its 64-row query blocks (both warpgroups
//     share the CTA's sequence of (item, block)s, so 257 tokens' five
//     blocks split evenly over items), and the next item's copy overlaps
//     this one's products; the warpgroup that frees a slot last refills it.
//     A warpgroup holds every score of its 64 rows in registers (KC / 2 a
//     thread: 104 or 136), so the exact row maxima take one pass: S = Qs
//     K^T by wgmma (Qs in registers, K from shared memory, n128 + n64 or
//     n128 + n128, then n16), in two commit groups whose first 128 keys'
//     masks and maxima run while the rest multiply; p and l; P V by wgmma
//     with p repacked in registers as A and V read MN-major. Without a
//     producer warp a CTA has eight warps, two a scheduler, which leaves a
//     thread 255 registers; a ninth warp cuts that to 168, and an earlier
//     build with one spilled at 272 keys and ptxas serialised every wgmma
//     (C7512). ptxas: 176 registers and no spill at 208 keys, 208 at 272;
//     causal ones up to 255 without spill, three of the four
//     segment-masked ones 255 with 72-104 bytes of spill (none serialised).
//     setmaxnreg is not used: with no producer warpgroup there is nothing
//     to take registers from;
//   * rows past 272 tokens at D=64 (336 px at 577, SigLIP-512 at 1024), and
//     any row the row ring does not hold, take flash_fwd_stream_ring_kernel,
//     in two passes: persistent CTAs (one an SM) of two consumer
//     warpgroups and one producer warp, walking (row, head, pair of 64-row
//     query blocks) items, the pair fastest so that one (row, head)'s items
//     run side by side and find its K and V in L2; the producer loads each
//     item's Q into one of two item slots and streams the row's chunks of
//     128 keys (64 under a causal mask, which would spill beside 128 keys
//     of scores) through up to eight ring slots, twice: K alone for S, the
//     masks and the exact row maxima (pass 1), then K and V for S again, p,
//     l and P V (pass 2). Both warpgroups read every chunk, so a chunk is
//     copied once for 128 query rows. The scores are computed twice, as the
//     exact maxima need (an online softmax would round p against a running
//     maximum); ptxas: 158-168 registers, no spill;
//   * every wgmma of the rings has a fixed shape and runs unconditionally
//     (a wgmma behind a branch or of a run-time shape makes ptxas serialise
//     them all); key capacities and chunks are template constants; exp2 is
//     skipped on 16-key chunks with no visible key. A 64-row wgmma pads the
//     last query block: 197 tokens take 256 rows (23% padding), 257 take 320
//     (20%), 577 take 640 (10%), 256 and 1024 none; the row ring's keys
//     pad 197 to 208 and 257 to 272. Each output row has one owner (no
//     atomics), so two calls give the same bits; out leaves through a
//     shared-memory tile a warpgroup by TMA store, lse2 from registers;
//   * tried on the card and not kept (PERF.md): ping-pong turns between the
//     two warpgroups (named barriers), S of the stream ring in two commit
//     groups, two accumulators for P V, and one consumer warpgroup a CTA,
//     two CTAs an SM: none was faster, and the last was slower;
//   * D=128 keeps flash_fwd_long_kernel at every length past 128 tokens: P
//     V's accumulator alone takes 64 registers a thread and Q's fragments
//     32, so the row ring would hold no row of 197 scores and the stream
//     ring no chunk of 128. Its CTA holds K and V of the whole row in
//     shared memory (the "resident" form: 113,152 B at D=128, L=197) and its
//     warps walk 16-row query blocks over them; where K and V do not fit
//     (D=128 beyond 384 tokens) it streams them through a ring of two
//     64-key slots (the "streamed" form), K once for the maxima and K with
//     V again for p and P V. Its launch plan (attention.py::long_kernel_plan)
//     picks the form, the warps of a CTA and the CTAs per (row, head); the
//     same plans still reach it at D=64 through their `resident` codes 1 and
//     0, which chip_smoke.py and tools/long_row_plans.py time beside the
//     rings. Each warp takes 32 keys (D=64) or 64 keys (D=128) of its block
//     at a time; at D=64 it keeps its Q fragments in registers, at D=128 it
//     re-reads them from shared memory at every k-step; p = exp2(s - m) on
//     the SFU (ex2.approx, ~2^-22 relative, well below p's bf16 rounding),
//     and l by one more mma, P times a column of ones; Q, K and V move with
//     16-byte cp.async copies, the ragged edge zero-filled to a multiple of
//     16 keys and masked;
//   * the long-row, one-CTA and warp-ring kernels run their products on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); shared-memory
//     rows are padded by 16 bytes so that the ldmatrix reads are free of
//     bank conflicts; the output goes back through shared memory so that it
//     too is stored 16 bytes a thread (the ring stores 16 bytes a lane after
//     a transpose within each quad of lanes);
//   * causal CTAs stop at the last key their rows can see; every causal or
//     segment row keeps its own diagonal, so its maximum is finite.
// What bounds the rings is not settled (no profiler here shows stalls or L2
// traffic): on an NVIDIA H100 80GB HBM3 at 700 W the row ring reaches 48% of
// its bound (memory) at [256, 197, 12 x 64] and 44% at [256, 257, 16 x 64],
// the stream ring 23% at [16, 1024, 12 x 64] (PERF.md). Per 64-row block a
// warpgroup's time grows little with the keys (about 4.2 us at 208 keys and
// 4.7 at 272), so its chain of products, masks and exp2 is bound by latency
// more than by the tensor cores or the SFU.
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

// ---- rows of 65..96 tokens at D = 64: one warp per 16 rows, fed by a TMA ring -

constexpr int WARP_RING = 1;  // the entry points' `resident` for the warp ring on short rows

// Shared memory of the warp ring (attention.py::warp_ring_smem_bytes mirrors
// it): 1 KB to align the swizzled tiles, per stage Q, K and V of one (row,
// head) as ROWS token rows of 128 B, the output tile (16 rows a consumer
// warp), (SEG) the stages' seg ids, and the full and empty mbarriers.
template <int ROWS>
constexpr size_t warp_ring_smem_bytes(int stages, bool seg) {
  return SW128_ALIGN + (size_t)stages * 3 * ROWS * SW128_ROW + (size_t)ROWS * SW128_ROW +
         (seg ? (size_t)stages * ROWS * 4 : 0) + 16 * (size_t)stages;
}

// CTAs an SM that the warp ring's registers must allow, of five consumer
// warps (80 rows) or six (96 rows): three of five, at 96 registers a thread,
// spilled and ran slower (PERF.md).
constexpr int WARP_RING_CTAS = 2;

// ROWS / 16 consumer warps, one per 16 query rows, then one producer warp.
// CTA x takes the (row, head) items x, x + gridDim.x, ...; the producer keeps
// them in flight through `stages` slots, each holding Q, K and V of one item
// as TMA boxes of ROWS token rows (zeros past L) in the 128-byte swizzle.
// Per item each consumer warp computes what flash_fwd_kernel's warp does,
// with the same mma.sync m16n8k16 products in the same order, reading its
// fragments from the swizzled slot: Qs, S = Qs K^T over every key of the
// slot, the masks, the exact row maxima, p = bf16(exp2(s - m)), l, P V. A
// causal warp takes the chunks past its diagonal too (masked, p = 0): the
// slot is refilled once its last warp is done with it, so a warp that
// stopped at its diagonal would only wait for the last one (that form ran
// 14% slower at [1000, 77, 8 x 64], PERF.md). It releases the slot when P V
// has been issued (its operands are in registers), then writes out = acc /
// l into its 16 rows of the output tile and stores them by TMA (rows from L
// on are dropped), and lse2 from registers. A 64-row wgmma would pad 77
// tokens to 128 rows; 16-row warps pad them to 80.
template <int ROWS, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(ROWS * 2 + 32, WARP_RING_CTAS)
    flash_fwd_warp_ring_kernel(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap out_map, const int* __restrict__ seg,
                               float* __restrict__ lse, int B, int L, int H, float qscale, long lse_b,
                               long lse_h, int stages) {
  constexpr int D = 64;
  constexpr int NW = ROWS / 16;                // consumer warps
  constexpr int TILE_BYTES = ROWS * SW128_ROW;  // Q, K or V of one item
  constexpr int STAGE = 3 * TILE_BYTES;
  constexpr int NT = ROWS / 8;                 // 8-key score tiles
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* out_tile = ring + (size_t)stages * STAGE;
  int* sseg = reinterpret_cast<int*>(out_tile + TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sseg + (SEG ? stages * ROWS : 0));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int items = B * H;
  const int HD = H * D;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NW * 32) {  // the producer warp
    const int lane = tid % 32;
    int n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int s = n % stages;
      if (n >= stages) mbar_wait(&empty[s], (n / stages - 1) & 1);
      const int b = item / H, h = item % H;
      if (SEG) {  // the item's seg ids, -2 past L, by the warp's lanes
        for (int i = lane; i < ROWS; i += 32) sseg[s * ROWS + i] = i < L ? seg[(long)b * L + i] : -2;
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* dst = ring + (size_t)s * STAGE;
        for (int part = 0; part < 3; ++part)  // q, k, v
          tma_load_3d(dst + part * TILE_BYTES, &qkv_map, &full[s], part * HD + h * D, 0, b);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = warp * 16 + g, row_b = row_a + 8;
  const uint32_t ring_base = smem_addr(ring);
  unsigned char* tile = out_tile + warp * 16 * SW128_ROW;  // this warp's 16 output rows
  const float neg_inf = __int_as_float(0xff800000);
  // ldmatrix lane addresses in the swizzled tiles, as a 16-row block's byte
  // offset plus the lane's row and its 16-byte chunk of k-step j: the A
  // pattern (Q, and V transposed) and the B pattern (K). Every block starts
  // at a multiple of 8 rows, so the swizzle of a lane's row is lane % 8; a
  // few registers a thread, where addresses precomputed for every block and
  // k-step would be hoisted out of the item loop and spill.
  const uint32_t arow = a_row(lane) * SW128_ROW, brow = b_row(lane) * SW128_ROW;
  uint32_t xa[4], xb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xa[j] = arow + (((2 * j + lane / 16) ^ (lane % 8)) << 4);
    xb[j] = brow + (((2 * j + (lane / 8) % 2) ^ (lane % 8)) << 4);
  }

  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int s = n % stages;
    const int b = item / H, h = item % H;
    const uint32_t qbase = ring_base + s * STAGE, kbase = qbase + TILE_BYTES, vbase = kbase + TILE_BYTES;
    const int* ss = sseg + s * ROWS;
    mbar_wait(&full[s], (n / stages) & 1);

    // Q fragments of this warp's 16 rows, scaled by qscale in f32 and rounded
    // to bf16, as the TPU kernel scales q.
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldmatrix_x4_at(qf[kk], qbase + warp * 16 * SW128_ROW + xa[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[kk][e] = scale_bf16x2(qf[kk][e], qscale);
    }

    // s = Qs K^T over every key of the slot, masked.
    float sc[NT][4];
#pragma unroll
    for (int c = 0; c < NW; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[2 * c + i / 4][i % 4] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4_at(kf, kbase + c * 16 * SW128_ROW + xb[kk]);
        mma_bf16(sc[2 * c], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * c + 1], qf[kk], kf[2], kf[3]);
      }
    }
    int seg_a = 0, seg_b = 0;
    if (SEG) {
      seg_a = row_a < L ? ss[row_a] : -1;
      seg_b = row_b < L ? ss[row_b] : -1;
    }
    if (CAUSAL || SEG || L < ROWS) {
#pragma unroll
      for (int n8 = 0; n8 < NT; ++n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n8 * 8 + 2 * t + (e & 1);
          bool visible = j < L;
          if (CAUSAL) visible = visible && j <= (e < 2 ? row_a : row_b);
          if (SEG) visible = visible && ss[j] == (e < 2 ? seg_a : seg_b);
          if (!visible) sc[n8][e] = MASKED;
        }
      }
    }

    // The row maxima over every key, as the TPU kernel takes them over its
    // whole row, so that p is rounded against the same maximum.
    float m_row[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int n8 = 0; n8 < NT; ++n8) {
      m_row[0] = fmaxf(m_row[0], fmaxf(sc[n8][0], sc[n8][1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(sc[n8][2], sc[n8][3]));
    }
    m_row[0] = quad_max(m_row[0]);
    m_row[1] = quad_max(m_row[1]);

    // p = bf16(exp2(s - m)), l = sum of those bf16 values, acc = P V.
    float l_run[2] = {0.f, 0.f};
    uint32_t pf[NW][4];
#pragma unroll
    for (int n8 = 0; n8 < NT; ++n8) {
      const __nv_bfloat162 pa =
          __floats2bfloat162_rn(exp2f(sc[n8][0] - m_row[0]), exp2f(sc[n8][1] - m_row[0]));
      const __nv_bfloat162 pb =
          __floats2bfloat162_rn(exp2f(sc[n8][2] - m_row[1]), exp2f(sc[n8][3] - m_row[1]));
      const float2 fa = __bfloat1622float2(pa);
      const float2 fb = __bfloat1622float2(pb);
      l_run[0] += fa.x + fa.y;
      l_run[1] += fb.x + fb.y;
      pf[n8 / 2][(n8 % 2) * 2 + 0] = as_u32(pa);
      pf[n8 / 2][(n8 % 2) * 2 + 1] = as_u32(pb);
    }
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NW; ++c) {
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans_at(vf, vbase + c * 16 * SW128_ROW + xa[d2]);
        mma_bf16(acc[2 * d2], pf[c], vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], pf[c], vf[2], vf[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the slot is free: the rest reads registers only
    l_run[0] = quad_sum(l_run[0]);
    l_run[1] = quad_sum(l_run[1]);

    // out = acc / l in bf16 through this warp's rows of the output tile,
    // once the previous item's store has read them, then one TMA store.
    if (lane == 0) bulk_wait_read<0>();
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(g, d) + 4 * t) =
          pack_bf16(acc[d][0] / l_run[0], acc[d][1] / l_run[0]);
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(g + 8, d) + 4 * t) =
          pack_bf16(acc[d][2] / l_run[1], acc[d][3] / l_run[1]);
    }
    fence_proxy_async();  // the tile, written by the lanes, is read by TMA
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&out_map, tile, h * D, warp * 16, b);
      bulk_commit();
    }
    if (t == 0) {
      float* lbase = lse + b * lse_b + h * lse_h;
      if (row_a < L) lbase[row_a] = m_row[0] + log2f(l_run[0]);
      if (row_b < L) lbase[row_b] = m_row[1] + log2f(l_run[1]);
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
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

// ---- rows of more than 128 tokens at D = 64: the TMA rings -------------------

constexpr int LR_TILE = 64 * SW128_ROW;   // a 64-row box of one head: 8 KB
constexpr int ROW_KEYS_SHORT = 208;       // the row ring's key capacities: 64 n + 16
constexpr int ROW_KEYS_LONG = 272;
constexpr int ROW_THREADS = 256;          // the row ring: two consumer warpgroups, no producer warp
constexpr int STREAM_THREADS = 256 + 32;  // the stream ring: two consumer warpgroups, one producer warp
constexpr int RING_MAX_SLOTS = 8;         // slots of a long-row ring, at most
// the entry points' `resident` past SHORT_ROW tokens: flash_fwd_long_kernel's forms, then the rings
constexpr int FORM_STREAMED = 0, FORM_RESIDENT = 1, FORM_ROW_RING = 2, FORM_STREAM_RING64 = 3,
              FORM_STREAM_RING128 = 4;

// Shared memory of the row ring (attention.py::row_ring_smem_bytes mirrors
// it): 1 KB to align the swizzled tiles, per stage Q, K and V of one (row,
// head) as KC token rows of 128 B each, the two warpgroups' 64-row output
// tiles, and per stage an mbarrier and a release count.
template <int KC>
constexpr size_t row_ring_smem_bytes(int stages) {
  return SW128_ALIGN + (size_t)stages * 3 * KC * SW128_ROW + 2 * (size_t)LR_TILE + 16 * (size_t)stages;
}

// Shared memory of the stream ring (attention.py::stream_ring_smem_bytes
// mirrors it): 1 KB to align, two item slots of Q (two 64-row boxes),
// `stages` ring slots of K and V of C keys, the output tiles, (SEG) the item
// slots' query and the ring slots' key seg ids, and the full and empty
// mbarriers of every slot.
constexpr size_t stream_ring_smem_bytes(int chunk, int stages, bool seg) {
  return SW128_ALIGN + 4 * (size_t)LR_TILE + (size_t)stages * 2 * chunk * SW128_ROW + 2 * (size_t)LR_TILE +
         (seg ? (2 * 128 + (size_t)stages * chunk) * 4 : 0) + 16 * (2 + (size_t)stages);
}

// A seg id from device memory, by a load that the compiler keeps in program
// order with the wgmma waits (a volatile asm): hoisted above them, a row's
// 68 key ids would sit in registers beside its 136 scores and spill.
__device__ __forceinline__ int load_seg(const int* p) {
  int v;
  asm volatile("ld.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Masks of one accumulator block of J 8-key columns, keys key0 .. key0 + 8 J
// - 1, for the accumulator rows row_a and row_a + 8 of seg ids seg_a and
// seg_b; key_seg(j) is the seg id of key j (asked only below L).
// Masked scores become MASKED, and mx takes the maxima of what is left: four
// partial maxima a row, by column, so that the chains of dependent
// instructions stay short (two warps a scheduler hide little latency). A
// block whose keys are all below L takes no mask unless CAUSAL or SEG.
template <bool SEG, bool CAUSAL, int K, typename KeySeg>
__device__ __forceinline__ void mask_max(float (&x)[K], int J, int key0, int L, int row_a, int seg_a,
                                         int seg_b, KeySeg key_seg, int t, float (&mx)[2][4]) {
  const bool edge = CAUSAL || SEG || key0 + 8 * J > L;
#pragma unroll
  for (int jb = 0; jb < J; ++jb) {
    const int jl = jb * 8 + 2 * t;  // this lane's two keys of the block, from key0
    int sk[2] = {0, 0};
    if (SEG) {
      sk[0] = key0 + jl < L ? key_seg(key0 + jl) : -2;
      sk[1] = key0 + jl + 1 < L ? key_seg(key0 + jl + 1) : -2;
    }
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = key0 + jl + (e & 1);
        bool visible = j < L;
        if (CAUSAL) visible = visible && j <= row_a + (e < 2 ? 0 : 8);
        if (SEG) visible = visible && sk[e & 1] == (e < 2 ? seg_a : seg_b);
        if (!visible) x[4 * jb + e] = MASKED;
      }
    }
    mx[0][jb % 4] = fmaxf(mx[0][jb % 4], fmaxf(x[4 * jb], x[4 * jb + 1]));
    mx[1][jb % 4] = fmaxf(mx[1][jb % 4], fmaxf(x[4 * jb + 2], x[4 * jb + 3]));
  }
}

// The row maxima from the partial maxima of mask_max, over the quad of lanes.
__device__ __forceinline__ void row_max(const float (&mx)[2][4], float (&m)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) m[q] = quad_max(fmaxf(fmaxf(mx[q][0], mx[q][1]), fmaxf(mx[q][2], mx[q][3])));
}

// p = bf16(exp2(s - m)) of the 16-key chunk whose scores are x[i0 .. i0 + 7]
// (one accumulator's two 8-key columns), packed as the A fragment of P V;
// lp[.][slot] += those bf16 values in f32 (four partial sums a row). A
// chunk with no visible key (`live` false) is 0, with no exp2.
template <int K>
__device__ __forceinline__ void p_chunk(const float (&x)[K], int i0, bool live, const float (&m)[2],
                                        float (&lp)[2][4], int slot, uint32_t (&pf)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + half * 4;
    __nv_bfloat162 pa = __floats2bfloat162_rn(0.f, 0.f), pb = pa;
    if (live) {
      pa = __floats2bfloat162_rn(exp2_approx(x[i] - m[0]), exp2_approx(x[i + 1] - m[0]));
      pb = __floats2bfloat162_rn(exp2_approx(x[i + 2] - m[1]), exp2_approx(x[i + 3] - m[1]));
    }
    const float2 fa = __bfloat1622float2(pa), fb = __bfloat1622float2(pb);
    lp[0][slot] += fa.x + fa.y;
    lp[1][slot] += fb.x + fb.y;
    pf[half * 2 + 0] = as_u32(pa);
    pf[half * 2 + 1] = as_u32(pb);
  }
}

// Q fragments of a warp's 16 rows (from row0) of the swizzled rows at
// qtile, scaled by qscale in f32 and rounded to bf16, as the TPU kernel
// scales q.
__device__ __forceinline__ void load_q64(uint32_t (&qf)[4][4], uint32_t qtile, int row0, int lane,
                                         float qscale) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4_at(qf[kk], qtile + sw128_offset(row0 + a_row(lane), kk * 2 + lane / 16));
#pragma unroll
    for (int e = 0; e < 4; ++e) qf[kk][e] = scale_bf16x2(qf[kk][e], qscale);
  }
}

// The epilogue of a warpgroup's 64-row block (rows row0 .. row0 + 63 of row
// b, head column col): out = acc / l rounded once to bf16 (the correctly
// rounded quotient, from the row's correctly rounded reciprocal and one
// exact FMA residual) through the warpgroup's output tile in the 128-byte
// swizzle and one TMA store, which drops the rows from L on; lse2 = m +
// log2(l) for the rows below L. `wtid` is the thread's index in its
// warpgroup, `barrier` the warpgroup's named barrier; the tile is reused
// once the previous store has read it.
__device__ __forceinline__ void store_block(const float (&acc)[32], const float (&lp)[2][4], const float (&m)[2],
                                            unsigned char* tile, const CUtensorMap* out_map, int col, int row0,
                                            int b, float* lbase, int L, int wtid, int barrier) {
  float l[2], rcp[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    l[q] = quad_sum((lp[q][0] + lp[q][1]) + (lp[q][2] + lp[q][3]));
    rcp[q] = __frcp_rn(l[q]);
  }
  auto finish = [&](float a, int q) {
    const float x = a * rcp[q];
    return fmaf(fmaf(-x, l[q], a), rcp[q], x);
  };
  const int lane = wtid % 32, t = lane % 4, ra = (wtid / 32) * 16 + lane / 4;
  const bool leader = wtid == 0;
  if (leader) bulk_wait_read<0>();
  named_barrier(barrier, 128);
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(ra, jb) + 4 * t) =
        pack_bf16(finish(acc[4 * jb], 0), finish(acc[4 * jb + 1], 0));
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(ra + 8, jb) + 4 * t) =
        pack_bf16(finish(acc[4 * jb + 2], 1), finish(acc[4 * jb + 3], 1));
  }
  fence_proxy_async();  // the tile, written by the threads, is read by TMA
  named_barrier(barrier, 128);
  if (leader) {
    tma_store_3d(out_map, tile, col, row0, b);
    bulk_commit();
  }
  if (t == 0) {
    if (row0 + ra < L) lbase[row0 + ra] = m[0] + log2f(l[0]);
    if (row0 + ra + 8 < L) lbase[row0 + ra + 8] = m[1] + log2f(l[1]);
  }
}

// The row ring ("row_ring", rows of 129..KC tokens, D = 64), in one pass:
// persistent CTAs of two consumer warpgroups and no producer warp (a ninth
// warp would cut each thread's registers from 255 to 168, short of a row of
// 272 scores); CTA x takes the (row, head) items x, x + gridDim.x, ...
// through `stages` slots, each holding Q, K and V of one item as KC token
// rows (TMA boxes of 64 rows, then 16; zeros past L) in the 128-byte
// swizzle. Thread 0 fills every slot at the start; then the warpgroup that
// releases a slot last (a count in shared memory) refills it with the item
// `stages` on, so the next items' copies overlap this one's products. The
// warpgroups share the CTA's sequence of (item, 64-row query block)s:
// warpgroup w takes the blocks w, w + 2, ... of it, so an odd count of
// blocks a row (5 at 257 tokens) splits evenly over the items. The last
// block reads its rows past KC from the slot's K rows: they are finite, and
// rows from L on are never stored. Per block a warpgroup holds every score
// of its 64 rows in registers: S = Qs K^T by wgmma (Qs in registers, K from
// shared memory) in two commit groups, the first 128 keys' masks and maxima
// taken while the rest are multiplied, so that the row maxima are exact in
// one pass; p and l; P V by wgmma with p repacked as the register A operand
// and V read MN-major. Every wgmma has a fixed shape and runs
// unconditionally; exp2 is skipped on 16-key chunks with no visible key.
// The warpgroup releases the slot when the P V of its last block of the item
// has retired, before that block's epilogue.
template <int KC, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(ROW_THREADS, 1)
    flash_fwd_row_ring_kernel(const __grid_constant__ CUtensorMap map64, const __grid_constant__ CUtensorMap map16,
                              const __grid_constant__ CUtensorMap out_map, const int* __restrict__ seg,
                              float* __restrict__ lse, int B, int L, int H, float qscale, long lse_b, long lse_h,
                              int stages) {
  constexpr int D = 64;
  constexpr int NB = KC / 64;  // 64-key blocks of S; a 16-key block follows
  static_assert(KC % 64 == 16 && NB >= 2, "key capacities of 64 n + 16, n >= 2");
  constexpr int CHUNKS = KC / 16;  // 16-key chunks of P V
  constexpr int REGION = KC * SW128_ROW, STAGE = 3 * REGION;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* out_tiles = ring + (size_t)stages * STAGE;  // 64 x D a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + 2 * LR_TILE);
  unsigned* released = reinterpret_cast<unsigned*>(full + stages);

  const int tid = threadIdx.x;
  const int items = B * H, HD = H * D, nqb = (L + 63) / 64;
  // the copies of item `item` into slot s, reported to full[s]
  auto fill = [&](int s, int item) {
    const int b = item / H, h = item % H;
    mbar_expect_tx(&full[s], STAGE);
    unsigned char* dst = ring + (size_t)s * STAGE;
    for (int part = 0; part < 3; ++part) {  // q, k, v
      for (int i = 0; i < NB; ++i)
        tma_load_3d(dst + part * REGION + i * LR_TILE, &map64, &full[s], part * HD + h * D, i * 64, b);
      tma_load_3d(dst + part * REGION + NB * LR_TILE, &map16, &full[s], part * HD + h * D, NB * 64, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_fence_init();
    for (int s = 0; s < stages && (int)(blockIdx.x + s * gridDim.x) < items; ++s)
      fill(s, (int)(blockIdx.x + s * gridDim.x));
  }
  __syncthreads();

  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ring_base = smem_addr(ring);
  const float neg_inf = __int_as_float(0xff800000);
  unsigned char* tile = out_tiles + wg * LR_TILE;
  const int my_items = (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const long tasks = (long)my_items * nqb;
  int waited = -1;  // the item whose slot this warpgroup last waited for

#pragma unroll 1
  for (long k = wg; k < tasks; k += 2) {
    const int n = (int)(k / nqb), qb = (int)(k % nqb), s = n % stages;
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = item / H, h = item % H;
    const uint32_t qbase = ring_base + s * STAGE, kbase = qbase + REGION, vbase = kbase + REGION;
    if (n != waited) {
      mbar_wait(&full[s], (n / stages) & 1);
      waited = n;
    }
    const int row_a = qb * 64 + warp * 16 + g;
    uint32_t qf[4][4];
    load_q64(qf, qbase + qb * LR_TILE, warp * 16, lane, qscale);
    int seg_a = 0, seg_b = 0;
    const int* rowseg = seg + (long)b * L;
    auto key_seg = [&](int j) { return load_seg(rowseg + j); };
    if (SEG) {
      seg_a = row_a < L ? rowseg[row_a] : -1;
      seg_b = row_a + 8 < L ? rowseg[row_a + 8] : -1;
    }

    // S = Qs K^T over the KC keys: keys 0..127 as one commit group, the rest
    // (64-key blocks two at a time, then 16 keys in sc[NB]) as a second
    float sc[NB + 1][32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs128<0>(*reinterpret_cast<float(*)[64]>(&sc[0][0]), qf[kk], sw128_desc(kbase) + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hk = 2; hk < NB; hk += 2) {
        const uint64_t db = sw128_desc(kbase + hk * LR_TILE) + 2 * kk;
        if (hk + 1 < NB)
          wgmma_rs128<0>(*reinterpret_cast<float(*)[64]>(&sc[hk][0]), qf[kk], db, kk > 0);
        else
          wgmma_rs64<0>(sc[hk], qf[kk], db, kk > 0);
      }
      wgmma_rs16<0>(sc[NB], qf[kk], sw128_desc(kbase + NB * LR_TILE) + 2 * kk, kk > 0);
    }
    wgmma_commit();

    float mx[2][4], m[2];
#pragma unroll
    for (int q = 0; q < 8; ++q) mx[q / 4][q % 4] = neg_inf;
    wgmma_wait<1>();  // the first 128 keys have retired, the rest may still run
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      fence_operands(sc[hk]);
      mask_max<SEG, CAUSAL>(sc[hk], 8, hk * 64, L, row_a, seg_a, seg_b, key_seg, t, mx);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int hk = 2; hk < NB; ++hk) {
      fence_operands(sc[hk]);
      mask_max<SEG, CAUSAL>(sc[hk], 8, hk * 64, L, row_a, seg_a, seg_b, key_seg, t, mx);
    }
    fence_operands(sc[NB]);
    mask_max<SEG, CAUSAL>(sc[NB], 2, NB * 64, L, row_a, seg_a, seg_b, key_seg, t, mx);
    row_max(mx, m);

    // p and l; chunks past the block's last visible key are 0
    const int live = ((CAUSAL ? min(L, (qb + 1) * 64) : L) + 15) / 16;
    float lp[2][4] = {};
    uint32_t pf[CHUNKS][4];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) p_chunk(sc[c / 4], (c % 4) * 8, c < live, m, lp, c % 4, pf[c]);

    float acc[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      wgmma_rs64<1>(acc, pf[c], sw128_mn_desc(vbase + c * 16 * SW128_ROW, LR_TILE), c > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pf);

    // The slot is free once this warpgroup's last block of the item has
    // read it; the warpgroup that releases it last refills it.
    if (k + 2 >= (long)(n + 1) * nqb && wtid == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1u) == 1) {
        __threadfence_block();
        released[s] = 0;
        const int next = item + stages * (int)gridDim.x;
        if (next < items) fill(s, next);
      }
    }
    store_block(acc, lp, m, tile, &out_map, h * D, qb * 64, b, lse + b * lse_b + h * lse_h, L, wtid, 1 + wg);
  }
  if (wtid == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
}

// The stream ring ("stream_ring", any row past 128 tokens at D = 64), in two
// passes: persistent CTAs, CTA x taking the items x, x + gridDim.x, ... of
// (row b, head h, pair of 64-row query blocks), the pair fastest, so that
// the pairs of one (row, head) run side by side and find its K and V in L2.
// Consumer warpgroup w owns block 2 pair + w of the item. The producer warp
// loads each item's Q into one of two item slots and streams the item's
// C-key chunks through `stages` ring slots, twice: K alone, for S, the
// masks and the exact row maxima (pass 1), then K and V, for S again, p, l
// and P V (pass 2), zeros past L. Both warpgroups read every chunk; each
// of their eight warps releases a ring slot when its products on it have
// retired and its masks have read the slot's seg ids, and the item slot
// once it holds its Q fragments and query seg ids. Every wgmma has a fixed shape and runs
// unconditionally; a causal item streams the chunks up to its last row.
template <int C, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
    flash_fwd_stream_ring_kernel(const __grid_constant__ CUtensorMap map64, const __grid_constant__ CUtensorMap out_map,
                                 const int* __restrict__ seg, float* __restrict__ lse, int B, int L, int H,
                                 float qscale, long lse_b, long lse_h, int stages) {
  constexpr int D = 64;
  constexpr int KT = C * SW128_ROW;  // K or V of one chunk
  constexpr int QSLOT = 2 * LR_TILE; // Q of one item

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* qslots = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* ring = qslots + 2 * QSLOT;
  unsigned char* out_tiles = ring + (size_t)stages * 2 * KT;
  int* sqseg = reinterpret_cast<int*>(out_tiles + 2 * LR_TILE);  // [2][128]
  int* skseg = sqseg + (SEG ? 2 * 128 : 0);                      // [stages][C]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skseg + (SEG ? stages * C : 0));
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int HD = H * D;
  const int nqb = (L + 63) / 64, npair = (nqb + 1) / 2, nkc = (L + C - 1) / C;
  const int items = B * H * npair;  // the host checks that it fits an int
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the chunks an item streams in each pass: a causal item's end at its last row
  auto item_chunks = [&](int pr) { return CAUSAL ? min(nkc, (min(L, (pr + 1) * 128) + C - 1) / C) : nkc; };

  if (tid >= 256) {  // the producer warp
    const int lane = tid % 32;
    int c = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int pr = item % npair, bh = item / npair, h = bh % H, b = bh / H;
      const int qs = n % 2;
      if (n >= 2) mbar_wait(&q_empty[qs], (n / 2 - 1) & 1);
      if (SEG) {
        for (int i = lane; i < 128; i += 32) {
          const int q = pr * 128 + i;
          sqseg[qs * 128 + i] = q < L ? seg[(long)b * L + q] : -1;
        }
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(&q_full[qs], QSLOT);
        for (int w = 0; w < 2; ++w)
          tma_load_3d(qslots + (size_t)qs * QSLOT + w * LR_TILE, &map64, &q_full[qs], h * D, pr * 128 + w * 64, b);
      }
      const int chunks = item_chunks(pr);
      for (int pass = 0; pass < 2; ++pass)
        for (int kc = 0; kc < chunks; ++kc, ++c) {
          const int s = c % stages;
          if (c >= stages) mbar_wait(&empty[s], (c / stages - 1) & 1);
          if (SEG) {
            for (int i = lane; i < C; i += 32) {
              const int k = kc * C + i;
              skseg[s * C + i] = k < L ? seg[(long)b * L + k] : -2;
            }
            __syncwarp();
          }
          if (lane == 0) {
            unsigned char* dst = ring + (size_t)s * 2 * KT;
            mbar_expect_tx(&full[s], (pass + 1) * KT);
            for (int i = 0; i < C / 64; ++i) {
              tma_load_3d(dst + i * LR_TILE, &map64, &full[s], HD + h * D, kc * C + i * 64, b);
              if (pass)
                tma_load_3d(dst + KT + i * LR_TILE, &map64, &full[s], 2 * HD + h * D, kc * C + i * 64, b);
            }
          }
        }
    }
    return;
  }

  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t qslot_base = smem_addr(qslots), ring_base = smem_addr(ring);
  const float neg_inf = __int_as_float(0xff800000);
  unsigned char* tile = out_tiles + wg * LR_TILE;
  int c = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int pr = item % npair, bh = item / npair, h = bh % H, b = bh / H;
    const int qs = n % 2, qb = pr * 2 + wg;
    const int row_a = qb * 64 + warp * 16 + g;
    mbar_wait(&q_full[qs], (n / 2) & 1);
    uint32_t qf[4][4];
    load_q64(qf, qslot_base + qs * QSLOT + wg * LR_TILE, warp * 16, lane, qscale);
    int seg_a = 0, seg_b = 0;
    if (SEG) {
      seg_a = sqseg[qs * 128 + wg * 64 + warp * 16 + g];
      seg_b = sqseg[qs * 128 + wg * 64 + warp * 16 + g + 8];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qs]);  // this warp holds its Q and seg ids

    const int chunks = item_chunks(pr);
    const int live_end = CAUSAL ? min(L, (qb + 1) * 64) : L;  // keys this block can see end here
    // S = Qs K^T of the chunk in ring slot s, masked, the maxima into mx
    auto scores = [&](float (&sc)[C / 64][32], int s, int kc, float (&mx)[2][4]) {
      const uint32_t kb = ring_base + s * 2 * KT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (C == 128)
          wgmma_rs128<0>(*reinterpret_cast<float(*)[64]>(&sc[0][0]), qf[kk], sw128_desc(kb) + 2 * kk, kk > 0);
        else
          wgmma_rs64<0>(sc[0], qf[kk], sw128_desc(kb) + 2 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hk = 0; hk < C / 64; ++hk) {
        fence_operands(sc[hk]);
        mask_max<SEG, CAUSAL>(sc[hk], 8, kc * C + hk * 64, L, row_a, seg_a, seg_b,
                              [&](int j) { return skseg[s * C + j - kc * C]; }, t, mx);
      }
    };

    // pass 1: the exact row maxima
    float mx[2][4], m[2];
#pragma unroll
    for (int q = 0; q < 8; ++q) mx[q / 4][q % 4] = neg_inf;
    for (int kc = 0; kc < chunks; ++kc, ++c) {
      const int s = c % stages;
      mbar_wait(&full[s], (c / stages) & 1);
      float sc[C / 64][32];
      scores(sc, s, kc, mx);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    row_max(mx, m);

    // pass 2: p, l and P V
    float lp[2][4] = {}, acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < chunks; ++kc, ++c) {
      const int s = c % stages;
      mbar_wait(&full[s], (c / stages) & 1);
      float sc[C / 64][32], unused[2][4] = {};
      scores(sc, s, kc, unused);
      uint32_t pf[C / 16][4];
#pragma unroll
      for (int cc = 0; cc < C / 16; ++cc)
        p_chunk(sc[cc / 4], (cc % 4) * 8, kc * C + cc * 16 < live_end, m, lp, cc % 4, pf[cc]);
      const uint32_t vb = ring_base + s * 2 * KT + KT;
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < C / 16; ++cc)
        wgmma_rs64<1>(acc, pf[cc], sw128_mn_desc(vb + cc * 16 * SW128_ROW, LR_TILE), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_block(acc, lp, m, tile, &out_map, h * D, qb * 64, b, lse + b * lse_b + h * lse_h, L, wtid, 1 + wg);
  }
  if (wtid == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
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

// The warp ring on `grid` persistent CTAs with `stages` slots: D = 64 and
// rows of 65..96 tokens (ROWS = round16(L)).
template <int ROWS, bool SEG, bool CAUSAL>
int launch_warp_ring(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                     float qscale, bool lse_head_major, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_fwd_warp_ring_kernel<ROWS, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = warp_ring_smem_bytes<ROWS>(stages, SEG);
  if (B <= 0 || H <= 0 || round16(L) != ROWS || (long)B * H > INT_MAX || grid < 1 || stages < 1 ||
      stages > RING_MAX_STAGES || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // qkv as [B][L][3 * H * 64] in boxes of ROWS rows (rows past L read as
  // zeros), out as [B][L][H * 64] in boxes of a warp's 16 rows (rows from L on
  // are not stored)
  CUtensorMap map, out_map;
  const uint64_t dims[3] = {(uint64_t)3 * H * 64, (uint64_t)L, (uint64_t)B};
  const uint64_t out_dims[3] = {(uint64_t)H * 64, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&map, qkv, 3, dims, ROWS) || !tensor_map_bf16(&out_map, out, 3, out_dims, 16))
    return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<grid, ROWS * 2 + 32, smem, stream>>>(map, out_map, static_cast<const int*>(seg),
                                                static_cast<float*>(lse), B, L, H, qscale, lse_b, lse_h,
                                                stages);
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

// The row ring with key capacity KC on `grid` persistent CTAs (one an SM)
// and `stages` slots.
template <int KC, bool SEG, bool CAUSAL>
int launch_row_ring(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                    float qscale, bool lse_head_major, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_fwd_row_ring_kernel<KC, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = row_ring_smem_bytes<KC>(stages);
  if (B <= 0 || H <= 0 || L <= SHORT_ROW || L > KC || (long)B * H * ((L + 63) / 64) > INT_MAX || grid < 1 ||
      stages < 1 || stages > RING_MAX_SLOTS || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // qkv as [B][L][3 * H * D] and out as [B][L][H * D]: box rows past L read as zeros and are not stored
  CUtensorMap map64, map16, out_map;
  const uint64_t dims[3] = {(uint64_t)3 * H * 64, (uint64_t)L, (uint64_t)B};
  const uint64_t out_dims[3] = {(uint64_t)H * 64, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&map64, qkv, 3, dims, 64) || !tensor_map_bf16(&map16, qkv, 3, dims, 16) ||
      !tensor_map_bf16(&out_map, out, 3, out_dims, 64))
    return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<grid, ROW_THREADS, smem, stream>>>(map64, map16, out_map, static_cast<const int*>(seg),
                                              static_cast<float*>(lse), B, L, H, qscale, lse_b, lse_h, stages);
  return (int)cudaGetLastError();
}

// The stream ring with C-key chunks on `grid` persistent CTAs (one an SM)
// and `stages` ring slots.
template <int C, bool SEG, bool CAUSAL>
int launch_stream_ring(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                       float qscale, bool lse_head_major, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_fwd_stream_ring_kernel<C, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stream_ring_smem_bytes(C, stages, SEG);
  const long pairs = ((long)(L + 63) / 64 + 1) / 2;
  if (B <= 0 || H <= 0 || L <= SHORT_ROW || (long)B * H * pairs > INT_MAX || grid < 1 || stages < 1 ||
      stages > RING_MAX_SLOTS || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map, out_map;
  const uint64_t dims[3] = {(uint64_t)3 * H * 64, (uint64_t)L, (uint64_t)B};
  const uint64_t out_dims[3] = {(uint64_t)H * 64, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&map, qkv, 3, dims, 64) || !tensor_map_bf16(&out_map, out, 3, out_dims, 64))
    return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<grid, STREAM_THREADS, smem, stream>>>(map, out_map, static_cast<const int*>(seg),
                                                 static_cast<float*>(lse), B, L, H, qscale, lse_b, lse_h, stages);
  return (int)cudaGetLastError();
}

// The rings past SHORT_ROW tokens at D = 64: `form` FORM_ROW_RING (the key
// capacity from L) or FORM_STREAM_RING64/128, each on (grid, stages).
template <bool SEG, bool CAUSAL>
int launch_long_ring(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                     float qscale, bool hm, int grid, int stages, int form, cudaStream_t s) {
  if (form == FORM_ROW_RING) {
    if (L <= ROW_KEYS_SHORT)
      return launch_row_ring<ROW_KEYS_SHORT, SEG, CAUSAL>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
    return launch_row_ring<ROW_KEYS_LONG, SEG, CAUSAL>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
  }
  if (form == FORM_STREAM_RING64)
    return launch_stream_ring<64, SEG, CAUSAL>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
  if constexpr (!CAUSAL) {  // a causal mask beside 128 keys of scores a warpgroup would spill
    if (form == FORM_STREAM_RING128)
      return launch_stream_ring<128, SEG, CAUSAL>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch plan: for rows of more than SHORT_ROW tokens (warps, splits,
// resident) of the long-row kernel, or (grid, stages, form) of a ring at D
// = 64 (resident FORM_ROW_RING and up); for
// shorter rows `warps` carries the ring's grid of persistent CTAs and
// `splits` its stages, `resident` 0 for the warpgroup ring or WARP_RING for
// the warp ring (D = 64, 65..96 tokens), and a grid of 0 selects the
// one-CTA-per-(row, head) kernel, which the block-diagonal forward always
// takes.
template <int D, bool SEG, bool BD>
int launch_rows(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                int causal, float qscale, bool hm, int warps, int splits, int resident,
                cudaStream_t s) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  if (!BD && L <= SHORT_ROW && warps > 0) {
    const int grid = warps, stages = splits;
    if (resident == WARP_RING) {
      if (D != 64 || L < 65 || L > 96) return (int)cudaErrorInvalidValue;
      if (L <= 80)
        return causal ? launch_warp_ring<80, SEG, true>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s)
                      : launch_warp_ring<80, SEG, false>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
      return causal ? launch_warp_ring<96, SEG, true>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s)
                    : launch_warp_ring<96, SEG, false>(qkv, seg, out, lse, B, L, H, qscale, hm, grid, stages, s);
    }
    if (resident != 0) return (int)cudaErrorInvalidValue;
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
    if (resident >= FORM_ROW_RING) {
      if (D != 64) return (int)cudaErrorInvalidValue;
      return causal ? launch_long_ring<SEG, true>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, resident, s)
                    : launch_long_ring<SEG, false>(qkv, seg, out, lse, B, L, H, qscale, hm, warps, splits, resident, s);
    }
    if (resident != FORM_RESIDENT && resident != FORM_STREAMED) return (int)cudaErrorInvalidValue;
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
// for rows longer than 128 tokens: (grid, slots, 2) of the row ring, (grid,
// slots, 3 or 4) of the stream ring with 64- or 128-key chunks (head_dim 64),
// or (warps, splits, 1 or 0) of flash_fwd_long_kernel's resident or streamed
// form; for shorter rows attention.py::short_row_plan gives (grid, stages,
// 0) of the ring kernel, (grid, stages, 1) of the warp ring (D = 64, 65..96
// tokens), or (0, 0, 0) for the one-CTA-per-(row, head) kernel.
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
