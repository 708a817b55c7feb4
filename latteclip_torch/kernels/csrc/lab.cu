// The attention lab's kernels on Hopper (sm_90a).
//
// Replaces the six Pallas TPU kernel bodies of the two lab tools:
//   latteclip_lab_fwd_packed  <- tools/attn_lab.py::_fwd_kernel_v1 (fwd_v1g)
//   latteclip_lab_fwd_bhld    <- tools/attn_lab.py::_fwd_kernel_v3 (fwd_v3)
//   latteclip_lab_bwd_bhld    <- tools/attn_lab.py::_bwd_kernel_v3 (bwd_v3)
//   latteclip_lab_qk_natural  <- tools/r4_transpose_probe.py::_kern_natural
//   latteclip_lab_qk_pret     <- tools/r4_transpose_probe.py::_kern_pret
//   latteclip_lab_pv          <- tools/r4_transpose_probe.py::_kern_pv
// Four kernels: the lab forward (two entry points that differ only in the
// strides and the lse layout they are given), the lab backward, the
// head-summed Q K^T (k given [B, L, HD] or transposed [B, HD, L]) and the
// head-summed P V.
//
// Numerics of the lab forward and backward follow the Pallas bodies step by
// step, per (row b, head h), and differ from the flash kernels (K1, K3):
//   s = (q . k^T in f32) * D^-1/2, scaled after the product;
//   m = rowmax(s) over the whole row; p = exp(s - m) in f32;
//   l = sum of the unrounded p; o = bf16((bf16(p) . v in f32) / l);
//   lse = m + ln(l), natural log, [B, H, L] (packed) or [H, B, L] (BHLD);
//   backward: p = exp(s - lse), dv = bf16(p)^T . do, dp = do . v^T,
//   delta = rowsum(p * dp) over the whole score row in f32,
//   ds = bf16(p * (dp - delta) * D^-1/2), dq = ds . k, dk = ds^T . q.
// p is rounded against the exact row maximum (no online softmax), and delta
// needs every dp of its row before any ds: so each CTA holds one (b, h)'s
// whole row in shared memory and walks it twice (max, then p and P V; delta,
// then dq). Only the f32 summation order differs from the plain versions.
//
// The head-summed products compute S[b] = sum_h q_h . k_h^T [L, L] f32 (one
// [L x HD] . [HD x L] product per row) and O[b] = sum_h p . v_h [L, D] f32
// with one bf16 p [L, L] shared by every head.
//
// Bound. At the tools' shapes every kernel is memory-bound on an H100: the
// lab forward at [512, 197, 12 x 64] does 61 GFLOP against 624.5 MB (98
// FLOP/byte, below the ~295 at which the bf16 tensor cores become the
// limit), the backward 153 GFLOP (five products) against 1089.4 MB, the
// head-summed products at [1024, 77, 8 x 64] 6.2 GFLOP against 185.8 MB
// (Q K^T) and 113.1 MB (P V). So the designs read every input once from
// device memory and keep scores, p and ds on chip. Each entry point of the
// lab forward and of Q K^T takes a launch plan (lab.py::lab_fwd_plan,
// lab_qk_plan: grid and stages), which picks one of two forms:
//   * the ring (lab_fwd_ring_kernel, lab_qk_ring_kernel): persistent CTAs
//     that keep the next items' operands in flight by TMA through a ring of
//     mbarrier slots, and consumer warpgroups that multiply with wgmma from
//     shared memory (csrc/hopper.cuh).
//     The lab forward (rows of at most 256 tokens) walks (b, h) items: TMA
//     boxes of Q, K and V (64 rows a 64-key block, zeros past L, 128-byte
//     swizzle) from maps over (H * D, L, B) for packed tensors or (D, L,
//     B * H) for BHLD ones; each warpgroup takes 64-row query blocks and
//     holds the whole score row of its rows in registers, so the exact row
//     maximum takes one pass and no product is recomputed; p = exp(s - m) on
//     the SFU (ex2.approx of the scores scaled by D^-1/2 log2 e, ~2^-22
//     relative), and P V takes bf16(p) from registers as the A operand with V
//     read MN-major; o goes out by TMA stores. It has no producer warp (the
//     consumers refill the slots they free): a ninth warp would cut each
//     thread's registers from 255 to 168, short of a row of 256 scores. Q K^T
//     walks the batch rows, each in HD / 64 chunks kept in flight by a
//     producer warp: q's (and natural's k) by TMA boxes over (HD, L, B); kT's
//     64 rows of a
//     chunk, one contiguous run of 128 L bytes at a 16-byte boundary, by one
//     1-D bulk copy (a tensor map cannot take kT: its row stride of 2 L bytes
//     is not a multiple of 16 at odd L), transposed in shared memory into
//     exactly the tile natural's TMA writes, so both entries run the same
//     products and agree bit for bit; S goes out through shared memory, 16
//     bytes a thread on consecutive addresses;
//   * one CTA per (b, h) (lab forward rows beyond 256 tokens, whose scores
//     do not fit a warpgroup's registers) or per batch row (Q K^T), the first
//     port's kernels, kept where the plan picks them by shape;
//   * the lab backward and P V keep one CTA per (b, h) or batch row: q, k, v
//     (and do) of the whole row are copied once into shared memory with
//     16-byte cp.async copies, rows padded by 16 bytes so the ldmatrix reads
//     are free of bank conflicts; each warp owns 16-row query blocks (the
//     backward also 16-key blocks for dk and dv, so no gradient row has two
//     writers and no atomics are needed); scores live in mma.sync m16n8k16
//     accumulators (bf16 in, f32 accumulate), 16 keys at a time, and p and
//     ds repack in registers into the A operand of the next product. P V
//     streams each head's V in 64-column chunks through two shared buffers;
//     p [B, L, L] has rows of L bf16 values, not 16-byte aligned at odd L,
//     and is copied 2 bytes a thread;
//   * keys beyond L are zero-filled and masked to p = 0, so they stay out of
//     m, l and delta; query rows beyond L are not stored.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.

#include <climits>

#include "hopper.cuh"

namespace {

using namespace latteclip;
using bf16 = __nv_bfloat16;

constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA may use on an H100
constexpr int FWD_MAX_WARPS = 8;
constexpr int PROD_MAX_L = 128;    // rows of the head-summed products held by one CTA
constexpr int CHUNK = 64;          // columns of one streamed chunk of Q K^T

// Element strides of q, k, v, o (and do, dq, dk, dv) and where lse[b, h, l] lives.
struct Layout {
  long batch, head, token;
  long lse_b, lse_h;
};

// Warps of a CTA that walks nblk 16-row blocks: the fewest rounds of at most
// max_warps warps, then as few warps as those rounds need.
int warps_for(int nblk, int max_warps) {
  const int rounds = (nblk + max_warps - 1) / max_warps;
  return (nblk + rounds - 1) / rounds;
}

// Copy n rows of W columns (`stride` elements between rows of src) into dst
// (rows W + 8 apart), 16 bytes a thread; rows from L on are zero-filled.
template <int W>
__device__ void copy_rows(bf16* dst, const bf16* src, long stride, int n, int L) {
  constexpr int CHUNKS = W / 8;
  for (int c = threadIdx.x; c < n * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const bool valid = r < L;
    cp_async_16(&dst[r * (W + 8) + col], src + (long)(valid ? r : 0) * stride + col, valid);
  }
}

// Round a warp's 16 accumulator rows (r0..r0+15) to bf16 and store those
// below L, `stride` elements apart.
template <int D>
__device__ void store_rows(bf16* base, long stride, int r0, const float (&acc)[D / 8][4], int L) {
  const int lane = threadIdx.x % 32;
  const int ra = r0 + lane / 4, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * (lane % 4);
    if (ra < L) *reinterpret_cast<uint32_t*>(&base[ra * stride + col]) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < L) *reinterpret_cast<uint32_t*>(&base[rb * stride + col]) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ---- lab forward -----------------------------------------------------------

// One CTA per (b, h); shared memory holds the row's Q, K and V.
template <int D>
__global__ void __launch_bounds__(FWD_MAX_WARPS * 32, D == 64 ? 2 : 1)
    lab_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   Layout lay, int L, int H, float scale) {
  constexpr int S = D + 8, KSTEPS = D / 16, DT = D / 8, CHUNKS = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L), nblk = rows / 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + rows * S;
  bf16* sV = sK + rows * S;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const long base = b * lay.batch + h * lay.head;
  copy_rows<D>(sQ, q + base, lay.token, rows, L);
  copy_rows<D>(sK, k + base, lay.token, rows, L);
  copy_rows<D>(sV, v + base, lay.token, rows, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float neg_inf = __int_as_float(0xff800000);
  for (int qb = warp; qb < nblk; qb += blockDim.x / 32) {
    const int r0 = qb * 16;
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(qf[kk], &sQ[(r0 + a_row(lane)) * S + kk * 16 + a_col(lane)]);
    // s = (q . k^T) * scale for the 16 keys from kb * 16; keys from L on at -inf
    auto scores = [&](int kb, float (&s)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &sK[(kb * 16 + b_row(lane)) * S + kk * 16 + b_col(lane)]);
        mma_bf16(s[0], qf[kk], kf[0], kf[1]);
        mma_bf16(s[1], qf[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kb * 16 + n * 8 + 2 * t + (e & 1);
          s[n][e] = j < L ? s[n][e] * scale : neg_inf;
        }
    };

    float m[2] = {neg_inf, neg_inf};
    for (int kb = 0; kb < nblk; ++kb) {
      float s[2][4];
      scores(kb, s);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e / 2] = fmaxf(m[e / 2], s[n][e]);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);

    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    float l[2] = {0.f, 0.f};
    for (int kb = 0; kb < nblk; ++kb) {
      float p[2][4];
      scores(kb, p);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[n][e] = expf(p[n][e] - m[e / 2]);  // 0 at the masked keys
          l[e / 2] += p[n][e];
        }
      const uint32_t pf[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[(kb * 16 + a_row(lane)) * S + d2 * 16 + a_col(lane)]);
        mma_bf16(acc[2 * d2], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], pf, vf[2], vf[3]);
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // o = acc / l in bf16, through this warp's own 16 rows of sQ, then stored
    // 16 bytes a thread
    bf16* sO = sQ + r0 * S;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sO[g * S + col]) = pack_bf16(acc[d][0] / l[0], acc[d][1] / l[0]);
      *reinterpret_cast<uint32_t*>(&sO[(g + 8) * S + col]) =
          pack_bf16(acc[d][2] / l[1], acc[d][3] / l[1]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * CHUNKS; c += 32) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      if (r0 + r < L)
        *reinterpret_cast<uint4*>(o + base + (long)(r0 + r) * lay.token + col) =
            *reinterpret_cast<const uint4*>(&sO[r * S + col]);
    }
    if (t == 0) {
      float* lrow = lse + b * lay.lse_b + h * lay.lse_h;
      if (r0 + g < L) lrow[r0 + g] = m[0] + logf(l[0]);
      if (r0 + g + 8 < L) lrow[r0 + g + 8] = m[1] + logf(l[1]);
    }
  }
}

// Keep registers that an asynchronous wgmma reads or writes out of the
// compiler's reach until its wait: an empty asm that claims to change them.
template <int K>
__device__ __forceinline__ void fence_operands(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---- lab forward on persistent CTAs fed by a TMA ring ----------------------

constexpr int RING_MAX_STAGES = 4;
constexpr int FWD_RING_MAX_L = 256;  // keys whose scores one warpgroup holds in registers
constexpr float LOG2E = 1.4426950408889634f;

// Consumer warpgroups of a forward ring CTA holding rows of 64 * KB tokens:
// two where the KB 64-row query blocks split evenly between them, else one.
__host__ __device__ constexpr int fwd_ring_wgs(int KB) { return KB % 2 ? 1 : 2; }

// CTAs an SM the forward ring's registers must allow. A warpgroup holds the
// scores of 64 query rows over 64 * KB keys (KB * 32 registers a thread),
// then p as bf16 A fragments and the D / 2 registers of P V. An SM's 64 K
// registers are split among its four schedulers, so a thread may hold
// 16384 / (32 * warps a scheduler): the ring has no producer warp, since a
// ninth warp would leave each of two warpgroups 168 registers (spills at
// KB = 4) where eight leave them 255.
__host__ __device__ constexpr int fwd_ring_min_ctas(int D, int KB) {
  return KB == 1 ? (D == 64 ? 4 : 2) : KB == 3 ? 2 : (KB == 2 && D == 64 ? 2 : 1);
}

// Shared memory of the forward ring (lab.py::lab_fwd_smem_bytes mirrors
// it): 1 KB to align the swizzled tiles, then per stage Q, K and V of one
// (b, h), D / 64 panels of 64 * KB token rows x 128 B each, then per
// warpgroup the 64 x D output tile of its query block, then per stage a full
// mbarrier and a release count.
constexpr size_t fwd_ring_smem(int D, int KB, int stages) {
  return SW128_ALIGN + (size_t)stages * 3 * D * 64 * KB * 2 + (size_t)fwd_ring_wgs(KB) * 64 * D * 2 +
         16 * (size_t)stages;
}

// S[:, 64 HK0 .. 64 HK1) = Q K^T of one 64-row query block (Q at qb, K at
// kb, D / 64 panels of PANEL bytes): 128 keys a wgmma where two 64-key
// blocks remain, else 64.
template <int D, int PANEL, int HK0, int HK1, int KB>
__device__ __forceinline__ void s_keys(float (&sc)[KB][32], uint32_t qb, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int hk = HK0; hk < HK1; hk += 2) {
      const uint64_t da = sw128_desc(qb + (kk / 4) * PANEL) + 2 * (kk % 4);
      const uint64_t db = sw128_desc(kb + (kk / 4) * PANEL + hk * 64 * SW128_ROW) + 2 * (kk % 4);
      if (hk + 1 < HK1)
        wgmma_ss128<0>(*reinterpret_cast<float(*)[64]>(&sc[hk][0]), da, db, kk > 0);
      else
        wgmma_ss64<0>(sc[hk], da, db, kk > 0);
    }
}

// NWG consumer warpgroups and no producer warp. CTA x takes the (b, h) items
// x, x + gridDim.x, ... through `stages` ring slots, each holding Q, K and V
// of one item as TMA boxes of 64 * KB token rows (zeros past L) in the
// 128-byte swizzle: packed tensors through maps over (H * D, L, B) at column
// h * D, BHLD ones through maps over (D, L, B * H). Thread 0 fills every
// slot at the start; then the warpgroup that releases a slot last (a count
// in shared memory) refills it with the item `stages` on, so the copy of
// the next items overlaps this one's products. Warpgroup w takes the item's
// 64-row query blocks w, w + NWG, ...: S = Q K^T by wgmma from shared memory
// over every key of the box, so a row's whole score row is in registers and
// its maximum exact in one pass; keys from L on are
// masked to -inf; p = 2^(s log2 e - m log2 e) on the SFU in f32, l the f32
// sum of the unrounded p, then P V by wgmma with bf16(p) repacked in
// registers as A and V read MN-major. A warpgroup releases the slot when its
// last P V has retired; o = bf16(acc / l) (the correctly rounded quotient)
// goes out through shared memory by TMA stores (storing it 16 bytes a lane
// from registers cost a fifth of the kernel's time at [512, 197, 12 x 64]),
// lse = m + ln l, natural, to lse[b * lse_b + h * lse_h + l].
template <int D, int KB>
__global__ void __launch_bounds__(fwd_ring_wgs(KB) * 128, fwd_ring_min_ctas(D, KB))
    lab_fwd_ring_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                        Layout lay, int B, int L, int H, float scale, int bhld, int stages) {
  constexpr int NWG = fwd_ring_wgs(KB);
  constexpr int RB = KB / NWG;            // query blocks a warpgroup takes per item
  constexpr int BOX = 64 * KB;            // token rows of a box
  constexpr int P = D / 64;               // 64-value panels of one head
  constexpr int PANEL = BOX * SW128_ROW;  // bytes of one panel
  constexpr int TILE_BYTES = P * PANEL;   // Q, K or V of one item
  constexpr int STAGE = 3 * TILE_BYTES;
  constexpr int CH = BOX / 16;            // 16-key chunks of a box

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* out_tiles = ring + (size_t)stages * STAGE;  // 64 x D a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + NWG * 64 * D * 2);
  unsigned* released = reinterpret_cast<unsigned*>(full + stages);

  const int tid = threadIdx.x;
  const int items = B * H;
  // the copies of item `item` into slot s, reported to full[s]
  auto fill = [&](int s, int item) {
    const int col = bhld ? 0 : (item % H) * D, outer = bhld ? item : item / H;
    mbar_expect_tx(&full[s], STAGE);
    unsigned char* dst = ring + (size_t)s * STAGE;
    for (int p = 0; p < P; ++p) {
      tma_load_3d(dst + p * PANEL, &q_map, &full[s], col + p * 64, 0, outer);
      tma_load_3d(dst + TILE_BYTES + p * PANEL, &k_map, &full[s], col + p * 64, 0, outer);
      tma_load_3d(dst + 2 * TILE_BYTES + p * PANEL, &v_map, &full[s], col + p * 64, 0, outer);
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

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nch = round16(L) / 16;  // 16-key chunks that hold a key below L
  const float c2 = scale * LOG2E;
  const uint32_t ring_base = smem_addr(ring);
  const float neg_inf = __int_as_float(0xff800000);
  constexpr int KA = KB >= 2 ? 2 : 1;  // key blocks of S's first wgmma group

  // A warpgroup's tasks: query block r of its item n is task n * RB + r.
  const int my_items = (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int tasks = my_items * RB;

#pragma unroll 1
  for (int task = 0; task < tasks; ++task) {
    const int n = task / RB, r = task % RB, s = n % stages;
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = item / H, h = item % H;
    const int row_a = (wg + r * NWG) * 64 + (warp % 4) * 16 + g, row_b = row_a + 8;
    const uint32_t qb = ring_base + s * STAGE + (wg + r * NWG) * 64 * SW128_ROW;
    const uint32_t kb = ring_base + s * STAGE + TILE_BYTES, vbase = kb + TILE_BYTES;
    if (r == 0) mbar_wait(&full[s], (n / stages) & 1);

    // S = Q K^T over every key of the box, into sc: key blocks [0, KA) as
    // one wgmma group, [KA, KB) as a second, so that the first group's
    // maxima are taken while the second is multiplied. Every wgmma has a
    // fixed shape and runs unconditionally (one behind a branch, or of a
    // shape chosen at run time, makes ptxas serialise them all).
    float sc[KB][32];
    wgmma_fence();
    s_keys<D, PANEL, 0, KA>(sc, qb, kb);
    wgmma_commit();
    s_keys<D, PANEL, KA, KB>(sc, qb, kb);
    wgmma_commit();

    // The exact row maxima over the keys below L; keys from L on at -inf
    // (they lie in the last key block: KB = ceil(L / 64)). Scaling by
    // D^-1/2 keeps the order, so m = max(acc) * scale is the maximum of the
    // scaled scores. Four partial maxima a row keep the chains of dependent
    // instructions short: two warps a scheduler hide little latency.
    float mx[2][4];
#pragma unroll
    for (int q = 0; q < 8; ++q) mx[q / 4][q % 4] = neg_inf;
    auto mask_max = [&](int hk) {
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (hk == KB - 1 && hk * 64 + jb * 8 + 2 * t + (e & 1) >= L) sc[hk][4 * jb + e] = neg_inf;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mx[q][jb % 4] = fmaxf(mx[q][jb % 4], fmaxf(sc[hk][4 * jb + 2 * q], sc[hk][4 * jb + 2 * q + 1]));
    };
    wgmma_wait<1>();  // the first group has retired, the second may still run
#pragma unroll
    for (int hk = 0; hk < KA; ++hk) {
      fence_operands(sc[hk]);
      mask_max(hk);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int hk = KA; hk < KB; ++hk) {
      fence_operands(sc[hk]);
      mask_max(hk);
    }
    float m[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      m[q] = quad_max(fmaxf(fmaxf(mx[q][0], mx[q][1]), fmaxf(mx[q][2], mx[q][3]))) * scale;
    const float mc[2] = {m[0] * LOG2E, m[1] * LOG2E};

    // p = exp(s - m) in f32, l the sum of the unrounded p, bf16(p) as the A
    // fragments of P V; chunks from nch on hold masked keys only: p = 0.
    // acc = bf16(p) V, V the MN-major B, 16 key rows a k-step, its 64-value
    // panels PANEL bytes apart.
    float lp[2][4] = {};  // partial sums a row, by chunk
    uint32_t pf[CH][4];
    auto form_p = [&](int c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = (c % 4) * 8 + half * 4;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
        if (c < nch) {
          p0 = exp2_approx(fmaf(sc[c / 4][i], c2, -mc[0]));
          p1 = exp2_approx(fmaf(sc[c / 4][i + 1], c2, -mc[0]));
          p2 = exp2_approx(fmaf(sc[c / 4][i + 2], c2, -mc[1]));
          p3 = exp2_approx(fmaf(sc[c / 4][i + 3], c2, -mc[1]));
        }
        lp[0][c % 4] += p0 + p1;
        lp[1][c % 4] += p2 + p3;
        pf[c][half * 2 + 0] = pack_bf16(p0, p1);
        pf[c][half * 2 + 1] = pack_bf16(p2, p3);
      }
    };
    auto pv = [&](float (&acc)[D / 2], int c) {
      const uint64_t db = sw128_mn_desc(vbase + c * 16 * SW128_ROW, PANEL);
      if constexpr (D == 64)
        wgmma_rs64<1>(acc, pf[c], db, c > 0);
      else
        wgmma_rs128<1>(acc, pf[c], db, c > 0);
    };
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < CH; ++c) form_p(c);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CH; ++c) pv(acc, c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pf);

    // The slot is free once this warpgroup's last P V has retired; the last
    // warpgroup to release it refills it with the item `stages` on.
    if (r == RB - 1 && tid % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1u) == NWG - 1) {
        __threadfence_block();
        released[s] = 0;
        const int next = item + stages * (int)gridDim.x;
        if (next < items) fill(s, next);
      }
    }

    // o = acc / l rounded once to bf16: the correctly rounded quotient, from
    // the row's correctly rounded reciprocal and one exact FMA residual
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
    uint32_t oa[D / 8], ob[D / 8];
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      oa[jb] = pack_bf16(finish(acc[4 * jb], 0), finish(acc[4 * jb + 1], 0));
      ob[jb] = pack_bf16(finish(acc[4 * jb + 2], 1), finish(acc[4 * jb + 3], 1));
    }
    // o goes out through this warpgroup's output tile (the 128-byte swizzle
    // of the maps, D / 64 panels of 64 rows) by TMA stores, which drop the
    // rows from L on: the tile is free once the previous block's stores have
    // read it.
    unsigned char* tile = out_tiles + wg * 64 * D * 2;
    const bool leader = tid % 128 == 0;
    if (leader) bulk_wait_read<0>();
    named_barrier(1 + wg, 128);
    const int ra = (warp % 4) * 16 + g;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      unsigned char* panel = tile + (jb / 8) * 64 * SW128_ROW;
      *reinterpret_cast<uint32_t*>(panel + sw128_offset(ra, jb % 8) + 4 * t) = oa[jb];
      *reinterpret_cast<uint32_t*>(panel + sw128_offset(ra + 8, jb % 8) + 4 * t) = ob[jb];
    }
    fence_proxy_async();  // the tile, written by the threads, is read by TMA
    named_barrier(1 + wg, 128);
    if (leader) {
      const int row0 = (wg + r * NWG) * 64;
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_store_3d(&o_map, tile + p * 64 * SW128_ROW, (bhld ? 0 : h * D) + p * 64, row0, bhld ? item : b);
      bulk_commit();
    }
    if (t == 0) {
      float* lrow = lse + b * lay.lse_b + h * lay.lse_h;
      if (row_a < L) lrow[row_a] = m[0] + logf(l[0]);
      if (row_b < L) lrow[row_b] = m[1] + logf(l[1]);
    }
  }
  if (tid % 128 == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
}

// ---- lab backward ----------------------------------------------------------

// warps of a backward CTA: 16 at D = 64 hold 128 registers a thread, 8 at D = 128
constexpr int bwd_max_warps(int D) { return D == 64 ? 16 : 8; }

// One CTA per (b, h); shared memory holds the row's Q, K, V, dO, lse and
// delta. Phase 1: each warp's query blocks, delta then dq. Phase 2: each
// warp's key blocks, dk and dv from the transposed scores K . Q^T and V . dO^T.
template <int D>
__global__ void __launch_bounds__(D == 64 ? 512 : 256)
    lab_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, bf16* __restrict__ dq, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Layout lay, int L, int H, float scale) {
  constexpr int S = D + 8, KSTEPS = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L), nblk = rows / 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + rows * S;
  bf16* sV = sK + rows * S;
  bf16* sO = sV + rows * S;  // dO
  float* sLse = reinterpret_cast<float*>(sO + rows * S);
  float* sDelta = sLse + rows;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const long base = b * lay.batch + h * lay.head;
  copy_rows<D>(sQ, q + base, lay.token, rows, L);
  copy_rows<D>(sK, k + base, lay.token, rows, L);
  copy_rows<D>(sV, v + base, lay.token, rows, L);
  copy_rows<D>(sO, dout + base, lay.token, rows, L);
  cp_async_commit();
  const float* lrow = lse + b * lay.lse_b + h * lay.lse_h;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) sLse[i] = i < L ? lrow[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // Phase 1: delta, then dq, of each of this warp's 16-query blocks.
  for (int qb = warp; qb < nblk; qb += nw) {
    const int r0 = qb * 16;
    const float lq[2] = {sLse[r0 + g], sLse[r0 + g + 8]};
    // p = exp(s - lse) (0 at keys from L on) and dp of the 16 keys from kb * 16
    auto probs = [&](int kb, float (&p)[2][4], float (&dp)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4], oa[4], kf[4], vf[4];
        const int ar = (r0 + a_row(lane)) * S + kk * 16 + a_col(lane);
        const int br = (kb * 16 + b_row(lane)) * S + kk * 16 + b_col(lane);
        ldmatrix_x4(qa, &sQ[ar]);
        ldmatrix_x4(oa, &sO[ar]);
        ldmatrix_x4(kf, &sK[br]);
        ldmatrix_x4(vf, &sV[br]);
        mma_bf16(p[0], qa, kf[0], kf[1]);
        mma_bf16(p[1], qa, kf[2], kf[3]);
        mma_bf16(dp[0], oa, vf[0], vf[1]);
        mma_bf16(dp[1], oa, vf[2], vf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kb * 16 + n * 8 + 2 * t + (e & 1);
          p[n][e] = j < L ? expf(p[n][e] * scale - lq[e / 2]) : 0.f;
        }
    };

    float delta[2] = {0.f, 0.f};
    for (int kb = 0; kb < nblk; ++kb) {
      float p[2][4], dp[2][4];
      probs(kb, p, dp);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e / 2] += p[n][e] * dp[n][e];
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);

    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    for (int kb = 0; kb < nblk; ++kb) {
      float p[2][4], dp[2][4];
      probs(kb, p, dp);
      float ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (dp[n][e] - delta[e / 2]) * scale;
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, &sK[(kb * 16 + a_row(lane)) * S + d2 * 16 + a_col(lane)]);
        mma_bf16(acc[2 * d2], da, kf[0], kf[1]);
        mma_bf16(acc[2 * d2 + 1], da, kf[2], kf[3]);
      }
    }
    store_rows<D>(dq + base, lay.token, r0, acc, L);
    if (t == 0) {
      sDelta[r0 + g] = delta[0];
      sDelta[r0 + g + 8] = delta[1];
    }
  }
  __syncthreads();  // every delta is in shared memory

  // Phase 2: dk and dv of each of this warp's 16-key blocks, over every query.
  for (int kb = warp; kb < nblk; kb += nw) {
    const int k0 = kb * 16;
    const bool key_ok[2] = {k0 + g < L, k0 + g + 8 < L};
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
      dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
    }
    for (int qb = 0; qb < nblk; ++qb) {
      const int q0 = qb * 16;
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4], qf[4], of[4];
        const int ar = (k0 + a_row(lane)) * S + kk * 16 + a_col(lane);
        const int br = (q0 + b_row(lane)) * S + kk * 16 + b_col(lane);
        ldmatrix_x4(ka, &sK[ar]);
        ldmatrix_x4(va, &sV[ar]);
        ldmatrix_x4(qf, &sQ[br]);
        ldmatrix_x4(of, &sO[br]);
        mma_bf16(st[0], ka, qf[0], qf[1]);
        mma_bf16(st[1], ka, qf[2], qf[3]);
        mma_bf16(dpt[0], va, of[0], of[1]);
        mma_bf16(dpt[1], va, of[2], of[3]);
      }
      // pT and dsT of this 16 x 16 block; rows are keys, columns queries
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = q0 + n * 8 + 2 * t + (e & 1);
          const bool visible = ql < L && key_ok[e / 2];
          pt[n][e] = visible ? expf(st[n][e] * scale - sLse[ql]) : 0.f;
          dst[n][e] = pt[n][e] * (dpt[n][e] - sDelta[ql]) * scale;
        }
      const uint32_t pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
      const uint32_t da[4] = {pack_bf16(dst[0][0], dst[0][1]), pack_bf16(dst[0][2], dst[0][3]),
                              pack_bf16(dst[1][0], dst[1][1]), pack_bf16(dst[1][2], dst[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t ob[4], qt[4];
        const int r = (q0 + a_row(lane)) * S + d2 * 16 + a_col(lane);
        ldmatrix_x4_trans(ob, &sO[r]);
        ldmatrix_x4_trans(qt, &sQ[r]);
        mma_bf16(dva[2 * d2], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * d2 + 1], pa, ob[2], ob[3]);
        mma_bf16(dka[2 * d2], da, qt[0], qt[1]);
        mma_bf16(dka[2 * d2 + 1], da, qt[2], qt[3]);
      }
    }
    store_rows<D>(dk + base, lay.token, k0, dka, L);
    store_rows<D>(dv + base, lay.token, k0, dva, L);
  }
}

// ---- head-summed Q K^T -------------------------------------------------------

// One CTA per batch row, one warp per 16 query rows; S[b] = q[b] . k[b]^T
// over all HD columns, streamed in CHUNK-column chunks through two buffers.
// PRET: k is given transposed, kT [B, HD, L].
template <bool PRET>
__global__ void __launch_bounds__(PROD_MAX_L / 16 * 32)
    lab_qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  float* __restrict__ out, int L, int HD) {
  constexpr int S = CHUNK + 8;
  constexpr int NT = PROD_MAX_L / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L), ST = rows + 8;  // ST: row of a kT chunk
  bf16* sQ = reinterpret_cast<bf16*>(smem);    // [2][rows][S]
  bf16* sK = sQ + 2 * rows * S;                // [2][rows][S], or kT [2][CHUNK][ST]
  const int k_buf = PRET ? CHUNK * ST : rows * S;
  const int b = blockIdx.x;
  const bf16* qrow = q + (long)b * L * HD;
  const bf16* krow = k + (long)b * L * HD;
  const bf16 zero = __float2bfloat16(0.f);

  auto load = [&](int c, int buf) {
    copy_rows<CHUNK>(sQ + buf * rows * S, qrow + c * CHUNK, HD, rows, L);
    bf16* dst = sK + buf * k_buf;
    if (PRET) {
      for (int i = threadIdx.x; i < CHUNK * rows; i += blockDim.x) {
        const int d = i / rows, j = i % rows;
        dst[d * ST + j] = j < L ? krow[(long)(c * CHUNK + d) * L + j] : zero;
      }
    } else {
      copy_rows<CHUNK>(dst, krow + c * CHUNK, HD, rows, L);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_chunks = HD / CHUNK;
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cq = sQ + (c & 1) * rows * S;
    const bf16* ck = sK + (c & 1) * k_buf;
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk) {
      uint32_t qf[4];
      ldmatrix_x4(qf, &cq[(r0 + a_row(lane)) * S + kk * 16 + a_col(lane)]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        if (n2 * 16 >= rows) break;
        uint32_t kf[4];
        if (PRET)
          ldmatrix_x4_trans(kf, &ck[(kk * 16 + a_row(lane)) * ST + n2 * 16 + a_col(lane)]);
        else
          ldmatrix_x4(kf, &ck[(n2 * 16 + b_row(lane)) * S + kk * 16 + b_col(lane)]);
        mma_bf16(acc[2 * n2], qf, kf[0], kf[1]);
        mma_bf16(acc[2 * n2 + 1], qf, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // rows of L f32 values are 8-byte aligned only at even L: one value a store
  float* orow = out + (long)b * L * L;
  const int ra = r0 + lane / 4, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n * 8 >= rows) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ra : rb;
      const int j = n * 8 + 2 * (lane % 4) + (e & 1);
      if (i < L && j < L) orow[(long)i * L + j] = acc[n][e];
    }
  }
}

// ---- head-summed Q K^T on persistent CTAs fed by a ring ----------------------

// A chunk's slot is released only once the next chunk's products are
// issued, so the ring needs two stages at least.
constexpr int QK_MIN_STAGES = 2, QK_MAX_STAGES = 8;

// Consumer warpgroups of a Q K^T ring CTA: one per 64 rows of S.
__host__ __device__ constexpr int qk_ring_wgs(int L) { return L <= 64 ? 1 : 2; }

// Shared memory of the Q K^T ring (lab.py::lab_qk_smem_bytes mirrors it):
// 1 KB to align the swizzled tiles; per stage a q tile and a k tile of 64
// * NWG rows x 128 B (one 64-column chunk of HD), then per stage the flat
// 64 x L chunk of kT (128 L bytes, reserved for both entries so that they
// share one plan); S of one batch row, L x L f32 (+ 16 B to shift it into
// the alignment of its destination); the full and empty mbarriers.
size_t qk_ring_smem(int L, int stages) {
  const size_t tile = (size_t)64 * qk_ring_wgs(L) * SW128_ROW;
  return SW128_ALIGN + (size_t)stages * (2 * tile + (size_t)128 * L) + round16(4 * L * L) + 16 +
         16 * (size_t)stages;
}

// NWG consumer warpgroups (rows 64 w .. 64 w + 63 of S), then one producer
// warp. CTA x takes the batch rows x, x + gridDim.x, ...; each row is HD / 64
// chunks, and the producer keeps chunks in flight through `stages` ring
// slots: q's chunk by a TMA box of 64 * NWG rows x 64 columns over (HD, L,
// B) (zeros past L, never batch row b + 1), and k's the same way (natural)
// or, PRET, kT's rows c * 64 .. c * 64 + 63, which are one contiguous run of
// 128 L bytes starting at a multiple of 16 bytes, by one 1-D bulk copy (a
// tensor map cannot take kT: its row stride of 2 L bytes is not a multiple
// of 16 at odd L). The consumers transpose that flat chunk in shared memory
// into exactly the tile natural's TMA writes (K-major, 128-byte swizzle,
// zeros past L), so both entries run the same products in the same order
// and agree bit for bit. Each chunk is 4 wgmma m64nNk16 (N = 64 * NWG) from
// shared memory into the f32 accumulators; a slot is released when the next
// chunk's products are issued and its own have retired. S goes out through
// shared memory: the row's L x L values are one contiguous run, stored 16
// bytes a thread, consecutive threads on consecutive addresses.
template <int NWG, bool PRET>
__global__ void __launch_bounds__(NWG * 128 + 32, 2)
    lab_qk_ring_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map, const bf16* __restrict__ kt,
                       float* __restrict__ out, int B, int L, int HD, int stages) {
  constexpr int BOX = 64 * NWG;
  constexpr int TILE = BOX * SW128_ROW;
  constexpr int CONSUMERS = NWG * 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  const int chunk_bytes = CHUNK * 2 * L;  // one chunk of kT
  unsigned char* flat = ring + (size_t)stages * 2 * TILE;
  float* sout = reinterpret_cast<float*>(flat + (size_t)stages * chunk_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(sout) + round16(4 * L * L) + 16);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int chunks = HD / CHUNK;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues the copies
    if (tid != CONSUMERS) return;
    int n = 0;
    for (int item = blockIdx.x; item < B; item += gridDim.x)
      for (int c = 0; c < chunks; ++c, ++n) {
        const int s = n % stages;
        if (n >= stages) mbar_wait(&empty[s], (n / stages - 1) & 1);
        unsigned char* dst = ring + (size_t)s * 2 * TILE;
        mbar_expect_tx(&full[s], TILE + (PRET ? chunk_bytes : TILE));
        tma_load_3d(dst, &q_map, &full[s], c * CHUNK, 0, item);
        if (PRET)
          bulk_load(flat + (size_t)s * chunk_bytes, kt + ((long)item * HD + c * CHUNK) * L, chunk_bytes,
                    &full[s]);
        else
          tma_load_3d(dst + TILE, &k_map, &full[s], c * CHUNK, 0, item);
      }
    return;
  }

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int row_a = wg * 64 + (warp % 4) * 16 + lane / 4, row_b = row_a + 8;
  const int t = lane % 4;
  const uint32_t ring_base = smem_addr(ring);
  const bool signals = tid % 128 == 0;  // one arrival a warpgroup on `empty`
  float acc[BOX / 2];
  int n = 0;
  for (int item = blockIdx.x; item < B; item += gridDim.x) {
    for (int c = 0; c < chunks; ++c, ++n) {
      const int s = n % stages;
      mbar_wait(&full[s], (n / stages) & 1);
      const uint32_t qb = ring_base + s * 2 * TILE, kb = qb + TILE;
      if (PRET) {
        // k tile row j, 16-byte chunk q8 = kT rows q8 * 8 .. q8 * 8 + 7 of
        // column j: consecutive threads take consecutive j (2-byte reads of
        // one kT row, 16-byte writes spread over the swizzle's 8 positions)
        const uint16_t* src = reinterpret_cast<const uint16_t*>(flat + (size_t)s * chunk_bytes);
        unsigned char* ktile = ring + (size_t)s * 2 * TILE + TILE;
        for (int x = tid; x < BOX * 8; x += CONSUMERS) {
          const int j = x % BOX, q8 = x / BOX;
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          if (j < L) {
            const uint16_t* col = src + q8 * 8 * L + j;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = (uint32_t)col[2 * e * L] | ((uint32_t)col[(2 * e + 1) * L] << 16);
          }
          *reinterpret_cast<uint4*>(ktile + sw128_offset(j, q8)) = make_uint4(w[0], w[1], w[2], w[3]);
        }
        fence_proxy_async();  // the tile, written by the threads, is read by wgmma
        named_barrier(1, CONSUMERS);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        const uint64_t da = sw128_desc(qb + wg * 64 * SW128_ROW) + 2 * kk;
        const uint64_t db = sw128_desc(kb) + 2 * kk;
        if constexpr (NWG == 2)
          wgmma_ss128<0>(acc, da, db, c > 0 || kk > 0);
        else
          wgmma_ss64<0>(acc, da, db, c > 0 || kk > 0);
      }
      wgmma_commit();
      if (c > 0) {  // the previous chunk's products have retired: release its slot
        wgmma_wait<1>();
        if (signals) mbar_arrive(&empty[(n - 1) % stages]);
      }
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(&empty[(n - 1) % stages]);

    // S[item] through shared memory, shifted by `phase` values so that it
    // shares its destination's alignment to 16 bytes: a head of up to 3
    // values, then 16-byte stores, then a tail.
    const long o0 = (long)item * L * L;
    const int phase = (int)(o0 & 3), total = L * L;
#pragma unroll
    for (int jb = 0; jb < BOX / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? row_a : row_b, j = jb * 8 + 2 * t + (e & 1);
        if (i < L && j < L) sout[phase + i * L + j] = acc[4 * jb + e];
      }
    named_barrier(1, CONSUMERS);
    const int head = min(total, (4 - phase) & 3);
    const int vecs = (total - head) / 4;
    for (int e = tid; e < head; e += CONSUMERS) out[o0 + e] = sout[phase + e];
    const float4* src4 = reinterpret_cast<const float4*>(sout + phase + head);
    float4* dst4 = reinterpret_cast<float4*>(out + o0 + head);
    for (int v = tid; v < vecs; v += CONSUMERS) dst4[v] = src4[v];
    for (int e = head + 4 * vecs + tid; e < total; e += CONSUMERS) out[o0 + e] = sout[phase + e];
    named_barrier(1, CONSUMERS);  // every value is out before the next row's are staged
  }
}

// ---- head-summed P V ---------------------------------------------------------

// One CTA per batch row, one warp per 16 rows of p; O[b] = sum_h p[b] . v_h,
// with p's A fragments held in registers and each head's V streamed through
// two buffers.
template <int D>
__global__ void __launch_bounds__(PROD_MAX_L / 16 * 32)
    lab_pv_kernel(const bf16* __restrict__ p, const bf16* __restrict__ v,
                  float* __restrict__ out, int L, int H) {
  constexpr int S = D + 8, DT = D / 8, KT = PROD_MAX_L / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L), SP = rows + 8;
  bf16* sP = reinterpret_cast<bf16*>(smem);  // [rows][SP]
  bf16* sV = sP + rows * SP;                 // [2][rows][S]
  const int b = blockIdx.x, HD = H * D;
  const bf16* prow = p + (long)b * L * L;
  const bf16* vrow = v + (long)b * L * HD;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * rows; i += blockDim.x) {
    const int r = i / rows, j = i % rows;
    sP[r * SP + j] = r < L && j < L ? prow[(long)r * L + j] : zero;
  }
  auto load = [&](int h, int buf) {
    copy_rows<D>(sV + buf * rows * S, vrow + (long)h * D, HD, rows, L);
    cp_async_commit();
  };
  load(0, 0);
  __syncthreads();  // p is in shared memory

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  uint32_t pf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk * 16 >= rows) break;
    ldmatrix_x4(pf[kk], &sP[(r0 + a_row(lane)) * SP + kk * 16 + a_col(lane)]);
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H) {
      load(h + 1, (h + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cv = sV + (h & 1) * rows * S;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk * 16 >= rows) break;
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &cv[(kk * 16 + a_row(lane)) * S + d2 * 16 + a_col(lane)]);
        mma_bf16(acc[2 * d2], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float* orow = out + (long)b * L * D;
  const int ra = r0 + lane / 4, rb = ra + 8;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * (lane % 4);
    if (ra < L) *reinterpret_cast<float2*>(&orow[(long)ra * D + col]) = make_float2(acc[d][0], acc[d][1]);
    if (rb < L) *reinterpret_cast<float2*>(&orow[(long)rb * D + col]) = make_float2(acc[d][2], acc[d][3]);
  }
}

// ---- launches ----------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool (&allowed)[MAX_DEVICES], long blocks, int threads, size_t smem,
           void* stream, Args... args) {
  if (blocks <= 0 || blocks > INT_MAX || smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

size_t fwd_smem(int L, int D) { return (size_t)3 * round16(L) * (D + 8) * 2; }
size_t bwd_smem(int L, int D) { return (size_t)4 * round16(L) * (D + 8) * 2 + (size_t)8 * round16(L); }

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, Layout lay, int B, int L,
        int H, float scale, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  const int threads = 32 * warps_for(round16(L) / 16, FWD_MAX_WARPS);
  return launch(lab_fwd_kernel<D>, allowed, (long)B * H, threads, fwd_smem(L, D), stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), lay,
                L, H, scale);
}

// The forward ring on `grid` persistent CTAs with `stages` ring slots.
template <int D, int KB>
int fwd_ring(const void* q, const void* k, const void* v, void* o, void* lse, Layout lay, int B,
             int L, int H, float scale, bool bhld, int grid, int stages, void* stream) {
  auto kernel = lab_fwd_ring_kernel<D, KB>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_ring_smem(D, KB, stages);
  if ((long)B * H > INT_MAX || grid < 1 || stages < 1 || stages > RING_MAX_STAGES ||
      smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // packed [B][L][H * D] at column h * D, or BHLD [B * H][L][D]: box rows past L read as zeros
  const uint64_t dims[3] = {(uint64_t)(bhld ? D : H * D), (uint64_t)L, (uint64_t)(bhld ? B * H : B)};
  CUtensorMap maps[4];  // q, k, v in boxes of the row's 64 * KB tokens; o in 64-row blocks
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (!tensor_map_bf16(&maps[i], ptrs[i], 3, dims, i < 3 ? 64 * KB : 64)) return (int)cudaErrorInvalidValue;
  kernel<<<grid, fwd_ring_wgs(KB) * 128, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), lay, B, L, H,
      scale, (int)bhld, stages);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_rows(const void* q, const void* k, const void* v, void* o, void* lse, Layout lay, int B,
             int L, int H, float scale, bool bhld, int grid, int stages, void* stream) {
  if (grid == 0) return fwd<D>(q, k, v, o, lse, lay, B, L, H, scale, stream);
  if (L > FWD_RING_MAX_L) return (int)cudaErrorInvalidValue;  // such rows take one CTA per (b, h)
  switch ((L + 63) / 64) {
    case 1: return fwd_ring<D, 1>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
    case 2: return fwd_ring<D, 2>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
    case 3: return fwd_ring<D, 3>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
    case 4: return fwd_ring<D, 4>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// grid and stages: the launch plan, lab.py::lab_fwd_plan; a grid of 0 takes
// one CTA per (b, h)
int fwd_dispatch(const void* q, const void* k, const void* v, void* o, void* lse, Layout lay,
                 int B, int L, int H, int D, float scale, bool bhld, int grid, int stages,
                 void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || grid < 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return fwd_rows<64>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
  if (D == 128) return fwd_rows<128>(q, k, v, o, lse, lay, B, L, H, scale, bhld, grid, stages, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, void* dq,
        void* dk, void* dv, Layout lay, int B, int L, int H, float scale, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  const int threads = 32 * warps_for(round16(L) / 16, bwd_max_warps(D));
  return launch(lab_bwd_kernel<D>, allowed, (long)B * H, threads, bwd_smem(L, D), stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), lay, L, H, scale);
}

template <bool PRET>
int qk_cta(const void* q, const void* k, void* out, int B, int L, int HD, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  const int rows = round16(L);
  const size_t smem = (size_t)2 * rows * (CHUNK + 8) * 2 +
                      (PRET ? (size_t)2 * CHUNK * (rows + 8) * 2 : (size_t)2 * rows * (CHUNK + 8) * 2);
  return launch(lab_qk_kernel<PRET>, allowed, (long)B, 2 * rows, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out),
                L, HD);
}

// The Q K^T ring on `grid` persistent CTAs with `stages` ring slots.
template <int NWG, bool PRET>
int qk_ring(const void* q, const void* k, void* out, int B, int L, int HD, int grid, int stages,
            void* stream) {
  auto kernel = lab_qk_ring_kernel<NWG, PRET>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = qk_ring_smem(L, stages);
  if (grid < 1 || stages < QK_MIN_STAGES || stages > QK_MAX_STAGES || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // q (and natural's k) as [B][L][HD]: box rows past L read as zeros
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)L, (uint64_t)B};
  CUtensorMap q_map, k_map;
  if (!tensor_map_bf16(&q_map, q, 3, dims, 64 * NWG)) return (int)cudaErrorInvalidValue;
  if (PRET)
    k_map = q_map;  // unused: kT arrives by bulk copies
  else if (!tensor_map_bf16(&k_map, k, 3, dims, 64 * NWG))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, NWG * 128 + 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, static_cast<const bf16*>(k), static_cast<float*>(out), B, L, HD, stages);
  return (int)cudaGetLastError();
}

// grid and stages: the launch plan, lab.py::lab_qk_plan; a grid of 0 takes
// one CTA per batch row
template <bool PRET>
int qk(const void* q, const void* k, void* out, int B, int L, int HD, int grid, int stages,
       void* stream) {
  if (B <= 0 || L <= 0 || L > PROD_MAX_L || HD <= 0 || HD % CHUNK || grid < 0)
    return (int)cudaErrorInvalidValue;
  if (grid == 0) return qk_cta<PRET>(q, k, out, B, L, HD, stream);
  if (qk_ring_wgs(L) == 1) return qk_ring<1, PRET>(q, k, out, B, L, HD, grid, stages, stream);
  return qk_ring<2, PRET>(q, k, out, B, L, HD, grid, stages, stream);
}

template <int D>
int pv(const void* p, const void* v, void* out, int B, int L, int H, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  const int rows = round16(L);
  const size_t smem = (size_t)rows * (rows + 8) * 2 + (size_t)2 * rows * (D + 8) * 2;
  return launch(lab_pv_kernel<D>, allowed, (long)B, 2 * rows, smem, stream,
                static_cast<const bf16*>(p), static_cast<const bf16*>(v), static_cast<float*>(out),
                L, H);
}

}  // namespace

// q, k, v, o [B, L, H*D]; lse [B, H, L]; grid, stages: lab.py::lab_fwd_plan
// (a grid of 0 takes one CTA per (b, h))
extern "C" int latteclip_lab_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int L, int H, int D, float scale,
                                        int grid, int stages, void* stream) {
  const Layout lay{(long)L * H * D, D, (long)H * D, (long)H * L, L};
  return fwd_dispatch(q, k, v, o, lse, lay, B, L, H, D, scale, false, grid, stages, stream);
}

// q, k, v, o [B, H, L, D]; lse [H, B, L]; grid, stages as above
extern "C" int latteclip_lab_fwd_bhld(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int L, int H, int D, float scale,
                                      int grid, int stages, void* stream) {
  const Layout lay{(long)H * L * D, (long)L * D, D, L, (long)B * L};
  return fwd_dispatch(q, k, v, o, lse, lay, B, L, H, D, scale, true, grid, stages, stream);
}

// q, k, v, do, dq, dk, dv [B, H, L, D]; lse [H, B, L]
extern "C" int latteclip_lab_bwd_bhld(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, int B, int L, int H, int D, float scale,
                                      void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Layout lay{(long)H * L * D, (long)L * D, D, L, (long)B * L};
  if (D == 64) return bwd<64>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, stream);
  if (D == 128) return bwd<128>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k [B, L, HD] -> s [B, L, L] f32 (L <= 128, HD a multiple of 64); grid,
// stages: lab.py::lab_qk_plan (a grid of 0 takes one CTA per batch row)
extern "C" int latteclip_lab_qk_natural(const void* q, const void* k, void* s, int B, int L,
                                        int HD, int grid, int stages, void* stream) {
  return qk<false>(q, k, s, B, L, HD, grid, stages, stream);
}

// q [B, L, HD], kT [B, HD, L] -> s [B, L, L] f32 (L <= 128, HD a multiple of 64);
// grid, stages as above
extern "C" int latteclip_lab_qk_pret(const void* q, const void* kt, void* s, int B, int L, int HD,
                                     int grid, int stages, void* stream) {
  return qk<true>(q, kt, s, B, L, HD, grid, stages, stream);
}

// p [B, L, L], v [B, L, H*D] -> o [B, L, D] f32 (L <= 128, D 64 or 128)
extern "C" int latteclip_lab_pv(const void* p, const void* v, void* o, int B, int L, int H, int D,
                                void* stream) {
  if (B <= 0 || L <= 0 || L > PROD_MAX_L || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return pv<64>(p, v, o, B, L, H, stream);
  if (D == 128) return pv<128>(p, v, o, B, L, H, stream);
  return (int)cudaErrorInvalidValue;
}
