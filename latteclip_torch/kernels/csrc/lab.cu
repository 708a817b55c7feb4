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
// device memory and keep scores, p and ds on chip. Every entry point takes a
// launch plan (lab.py::lab_fwd_plan, lab_bwd_plan, lab_qk_plan,
// lab_pv_plan: grid and stages), which picks one of two forms:
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
//     bytes a thread on consecutive addresses.
//     The lab backward (head_dim 64, rows of at most 208 tokens) holds
//     Q, dO, V and K of a (b, h) item by TMA, and ds [L, L] bf16 of the item
//     beside them: two items up to 144 tokens, else one, which is what fits
//     one CTA (227 KB). The next item is prefetched into L2; with one slot
//     its Q, dO and V are copied while this item's dq is multiplied, with
//     two the whole item is copied while this one is multiplied. Two
//     warpgroups take 64-row blocks in three phases: delta = rowsum(p * dp)
//     by query block (S and dP once); dk and dv by key block over every
//     query (S^T and dP^T a second time, p and ds in registers as the A
//     operands of wgmma), writing bf16(ds) into shared memory transposed
//     (stmatrix); dq = ds . K by query block from shared memory. Each
//     gradient row has one owner, so no atomics; the gradients leave by TMA
//     stores. P V walks the batch rows with a producer warp: one 16-key step
//     of every head a ring slot (16 contiguous token rows of v), by TMA; the
//     row's p, whose rows of 2 L bytes take no tensor map, by one 1-D bulk
//     copy of the 16-byte aligned span that covers it, a row ahead; each
//     step's A fragments of p are read from that copy at its offset and
//     serve every head;
//   * one CTA per (b, h) (lab forward rows beyond 256 tokens, whose scores
//     do not fit a warpgroup's registers; lab backward rows beyond 208
//     tokens or at head_dim 128, whose item and ds do not fit) or per batch
//     row (Q K^T, P V), the first port's kernels, kept where the plan picks
//     them by shape:
//     q, k, v (and do) of the whole row are copied once into shared memory with
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

// ---- head-summed P V on persistent CTAs fed by a ring ------------------------

// One stage is one 16-key step of every head. With one stage no copy would
// be in flight while a step is multiplied. p has three slots, so that a
// row's p is copied a whole row ahead of its use.
constexpr int PV_MIN_STAGES = 2, PV_MAX_STAGES = 8, PV_P_SLOTS = 3;

// Consumer warpgroups of a P V ring CTA: one per 64 rows of O.
__host__ __device__ constexpr int pv_ring_wgs(int L) { return L <= 64 ? 1 : 2; }

// Bytes of a p slot: one batch row of p (2 L^2 bytes at an even offset),
// the up to 14 bytes before it that its 16-byte aligned copy starts with and
// the up to 14 after it that the copy ends with.
__host__ __device__ constexpr int pv_p_bytes(int L) { return round16(2 * L * L + 28); }

// Shared memory of the P V ring (lab.py::lab_pv_smem_bytes mirrors it): 1 KB
// to align; per stage 16 token rows of v (HD / 64 panels of 16 rows x 128 B);
// the p slots; the full and empty mbarriers of the stages and of the p slots.
size_t pv_ring_smem(int L, int HD, int stages) {
  return SW128_ALIGN + (size_t)stages * 32 * HD + PV_P_SLOTS * (size_t)pv_p_bytes(L) +
         16 * ((size_t)stages + PV_P_SLOTS);
}

// NWG consumer warpgroups (rows 64 w .. 64 w + 63 of O), then one producer
// warp. CTA x takes the batch rows x, x + gridDim.x, ...; the producer
// copies p of the next row into a p slot, then v of this row through
// `stages` slots,
// one 16-key step a slot: tokens 16 c .. 16 c + 15 of every head, which are
// 16 KB of contiguous device memory at HD = 512, as HD / 64 TMA boxes of 16
// token rows x 64 columns over (HD, L, B) (zeros past L), one panel of the
// 128-byte swizzle each. p[b] starts at 2 L^2 b bytes, 16-byte aligned only
// when 8 divides b at odd L, and its rows of 2 L bytes take no tensor map:
// one 1-D bulk copy brings the 16-byte aligned span that covers it (cut at
// the tensor's last 16-byte boundary; the consumers read the few values
// past that, in the last batch row, from device memory). For each step the
// consumers build their A fragments of p (keys 16 c .. 16 c + 15, zeros
// outside L x L) from the copy, then multiply every head: O += p_c . v_{c,h}
// by wgmma m64nDk16 with v read MN-major, H products into one f32
// accumulator a step. A slot is released when its products have retired,
// before the next step's fragments are built over the registers they read;
// O goes out by 8-byte stores (a quad of lanes writes one 32-byte sector).
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, D == 64 ? 2 : 1)
    lab_pv_ring_kernel(const bf16* __restrict__ p, const __grid_constant__ CUtensorMap v_map,
                       float* __restrict__ out, int B, int L, int H, int stages) {
  constexpr int PANEL = 16 * SW128_ROW;  // 16 token rows of one 64-column panel
  constexpr int CONSUMERS = NWG * 128;
  const int HD = H * D;
  const int STAGE = HD / 64 * PANEL;     // one 16-key step of every head
  const int steps = (L + 15) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  const int pb = pv_p_bytes(L);
  unsigned char* pbuf = ring + (size_t)stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + PV_P_SLOTS * pb);
  uint64_t* empty = full + stages;
  uint64_t* p_full = empty + stages;
  uint64_t* p_empty = p_full + PV_P_SLOTS;

  const int tid = threadIdx.x;
  const long row_bytes = 2L * L * L;
  const long end_bytes = (row_bytes * B) & ~15L;  // the copies stop at the tensor's last 16-byte boundary
  // the 16-byte aligned span of batch row `row`: [start, end)
  auto span = [&](int row, long& start, long& end) {
    const long first = row_bytes * row;
    start = first & ~15L;
    end = (first + row_bytes + 15) & ~15L;
    if (end > end_bytes) end = end_bytes;
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    for (int s = 0; s < PV_P_SLOTS; ++s) {
      mbar_init(&p_full[s], 1);
      mbar_init(&p_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues the copies
    if (tid != CONSUMERS) return;
    // p of the row this CTA takes i-th, into p slot i % PV_P_SLOTS
    auto copy_p = [&](int i, int row) {
      const int ps = i % PV_P_SLOTS;
      if (i >= PV_P_SLOTS) mbar_wait(&p_empty[ps], (i / PV_P_SLOTS - 1) & 1);
      long start, end;
      span(row, start, end);
      const uint32_t bytes = end > start ? (uint32_t)(end - start) : 0u;
      mbar_expect_tx(&p_full[ps], bytes);
      if (bytes)
        bulk_load(pbuf + ps * pb, reinterpret_cast<const unsigned char*>(p) + start, bytes, &p_full[ps]);
    };
    int n = 0, m = 0;
    if ((int)blockIdx.x < B) copy_p(0, blockIdx.x);
    for (int row = blockIdx.x; row < B; row += gridDim.x, ++n) {
      if (row + (int)gridDim.x < B) copy_p(n + 1, row + gridDim.x);
      for (int c = 0; c < steps; ++c, ++m) {
        const int s = m % stages;
        if (m >= stages) mbar_wait(&empty[s], (m / stages - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* dst = ring + (size_t)s * STAGE;
        for (int q = 0; q < HD / 64; ++q) tma_load_3d(dst + q * PANEL, &v_map, &full[s], q * 64, 16 * c, row);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int r_a = wg * 64 + (warp % 4) * 16 + lane / 4, r_b = r_a + 8;
  const uint32_t ring_base = smem_addr(ring);
  const bool signals = tid % 128 == 0;  // one arrival a warpgroup on `empty`
  const uint16_t* p16 = reinterpret_cast<const uint16_t*>(p);
  int n = 0, m = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x, ++n) {
    const int ps = n % PV_P_SLOTS;
    long start, end;
    span(row, start, end);
    const long first = row_bytes / 2 * row;  // elements
    const int shift = (int)(first & 7);      // elements of the copy before the row
    const int copied = end > start ? (int)((end - start) / 2) : 0;
    const uint16_t* sp = reinterpret_cast<const uint16_t*>(pbuf + ps * pb) + shift;
    const uint16_t* gp = p16 + first;
    // p[r][j], zero outside L x L: from the copy, or from device memory for
    // the values past the tensor's last 16-byte boundary (a generic load from
    // either pointer, and selections: no branch may diverge before a wgmma)
    auto el = [&](int r, int j) -> uint32_t {
      const bool in = r < L && j < L;
      const int i = in ? r * L + j : 0;
      const uint16_t* src = i + shift < copied ? sp : gp;
      const uint32_t x = src[i];
      return in ? x : 0u;
    };
    mbar_wait(&p_full[ps], (n / PV_P_SLOTS) & 1);

    float acc[D / 2];
#pragma unroll 1
    for (int c = 0; c < steps; ++c, ++m) {
      const int s = m % stages;
      const int j = 16 * c + 2 * t;
      uint32_t pf[4] = {el(r_a, j) | el(r_a, j + 1) << 16, el(r_b, j) | el(r_b, j + 1) << 16,
                              el(r_a, j + 8) | el(r_a, j + 9) << 16, el(r_b, j + 8) | el(r_b, j + 9) << 16};
      mbar_wait(&full[s], (m / stages) & 1);
      const uint32_t vt = ring_base + s * STAGE;
      fence_operands(pf);  // the fragments are whole before the fence
      wgmma_fence();
#pragma unroll 1
      for (int h = 0; h < H; ++h) {
        const uint64_t db = sw128_mn_desc(vt + h * (D / 64) * PANEL, PANEL);
        if constexpr (D == 64)
          wgmma_rs64<1>(acc, pf, db, c > 0 || h > 0);
        else
          wgmma_rs128<1>(acc, pf, db, c > 0 || h > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pf);
      if (signals) mbar_arrive(&empty[s]);
    }
    mbar_arrive(&p_empty[ps]);  // this thread is done with the slot

    float* orow = out + (long)row * L * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const int col = 8 * jb + 2 * t;
      if (r_a < L) *reinterpret_cast<float2*>(orow + (long)r_a * D + col) = make_float2(acc[4 * jb], acc[4 * jb + 1]);
      if (r_b < L)
        *reinterpret_cast<float2*>(orow + (long)r_b * D + col) = make_float2(acc[4 * jb + 2], acc[4 * jb + 3]);
    }
  }
}

// ---- lab backward on persistent CTAs fed by TMA ------------------------------

constexpr int BWD_RING_WGS = 2;

// Token rows of a backward ring tile: round16(L) for rows of two or more
// 64-row blocks, else 64. A 64-row wgmma operand of the last block reads up
// to 48 rows past a tile of round16(L) rows; the tiles are laid out so that
// those rows are rows of the item's next tile, in shared memory the item
// owns (see lab_bwd_ring_kernel).
__host__ __device__ constexpr int bwd_ring_rows(int L) { return L <= 64 ? 64 : round16(L); }

constexpr int BWD_RING_MAX_STAGES = 2;

// Shared memory of the backward ring at head_dim 64 (lab.py::
// lab_bwd_smem_bytes mirrors it): 1 KB to align; per stage (item slot) Q,
// dO, V and K of one (b, h) (R = bwd_ring_rows(L) rows x 128 B each), with
// ds, one R x 128 B panel a 64-key block, after the first slot; a 64 x 64
// bf16 output tile a warpgroup; lse2 and delta (R f32 each); an mbarrier a
// stage and a release count.
size_t bwd_ring_smem(int L, int stages) {
  const int R = bwd_ring_rows(L), KB = (L + 63) / 64;
  return SW128_ALIGN + (size_t)(4 * stages + KB) * R * SW128_ROW + (size_t)BWD_RING_WGS * 64 * 64 * 2 +
         (size_t)8 * R + 16 * (size_t)stages;
}

// Store four 8 x 8 bf16 matrices transposed: r[i] is each lane's fragment of
// matrix i (row lane / 4, columns 2 (lane % 4) and + 1), and lane 8 i + c
// gives the address of the 16 bytes that receive column c of matrix i.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// Bring the box at (c0, c1, c2) of a tensor map into L2, ahead of its copy.
__device__ __forceinline__ void tma_prefetch_3d(const CUtensorMap* map, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// Two consumer warpgroups and no producer warp, head_dim 64, rows of KB
// 64-row blocks (at most 208 tokens). CTA x takes the (b, h) items x, x +
// gridDim.x, ...; STAGES (1 or 2) items are resident, each in a slot
// holding Q, dO, V and K, each a TMA box of R = bwd_ring_rows(L) token rows
// (zeros past L) over (D, L, B * H) in the 128-byte swizzle, in that order;
// ds follows the first slot. Per item:
//   1. warpgroup w takes query blocks w, w + 2, ...: over 64-key chunks, S =
//      Q K^T and dP = dO V^T by wgmma from shared memory, p = exp(s D^-1/2 -
//      lse) (ex2.approx of the scores scaled by D^-1/2 log2 e, lse taken to
//      base 2), delta = the f32 sum of p * dp over the keys below L; lse2 and
//      delta of each row go to shared memory;
//   2. warpgroup w takes key blocks w, w + 2, ...: over 64-query chunks, S^T
//      = K Q^T and dP^T = V dO^T (the second and last time any score is
//      multiplied), p^T and ds^T = bf16(p (dp - delta) D^-1/2) in registers
//      (0 wherever the query or the key is from L on), dv += bf16(p)^T dO and
//      dk += ds^T Q with p^T and ds^T as register A operands and dO and Q read
//      MN-major; ds^T also goes into ds's panel of this key block, transposed
//      by stmatrix into rows of queries (K-major for phase 3); dk and dv out;
//   3. warpgroup w takes query blocks w, w + 2, ...: dq = ds K, ds read
//      K-major and K MN-major, both from shared memory; dq out.
// A 64-row operand of the last block reads up to 48 rows past its tile of R
// rows. Those rows are never stored, and where they enter a sum (a product's
// reduction over tokens) they meet factors that are exactly 0 (p and ds of
// tokens from L on): what they hold must only be finite. So the tiles follow
// one another in the order Q, dO, V, K, ds, and each reads into the next:
// Q into dO, dO into V, K into ds, all the item's own values (V only ever
// reads past its rows as an A operand, whose extra rows are dropped); the
// last ds panel reads into what follows ds (dropped rows). Keys and queries
// from L on are masked by selection, never by a product, so no such value
// reaches a result (the second slot's K reads into the output tiles, which
// start as zeros). Thread 0 fills every slot at the start. With one slot,
// thread 0 copies the next item's Q, dO and V after phase 2 (phase 3 reads
// only K and ds), and the warpgroup that finishes phase 3 last copies its
// K; with two, that warpgroup refills the whole slot with the item two on.
// The item to be copied next is prefetched into L2 when an item starts
// (phases 1 and 2 read every tile). The gradients go out through each
// warpgroup's 64 x 64 tile by TMA stores over (D, L, B * H), which drop the
// rows from L on. Each gradient row has one owner: no atomics, and the result
// does not depend on scheduling.
template <int KB, int STAGES>
__global__ void __launch_bounds__(BWD_RING_WGS * 128, 1)
    lab_bwd_ring_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap dq_map,
                        const __grid_constant__ CUtensorMap dk_map,
                        const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ lse,
                        Layout lay, int items, int L, int H, float scale) {
  constexpr int NWG = BWD_RING_WGS;
  constexpr int BLOCK = 64 * SW128_ROW;  // bytes of 64 rows of a tile
  const int R = bwd_ring_rows(L);
  const int T = R * SW128_ROW;           // bytes of one tile
  const int SLOT = (4 + KB) * T;         // slot s at ring + s * SLOT; ds after slot 0

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* out_tiles = ring + (size_t)(4 * STAGES + KB) * T;  // 64 x 64 a warpgroup
  float* s_lse = reinterpret_cast<float*>(out_tiles + NWG * BLOCK);  // lse2 of each query
  float* s_delta = s_lse + R;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_delta + R);
  unsigned* released = reinterpret_cast<unsigned*>(full + STAGES);

  const int tid = threadIdx.x;
  // an item's Q, dO and V into slot s (with the expected bytes of all four
  // tiles), then its K apart: K is read until the item's last product
  auto load_qov = [&](int s, int item) {
    unsigned char* dst = ring + (size_t)s * SLOT;
    mbar_expect_tx(&full[s], 4 * T);
    tma_load_3d(dst, &q_map, &full[s], 0, 0, item);
    tma_load_3d(dst + T, &do_map, &full[s], 0, 0, item);
    tma_load_3d(dst + 2 * T, &v_map, &full[s], 0, 0, item);
  };
  auto load_k = [&](int s, int item) {
    tma_load_3d(ring + (size_t)s * SLOT + 3 * T, &k_map, &full[s], 0, 0, item);
  };
  for (int i = tid; i < NWG * BLOCK / 16; i += NWG * 128)
    reinterpret_cast<uint4*>(out_tiles)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // the zeros, written by the threads, are read by wgmma
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    *released = 0;
    mbar_fence_init();
    for (int s = 0; s < STAGES && (int)(blockIdx.x + s * gridDim.x) < items; ++s) {
      load_qov(s, blockIdx.x + s * gridDim.x);
      load_k(s, blockIdx.x + s * gridDim.x);
    }
  }
  __syncthreads();

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w16 = (warp % 4) * 16;  // this warp's rows within a 64-row block
  const float c2 = scale * LOG2E;
  const uint32_t base = smem_addr(ring);
  const uint32_t sds = base + 4 * T;
  const bool leader = tid % 128 == 0;
  unsigned char* tile = out_tiles + wg * BLOCK;

  // bf16 of a 64 x 64 accumulator out through this warpgroup's tile by one
  // TMA store at token row row0 of `item` (rows from L on are dropped); the
  // tile is free once the previous store has read it
  auto store_block = [&](const float (&acc)[32], const CUtensorMap* map, int row0, int item) {
    if (leader) bulk_wait_read<0>();
    named_barrier(2 + wg, 128);
    const int ra = w16 + g;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(ra, jb) + 4 * t) = pack_bf16(acc[4 * jb], acc[4 * jb + 1]);
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(ra + 8, jb) + 4 * t) =
          pack_bf16(acc[4 * jb + 2], acc[4 * jb + 3]);
    }
    fence_proxy_async();  // the tile, written by the threads, is read by TMA
    named_barrier(2 + wg, 128);
    if (leader) {
      tma_store_3d(map, tile, 0, row0, item);
      bulk_commit();
    }
  };

  int n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int b = item / H, h = item % H;
    const int slot = n % STAGES;
    const int refill = item + STAGES * (int)gridDim.x;  // the item this slot takes next
    if (tid == 0 && refill < items) {
      tma_prefetch_3d(&q_map, 0, 0, refill);
      tma_prefetch_3d(&do_map, 0, 0, refill);
      tma_prefetch_3d(&v_map, 0, 0, refill);
      tma_prefetch_3d(&k_map, 0, 0, refill);
    }
    const uint32_t sq = base + slot * SLOT, sdo = sq + T, sv = sq + 2 * T, sk = sq + 3 * T;
    mbar_wait(&full[slot], (n / STAGES) & 1);

    // 1. delta of each query row of this warpgroup's blocks: S and dP of
    //    64-key chunk kc into buffer kc % 2, chunk kc + 1's products running
    //    while chunk kc's p and p * dp are taken
    const float* lrow = lse + b * lay.lse_b + h * lay.lse_h;
#pragma unroll 1
    for (int qb = wg; qb < KB; qb += NWG) {
      const int ra = qb * 64 + w16 + g, rb = ra + 8;
      const float la = ra < L ? lrow[ra] * LOG2E : 0.f, lb = rb < L ? lrow[rb] * LOG2E : 0.f;
      float da[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};
      float s[2][32], dp[2][32];
      auto scores = [&](int kc) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64<0>(s[kc % 2], sw128_desc(sq + qb * BLOCK) + 2 * kk, sw128_desc(sk + kc * BLOCK) + 2 * kk,
                        kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64<0>(dp[kc % 2], sw128_desc(sdo + qb * BLOCK) + 2 * kk, sw128_desc(sv + kc * BLOCK) + 2 * kk,
                        kk > 0);
        wgmma_commit();
      };
      scores(0);
#pragma unroll
      for (int kc = 0; kc < KB; ++kc) {
        if (kc + 1 < KB) {
          scores(kc + 1);
          wgmma_wait<1>();  // chunk kc has retired, chunk kc + 1 may still run
        } else {
          wgmma_wait<0>();
        }
        fence_operands(s[kc % 2]);
        fence_operands(dp[kc % 2]);
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc * 64 + jb * 8 + 2 * t + (e & 1);
            const float pr = exp2_approx(fmaf(s[kc % 2][4 * jb + e], c2, -(e < 2 ? la : lb)));
            const float term = key < L ? pr * dp[kc % 2][4 * jb + e] : 0.f;
            if (e < 2)
              da[jb % 2] += term;
            else
              db[jb % 2] += term;
          }
      }
      const float delta_a = quad_sum(da[0] + da[1]), delta_b = quad_sum(db[0] + db[1]);
      if (t == 0) {
        if (ra < R) {
          s_lse[ra] = la;
          s_delta[ra] = delta_a;
        }
        if (rb < R) {
          s_lse[rb] = lb;
          s_delta[rb] = delta_b;
        }
      }
    }
    named_barrier(1, NWG * 128);  // every lse2 and delta is in shared memory

    // 2. dk and dv of each key row of this warpgroup's blocks, over 64-query
    //    chunks; ds into shared memory. S^T and dP^T of chunk qc + 1 are
    //    issued with chunk qc's dv and dk products, in one group.
#pragma unroll 1
    for (int kb = wg; kb < KB; kb += NWG) {
      const int ka = kb * 64 + w16 + g, kbb = ka + 8;
      float dk[32], dv[32], st[32], dpt[32];
      // p^T and ds^T: rows are keys, columns queries; pa[c] and da[c] the A
      // fragments of the 16 queries from qc * 64 + 16 c
      uint32_t pa[4][4], da[4][4];
      auto scores = [&](int qc) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64<0>(st, sw128_desc(sk + kb * BLOCK) + 2 * kk, sw128_desc(sq + qc * BLOCK) + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64<0>(dpt, sw128_desc(sv + kb * BLOCK) + 2 * kk, sw128_desc(sdo + qc * BLOCK) + 2 * kk,
                        kk > 0);
      };
      wgmma_fence();
      scores(0);
      wgmma_commit();
#pragma unroll
      for (int qc = 0; qc < KB; ++qc) {
        wgmma_wait<0>();  // chunk qc's scores and chunk qc - 1's products have retired
        fence_operands(st);
        fence_operands(dpt);
        fence_operands(pa);
        fence_operands(da);
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          float pr[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = qc * 64 + jb * 8 + 2 * t + (e & 1);
            const bool visible = q < L && (e < 2 ? ka : kbb) < L;
            const float lq = q < L ? s_lse[q] : 0.f, dl = q < L ? s_delta[q] : 0.f;
            const float x = exp2_approx(fmaf(st[4 * jb + e], c2, -lq));
            pr[e] = visible ? x : 0.f;
            ds[e] = visible ? x * (dpt[4 * jb + e] - dl) * scale : 0.f;
          }
          pa[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(pr[0], pr[1]);
          pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
          da[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          da[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // ds of these 64 keys and 64 queries into the key block's panel, rows
        // of queries (below R): 8 x 8 matrix i of da[c] holds keys 8 (i % 2) ..
        // and queries 8 (i / 2) .. of the 16 from qc * 64 + 16 c
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q0 = qc * 64 + 16 * c;
          if (q0 < R) {
            const int i = lane / 8;
            stmatrix_x4_trans(sds + kb * T + sw128_offset(q0 + 8 * (i / 2) + lane % 8, w16 / 8 + i % 2), da[c]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t row = (qc * 64 + 16 * c) * SW128_ROW;
          wgmma_rs64<1>(dv, pa[c], sw128_mn_desc(sdo + row, T), qc > 0 || c > 0);
          wgmma_rs64<1>(dk, da[c], sw128_mn_desc(sq + row, T), qc > 0 || c > 0);
        }
        if (qc + 1 < KB) scores(qc + 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operands(pa);
      fence_operands(da);
      fence_operands(dv);
      fence_operands(dk);
      store_block(dk, &dk_map, kb * 64, item);
      store_block(dv, &dv_map, kb * 64, item);
    }
    fence_proxy_async();          // ds, written by the threads, is read by wgmma
    named_barrier(1, NWG * 128);  // ds is whole; Q, dO and V are free
    if (STAGES == 1 && tid == 0 && refill < items) load_qov(0, refill);

    // 3. dq of each query row of this warpgroup's blocks
#pragma unroll 1
    for (int qb = wg; qb < KB; qb += NWG) {
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KB; ++kc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64<1>(dq, sw128_desc(sds + kc * T + qb * BLOCK) + 2 * kk,
                        sw128_mn_desc(sk + (kc * 64 + 16 * kk) * SW128_ROW, T), kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq);
      store_block(dq, &dq_map, qb * 64, item);
    }

    // K (and with two slots the whole slot) is free once both warpgroups'
    // products have retired: the last to finish refills it
    if (leader) {
      __threadfence_block();
      if (atomicAdd(released, 1u) == NWG - 1) {
        __threadfence_block();
        *released = 0;
        if (refill < items) {
          if (STAGES > 1) load_qov(slot, refill);
          load_k(slot, refill);
        }
      }
    }
  }
  if (leader) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
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

// The backward ring (head_dim 64) on `grid` persistent CTAs with STAGES item slots.
template <int KB, int STAGES>
int bwd_ring(const void* q, const void* k, const void* v, const void* dout, const void* lse, void* dq,
             void* dk, void* dv, Layout lay, int B, int L, int H, float scale, int grid, void* stream) {
  auto kernel = lab_bwd_ring_kernel<KB, STAGES>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_ring_smem(L, STAGES);
  if ((long)B * H > INT_MAX || grid < 1 || smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // [B * H][L][64]: q, k, v, do in boxes of the tile's rows (zeros past L);
  // dq, dk, dv in 64-row blocks (rows past L not written)
  const uint64_t dims[3] = {64, (uint64_t)L, (uint64_t)B * H};
  CUtensorMap maps[7];
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (!tensor_map_bf16(&maps[i], ptrs[i], 3, dims, i < 4 ? bwd_ring_rows(L) : 64))
      return (int)cudaErrorInvalidValue;
  kernel<<<grid, BWD_RING_WGS * 128, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], static_cast<const float*>(lse), lay,
      B * H, L, H, scale);
  return (int)cudaGetLastError();
}

// grid and stages: the launch plan, lab.py::lab_bwd_plan; a grid of 0 takes
// one CTA per (b, h); the ring takes head_dim 64, rows of at most 208 tokens
// and one or two item slots (two up to 144 tokens)
int bwd_dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 void* dq, void* dk, void* dv, Layout lay, int B, int L, int H, int D, float scale,
                 int grid, int stages, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || grid < 0) return (int)cudaErrorInvalidValue;
  if (grid == 0) {
    if (D == 64) return bwd<64>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, stream);
    if (D == 128) return bwd<128>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (D != 64 || stages < 1 || stages > BWD_RING_MAX_STAGES) return (int)cudaErrorInvalidValue;
  const bool two = stages == 2;
  switch ((L + 63) / 64) {
    case 1:
      return two ? bwd_ring<1, 2>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream)
                 : bwd_ring<1, 1>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream);
    case 2:
      return two ? bwd_ring<2, 2>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream)
                 : bwd_ring<2, 1>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream);
    case 3:
      return two ? bwd_ring<3, 2>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream)
                 : bwd_ring<3, 1>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream);
    case 4:  // two items of 193 to 208 tokens do not fit
      return two ? (int)cudaErrorInvalidValue
                 : bwd_ring<4, 1>(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, scale, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
int pv_cta(const void* p, const void* v, void* out, int B, int L, int H, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  const int rows = round16(L);
  const size_t smem = (size_t)rows * (rows + 8) * 2 + (size_t)2 * rows * (D + 8) * 2;
  return launch(lab_pv_kernel<D>, allowed, (long)B, 2 * rows, smem, stream,
                static_cast<const bf16*>(p), static_cast<const bf16*>(v), static_cast<float*>(out),
                L, H);
}

// The P V ring on `grid` persistent CTAs with `stages` V slots.
template <int D, int NWG>
int pv_ring(const void* p, const void* v, void* out, int B, int L, int H, int grid, int stages,
            void* stream) {
  auto kernel = lab_pv_ring_kernel<D, NWG>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, MAX_SMEM, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pv_ring_smem(L, H * D, stages);
  if (grid < 1 || stages < PV_MIN_STAGES || stages > PV_MAX_STAGES || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // v as [B][L][H * D] in boxes of 16 token rows x 64 columns: rows past L read as zeros
  const uint64_t dims[3] = {(uint64_t)H * D, (uint64_t)L, (uint64_t)B};
  CUtensorMap v_map;
  if (!tensor_map_bf16(&v_map, v, 3, dims, 16)) return (int)cudaErrorInvalidValue;
  kernel<<<grid, NWG * 128 + 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p), v_map, static_cast<float*>(out), B, L, H, stages);
  return (int)cudaGetLastError();
}

// grid and stages: the launch plan, lab.py::lab_pv_plan; a grid of 0 takes
// one CTA per batch row
template <int D>
int pv(const void* p, const void* v, void* out, int B, int L, int H, int grid, int stages, void* stream) {
  if (grid == 0) return pv_cta<D>(p, v, out, B, L, H, stream);
  if (pv_ring_wgs(L) == 1) return pv_ring<D, 1>(p, v, out, B, L, H, grid, stages, stream);
  return pv_ring<D, 2>(p, v, out, B, L, H, grid, stages, stream);
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

// q, k, v, do, dq, dk, dv [B, H, L, D]; lse [H, B, L]; grid, stages:
// lab.py::lab_bwd_plan (a grid of 0 takes one CTA per (b, h))
extern "C" int latteclip_lab_bwd_bhld(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, int B, int L, int H, int D, float scale, int grid,
                                      int stages, void* stream) {
  const Layout lay{(long)H * L * D, (long)L * D, D, L, (long)B * L};
  return bwd_dispatch(q, k, v, dout, lse, dq, dk, dv, lay, B, L, H, D, scale, grid, stages, stream);
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

// p [B, L, L], v [B, L, H*D] -> o [B, L, D] f32 (L <= 128, D 64 or 128); grid,
// stages: lab.py::lab_pv_plan (a grid of 0 takes one CTA per batch row)
extern "C" int latteclip_lab_pv(const void* p, const void* v, void* o, int B, int L, int H, int D,
                                int grid, int stages, void* stream) {
  if (B <= 0 || L <= 0 || L > PROD_MAX_L || H <= 0 || grid < 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return pv<64>(p, v, o, B, L, H, grid, stages, stream);
  if (D == 128) return pv<128>(p, v, o, B, L, H, grid, stages, stream);
  return (int)cudaErrorInvalidValue;
}
