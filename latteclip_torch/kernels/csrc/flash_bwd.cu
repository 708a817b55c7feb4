// Backward flash attention for the CLIP towers on Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of latteclip_tpu/kernels/attention.py:
//   latteclip_flash_bwd      <- _bwd_kernel      (whole-row, optional causal)
//   latteclip_flash_bwd_seg  <- _bwd_kernel_seg  (segment-masked rows, optional causal)
//   latteclip_flash_bwd_hs   <- _bwd_kernel_hs   (head-split, whole-row)
// All take the forward's residuals, qkv [B, L, 3*H*D] (laid out [q | k | v],
// bf16), out [B, L, H*D] bf16 and the base-2 logsumexp lse2 f32, with the
// cotangent dout [B, L, H*D] bf16, and write the gradient dqkv [B, L, 3*H*D]
// bf16 in the layout of qkv, so the in-projection's backward reads it as it
// is. The first two read lse2 as [B, H, L]; the head-split kernel reads the
// head-split forward's lse2 [H/HP, HP, B, L] ([H, B, L] in memory). The TPU
// kernel writes dqkv3 [3, B, L, H*D] and JAX moves the axis afterwards
// (attention.py:842); here the store's strides put each gradient row where
// that move would, so no copy follows and no rounding moves.
//
// Numerics follow the TPU kernel step by step, per (row b, head h):
//   s2 = bf16(q * D^-1/2 * log2 e) . k^T in f32, masked entries dropped;
//   p = exp2(s2 - lse2) in f32 (no max pass: lse2 normalises), pb = bf16(p);
//   dv = pb^T . do;  dp = do . v^T;  delta = rowsum(f32(do) * f32(out));
//   ds = bf16(p * (dp - delta) * D^-1/2);  dq = ds . k;  dk = ds^T . q
// with every product accumulated in f32 and rounded to bf16 once. Only the
// f32 summation order differs (and the ring's and the streamed pair's exp2,
// ex2.approx at ~2^-22 relative, well below the bf16 rounding of p and ds).
//
// Bound. Like the forward, the backward is memory-bound at the train shapes:
// packed captions at R=300, P=128, H=8, D=64 (about four 32-token captions
// a row) do 10*D*H*(visible pairs), about 3 GFLOP, against 2*R*P*8*H*D
// bytes (qkv, out, dout read, dqkv written), about 315 MB: 10 FLOP/byte
// against the H100's ~295. So the design reads each input once where it
// can and keeps p and ds on chip:
//   * rows of at most 128 tokens take flash_bwd_ring_kernel (the launch
//     plan attention.py::bwd_short_row_plan): persistent CTAs, each walking
//     (row, head) items with one producer warp that keeps the items' Q, K,
//     V, dO and out in flight by TMA through a ring of full/empty mbarrier
//     slots, and one consumer warpgroup per 64 rows. Per item the consumers
//     take delta = rowsum(f32(dO) f32(out)) from the slot, so no pre-pass
//     launches and dO is read once, and overwrite out with Qs = bf16(q *
//     qscale), the shared-memory B operand of the transposed scores; then
//     each warpgroup takes dk and dv of its 64 keys (K Qs^T, V dO^T, then
//     pT dO and dsT Q by wgmma, p and ds repacked in registers as A) and dq
//     of its 64 queries (Qs K^T, dO V^T, then ds K). At D = 128, or with two
//     warpgroups at D = 64 (two CTAs an SM, 112 registers a thread), dk and
//     dv take separate passes that each compute the scores. Rows of 65..96
//     tokens (text at 77), and cases whose (row, head) items are no more
//     than the SMs (or than four an SM where the two passes run), take the
//     warp ring below at D = 64 and the delta pre-pass and the row kernel at
//     D = 128;
//   * the warp ring (flash_bwd_warp_ring_kernel, D = 64) keeps the row
//     kernel's partition and arithmetic, one warp per 16-token block with
//     mma.sync, on persistent CTAs (two of up to five consumer warps an SM
//     up to 80 tokens, one of up to eight beyond) whose producer warp keeps
//     the items' Q, K, V, dO and out in flight by TMA through mbarrier slots
//     and takes delta from each slot between the copy landing and the slot
//     being marked full: no pre-pass launches, out and dO are read once, and
//     the next item's copy overlaps this one's products and stores; the
//     gradients leave by TMA store into dqkv in the layout of qkv. Its sums
//     run in the row kernel's and the pre-pass's order, so the two give the
//     same bits. D = 128 keeps the row kernel: dk and dv alone take 128 f32
//     registers a thread there, and a slot of five 80-row tiles is 100 KB;
//   * the row kernel and the tiled pair follow a pre-pass that writes delta
//     [B, H, L] f32 (read once from out and dout);
//   * the row kernel takes one CTA per (row, head) and copies the whole
//     row's Q, K, V and dO into shared memory once (rows padded by 16 bytes
//     for conflict-free ldmatrix). Warp w owns the 16-token blocks w, w +
//     warps, ...: for each it accumulates the block's dk and dv over every
//     query, from the transposed scores K . Qs^T and V . dO^T, and then, for
//     each again, the block's dq over every key. Each gradient row has one
//     owner, so there are no atomics and the result does not depend on
//     scheduling. Causal work per key block falls with its index and per
//     query block rises, so every warp's sum is the same. Rows of at most
//     128 tokens take one warp a block (at most 8). Longer rows take it at
//     D = 128 under the launch plan (attention.py::bwd_long_row_plan) where
//     the padded row fits a CTA's shared memory (up to 208 tokens: 229,632 B
//     at 197 with segment ids), one CTA of at most 8 warps an SM, so that dk
//     and dv (128 f32 accumulators) stay in registers, and at D = 64 only when
//     the entry point is asked for it. No row kernel CTA has more than 8
//     warps. (An earlier form held D = 64 rows of up to 208 tokens unpadded,
//     the 16-byte chunks of each row permuted by row % 8, two CTAs of 8 warps
//     an SM; the streamed pair below beat it at ViT-B/16's 197 tokens and
//     replaced it: PERF.md keeps both times);
//   * rows of more than 128 tokens at D = 64 (ViT-B/16 at 197, ViT-L/14 at
//     257, 336 px at 577, SigLIP-512 at 1024; attention.py::bwd_long_row_plan)
//     take the streamed pair: two kernels on persistent CTAs of one consumer
//     warpgroup and one producer warp, three CTAs an SM, each CTA walking
//     items of one 64-token block of a (row, head), the block fastest, so
//     that the blocks of one (row, head) run side by side and re-read its
//     tiles from L2 rather than from device memory. The block's own tiles
//     stay in shared memory (two item slots, so the next item's copy
//     overlaps this one's products) and the rest of the row streams in
//     32-token chunks by TMA (128-byte swizzle, zeros past L) through a ring
//     of full/empty mbarrier slots; every product is a wgmma of one fixed
//     shape (m64n32k16 for the scores, m64n64k16 for the gradients), issued
//     unconditionally, with p and ds repacked in registers as the A
//     operand. The producer warp also does the per-item and per-chunk
//     passes that need no product, between a slot's copy landing and the
//     slot being marked full, so the consumers spend no time or barrier on
//     them. The dq kernel runs first: items of 64 queries with Q, dO and out
//     resident; the producer takes delta = rowsum(f32(dO) f32(out)) of the
//     item's queries, writes it to the delta scratch [B, H, L], which
//     replaces the pre-pass and its second read of out and dO (538 MB at
//     [512, 257, 16 x 64], 0.16 ms at 3.35 TB/s), and overwrites Q with
//     Qs; the consumers stream K and V: s = Qs K^T, dp = dO V^T, ds,
//     dq += ds K. The dk/dv kernel then takes items of 64 keys with K and V
//     resident and streams Q and dO with their lse2, delta and seg ids; the
//     producer writes each chunk's Qs into a third tile of its slot, and the
//     consumers take sT = K Qs^T and dpT = V dO^T, then dv += pT dO and
//     dk += dsT Q (Q and dO read MN-major). Each gradient row has one owner:
//     no atomics, and two calls are bit-equal. Both kernels compute the
//     scores (the price of no atomics: seven products instead of five).
//     Under a causal mask an item's chunks start (dk/dv) or end (dq) at its
//     diagonal. Overlap within a warpgroup is left to the three CTAs an SM:
//     splitting a chunk's products into groups waited for one at a time, or
//     issuing the next chunk's scores under the previous chunk's gradient
//     products, made ptxas serialise every wgmma (C7520: a compiler-inserted
//     warpgroup arrive on a divergent path) and ran slower (PERF.md). Head
//     width 128 has no streamed form: dk and dv alone take 128 f32 registers
//     a thread there, so the same template would hold one CTA an SM;
//   * D = 128 past 208 tokens takes the tiled pair: one CTA of 4 warps per
//     (row, head, 64-key tile) streams 64-query tiles for dk and dv, and one
//     per (row, head, 64-query tile) streams 64-key tiles for dq (Q, K, V
//     and dO re-read from L2 by every tile CTA, the scores computed in both,
//     each tile copied by cp.async and waited for before its products). It
//     is the first port's design, kept also as the -DLATTECLIP_BWD_SHORT_ROW=0
//     build that chip_smoke.py times beside every K3/K4 case;
//   * in the row and tile kernels, scores, p and ds live in mma
//     accumulators, 16 x 16 at a time, and are repacked in registers as the
//     A operand of the next product, so neither p nor ds touches shared
//     memory; every q, k, v and do fragment is reloaded with ldmatrix for
//     each block rather than held, which keeps D = 128 within registers
//     beside its 128 accumulators;
//   * the ragged edge is zero-filled to a multiple of 16 (of 64 in the ring
//     and the streamed pair's blocks, of 32 in its chunks) and masked, so
//     tokens beyond L contribute exactly
//     0; causal warps skip the 16 x 16 blocks above the diagonal;
//   * padding tokens (segment 0) see each other, as in the TPU kernel; their
//     cotangent is zero on the train path and their rows stay finite, since
//     every row keeps its diagonal.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes
// the delta scratch [B, H, L] f32, which the ring leaves unused), and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a launch plan it
// cannot run.

#include <climits>

#include "hopper.cuh"

namespace {

using namespace latteclip;

// Rows of at most SHORT_ROW tokens take the ring or the row kernel under
// their plan, longer ones follow theirs. Building with -DLATTECLIP_BWD_SHORT_ROW=0 sends
// every row, short or long, to the tiled pair whatever the plan says, which
// chip_smoke.py times beside the row kernel.
#ifndef LATTECLIP_BWD_SHORT_ROW
#define LATTECLIP_BWD_SHORT_ROW 128
#endif
constexpr int SHORT_ROW = LATTECLIP_BWD_SHORT_ROW;
static_assert(SHORT_ROW == 0 || SHORT_ROW == 128, "SHORT_ROW is 128, or 0 for the tiled pair alone");
constexpr bool TILED_ONLY = SHORT_ROW == 0;
constexpr int TILE = 64;  // query or key rows per tile of the tiled pair
constexpr int DELTA_THREADS = 256;
constexpr int SMEM_MAX = 232448;  // shared memory a CTA can take on an H100

constexpr int ROW_WARPS = 8;  // the most warps of a row kernel CTA: at D = 128 dk and dv
                              // take 128 f32 registers alone

// Shared-memory tiles of one CTA: Q and dO (q_rows), K and V (k_rows), then
// lse2 and delta of the query rows and, when segmented, the segment ids of
// the query rows and of the keys. ldmatrix reads 8 rows of 16 bytes at one
// column: rows padded by 16 bytes keep those in 8 bank groups.
template <int D>
struct Tiles {
  static constexpr int STRIDE = D + 8;  // shared row, in bf16 elements

  // element offset of (row, col)
  static __device__ __forceinline__ int off(int row, int col) { return row * STRIDE + col; }

  __nv_bfloat16 *q, *dout, *k, *v;
  float *lse, *delta;
  int *segq, *segk;

  __device__ Tiles(unsigned char* smem, int q_rows, int k_rows) {
    q = reinterpret_cast<__nv_bfloat16*>(smem);
    dout = q + q_rows * STRIDE;
    k = dout + q_rows * STRIDE;
    v = k + k_rows * STRIDE;
    lse = reinterpret_cast<float*>(v + k_rows * STRIDE);
    delta = lse + q_rows;
    segq = reinterpret_cast<int*>(delta + q_rows);
    segk = segq + q_rows;
  }

  static constexpr size_t bytes(int q_rows, int k_rows, bool seg) {
    return (size_t)(2 * q_rows + 2 * k_rows) * STRIDE * 2 + (size_t)q_rows * 8 +
           (seg ? (size_t)(q_rows + k_rows) * 4 : 0);
  }
};

// Where one (row b, head h) of the residuals lives.
struct Row {
  const __nv_bfloat16* qkv;   // token 0 of row b, head h's q columns
  const __nv_bfloat16* dout;  // token 0 of row b, head h's columns
  const float* lse;           // lse2[b, h, :]
  const float* delta;         // delta[b, h, :]
  const int* seg;             // seg[b, :] or nullptr
  __nv_bfloat16* dqkv;        // dq of token 0 of row b, head h, in the layout of qkv
  int L, HD;
};

// Copy n token rows from r0 on (one head's D columns, `stride` elements
// between tokens) into dst, 16 bytes a thread; rows beyond L are zero-filled.
template <int D>
__device__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long stride, int r0,
                          int n, int L) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < n * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const bool valid = r0 + r < L;
    cp_async_16(&dst[Tiles<D>::off(r, col)], src + (long)(valid ? r0 + r : 0) * stride + col,
                valid);
  }
}

// Q, dO and the per-query scalars of query rows [r0, r0 + n).
template <int D, bool SEG>
__device__ void load_queries(const Tiles<D>& t, const Row& row, int r0, int n) {
  copy_rows<D>(t.q, row.qkv, 3L * row.HD, r0, n, row.L);
  copy_rows<D>(t.dout, row.dout, row.HD, r0, n, row.L);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = r0 + i;
    const bool valid = j < row.L;
    t.lse[i] = valid ? row.lse[j] : 0.f;
    t.delta[i] = valid ? row.delta[j] : 0.f;
    if (SEG) t.segq[i] = valid ? row.seg[j] : -1;
  }
}

// K, V and the segment ids of key rows [r0, r0 + n).
template <int D, bool SEG>
__device__ void load_keys(const Tiles<D>& t, const Row& row, int r0, int n) {
  copy_rows<D>(t.k, row.qkv + row.HD, 3L * row.HD, r0, n, row.L);
  copy_rows<D>(t.v, row.qkv + 2L * row.HD, 3L * row.HD, r0, n, row.L);
  if (SEG)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      t.segk[i] = r0 + i < row.L ? row.seg[r0 + i] : -2;
}

// Phase 1, one warp: dk and dv of the 16 keys at local rows kr.. of the key
// tile (global index k0 = key_base + kr), over the queries at local rows
// [qr_lo, qr_hi) of the query tile (global index query_base + local).
// Scores are formed transposed, sT = K . Qs^T and dpT = V . dO^T, so each
// thread's accumulator rows are its keys and p and ds repack straight into
// A fragments for dv += pT . dO and dk += dsT . Q.
template <int D, bool SEG, bool CAUSAL>
__device__ void warp_dkdv(const Tiles<D>& t, int kr, int k0, int qr_lo, int qr_hi,
                          int query_base, int L, float qscale, float scale, float (&dk)[D / 8][4],
                          float (&dv)[D / 8][4]) {
  using T = Tiles<D>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int key[2] = {k0 + g, k0 + g + 8};
  int segk[2] = {0, 0};
  if (SEG) {
    segk[0] = t.segk[kr + g];
    segk[1] = t.segk[kr + g + 8];
  }
  for (int qr = qr_lo; qr < qr_hi; qr += 16) {
    float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4], qb[4], ob[4];
      const int ar = T::off(kr + a_row(lane), kk * 16 + a_col(lane));
      const int br = T::off(qr + b_row(lane), kk * 16 + b_col(lane));
      ldmatrix_x4(ka, &t.k[ar]);
      ldmatrix_x4(va, &t.v[ar]);
      ldmatrix_x4(qb, &t.q[br]);
      ldmatrix_x4(ob, &t.dout[br]);
#pragma unroll
      for (int e = 0; e < 4; ++e) qb[e] = scale_bf16x2(qb[e], qscale);
      mma_bf16(st[0], ka, qb[0], qb[1]);
      mma_bf16(st[1], ka, qb[2], qb[3]);
      mma_bf16(dpt[0], va, ob[0], ob[1]);
      mma_bf16(dpt[1], va, ob[2], ob[3]);
    }
    // pT and dsT of this 16 x 16 block; columns are queries
    float p[2][4], ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = qr + n * 8 + 2 * tq + (e & 1);
        const int qg = query_base + ql;
        const int r = e / 2;
        bool visible = qg < L && key[r] < L;
        if (CAUSAL) visible = visible && key[r] <= qg;
        if (SEG) visible = visible && t.segq[ql] == segk[r];
        p[n][e] = visible ? exp2f(st[n][e] - t.lse[ql]) : 0.f;
        ds[n][e] = p[n][e] * (dpt[n][e] - t.delta[ql]) * scale;
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t ob[4], qb[4];
      const int r = T::off(qr + a_row(lane), d2 * 16 + a_col(lane));
      ldmatrix_x4_trans(ob, &t.dout[r]);
      ldmatrix_x4_trans(qb, &t.q[r]);
      mma_bf16(dv[2 * d2], pa, ob[0], ob[1]);
      mma_bf16(dv[2 * d2 + 1], pa, ob[2], ob[3]);
      mma_bf16(dk[2 * d2], da, qb[0], qb[1]);
      mma_bf16(dk[2 * d2 + 1], da, qb[2], qb[3]);
    }
  }
}

// Phase 2, one warp: dq of the 16 queries at local rows qr.. of the query
// tile (global index q0), over the keys at local rows [kr_lo, kr_hi) of the
// key tile (global index key_base + local): s = Qs . K^T, dp = dO . V^T,
// then dq += ds . K.
template <int D, bool SEG, bool CAUSAL>
__device__ void warp_dq(const Tiles<D>& t, int qr, int q0, int kr_lo, int kr_hi, int key_base,
                        int L, float qscale, float scale, float (&dq)[D / 8][4]) {
  using T = Tiles<D>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int query[2] = {q0 + g, q0 + g + 8};
  const float lse[2] = {t.lse[qr + g], t.lse[qr + g + 8]};
  const float delta[2] = {t.delta[qr + g], t.delta[qr + g + 8]};
  int segq[2] = {0, 0};
  if (SEG) {
    segq[0] = t.segq[qr + g];
    segq[1] = t.segq[qr + g + 8];
  }
  for (int kr = kr_lo; kr < kr_hi; kr += 16) {
    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4], kb[4], vb[4];
      const int ar = T::off(qr + a_row(lane), kk * 16 + a_col(lane));
      const int br = T::off(kr + b_row(lane), kk * 16 + b_col(lane));
      ldmatrix_x4(qa, &t.q[ar]);
      ldmatrix_x4(oa, &t.dout[ar]);
      ldmatrix_x4(kb, &t.k[br]);
      ldmatrix_x4(vb, &t.v[br]);
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = scale_bf16x2(qa[e], qscale);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
      mma_bf16(dp[0], oa, vb[0], vb[1]);
      mma_bf16(dp[1], oa, vb[2], vb[3]);
    }
    float ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kr + n * 8 + 2 * tq + (e & 1);
        const int kg = key_base + kl;
        const int r = e / 2;
        bool visible = query[r] < L && kg < L;
        if (CAUSAL) visible = visible && kg <= query[r];
        if (SEG) visible = visible && t.segk[kl] == segq[r];
        const float p = visible ? exp2f(s[n][e] - lse[r]) : 0.f;
        ds[n][e] = p * (dp[n][e] - delta[r]) * scale;
      }
    }
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t kb[4];
      ldmatrix_x4_trans(kb, &t.k[T::off(kr + a_row(lane), d2 * 16 + a_col(lane))]);
      mma_bf16(dq[2 * d2], da, kb[0], kb[1]);
      mma_bf16(dq[2 * d2 + 1], da, kb[2], kb[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Round a warp's 16 accumulator rows (global rows r0..r0+15) to bf16 and
// store those below L into part `part` of dqkv (0 dq, 1 dk, 2 dv).
template <int D>
__device__ void store_rows(const Row& row, int part, int r0, const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x % 32;
  const int ra = r0 + lane / 4, rb = ra + 8;
  const long stride = 3L * row.HD;
  __nv_bfloat16* base = row.dqkv + (long)part * row.HD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * (lane % 4);
    if (ra < row.L)
      *reinterpret_cast<uint32_t*>(&base[ra * stride + col]) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < row.L)
      *reinterpret_cast<uint32_t*>(&base[rb * stride + col]) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// Where lse2 comes from: [B, H, L], or with `split` (the head-split kernel)
// [H, B, L].
struct Layout {
  int B;
  bool split;
};

__device__ Row make_row(const __nv_bfloat16* qkv, const int* seg, const __nv_bfloat16* dout,
                        const float* lse, const float* delta, __nv_bfloat16* dqkv, int b, int h,
                        int L, int H, int D, Layout layout) {
  const int HD = H * D;
  const long tok0 = (long)b * L;
  Row row;
  row.qkv = qkv + tok0 * 3 * HD + (long)h * D;
  row.dout = dout + tok0 * HD + (long)h * D;
  row.lse = lse + (layout.split ? (long)h * layout.B + b : (long)b * H + h) * L;
  row.delta = delta + ((long)b * H + h) * L;
  row.seg = seg ? seg + tok0 : nullptr;
  row.dqkv = dqkv + tok0 * 3 * HD + (long)h * D;
  row.L = L;
  row.HD = HD;
  return row;
}

// delta[b, h, l] = sum_d f32(dout) * f32(out) over one head's D columns;
// one thread per (token, head), 16-byte loads.
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                       const __nv_bfloat16* __restrict__ dout,
                                       float* __restrict__ delta, long n, int L, int H, int D) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int h = i % H;
  const long tok = i / H;  // b * L + l
  const long base = tok * H * D + (long)h * D;
  float acc = 0.f;
  for (int c = 0; c < D; c += 8) {
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + base + c);
    const uint4 g4 = *reinterpret_cast<const uint4*>(dout + base + c);
    const uint32_t o[4] = {o4.x, o4.y, o4.z, o4.w};
    const uint32_t g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fo = __bfloat1622float2(as_bf162(o[e]));
      const float2 fg = __bfloat1622float2(as_bf162(g[e]));
      acc += fg.x * fo.x;
      acc += fg.y * fo.y;
    }
  }
  const long b = tok / L, l = tok % L;
  delta[(b * H + h) * L + l] = acc;
}

// One CTA per (row, head), the whole row in shared memory for both phases;
// warp w owns the 16-token blocks w, w + warps, ... in each. At D = 64 two
// CTAs of 8 warps must fit an SM's registers (128 a thread): without that bound
// ptxas gives the short-row kernel 145-158 and one CTA an SM, which made K4
// at [256, 100, 12 x 64] 1.4x slower.
template <int D, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(ROW_WARPS * 32, D == 64 ? 2 : 1)
    flash_bwd_row_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ seg,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                         int L, int H, float qscale, float scale, Layout layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L);
  const Tiles<D> t(smem, rows, rows);
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const Row row = make_row(qkv, seg, dout, lse, delta, dqkv, b, h, L, H, D, layout);
  load_queries<D, SEG>(t, row, 0, rows);
  load_keys<D, SEG>(t, row, 0, rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int first = threadIdx.x / 32, warps = blockDim.x / 32, nblk = rows / 16;
  float acc_a[D / 8][4], acc_b[D / 8][4];
  for (int blk = first; blk < nblk; blk += warps) {  // the block's 16 keys: dk, dv
    const int r0 = blk * 16;
    zero<D>(acc_a);
    zero<D>(acc_b);
    warp_dkdv<D, SEG, CAUSAL>(t, r0, r0, CAUSAL ? r0 : 0, rows, 0, L, qscale, scale, acc_a, acc_b);
    store_rows<D>(row, 1, r0, acc_a);  // dk
    store_rows<D>(row, 2, r0, acc_b);  // dv
  }
  for (int blk = first; blk < nblk; blk += warps) {  // the block's 16 queries: dq
    const int r0 = blk * 16;
    zero<D>(acc_a);
    warp_dq<D, SEG, CAUSAL>(t, r0, r0, 0, CAUSAL ? r0 + 16 : rows, 0, L, qscale, scale, acc_a);
    store_rows<D>(row, 0, r0, acc_a);  // dq
  }
}

// Longer rows, phase 1: one CTA of 4 warps per (row, head, 64-key tile)
// walks the 64-query tiles that can see its keys.
template <int D, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(4 * 32)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ seg,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                          int L, int H, float qscale, float scale, Layout layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<D> t(smem, TILE, TILE);
  const int n_t = (L + TILE - 1) / TILE;
  const int kt = blockIdx.x % n_t;
  const int h = (blockIdx.x / n_t) % H, b = blockIdx.x / (n_t * H);
  const Row row = make_row(qkv, seg, dout, lse, delta, dqkv, b, h, L, H, D, layout);
  const int key_base = kt * TILE;
  const int kr = (threadIdx.x / 32) * 16;
  const int k0 = key_base + kr;
  load_keys<D, SEG>(t, row, key_base, TILE);

  float dk[D / 8][4], dv[D / 8][4];
  zero<D>(dk);
  zero<D>(dv);
  for (int qt = CAUSAL ? kt : 0; qt < n_t; ++qt) {
    const int query_base = qt * TILE;
    const int q_rows = min(TILE, round16(L - query_base));
    __syncthreads();  // every warp is done with the previous query tile
    load_queries<D, SEG>(t, row, query_base, q_rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (k0 < L)
      warp_dkdv<D, SEG, CAUSAL>(t, kr, k0, CAUSAL && qt == kt ? kr : 0, q_rows, query_base, L,
                                qscale, scale, dk, dv);
  }
  store_rows<D>(row, 1, k0, dk);
  store_rows<D>(row, 2, k0, dv);
}

// Longer rows, phase 2: one CTA of 4 warps per (row, head, 64-query tile)
// walks the 64-key tiles its queries can see.
template <int D, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(4 * 32)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ seg,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv, int L,
                        int H, float qscale, float scale, Layout layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<D> t(smem, TILE, TILE);
  const int n_t = (L + TILE - 1) / TILE;
  const int qt = blockIdx.x % n_t;
  const int h = (blockIdx.x / n_t) % H, b = blockIdx.x / (n_t * H);
  const Row row = make_row(qkv, seg, dout, lse, delta, dqkv, b, h, L, H, D, layout);
  const int qr = (threadIdx.x / 32) * 16;
  const int q0 = qt * TILE + qr;
  load_queries<D, SEG>(t, row, qt * TILE, TILE);

  float dq[D / 8][4];
  zero<D>(dq);
  const int kt_end = CAUSAL ? qt : n_t - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int key_base = kt * TILE;
    const int k_rows = min(TILE, round16(L - key_base));
    __syncthreads();  // every warp is done with the previous key tile
    load_keys<D, SEG>(t, row, key_base, k_rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (q0 < L)
      warp_dq<D, SEG, CAUSAL>(t, qr, q0, 0, CAUSAL && kt == qt ? min(qr + 16, k_rows) : k_rows,
                              key_base, L, qscale, scale, dq);
  }
  store_rows<D>(row, 0, q0, dq);
}

// ---- rows of at most 128 tokens: persistent CTAs fed by a TMA ring ----------

constexpr int RING_MAX_STAGES = 4;

// Shared memory of the ring kernel (attention.py::bwd_short_row_smem_bytes
// mirrors it): 1 KB to align the swizzled tiles, then per stage Q, K, V, dO
// and out of one (row, head), D / 64 panels of `box` token rows x 128 B each,
// then per stage lse2, delta and (SEG) the seg ids of the box's tokens, then
// the full and empty mbarriers.
template <int D>
constexpr size_t ring_smem_bytes(int box, int stages, bool seg) {
  return SW128_ALIGN + (size_t)stages * (5 * D * box * 2 + (seg ? 12 : 8) * box) + 16 * (size_t)stages;
}

// Round the 16 accumulator rows of a warp (rows r_a = lane / 4 and r_b =
// r_a + 8 of the (row, head)) to bf16 and store those below L into part
// `part` of dqkv (0 dq, 1 dk, 2 dv; `base` is dq of token 0, `tok` the
// elements between tokens).
template <int D>
__device__ __forceinline__ void store_part(const float (&acc)[D / 2], __nv_bfloat16* base, int part,
                                           int HD, long tok, int r_a, int r_b, int L, int lane) {
  uint32_t a[D / 8], b[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    a[j] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    b[j] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __nv_bfloat16* p = base + (long)part * HD;
  store_rows_bf16<D / 8>(a, b, r_a < L ? p + r_a * tok : nullptr, r_b < L ? p + r_b * tok : nullptr,
                         lane);
}

// dst (+)= A . B with A a 64 x 16 fragment in registers and B the MN-major
// D-wide rows of a tile at `addr` (16 rows of the reduction), N = D.
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t addr,
                                           uint32_t panel) {
  const uint64_t db = sw128_mn_desc(addr, panel);
  if constexpr (D == 64)
    wgmma_rs64<1>(d, a, db, 1);
  else
    wgmma_rs128<1>(d, a, db, 1);
}

// wgmma_ss with N = C (32 or 64), B K-major.
template <int C, int K>
__device__ __forceinline__ void wgmma_ss_c(float (&d)[K], uint64_t da, uint64_t db, int scale_d) {
  static_assert(C == 32 || C == 64, "chunks of 32 or 64");
  if constexpr (C == 32)
    wgmma_ss32<0>(d, da, db, scale_d);
  else
    wgmma_ss64<0>(d, da, db, scale_d);
}

// Phase 1 of the ring kernel for one warpgroup, owning keys 64 wg ..
// 64 wg + 63 (accumulator rows r_a, r_b): over 32-query chunks, sT = K Qs^T
// (and, for dk, dpT = V dO^T) by wgmma from shared memory, then p (and ds)
// of each (key, query) in registers, then dv += pT dO (DV) and dk += dsT Q
// (DK) with pT and dsT as register A operands and dO and Q read MN-major.
// The tiles are the stage's Q (qb), K, V, dO and Qs at those addresses; sl,
// sd and ss its lse2, delta and seg ids.
template <int D, int C, bool SEG, bool CAUSAL, bool DK, bool DV>
__device__ __forceinline__ void dkdv_pass(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t kb,
                                          uint32_t vb, uint32_t dob, uint32_t qb, uint32_t qsb,
                                          const float* sl, const float* sd, const int* ss, int wg,
                                          int r_a, int r_b, int L, int rows, float scale) {
  constexpr int PANEL_ROWS = 64 * SW128_ROW;  // a warpgroup's 64 rows of a panel
  const int panel = (rows > 64 ? 128 : 64) * SW128_ROW;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if (DK) dk[i] = 0.f;
    if (DV) dv[i] = 0.f;
  }
  int segk[2] = {0, 0};
  if (SEG) {
    segk[0] = ss[r_a];
    segk[1] = ss[r_b];
  }
  // every wgmma has a fixed shape and runs unconditionally (see the forward's
  // ring kernel); queries past L are zeros and masked
  for (int qc = CAUSAL ? wg * 64 : 0; qc < rows; qc += C) {
    float st[C / 2], dpt[C / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pan = (kk / 4) * panel, k2 = 2 * (kk % 4);
      wgmma_ss_c<C>(st, sw128_desc(kb + pan + wg * PANEL_ROWS) + k2,
                    sw128_desc(qsb + pan + qc * SW128_ROW) + k2, kk > 0);
      if constexpr (DK)
        wgmma_ss_c<C>(dpt, sw128_desc(vb + pan + wg * PANEL_ROWS) + k2,
                      sw128_desc(dob + pan + qc * SW128_ROW) + k2, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // pT and dsT: rows are keys, columns queries
    uint32_t pa[C / 16][4], da[C / 16][4];
#pragma unroll
    for (int jb = 0; jb < C / 8; ++jb) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qc + jb * 8 + 2 * t + (e & 1);
        const int k = e < 2 ? r_a : r_b;
        bool visible = q < L && k < L;
        if (CAUSAL) visible = visible && k <= q;
        if (SEG) visible = visible && ss[q] == segk[e / 2];
        p[e] = visible ? exp2_approx(st[4 * jb + e] - sl[q]) : 0.f;
        ds[e] = p[e] * (dpt[4 * jb + e] - sd[q]) * scale;
      }
      pa[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C / 16; ++c) {
      const uint32_t row = (qc + 16 * c) * SW128_ROW;
      if constexpr (DV) wgmma_rs_d<D>(dv, pa[c], dob + row, panel);
      if constexpr (DK) wgmma_rs_d<D>(dk, da[c], qb + row, panel);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
}

// CTAs an SM that the ring kernel's registers must allow (its time falls
// with the warpgroups an SM holds): two at D = 64, 112 registers a thread
// with two warpgroups a CTA, where dk and dv then take separate passes;
// with one warpgroup, or at D = 128, where one CTA holds the SM
// (two passes, 168 registers).
__host__ __device__ constexpr int ring_min_ctas(int D, int NWG) { return D == 64 || NWG == 1 ? 2 : 1; }

// dk and dv in two passes over the queries (one D-wide accumulator live at a
// time) where the registers of ring_min_ctas CTAs an SM do not hold both.
__host__ __device__ constexpr bool ring_two_passes(int D, int NWG) { return D == 128 || NWG == 2; }

// NWG consumer warpgroups (one for rows of at most 64 tokens, two up to 128),
// then one producer warp. CTA x takes the (row, head) items x, x + gridDim.x,
// ...; the producer keeps them in flight through `stages` ring slots, each
// holding Q, K, V, dO and out of one item as TMA boxes of 64 * NWG token rows
// (zeros past L) in the 128-byte swizzle, with lse2 and the seg ids loaded by
// its lanes. Per item the consumers first take delta = rowsum(f32(dO) *
// f32(out)), two threads a row, and overwrite out in place with Qs = bf16(q
// * qscale), the B operand of the transposed scores; then warpgroup w
//   1. owns keys 64w..64w+63 (dkdv_pass): over 32-query chunks, sT = K Qs^T
//      and dpT = V dO^T by wgmma from shared memory, p and ds in registers,
//      then dv += pT dO and dk += dsT Q with pT and dsT as register A
//      operands and dO and Q read MN-major; it stores dk and dv;
//   2. owns queries 64w..64w+63: over C-key chunks, s = Qs K^T and
//      dp = dO V^T, ds, then dq += ds K; it releases the slot and stores dq.
// Each gradient row has one owner: no atomics, and the result does not
// depend on scheduling.
template <int D, int NWG, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(NWG * 128 + 32, ring_min_ctas(D, NWG))
    flash_bwd_ring_kernel(const __grid_constant__ CUtensorMap qkv_map,
                          const __grid_constant__ CUtensorMap out_map,
                          const __grid_constant__ CUtensorMap dout_map, const int* __restrict__ seg,
                          const float* __restrict__ lse, __nv_bfloat16* __restrict__ dqkv, int B,
                          int L, int H, float qscale, float scale, Layout layout, int stages) {
  constexpr int BOX = 64 * NWG;           // token rows of a box
  constexpr int P = D / 64;               // 64-value panels of one head
  constexpr int PANEL = BOX * SW128_ROW;  // bytes of one panel
  constexpr int TILE_BYTES = P * PANEL;   // one tile of one item
  constexpr int STAGE = 5 * TILE_BYTES;   // Q, K, V, dO, out (then Qs)
  constexpr int CONSUMERS = NWG * 128;
  constexpr int KSTEPS = D / 16;
  constexpr int C1 = 32;                               // queries a product chunk of phase 1
  constexpr int C = ring_two_passes(D, NWG) ? 32 : 64;  // keys a product chunk of phase 2
  constexpr int WG_ROWS = 64 * SW128_ROW;  // bytes of a warpgroup's 64 rows of a panel

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  float* slse = reinterpret_cast<float*>(ring + (size_t)stages * STAGE);
  float* sdelta = slse + stages * BOX;
  int* sseg = reinterpret_cast<int*>(sdelta + stages * BOX);
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
      const float* lrow = lse + (layout.split ? (long)h * layout.B + b : (long)b * H + h) * L;
      for (int i = lane; i < BOX; i += 32) {
        slse[s * BOX + i] = i < L ? lrow[i] : 0.f;
        if (SEG) sseg[s * BOX + i] = i < L ? seg[(long)b * L + i] : -2;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* dst = ring + (size_t)s * STAGE;
        for (int p = 0; p < P; ++p) {
          const int col = h * D + p * 64;
          for (int part = 0; part < 3; ++part)  // q, k, v
            tma_load_3d(dst + part * TILE_BYTES + p * PANEL, &qkv_map, &full[s], part * HD + col, 0, b);
          tma_load_3d(dst + 3 * TILE_BYTES + p * PANEL, &dout_map, &full[s], col, 0, b);
          tma_load_3d(dst + 4 * TILE_BYTES + p * PANEL, &out_map, &full[s], col, 0, b);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = wg * 64 + (warp % 4) * 16 + g, r_b = r_a + 8;  // this thread's accumulator rows
  const int rows = round16(L);
  const uint32_t ring_base = smem_addr(ring);
  const long tok = 3L * HD;  // elements between tokens of dqkv

  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int s = n % stages;
    const int b = item / H, h = item % H;
    const uint32_t qb = ring_base + s * STAGE, kb = qb + TILE_BYTES, vb = kb + TILE_BYTES,
                   dob = vb + TILE_BYTES, qsb = dob + TILE_BYTES;
    unsigned char* const stage = ring + (size_t)s * STAGE;
    const float* sl = slse + s * BOX;
    float* sd = sdelta + s * BOX;
    const int* ss = sseg + s * BOX;
    mbar_wait(&full[s], (n / stages) & 1);

    // delta of row r from threads 2r and 2r + 1, each half the row's 16-byte
    // chunks in order; each overwrites its chunks of out with Qs.
    {
      const int r = tid / 2, half = tid % 2;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int chunk = half * (D / 16) + i;
        const uint32_t off = (chunk / 8) * PANEL + sw128_offset(r, chunk % 8);
        const uint4 o4 = *reinterpret_cast<const uint4*>(stage + 4 * TILE_BYTES + off);
        const uint4 g4 = *reinterpret_cast<const uint4*>(stage + 3 * TILE_BYTES + off);
        const uint4 q4 = *reinterpret_cast<const uint4*>(stage + off);
        const uint32_t o[4] = {o4.x, o4.y, o4.z, o4.w}, gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(as_bf162(o[e]));
          const float2 fg = __bfloat1622float2(as_bf162(gr[e]));
          acc += fg.x * fo.x;
          acc += fg.y * fo.y;
        }
        *reinterpret_cast<uint4*>(stage + 4 * TILE_BYTES + off) =
            make_uint4(scale_bf16x2(q4.x, qscale), scale_bf16x2(q4.y, qscale),
                       scale_bf16x2(q4.z, qscale), scale_bf16x2(q4.w, qscale));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) sd[r] = acc;
    }
    fence_proxy_async();  // Qs, written by the threads, is read by wgmma
    named_barrier(1, CONSUMERS);

    __nv_bfloat16* base = dqkv + (long)b * L * tok + (long)h * D;

    // 1. dk and dv of keys r_a, r_b, over the queries that can see them: in
    //    one pass, or dv and then dk, each pass taking the scores again
    if constexpr (!ring_two_passes(D, NWG)) {
      float dk[D / 2], dv[D / 2];
      dkdv_pass<D, C1, SEG, CAUSAL, true, true>(dk, dv, kb, vb, dob, qb, qsb, sl, sd, ss, wg, r_a, r_b, L,
                                            rows, scale);
      store_part<D>(dk, base, 1, HD, tok, r_a, r_b, L, lane);
      store_part<D>(dv, base, 2, HD, tok, r_a, r_b, L, lane);
    } else {
      float acc[D / 2];
      dkdv_pass<D, C1, SEG, CAUSAL, false, true>(acc, acc, kb, vb, dob, qb, qsb, sl, sd, ss, wg, r_a, r_b,
                                             L, rows, scale);
      store_part<D>(acc, base, 2, HD, tok, r_a, r_b, L, lane);
      dkdv_pass<D, C1, SEG, CAUSAL, true, false>(acc, acc, kb, vb, dob, qb, qsb, sl, sd, ss, wg, r_a, r_b,
                                             L, rows, scale);
      store_part<D>(acc, base, 1, HD, tok, r_a, r_b, L, lane);
    }

    // 2. dq of queries r_a, r_b, over the keys they can see
    {
      const float lse_q[2] = {sl[r_a], sl[r_b]}, delta_q[2] = {sd[r_a], sd[r_b]};
      int segq[2] = {0, 0};
      if (SEG) {
        segq[0] = ss[r_a];
        segq[1] = ss[r_b];
      }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      const int k_end = CAUSAL ? min(rows, (wg + 1) * 64) : rows;
      for (int kc = 0; kc < k_end; kc += C) {  // keys past L are zeros and masked
        float sc[C / 2], dp[C / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const uint32_t pan = (kk / 4) * PANEL, k2 = 2 * (kk % 4);
          wgmma_ss_c<C>(sc, sw128_desc(qsb + pan + wg * WG_ROWS) + k2,
                        sw128_desc(kb + pan + kc * SW128_ROW) + k2, kk > 0);
          wgmma_ss_c<C>(dp, sw128_desc(dob + pan + wg * WG_ROWS) + k2,
                        sw128_desc(vb + pan + kc * SW128_ROW) + k2, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        uint32_t da[C / 16][4];
#pragma unroll
        for (int jb = 0; jb < C / 8; ++jb) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = kc + jb * 8 + 2 * t + (e & 1);
            const int q = e < 2 ? r_a : r_b;
            bool visible = q < L && k < L;
            if (CAUSAL) visible = visible && k <= q;
            if (SEG) visible = visible && ss[k] == segq[e / 2];
            const float p = visible ? exp2_approx(sc[4 * jb + e] - lse_q[e / 2]) : 0.f;
            ds[e] = p * (dp[4 * jb + e] - delta_q[e / 2]) * scale;
          }
          da[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          da[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < C / 16; ++c) wgmma_rs_d<D>(dq, da[c], kb + (kc + 16 * c) * SW128_ROW, PANEL);
        wgmma_commit();
        wgmma_wait<0>();
      }
      if (tid % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the slot
      store_part<D>(dq, base, 0, HD, tok, r_a, r_b, L, lane);
    }
  }
}

// ---- rows of at most 128 tokens at D = 64: one warp per 16 rows, fed by a TMA ring

constexpr int WARP_RING = 16;  // the entry points' `resident` for the warp ring: WARP_RING + stages
constexpr int WR_BLOCK = 16 * SW128_ROW;  // a warp's 16 rows of one tile: 2 KB

// Shared memory of the warp ring (attention.py::bwd_warp_ring_smem_bytes
// mirrors it), 1 KB to align the swizzled tiles first: per stage Q, K, V, dO
// and out of one (row, head) as `rows` token rows of 128 B; one 16-row
// staging tile a consumer warp; per stage lse2, delta and (SEG) the seg ids
// of the rows; three mbarriers a stage (loaded, full, empty).
__host__ __device__ constexpr size_t warp_ring_smem_bytes(int rows, int stages, bool seg) {
  return SW128_ALIGN + (size_t)stages * 5 * rows * SW128_ROW + (size_t)rows * SW128_ROW +
         (size_t)stages * rows * (seg ? 12 : 8) + 24 * (size_t)stages;
}

// The row kernel's warp_dkdv on the swizzled tiles of a slot (q, k, v and do
// are their addresses): dk and dv of the 16 keys from k0 over the queries
// [q_lo, rows), with lse2, delta and the seg ids from the slot's arrays.
template <bool SEG, bool CAUSAL>
__device__ __forceinline__ void ring_dkdv(uint32_t q, uint32_t k, uint32_t v, uint32_t dob, const float* sl,
                                          const float* sd, const int* ss, int k0, int q_lo, int rows, int L,
                                          float qscale, float scale, float (&dk)[8][4], float (&dv)[8][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int key[2] = {k0 + g, k0 + g + 8};
  int segk[2] = {0, 0};
  if (SEG) {
    segk[0] = ss[key[0]];
    segk[1] = ss[key[1]];
  }
  for (int qr = q_lo; qr < rows; qr += 16) {
    float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ka[4], va[4], qb[4], ob[4];
      const int ca = 2 * kk + lane / 16, cb = 2 * kk + (lane / 8) % 2;
      ldmatrix_x4_at(ka, k + sw128_offset(k0 + a_row(lane), ca));
      ldmatrix_x4_at(va, v + sw128_offset(k0 + a_row(lane), ca));
      ldmatrix_x4_at(qb, q + sw128_offset(qr + b_row(lane), cb));
      ldmatrix_x4_at(ob, dob + sw128_offset(qr + b_row(lane), cb));
#pragma unroll
      for (int e = 0; e < 4; ++e) qb[e] = scale_bf16x2(qb[e], qscale);
      mma_bf16(st[0], ka, qb[0], qb[1]);
      mma_bf16(st[1], ka, qb[2], qb[3]);
      mma_bf16(dpt[0], va, ob[0], ob[1]);
      mma_bf16(dpt[1], va, ob[2], ob[3]);
    }
    // pT and dsT of this 16 x 16 block; columns are queries
    float p[2][4], ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qg = qr + n * 8 + 2 * tq + (e & 1);
        const int r = e / 2;
        bool visible = qg < L && key[r] < L;
        if (CAUSAL) visible = visible && key[r] <= qg;
        if (SEG) visible = visible && ss[qg] == segk[r];
        p[n][e] = visible ? exp2f(st[n][e] - sl[qg]) : 0.f;
        ds[n][e] = p[n][e] * (dpt[n][e] - sd[qg]) * scale;
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < 4; ++d2) {
      uint32_t ob[4], qb[4];
      const int r = qr + a_row(lane), c = 2 * d2 + lane / 16;
      ldmatrix_x4_trans_at(ob, dob + sw128_offset(r, c));
      ldmatrix_x4_trans_at(qb, q + sw128_offset(r, c));
      mma_bf16(dv[2 * d2], pa, ob[0], ob[1]);
      mma_bf16(dv[2 * d2 + 1], pa, ob[2], ob[3]);
      mma_bf16(dk[2 * d2], da, qb[0], qb[1]);
      mma_bf16(dk[2 * d2 + 1], da, qb[2], qb[3]);
    }
  }
}

// The row kernel's warp_dq on the swizzled tiles of a slot: dq of the 16
// queries from q0 over the keys [0, k_hi).
template <bool SEG, bool CAUSAL>
__device__ __forceinline__ void ring_dq(uint32_t q, uint32_t k, uint32_t v, uint32_t dob, const float* sl,
                                        const float* sd, const int* ss, int q0, int k_hi, int L, float qscale,
                                        float scale, float (&dq)[8][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int query[2] = {q0 + g, q0 + g + 8};
  const float lse[2] = {sl[query[0]], sl[query[1]]};
  const float delta[2] = {sd[query[0]], sd[query[1]]};
  int segq[2] = {0, 0};
  if (SEG) {
    segq[0] = ss[query[0]];
    segq[1] = ss[query[1]];
  }
  for (int kr = 0; kr < k_hi; kr += 16) {
    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t qa[4], oa[4], kb[4], vb[4];
      const int ca = 2 * kk + lane / 16, cb = 2 * kk + (lane / 8) % 2;
      ldmatrix_x4_at(qa, q + sw128_offset(q0 + a_row(lane), ca));
      ldmatrix_x4_at(oa, dob + sw128_offset(q0 + a_row(lane), ca));
      ldmatrix_x4_at(kb, k + sw128_offset(kr + b_row(lane), cb));
      ldmatrix_x4_at(vb, v + sw128_offset(kr + b_row(lane), cb));
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = scale_bf16x2(qa[e], qscale);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
      mma_bf16(dp[0], oa, vb[0], vb[1]);
      mma_bf16(dp[1], oa, vb[2], vb[3]);
    }
    float ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kg = kr + n * 8 + 2 * tq + (e & 1);
        const int r = e / 2;
        bool visible = query[r] < L && kg < L;
        if (CAUSAL) visible = visible && kg <= query[r];
        if (SEG) visible = visible && ss[kg] == segq[r];
        const float p = visible ? exp2f(s[n][e] - lse[r]) : 0.f;
        ds[n][e] = p * (dp[n][e] - delta[r]) * scale;
      }
    }
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < 4; ++d2) {
      uint32_t kb[4];
      ldmatrix_x4_trans_at(kb, k + sw128_offset(kr + a_row(lane), 2 * d2 + lane / 16));
      mma_bf16(dq[2 * d2], da, kb[0], kb[1]);
      mma_bf16(dq[2 * d2 + 1], da, kb[2], kb[3]);
    }
  }
}

// A warp's 16 accumulator rows rounded to bf16 into its 16-row staging tile
// in the 128-byte swizzle (rows lane / 4 and lane / 4 + 8).
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[8][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(g, j) + 4 * t) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(g + 8, j) + 4 * t) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// Consumer warps a warp-ring CTA holds at most: five (rows of at most 80
// tokens, two CTAs an SM) or eight (up to 128, one CTA an SM).
__host__ __device__ constexpr int warp_ring_min_ctas(int MAXW) { return MAXW <= 5 ? 2 : 1; }

// The warp ring ("warp_ring"): rows/16 consumer warps, one per 16-token
// block, then one producer warp. CTA x takes the (row, head) items x, x +
// gridDim.x, ...; the producer keeps them in flight through `stages` slots,
// each holding Q, K, V, dO and out of one item as TMA boxes of round16(L)
// token rows (zeros past L) in the 128-byte swizzle, with the item's lse2 and
// seg ids loaded by its lanes. Once a slot's tiles have landed the producer
// takes delta = rowsum(f32(dO) f32(out)) from them, in the pre-pass's order
// of summation, and only then marks the slot full, so no pre-pass launches,
// out and dO are read once, and the consumers spend no time or barrier on
// it. It issues the copies of item n + stages once item n's slot is free,
// and takes item n + 1's delta while the consumers work on item n (with one
// stage, after issuing its copy). Warp w keeps the row kernel's partition
// and arithmetic (ring_dkdv, ring_dq: mma.sync from the slot): dk and dv of
// keys 16w..16w+15 over the queries that see them, then dq of queries
// 16w..16w+15 over the keys they see, so causal work balances over the
// warps and each gradient row has one owner (no atomics; two calls are
// bit-equal, and equal to the row kernel's). dk goes out through the warp's
// staging tile and dv through its 16 rows of the slot's out tile (dead once
// delta is taken), each by TMA store into dqkv in the layout of qkv; once
// those stores have read shared memory the warp releases the slot, then
// stores dq through its staging tile, so the next item's copy overlaps this
// one's last products and stores.
template <int MAXW, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(MAXW * 32 + 32, warp_ring_min_ctas(MAXW))
    flash_bwd_warp_ring_kernel(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap out_map,
                               const __grid_constant__ CUtensorMap dout_map,
                               const __grid_constant__ CUtensorMap dqkv_map, const int* __restrict__ seg,
                               const float* __restrict__ lse, int B, int L, int H, float qscale, float scale,
                               Layout layout, int stages) {
  constexpr int D = 64;
  const int rows = round16(L), nw = rows / 16;
  const int TILE_BYTES = rows * SW128_ROW;  // one tile of one item
  const int STAGE = 5 * TILE_BYTES;         // Q, K, V, dO, out

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* staging = ring + (size_t)stages * STAGE;
  float* slse = reinterpret_cast<float*>(staging + TILE_BYTES);
  float* sdelta = slse + stages * rows;
  int* sseg = reinterpret_cast<int*>(sdelta + stages * rows);
  uint64_t* loaded = reinterpret_cast<uint64_t*>(sseg + (SEG ? stages * rows : 0));
  uint64_t* full = loaded + stages;
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int items = B * H;
  const int HD = H * D;
  const int mine = (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nw);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= nw * 32) {  // the producer warp
    const int lane = tid % 32;
    // the copies of this CTA's n-th item into slot n % stages, once its
    // previous item has released it; its lse2 and seg ids by the lanes
    auto issue = [&](int n) {
      const int s = n % stages, item = (int)blockIdx.x + n * (int)gridDim.x;
      if (n >= stages) mbar_wait(&empty[s], (n / stages - 1) & 1);
      const int b = item / H, h = item % H;
      const float* lrow = lse + (layout.split ? (long)h * layout.B + b : (long)b * H + h) * L;
      for (int i = lane; i < rows; i += 32) {
        slse[s * rows + i] = i < L ? lrow[i] : 0.f;
        if (SEG) sseg[s * rows + i] = i < L ? seg[(long)b * L + i] : -2;
      }
      if (lane == 0) {
        mbar_expect_tx(&loaded[s], STAGE);
        unsigned char* dst = ring + (size_t)s * STAGE;
        for (int part = 0; part < 3; ++part)  // q, k, v
          tma_load_3d(dst + part * TILE_BYTES, &qkv_map, &loaded[s], part * HD + h * D, 0, b);
        tma_load_3d(dst + 3 * TILE_BYTES, &dout_map, &loaded[s], h * D, 0, b);
        tma_load_3d(dst + 4 * TILE_BYTES, &out_map, &loaded[s], h * D, 0, b);
      }
    };
    // delta of the n-th item's rows, one lane a row, each row's 16-byte
    // chunks in order (the pre-pass's order), then the slot is full
    auto finish = [&](int n) {
      const int s = n % stages;
      mbar_wait(&loaded[s], (n / stages) & 1);
      const unsigned char* st = ring + (size_t)s * STAGE;
      for (int r = lane; r < rows; r += 32) {
        float acc = 0.f;
#pragma unroll
        for (int chunk = 0; chunk < 8; ++chunk) {
          const uint32_t off = sw128_offset(r, chunk);
          const uint4 o4 = *reinterpret_cast<const uint4*>(st + 4 * TILE_BYTES + off);
          const uint4 g4 = *reinterpret_cast<const uint4*>(st + 3 * TILE_BYTES + off);
          const uint32_t o[4] = {o4.x, o4.y, o4.z, o4.w}, gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fo = __bfloat1622float2(as_bf162(o[e]));
            const float2 fg = __bfloat1622float2(as_bf162(gr[e]));
            acc += fg.x * fo.x;
            acc += fg.y * fo.y;
          }
        }
        sdelta[s * rows + r] = acc;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    };
    for (int n = 0; n < stages && n < mine; ++n) issue(n);
    if (mine > 0) finish(0);
    for (int n = 0; n + 1 < mine; ++n) {
      if (stages > 1) {
        finish(n + 1);
        if (n + stages < mine) issue(n + stages);
      } else {
        issue(n + 1);
        finish(n + 1);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;  // this warp's 16-token block
  const uint32_t ring_base = smem_addr(ring);
  unsigned char* own = staging + warp * WR_BLOCK;  // this warp's staging tile
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int s = n % stages;
    const int b = item / H, h = item % H;
    const uint32_t qb = ring_base + s * STAGE, kb = qb + TILE_BYTES, vb = kb + TILE_BYTES,
                   dob = vb + TILE_BYTES;
    unsigned char* const out_rows = ring + (size_t)s * STAGE + 4 * TILE_BYTES + warp * WR_BLOCK;
    const float* sl = slse + s * rows;
    const float* sd = sdelta + s * rows;
    const int* ss = sseg + s * rows;
    mbar_wait(&full[s], (n / stages) & 1);

    // 1. dk and dv of keys r0..r0+15 over the queries that can see them
    float acc_a[8][4] = {}, acc_b[8][4] = {};
    ring_dkdv<SEG, CAUSAL>(qb, kb, vb, dob, sl, sd, ss, r0, CAUSAL ? r0 : 0, rows, L, qscale, scale, acc_a,
                           acc_b);
    if (lane == 0) bulk_wait_read<0>();  // the previous item's dq store has read the staging tile
    __syncwarp();
    stage_rows(own, acc_a, lane);       // dk
    stage_rows(out_rows, acc_b, lane);  // dv, into the slot's out rows of this block
    fence_proxy_async();  // the tiles, written by the lanes, are read by TMA
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&dqkv_map, own, HD + h * D, r0, b);
      tma_store_3d(&dqkv_map, out_rows, 2 * HD + h * D, r0, b);
      bulk_commit();
    }

    // 2. dq of queries r0..r0+15 over the keys they can see
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_a[j][0] = acc_a[j][1] = acc_a[j][2] = acc_a[j][3] = 0.f;
    ring_dq<SEG, CAUSAL>(qb, kb, vb, dob, sl, sd, ss, r0, CAUSAL ? r0 + 16 : rows, L, qscale, scale, acc_a);
    if (lane == 0) bulk_wait_read<0>();  // dk and dv have left the staging tile and the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
    stage_rows(own, acc_a, lane);  // dq
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&dqkv_map, own, h * D, r0, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
}

// ---- rows longer than 128 tokens at D = 64: the streamed pair ----------------

// A resident block is the 64 rows of a wgmma; a streamed chunk has 32 tokens,
// which holds the consumers to 128 registers (dk and dv take 64) so that
// three CTAs share an SM, and pads ViT-L/14's 257 tokens to 288 streamed
// rows rather than 320. 64-token chunks (two CTAs an SM) were slower at 197
// and 257 tokens and faster at 577 and 1024 (PERF.md §7: a chunk picked by
// length is still to do).
constexpr int SBLK = 64;                        // tokens of a resident block
constexpr int SC = 32;                          // tokens of a streamed chunk
constexpr int STILE = SBLK * SW128_ROW;         // one resident tile of one head: 8 KB
constexpr int CTILE = SC * SW128_ROW;           // one streamed tile of one head: 4 KB
constexpr int STREAM_THREADS = 128 + 32;        // one consumer warpgroup, one producer warp
constexpr int STREAM_CTAS = 3;                  // CTAs an SM
constexpr int STREAM_SMEM_MAX = 233472 / STREAM_CTAS - 1024;  // each CTA's share of an SM
constexpr int STAGES = 3;  // ring slots: the most the dq kernel fits in a third of an SM
constexpr int STREAMED = 3;  // the entry points' `resident` for the streamed pair

// Shared memory of the two kernels (attention.py::bwd_stream_smem_bytes
// mirrors them), 1 KB to align the swizzled tiles first. The dq kernel: two
// item slots of Q (then Qs), dO and out, STAGES ring slots of K and V; lse2
// and delta of each item slot, and (SEG) the item slots' query seg ids and
// the ring slots' key seg ids; then three mbarriers an item slot (loaded,
// full, empty) and two a ring slot. The dk/dv
// kernel: two item slots of K and V, STAGES ring slots of Q, dO and Qs;
// (SEG) the item slots' key seg ids; lse2, delta and (SEG) the query seg ids
// of each ring slot; the item mbarriers and three a ring slot (loaded, full,
// empty).
constexpr size_t stream_dq_smem_bytes(bool seg) {
  return SW128_ALIGN + 6 * (size_t)STILE + 2 * (size_t)STAGES * CTILE + 2 * 2 * SBLK * 4 +
         (seg ? (size_t)(2 * SBLK + STAGES * SC) * 4 : 0) + 8 * (6 + 2 * (size_t)STAGES);
}
constexpr size_t stream_dkdv_smem_bytes(bool seg) {
  return SW128_ALIGN + 4 * (size_t)STILE + 3 * (size_t)STAGES * CTILE + (size_t)STAGES * SC * 8 +
         (seg ? (size_t)(2 * SBLK + STAGES * SC) * 4 : 0) + 8 * (4 + 3 * (size_t)STAGES);
}
static_assert(stream_dq_smem_bytes(true) <= STREAM_SMEM_MAX && stream_dkdv_smem_bytes(true) <= STREAM_SMEM_MAX,
              "three CTAs of the streamed pair share an SM");

__device__ __forceinline__ long lse_row(Layout layout, int b, int h, int H) {
  return layout.split ? (long)h * layout.B + b : (long)b * H + h;
}

// Step 1 of the streamed pair, which launches first: dq and delta. CTA x
// takes the items x, x + gridDim.x, ... of (row b, head h, 64-query block),
// the block fastest, so the blocks of one (row, head) run side by side and
// find its K and V in L2. The producer warp loads each item's Q, dO and out
// by TMA into one of two item slots (the next item's copy overlaps this
// one's products) with its lse2 and query seg ids, and streams the item's
// 32-key chunks of K and V (zeros past L) through STAGES ring slots. Once
// an item's tiles have landed (after it has issued the item's first chunk)
// the producer takes delta = rowsum(f32(dO) f32(out)), one lane a row, writes
// it to the slot and to delta [B, H, L] for step 2, overwrites Q in place
// with Qs = bf16(q * qscale), and only then marks the item slot full, so the
// consumers spend no time or barrier on that pass. Per chunk the consumer
// warpgroup takes s = Qs K^T and dp = dO V^T by wgmma from shared memory, ds
// in registers, dq += ds K with ds as the register A operand; it stores dq.
// Under a causal mask the item visits the chunks up to its diagonal. Every
// wgmma has a fixed shape and runs unconditionally; tokens past L are zeros
// and masked.
template <bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_CTAS)
    flash_bwd_stream_dq_kernel(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap qkv_chunk_map,
                               const __grid_constant__ CUtensorMap out_map,
                               const __grid_constant__ CUtensorMap dout_map,
                               const int* __restrict__ seg, const float* __restrict__ lse,
                               float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv, int B,
                               int L, int H, float qscale, float scale, Layout layout) {
  constexpr int D = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* tiles = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* ring = tiles + 6 * STILE;  // ring slot s: K, V
  float* slse = reinterpret_cast<float*>(ring + STAGES * 2 * CTILE);  // [2][SBLK]
  float* sdelta = slse + 2 * SBLK;                                    // [2][SBLK]
  int* ssegq = reinterpret_cast<int*>(sdelta + 2 * SBLK);             // [2][SBLK]
  int* ssegk = ssegq + (SEG ? 2 * SBLK : 0);                          // [STAGES][SC]
  uint64_t* item_loaded = reinterpret_cast<uint64_t*>(ssegk + (SEG ? STAGES * SC : 0));
  uint64_t* item_full = item_loaded + 2;
  uint64_t* item_empty = item_full + 2;
  uint64_t* full = item_empty + 2;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int nb = (L + SBLK - 1) / SBLK, nc = (L + SC - 1) / SC;
  const int items = B * H * nb;  // the host checks that it fits an int
  const int HD = H * D;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&item_loaded[i], 1);
      mbar_init(&item_full[i], 1);
      mbar_init(&item_empty[i], 1);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    const int lane = tid % 32;
    int c = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int blk = item % nb, h = (item / nb) % H, b = item / (nb * H);
      const int slot = n % 2, q0 = blk * SBLK;
      unsigned char* const it = tiles + (size_t)slot * 3 * STILE;
      if (n >= 2) mbar_wait(&item_empty[slot], (n / 2 - 1) & 1);
      const float* lrow = lse + lse_row(layout, b, h, H) * L;
      for (int i = lane; i < SBLK; i += 32) {
        const int q = q0 + i;
        slse[slot * SBLK + i] = q < L ? lrow[q] : 0.f;
        if (SEG) ssegq[slot * SBLK + i] = q < L ? seg[(long)b * L + q] : -1;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&item_loaded[slot], 3 * STILE);
        tma_load_3d(it, &qkv_map, &item_loaded[slot], h * D, q0, b);
        tma_load_3d(it + STILE, &dout_map, &item_loaded[slot], h * D, q0, b);
        tma_load_3d(it + 2 * STILE, &out_map, &item_loaded[slot], h * D, q0, b);
      }
      const int chunks = CAUSAL ? min((blk + 1) * (SBLK / SC), nc) : nc;
      for (int kc = 0; kc < chunks; ++kc, ++c) {
        const int s = c % STAGES, k0 = kc * SC;
        if (c >= STAGES) mbar_wait(&empty[s], (c / STAGES - 1) & 1);
        if (SEG) {
          for (int i = lane; i < SC; i += 32)
            ssegk[s * SC + i] = k0 + i < L ? seg[(long)b * L + k0 + i] : -2;
          __syncwarp();
        }
        if (lane == 0) {
          unsigned char* dst = ring + (size_t)s * 2 * CTILE;
          mbar_expect_tx(&full[s], 2 * CTILE);
          tma_load_3d(dst, &qkv_chunk_map, &full[s], HD + h * D, k0, b);
          tma_load_3d(dst + CTILE, &qkv_chunk_map, &full[s], 2 * HD + h * D, k0, b);
        }
        if (kc > 0) continue;
        // the item's delta and Qs, rows `lane` and `lane + 32`, each row's
        // 16-byte chunks in order; the waits above need only items already
        // published
        mbar_wait(&item_loaded[slot], (n / 2) & 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          float acc = 0.f;
#pragma unroll
          for (int chunk = 0; chunk < 8; ++chunk) {
            const uint32_t off = sw128_offset(r, chunk);
            const uint4 q4 = *reinterpret_cast<const uint4*>(it + off);
            const uint4 g4 = *reinterpret_cast<const uint4*>(it + STILE + off);
            const uint4 o4 = *reinterpret_cast<const uint4*>(it + 2 * STILE + off);
            const uint32_t o[4] = {o4.x, o4.y, o4.z, o4.w}, gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 fo = __bfloat1622float2(as_bf162(o[e]));
              const float2 fg = __bfloat1622float2(as_bf162(gr[e]));
              acc += fg.x * fo.x;
              acc += fg.y * fo.y;
            }
            *reinterpret_cast<uint4*>(it + off) =
                make_uint4(scale_bf16x2(q4.x, qscale), scale_bf16x2(q4.y, qscale),
                           scale_bf16x2(q4.z, qscale), scale_bf16x2(q4.w, qscale));
          }
          sdelta[slot * SBLK + r] = acc;
          if (q0 + r < L) delta[((long)b * H + h) * L + q0 + r] = acc;
        }
        fence_proxy_async();  // Qs, written by the lanes, is read by wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&item_full[slot]);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g, r_b = r_a + 8;  // this thread's accumulator rows in the block
  const uint32_t tiles_base = smem_addr(tiles), ring_base = smem_addr(ring);
  const long tok = 3L * HD;  // elements between tokens of dqkv
  int c = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int blk = item % nb, h = (item / nb) % H, b = item / (nb * H);
    const int slot = n % 2, q0 = blk * SBLK;
    const uint32_t qsb = tiles_base + slot * 3 * STILE, dob = qsb + STILE;
    const float* sl = slse + slot * SBLK;
    const float* sd = sdelta + slot * SBLK;
    mbar_wait(&item_full[slot], (n / 2) & 1);
    const float lse_q[2] = {sl[r_a], sl[r_b]}, delta_q[2] = {sd[r_a], sd[r_b]};
    const int query[2] = {q0 + r_a, q0 + r_b};
    int segq[2] = {0, 0};
    if (SEG) {
      segq[0] = ssegq[slot * SBLK + r_a];
      segq[1] = ssegq[slot * SBLK + r_b];
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const int chunks = CAUSAL ? min((blk + 1) * (SBLK / SC), nc) : nc;
    for (int kc = 0; kc < chunks; ++kc, ++c) {
      const int s = c % STAGES;
      const uint32_t kb = ring_base + s * 2 * CTILE, vb = kb + CTILE;
      const int* sk = ssegk + s * SC;
      mbar_wait(&full[s], (c / STAGES) & 1);
      float sc[SC / 2], dp[SC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_c<SC>(sc, sw128_desc(qsb) + 2 * kk, sw128_desc(kb) + 2 * kk, kk > 0);
        wgmma_ss_c<SC>(dp, sw128_desc(dob) + 2 * kk, sw128_desc(vb) + 2 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      uint32_t da[SC / 16][4];
#pragma unroll
      for (int jb = 0; jb < SC / 8; ++jb) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = jb * 8 + 2 * t + (e & 1), k = kc * SC + kl;
          const int q = query[e / 2];
          bool visible = q < L && k < L;
          if (CAUSAL) visible = visible && k <= q;
          if (SEG) visible = visible && sk[kl] == segq[e / 2];
          const float p = visible ? exp2_approx(sc[4 * jb + e] - lse_q[e / 2]) : 0.f;
          ds[e] = p * (dp[4 * jb + e] - delta_q[e / 2]) * scale;
        }
        da[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        da[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < SC / 16; ++cc) wgmma_rs_d<D>(dq, da[cc], kb + 16 * cc * SW128_ROW, CTILE);
      wgmma_commit();
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);  // done with the ring slot
    }
    if (tid == 0) mbar_arrive(&item_empty[slot]);  // done with the item slot
    store_part<D>(dq, dqkv + (long)b * L * tok + (long)h * D, 0, HD, tok, query[0], query[1], L, lane);
  }
}

// Step 2 of the streamed pair: dk and dv. CTA x takes the items x, x +
// gridDim.x, ... of (row b, head h, 64-key block), the block fastest. The
// producer warp loads each item's K and V by TMA into one of two item slots
// with its key seg ids, and streams the item's 32-query chunks of Q and dO
// (zeros past L) through STAGES ring slots, with their lse2, their delta
// (written by step 1) and their seg ids. A slot is loaded, then full: one
// chunk behind the copies it issues, the producer writes the landed chunk's Qs = bf16(q * qscale) into the slot's
// third tile and only then marks the slot full, so the consumers never
// spend time or a barrier on that pass. Per chunk the consumer warpgroup
// takes sT = K Qs^T and dpT = V dO^T by wgmma from shared memory, pT and
// dsT in registers, then dv += pT dO and dk += dsT Q with pT and dsT as
// register A operands and dO and Q read MN-major; it stores dk and dv.
// Under a causal mask the item's chunks start at its diagonal.
template <bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_CTAS)
    flash_bwd_stream_dkdv_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                 const __grid_constant__ CUtensorMap qkv_chunk_map,
                                 const __grid_constant__ CUtensorMap dout_chunk_map,
                                 const int* __restrict__ seg, const float* __restrict__ lse,
                                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                                 int B, int L, int H, float qscale, float scale, Layout layout) {
  constexpr int D = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* tiles = smem_raw + (((raw + SW128_ALIGN - 1) & ~(uint32_t)(SW128_ALIGN - 1)) - raw);
  unsigned char* ring = tiles + 4 * STILE;  // ring slot s: Q, dO, Qs
  float* slse = reinterpret_cast<float*>(ring + STAGES * 3 * CTILE);  // [STAGES][SC]
  float* sdelta = slse + STAGES * SC;                                  // [STAGES][SC]
  int* ssegk = reinterpret_cast<int*>(sdelta + STAGES * SC);           // [2][SBLK]
  int* ssegq = ssegk + (SEG ? 2 * SBLK : 0);                           // [STAGES][SC]
  uint64_t* item_full = reinterpret_cast<uint64_t*>(ssegq + (SEG ? STAGES * SC : 0));
  uint64_t* item_empty = item_full + 2;
  uint64_t* loaded = item_empty + 2;
  uint64_t* full = loaded + STAGES;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int nb = (L + SBLK - 1) / SBLK, nc = (L + SC - 1) / SC;
  const int items = B * H * nb;
  const int HD = H * D;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&item_full[i], 1);
      mbar_init(&item_empty[i], 1);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    const int lane = tid % 32;
    // Qs of chunk p once its copies have landed, 16 bytes a lane at the same
    // swizzled offsets; then its slot is full
    auto publish = [&](int p) {
      const int s = p % STAGES;
      unsigned char* stage = ring + (size_t)s * 3 * CTILE;
      mbar_wait(&loaded[s], (p / STAGES) & 1);
#pragma unroll 4
      for (int i = lane; i < CTILE / 16; i += 32) {
        const uint4 q4 = *reinterpret_cast<const uint4*>(stage + 16 * i);
        *reinterpret_cast<uint4*>(stage + 2 * CTILE + 16 * i) =
            make_uint4(scale_bf16x2(q4.x, qscale), scale_bf16x2(q4.y, qscale),
                       scale_bf16x2(q4.z, qscale), scale_bf16x2(q4.w, qscale));
      }
      fence_proxy_async();  // Qs, written by the lanes, is read by wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    };
    int c = 0, published = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int blk = item % nb, h = (item / nb) % H, b = item / (nb * H);
      const int slot = n % 2, k0 = blk * SBLK;
      if (n >= 2) mbar_wait(&item_empty[slot], (n / 2 - 1) & 1);
      if (SEG) {
        for (int i = lane; i < SBLK; i += 32)
          ssegk[slot * SBLK + i] = k0 + i < L ? seg[(long)b * L + k0 + i] : -2;
        __syncwarp();
      }
      if (lane == 0) {
        unsigned char* dst = tiles + (size_t)slot * 2 * STILE;
        mbar_expect_tx(&item_full[slot], 2 * STILE);
        tma_load_3d(dst, &qkv_map, &item_full[slot], HD + h * D, k0, b);
        tma_load_3d(dst + STILE, &qkv_map, &item_full[slot], 2 * HD + h * D, k0, b);
      }
      const float* lrow = lse + lse_row(layout, b, h, H) * L;
      const float* drow = delta + ((long)b * H + h) * L;
      for (int qc = CAUSAL ? blk * (SBLK / SC) : 0; qc < nc; ++qc, ++c) {
        const int s = c % STAGES, q0 = qc * SC;
        if (c >= STAGES) mbar_wait(&empty[s], (c / STAGES - 1) & 1);
        for (int i = lane; i < SC; i += 32) {
          const int q = q0 + i;
          slse[s * SC + i] = q < L ? lrow[q] : 0.f;
          sdelta[s * SC + i] = q < L ? drow[q] : 0.f;
          if (SEG) ssegq[s * SC + i] = q < L ? seg[(long)b * L + q] : -1;
        }
        __syncwarp();
        if (lane == 0) {
          unsigned char* dst = ring + (size_t)s * 3 * CTILE;
          mbar_expect_tx(&loaded[s], 2 * CTILE);
          tma_load_3d(dst, &qkv_chunk_map, &loaded[s], h * D, q0, b);
          tma_load_3d(dst + CTILE, &dout_chunk_map, &loaded[s], h * D, q0, b);
        }
        // publish the chunk before this one: every wait above needs only
        // chunks published already, the oldest slot waited for being STAGES
        // chunks back
        while (published < c) publish(published++);
      }
    }
    while (published < c) publish(published++);
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g, r_b = r_a + 8;  // this thread's accumulator rows in the block
  const uint32_t tiles_base = smem_addr(tiles), ring_base = smem_addr(ring);
  const long tok = 3L * HD;
  int c = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int blk = item % nb, h = (item / nb) % H, b = item / (nb * H);
    const int slot = n % 2, k0 = blk * SBLK;
    const uint32_t kb = tiles_base + slot * 2 * STILE, vb = kb + STILE;
    const int key[2] = {k0 + r_a, k0 + r_b};
    mbar_wait(&item_full[slot], (n / 2) & 1);
    int segk[2] = {0, 0};
    if (SEG) {
      segk[0] = ssegk[slot * SBLK + r_a];
      segk[1] = ssegk[slot * SBLK + r_b];
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int qc = CAUSAL ? blk * (SBLK / SC) : 0; qc < nc; ++qc, ++c) {
      const int s = c % STAGES;
      const uint32_t qb = ring_base + s * 3 * CTILE, dob = qb + CTILE, qsb = dob + CTILE;
      const float* sl = slse + s * SC;
      const float* sd = sdelta + s * SC;
      const int* sq = ssegq + s * SC;
      mbar_wait(&full[s], (c / STAGES) & 1);
      float st[SC / 2], dpt[SC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_c<SC>(st, sw128_desc(kb) + 2 * kk, sw128_desc(qsb) + 2 * kk, kk > 0);
        wgmma_ss_c<SC>(dpt, sw128_desc(vb) + 2 * kk, sw128_desc(dob) + 2 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // pT and dsT: rows are keys, columns queries
      uint32_t pa[SC / 16][4], da[SC / 16][4];
#pragma unroll
      for (int jb = 0; jb < SC / 8; ++jb) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = jb * 8 + 2 * t + (e & 1), q = qc * SC + ql;
          const int k = key[e / 2];
          bool visible = q < L && k < L;
          if (CAUSAL) visible = visible && k <= q;
          if (SEG) visible = visible && sq[ql] == segk[e / 2];
          p[e] = visible ? exp2_approx(st[4 * jb + e] - sl[ql]) : 0.f;
          ds[e] = p[e] * (dpt[4 * jb + e] - sd[ql]) * scale;
        }
        pa[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[jb / 2][(jb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        da[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < SC / 16; ++cc) {
        const uint32_t row = 16 * cc * SW128_ROW;
        wgmma_rs_d<D>(dv, pa[cc], dob + row, CTILE);
        wgmma_rs_d<D>(dk, da[cc], qb + row, CTILE);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);  // done with the ring slot
    }
    if (tid == 0) mbar_arrive(&item_empty[slot]);  // done with K and V
    __nv_bfloat16* base = dqkv + (long)b * L * tok + (long)h * D;
    store_part<D>(dk, base, 1, HD, tok, key[0], key[1], L, lane);
    store_part<D>(dv, base, 2, HD, tok, key[0], key[1], L, lane);
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, bool (&allowed)[MAX_DEVICES], long blocks, int threads,
                  size_t smem, size_t smem_max, const void* qkv, const void* seg,
                  const void* dout, const void* lse, const void* delta, void* dqkv, int L, int H,
                  float qscale, float scale, Layout layout, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, (int)smem_max, allowed);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqkv), L, H, qscale, scale,
      layout);
  return (int)cudaGetLastError();
}

// The ring kernel on `grid` persistent CTAs with `stages` ring slots.
template <int D, int NWG, bool SEG, bool CAUSAL>
int launch_ring(const void* qkv, const void* seg, const void* out, const void* dout,
                const void* lse, void* dqkv, int B, int L, int H, float qscale, float scale,
                Layout layout, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_bwd_ring_kernel<D, NWG, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, SMEM_MAX, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_smem_bytes<D>(64 * NWG, stages, SEG);
  if ((long)B * H > INT_MAX || grid < 1 || stages < 1 || stages > RING_MAX_STAGES ||
      smem > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // qkv as [B][L][3 * H * D], out and dout as [B][L][H * D]: box rows past L read as zeros
  CUtensorMap qkv_map, out_map, dout_map;
  const uint64_t qkv_dims[3] = {(uint64_t)3 * H * D, (uint64_t)L, (uint64_t)B};
  const uint64_t o_dims[3] = {(uint64_t)H * D, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&qkv_map, qkv, 3, qkv_dims, 64 * NWG) ||
      !tensor_map_bf16(&out_map, out, 3, o_dims, 64 * NWG) ||
      !tensor_map_bf16(&dout_map, dout, 3, o_dims, 64 * NWG))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      qkv_map, out_map, dout_map, static_cast<const int*>(seg), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dqkv), B, L, H, qscale, scale, layout, stages);
  return (int)cudaGetLastError();
}

// The warp ring at D = 64 on `grid` persistent CTAs with `stages` slots.
template <int MAXW, bool SEG, bool CAUSAL>
int launch_warp_ring(const void* qkv, const void* seg, const void* out, const void* dout,
                     const void* lse, void* dqkv, int B, int L, int H, float qscale, float scale,
                     Layout layout, int grid, int stages, cudaStream_t stream) {
  auto kernel = flash_bwd_warp_ring_kernel<MAXW, SEG, CAUSAL>;
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, SMEM_MAX, allowed, true);
  if (err != cudaSuccess) return (int)err;
  const int rows = round16(L);
  const size_t smem = warp_ring_smem_bytes(rows, stages, SEG);
  if ((long)B * H > INT_MAX || rows / 16 > MAXW || grid < 1 || stages < 1 || stages > RING_MAX_STAGES ||
      smem > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // qkv as [B][L][3 * H * 64], out and dout as [B][L][H * 64] in boxes of the
  // row's padded rows (rows past L read as zeros); dqkv in boxes of a warp's
  // 16 rows (rows from L on are not stored)
  CUtensorMap qkv_map, out_map, dout_map, dqkv_map;
  const uint64_t qkv_dims[3] = {(uint64_t)3 * H * 64, (uint64_t)L, (uint64_t)B};
  const uint64_t o_dims[3] = {(uint64_t)H * 64, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&qkv_map, qkv, 3, qkv_dims, rows) || !tensor_map_bf16(&out_map, out, 3, o_dims, rows) ||
      !tensor_map_bf16(&dout_map, dout, 3, o_dims, rows) || !tensor_map_bf16(&dqkv_map, dqkv, 3, qkv_dims, 16))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, rows * 2 + 32, smem, stream>>>(qkv_map, out_map, dout_map, dqkv_map,
                                                 static_cast<const int*>(seg), static_cast<const float*>(lse), B,
                                                 L, H, qscale, scale, layout, stages);
  return (int)cudaGetLastError();
}

// The streamed pair at D = 64 on `grid` persistent CTAs (three an SM): the
// dq kernel, which writes delta, then the dk/dv kernel, which reads it.
template <bool SEG, bool CAUSAL>
int launch_streamed(const void* qkv, const void* seg, const void* out, const void* dout,
                    const void* lse, void* delta, void* dqkv, int B, int L, int H, float qscale,
                    float scale, Layout layout, int grid, cudaStream_t stream) {
  constexpr int D = 64;
  auto dq_kernel = flash_bwd_stream_dq_kernel<SEG, CAUSAL>;
  auto kv_kernel = flash_bwd_stream_dkdv_kernel<SEG, CAUSAL>;
  static bool allowed_dq[MAX_DEVICES] = {}, allowed_kv[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(dq_kernel, STREAM_SMEM_MAX, allowed_dq, true);
  if (err == cudaSuccess) err = allow_smem(kv_kernel, STREAM_SMEM_MAX, allowed_kv, true);
  if (err != cudaSuccess) return (int)err;
  if ((long)B * H * ((L + SBLK - 1) / SBLK) > INT_MAX || grid < 1) return (int)cudaErrorInvalidValue;
  // qkv as [B][L][3 * H * D], out and dout as [B][L][H * D], in boxes of a
  // resident block's rows and of a chunk's: rows past L read as zeros
  CUtensorMap qkv_map, qkv_chunk_map, out_map, dout_map, dout_chunk_map;
  const uint64_t qkv_dims[3] = {(uint64_t)3 * H * D, (uint64_t)L, (uint64_t)B};
  const uint64_t o_dims[3] = {(uint64_t)H * D, (uint64_t)L, (uint64_t)B};
  if (!tensor_map_bf16(&qkv_map, qkv, 3, qkv_dims, SBLK) ||
      !tensor_map_bf16(&qkv_chunk_map, qkv, 3, qkv_dims, SC) ||
      !tensor_map_bf16(&out_map, out, 3, o_dims, SBLK) ||
      !tensor_map_bf16(&dout_map, dout, 3, o_dims, SBLK) ||
      !tensor_map_bf16(&dout_chunk_map, dout, 3, o_dims, SC))
    return (int)cudaErrorInvalidValue;
  dq_kernel<<<grid, STREAM_THREADS, stream_dq_smem_bytes(SEG), stream>>>(
      qkv_map, qkv_chunk_map, out_map, dout_map, static_cast<const int*>(seg),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dqkv), B,
      L, H, qscale, scale, layout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<grid, STREAM_THREADS, stream_dkdv_smem_bytes(SEG), stream>>>(
      qkv_map, qkv_chunk_map, dout_chunk_map, static_cast<const int*>(seg), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqkv), B, L, H, qscale, scale,
      layout);
  return (int)cudaGetLastError();
}

template <int D, bool SEG, bool CAUSAL>
int launch(const void* qkv, const void* seg, const void* out, const void* dout, const void* lse,
           void* delta, void* dqkv, int B, int L, int H, float qscale, float scale, bool split,
           int warps, int resident, cudaStream_t s) {
  const Layout layout{B, split};
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  // the streamed pair: grid `warps` (head_dim 64 only)
  if (!TILED_ONLY && L > SHORT_ROW && resident == STREAMED) {
    if constexpr (D == 64)
      return launch_streamed<SEG, CAUSAL>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale,
                                          scale, layout, warps, s);
    return (int)cudaErrorInvalidValue;
  }
  if (!TILED_ONLY && L <= SHORT_ROW && warps > 0 && resident > WARP_RING) {
    // the warp ring: grid `warps`, stages `resident - WARP_RING` (head_dim 64 only)
    if constexpr (D == 64 && !TILED_ONLY) {
      if (L <= 80)
        return launch_warp_ring<5, SEG, CAUSAL>(qkv, seg, out, dout, lse, dqkv, B, L, H, qscale, scale, layout,
                                                warps, resident - WARP_RING, s);
      return launch_warp_ring<8, SEG, CAUSAL>(qkv, seg, out, dout, lse, dqkv, B, L, H, qscale, scale, layout,
                                              warps, resident - WARP_RING, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (!TILED_ONLY && L <= SHORT_ROW && warps > 0) {  // the ring: grid `warps`, stages `resident`
    if (L <= 64)
      return launch_ring<D, 1, SEG, CAUSAL>(qkv, seg, out, dout, lse, dqkv, B, L, H, qscale, scale,
                                            layout, warps, resident, s);
    return launch_ring<D, 2, SEG, CAUSAL>(qkv, seg, out, dout, lse, dqkv, B, L, H, qscale, scale,
                                          layout, warps, resident, s);
  }
  const long n = (long)B * L * H;
  const long delta_blocks = (n + DELTA_THREADS - 1) / DELTA_THREADS;
  if (delta_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int rows = round16(L);
  const size_t row_smem = Tiles<D>::bytes(rows, rows, SEG);
  const bool long_resident = !TILED_ONLY && L > SHORT_ROW && resident;
  if (long_resident && (resident != 1 || warps < 1 || warps > ROW_WARPS || warps > rows / 16 ||
                        row_smem > (size_t)SMEM_MAX))
    return (int)cudaErrorInvalidValue;  // refused before anything is launched
  flash_bwd_delta_kernel<<<(unsigned)delta_blocks, DELTA_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), n, L, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (!TILED_ONLY && (L <= SHORT_ROW || long_resident)) {
    static bool allowed[MAX_DEVICES] = {};
    const int threads = 32 * (L <= SHORT_ROW ? rows / 16 : warps);
    return launch_kernel(flash_bwd_row_kernel<D, SEG, CAUSAL>, allowed, (long)B * H,
                         threads, row_smem, SMEM_MAX, qkv, seg, dout, lse, delta, dqkv, L, H,
                         qscale, scale, layout, s);
  }
  const long blocks = (long)B * H * ((L + TILE - 1) / TILE);
  const size_t bytes = Tiles<D>::bytes(TILE, TILE, SEG);
  static bool allowed_kv[MAX_DEVICES] = {}, allowed_q[MAX_DEVICES] = {};
  int e = launch_kernel(flash_bwd_dkdv_kernel<D, SEG, CAUSAL>, allowed_kv, blocks, 4 * 32, bytes,
                        bytes, qkv, seg, dout, lse, delta, dqkv, L, H, qscale, scale, layout, s);
  if (e) return e;
  return launch_kernel(flash_bwd_dq_kernel<D, SEG, CAUSAL>, allowed_q, blocks, 4 * 32, bytes,
                       bytes, qkv, seg, dout, lse, delta, dqkv, L, H, qscale, scale, layout, s);
}

// warps and resident: the launch plan. For rows longer than SHORT_ROW tokens
// (attention.py::bwd_long_row_plan): resident = 1 runs the row kernel with
// `warps` warps in padded rows, 0 the tiled pair, and 3 (STREAMED) the
// streamed pair (D = 64) on a grid of `warps` persistent CTAs; any other
// value is refused. For shorter rows (attention.py::bwd_short_row_plan):
// `warps` is the ring's grid of persistent CTAs and `resident` its stages,
// or WARP_RING + stages for the warp ring (head_dim 64); a grid of 0 runs
// the delta pre-pass and the one-CTA-per-(row, head) row kernel.
template <bool SEG>
int dispatch(const void* qkv, const void* seg, const void* out, const void* dout, const void* lse,
             void* delta, void* dqkv, int B, int L, int H, int D, int causal, float qscale,
             float scale, bool split, int warps, int resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? launch<64, SEG, true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, warps, resident, s)
                  : launch<64, SEG, false>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, warps, resident, s);
  if (D == 128)
    return causal ? launch<128, SEG, true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, warps, resident, s)
                  : launch<128, SEG, false>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, warps, resident, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int latteclip_flash_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dqkv, int B, int L, int H,
                                   int D, int causal, float qscale, float scale, int warps,
                                   int resident, void* stream) {
  return dispatch<false>(qkv, nullptr, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale,
                         scale, false, warps, resident, stream);
}

extern "C" int latteclip_flash_bwd_seg(const void* qkv, const void* seg, const void* out,
                                       const void* dout, const void* lse, void* delta, void* dqkv,
                                       int B, int L, int H, int D, int causal, float qscale,
                                       float scale, int warps, int resident, void* stream) {
  return dispatch<true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale, scale,
                        false, warps, resident, stream);
}

// lse2 [H/HP, HP, B, L] ([H, B, L] in memory); dqkv in the layout of qkv
extern "C" int latteclip_flash_bwd_hs(const void* qkv, const void* out, const void* dout,
                                      const void* lse, void* delta, void* dqkv, int B, int L,
                                      int H, int D, int causal, float qscale, float scale,
                                      int warps, int resident, void* stream) {
  return dispatch<false>(qkv, nullptr, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale,
                         scale, true, warps, resident, stream);
}
