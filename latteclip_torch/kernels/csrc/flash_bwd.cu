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
// f32 summation order differs (and the ring kernel's exp2, ex2.approx at
// ~2^-22 relative, well below the bf16 rounding of p and ds).
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
//     dv take separate passes that each compute the scores. Rows of 65..80
//     tokens (text at 77), and cases whose (row, head) items are no more
//     than the SMs (or than four an SM where the two passes run), keep the
//     delta pre-pass and the row kernel below, which were faster there
//     (PERF.md);
//   * otherwise a pre-pass writes delta [B, H, L] f32 (read once from out
//     and dout);
//   * the row kernel takes one CTA per (row, head) and copies the whole
//     row's Q, K, V and dO into shared memory once (rows padded by 16 bytes
//     for conflict-free ldmatrix). Warp w owns the 16-token blocks w, w +
//     warps, ...: for each it accumulates the block's dk and dv over every
//     query, from the transposed scores K . Qs^T and V . dO^T, and then, for
//     each again, the block's dq over every key. Each gradient row has one
//     owner, so there are no atomics and the result does not depend on
//     scheduling. Causal work per key block falls with its index and per
//     query block rises, so every warp's sum is the same. Rows of at most
//     128 tokens take one warp a block (at most 8). Longer rows take it
//     under the launch plan
//     (attention.py::bwd_long_row_plan) where the row fits a CTA's shared
//     memory. The kernel's time falls with the warps an SM holds (its
//     blocks are chains of ldmatrix, mma and exp2 that one warp cannot
//     overlap): at ViT-B/16's 197 tokens (208 rows) padded rows take 4 x 208
//     x 72 x 2 = 119,808 B plus lse2 and delta, one CTA of 13 warps an SM;
//     unpadded rows with the 16-byte chunks of each row permuted by row % 8
//     (conflict-free ldmatrix all the same) take 106,496 B, so two CTAs of 8
//     warps (128 registers a thread) share an SM and one's copy-in overlaps
//     the other's products, which beat one padded CTA of 13 warps
//     (tools/long_row_plans.py times the forms). D = 64 takes that pair form
//     up to 208 tokens; D = 128 takes padded rows up to
//     208 tokens, one CTA of at most 8 warps an SM, so that dk and dv (128
//     f32 accumulators) stay in registers (229,632 B at 197 with segment
//     ids). No row kernel CTA has more than 8 warps;
//   * longer rows (336 px at 577) split the same two phases over
//     two kernels: one CTA of 4 warps per (row, head, 64-key tile) streams
//     64-query tiles for dk and dv, and one per (row, head, 64-query tile)
//     streams 64-key tiles for dq (Q, K, V and dO re-read from L2 by every
//     tile CTA, the scores computed in both);
//   * in the row and tile kernels, scores, p and ds live in mma
//     accumulators, 16 x 16 at a time, and are repacked in registers as the
//     A operand of the next product, so neither p nor ds touches shared
//     memory; every q, k, v and do fragment is reloaded with ldmatrix for
//     each block rather than held, which keeps D = 128 within registers
//     beside its 128 accumulators;
//   * the ragged edge is zero-filled to a multiple of 16 and masked, so
//     tokens beyond L contribute exactly 0; causal warps skip the 16 x 16
//     blocks above the diagonal;
//   * padding tokens (segment 0) see each other, as in the TPU kernel; their
//     cotangent is zero on the train path and their rows stay finite, since
//     every row keeps its diagonal.
// The phases recompute the scores once each (compute is cheap here); wgmma,
// TMA and software pipelining of the long rows are left for later work.
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
constexpr int PAIR_SMEM_MAX = 233472 / 2 - 1024;  // the most two CTAs of one SM can each take

constexpr int ROW_WARPS = 8;  // the most warps of a row kernel CTA: at D = 128 dk and dv
                              // take 128 f32 registers alone

// Shared-memory tiles of one CTA: Q and dO (q_rows), K and V (k_rows), then
// lse2 and delta of the query rows and, when segmented, the segment ids of
// the query rows and of the keys. ldmatrix reads 8 rows of 16 bytes at one
// column: rows padded by 16 bytes keep those in 8 bank groups; with SWZ the
// rows are unpadded and the 16-byte chunks of row r are permuted by r % 8
// (chunk c at c ^ (r % 8)), which does the same in less memory.
template <int D, bool SWZ = false>
struct Tiles {
  static constexpr int STRIDE = SWZ ? D : D + 8;  // shared row, in bf16 elements

  // element offset of (row, col), col a multiple of 8
  static __device__ __forceinline__ int off(int row, int col) {
    return SWZ ? row * STRIDE + ((((col >> 3) ^ (row & 7))) << 3) : row * STRIDE + col;
  }

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
template <int D, bool SWZ>
__device__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long stride, int r0,
                          int n, int L) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < n * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const bool valid = r0 + r < L;
    cp_async_16(&dst[Tiles<D, SWZ>::off(r, col)], src + (long)(valid ? r0 + r : 0) * stride + col,
                valid);
  }
}

// Q, dO and the per-query scalars of query rows [r0, r0 + n).
template <int D, bool SEG, bool SWZ>
__device__ void load_queries(const Tiles<D, SWZ>& t, const Row& row, int r0, int n) {
  copy_rows<D, SWZ>(t.q, row.qkv, 3L * row.HD, r0, n, row.L);
  copy_rows<D, SWZ>(t.dout, row.dout, row.HD, r0, n, row.L);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = r0 + i;
    const bool valid = j < row.L;
    t.lse[i] = valid ? row.lse[j] : 0.f;
    t.delta[i] = valid ? row.delta[j] : 0.f;
    if (SEG) t.segq[i] = valid ? row.seg[j] : -1;
  }
}

// K, V and the segment ids of key rows [r0, r0 + n).
template <int D, bool SEG, bool SWZ>
__device__ void load_keys(const Tiles<D, SWZ>& t, const Row& row, int r0, int n) {
  copy_rows<D, SWZ>(t.k, row.qkv + row.HD, 3L * row.HD, r0, n, row.L);
  copy_rows<D, SWZ>(t.v, row.qkv + 2L * row.HD, 3L * row.HD, r0, n, row.L);
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
template <int D, bool SEG, bool CAUSAL, bool SWZ>
__device__ void warp_dkdv(const Tiles<D, SWZ>& t, int kr, int k0, int qr_lo, int qr_hi,
                          int query_base, int L, float qscale, float scale, float (&dk)[D / 8][4],
                          float (&dv)[D / 8][4]) {
  using T = Tiles<D, SWZ>;
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
template <int D, bool SEG, bool CAUSAL, bool SWZ>
__device__ void warp_dq(const Tiles<D, SWZ>& t, int qr, int q0, int kr_lo, int kr_hi, int key_base,
                        int L, float qscale, float scale, float (&dq)[D / 8][4]) {
  using T = Tiles<D, SWZ>;
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
// warp w owns the 16-token blocks w, w + warps, ... in each. With SWZ the
// rows are unpadded (Tiles) so that two CTAs share an SM. At D = 64 two CTAs
// of 8 warps must fit an SM's registers (128 a thread): without that bound
// ptxas gives the short-row kernel 145-158 and one CTA an SM, which made K4
// at [256, 100, 12 x 64] 1.4x slower.
template <int D, bool SEG, bool CAUSAL, bool SWZ>
__global__ void __launch_bounds__(ROW_WARPS * 32, D == 64 ? 2 : 1)
    flash_bwd_row_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ seg,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                         int L, int H, float qscale, float scale, Layout layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = round16(L);
  const Tiles<D, SWZ> t(smem, rows, rows);
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

template <int D, bool SEG, bool CAUSAL>
int launch(const void* qkv, const void* seg, const void* out, const void* dout, const void* lse,
           void* delta, void* dqkv, int B, int L, int H, float qscale, float scale, bool split,
           int warps, int resident, cudaStream_t s) {
  const Layout layout{B, split};
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
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
  // resident 1: padded rows, one CTA an SM; 2: unpadded swizzled rows at D =
  // 64, two CTAs of at most 8 warps an SM
  const bool pair = resident == 2;
  const size_t row_smem = pair ? Tiles<D, true>::bytes(rows, rows, SEG) : Tiles<D>::bytes(rows, rows, SEG);
  const bool long_resident = !TILED_ONLY && L > SHORT_ROW && resident;
  if (long_resident &&
      (resident > 2 || warps < 1 || warps > ROW_WARPS || warps > rows / 16 ||
       row_smem > (size_t)(pair ? PAIR_SMEM_MAX : SMEM_MAX) || (pair && D != 64)))
    return (int)cudaErrorInvalidValue;  // refused before anything is launched
  flash_bwd_delta_kernel<<<(unsigned)delta_blocks, DELTA_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), n, L, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (!TILED_ONLY && (L <= SHORT_ROW || long_resident)) {
    static bool allowed[MAX_DEVICES] = {}, allowed_pair[MAX_DEVICES] = {};
    const int threads = 32 * (L <= SHORT_ROW ? rows / 16 : warps);
    if constexpr (D == 64) {
      if (long_resident && pair) {
        cudaError_t e = allow_smem(flash_bwd_row_kernel<D, SEG, CAUSAL, true>, PAIR_SMEM_MAX,
                                   allowed_pair, true);
        if (e != cudaSuccess) return (int)e;
        return launch_kernel(flash_bwd_row_kernel<D, SEG, CAUSAL, true>, allowed_pair,
                             (long)B * H, threads, row_smem, PAIR_SMEM_MAX, qkv, seg, dout, lse,
                             delta, dqkv, L, H, qscale, scale, layout, s);
      }
    }
    return launch_kernel(flash_bwd_row_kernel<D, SEG, CAUSAL, false>, allowed, (long)B * H,
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
// `warps` warps in padded rows, 2 in unpadded swizzled rows (D = 64, two CTAs
// an SM), 0 the tiled pair. For shorter rows (attention.py::bwd_short_row_plan):
// `warps` is the ring's grid of persistent CTAs and `resident` its stages;
// a grid of 0 runs the delta pre-pass and the one-CTA-per-(row, head) row
// kernel.
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
