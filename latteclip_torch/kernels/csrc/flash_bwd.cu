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
// f32 summation order differs.
//
// Bound. Like the forward, the backward is memory-bound at the train shapes:
// packed captions at R=300, P=128, H=8, D=64 (about four 32-token captions
// a row) do 10*D*H*(visible pairs), about 3 GFLOP, against 2*R*P*8*H*D
// bytes (qkv, out, dout read, dqkv written), about 315 MB: 10 FLOP/byte
// against the H100's ~295. So the design reads each input once where it
// can and keeps p and ds on chip:
//   * a pre-pass writes delta [B, H, L] f32 (read once from out and dout);
//   * the row kernel takes one CTA per (row, head) and copies the whole
//     row's Q, K, V and dO into shared memory once (rows padded by 16 bytes
//     for conflict-free ldmatrix). Warp w owns the 16-token blocks w, w +
//     warps, ...: for each it accumulates the block's dk and dv over every
//     query, from the transposed scores K . Qs^T and V . dO^T, and then, for
//     each again, the block's dq over every key. Each gradient row has one
//     owner, so there are no atomics and the result does not depend on
//     scheduling. Causal work per key block falls with its index and per
//     query block rises, so every warp's sum is the same. Rows of at most
//     128 tokens (every row of the ViT-B/32 train step) take one warp a block
//     (at most 8). Longer rows take it under the launch plan
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
//   * scores, p and ds live in mma accumulators, 16 x 16 at a time, and are
//     repacked in registers as the A operand of the next product, so neither
//     p nor ds touches shared memory; every q, k, v and do fragment is
//     reloaded with ldmatrix for each block rather than held, which keeps
//     D = 128 within registers beside its 128 accumulators;
//   * the ragged edge is zero-filled to a multiple of 16 and masked, so
//     tokens beyond L contribute exactly 0; causal warps skip the 16 x 16
//     blocks above the diagonal;
//   * padding tokens (segment 0) see each other, as in the TPU kernel; their
//     cotangent is zero on the train path and their rows stay finite, since
//     every row keeps its diagonal.
// The phases recompute the scores once each (compute is cheap here); wgmma,
// TMA and software pipelining are left for later work.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes
// the delta scratch [B, H, L] f32), and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a launch plan it cannot run.

#include <climits>

#include "common.cuh"

namespace {

using namespace latteclip;

// Rows of at most SHORT_ROW tokens take the row kernel with no plan, longer
// ones follow their plan. Building with -DLATTECLIP_BWD_SHORT_ROW=0 sends
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

template <int D, bool SEG, bool CAUSAL>
int launch(const void* qkv, const void* seg, const void* out, const void* dout, const void* lse,
           void* delta, void* dqkv, int B, int L, int H, float qscale, float scale, bool split,
           int warps, int resident, cudaStream_t s) {
  const Layout layout{B, split};
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
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

// warps and resident: the launch plan of rows longer than SHORT_ROW tokens
// (attention.py::bwd_long_row_plan): resident = 1 runs the row kernel with
// `warps` warps in padded rows, 2 in unpadded swizzled rows (D = 64, two CTAs
// an SM), 0 the tiled pair. Ignored for shorter rows.
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
