// Backward flash attention for the CLIP towers on Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of latteclip_tpu/kernels/attention.py:
//   latteclip_flash_bwd      <- _bwd_kernel      (whole-row, optional causal)
//   latteclip_flash_bwd_seg  <- _bwd_kernel_seg  (segment-masked rows, optional causal)
//   latteclip_flash_bwd_hs   <- _bwd_kernel_hs   (head-split, whole-row)
// All take the forward's residuals, qkv [B, L, 3*H*D] (laid out [q | k | v],
// bf16), out [B, L, H*D] bf16 and the base-2 logsumexp lse2 f32, with the
// cotangent dout [B, L, H*D] bf16. The first two read lse2 as [B, H, L] and
// write the gradient dqkv [B, L, 3*H*D] bf16 in the layout of qkv, so the
// in-projection's backward reads it as it is. The head-split kernel computes
// the same gradient from the head-split forward's lse2 [H/HP, HP, B, L]
// ([H, B, L] in memory) and writes it as dqkv3 [3, B, L, H*D] (dq, dk, dv),
// as the TPU kernel does; the caller re-merges it into the layout of qkv.
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
//   * rows of at most 128 tokens (every row of the ViT-B/32 train step: vision
//     pairs at 100, text at 77, packed text at 128) take one CTA per
//     (row, head) with one warp per 16 tokens. The CTA copies the whole row's
//     Q, K, V and dO into shared memory once. Each warp then owns 16 keys and
//     accumulates their dk and dv over every query, from the transposed
//     scores K . Qs^T and V . dO^T, and then owns 16 queries and accumulates
//     their dq over every key. Each gradient row has one owner, so there are
//     no atomics and the result does not depend on scheduling;
//   * longer rows (ViT-B/16 at 197, 336 px at 577) split the same two phases
//     over two kernels: one CTA of 4 warps per (row, head, 64-key tile)
//     streams 64-query tiles for dk and dv, and one per (row, head, 64-query
//     tile) streams 64-key tiles for dq;
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
// the delta scratch [B, H, L] f32), and returns cudaGetLastError().

#include <climits>

#include "common.cuh"

namespace {

using namespace latteclip;

constexpr int ROW_MAX = 128;  // the most tokens the one-CTA-per-(row, head) kernel holds
// Rows of at most SHORT_ROW tokens take that kernel, longer ones the tiled
// pair. Building with -DLATTECLIP_BWD_SHORT_ROW=0 sends every row to the
// tiled pair, which chip_smoke.py times beside the row kernel.
#ifndef LATTECLIP_BWD_SHORT_ROW
#define LATTECLIP_BWD_SHORT_ROW ROW_MAX
#endif
constexpr int SHORT_ROW = LATTECLIP_BWD_SHORT_ROW;
static_assert(SHORT_ROW >= 0 && SHORT_ROW <= ROW_MAX, "SHORT_ROW must lie in [0, ROW_MAX]");
constexpr int TILE = 64;  // query or key rows per tile on longer rows
constexpr int DELTA_THREADS = 256;

// Shared-memory tiles of one CTA: Q and dO (q_rows), K and V (k_rows), each
// row padded by 16 bytes so that ldmatrix reads are free of bank conflicts,
// then lse2, delta and segment ids of the query rows, segment ids of the keys.
template <int D>
struct Tiles {
  static constexpr int STRIDE = D + 8;  // padded shared row, in bf16 elements
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

  static constexpr size_t bytes(int q_rows, int k_rows) {
    return (size_t)(2 * q_rows + 2 * k_rows) * STRIDE * 2 + (size_t)q_rows * 12 +
           (size_t)k_rows * 4;
  }
};

// Where one (row b, head h) of the residuals lives.
struct Row {
  const __nv_bfloat16* qkv;   // token 0 of row b, head h's q columns
  const __nv_bfloat16* dout;  // token 0 of row b, head h's columns
  const float* lse;           // lse2[b, h, :]
  const float* delta;         // delta[b, h, :]
  const int* seg;             // seg[b, :] or nullptr
  __nv_bfloat16* dqkv;        // dq of token 0 of row b, head h
  long dqkv_tok;              // elements between two tokens' gradients
  long dqkv_part;             // elements from dq to dk and from dk to dv
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
    cp_async_16(&dst[r * Tiles<D>::STRIDE + col], src + (long)(valid ? r0 + r : 0) * stride + col,
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
__device__ void warp_dkdv(const Tiles<D>& t, int kr, int k0, int qr_lo, int qr_hi, int query_base,
                          int L, float qscale, float scale, float (&dk)[D / 8][4],
                          float (&dv)[D / 8][4]) {
  constexpr int S = Tiles<D>::STRIDE;
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
      const int ar = (kr + a_row(lane)) * S + kk * 16 + a_col(lane);
      const int br = (qr + b_row(lane)) * S + kk * 16 + b_col(lane);
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
      const int r = (qr + a_row(lane)) * S + d2 * 16 + a_col(lane);
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
  constexpr int S = Tiles<D>::STRIDE;
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
      const int ar = (qr + a_row(lane)) * S + kk * 16 + a_col(lane);
      const int br = (kr + b_row(lane)) * S + kk * 16 + b_col(lane);
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
      ldmatrix_x4_trans(kb, &t.k[(kr + a_row(lane)) * S + d2 * 16 + a_col(lane)]);
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
  const long stride = row.dqkv_tok;
  __nv_bfloat16* base = row.dqkv + part * row.dqkv_part;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * (lane % 4);
    if (ra < row.L)
      *reinterpret_cast<uint32_t*>(&base[ra * stride + col]) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < row.L)
      *reinterpret_cast<uint32_t*>(&base[rb * stride + col]) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// Where lse2 comes from and the gradient goes: lse2 [B, H, L] and dqkv in
// the layout of qkv, or with `split` (the head-split kernel) lse2 [H, B, L]
// and dqkv3 [3, B, L, H*D].
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
  row.dqkv_tok = layout.split ? HD : 3L * HD;
  row.dqkv_part = layout.split ? (long)layout.B * L * HD : HD;
  row.dqkv = dqkv + tok0 * row.dqkv_tok + (long)h * D;
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

// Rows of at most ROW_MAX tokens: one CTA per (row, head), one warp per 16
// tokens; the whole row stays in shared memory for both phases.
template <int D, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(ROW_MAX * 2)
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

  const int r0 = (threadIdx.x / 32) * 16;  // this warp's 16 keys, then its 16 queries
  float acc_a[D / 8][4], acc_b[D / 8][4];
  zero<D>(acc_a);
  zero<D>(acc_b);
  warp_dkdv<D, SEG, CAUSAL>(t, r0, r0, CAUSAL ? r0 : 0, rows, 0, L, qscale, scale, acc_a, acc_b);
  store_rows<D>(row, 1, r0, acc_a);  // dk
  store_rows<D>(row, 2, r0, acc_b);  // dv
  zero<D>(acc_a);
  warp_dq<D, SEG, CAUSAL>(t, r0, r0, 0, CAUSAL ? r0 + 16 : rows, 0, L, qscale, scale, acc_a);
  store_rows<D>(row, 0, r0, acc_a);  // dq
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
           cudaStream_t s) {
  const Layout layout{B, split};
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long n = (long)B * L * H;
  const long delta_blocks = (n + DELTA_THREADS - 1) / DELTA_THREADS;
  if (delta_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<<<(unsigned)delta_blocks, DELTA_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), n, L, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (L <= SHORT_ROW) {
    static bool allowed[MAX_DEVICES] = {};
    const int rows = round16(L);
    return launch_kernel(flash_bwd_row_kernel<D, SEG, CAUSAL>, allowed, (long)B * H, 2 * rows,
                         Tiles<D>::bytes(rows, rows), Tiles<D>::bytes(ROW_MAX, ROW_MAX), qkv,
                         seg, dout, lse, delta, dqkv, L, H, qscale, scale, layout, s);
  }
  const long blocks = (long)B * H * ((L + TILE - 1) / TILE);
  const size_t bytes = Tiles<D>::bytes(TILE, TILE);
  static bool allowed_kv[MAX_DEVICES] = {}, allowed_q[MAX_DEVICES] = {};
  int e = launch_kernel(flash_bwd_dkdv_kernel<D, SEG, CAUSAL>, allowed_kv, blocks, 4 * 32, bytes,
                        bytes, qkv, seg, dout, lse, delta, dqkv, L, H, qscale, scale, layout, s);
  if (e) return e;
  return launch_kernel(flash_bwd_dq_kernel<D, SEG, CAUSAL>, allowed_q, blocks, 4 * 32, bytes,
                       bytes, qkv, seg, dout, lse, delta, dqkv, L, H, qscale, scale, layout, s);
}

template <bool SEG>
int dispatch(const void* qkv, const void* seg, const void* out, const void* dout, const void* lse,
             void* delta, void* dqkv, int B, int L, int H, int D, int causal, float qscale,
             float scale, bool split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? launch<64, SEG, true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, s)
                  : launch<64, SEG, false>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, s);
  if (D == 128)
    return causal ? launch<128, SEG, true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, s)
                  : launch<128, SEG, false>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, qscale, scale, split, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int latteclip_flash_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dqkv, int B, int L, int H,
                                   int D, int causal, float qscale, float scale, void* stream) {
  return dispatch<false>(qkv, nullptr, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale,
                         scale, false, stream);
}

extern "C" int latteclip_flash_bwd_seg(const void* qkv, const void* seg, const void* out,
                                       const void* dout, const void* lse, void* delta, void* dqkv,
                                       int B, int L, int H, int D, int causal, float qscale,
                                       float scale, void* stream) {
  return dispatch<true>(qkv, seg, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale, scale,
                        false, stream);
}

// lse2 [H/HP, HP, B, L] ([H, B, L] in memory), dqkv3 [3, B, L, H*D]
extern "C" int latteclip_flash_bwd_hs(const void* qkv, const void* out, const void* dout,
                                      const void* lse, void* delta, void* dqkv, int B, int L,
                                      int H, int D, int causal, float qscale, float scale,
                                      void* stream) {
  return dispatch<false>(qkv, nullptr, out, dout, lse, delta, dqkv, B, L, H, D, causal, qscale,
                         scale, true, stream);
}
