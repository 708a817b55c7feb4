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
// device memory and keep scores, p and ds on chip:
//   * lab forward and backward: one CTA per (b, h); q, k, v (and do) of the
//     whole row are copied once into shared memory with 16-byte cp.async
//     copies, rows padded by 16 bytes so the ldmatrix reads are free of bank
//     conflicts; each warp owns 16-row query blocks (the backward also 16-key
//     blocks for dk and dv, so no gradient row has two writers and no
//     atomics are needed); scores live in mma.sync m16n8k16 accumulators
//     (bf16 in, f32 accumulate), 16 keys at a time, and p and ds repack in
//     registers into the A operand of the next product. Recomputing the
//     scores in the second walk costs tensor-core time, which is cheap here;
//   * keys beyond L are zero-filled to a multiple of 16 and masked to
//     p = 0, so they stay out of m, l and delta; query rows beyond L are not
//     stored;
//   * Q K^T and P V: one CTA per batch row (L <= 128), one warp per 16 rows,
//     the HD (or per-head V) columns streamed in 64-column chunks through two
//     shared buffers so the next chunk's copy overlaps this chunk's products.
//     k^T [B, HD, L] and p [B, L, L] have rows of L bf16 values, which are
//     not 16-byte aligned at odd L: they are copied 2 bytes a thread.
// wgmma, TMA and warp specialisation are left for later work.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.

#include <climits>

#include "common.cuh"

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

// Lane offsets within a 16 x 16 block of a row-major shared tile for an
// ldmatrix x4: the A pattern (rows M, columns K; with .trans also a B
// operand stored [K][N]) and the B pattern (rows N, columns K, no .trans).
__device__ __forceinline__ int a_row(int lane) { return (lane % 8) + 8 * ((lane / 8) % 2); }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int b_row(int lane) { return (lane % 8) + 8 * (lane / 16); }
__device__ __forceinline__ int b_col(int lane) { return 8 * ((lane / 8) % 2); }

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

int fwd_dispatch(const void* q, const void* k, const void* v, void* o, void* lse, Layout lay,
                 int B, int L, int H, int D, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return fwd<64>(q, k, v, o, lse, lay, B, L, H, scale, stream);
  if (D == 128) return fwd<128>(q, k, v, o, lse, lay, B, L, H, scale, stream);
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
int qk(const void* q, const void* k, void* out, int B, int L, int HD, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  if (L <= 0 || L > PROD_MAX_L || HD <= 0 || HD % CHUNK) return (int)cudaErrorInvalidValue;
  const int rows = round16(L);
  const size_t smem = (size_t)2 * rows * (CHUNK + 8) * 2 +
                      (PRET ? (size_t)2 * CHUNK * (rows + 8) * 2 : (size_t)2 * rows * (CHUNK + 8) * 2);
  return launch(lab_qk_kernel<PRET>, allowed, (long)B, 2 * rows, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out),
                L, HD);
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

// q, k, v, o [B, L, H*D]; lse [B, H, L]
extern "C" int latteclip_lab_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int L, int H, int D, float scale,
                                        void* stream) {
  const Layout lay{(long)L * H * D, D, (long)H * D, (long)H * L, L};
  return fwd_dispatch(q, k, v, o, lse, lay, B, L, H, D, scale, stream);
}

// q, k, v, o [B, H, L, D]; lse [H, B, L]
extern "C" int latteclip_lab_fwd_bhld(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int L, int H, int D, float scale,
                                      void* stream) {
  const Layout lay{(long)H * L * D, (long)L * D, D, L, (long)B * L};
  return fwd_dispatch(q, k, v, o, lse, lay, B, L, H, D, scale, stream);
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

// q, k [B, L, HD] -> s [B, L, L] f32 (L <= 128, HD a multiple of 64)
extern "C" int latteclip_lab_qk_natural(const void* q, const void* k, void* s, int B, int L,
                                        int HD, void* stream) {
  return qk<false>(q, k, s, B, L, HD, stream);
}

// q [B, L, HD], kT [B, HD, L] -> s [B, L, L] f32 (L <= 128, HD a multiple of 64)
extern "C" int latteclip_lab_qk_pret(const void* q, const void* kt, void* s, int B, int L, int HD,
                                     void* stream) {
  return qk<true>(q, kt, s, B, L, HD, stream);
}

// p [B, L, L], v [B, L, H*D] -> o [B, L, D] f32 (L <= 128, D 64 or 128)
extern "C" int latteclip_lab_pv(const void* p, const void* v, void* o, int B, int L, int H, int D,
                                void* stream) {
  if (B <= 0 || L <= 0 || L > PROD_MAX_L || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return pv<64>(p, v, o, B, L, H, stream);
  if (D == 128) return pv<128>(p, v, o, B, L, H, stream);
  return (int)cudaErrorInvalidValue;
}
