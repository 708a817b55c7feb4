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
// up to ~2e-3). Only the f32 summation order differs.
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
// p is rounded.
//
// Bound. At the serving shapes both kernels are memory-bound: text at
// B=1000, L=77, H=8, D=64 does 12.1 GFLOP (4*B*H*L^2*D) against about
// 318 MB read and written, 38 FLOP/byte, far below the ~295 FLOP/byte at
// which an H100's bf16 tensor cores (989 TFLOP/s) rather than its memory
// (3.35 TB/s) become the limit. So the design goal is to read qkv once with
// 16-byte coalesced loads, to keep scores and probabilities on chip, and to
// have the loads of a CTA in flight together:
//   * rows of at most 128 tokens (ViT-B/32 vision at 50, its image pairs at
//     100, text at 77, packed text at 128) take one CTA per (row, head) with
//     one warp per 16 query rows, and hold the whole row's K and V in shared
//     memory: q, k and v are each read once, and the scores of a warp's 16
//     rows against every key stay in registers, so the row maximum is exact
//     in one pass;
//   * longer rows (ViT-B/16 at 197, 336 px at 577) take one CTA of 4 warps
//     per (row, head, 64-query tile) and stream K and V in 64-key tiles, in
//     two passes: the first for the row maximum, the second for p, l and
//     P V; it starts from the last tile, whose scores are still in
//     registers, and the other tiles' K comes back from L2;
//   * Q, K and V move with 16-byte cp.async copies, issued together at the
//     start; the ragged edge (L is never a multiple of 16 here) is
//     zero-filled to a multiple of 16 keys and masked, so keys beyond L
//     contribute exactly 0; blocks of 16 keys past the edge are skipped;
//   * products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate); shared-memory rows are padded by 16 bytes so that the
//     ldmatrix reads are free of bank conflicts; the output goes back
//     through shared memory so that it too is stored 16 bytes a thread;
//   * causal CTAs stop at the last key their rows can see; every causal or
//     segment row keeps its own diagonal, so its maximum is finite.
// wgmma, TMA and warp specialisation are left for later work.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <climits>

#include "common.cuh"

namespace {

using namespace latteclip;

constexpr int SHORT_ROW = 128;  // rows up to this many tokens stay whole in shared memory
constexpr int LONG_BLOCK_M = 64;  // query rows per CTA on longer rows
constexpr int LONG_BLOCK_N = 64;  // keys per shared-memory tile on longer rows
constexpr int MAX_THREADS = 2 * SHORT_ROW;  // one warp per 16 query rows
constexpr float MASKED = -1e9f;

// Query rows per CTA, and key rows per shared-memory tile, for a row of L tokens.
__host__ __device__ constexpr int block_rows(int block_n, int L) {
  return block_n >= L ? round16(L) : LONG_BLOCK_M;
}
__host__ __device__ constexpr int tile_rows(int block_n, int L) {
  return block_n < round16(L) ? block_n : round16(L);
}

// Shared memory: seg ids of one key tile, then Q (later the output), K, V.
template <int D, int BLOCK_N>
constexpr size_t smem_bytes(int L) {
  return BLOCK_N * sizeof(int) +
         (size_t)(block_rows(BLOCK_N, L) + 2 * tile_rows(BLOCK_N, L)) * (D + 8) * 2;
}

// BLOCK_N is the key tile: SHORT_ROW for rows of 65..128 tokens (one tile),
// LONG_BLOCK_N for shorter rows (one tile) and for longer ones (several).
// Registers are held to 128 a thread (two CTAs of MAX_THREADS, or four
// 4-warp CTAs, in flight on an SM), except for the 64-key tiles at D=128,
// which take about 210 without spilling.
// BD selects the block-diagonal kernel's rounding (one key tile only).
// lse2[b, h, l] is stored at lse[b * lse_b + h * lse_h + l].
template <int D, int BLOCK_N, bool SEG, bool CAUSAL, bool BD>
__global__ void __launch_bounds__(MAX_THREADS, D == 64 || BLOCK_N == SHORT_ROW ? 2 : 1)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L, int H,
                     float qscale, long lse_b, long lse_h) {
  constexpr int STRIDE = D + 8;   // padded shared row, in bf16 elements
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row of one head
  constexpr int KSTEPS = D / 16;  // mma k-steps over the head dimension
  constexpr int NT = BLOCK_N / 8; // 8-key score tiles per key tile
  constexpr int DT = D / 8;       // 8-wide output tiles

  const int block_m = blockDim.x / 2;  // 16 query rows per warp
  const int rows = tile_rows(BLOCK_N, L);
  extern __shared__ __align__(16) unsigned char smem[];
  int* sSeg = reinterpret_cast<int*>(smem);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + BLOCK_N * sizeof(int));
  __nv_bfloat16* sK = sQ + block_m * STRIDE;
  __nv_bfloat16* sV = sK + rows * STRIDE;

  const int n_qt = (L + block_m - 1) / block_m;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % H;
  const int b = blockIdx.x / (n_qt * H);
  const int HD = H * D;
  const long tok_stride = 3L * HD;  // elements between consecutive tokens
  const __nv_bfloat16* qbase = qkv + (long)b * L * tok_stride + (long)h * D;
  const int q0 = qt * block_m;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within the warp's 16 rows
  const int t = lane % 4;  // fragment column pair
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  const int kv_end = CAUSAL ? min(L, q0 + block_m) : L;
  const int n_kt = (kv_end + BLOCK_N - 1) / BLOCK_N;
  const int last = BLOCK_N == SHORT_ROW ? 0 : n_kt - 1;
  // key rows of tile kt held in shared memory (a multiple of 16)
  auto kv_rows = [&](int kt) { return min(rows, round16(kv_end - kt * BLOCK_N)); };

  // Copy n token rows from r0 on (one head's columns at offset ofs) into
  // dst, 16 bytes a thread at a time; rows beyond L are zero-filled.
  auto copy_rows = [&](__nv_bfloat16* dst, int r0, int n, long ofs) {
    for (int c = tid; c < n * CHUNKS; c += blockDim.x) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      const bool valid = r0 + r < L;
      cp_async_16(&dst[r * STRIDE + col], qbase + (long)(valid ? r0 + r : 0) * tok_stride + ofs + col,
                  valid);
    }
  };
  auto load_k = [&](int kt) {
    copy_rows(sK, kt * BLOCK_N, kv_rows(kt), HD);
    if (SEG)
      for (int i = tid; i < BLOCK_N; i += blockDim.x) {
        const int j = kt * BLOCK_N + i;
        sSeg[i] = j < L ? seg[(long)b * L + j] : -2;
      }
  };
  auto load_v = [&](int kt) {
    copy_rows(sV, kt * BLOCK_N, kv_rows(kt), 2L * HD);
    cp_async_commit();
  };

  int seg_a = 0, seg_b = 0;
  if (SEG) {
    seg_a = row_a < L ? seg[(long)b * L + row_a] : -1;
    seg_b = row_b < L ? seg[(long)b * L + row_b] : -1;
  }

  // Q and the first K tile in one copy group; V of a one-tile row in another.
  copy_rows(sQ, q0, block_m, 0);
  load_k(0);
  cp_async_commit();
  if (last == 0) {
    load_v(0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // Q fragments of this warp's 16 rows, scaled by qscale in f32 and rounded
  // to bf16, as the TPU kernel scales q.
  uint32_t qf[KSTEPS][4];
  {
    const int r = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
    const int cofs = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldmatrix_x4(qf[kk], &sQ[r * STRIDE + kk * 16 + cofs]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(as_bf162(qf[kk][e]));
        qf[kk][e] = as_u32(__floats2bfloat162_rn(f.x * qscale, f.y * qscale));
      }
    }
  }

  // s = Qs K^T for this warp's 16 rows and the keys of tile kt, masked.
  float s[NT][4];
  auto scores = [&](int kt) {
    const int k0 = kt * BLOCK_N;
    const int n_rows = kv_rows(kt);
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      if (n2 * 16 >= n_rows) break;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t kf[4];
        const int key = n2 * 16 + (lane % 8) + 8 * (lane / 16);
        const int d = kk * 16 + 8 * ((lane / 8) % 2);
        ldmatrix_x4(kf, &sK[key * STRIDE + d]);
        mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }
    if (!CAUSAL && !SEG && k0 + BLOCK_N <= kv_end) return;  // every key visible
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * t + (e & 1);
        const int j = k0 + jl;
        bool visible = j < kv_end;
        if (CAUSAL) visible = visible && j <= (e < 2 ? row_a : row_b);
        if (SEG) visible = visible && sSeg[jl] == (e < 2 ? seg_a : seg_b);
        if (!visible) s[n][e] = MASKED;
      }
    }
  };

  // Pass 1: the row maxima over every key tile, as the TPU kernel takes them
  // over its whole row, so that p is rounded against the same maximum.
  // The last tile's scores stay in registers and its V is fetched meanwhile.
  const float neg_inf = __int_as_float(0xff800000);
  float m_row[2] = {neg_inf, neg_inf};
  for (int kt = 0; kt <= last; ++kt) {
    if (kt > 0) {
      __syncthreads();  // every warp is done with the previous K tile
      load_k(kt);
      cp_async_commit();
      if (kt == last) {
        load_v(kt);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    scores(kt);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      m_row[0] = fmaxf(m_row[0], fmaxf(s[n][0], s[n][1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(s[n][2], s[n][3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // Pass 2: p = bf16(exp2(s - m)), l = sum of those bf16 values, acc += P V,
  // walking the tiles from the last (already in registers) to the first.
  // With BD (one tile): p = exp2(s - m) in f32, l = its sum, pb = bf16(p / l).
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  for (int kt = last; kt >= 0; --kt) {
    if (kt != last) {
      __syncthreads();  // every warp is done with the previous K and V tiles
      load_k(kt);
      cp_async_commit();
      load_v(kt);
      cp_async_wait<1>();  // K has landed; V may still be in flight
      __syncthreads();
      scores(kt);
    }
    uint32_t pf[NT / 2][4];  // p packed straight into mma A fragments
    if constexpr (BD) {
      // 8-key tiles past the row's last block of 16 keys hold masked scores
      // only: p is 0 there, with no exp2 and no division
      const int n_rows = kv_rows(kt);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = n * 8 < n_rows ? exp2f(s[n][e] - m_row[e / 2]) : 0.f;
          l_run[e / 2] += s[n][e];
        }
      float rcp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
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
        if (n * 8 >= n_rows) {
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
    const int n_rows = kv_rows(kt);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk * 16 >= n_rows) break;  // p is exactly 0 there
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
        const int d = d2 * 16 + 8 * (lane / 16);
        ldmatrix_x4_trans(vf, &sV[key * STRIDE + d]);
        mma_bf16(acc[2 * d2], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  if constexpr (!BD) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
  }
  // out = acc / l (with BD, acc as it is) in bf16, through this warp's own
  // 16 rows of sQ, then stored 16 bytes a thread.
  __nv_bfloat16* sO = sQ + warp * 16 * STRIDE;
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
  __nv_bfloat16* obase = out + (long)b * L * HD + (long)h * D;
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const int row = q0 + warp * 16 + r;
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

// lse_head_major stores lse2 as [H, B, L] (the head-split kernel's
// [H/HP, HP, B, L]), otherwise as [B, H, L].
template <int D, int BLOCK_N, bool SEG, bool CAUSAL, bool BD>
int launch(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
           float qscale, bool lse_head_major, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, BLOCK_N, SEG, CAUSAL, BD>;
  // the most dynamic shared memory this instantiation can take
  static bool allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(
      kernel, (int)smem_bytes<D, BLOCK_N>(BLOCK_N == SHORT_ROW ? SHORT_ROW : LONG_BLOCK_M),
      allowed);
  if (err != cudaSuccess) return (int)err;
  const int block_m = block_rows(BLOCK_N, L);
  const long blocks = (long)B * H * ((L + block_m - 1) / block_m);
  if (B <= 0 || L <= 0 || H <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const long lse_b = lse_head_major ? L : (long)H * L;
  const long lse_h = lse_head_major ? (long)B * L : L;
  kernel<<<(unsigned)blocks, 2 * block_m, smem_bytes<D, BLOCK_N>(L), stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, H, qscale, lse_b, lse_h);
  return (int)cudaGetLastError();
}

template <int D, bool SEG, bool BD>
int launch_rows(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H,
                int causal, float qscale, bool hm, cudaStream_t s) {
  if (L > LONG_BLOCK_N && L <= SHORT_ROW)
    return causal ? launch<D, SHORT_ROW, SEG, true, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s)
                  : launch<D, SHORT_ROW, SEG, false, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s);
  if (BD && L > SHORT_ROW) return (int)cudaErrorInvalidValue;  // BD takes one key tile
  return causal ? launch<D, LONG_BLOCK_N, SEG, true, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s)
                : launch<D, LONG_BLOCK_N, SEG, false, BD>(qkv, seg, out, lse, B, L, H, qscale, hm, s);
}

template <bool SEG, bool BD>
int dispatch(const void* qkv, const void* seg, void* out, void* lse, int B, int L, int H, int D,
             int causal, float qscale, bool lse_head_major, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_rows<64, SEG, BD>(qkv, seg, out, lse, B, L, H, causal, qscale, lse_head_major, s);
  if (D == 128)
    return launch_rows<128, SEG, BD>(qkv, seg, out, lse, B, L, H, causal, qscale, lse_head_major, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int latteclip_flash_fwd(const void* qkv, void* out, void* lse, int B, int L, int H,
                                   int D, int causal, float qscale, void* stream) {
  return dispatch<false, false>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, false, stream);
}

extern "C" int latteclip_flash_fwd_seg(const void* qkv, const void* seg, void* out, void* lse,
                                       int B, int L, int H, int D, int causal, float qscale,
                                       void* stream) {
  return dispatch<true, false>(qkv, seg, out, lse, B, L, H, D, causal, qscale, false, stream);
}

// lse2 as [H/HP, HP, B, L], which is [H, B, L] in memory
extern "C" int latteclip_flash_fwd_hs(const void* qkv, void* out, void* lse, int B, int L, int H,
                                      int D, int causal, float qscale, void* stream) {
  return dispatch<false, false>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, true, stream);
}

// rows of at most 128 tokens; longer rows return cudaErrorInvalidValue
extern "C" int latteclip_flash_fwd_bd(const void* qkv, void* out, void* lse, int B, int L, int H,
                                      int D, int causal, float qscale, void* stream) {
  return dispatch<false, true>(qkv, nullptr, out, lse, B, L, H, D, causal, qscale, false, stream);
}
