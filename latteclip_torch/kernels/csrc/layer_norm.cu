// LayerNorm on Hopper (sm_90a): one forward kernel and one backward pair,
// x and y in bf16 (or fp16, or fp32) with float32 statistics.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm
// (latteclip_tpu/models/layers.py::layer_norm) to XLA, which fuses the
// casts, the statistics and the affine map into one pass. The port's
// composition, F.layer_norm(x.float(), ...).to(x.dtype), made full-size
// float32 copies both ways: 20 bytes an element forward (copy up, float32
// LayerNorm, cast down) and 32 backward (cotangent up, float32 input and
// parameter gradients, dx down), where the function needs 4 and 6 in bf16.
//
//   latteclip_layernorm_fwd_kernel: for each row of x [M, D],
//       mean = sum(x) / D, var = sum((x - mean)^2) / D, rstd = rsqrt(var + eps)
//       (two passes over the row, as jnp.var), y = T((x - mean) * rstd * gamma
//       + beta), rounded once; mean and rstd [M] f32 written only where the
//       backward will read them.
//   latteclip_layernorm_bwd_kernel: xhat = (x - mean) * rstd, g = gamma * dy,
//       dx = T(rstd * (g - sum(g) / D - xhat * sum(g * xhat) / D)); each CTA's
//       sums over its rows of dy * xhat and dy (f32) as one [D] pair of
//       partials.
//   latteclip_layernorm_bwd_reduce_kernel: dgamma, dbeta [2, D] f32, the
//       partials summed in a fixed order (no atomics: two backward runs give
//       the same bits).
//
// Bound: bytes. Forward reads x and writes y, 4 bytes an element in bf16;
// backward reads x and dy and writes dx, 6 (the statistics are 8 bytes a
// row, the parameters and partials a few [D] rows). So each row is read
// once and held in registers:
//   * a row takes `warps` warps (one up to D = 1024 in bf16), each lane `k`
//     accesses of `vec` elements, 16 bytes where the row's bytes allow, else
//     4 (D = 2730 in bf16), interleaved so that a warp's lanes touch
//     neighbouring addresses; lanes past the row's end are masked;
//   * the two sums of a row are warp shuffles, then, across the row's
//     warps, shared memory read in a fixed order, so every lane of a row
//     holds the same bits;
//   * the forward takes one row per row slot of a CTA (eight warps where a
//     row takes at most eight); the backward's CTAs are persistent (the
//     plan's CTAs an SM) and stride over rows, each lane keeping its
//     columns' dgamma and dbeta sums in f32 registers across its rows, so
//     a CTA writes one [D] pair of partials and the reduce kernel sums
//     [CTAs, D] (a few MB) in a fixed order;
//   * those sums leave the backward no registers to hold a second row, and
//     with x, dy and the row's work in registers a lane had one row's bytes
//     in flight: 66% of the byte bound at [100864, 768] on an H100. So each
//     lane copies its next row's accesses into a two-stage ring in shared
//     memory with cp.async while it works on the row before (72%).
// The launch plan (vec, k, warps, rows a CTA, backward CTAs an SM) is
// fused_ln_linear.py::layer_norm_plan, which the CPU tests hold.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream, does not synchronise, allocates nothing, and returns the CUDA
// error of its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_K = 4;         // accesses a lane makes in a row
constexpr int CTA_WARPS = 8;     // warps a CTA, where a row takes at most 8
constexpr int MAX_WARPS = 32;    // warps a row (rows of 16-byte accesses: 8)
constexpr int REDUCE_WARPS = 8;  // warps of a reduce CTA, over 32 columns

struct Bf16 {
  using S = uint16_t;
  static __device__ __forceinline__ float load(S s) { return __uint_as_float((uint32_t)s << 16); }
  static __device__ __forceinline__ S store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F16 {
  using S = uint16_t;
  static __device__ __forceinline__ float load(S s) { return __half2float(__ushort_as_half(s)); }
  static __device__ __forceinline__ S store(float f) { return __half_as_ushort(__float2half_rn(f)); }
};

struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S s) { return s; }
  static __device__ __forceinline__ S store(float f) { return f; }
};

// VEC elements moved by one load or store.
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

// A lane's VEC float32 parameters, in 16-byte loads where VEC >= 4.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = q.x, out[i + 1] = q.y, out[i + 2] = q.z, out[i + 3] = q.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = q.x, out[1] = q.y;
  } else {
    out[0] = __ldg(p);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over one row's `warps` warps of each lane's value: a butterfly in
// each warp (every lane ends with the same bits), then the warps' sums read
// from `buf` (one slot a warp of the CTA) in order. Every thread of the CTA
// calls it; `buf` must not be written again until every thread has read it.
__device__ __forceinline__ float2 row_sum(float2 v, int warps, float2* buf) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if (warps == 1) return v;
  const int w = threadIdx.x / 32, first = w - w % warps;
  if (threadIdx.x % 32 == 0) buf[w] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < warps; ++i) {
    const float2 b = buf[first + i];
    s.x += b.x, s.y += b.y;
  }
  return s;
}

// 16-byte accesses give rows of at most 8 warps and CTAs of 256 threads; the
// narrower accesses of odd widths hold a few elements a lane and may take up
// to 32 warps a row.
template <class E, int VEC>
constexpr bool kWide = sizeof(typename E::S) * VEC == 16;

template <class E, int VEC, int K>
__global__ void __launch_bounds__(kWide<E, VEC> ? CTA_WARPS * 32 : MAX_WARPS * 32)
    latteclip_layernorm_fwd_kernel(const typename E::S* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, typename E::S* __restrict__ y,
                                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                   int M, int D, int warps, float eps) {
  using S = typename E::S;
  using P = Pack<S, VEC>;
  __shared__ float2 red[2][MAX_WARPS];
  const int row_threads = warps * 32;
  const int slot = threadIdx.x / row_threads, t = threadIdx.x % row_threads;
  const long row = (long)blockIdx.x * (blockDim.x / row_threads) + slot;
  const bool live = row < M;
  const int nvec = D / VEC;
  const size_t base = live ? (size_t)row * D : 0;

  float v[K][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k * row_threads + t;
    if (live && j < nvec) {
      const P p = *reinterpret_cast<const P*>(x + base + (size_t)j * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = E::load(p.v[i]), s += v[k][i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = 0.f;
    }
  }
  const float mean = row_sum(make_float2(s, 0.f), warps, red[0]).x / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live && k * row_threads + t < nvec) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[k][i] - mean;
        q += d * d;
      }
    }
  }
  const float var = row_sum(make_float2(q, 0.f), warps, red[1]).x / D;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k * row_threads + t;
    if (live && j < nvec) {
      float g[VEC], b[VEC];
      load_f32<VEC>(gamma + j * VEC, g);
      load_f32<VEC>(beta + j * VEC, b);
      P p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) p.v[i] = E::store((v[k][i] - mean) * rstd * g[i] + b[i]);
      *reinterpret_cast<P*>(y + base + (size_t)j * VEC) = p;
    }
  }
  if (mean_out != nullptr && live && t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// A lane's access copied to shared memory without registers (cp.async):
// 16 bytes through L2 only, 4 bytes through L1; zeros where !valid.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    latteclip::cp_async_16(dst, src, valid);
  } else {
    static_assert(BYTES == 4, "accesses of 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(latteclip::smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

// Shared memory of a backward CTA of `threads`: the ring [2 stages][x, dy][K]
// [threads] of one access each, or the row slots' fold [2, D] f32 after it.
template <class E, int VEC, int K>
constexpr size_t bwd_ring_bytes(int threads) {
  return (size_t)2 * 2 * K * threads * sizeof(Pack<typename E::S, VEC>);
}

template <class E, int VEC, int K>
__global__ void __launch_bounds__(kWide<E, VEC> ? CTA_WARPS * 32 : MAX_WARPS * 32,
                                  kWide<E, VEC> ? 2 : 1)
    latteclip_layernorm_bwd_kernel(const typename E::S* __restrict__ x,
                                   const typename E::S* __restrict__ dy,
                                   const float* __restrict__ mean, const float* __restrict__ rstd,
                                   const float* __restrict__ gamma, typename E::S* __restrict__ dx,
                                   float* __restrict__ part, int M, int D, int warps) {
  using S = typename E::S;
  using P = Pack<S, VEC>;
  __shared__ float2 red[2][MAX_WARPS];
  extern __shared__ __align__(16) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);
  const int threads = blockDim.x, row_threads = warps * 32;
  const int rows = threads / row_threads;
  const int slot = threadIdx.x / row_threads, t = threadIdx.x % row_threads;
  const int nvec = D / VEC;
  const long stride = (long)gridDim.x * rows;

  // The next row's x and dy, each lane's accesses into `stage` of the ring
  // (zeros past the row's end or M), and its statistics into registers: the
  // copies fly while the lane works on the row before. A lane reads back
  // only what it copied, so the ring needs no barrier.
  float mu_next = 0.f, rs_next = 0.f;
  auto fetch = [&](long first, int stage) {
    const long row = first + slot;
    const bool live = row < M;
    const size_t base = live ? (size_t)row * D : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * row_threads + t;
      const bool valid = live && j < nvec;
      const size_t off = valid ? base + (size_t)j * VEC : 0;
      copy_async<sizeof(P)>(&ring[((stage * 2) * K + k) * threads + threadIdx.x], x + off, valid);
      copy_async<sizeof(P)>(&ring[((stage * 2 + 1) * K + k) * threads + threadIdx.x], dy + off, valid);
    }
    latteclip::cp_async_commit();
    mu_next = live ? mean[row] : 0.f;
    rs_next = live ? rstd[row] : 0.f;
  };

  float dg[K][VEC], db[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) dg[k][i] = 0.f, db[k][i] = 0.f;

  long first = (long)blockIdx.x * rows;
  if (first < M) fetch(first, 0);
  for (int stage = 0; first < M; first += stride, stage ^= 1) {
    latteclip::cp_async_wait<0>();
    P xp[K], dp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xp[k] = ring[((stage * 2) * K + k) * threads + threadIdx.x];
      dp[k] = ring[((stage * 2 + 1) * K + k) * threads + threadIdx.x];
    }
    const float mu = mu_next, rs = rs_next;
    if (first + stride < M) fetch(first + stride, stage ^ 1);
    const long row = first + slot;
    const bool live = row < M;
    const size_t base = live ? (size_t)row * D : 0;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * row_threads + t;
      if (live && j < nvec) {
        float g[VEC];
        load_f32<VEC>(gamma + j * VEC, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = (E::load(xp[k].v[i]) - mu) * rs, d = E::load(dp[k].v[i]);
          const float gd = g[i] * d;
          a += gd;
          b += gd * xh;
          dg[k][i] += d * xh;
          db[k][i] += d;
        }
      }
    }
    const float2 ab = row_sum(make_float2(a, b), warps, red[stage]);
    const float ma = ab.x / D, mb = ab.y / D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * row_threads + t;
      if (live && j < nvec) {
        float g[VEC];
        load_f32<VEC>(gamma + j * VEC, g);
        P p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = (E::load(xp[k].v[i]) - mu) * rs;
          p.v[i] = E::store(rs * (g[i] * E::load(dp[k].v[i]) - ma - xh * mb));
        }
        *reinterpret_cast<P*>(dx + base + (size_t)j * VEC) = p;
      }
    }
  }

  // This CTA's [D] pair: the row slots' sums folded in slot order, in the
  // shared memory the ring held.
  float* dg_out = part + (size_t)blockIdx.x * D;
  float* db_out = part + ((size_t)gridDim.x + blockIdx.x) * D;
  if (rows == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * row_threads + t;
      if (j < nvec) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dg_out[j * VEC + i] = dg[k][i], db_out[j * VEC + i] = db[k][i];
      }
    }
    return;
  }
  float* fold = reinterpret_cast<float*>(smem);
  __syncthreads();
  for (int s = 0; s < rows; ++s) {
    if (slot == s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = k * row_threads + t;
        if (j < nvec) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int c = j * VEC + i;
            fold[c] = s ? fold[c] + dg[k][i] : dg[k][i];
            fold[D + c] = s ? fold[D + c] + db[k][i] : db[k][i];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) dg_out[c] = fold[c], db_out[c] = fold[D + c];
}

// out [2, D] = the sums over `parts` of part [2, parts, D]: each CTA takes 32
// columns of dgamma (blockIdx.y 0) or dbeta (1); warp w sums parts w, w + 8,
// ... in order, then warp 0 adds the eight sums in order.
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
    latteclip_layernorm_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                          int parts, int D) {
  __shared__ float sums[REDUCE_WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const float* p = part + (size_t)blockIdx.y * parts * D;
  float s = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int i = w; i < parts; i += REDUCE_WARPS) s += p[(size_t)i * D + c];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < D) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < REDUCE_WARPS; ++i) total += sums[i][lane];
    out[(size_t)blockIdx.y * D + c] = total;
  }
}

// -- host side -----------------------------------------------------------------

struct FwdArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* mean;
  float* rstd;
  int M, D, warps, rows;
  float eps;
  cudaStream_t stream;
};

struct BwdArgs {
  const void* x;
  const void* dy;
  const float* mean;
  const float* rstd;
  const float* gamma;
  void* dx;
  float* part;
  float* out;
  int M, D, warps, rows, ctas;
  cudaStream_t stream;
};

template <class E, int VEC, int K>
int run(const FwdArgs& a) {
  using S = typename E::S;
  const long blocks = ((long)a.M + a.rows - 1) / a.rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  latteclip_layernorm_fwd_kernel<E, VEC, K><<<(unsigned)blocks, a.rows * a.warps * 32, 0, a.stream>>>(
      static_cast<const S*>(a.x), a.gamma, a.beta, static_cast<S*>(a.y), a.mean, a.rstd, a.M, a.D,
      a.warps, a.eps);
  return (int)cudaGetLastError();
}

template <class E, int VEC, int K>
int run(const BwdArgs& a) {
  using S = typename E::S;
  auto kernel = latteclip_layernorm_bwd_kernel<E, VEC, K>;
  const int threads = a.rows * a.warps * 32;
  const size_t fold_bytes = a.rows > 1 ? (size_t)2 * a.D * sizeof(float) : 0;
  const size_t smem = std::max(bwd_ring_bytes<E, VEC, K>(threads), fold_bytes);
  static bool allowed[latteclip::MAX_DEVICES] = {};
  cudaError_t err = latteclip::allow_smem(
      kernel, (int)bwd_ring_bytes<E, VEC, K>(kWide<E, VEC> ? CTA_WARPS * 32 : MAX_WARPS * 32), allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.ctas, threads, smem, a.stream>>>(
      static_cast<const S*>(a.x), static_cast<const S*>(a.dy), a.mean, a.rstd, a.gamma,
      static_cast<S*>(a.dx), a.part, a.M, a.D, a.warps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  latteclip_layernorm_bwd_reduce_kernel<<<dim3((a.D + 31) / 32, 2), REDUCE_WARPS * 32, 0, a.stream>>>(
      a.part, a.out, a.ctas, a.D);
  return (int)cudaGetLastError();
}

template <class E, int VEC, class A>
int by_k(int k, const A& a) {
  switch (k) {
    case 1: return run<E, VEC, 1>(a);
    case 2: return run<E, VEC, 2>(a);
    case 3: return run<E, VEC, 3>(a);
    case 4: return run<E, VEC, 4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// The access width: 16 bytes or 4 (the plan's `vec`).
template <class E, class A>
int by_vec(int vec, int k, const A& a) {
  constexpr int size = sizeof(typename E::S);
  if (vec == 16 / size) return by_k<E, 16 / size>(k, a);
  if (vec == 4 / size) return by_k<E, 4 / size>(k, a);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 bf16, 1 fp16, 2 fp32. Refuses a plan that does not cover the row
// or that a kernel cannot take, and pointers not aligned to their accesses.
template <class A>
int dispatch(int dtype, int vec, int k, const A& a, const void* const* rows_ptrs, int n_rows_ptrs,
             const float* const* params, int n_params) {
  const int size = dtype == 2 ? 4 : 2;
  const int vec_bytes = vec * size, M = a.M, D = a.D, warps = a.warps, rows = a.rows;
  if (dtype < 0 || dtype > 2 || M <= 0 || D <= 0 || vec <= 0 || D % vec ||
      (vec_bytes != 16 && vec_bytes != 4) || k < 1 || k > MAX_K || warps < 1 ||
      warps > (vec_bytes == 16 ? CTA_WARPS : MAX_WARPS) || rows < 1 ||
      (rows > 1 && rows * warps > CTA_WARPS) || (long)32 * warps * k * vec < D)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_rows_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(rows_ptrs[i]) % vec_bytes) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_params; ++i)
    if (reinterpret_cast<uintptr_t>(params[i]) % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_vec<Bf16>(vec, k, a);
  if (dtype == 1) return by_vec<F16>(vec, k, a);
  return by_vec<F32>(vec, k, a);
}

}  // namespace

// y [M, D] = LayerNorm(x [M, D]) in x's dtype; mean, rstd [M] f32 written
// unless null (both or neither). gamma, beta [D] f32, 16-byte aligned. The
// plan (vec, k, warps, rows) is fused_ln_linear.py::layer_norm_plan.
extern "C" int latteclip_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                       void* mean, void* rstd, int M, int D, int dtype, int vec,
                                       int k, int warps, int rows, float eps, void* stream) {
  if ((mean == nullptr) != (rstd == nullptr)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), y,
                  static_cast<float*>(mean), static_cast<float*>(rstd), M, D, warps, rows, eps,
                  static_cast<cudaStream_t>(stream)};
  const void* rows_ptrs[] = {x, y};
  const float* params[] = {a.gamma, a.beta};
  return dispatch(dtype, vec, k, a, rows_ptrs, 2, params, 2);
}

// dx [M, D] in x's dtype and dgamma, dbeta as out [2, D] f32, from x and dy
// [M, D], the forward's mean and rstd [M] and gamma [D] f32; part [2, ctas,
// D] f32 is scratch. `ctas` persistent CTAs of the plan's rows stride over
// the rows, then the reduce kernel sums their partials.
extern "C" int latteclip_layernorm_bwd(const void* x, const void* dy, const void* mean,
                                       const void* rstd, const void* gamma, void* dx, void* part,
                                       void* out, int M, int D, int dtype, int vec, int k, int warps,
                                       int rows, int ctas, void* stream) {
  if (ctas < 1 || (long)ctas * rows > (long)M + rows - 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, dy, static_cast<const float*>(mean), static_cast<const float*>(rstd),
                  static_cast<const float*>(gamma), dx, static_cast<float*>(part),
                  static_cast<float*>(out), M, D, warps, rows, ctas,
                  static_cast<cudaStream_t>(stream)};
  const void* rows_ptrs[] = {x, dy, dx};
  const float* params[] = {a.gamma};
  return dispatch(dtype, vec, k, a, rows_ptrs, 3, params, 1);
}
