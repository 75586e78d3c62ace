// BatchNorm with batch statistics over the rows of a channels-last
// activation, forward and backward, with an optional ReLU fused into its
// epilogue, for Hopper (sm_90a).
//
// Replaces no TPU kernel: swat_tpu leaves its AffineBN
// (swat_tpu/models/resnet.py) to XLA, which fuses its passes.  The port's
// models/resnet.py::AffineBN computes the same function in train mode as
// separate PyTorch passes (an fp32 upcast, the mean, Welford's variance, the
// affine coefficients, x * a, + b, then F.relu), which autograd
// differentiates one by one: about 30 passes over the activation a call,
// and the fp32 upcast saved for the variance's gradient.  These kernels
// compute what that path computes:
//   mean and biased variance of each channel in fp32 over N, H and W;
//   rstd = rsqrt(var + eps); a = w * rstd and b = bias - mean * w * rstd,
//   each in fp32 and rounded once to the activation's dtype;
//   y = x * a + b with the product rounded, then the sum (as two PyTorch
//   passes round them), and max(y, 0) where a ReLU follows;
//   the batch mean and the unbiased variance for the running statistics.
// The backward is the exact fp32 gradient of that function, with dz = dy
// where the output is positive (or everywhere, without the ReLU):
//   dx = a32 * ((dz - mean(dz)) - (x - mean) * rstd * mean(dz * xhat)),
//   a32 = w * rstd in fp32, rounded once to x's dtype; dw = sum(dz * xhat)
//   and db = sum(dz) in fp32.  The ReLU's mask is recomputed from x, a and b
//   at the forward's rounding points, so nothing beyond x and a few floats a
//   channel is saved or read.
//
// What bounds it on this card: bytes.  A few operations an element against
// the 295 a byte that would make the H100 compute-bound.  So the forward
// reads x twice (statistics, then the affine) and writes y once; the
// backward reads x and dy twice (the two channel sums, then dx) and writes
// dx once.
//
// Design.
// * An activation [B, C, H, W] that is channels-last is a row-major
//   [M, C], M = B * H * W.  A block of kThreads threads takes a channel tile
//   (blockIdx.y: tpr lanes of n channels, n = 16 bytes of elements: 4 fp32
//   or 8 bf16; C a multiple of n, every row 16-byte aligned) of a slab of
//   rows (blockIdx.x: slab_rows rows); its
//   kThreads / tpr row lanes take every (kThreads / tpr)-th row of the slab,
//   kUnroll rows loaded before they are used.  A warp reads whole row
//   segments of 16-byte vectors.  plan() in kernels/batch_norm.py picks tpr
//   and the slabs from (M, C) so that enough blocks fill the 132 SMs at
//   every shape, from the stem's C = 32 at M = 3.2 M rows to C = 2048 at a
//   few hundred.
// * Statistics: each thread keeps Welford's count, mean and M2 of its
//   channels over its rows; the block's row lanes are merged by Chan's
//   formula in a fixed tree (lane r takes lane r + half, half = R / 2 .. 1)
//   and the block writes one partial per (slab, channel); a join kernel
//   merges a channel's partials in a fixed order (warp w of kJoinWarps
//   takes partials w, w + kJoinWarps, ... in order, kJoinUnroll loaded at
//   once, then the warps merge in a fixed tree).  The backward's two
//   channel sums go the same way as plain sums.  No atomics: the same inputs
//   give the same bits.
// * Three launches each way: statistics, join, apply (forward); the two
//   sums, join, dx (backward).  The joins are small: a channel has at most
//   about a thousand partials (the stem's 32 channels, one block).
// * x, y, dy, dx, a and b share one dtype, fp32 or bf16; the statistics, w,
//   bias, dw and db are fp32.  The affine and dx use explicitly rounded fp32
//   operations (__fmul_rn, __fadd_rn, __fsub_rn), never a contracted
//   multiply-add, so that the rounding points are the plain path's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bnk {

constexpr int kThreads = 256;  // threads a block of the streaming kernels
constexpr int kUnroll = 4;     // rows a thread loads before it uses them
constexpr int kJoinWarps = 32;  // joins: warps a block of 32 channels
constexpr int kJoinUnroll = 4;  // joins: partials a lane loads at once

// the launch shape (kernels/batch_norm.py::plan): slabs x tiles blocks; a
// block takes slab_rows rows of blockIdx.y's tile of tpr x n channels
struct Plan {
  int rows, channels, tpr, slab_rows, slabs;
};

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements at p <-> floats, in 16-byte accesses (p aligned
// to 16 bytes)
template <int N>
__device__ __forceinline__ void load(const float* p, float* v) {
  static_assert(N % 4 == 0, "16-byte vectors of fp32");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    v[k] = t.x;
    v[k + 1] = t.y;
    v[k + 2] = t.z;
    v[k + 3] = t.w;
  }
}

// a bf16 is the high half of the fp32 of the same value
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  static_assert(N % 8 == 0, "16-byte vectors of bf16");
#pragma unroll
  for (int k = 0; k < N; k += 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p + k);
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[k + 2 * j] = __uint_as_float(u[j] << 16);
      v[k + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  static_assert(N % 4 == 0, "16-byte vectors of fp32");
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  static_assert(N % 8 == 0, "16-byte vectors of bf16");
#pragma unroll
  for (int k = 0; k < N; k += 8) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[k + 2 * j], v[k + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + k) = *reinterpret_cast<const uint4*>(h);
  }
}

// a thread's N elements of a row as loaded, widened at use: a bf16 vector
// stays in its four words until then (half the registers of its floats)
template <typename T, int N>
struct Raw;

template <>
struct Raw<float, 4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) { bnk::load<4>(p, v); }
  __device__ __forceinline__ void get(float* out) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = v[e];
  }
};

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 t;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    t = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* v) const {
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
};

// Chan's merge of (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a), N channels
template <int N>
__device__ __forceinline__ void chan_merge(float& n_a, float* mean_a,
                                           float* m2_a, float n_b,
                                           const float* mean_b,
                                           const float* m2_b) {
  if (n_b == 0.f) return;
  if (n_a == 0.f) {
    n_a = n_b;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      mean_a[e] = mean_b[e];
      m2_a[e] = m2_b[e];
    }
    return;
  }
  const float n = n_a + n_b;
  const float f = __fdiv_rn(n_b, n);
  const float g = n_a * f;  // n_a n_b / n
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float d = mean_b[e] - mean_a[e];
    mean_a[e] = fmaf(d, f, mean_a[e]);
    m2_a[e] = m2_a[e] + m2_b[e] + d * d * g;
  }
  n_a = n;
}

// rows of slab s
__device__ __forceinline__ float slab_count(const Plan& p, int s) {
  const long long left = p.rows - static_cast<long long>(s) * p.slab_rows;
  const long long cap = p.slab_rows;
  return static_cast<float>(left < 0 ? 0 : min(left, cap));
}

// where this thread works: its first channel, its row lane, the block's
// row lanes (the rows' stride) and the slab's rows [r0, r1)
struct Place {
  int c0, lane_r, step, r0, r1;
  bool live;
};

template <int N>
__device__ __forceinline__ Place place(const Plan& p) {
  Place q;
  q.lane_r = threadIdx.x / p.tpr;
  q.step = kThreads / p.tpr;
  q.c0 = (blockIdx.y * p.tpr + threadIdx.x % p.tpr) * N;
  q.live = q.c0 < p.channels;
  const long long r0 = static_cast<long long>(blockIdx.x) * p.slab_rows;
  const long long rows = p.rows;
  q.r0 = static_cast<int>(min(r0, rows));
  q.r1 = static_cast<int>(min(r0 + p.slab_rows, rows));
  return q;
}

// the affine at the plain path's rounding points, then the ReLU:
// round(round(x * a) + b), max(., 0) (NaN kept, as F.relu keeps it)
template <typename T>
__device__ __forceinline__ float affine(float x, float a, float b,
                                        int relu) {
  const float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, a)), b));
  return relu && z <= 0.f ? 0.f : z;
}

// dz: dy where the forward's output is positive (F.relu's gradient passes
// it where the output is not <= 0), or dy
template <typename T>
__device__ __forceinline__ float masked(float x, float dy, float a, float b,
                                       int relu) {
  return relu && affine<T>(x, a, b, 0) <= 0.f ? 0.f : dy;
}

// ---- forward 1/3: each block's Welford partial of its channels over its
// slab -> part[0][slab][C] (mean), part[1][slab][C] (M2)

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    batchnorm_stats_kernel(const T* __restrict__ x, Plan p,
                           float* __restrict__ part) {
  __shared__ float s_mean[kThreads * N];
  __shared__ float s_m2[kThreads * N];
  __shared__ float s_n[kThreads];
  const Place q = place<N>(p);
  float n = 0.f, mean[N], m2[N];
#pragma unroll
  for (int e = 0; e < N; ++e) mean[e] = m2[e] = 0.f;
  if (q.live) {
    int count = 0;
    for (int r = q.r0 + q.lane_r; r < q.r1; r += q.step * kUnroll) {
      Raw<T, N> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * q.step < q.r1)
          raw[u].load(x + static_cast<long long>(r + u * q.step) * p.channels +
                      q.c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * q.step >= q.r1) break;
        ++count;
        const float inv = __frcp_rn(static_cast<float>(count));
        float v[N];
        raw[u].get(v);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = v[e] - mean[e];
          mean[e] = fmaf(d, inv, mean[e]);
          m2[e] = fmaf(d, v[e] - mean[e], m2[e]);
        }
      }
    }
    n = static_cast<float>(count);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s_mean[threadIdx.x * N + e] = mean[e];
    s_m2[threadIdx.x * N + e] = m2[e];
  }
  s_n[threadIdx.x] = n;
  for (int half = q.step / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (q.lane_r < half) {
      const int o = threadIdx.x + half * p.tpr;
      float mb[N], qb[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        mb[e] = s_mean[o * N + e];
        qb[e] = s_m2[o * N + e];
      }
      chan_merge<N>(n, mean, m2, s_n[o], mb, qb);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s_mean[threadIdx.x * N + e] = mean[e];
        s_m2[threadIdx.x * N + e] = m2[e];
      }
      s_n[threadIdx.x] = n;
    }
  }
  if (q.lane_r != 0 || !q.live) return;
  const long long at = static_cast<long long>(blockIdx.x) * p.channels + q.c0;
  store<N>(part + at, mean);
  store<N>(part + static_cast<long long>(p.slabs) * p.channels + at, m2);
}

// ---- forward 2/3: a channel's partials merged in a fixed order -> fp32
// mean and rstd (kept for the backward), the unbiased variance (for the
// running statistics), a and b rounded to T.  A block takes 32 channels, a
// lane one; warp w merges partials w, w + kJoinWarps, ... in order, then the
// warps merge in a tree (warp w takes warp w + half, half = 16 .. 1)

template <typename T>
__global__ void __launch_bounds__(kJoinWarps * 32)
    batchnorm_join_kernel(const float* __restrict__ part, Plan p,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, float eps,
                          float unbias, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out,
                          float* __restrict__ var_out, T* __restrict__ a_out,
                          T* __restrict__ b_out) {
  __shared__ float red[3][kJoinWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const long long plane = static_cast<long long>(p.slabs) * p.channels;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < p.channels)
    for (int s0 = warp; s0 < p.slabs; s0 += kJoinWarps * kJoinUnroll) {
      float mb[kJoinUnroll], qb[kJoinUnroll];
#pragma unroll
      for (int u = 0; u < kJoinUnroll; ++u) {
        const long long at =
            static_cast<long long>(s0 + u * kJoinWarps) * p.channels + c;
        const bool in = s0 + u * kJoinWarps < p.slabs;
        mb[u] = in ? part[at] : 0.f;
        qb[u] = in ? part[plane + at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kJoinUnroll; ++u)
        if (s0 + u * kJoinWarps < p.slabs)
          chan_merge<1>(n, &mean, &m2, slab_count(p, s0 + u * kJoinWarps),
                        &mb[u], &qb[u]);
    }
  red[0][warp][lane] = n;
  red[1][warp][lane] = mean;
  red[2][warp][lane] = m2;
  for (int half = kJoinWarps / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (warp < half) {
      chan_merge<1>(n, &mean, &m2, red[0][warp + half][lane],
                    &red[1][warp + half][lane], &red[2][warp + half][lane]);
      red[0][warp][lane] = n;
      red[1][warp][lane] = mean;
      red[2][warp][lane] = m2;
    }
  }
  if (warp != 0 || c >= p.channels) return;
  const float var = __fdiv_rn(m2, n);
  const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
  const float wc = w[c];
  mean_out[c] = mean;
  rstd_out[c] = rstd;
  var_out[c] = __fmul_rn(var, unbias);
  a_out[c] = from_f<T>(__fmul_rn(wc, rstd));
  b_out[c] = from_f<T>(__fsub_rn(bias[c],
                                 __fmul_rn(__fmul_rn(mean, wc), rstd)));
}

// ---- forward 3/3: y = affine(x)

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    batchnorm_apply_kernel(const T* __restrict__ x, Plan p,
                           const T* __restrict__ a, const T* __restrict__ b,
                           int relu, T* __restrict__ y) {
  const Place q = place<N>(p);
  if (!q.live) return;
  float av[N], bv[N];
  load<N>(a + q.c0, av);
  load<N>(b + q.c0, bv);
  for (int r = q.r0 + q.lane_r; r < q.r1; r += q.step * kUnroll) {
    Raw<T, N> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * q.step < q.r1)
        raw[u].load(x + static_cast<long long>(r + u * q.step) * p.channels +
                    q.c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * q.step >= q.r1) break;
      float v[N];
      raw[u].get(v);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = affine<T>(v[e], av[e], bv[e], relu);
      store<N>(y + static_cast<long long>(r + u * q.step) * p.channels + q.c0,
               v);
    }
  }
}

// ---- backward 1/3: each block's sums of dz and dz * (x - mean) of its
// channels over its slab -> part[0][slab][C], part[1][slab][C]

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    batchnorm_bwd_reduce_kernel(const T* __restrict__ x,
                                const T* __restrict__ dy, Plan p,
                                const float* __restrict__ mean,
                                const T* __restrict__ a,
                                const T* __restrict__ b, int relu,
                                float* __restrict__ part) {
  __shared__ float s_1[kThreads * N];
  __shared__ float s_2[kThreads * N];
  const Place q = place<N>(p);
  float s1[N], s2[N];
#pragma unroll
  for (int e = 0; e < N; ++e) s1[e] = s2[e] = 0.f;
  if (q.live) {
    float mu[N], av[N], bv[N];
    load<N>(mean + q.c0, mu);
    load<N>(a + q.c0, av);
    load<N>(b + q.c0, bv);
    for (int r = q.r0 + q.lane_r; r < q.r1; r += q.step * kUnroll) {
      Raw<T, N> xr[kUnroll], dr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * q.step >= q.r1) continue;
        const long long at =
            static_cast<long long>(r + u * q.step) * p.channels + q.c0;
        xr[u].load(x + at);
        dr[u].load(dy + at);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * q.step >= q.r1) break;
        float xv[N], dv[N];
        xr[u].get(xv);
        dr[u].get(dv);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float dz = masked<T>(xv[e], dv[e], av[e], bv[e], relu);
          s1[e] += dz;
          s2[e] = fmaf(dz, xv[e] - mu[e], s2[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s_1[threadIdx.x * N + e] = s1[e];
    s_2[threadIdx.x * N + e] = s2[e];
  }
  for (int half = q.step / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (q.lane_r < half) {
      const int o = threadIdx.x + half * p.tpr;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s1[e] += s_1[o * N + e];
        s2[e] += s_2[o * N + e];
        s_1[threadIdx.x * N + e] = s1[e];
        s_2[threadIdx.x * N + e] = s2[e];
      }
    }
  }
  if (q.lane_r != 0 || !q.live) return;
  const long long at = static_cast<long long>(blockIdx.x) * p.channels + q.c0;
  store<N>(part + at, s1);
  store<N>(part + static_cast<long long>(p.slabs) * p.channels + at, s2);
}

// ---- backward 2/3: a channel's sums added in the forward join's order ->
// dw = s2 * rstd and db = s1 (when asked for), and dx's coefficients
// coef[0 | 1 | 2][C]: a32 = w * rstd, mean(dz) = s1 / M,
// rstd * mean(dz * xhat) = rstd * dw / M

__global__ void __launch_bounds__(kJoinWarps * 32)
    batchnorm_bwd_join_kernel(const float* __restrict__ part, Plan p,
                              const float* __restrict__ rstd,
                              const float* __restrict__ w,
                              float* __restrict__ dw, float* __restrict__ db,
                              float* __restrict__ coef) {
  __shared__ float red[2][kJoinWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const long long plane = static_cast<long long>(p.slabs) * p.channels;
  float s1 = 0.f, s2 = 0.f;
  if (c < p.channels)
    for (int s0 = warp; s0 < p.slabs; s0 += kJoinWarps * kJoinUnroll) {
      float a1[kJoinUnroll], a2[kJoinUnroll];
#pragma unroll
      for (int u = 0; u < kJoinUnroll; ++u) {
        const long long at =
            static_cast<long long>(s0 + u * kJoinWarps) * p.channels + c;
        const bool in = s0 + u * kJoinWarps < p.slabs;
        a1[u] = in ? part[at] : 0.f;
        a2[u] = in ? part[plane + at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kJoinUnroll; ++u) {
        s1 += a1[u];
        s2 += a2[u];
      }
    }
  red[0][warp][lane] = s1;
  red[1][warp][lane] = s2;
  for (int half = kJoinWarps / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (warp < half) {
      s1 += red[0][warp + half][lane];
      s2 += red[1][warp + half][lane];
      red[0][warp][lane] = s1;
      red[1][warp][lane] = s2;
    }
  }
  if (warp != 0 || c >= p.channels) return;
  const float rs = rstd[c];
  const float dwc = __fmul_rn(s2, rs);
  if (dw != nullptr) {
    dw[c] = dwc;
    db[c] = s1;
  }
  const float m = static_cast<float>(p.rows);
  coef[c] = __fmul_rn(w[c], rs);
  coef[p.channels + c] = __fdiv_rn(s1, m);
  coef[2 * p.channels + c] = __fmul_rn(rs, __fdiv_rn(dwc, m));
}

// ---- backward 3/3: dx = a32 * ((dz - mean(dz)) - (x - mean) * rstd *
// mean(dz * xhat))

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    batchnorm_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        Plan p, const float* __restrict__ mean,
                        const float* __restrict__ coef,
                        const T* __restrict__ a, const T* __restrict__ b,
                        int relu, T* __restrict__ dx) {
  const Place q = place<N>(p);
  if (!q.live) return;
  float mu[N], k[N], m1[N], c2[N], av[N], bv[N];
  load<N>(mean + q.c0, mu);
  load<N>(coef + q.c0, k);
  load<N>(coef + p.channels + q.c0, m1);
  load<N>(coef + 2 * p.channels + q.c0, c2);
  load<N>(a + q.c0, av);
  load<N>(b + q.c0, bv);
  for (int r = q.r0 + q.lane_r; r < q.r1; r += q.step * kUnroll) {
    Raw<T, N> xr[kUnroll], dr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * q.step >= q.r1) continue;
      const long long at =
          static_cast<long long>(r + u * q.step) * p.channels + q.c0;
      xr[u].load(x + at);
      dr[u].load(dy + at);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * q.step >= q.r1) break;
      float xv[N], dv[N];
      xr[u].get(xv);
      dr[u].get(dv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float dz = masked<T>(xv[e], dv[e], av[e], bv[e], relu);
        dv[e] = __fmul_rn(
            k[e], __fsub_rn(__fsub_rn(dz, m1[e]),
                            __fmul_rn(__fsub_rn(xv[e], mu[e]), c2[e])));
      }
      store<N>(dx + static_cast<long long>(r + u * q.step) * p.channels +
                   q.c0,
               dv);
    }
  }
}

// the plan's grid, or a zero grid where the plan is out of range
inline dim3 grid_of(const Plan& p, int n) {
  const bool ok = p.rows > 0 && p.channels > 0 && p.tpr > 0 &&
                  p.tpr <= 32 && (p.tpr & (p.tpr - 1)) == 0 &&
                  p.slab_rows > 0 && p.slabs > 0 &&
                  static_cast<long long>(p.slabs) * p.slab_rows >= p.rows;
  const int tiles = ((p.channels + n - 1) / n + p.tpr - 1) / p.tpr;
  return ok && tiles <= 65535 ? dim3(p.slabs, tiles) : dim3(0, 0);
}

template <typename T, int N>
cudaError_t fwd_typed(const void* x, Plan p, const float* w,
                      const float* bias, float eps, float unbias, int relu,
                      float* part, float* mean, float* rstd, float* var,
                      void* a, void* b, void* y, cudaStream_t s) {
  const dim3 grid = grid_of(p, N);
  if (grid.x == 0) return cudaErrorInvalidValue;
  batchnorm_stats_kernel<T, N>
      <<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), p, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  batchnorm_join_kernel<T><<<(p.channels + 31) / 32, kJoinWarps * 32, 0, s>>>(
      part, p, w, bias, eps, unbias, mean, rstd, var, static_cast<T*>(a),
      static_cast<T*>(b));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  batchnorm_apply_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), p, static_cast<const T*>(a),
      static_cast<const T*>(b), relu, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t bwd_typed(const void* x, const void* dy, Plan p,
                      const float* mean, const float* rstd, const float* w,
                      const void* a, const void* b, int relu, float* part,
                      float* coef, float* dw, float* db, void* dx,
                      cudaStream_t s) {
  const dim3 grid = grid_of(p, N);
  if (grid.x == 0) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  batchnorm_bwd_reduce_kernel<T, N>
      <<<grid, kThreads, 0, s>>>(xt, dyt, p, mean, at, bt, relu, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  batchnorm_bwd_join_kernel<<<(p.channels + 31) / 32, kJoinWarps * 32, 0,
                              s>>>(part, p, rstd, w, dw, db, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  batchnorm_dx_kernel<T, N><<<grid, kThreads, 0, s>>>(
      xt, dyt, p, mean, coef, at, bt, relu, static_cast<T*>(dx));
  return cudaGetLastError();
}
}  // namespace bnk
}  // namespace

// C entry points, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16,
// of x, y, dy, dx, a and b alike; x, y, dy and dx are row-major [rows,
// channels], 16-byte aligned, channels a multiple of 16 bytes of elements
// (a thread reads 4 fp32 or 8 bf16 at once); tpr, slab_rows, slabs:
// kernels/batch_norm.py::plan.  part: 2 x slabs x channels
// floats of scratch.  Returns the cudaError_t of the launches (0 on
// success).

// y from x, fp32 w and bias [channels]; mean, rstd and the unbiased
// variance fp32 [channels], a and b [channels] in the dtype.
extern "C" int swat_bn_fwd(const void* x, int dtype, int rows, int channels,
                           int tpr, int slab_rows, int slabs,
                           const float* w, const float* bias, float eps,
                           float unbias, int relu, float* part, float* mean,
                           float* rstd, float* var, void* a, void* b,
                           void* y, void* stream) {
  const bnk::Plan p{rows, channels, tpr, slab_rows, slabs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bnk::fwd_typed<float, 4>(x, p, w, bias, eps, unbias, relu, part,
                                    mean, rstd, var, a, b, y, s);
  if (dtype == 1)
    return bnk::fwd_typed<__nv_bfloat16, 8>(x, p, w, bias, eps, unbias, relu,
                                            part, mean, rstd, var, a, b, y,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx from x, dy and the forward's mean, rstd, a and b; dw and db fp32
// [channels] when dw is not null; coef: 3 x channels floats of scratch.
extern "C" int swat_bn_bwd(const void* x, const void* dy, int dtype,
                           int rows, int channels, int tpr, int slab_rows,
                           int slabs, const float* mean, const float* rstd,
                           const float* w, const void* a, const void* b,
                           int relu, float* part, float* coef, float* dw,
                           float* db, void* dx, void* stream) {
  const bnk::Plan p{rows, channels, tpr, slab_rows, slabs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bnk::bwd_typed<float, 4>(x, dy, p, mean, rstd, w, a, b, relu,
                                    part, coef, dw, db, dx, s);
  if (dtype == 1)
    return bnk::bwd_typed<__nv_bfloat16, 8>(x, dy, p, mean, rstd, w, a, b,
                                            relu, part, coef, dw, db, dx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
