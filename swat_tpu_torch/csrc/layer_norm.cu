// LayerNorm over the last dimension of a [T, W] activation, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: swat_tpu leaves LayerNorm
// (swat_tpu/models/functional.py::_layer_norm) to XLA, which fuses its
// passes.  The port's models/clip.py::layer_norm runs the same formula in
// fp32 as separate PyTorch passes (an upcast, two means, the broadcast
// scale, the centring, the bias, the cast back), and autograd
// differentiates each of them: about 40 passes over [T, W] a call.  This
// pair computes the same function: fp32 statistics of each row (the
// one-pass clamped variance max(E[x^2] - mu^2, 0) where the precision
// policy asks for it, the exact two-pass variance otherwise), then
// y = (x - mu) * (rstd * w) + b rounded once to the output dtype, with the
// scale w and the bias b read in fp32 (not rounded to the compute dtype
// first, as the TPU block kernels of megablock.cuh do).
//
// What bounds it on this card: bytes.  A row is a few hundred operations
// over W elements, against the 295 operations a byte that would make the
// H100 compute-bound.  So the forward reads x once and writes y once (and
// 8 bytes of statistics a row when a gradient will be taken); the backward
// reads x, dy and the statistics once and writes dx once, and produces the
// parameter gradients from the same registers.
//
// Design.
// * A row belongs to a group of kGroup warps, which holds it in registers
//   as loaded (bf16 two to a register) and widens it at each use: lane l
//   of warp g of the group holds the 16-byte vectors
//   vi = i * 32 * kGroup + g * 32 + l of the row, i < kIters, at most 32
//   elements a lane.  One warp takes a row of up to 1024 elements (the
//   towers' widths are 512 to 1024); wider rows take 2, 4 or 8 warps, up
//   to 8192 elements, whose sums meet behind a barrier of the group's
//   warps.  Loads and stores are 16 bytes a thread where the pointers,
//   strides and width allow it, element by element otherwise, in the same
//   order.  The forward never goes through shared memory for the row.
// * x, y, dy and dx share one dtype, fp32 or bf16 (the towers' compute
//   dtype); the statistics, w, b, dw and db are fp32.
// * Row sums: each lane adds its elements in order (i, then the element
//   in the vector), then the warp adds lanes xor 16, 8, 4, 2, 1, then the
//   group's warps are added in order.  Every arithmetic step is an
//   explicitly rounded fp32 operation (__fadd_rn, __fmul_rn, __fdiv_rn,
//   __frsqrt_rn), never a contracted multiply-add, so that
//   tests/torch_port_lib.py::ln_model_* repeat the kernels bit for bit.
// * The backward's parameter gradients are deterministic column sums with
//   no atomics: block b owns rows [64 b, 64 b + 64); each of its
//   G = kWarps / kGroup row groups takes every G-th of them and adds its
//   columns' terms, in row order, to its own 2 x W floats of shared memory
//   (held there, not in registers); the groups are joined in a fixed tree
//   (group g adds group g + half, half = G/2, ..., 1) and block b writes
//   one partial row; layernorm_join_kernel then adds the partial rows in a
//   fixed order (kJoinWarps contiguous chunks, each in order, then the
//   chunks in order).  Smaller blocks, more of them (measured: 8 to 32
//   rows), and 128 rows left the backward slower at the towers' shapes.
// * The backward's fast-variance clamp: where max(E[x^2] - mu^2, 0) clamped
//   a row, autograd of the plain formula passes no gradient through the
//   variance.  The forward stores that row's rstd negated, and the backward
//   drops the variance term there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace lnk {

constexpr int kWarps = 8;          // warps a block
constexpr int kMaxPerLane = 32;    // elements of a row a lane holds
constexpr int kMaxGroup = kWarps;  // warps a row at most
constexpr int kRowsPerBlock = 64;  // backward: rows one block sums
constexpr int kJoinWarps = 8;      // join: chunks of partial rows a column

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

// N consecutive elements at p (8, 16 or 32 bytes, aligned to the vector
// unit) <-> floats
template <int N>
__device__ __forceinline__ void vload(const float* p, float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    v[k] = t.x;
    v[k + 1] = t.y;
    v[k + 2] = t.z;
    v[k + 3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void vstore(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

template <int N>
__device__ __forceinline__ void vstore(__nv_bfloat16* p, const float* v) {
  static_assert(N == 4 || N == 8, "a bf16 vector is 8 or 16 bytes");
  __nv_bfloat162 h[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// the N floats of w, b or a column sum from column c0 (zeros past the
// width); `vec`: whole vectors, which the width then holds
template <int N>
__device__ __forceinline__ void load_part(const float* p, int c0, int width,
                                          bool vec, float* v) {
  if (vec && c0 < width) {
    vload<N>(p + c0, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = c0 + e < width ? p[c0 + e] : 0.f;
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_part(T* row, int c0, int width,
                                           bool vec, const float* v) {
  if (vec && c0 < width) {
    vstore<N>(row + c0, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (c0 + e < width) row[c0 + e] = from_f<T>(v[e]);
  }
}

// N elements of T held as they lie in memory (bf16 two to a register)
template <typename T, int N>
struct Raw {
  uint32_t u[N * sizeof(T) / 4];
};

// the N elements of a row from column c0 into `r` (zeros past the width or
// for a row past the last); `vec`: whole vectors, which the width then holds
template <int N, typename T>
__device__ __forceinline__ void load_raw(const T* row, int c0, int width,
                                         bool vec, bool live, Raw<T, N>& r) {
  constexpr int kWords = N * sizeof(T) / 4;
  if (live && vec && c0 < width) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kWords; k += 4) {
        const uint4 t = reinterpret_cast<const uint4*>(row + c0)[k / 4];
        r.u[k] = t.x;
        r.u[k + 1] = t.y;
        r.u[k + 2] = t.z;
        r.u[k + 3] = t.w;
      }
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(row + c0);
      r.u[0] = t.x;
      r.u[1] = t.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.u[k] = 0u;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (!live || c0 + e >= width) continue;
    if constexpr (sizeof(T) == 4) {
      r.u[e] = __float_as_uint(row[c0 + e]);
    } else {
      const uint32_t bits = __bfloat16_as_ushort(row[c0 + e]);
      r.u[e / 2] |= bits << (16 * (e % 2));
    }
  }
}

template <int N>
__device__ __forceinline__ void to_floats(const Raw<float, N>& r, float* v) {
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = __uint_as_float(r.u[e]);
}

// a bf16 is the high half of the fp32 of the same value
template <int N>
__device__ __forceinline__ void to_floats(const Raw<__nv_bfloat16, N>& r,
                                          float* v) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    v[2 * k] = __uint_as_float(r.u[k] << 16);
    v[2 * k + 1] = __uint_as_float(r.u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the sums a and b of a row over its group's lanes: the warp's, then the
// group's warps in order through `slot` (a float2 a warp of the block),
// behind a barrier of the group's warps alone (named barrier 1 + group),
// so that one group's row never waits for another's
template <int kGroup>
__device__ __forceinline__ void row_sums(float& a, float& b,
                                         float2* slot) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (kGroup > 1) {
    const int warp = threadIdx.x / 32;
    const int id = 1 + warp / kGroup;
    const int first = warp / kGroup * kGroup;
    // the slots' last readers are done
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kGroup * 32) : "memory");
    if (threadIdx.x % 32 == 0) slot[warp] = make_float2(a, b);
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kGroup * 32) : "memory");
    a = slot[first].x;
    b = slot[first].y;
#pragma unroll
    for (int k = 1; k < kGroup; ++k) {
      a = __fadd_rn(a, slot[first + k].x);
      b = __fadd_rn(b, slot[first + k].y);
    }
  }
}

// ---- forward: y = (x - mu) * (rstd * w) + b -> T; mu and rstd (negated
// where the clamp acted) saved when `mu_out` is given.  Block b takes rows
// [b G, b G + G), one a group

template <typename T, int kIters, int kGroup>
__global__ void __launch_bounds__(kWarps * 32, 3)
    layernorm_fwd_kernel(const T* __restrict__ x, long long ldx,
                         const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         long long ldy, float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, int rows, int width,
                         int fast, float eps, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGroups = kWarps / kGroup;
  __shared__ float2 slot[kWarps];
  const int warp = threadIdx.x / 32;
  const int gl = warp % kGroup * 32 + threadIdx.x % 32;  // lane in group
  const int row = blockIdx.x * kGroups + warp / kGroup;
  const bool live = row < rows;
  const T* xr = x + static_cast<long long>(row) * ldx;
  Raw<T, kVec> raw[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i)
    load_raw<kVec>(xr, (i * 32 * kGroup + gl) * kVec, width, vec, live,
                   raw[i]);
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    float v[kVec];
    to_floats(raw[i], v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s = __fadd_rn(s, v[e]);
      if (fast) s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
    }
  }
  row_sums<kGroup>(s, s2, slot);
  const float n = static_cast<float>(width);
  const float mu = __fdiv_rn(s, n);
  float var;
  bool clamped = false;
  if (fast) {
    var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mu, mu));
    clamped = var < 0.f;
    if (clamped) var = 0.f;
  } else {
    s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c0 = (i * 32 * kGroup + gl) * kVec;
      float v[kVec];
      to_floats(raw[i], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (c0 + e < width) {
          const float d = __fsub_rn(v[e], mu);
          s2 = __fadd_rn(s2, __fmul_rn(d, d));
        }
      }
    }
    float unused = 0.f;
    row_sums<kGroup>(s2, unused, slot);
    var = __fdiv_rn(s2, n);
  }
  const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c0 = (i * 32 * kGroup + gl) * kVec;
    if (c0 >= width) continue;
    float wv[kVec], bv[kVec], v[kVec], out[kVec];
    load_part<kVec>(w, c0, width, vec, wv);
    load_part<kVec>(b, c0, width, vec, bv);
    to_floats(raw[i], v);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      out[e] = __fadd_rn(
          __fmul_rn(__fsub_rn(v[e], mu), __fmul_rn(rstd, wv[e])), bv[e]);
    store_part<kVec>(y + static_cast<long long>(row) * ldy, c0, width, vec,
                     out);
  }
  if (mu_out == nullptr || gl != 0) return;
  mu_out[row] = mu;
  rstd_out[row] = clamped ? -rstd : rstd;
}

// ---- backward: with g = dy * w and xhat = (x - mu) * rstd,
// dx = rstd * ((g - mean(g)) - xhat * mean(g * xhat)) -> T (the variance
// term dropped where the forward clamped), and, when `part` is given, the
// block's partial column sums of dy * xhat (dw) and dy (db):
// part[block][0 | 1][width].  Group g of block b takes the rows
// 64 b + k * G + g in order of k, and adds their terms, in row order, to
// its own [2][width] of shared memory; the groups are then joined in a
// tree.  x and dy are held as loaded and widened at
// each use (xhat and g computed twice).  One row at a time: two bf16 rows
// (measured) left the backward slower, their registers costing it blocks.

template <typename T, int kIters, int kGroup>
__global__ void __launch_bounds__(kWarps * 32, 2)
    layernorm_bwd_kernel(const T* __restrict__ x, long long ldx,
                         const T* __restrict__ dy, long long lddy,
                         const float* __restrict__ mu_in,
                         const float* __restrict__ rstd_in,
                         const float* __restrict__ w, T* __restrict__ dx,
                         long long lddx, float* __restrict__ part, int rows,
                         int width, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGroups = kWarps / kGroup;
  __shared__ float2 slot[kWarps];
  extern __shared__ float4 sums4[];  // [kGroups][2][width]
  float* sums = reinterpret_cast<float*>(sums4);
  const int warp = threadIdx.x / 32;
  const int group = warp / kGroup;
  const int gl = warp % kGroup * 32 + threadIdx.x % 32;
  const float n = static_cast<float>(width);
  float* mine = sums + static_cast<long long>(group) * 2 * width;
  if (part != nullptr) {
    for (int j = threadIdx.x; j < kGroups * 2 * width; j += kWarps * 32)
      sums[j] = 0.f;
    __syncthreads();
  }
  for (int k = 0; k < kRowsPerBlock / kGroups; ++k) {
    const int row = blockIdx.x * kRowsPerBlock + k * kGroups + group;
    const bool live = row < rows;
    const float mu = live ? mu_in[row] : 0.f;
    const float rs = live ? rstd_in[row] : 0.f;
    const float rstd = fabsf(rs);
    const T* xr = x + static_cast<long long>(row) * ldx;
    const T* dyr = dy + static_cast<long long>(row) * lddy;
    Raw<T, kVec> xraw[kIters];
    Raw<T, kVec> draw[kIters];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c0 = (i * 32 * kGroup + gl) * kVec;
      load_raw<kVec>(xr, c0, width, vec, live, xraw[i]);
      load_raw<kVec>(dyr, c0, width, vec, live, draw[i]);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c0 = (i * 32 * kGroup + gl) * kVec;
      float xv[kVec], dv[kVec], wv[kVec];
      to_floats(xraw[i], xv);
      to_floats(draw[i], dv);
      load_part<kVec>(w, c0, width, vec, wv);
      const bool sum_cols = part != nullptr && live && c0 < width;
      float pw[kVec], pb[kVec];
      if (sum_cols) {
        load_part<kVec>(mine, c0, width, vec, pw);
        load_part<kVec>(mine + width, c0, width, vec, pb);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], mu), rstd);
        const float g = __fmul_rn(dv[e], wv[e]);
        s1 = __fadd_rn(s1, g);
        s2 = __fadd_rn(s2, __fmul_rn(g, xh));
        if (sum_cols) {
          pw[e] = __fadd_rn(pw[e], __fmul_rn(dv[e], xh));
          pb[e] = __fadd_rn(pb[e], dv[e]);
        }
      }
      if (sum_cols) {
        store_part<kVec>(mine, c0, width, vec, pw);
        store_part<kVec>(mine + width, c0, width, vec, pb);
      }
    }
    row_sums<kGroup>(s1, s2, slot);
    if (dx == nullptr || !live) continue;
    const float m1 = __fdiv_rn(s1, n);
    const float m2 = rs > 0.f ? __fdiv_rn(s2, n) : 0.f;
    T* dxr = dx + static_cast<long long>(row) * lddx;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c0 = (i * 32 * kGroup + gl) * kVec;
      if (c0 >= width) continue;
      float xv[kVec], dv[kVec], wv[kVec], out[kVec];
      to_floats(xraw[i], xv);
      to_floats(draw[i], dv);
      load_part<kVec>(w, c0, width, vec, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], mu), rstd);
        const float g = __fmul_rn(dv[e], wv[e]);
        out[e] = __fmul_rn(rstd,
                           __fsub_rn(__fsub_rn(g, m1), __fmul_rn(xh, m2)));
      }
      store_part<kVec>(dxr, c0, width, vec, out);
    }
  }
  if (part == nullptr) return;
  // join the groups' sums: group g adds group g + half, half = G/2 .. 1
#pragma unroll
  for (int half = kGroups / 2; half >= 1; half /= 2) {
    __syncthreads();
    for (int j = threadIdx.x; j < half * 2 * width; j += kWarps * 32)
      sums[j] = __fadd_rn(sums[j], sums[half * 2 * width + j]);
  }
  __syncthreads();
  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * width;
  for (int j = threadIdx.x; j < 2 * width; j += kWarps * 32) pr[j] = sums[j];
}

// out[j] = the sum over the partial rows p of part[p][j], j < 2 * width
// (dw then db): warp k of a block adds its contiguous chunk of partial rows
// in order, then the chunks are added in order; a lane owns a column
__global__ void __launch_bounds__(kJoinWarps * 32)
    layernorm_join_kernel(const float* __restrict__ part, int parts,
                          int width, float* __restrict__ dw,
                          float* __restrict__ db) {
  __shared__ float red[kJoinWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane;
  const int cols = 2 * width;
  const int chunk = (parts + kJoinWarps - 1) / kJoinWarps;
  const int p0 = warp * chunk;
  const int p1 = min(parts, p0 + chunk);
  float s = 0.f;
  if (j < cols)
    for (int p = p0; p < p1; ++p)
      s = __fadd_rn(s, part[static_cast<long long>(p) * cols + j]);
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || j >= cols) return;
  float t = red[0][lane];
#pragma unroll
  for (int k = 1; k < kJoinWarps; ++k) t = __fadd_rn(t, red[k][lane]);
  if (j < width)
    dw[j] = t;
  else
    db[j - width] = t;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kGroup and kIters for a row of `width` elements of T: one warp, else 2,
// 4 or 8 warps; one or two warps with as few vectors a lane as hold the
// row, more with full lanes; group 0: too wide
template <typename T>
inline void plan(int width, int& group, int& iters) {
  constexpr int kMaxIters = kMaxPerLane / (16 / sizeof(T));
  const int nvec = (width + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  group = 1;
  while (group <= kMaxGroup && group * 32 * kMaxIters < nvec) group *= 2;
  if (group > kMaxGroup) group = 0;
  iters = group <= 2 ? (nvec + 32 * group - 1) / (32 * group) : kMaxIters;
}

// the instantiation for (group, iters) of the launcher L<T, iters,
// group>::run
template <template <typename, int, int> class L, typename T, int kGroup,
          int kIters, int kMaxIters, typename... A>
cudaError_t by_iters(int iters, A... a) {
  if constexpr (kIters > kMaxIters) {
    return cudaErrorInvalidValue;
  } else {
    if (iters == kIters) return L<T, kIters, kGroup>::run(a...);
    return by_iters<L, T, kGroup, kIters + 1, kMaxIters>(iters, a...);
  }
}

template <template <typename, int, int> class L, typename T, typename... A>
cudaError_t dispatch(int width, A... a) {
  constexpr int kMaxIters = kMaxPerLane / (16 / sizeof(T));
  int group, iters;
  plan<T>(width, group, iters);
  switch (group) {
    case 1: return by_iters<L, T, 1, 1, kMaxIters>(iters, a...);
    case 2: return by_iters<L, T, 2, 1, kMaxIters>(iters, a...);
    case 4: return L<T, kMaxIters, 4>::run(a...);
    case 8: return L<T, kMaxIters, 8>::run(a...);
    default: return cudaErrorInvalidValue;
  }
}

// the backward's shared memory for its groups' column sums at the widest
// row a group takes: kWarps / kGroup groups of 2 x (kGroup * 32 *
// kMaxPerLane) floats, 64 KB whatever kGroup
constexpr int kMaxSums = sizeof(float) * kWarps * 2 * 32 * kMaxPerLane;

template <typename T, int kIters, int kGroup>
struct FwdLaunch {
  static cudaError_t run(const void* x, long long ldx, const float* w,
                         const float* b, void* y, long long ldy, float* mu,
                         float* rstd, int rows, int width, int fast,
                         float eps, int vec, cudaStream_t stream) {
    constexpr int kBlockRows = kWarps / kGroup;
    layernorm_fwd_kernel<T, kIters, kGroup>
        <<<(rows + kBlockRows - 1) / kBlockRows, kWarps * 32, 0, stream>>>(
            static_cast<const T*>(x), ldx, w, b, static_cast<T*>(y), ldy,
            mu, rstd, rows, width, fast, eps, vec);
    return cudaGetLastError();
  }
};

template <typename T, int kIters, int kGroup>
struct BwdLaunch {
  static cudaError_t run(const void* x, long long ldx, const void* dy,
                         long long lddy, const float* mu, const float* rstd,
                         const float* w, void* dx, long long lddx,
                         float* part, int rows, int width, int vec,
                         cudaStream_t stream) {
    constexpr int kGroups = kWarps / kGroup;
    const size_t smem = part == nullptr ? 0
                                        : sizeof(float) * kGroups * 2 *
                                              static_cast<size_t>(width);
    // past 48 KB of sums (one warp a row wider than 768) the kernel asks
    // for more
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          layernorm_bwd_kernel<T, kIters, kGroup>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSums);
      if (err != cudaSuccess) return err;
    }
    layernorm_bwd_kernel<T, kIters, kGroup>
        <<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kWarps * 32, smem,
           stream>>>(static_cast<const T*>(x), ldx,
                     static_cast<const T*>(dy), lddy, mu, rstd, w,
                     static_cast<T*>(dx), lddx, part, rows, width, vec);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t fwd_typed(const void* x, long long ldx, const float* w,
                      const float* b, void* y, long long ldy, float* mu,
                      float* rstd, int rows, int width, int fast, float eps,
                      cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = width % kVec == 0 && aligned16(x) && aligned16(y) &&
                  aligned16(w) && aligned16(b) &&
                  ldx * sizeof(T) % 16 == 0 && ldy * sizeof(T) % 16 == 0;
  return dispatch<FwdLaunch, T>(width, x, ldx, w, b, y, ldy, mu, rstd, rows,
                                width, fast, eps, vec, stream);
}

template <typename T>
cudaError_t bwd_typed(const void* x, long long ldx, const void* dy,
                      long long lddy, const float* mu, const float* rstd,
                      const float* w, void* dx, long long lddx, float* part,
                      float* dw, float* db, int rows, int width,
                      cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = width % kVec == 0 && aligned16(x) && aligned16(dy) &&
                  aligned16(w) && (dx == nullptr || aligned16(dx)) &&
                  (part == nullptr || aligned16(part)) &&
                  ldx * sizeof(T) % 16 == 0 && lddy * sizeof(T) % 16 == 0 &&
                  lddx * sizeof(T) % 16 == 0;
  cudaError_t err = dispatch<BwdLaunch, T>(width, x, ldx, dy, lddy, mu, rstd,
                                           w, dx, lddx, part, rows, width,
                                           vec, stream);
  if (err != cudaSuccess || part == nullptr) return err;
  layernorm_join_kernel<<<(2 * width + 31) / 32, kJoinWarps * 32, 0,
                          stream>>>(
      part, (rows + kRowsPerBlock - 1) / kRowsPerBlock, width, dw, db);
  return cudaGetLastError();
}
}  // namespace lnk
}  // namespace

// C entry points, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16,
// of x, y, dy and dx alike.  Row strides are in elements; a row's elements
// are contiguous.  Returns the cudaError_t of the launches (0 on success).

// y[T, W] from x[T, W], w and b fp32 [W]; mu and rstd fp32 [T], written
// when not null.
extern "C" int swat_ln_fwd(const void* x, long long ldx, int dtype,
                           const float* w, const float* b, void* y,
                           long long ldy, float* mu, float* rstd, int rows,
                           int width, int fast, float eps, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = lnk::fwd_typed<float>(x, ldx, w, b, y, ldy, mu, rstd, rows, width,
                                fast, eps, s);
  else if (dtype == 1)
    err = lnk::fwd_typed<__nv_bfloat16>(x, ldx, w, b, y, ldy, mu, rstd, rows,
                                        width, fast, eps, s);
  return static_cast<int>(err);
}

// dx[T, W] (skipped when null) from x, dy and the forward's mu and rstd;
// dw and db fp32 [W] through `part` (ceil(T / 64) x 2 x W floats of
// scratch) when `part` is not null.
extern "C" int swat_ln_bwd(const void* x, long long ldx, int dtype,
                           const void* dy, long long lddy, const float* mu,
                           const float* rstd, const float* w, void* dx,
                           long long lddx, float* part, float* dw, float* db,
                           int rows, int width, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = lnk::bwd_typed<float>(x, ldx, dy, lddy, mu, rstd, w, dx, lddx,
                                part, dw, db, rows, width, s);
  else if (dtype == 1)
    err = lnk::bwd_typed<__nv_bfloat16>(x, ldx, dy, lddy, mu, rstd, w, dx,
                                        lddx, part, dw, db, rows, width, s);
  return static_cast<int>(err);
}
