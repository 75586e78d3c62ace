// Device code shared by the three block-fused transformer-layer entry
// points (megablock_fwd.cu, megablock_mlp_bwd.cu, megablock_attn_bwd.cu):
// the epilogues of the layer's matrix products, the fp32 LayerNorm forward
// and backward, and deterministic column sums.  This header holds no entry
// point.
//
// The TPU kernels (swat_tpu/kernels/megablock.py) keep a layer's weights
// and a block of images' activations in VMEM and walk the batch in order,
// carrying the weight-gradient sums from one grid step to the next.
// Neither carries over to this card: one ViT-B/32 layer has 7.1 M weights
// (28 MB in fp32) against 227 KB of shared memory a block, and blocks run
// in no order.  So each entry point runs a fixed sequence of the kernels
// below over all B*S token rows at once; what the TPU kernel kept on chip
// between its products (the LayerNorm output, q/k/v, the MLP hidden, ...)
// goes through scratch tensors that the Python wrapper allocates, and every
// weight gradient is one product over all token rows (its depth cut into
// splits whose partials are joined in order: deterministic, no atomics).
// The rounding points are the TPU kernels': every epilogue says where it
// rounds to the compute dtype T.
//
// What bounds it on the card: operations.  A ViT-B/32 layer at batch 256
// is 0.18 / 0.30 / 0.17 TFLOP (forward / MLP backward / attention backward)
// against ~0.15 GB of inputs and outputs.  So every product of the three
// entry points goes to the tensor-core template of megablock_mma.cuh, with
// the epilogues below (whose `pair` stores two columns at once); their
// weight gradients cut the depth into splits that one join adds in order.
// The fusion that takes the scratch away comes later.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace mega {

constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernels' casts to the compute dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// ---- activations (megablock.py::_act, _act_grad32), in fp32, by the
// special-function unit (__expf, __fdividef: a few ulps of fp32, far below
// the bf16 rounding that follows; an epilogue of the tensor-core product
// takes one for every output, so its cost shows there)

// Abramowitz-Stegun 7.1.26, the TPU kernels' erf
__device__ __forceinline__ float erf_as(float x) {
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * __expf(-ax * ax));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float act(float m, bool quick_gelu) {
  if (quick_gelu) return m * sigmoid(1.702f * m);
  return 0.5f * m * (1.f + erf_as(m * 0.7071067811865476f));
}

__device__ __forceinline__ float act_grad(float m, bool quick_gelu) {
  if (quick_gelu) {
    const float s = sigmoid(1.702f * m);
    return s * (1.f + 1.702f * m * (1.f - s));
  }
  const float phi = __expf(-0.5f * m * m) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erf_as(m * 0.7071067811865476f));
  return cdf + m * phi;
}

// ---- the epilogues of the tensor-core product (megablock_mma.cuh)

// two adjacent elements of a row as one access (p aligned to it)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Epi: what happens to each fp32 sum.  operator()(row, col, sum) stores and
// returns the value whose column sums the block adds up when kColSum (into
// partial[blockIdx.y][col]; a later kernel joins the row blocks in order);
// pair(row, col, s0, s1) does the same for columns col and col + 1.

// (sum -> T) + bias in T: q, k, v
template <typename T>
struct EpiBias {
  static constexpr bool kColSum = false;
  T* c;
  long long ldc;
  const T* bias;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    c[r * ldc + n] = from_float<T>(round_to<T>(s) + to_float(bias[n]));
    return 0.f;
  }
  // columns n and n + 1 of row r, the same arithmetic (r * ldc + n even)
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    store2(c + r * ldc + n, round_to<T>(s0) + to_float(bias[n]),
           round_to<T>(s1) + to_float(bias[n + 1]));
    return make_float2(0.f, 0.f);
  }
};

// res + ((sum -> T) + bias), each step in T: x2 from the out-projection,
// y from the MLP projection
template <typename T>
struct EpiBiasRes {
  static constexpr bool kColSum = false;
  T* c;
  long long ldc;
  const T* bias;
  const T* res;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    const float t = round_to<T>(round_to<T>(s) + to_float(bias[n]));
    c[r * ldc + n] = from_float<T>(to_float(res[r * ldc + n]) + t);
    return 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    const float t0 = round_to<T>(round_to<T>(s0) + to_float(bias[n]));
    const float t1 = round_to<T>(round_to<T>(s1) + to_float(bias[n + 1]));
    const T* rr = res + r * ldc + n;
    store2(c + r * ldc + n, to_float(rr[0]) + t0, to_float(rr[1]) + t1);
    return make_float2(0.f, 0.f);
  }
};

// m1 = (sum -> T) + bias in T (kept when m1 is given), g = act(fp32 m1) -> T
template <typename T>
struct EpiBiasAct {
  static constexpr bool kColSum = false;
  T* m1;
  T* g;
  long long ldc;
  const T* bias;
  bool quick_gelu;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    const float m = round_to<T>(round_to<T>(s) + to_float(bias[n]));
    if (m1 != nullptr) m1[r * ldc + n] = from_float<T>(m);
    g[r * ldc + n] = from_float<T>(act(m, quick_gelu));
    return 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    const float a = round_to<T>(round_to<T>(s0) + to_float(bias[n]));
    const float b = round_to<T>(round_to<T>(s1) + to_float(bias[n + 1]));
    if (m1 != nullptr) store2(m1 + r * ldc + n, a, b);
    store2(g + r * ldc + n, act(a, quick_gelu), act(b, quick_gelu));
    return make_float2(0.f, 0.f);
  }
};

// dm = sum * act'(fp32 m1), stored rounded to T over m1 itself; the fp32 dm
// is what the fc bias gradient sums
template <typename T>
struct EpiDm {
  static constexpr bool kColSum = true;
  T* m1_dm;
  long long ldc;
  bool quick_gelu;
  float* partial;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    const float dm = s * act_grad(to_float(m1_dm[r * ldc + n]), quick_gelu);
    m1_dm[r * ldc + n] = from_float<T>(dm);
    return dm;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    const float2 m = load2(m1_dm + r * ldc + n);
    const float2 dm = make_float2(s0 * act_grad(m.x, quick_gelu),
                                  s1 * act_grad(m.y, quick_gelu));
    store2(m1_dm + r * ldc + n, dm.x, dm.y);
    return dm;
  }
};

// the fp32 sum as it stands: weight gradients, dh1, dh2
struct EpiF32 {
  static constexpr bool kColSum = false;
  float* c;
  long long ldc;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    c[r * ldc + n] = s;
    return 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    store2(c + r * ldc + n, s0, s1);
    return make_float2(0.f, 0.f);
  }
};

// sum -> T: do
template <typename T>
struct EpiRound {
  static constexpr bool kColSum = false;
  T* c;
  long long ldc;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    c[r * ldc + n] = from_float<T>(s);
    return 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    store2(c + r * ldc + n, s0, s1);
    return make_float2(0.f, 0.f);
  }
};

// ---- LayerNorm over rows of `d` elements, one warp a row, always in the
// fast-variance form max(0, E[x^2] - E[x]^2) of the TPU kernels

constexpr int kRowWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int d,
                                          float& mu, float& rstd) {
  float s = 0.f, s2 = 0.f;
  for (int c = threadIdx.x % 32; c < d; c += 32) {
    const float v = to_float(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / d;
  const float var = fmaxf(0.f, s2 / d - mu * mu);
  rstd = rsqrtf(var + kLnEps);
}

// out = (xhat * scale + bias) -> T; scale and bias are T values (the TPU
// kernels cast the LayerNorm parameters to the compute dtype first)
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ out, int rows,
                  int d) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<long long>(row) * d;
  T* outr = out + static_cast<long long>(row) * d;
  float mu, rstd;
  row_stats(xr, d, mu, rstd);
  for (int c = threadIdx.x % 32; c < d; c += 32) {
    const float xhat = (to_float(xr[c]) - mu) * rstd;
    outr[c] = from_float<T>(xhat * to_float(scale[c]) + to_float(bias[c]));
  }
}

// out = (res + dx) -> T with dx the LayerNorm input gradient of the fp32
// `dh`; the row's mu and rstd are kept for the column sums
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dh,
                  const T* __restrict__ scale, const T* __restrict__ res,
                  T* __restrict__ out, float2* __restrict__ stats, int rows,
                  int d) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const long long at = static_cast<long long>(row) * d;
  float mu, rstd;
  row_stats(x + at, d, mu, rstd);
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x % 32; c < d; c += 32) {
    const float xhat = (to_float(x[at + c]) - mu) * rstd;
    const float dyh = dh[at + c] * to_float(scale[c]);
    s1 += dyh;
    s2 += dyh * xhat;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float n = static_cast<float>(d);
  for (int c = threadIdx.x % 32; c < d; c += 32) {
    const float xhat = (to_float(x[at + c]) - mu) * rstd;
    const float dyh = dh[at + c] * to_float(scale[c]);
    const float dx = (rstd / n) * (n * dyh - s1 - xhat * s2);
    out[at + c] = from_float<T>(to_float(res[at + c]) + dx);
  }
  if (threadIdx.x % 32 == 0) stats[row] = make_float2(mu, rstd);
}

template <typename T>
cudaError_t ln_fwd(const T* x, const T* scale, const T* bias, T* out,
                   int rows, int d, cudaStream_t stream) {
  ln_fwd_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0,
                     stream>>>(x, scale, bias, out, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_bwd(const T* x, const float* dh, const T* scale, const T* res,
                   T* out, float2* stats, int rows, int d,
                   cudaStream_t stream) {
  ln_bwd_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0,
                     stream>>>(x, dh, scale, res, out, stats, rows, d);
  return cudaGetLastError();
}

// ---- column sums over all rows, in two deterministic steps: each block
// sums kBM rows of its columns (one thread a column, so a row's reads
// coalesce), then one thread a column joins the row blocks in order.
// f(row, col, a, b) adds its term(s) to a (and b).

constexpr int kBM = 128;  // rows a block sums
constexpr int kColThreads = 128;

template <typename F>
__global__ void __launch_bounds__(kColThreads)
    colsum_kernel(F f, int rows, int cols, float* __restrict__ part_a,
                  float* __restrict__ part_b) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kBM;
  const int r1 = min(rows, r0 + kBM);
  float a = 0.f, b = 0.f;
  for (int r = r0; r < r1; ++r) f(r, c, a, b);
  part_a[static_cast<long long>(blockIdx.y) * cols + c] = a;
  if (part_b != nullptr)
    part_b[static_cast<long long>(blockIdx.y) * cols + c] = b;
}

__global__ void __launch_bounds__(kColThreads)
    colsum_join_kernel(const float* __restrict__ part, int parts, int cols,
                       float* __restrict__ out) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p)
    s += part[static_cast<long long>(p) * cols + c];
  out[c] = s;
}

inline int row_blocks(int rows) { return (rows + kBM - 1) / kBM; }

inline cudaError_t colsum_join(const float* part, int rows, int cols,
                               float* out, cudaStream_t stream) {
  colsum_join_kernel<<<(cols + kColThreads - 1) / kColThreads, kColThreads,
                       0, stream>>>(part, row_blocks(rows), cols, out);
  return cudaGetLastError();
}

// sum_rows f -> out_a (and out_b); `part` holds 2 * row_blocks * cols floats
template <typename F>
cudaError_t colsum(F f, int rows, int cols, float* part, float* out_a,
                   float* out_b, cudaStream_t stream) {
  const dim3 grid((cols + kColThreads - 1) / kColThreads, row_blocks(rows));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  float* part_b =
      out_b ? part + static_cast<long long>(row_blocks(rows)) * cols : nullptr;
  colsum_kernel<F><<<grid, kColThreads, 0, stream>>>(f, rows, cols, part,
                                                     part_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum_join(part, rows, cols, out_a, stream);
  if (err != cudaSuccess || out_b == nullptr) return err;
  return colsum_join(part_b, rows, cols, out_b, stream);
}

// a [rows, ld] matrix of T, widened: the bias gradients of the two
// projections that end a half block (sums of dy and of dx2)
template <typename T>
struct ColOf {
  const T* p;
  long long ld;
  __device__ __forceinline__ void operator()(int r, int c, float& a,
                                             float&) const {
    a += to_float(p[r * ld + c]);
  }
};

// the fp32 dq|dk|dv: summed as they are (the qkv bias gradient) and, when
// `out` is given, stored rounded to T for the products that follow
template <typename T>
struct ColRound {
  const float* in;
  T* out;
  long long ld;
  __device__ __forceinline__ void operator()(int r, int c, float& a,
                                             float&) const {
    const float v = in[r * ld + c];
    if (out != nullptr) out[r * ld + c] = from_float<T>(v);
    a += v;
  }
};

// the LayerNorm parameter gradients: a += dh * xhat (scale), b += dh (bias)
template <typename T>
struct ColLn {
  const T* x;
  const float* dh;
  const float2* stats;
  long long ld;
  __device__ __forceinline__ void operator()(int r, int c, float& a,
                                             float& b) const {
    const float2 st = stats[r];
    const float d = dh[r * ld + c];
    a += d * ((to_float(x[r * ld + c]) - st.x) * st.y);
    b += d;
  }
};

}  // namespace mega
}  // namespace
