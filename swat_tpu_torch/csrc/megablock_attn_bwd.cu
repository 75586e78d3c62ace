// Block-fused transformer layer, backward of the attention half, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// swat_tpu/kernels/megablock.py::_attn_bwd_kernel (launched by the
// pallas_call in attn_bwd_call, the second half of the custom VJP of the
// fused block).  Same function, same rounding points (T is the compute
// dtype, every product sums in fp32): from x and dx2 it recomputes
// h1 = LN1(x) -> T, q, k, v = (h1.W -> T) + b and, per image and head, the
// fp32 p and o = (p -> T).v -> T, then
//   dbo = sum dx2;  dWo = o^T.dx2;  do = (dx2.Wo^T) -> T;
//   dv = (p -> T)^T.do;  dp = do.v^T;  delta = rowsum(p * dp), fp32 p;
//   ds = p * (dp - delta) * scale, masked, -> T;  dq = ds.k;  dk = ds^T.q;
//   db{q,k,v} = sums of the fp32 dq, dk, dv;  dq, dk, dv -> T;
//   dW{q,k,v} = h1^T.d{q,k,v};  dh1 = sum of d{q,k,v}.W^T (fp32);
//   dx = (dx2 + LN1-backward(dh1)) -> T;  dLN1 scale = sum dh1 * xhat,
//   dLN1 bias = sum dh1.
// All parameter gradients come out in fp32, summed over every token row, in
// torch's layouts (d in_proj_weight [3D, D], d out_proj.weight [D, D]).
//
// As in megablock_mlp_bwd.cu, each weight gradient is one product over all
// N = B*S rows, its depth cut into splits whose fp32 partials a join adds
// in order, and each vector gradient a two-step column sum in a fixed
// order: deterministic, no atomics.  The five products (the qkv recompute,
// dWo, do, d in_proj_weight, dh1) are the tensor-core template of
// megablock_mma.cuh; the design and what bounds it are described there and
// in megablock.cuh.  Launches, in order: LN1, sum dx2 (two), the qkv
// product, the attention forward of attention_fwd.cuh (for o), dWo and its
// split join, the do product, the attention backward of attention_bwd.cuh
// (one kernel, or two for long rows) writing dq|dk|dv in fp32, their column
// sums (which also store them rounded to T; two), d in_proj_weight and its
// split join, dh1, the LayerNorm backward, its two column sums (three): 18
// (19 for long rows; two fewer where the depth takes one split).
// Scratch (allocated by the caller): h1 [N, D], qkv [N, 3D], o [N, D] (do
// takes its place once dWo is done), dqkv [N, 3D] of T (unused in fp32: the
// products then read the fp32 dqkv32 in place); dqkv32 [N, 3D], dh1 [N, D],
// row stats [N, 2], softmax stats [3, B, H, S] (only where the rows are too
// long for one block of the attention backward), `parts` column-sum
// partials and `split` partials of the weight gradients (none: one split)
// in fp32.

#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "megablock.cuh"
#include "megablock_mma.cuh"

#include <algorithm>

namespace {

enum Weight { kInW, kInB, kOutW, kLn1W, kLn1B, kNumWeights };
enum Grad { kDInW, kDInB, kDOutW, kDOutB, kDLn1W, kDLn1B, kNumGrads };

template <typename T>
cudaError_t mega_attn_bwd(const void* x_, const void* dx2_,
                          const void* const* w_, void* dx_,
                          float* const* grads, void* const* scratch,
                          long long split_floats, int batch, int seq, int d,
                          int heads, int causal, cudaStream_t stream) {
  using namespace mega;
  const T* x = static_cast<const T*>(x_);
  const T* dx2 = static_cast<const T*>(dx2_);
  const T* w[kNumWeights];
  for (int i = 0; i < kNumWeights; ++i) w[i] = static_cast<const T*>(w_[i]);
  T* dx = static_cast<T*>(dx_);
  T* h1 = static_cast<T*>(scratch[0]);
  T* qkv = static_cast<T*>(scratch[1]);
  T* o = static_cast<T*>(scratch[2]);
  T* dqkv_t = static_cast<T*>(scratch[3]);
  float* dqkv32 = static_cast<float*>(scratch[4]);
  float* dh1 = static_cast<float*>(scratch[5]);
  float2* stats = static_cast<float2*>(scratch[6]);
  float* softmax_stats = static_cast<float*>(scratch[7]);
  float* parts = static_cast<float*>(scratch[8]);
  float* split = split_floats > 0 ? static_cast<float*>(scratch[9]) : nullptr;
  const int n = batch * seq;
  const int hd = d / heads;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  cudaError_t err;

  err = ln_fwd<T>(x, w[kLn1W], w[kLn1B], h1, n, d, stream);
  if (err != cudaSuccess) return err;
  err = colsum(ColOf<T>{dx2, d}, n, d, parts, grads[kDOutB], nullptr, stream);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, true>(h1, d, w[kInW], d, n, 3 * d, d,
                                EpiBias<T>{qkv, 3 * d, w[kInB]}, stream);
  if (err != cudaSuccess) return err;
  {
    const afwd::Strides in{static_cast<long long>(seq) * 3 * d, 3 * d, hd};
    const afwd::Strides out{static_cast<long long>(seq) * d, d, hd};
    err = afwd::launch<T, true>(qkv, qkv + d, qkv + 2 * d, o, batch, seq,
                                heads, hd, in, in, in, out, scale, causal,
                                stream);
    if (err != cudaSuccess) return err;
  }
  // dWo[c, j] = sum_rows dx2[row, c] * o[row, j]
  err = tc::gemm_wgrad<T>(dx2, d, o, d, d, d, n, grads[kDOutW], split,
                          split_floats, stream);
  if (err != cudaSuccess) return err;
  // do[row, j] = sum_c dx2[row, c] * Wo[c, j], over o's place
  T* dout = o;
  err = tc::gemm<T, true, false>(dx2, d, w[kOutW], d, n, d, d,
                                 EpiRound<T>{dout, d}, stream);
  if (err != cudaSuccess) return err;
  {
    const abwd::Strides in{static_cast<long long>(seq) * 3 * d, 3 * d, hd};
    const abwd::Strides out{static_cast<long long>(seq) * d, d, hd};
    const abwd::Args a{qkv,    qkv + d,        qkv + 2 * d,        dout,
                       dqkv32, dqkv32 + d,     dqkv32 + 2 * d,     softmax_stats,
                       batch,  seq,            heads,              in,
                       in,     in,             out,                in,
                       in,     in,             scale,              causal};
    err = abwd::launch<T, true, float>(a, hd, stream);
    if (err != cudaSuccess) return err;
  }
  // fp32: the gradients are read in place as they stand (the products split
  // them into planes on the way); else rounded to T on the way
  const T* dqkv;
  if (std::is_same<T, float>::value) {
    dqkv = reinterpret_cast<const T*>(dqkv32);
    dqkv_t = nullptr;
  } else {
    dqkv = dqkv_t;
  }
  err = colsum(ColRound<T>{dqkv32, dqkv_t, 3 * d}, n, 3 * d, parts,
               grads[kDInB], nullptr, stream);
  if (err != cudaSuccess) return err;
  // d in_proj_weight[j, c] = sum_rows dqkv[row, j] * h1[row, c]
  err = tc::gemm_wgrad<T>(dqkv, 3 * d, h1, d, 3 * d, d, n, grads[kDInW],
                          split, split_floats, stream);
  if (err != cudaSuccess) return err;
  // dh1[row, c] = sum_j dqkv[row, j] * in_proj_weight[j, c]
  err = tc::gemm<T, true, false>(dqkv, 3 * d, w[kInW], d, n, d, 3 * d,
                                 EpiF32{dh1, d}, stream);
  if (err != cudaSuccess) return err;
  err = ln_bwd<T>(x, dh1, w[kLn1W], dx2, dx, stats, n, d, stream);
  if (err != cudaSuccess) return err;
  return colsum(ColLn<T>{x, dh1, stats, d}, n, d, parts, grads[kDLn1W],
                grads[kDLn1B], stream);
}

}  // namespace

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// x, dx2, dx: [batch * seq, width], contiguous.  w: the 5 weight pointers in
// the order of `Weight`; grads: the 6 fp32 outputs in the order of `Grad`;
// scratch: the 10 pointers named above; parts_floats and split_floats: the
// capacities of the last two (split_floats 0: the weight gradients take one
// split).  Returns the cudaError_t of the launches (0 on success).
extern "C" int swat_mega_attn_bwd(const void* x, const void* dx2,
                                  const void* const* w, void* dx,
                                  float* const* grads, void* const* scratch,
                                  long long parts_floats,
                                  long long split_floats, int batch, int seq,
                                  int width, int heads, int dtype, int causal,
                                  void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || width <= 0 || width % heads ||
      batch > 65535 || heads > 65535 || split_floats < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = batch * seq;
  const long long need =
      static_cast<long long>(mega::row_blocks(n)) * 3 * width;
  if (parts_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  // dWo [width, width] and d in_proj_weight [3 width, width], over n rows
  const long long split_need =
      dtype == 0
          ? std::max(mega::tc::split_floats<float>(width, width, n),
                     mega::tc::split_floats<float>(3 * width, width, n))
          : std::max(
                mega::tc::split_floats<__nv_bfloat16>(width, width, n),
                mega::tc::split_floats<__nv_bfloat16>(3 * width, width, n));
  if (split_floats > 0 && split_floats < split_need)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = mega_attn_bwd<float>(x, dx2, w, dx, grads, scratch, split_floats,
                               batch, seq, width, heads, causal, s);
  else if (dtype == 1)
    err = mega_attn_bwd<__nv_bfloat16>(x, dx2, w, dx, grads, scratch,
                                       split_floats, batch, seq, width, heads,
                                       causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
