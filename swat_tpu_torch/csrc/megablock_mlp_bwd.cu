// Block-fused transformer layer, backward of the MLP half, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// swat_tpu/kernels/megablock.py::_mlp_bwd_kernel (launched by the
// pallas_call in mlp_bwd_call, the first half of the custom VJP of the
// fused block).  Same function, same rounding points (T is the compute
// dtype, every product sums in fp32): from x2 and dy it recomputes
// h2 = LN2(x2) -> T, m1 = (h2.Wfc -> T) + bfc, g = act(fp32 m1) -> T, then
//   dbp = sum dy;  dWp = g^T.dy;  dm = (dy.Wp^T) * act'(fp32 m1) in fp32;
//   dbfc = sum dm (fp32);  dm -> T;  dWfc = h2^T.dm;  dh2 = dm.Wfc^T (fp32);
//   dx2 = (dy + LN2-backward(dh2)) -> T;  dLN2 scale = sum dh2 * xhat,
//   dLN2 bias = sum dh2.
// All parameter gradients come out in fp32, summed over every token row, in
// torch's layouts (dWfc [F, D], dWp [D, F]).
//
// The TPU kernel adds each batch block's share to the gradients as its grid
// walks the batch in order.  Here each weight gradient is one product over
// all N = B*S rows, its depth cut into splits whose fp32 partials a join
// adds in order, and each vector gradient a two-step column sum in a fixed
// order: deterministic, no atomics.  The design and what bounds it are
// described in megablock.cuh and, for the five products (the tensor-core
// template), megablock_mma.cuh.  Launches, in order: LN2, the fc product
// (keeping m1 and g), sum dy (two), dWp and its split join, the dg product
// whose epilogue makes dm (rounded in place over m1) and the row blocks'
// sums of the fp32 dm, their join, dWfc and its split join, dh2, the
// LayerNorm backward, its two column sums (three): 15 (13 where the depth
// takes one split).
// Scratch (allocated by the caller): h2 [N, D], m1 [N, F], g [N, F] of T;
// dh2 [N, D], row stats [N, 2], `parts` column-sum partials and `split`
// partials of the weight gradients (none: one split) in fp32.

#include "megablock.cuh"
#include "megablock_mma.cuh"

#include <algorithm>

namespace {

enum Weight { kFcW, kFcB, kProjW, kLn2W, kLn2B, kNumWeights };
enum Grad { kDFcW, kDFcB, kDProjW, kDProjB, kDLn2W, kDLn2B, kNumGrads };

template <typename T>
cudaError_t mega_mlp_bwd(const void* x2_, const void* dy_,
                         const void* const* w_, void* dx2_,
                         float* const* grads, void* const* scratch,
                         long long split_floats, int n, int d, int f,
                         bool quick_gelu, cudaStream_t stream) {
  using namespace mega;
  const T* x2 = static_cast<const T*>(x2_);
  const T* dy = static_cast<const T*>(dy_);
  const T* w[kNumWeights];
  for (int i = 0; i < kNumWeights; ++i) w[i] = static_cast<const T*>(w_[i]);
  T* dx2 = static_cast<T*>(dx2_);
  T* h2 = static_cast<T*>(scratch[0]);
  T* m1 = static_cast<T*>(scratch[1]);
  T* g = static_cast<T*>(scratch[2]);
  float* dh2 = static_cast<float*>(scratch[3]);
  float2* stats = static_cast<float2*>(scratch[4]);
  float* parts = static_cast<float*>(scratch[5]);
  float* split = split_floats > 0 ? static_cast<float*>(scratch[6]) : nullptr;
  cudaError_t err;

  err = ln_fwd<T>(x2, w[kLn2W], w[kLn2B], h2, n, d, stream);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, true>(h2, d, w[kFcW], d, n, f, d,
                                EpiBiasAct<T>{m1, g, f, w[kFcB], quick_gelu},
                                stream);
  if (err != cudaSuccess) return err;
  err = colsum(ColOf<T>{dy, d}, n, d, parts, grads[kDProjB], nullptr, stream);
  if (err != cudaSuccess) return err;
  // dWp[c, j] = sum_rows dy[row, c] * g[row, j]
  err = tc::gemm_wgrad<T>(dy, d, g, f, d, f, n, grads[kDProjW], split,
                          split_floats, stream);
  if (err != cudaSuccess) return err;
  // dg[row, j] = sum_c dy[row, c] * Wp[c, j]; dm replaces m1
  err = tc::gemm<T, true, false>(dy, d, w[kProjW], f, n, f, d,
                                 EpiDm<T>{m1, f, quick_gelu, parts}, stream);
  if (err != cudaSuccess) return err;
  err = colsum_join(parts, n, f, grads[kDFcB], stream);
  if (err != cudaSuccess) return err;
  const T* dm = m1;
  // dWfc[j, c] = sum_rows dm[row, j] * h2[row, c]
  err = tc::gemm_wgrad<T>(dm, f, h2, d, f, d, n, grads[kDFcW], split,
                          split_floats, stream);
  if (err != cudaSuccess) return err;
  // dh2[row, c] = sum_j dm[row, j] * Wfc[j, c]
  err = tc::gemm<T, true, false>(dm, f, w[kFcW], d, n, d, f,
                                 EpiF32{dh2, d}, stream);
  if (err != cudaSuccess) return err;
  err = ln_bwd<T>(x2, dh2, w[kLn2W], dy, dx2, stats, n, d, stream);
  if (err != cudaSuccess) return err;
  return colsum(ColLn<T>{x2, dh2, stats, d}, n, d, parts, grads[kDLn2W],
                grads[kDLn2B], stream);
}

}  // namespace

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// x2, dy, dx2: [rows, width], contiguous.  w: the 5 weight pointers in the
// order of `Weight`; grads: the 6 fp32 outputs in the order of `Grad`;
// scratch: the 7 pointers named above; parts_floats and split_floats: the
// capacities of the last two (split_floats 0: the weight gradients take one
// split).  Returns the cudaError_t of the launches (0 on success).
extern "C" int swat_mega_mlp_bwd(const void* x2, const void* dy,
                                 const void* const* w, void* dx2,
                                 float* const* grads, void* const* scratch,
                                 long long parts_floats,
                                 long long split_floats, int rows, int width,
                                 int mlp, int dtype, int quick_gelu,
                                 void* stream) {
  if (rows <= 0 || width <= 0 || mlp <= 0 || split_floats < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = static_cast<long long>(mega::row_blocks(rows)) *
                         (mlp > 2 * width ? mlp : 2 * width);
  if (parts_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  // dWp [width, mlp] and dWfc [mlp, width], both over `rows`
  const long long split_need =
      dtype == 0
          ? std::max(mega::tc::split_floats<float>(width, mlp, rows),
                     mega::tc::split_floats<float>(mlp, width, rows))
          : std::max(mega::tc::split_floats<__nv_bfloat16>(width, mlp, rows),
                     mega::tc::split_floats<__nv_bfloat16>(mlp, width, rows));
  if (split_floats > 0 && split_floats < split_need)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = mega_mlp_bwd<float>(x2, dy, w, dx2, grads, scratch, split_floats,
                              rows, width, mlp, quick_gelu != 0, s);
  else if (dtype == 1)
    err = mega_mlp_bwd<__nv_bfloat16>(x2, dy, w, dx2, grads, scratch,
                                      split_floats, rows, width, mlp,
                                      quick_gelu != 0, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
