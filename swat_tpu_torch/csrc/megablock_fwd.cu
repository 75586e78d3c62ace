// Block-fused transformer layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/megablock.py::_fwd_kernel
// (launched by the pallas_call in fwd_call, reached through
// fused_transformer).  Same function, same rounding points (T is the
// compute dtype, every product sums in fp32):
//   h1 = LN1(x) -> T;  q, k, v = (h1.W -> T) + b in T;
//   per image and head: s = q.k^T * scale in fp32, keys past the row masked
//   when causal, fp32 softmax, (p -> T).v -> T;
//   x2 = x + ((o.Wo summed over all heads in fp32 -> T) + bo);
//   h2 = LN2(x2) -> T;  m1 = (h2.Wfc -> T) + bfc;  g = act(fp32 m1) -> T;
//   y = x2 + ((g.Wp -> T) + bp).
// It writes y and x2.  The TPU kernel attends block-diagonally over several
// images of a batch block under a same-image mask; a masked score adds
// exactly 0, so attending per image gives the same p, and S is not padded.
//
// The design and what bounds it are described in megablock.cuh; the four
// products are the tensor-core template of megablock_mma.cuh.  Seven
// launches, in order: LN1, the qkv product, the attention of
// attention_fwd.cuh (p rounded before p.v, reading q, k, v in place from
// the qkv scratch), the out-projection with its residual, LN2, the fc
// product with the activation, the MLP projection with its residual.
// Scratch (allocated by the caller, T elements): h [N, D], qkv [N, 3D],
// o [N, D], g [N, F], with N = B*S.

#include "attention_fwd.cuh"
#include "megablock.cuh"
#include "megablock_mma.cuh"

namespace {

// the layer's weights, torch layouts ([out, in] matrices), all of type T
enum Weight {
  kInW, kInB, kOutW, kOutB, kLn1W, kLn1B, kLn2W, kLn2B, kFcW, kFcB, kProjW,
  kProjB, kNumWeights
};

template <typename T>
cudaError_t mega_fwd(const void* x_, const void* const* w_, void* y_,
                     void* x2_, void* const* scratch, int batch, int seq,
                     int d, int heads, int f, int causal, bool quick_gelu,
                     cudaStream_t stream) {
  using namespace mega;
  const T* x = static_cast<const T*>(x_);
  const T* w[kNumWeights];
  for (int i = 0; i < kNumWeights; ++i) w[i] = static_cast<const T*>(w_[i]);
  T* y = static_cast<T*>(y_);
  T* x2 = static_cast<T*>(x2_);
  T* h = static_cast<T*>(scratch[0]);
  T* qkv = static_cast<T*>(scratch[1]);
  T* o = static_cast<T*>(scratch[2]);
  T* g = static_cast<T*>(scratch[3]);
  const int n = batch * seq;
  const int hd = d / heads;
  cudaError_t err;

  err = ln_fwd<T>(x, w[kLn1W], w[kLn1B], h, n, d, stream);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, true>(h, d, w[kInW], d, n, 3 * d, d,
                                EpiBias<T>{qkv, 3 * d, w[kInB]}, stream);
  if (err != cudaSuccess) return err;
  const afwd::Strides in{static_cast<long long>(seq) * 3 * d, 3 * d, hd};
  const afwd::Strides out{static_cast<long long>(seq) * d, d, hd};
  err = afwd::launch<T, true>(qkv, qkv + d, qkv + 2 * d, o, batch, seq, heads,
                              hd, in, in, in, out,
                              1.f / sqrtf(static_cast<float>(hd)), causal,
                              stream);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, true>(o, d, w[kOutW], d, n, d, d,
                                EpiBiasRes<T>{x2, d, w[kOutB], x}, stream);
  if (err != cudaSuccess) return err;
  err = ln_fwd<T>(x2, w[kLn2W], w[kLn2B], h, n, d, stream);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, true>(
      h, d, w[kFcW], d, n, f, d,
      EpiBiasAct<T>{nullptr, g, f, w[kFcB], quick_gelu}, stream);
  if (err != cudaSuccess) return err;
  return tc::gemm<T, true, true>(g, f, w[kProjW], f, n, d, f,
                                 EpiBiasRes<T>{y, d, w[kProjB], x2}, stream);
}

}  // namespace

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// x, y, x2: [batch * seq, width], contiguous.  w: the 12 weight pointers in
// the order of `Weight`.  scratch: the 4 pointers named above.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int swat_mega_fwd(const void* x, const void* const* w, void* y,
                             void* x2, void* const* scratch, int batch,
                             int seq, int width, int heads, int mlp,
                             int dtype, int causal, int quick_gelu,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || width <= 0 || mlp <= 0 ||
      width % heads || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = mega_fwd<float>(x, w, y, x2, scratch, batch, seq, width, heads,
                          mlp, causal, quick_gelu != 0, s);
  else if (dtype == 1)
    err = mega_fwd<__nv_bfloat16>(x, w, y, x2, scratch, batch, seq, width,
                                  heads, mlp, causal, quick_gelu != 0, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
