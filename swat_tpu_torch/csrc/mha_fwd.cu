// Packed-head multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/flash_attention.py
// ::_mha_fwd_kernel (launched by the pallas_call in _mha_fwd, reached
// through mha_packed).  Same function: q, k, v in the packed [B, S, H*D]
// layout of the qkv projection (head h at column h*D); per head
// s = q.k^T * scale in fp32, keys at col >= S (and col > row when causal)
// masked out, fp32 softmax, p ROUNDED to the input dtype, out = p.v
// accumulated in fp32 and rounded to the input dtype once.
//
// The kernel is the template of attention_fwd.cuh (what bounds it and its
// design are described there), instantiated with kRoundP = true and a head
// stride of D.

#include "attention_fwd.cuh"

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; the last dimension must be contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int swat_mha_fwd(const void* q, const void* k, const void* v,
                            void* o, int batch, int seq, int heads,
                            int head_dim, int dtype, long long q_batch,
                            long long q_row, long long k_batch,
                            long long k_row, long long v_batch,
                            long long v_row, long long o_batch,
                            long long o_row, float scale, int causal,
                            void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_batch, q_row, head_dim}, ks{k_batch, k_row, head_dim},
      vs{v_batch, v_row, head_dim}, os{o_batch, o_row, head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, true>(q, k, v, o, batch, seq, heads, head_dim, qs,
                              ks, vs, os, scale, causal, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(q, k, v, o, batch, seq, heads,
                                      head_dim, qs, ks, vs, os, scale,
                                      causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* swat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
