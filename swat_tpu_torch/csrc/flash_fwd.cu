// Heads-first attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/flash_attention.py
// ::_fwd_kernel (launched by the pallas_call in _attention_fwd, reached
// through flash_attention / kernels.attention.multi_head_attention with
// use_pallas=True, the Flax towers' attention).  Same function: q, k, v as
// [B, H, S, D]; per (batch, head) the operands are taken to fp32,
// s = q.k^T * scale, keys at col >= S (and col > row when causal) masked
// out, fp32 softmax, out = p.v with the fp32 p NOT rounded (the packed-head
// kernel rounds it to the input dtype first), accumulated in fp32 and
// rounded to the input dtype once.
//
// The TPU kernel pads S to 8 and zero-pads D to 128 lanes, both tile needs
// of that machine; here S and D are taken as they are, and the heads-first
// layout is a matter of strides: each tensor takes a batch, a head and a
// row stride, so a [B, H, S, D] tensor of any dimension order (a transposed
// view of the qkv projection included) is read in place.
//
// The kernel is the template of attention_fwd.cuh (what bounds it and its
// design are described there), instantiated with kRoundP = false.

#include "attention_fwd.cuh"

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements, (batch, head, row) for each tensor; the last
// dimension must be contiguous.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int swat_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int batch,
    int seq, int heads, int head_dim, int dtype, long long q_batch,
    long long q_head, long long q_row, long long k_batch, long long k_head,
    long long k_row, long long v_batch, long long v_head, long long v_row,
    long long o_batch, long long o_head, long long o_row, float scale,
    int causal, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_batch, q_row, q_head}, ks{k_batch, k_row, k_head},
      vs{v_batch, v_row, v_head}, os{o_batch, o_row, o_head};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, false>(q, k, v, o, batch, seq, heads, head_dim, qs,
                               ks, vs, os, scale, causal, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, false>(q, k, v, o, batch, seq, heads,
                                       head_dim, qs, ks, vs, os, scale,
                                       causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
