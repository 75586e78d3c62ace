// Packed-head multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/flash_attention.py
// ::_mha_bwd_kernel (launched by the pallas_call in _mha_bwd, the custom-VJP
// backward of mha_packed).  Same function, same rounding points: q, k, v, do
// in the packed [B, S, H*D] layout (head h at column h*D); pb = p rounded to
// the input dtype, used only in dv; delta from the fp32 p; ds rounded to the
// input dtype before dq and dk.  dq, dk and dv can be the three thirds of
// one [B, S, 3*H*D] gradient of the qkv projection.
//
// The kernels are the tensor-core templates of attention_bwd.cuh (what
// bounds them and their design are described there), instantiated with
// kRound = true and a head stride of D: one block a (batch, head) up to 128
// rows in bf16 and 80 in fp32 (the towers' S = 50 and 77), a pair of kernels
// that own query rows and key rows beyond.

#include "attention_bwd.cuh"

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; the last dimension must be contiguous.  `stats`
// is fp32 scratch of 3 * batch * heads * seq elements, needed (and read)
// only where the rows are too long for one block.  Launches on `stream`;
// returns the cudaError_t of the launches (0 on success).
extern "C" int swat_mha_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* stats, int batch, int seq, int heads,
    int head_dim, int dtype, long long q_batch, long long q_row,
    long long k_batch, long long k_row, long long v_batch, long long v_row,
    long long do_batch, long long do_row, long long dq_batch,
    long long dq_row, long long dk_batch, long long dk_row,
    long long dv_batch, long long dv_row, float scale, int causal,
    void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hs = head_dim;
  const Args a{q,
               k,
               v,
               dout,
               dq,
               dk,
               dv,
               stats,
               batch,
               seq,
               heads,
               {q_batch, q_row, hs},
               {k_batch, k_row, hs},
               {v_batch, v_row, hs},
               {do_batch, do_row, hs},
               {dq_batch, dq_row, hs},
               {dk_batch, dk_row, hs},
               {dv_batch, dv_row, hs},
               scale,
               causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, true>(a, head_dim, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(a, head_dim, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
