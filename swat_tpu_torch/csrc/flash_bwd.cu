// Heads-first attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/flash_attention.py
// ::_bwd_kernel in both of its forms:
//   keep_dtype = 0 (the pallas_call in _attention_bwd, the gradient of
//     flash_attention): the operands are taken to fp32 and neither pb nor ds
//     is rounded; only dq, dk, dv are rounded, once, to the input dtype;
//   keep_dtype = 1 (the pallas_call in _mha_fast_bwd, the backward of
//     mha_packed(bwd="fused") below fp32): the matrix unit is fed the input
//     dtype, so pb (in dv) and ds (in dq, dk) are rounded to it, the
//     rounding points of the packed-head backward.
// In fp32 the two forms are one.  q, k, v, do, dq, dk, dv are [B, H, S, D];
// the TPU kernel pads S to 8 and zero-pads D to 128 lanes, here S and D are
// taken as they are and each tensor takes a batch, a head and a row stride,
// so any dimension order (the thirds of a packed qkv gradient included) is
// read and written in place.
//
// The kernels are the templates of attention_bwd.cuh (what bounds them and
// their design are described there), instantiated with kRound = keep_dtype.

#include "attention_bwd.cuh"

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// `strides` holds 21 element strides: (batch, head, row) for q, k, v, do,
// dq, dk, dv in that order; the last dimension must be contiguous.  `stats`
// is fp32 scratch of 3 * batch * heads * seq elements.  Launches kernel A,
// then kernel B, on `stream`; returns the cudaError_t of the launches
// (0 on success).
extern "C" int swat_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* stats, int batch, int seq, int heads,
    int head_dim, int dtype, const long long* strides, float scale,
    int causal, int keep_dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 2], strides[3 * i + 1]};
  const Args a{q,     k,     v,     dout,  dq,    dk,    dv,    stats,
               batch, seq,   heads, st[0], st[1], st[2], st[3], st[4],
               st[5], st[6], scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, false>(a, head_dim, s);
  else if (dtype == 1)
    err = keep_dtype ? launch<__nv_bfloat16, true>(a, head_dim, s)
                     : launch<__nv_bfloat16, false>(a, head_dim, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
