// Attention forward for Hopper (sm_90a): the kernel template shared by the
// packed-head forward (mha_fwd.cu) and the heads-first forward
// (flash_fwd.cu).  Each of those sources instantiates it with its own
// rounding mode and gives it its own strides; this header holds no entry
// point.
//
// Per (batch, head): s = q.k^T * scale in fp32, keys at col >= S (and
// col > row when causal) masked out, fp32 softmax, out = p.v accumulated in
// fp32 and rounded to the input dtype once.  kRoundP says whether p is
// rounded to the input dtype before p.v.
//
// What bounds it on the card.  The CLIP towers attend over short
// sequences (S = 50 / 77 / 197 / 257, head dim 64).  One (batch, head)
// pair moves 4*S*D elements through device memory and does ~6*S*S*D
// flops here, so from S ~ 50 up the CUDA-core fp32 FMA rate and the
// shared-memory reads feeding it bound this version, not HBM.  The TPU
// kernels kept the whole S x S score tile in VMEM; at S = 257 an fp32 tile
// (264 KB) does not fit the 227 KB a block may use, so that shape does
// not carry over.
//
// Design, simple first:
//   * one thread per query row, one warp (kRows = 32 rows) per block, grid
//     (ceil(S / kRows), H, B); the q row and its fp32 output accumulator
//     live in registers;
//   * keys and values stream through shared memory in tiles of kKeys rows,
//     so shared memory stays at 16 KB per block for every S;
//   * two passes over the keys: the first keeps the running row max and
//     sum (online softmax), the second recomputes each score, normalises
//     it with the final max and sum and accumulates p.v.  The extra q.k
//     pass buys exact TPU semantics: p is normalised (and, with kRoundP,
//     rounded) with the FINAL statistics, as the TPU kernels do it, so the
//     bf16 path needs no extra tolerance for end-of-row rescaling;
//   * S and D are taken as they are (no padding to 8 or to 128 lanes):
//     tiles past S are zero-filled and never scored, rows past S are not
//     written;
//   * q, k, v (and o) are strided views: each takes a batch, a head and a
//     row stride in elements, so the thirds of one qkv tensor (row stride
//     3*H*D, head stride D) and [B, H, S, D] tensors of any dimension order
//     are read in place, without a copy.
// tensor cores (wgmma) and TMA come in a later version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kRows = 32;  // query rows per block, one per thread
constexpr int kKeys = 32;  // keys per shared-memory tile

// element strides of one [batch, head, row, D] view; D is contiguous
struct Strides {
  long long batch;
  long long row;
  long long head;
};

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

// Copies keys [first, first + kKeys) of one head into a [kKeys][D] fp32
// tile; keys at or past `seq` read as zero.  Consecutive threads read
// consecutive elements of a row, so the loads coalesce.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          Strides st, int b, int head,
                                          int first, int seq) {
  const T* base = src + b * st.batch + head * st.head;
#pragma unroll 8
  for (int i = threadIdx.x; i < kKeys * D; i += kRows) {
    const int key = first + i / D;
    tile[i] = key < seq ? to_float(base[key * st.row + i % D]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&qf)[D],
                                         const float* krow) {
  const float4* k4 = reinterpret_cast<const float4*>(krow);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 kv = k4[i];  // the same address for the whole warp
    a0 = fmaf(qf[4 * i + 0], kv.x, a0);
    a1 = fmaf(qf[4 * i + 1], kv.y, a1);
    a2 = fmaf(qf[4 * i + 2], kv.z, a2);
    a3 = fmaf(qf[4 * i + 3], kv.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// kRoundP: round the normalised p to T before p.v (the packed-head TPU
// kernel's rounding point); false keeps the fp32 p (the heads-first one's)
template <typename T, int D, bool kRoundP>
__global__ void __launch_bounds__(kRows)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int seq,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal) {
  // k tile, v tile; the q and o row staging (kRows x (D + 1), padded so
  // that thread t's row starts in bank t) reuses the same space
  static_assert(kRows * (D + 1) <= 2 * kKeys * D, "staging overflows");
  __shared__ __align__(16) float smem[2 * kKeys * D];
  float* k_tile = smem;
  float* v_tile = smem + kKeys * D;
  float* stage = smem;

  const int t = threadIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + t;
  const bool active = row < seq;
  // keys this block reads: all of them, or up to its last row when causal
  const int n_keys = causal ? min(seq, row0 + kRows) : seq;

  // ---- q rows: coalesced global read -> staging -> registers
  {
    const T* base = q + b * qs.batch + head * qs.head;
    for (int i = t; i < kRows * D; i += kRows) {
      const int r = row0 + i / D;
      stage[(i / D) * (D + 1) + i % D] =
          r < seq ? to_float(base[r * qs.row + i % D]) : 0.f;
    }
  }
  __syncthreads();
  float qf[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qf[d] = stage[t * (D + 1) + d];
  __syncthreads();

  // ---- pass 1: row max m and sum l of exp(s - m), online over tiles
  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int first = 0; first < n_keys; first += kKeys) {
    load_tile<T, D>(k_tile, k, ks, b, head, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kKeys, (causal ? row + 1 : seq) - first);
      float s[kKeys];
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[j] = j < valid ? dot_row<D>(qf, k_tile + j * D) * scale
                         : -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[j]);
      }
      if (valid > 0) {
        const float m_new = fmaxf(m, tile_max);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          sum += j < valid ? expf(s[j] - m_new) : 0.f;
        l = l * expf(m - m_new) + sum;
        m = m_new;
      }
    }
    __syncthreads();
  }

  // ---- pass 2: p = exp(s - m) / l (rounded to T under kRoundP),
  // out += p * v in fp32
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int first = 0; first < n_keys; first += kKeys) {
    load_tile<T, D>(k_tile, k, ks, b, head, first, seq);
    load_tile<T, D>(v_tile, v, vs, b, head, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kKeys, (causal ? row + 1 : seq) - first);
      for (int j = 0; j < valid; ++j) {
        const float s = dot_row<D>(qf, k_tile + j * D) * scale;
        const float pf = expf(s - m) / l;
        const float p = kRoundP ? to_float(from_float<T>(pf)) : pf;
        const float4* v4 = reinterpret_cast<const float4*>(v_tile + j * D);
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float4 vv = v4[i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- out rows: registers -> staging -> coalesced global write
#pragma unroll
  for (int d = 0; d < D; ++d) stage[t * (D + 1) + d] = acc[d];
  __syncthreads();
  T* base = o + b * os.batch + head * os.head;
  for (int i = t; i < kRows * D; i += kRows) {
    const int r = row0 + i / D;
    if (r < seq)
      base[r * os.row + i % D] =
          from_float<T>(stage[(i / D) * (D + 1) + i % D]);
  }
}

template <typename T, bool kRoundP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq, int heads, int head_dim, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (head_dim) {
    case 8:
      attention_fwd_kernel<T, 8, kRoundP><<<grid, kRows, 0, stream>>>(
          qp, kp, vp, op, seq, qs, ks, vs, os, scale, causal);
      break;
    case 16:
      attention_fwd_kernel<T, 16, kRoundP><<<grid, kRows, 0, stream>>>(
          qp, kp, vp, op, seq, qs, ks, vs, os, scale, causal);
      break;
    case 32:
      attention_fwd_kernel<T, 32, kRoundP><<<grid, kRows, 0, stream>>>(
          qp, kp, vp, op, seq, qs, ks, vs, os, scale, causal);
      break;
    case 64:
      attention_fwd_kernel<T, 64, kRoundP><<<grid, kRows, 0, stream>>>(
          qp, kp, vp, op, seq, qs, ks, vs, os, scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
