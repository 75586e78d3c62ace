// Attention backward for Hopper (sm_90a): the kernel templates shared by
// the packed-head backward (mha_bwd.cu) and the heads-first backward
// (flash_bwd.cu).  Each of those sources instantiates them with its own
// rounding mode and gives them its own strides; this header holds no entry
// point.
//
// Per (batch, head):
//   s  = q.k^T * scale in fp32, keys with col > row masked when causal;
//   p  = exp(s - m) / sum, fp32;        pb = p (rounded to T under kRound);
//   dv = pb^T . do;                     dp = do . v^T (fp32);
//   delta = rowsum(p * dp) with the fp32 p;
//   ds = p * (dp - delta) * scale (rounded to T under kRound);
//   dq = ds . k;                        dk = ds^T . q;
// every product accumulated in fp32, each output rounded once to the input
// dtype.  q, k, v, do and dq, dk, dv are strided views (a batch, a head and
// a row stride each), so dq, dk and dv can be the three thirds of one
// [B, S, 3*H*D] gradient of the qkv projection, or [B, H, S, D] tensors of
// any dimension order.
//
// What bounds it on the card.  As for the forward (attention_fwd.cuh): at
// the CLIP sequence lengths (S = 50 / 77 / 197 / 257, D = 64) one (batch,
// head) pair does ~14*S*S*D flops (s and dp twice, then dq, dk, dv) on
// 7*S*D elements of device memory, so the CUDA-core fp32 FMA rate and the
// shared-memory reads feeding it bound this version, not HBM.  The TPU
// kernels hold the whole S x S tile per head and their grid runs in order;
// neither carries over (a block has at most 227 KB, blocks run in no
// order), so the work is split into two kernels that each own their output
// rows and need no atomics:
//
//   kernel A, one query row per thread pair: pass 1 over key tiles gives the
//     row max m and sum l; pass 2 gives delta; pass 3 recomputes ds and
//     accumulates dq in registers.  It writes dq and m, l, delta (fp32
//     scratch [3][B][H][S]).
//   kernel B, one key row per thread pair: loops over query tiles,
//     recomputes s, p and dp with the stored m, l, delta, and accumulates
//     dv += pb . do and dk += ds . q in registers.
//
// Both kernels compute s and dp with the same summation order, so p, dp and
// ds are bit-identical between them.  The result is deterministic run to
// run.  Each row is split over kParts = 2 threads (D/2 elements each, the
// partial dot products joined with one shuffle) to keep the three register
// rows of a thread (q, do, dq in A; k, v, dk, dv in B) clear of spills.
// Tensor cores (wgmma) and TMA come in a later version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kRows = 32;               // rows (query or key) per block
constexpr int kParts = 2;               // threads per row
constexpr int kThreads = kRows * kParts;
constexpr int kTile = 32;               // rows per shared-memory tile

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

// x rounded to T and back: the TPU kernel's casts to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Copies rows [first, first + kTile) of one head into a [kTile][D] fp32
// tile; rows at or past `seq` read as zero.  Consecutive threads read
// consecutive elements of a row, so the loads coalesce.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          Strides st, int b, int head,
                                          int first, int seq) {
  const T* base = src + b * st.batch + head * st.head;
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = first + i / D;
    tile[i] = r < seq ? to_float(base[r * st.row + i % D]) : 0.f;
  }
}

// This thread's D/kParts elements of row `row0 + threadIdx.x / kParts`,
// read through a padded staging buffer (coalesced global reads).
template <typename T, int D>
__device__ __forceinline__ void load_row_part(float (&out)[D / kParts],
                                              float* stage, const T* src,
                                              Strides st, int b, int head,
                                              int row0, int seq) {
  const T* base = src + b * st.batch + head * st.head;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = row0 + i / D;
    stage[(i / D) * (D + 1) + i % D] =
        r < seq ? to_float(base[r * st.row + i % D]) : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
#pragma unroll
  for (int d = 0; d < D / kParts; ++d)
    out[d] = stage[r * (D + 1) + part * (D / kParts) + d];
  __syncthreads();
}

// The reverse of load_row_part: rounds each thread's part to T and writes
// the block's rows (those below `seq`) with coalesced stores.
template <typename T, int D>
__device__ __forceinline__ void store_row_part(const float (&in)[D / kParts],
                                               float* stage, T* dst,
                                               Strides st, int b, int head,
                                               int row0, int seq) {
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
#pragma unroll
  for (int d = 0; d < D / kParts; ++d)
    stage[r * (D + 1) + part * (D / kParts) + d] = in[d];
  __syncthreads();
  T* base = dst + b * st.batch + head * st.head;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int row = row0 + i / D;
    if (row < seq)
      base[row * st.row + i % D] =
          from_float<T>(stage[(i / D) * (D + 1) + i % D]);
  }
  __syncthreads();
}

// The full dot product of a row with a tile row: this thread's partial sum
// over its D/kParts elements (four chains, as mha_fwd.cu), joined with its
// partner's.  `pair` holds the two lanes of the row.
template <int D>
__device__ __forceinline__ float row_dot(const float (&a)[D / kParts],
                                         const float* b_part,
                                         unsigned pair) {
  const float4* b4 = reinterpret_cast<const float4*>(b_part);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < D / kParts / 4; ++i) {
    const float4 bv = b4[i];
    a0 = fmaf(a[4 * i + 0], bv.x, a0);
    a1 = fmaf(a[4 * i + 1], bv.y, a1);
    a2 = fmaf(a[4 * i + 2], bv.z, a2);
    a3 = fmaf(a[4 * i + 3], bv.w, a3);
  }
  const float mine = (a0 + a1) + (a2 + a3);
  const float other = __shfl_xor_sync(pair, mine, 1);
  // the same order in both lanes and both kernels: part 0 + part 1
  return (threadIdx.x % kParts == 0) ? mine + other : other + mine;
}

__device__ __forceinline__ unsigned pair_mask() {
  return 3u << ((threadIdx.x & 31) & ~1);
}

// ---- kernel A: dq, and the row statistics m, l, delta.  kRound: round ds
// (and, in kernel B, pb) to T, the rounding points of the TPU kernels that
// feed the matrix unit the input dtype; false keeps both in fp32
template <typename T, int D, bool kRound>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ stats,
                      int heads, int seq, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dqs, float scale, int causal) {
  constexpr int P = D / kParts;
  static_assert(P % 4 == 0, "a row part must hold whole float4s");
  __shared__ __align__(16) float k_tile[kTile * D];
  __shared__ __align__(16) float v_tile[kTile * D];
  __shared__ float stage[kRows * (D + 1)];

  const int part = threadIdx.x % kParts;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + threadIdx.x / kParts;
  const bool active = row < seq;
  const unsigned pair = pair_mask();
  // keys this block reads, and keys this row attends to
  const int n_keys = causal ? min(seq, row0 + kRows) : seq;
  const int row_keys = causal ? row + 1 : seq;

  float qf[P], dof[P];
  load_row_part<T, D>(qf, stage, q, qs, b, head, row0, seq);
  load_row_part<T, D>(dof, stage, dout, dos, b, head, row0, seq);

  // ---- pass 1: row max m and sum l of exp(s - m), online over tiles
  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int first = 0; first < n_keys; first += kTile) {
    load_tile<T, D>(k_tile, k, ks, b, head, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kTile, row_keys - first);
      float s[kTile];
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float sj = row_dot<D>(qf, k_tile + j * D + part * P, pair) *
                         scale;
        s[j] = j < valid ? sj : -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[j]);
      }
      if (valid > 0) {
        const float m_new = fmaxf(m, tile_max);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          sum += j < valid ? expf(s[j] - m_new) : 0.f;
        l = l * expf(m - m_new) + sum;
        m = m_new;
      }
    }
    __syncthreads();
  }

  // ---- pass 2: delta = sum_j p_j * dp_j with the fp32 p
  float delta = 0.f;
  for (int first = 0; first < n_keys; first += kTile) {
    load_tile<T, D>(k_tile, k, ks, b, head, first, seq);
    load_tile<T, D>(v_tile, v, vs, b, head, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kTile, row_keys - first);
      for (int j = 0; j < valid; ++j) {
        const float s =
            row_dot<D>(qf, k_tile + j * D + part * P, pair) * scale;
        const float p = expf(s - m) / l;
        const float dp = row_dot<D>(dof, v_tile + j * D + part * P, pair);
        delta = fmaf(p, dp, delta);
      }
    }
    __syncthreads();
  }

  // ---- pass 3: ds (rounded to T under kRound), dq += ds * k in fp32
  float acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] = 0.f;
  for (int first = 0; first < n_keys; first += kTile) {
    load_tile<T, D>(k_tile, k, ks, b, head, first, seq);
    load_tile<T, D>(v_tile, v, vs, b, head, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kTile, row_keys - first);
      for (int j = 0; j < valid; ++j) {
        const float* krow = k_tile + j * D + part * P;
        const float s = row_dot<D>(qf, krow, pair) * scale;
        const float p = expf(s - m) / l;
        const float dp = row_dot<D>(dof, v_tile + j * D + part * P, pair);
        const float dsf = p * (dp - delta) * scale;
        const float ds = kRound ? round_to<T>(dsf) : dsf;
        const float4* k4 = reinterpret_cast<const float4*>(krow);
#pragma unroll
        for (int i = 0; i < P / 4; ++i) {
          const float4 kv = k4[i];
          acc[4 * i + 0] = fmaf(ds, kv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(ds, kv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(ds, kv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(ds, kv.w, acc[4 * i + 3]);
        }
      }
    }
    __syncthreads();
  }

  store_row_part<T, D>(acc, stage, dq, dqs, b, head, row0, seq);
  if (active && part == 0) {
    const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
    const long long at = (static_cast<long long>(b) * heads + head) * seq + row;
    stats[at] = m;
    stats[bhs + at] = l;
    stats[2 * bhs + at] = delta;
  }
}

// ---- kernel B: dk and dv, from the statistics kernel A stored
template <typename T, int D, bool kRound>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       T* __restrict__ dk, T* __restrict__ dv,
                       const float* __restrict__ stats, int heads, int seq,
                       Strides qs, Strides ks, Strides vs, Strides dos,
                       Strides dks, Strides dvs, float scale, int causal) {
  constexpr int P = D / kParts;
  static_assert(P % 4 == 0, "a row part must hold whole float4s");
  __shared__ __align__(16) float q_tile[kTile * D];
  __shared__ __align__(16) float do_tile[kTile * D];
  __shared__ float stage[kRows * (D + 1)];
  __shared__ float m_tile[kTile], l_tile[kTile], delta_tile[kTile];

  const int part = threadIdx.x % kParts;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;       // first key row of the block
  const int key = row0 + threadIdx.x / kParts;
  const bool active = key < seq;
  const unsigned pair = pair_mask();
  const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
  const float* stats_row =
      stats + (static_cast<long long>(b) * heads + head) * seq;

  float kf[P], vf[P];
  load_row_part<T, D>(kf, stage, k, ks, b, head, row0, seq);
  load_row_part<T, D>(vf, stage, v, vs, b, head, row0, seq);
  float dk_acc[P], dv_acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  // causal: queries before the block's first key never attend to its keys
  for (int first = causal ? row0 : 0; first < seq; first += kTile) {
    load_tile<T, D>(q_tile, q, qs, b, head, first, seq);
    load_tile<T, D>(do_tile, dout, dos, b, head, first, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int r = first + i;
      m_tile[i] = r < seq ? stats_row[r] : 0.f;
      l_tile[i] = r < seq ? stats_row[bhs + r] : 1.f;
      delta_tile[i] = r < seq ? stats_row[2 * bhs + r] : 0.f;
    }
    __syncthreads();
    if (active) {
      const int n = min(kTile, seq - first);
      for (int i = 0; i < n; ++i) {
        if (causal && first + i < key) continue;   // masked: no contribution
        const float* qrow = q_tile + i * D + part * P;
        const float* dorow = do_tile + i * D + part * P;
        const float s = row_dot<D>(kf, qrow, pair) * scale;
        const float p = expf(s - m_tile[i]) / l_tile[i];
        const float pb = kRound ? round_to<T>(p) : p;
        const float dp = row_dot<D>(vf, dorow, pair);
        const float dsf = p * (dp - delta_tile[i]) * scale;
        const float ds = kRound ? round_to<T>(dsf) : dsf;
        const float4* q4 = reinterpret_cast<const float4*>(qrow);
        const float4* do4 = reinterpret_cast<const float4*>(dorow);
#pragma unroll
        for (int c = 0; c < P / 4; ++c) {
          const float4 qv = q4[c];
          const float4 dov = do4[c];
          dv_acc[4 * c + 0] = fmaf(pb, dov.x, dv_acc[4 * c + 0]);
          dv_acc[4 * c + 1] = fmaf(pb, dov.y, dv_acc[4 * c + 1]);
          dv_acc[4 * c + 2] = fmaf(pb, dov.z, dv_acc[4 * c + 2]);
          dv_acc[4 * c + 3] = fmaf(pb, dov.w, dv_acc[4 * c + 3]);
          dk_acc[4 * c + 0] = fmaf(ds, qv.x, dk_acc[4 * c + 0]);
          dk_acc[4 * c + 1] = fmaf(ds, qv.y, dk_acc[4 * c + 1]);
          dk_acc[4 * c + 2] = fmaf(ds, qv.z, dk_acc[4 * c + 2]);
          dk_acc[4 * c + 3] = fmaf(ds, qv.w, dk_acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();
  }

  store_row_part<T, D>(dk_acc, stage, dk, dks, b, head, row0, seq);
  store_row_part<T, D>(dv_acc, stage, dv, dvs, b, head, row0, seq);
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float* stats;
  int batch, seq, heads;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
  int causal;
};

template <typename T, int D, bool kRound>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  attention_bwd_dq_kernel<T, D, kRound><<<grid, kThreads, 0, stream>>>(
      q, k, v, dout, static_cast<T*>(a.dq), a.stats, a.heads, a.seq, a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, D, kRound><<<grid, kThreads, 0, stream>>>(
      q, k, v, dout, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.stats,
      a.heads, a.seq, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, bool kRound>
cudaError_t launch(const Args& a, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_d<T, 8, kRound>(a, stream);
    case 16:
      return launch_d<T, 16, kRound>(a, stream);
    case 32:
      return launch_d<T, 32, kRound>(a, stream);
    case 64:
      return launch_d<T, 64, kRound>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
