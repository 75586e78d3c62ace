// Packed-head multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swat_tpu/kernels/flash_attention.py
// ::_mha_bwd_kernel (launched by the pallas_call in _mha_bwd, the custom-VJP
// backward of mha_packed).  Same function, same rounding points: per head
//   s  = q.k^T * scale in fp32, keys with col > row masked when causal;
//   p  = exp(s - m) / sum, fp32;        pb = p rounded to the input dtype;
//   dv = pb^T . do;                     dp = do . v^T (fp32);
//   delta = rowsum(p * dp) with the fp32 p;
//   ds = p * (dp - delta) * scale, rounded to the input dtype;
//   dq = ds . k;                        dk = ds^T . q;
// every product accumulated in fp32, each output rounded once to the input
// dtype.  q, k, v, do and dq, dk, dv are strided [B, S, H*D] views (a batch
// and a row stride each), so dq, dk and dv can be the three thirds of one
// [B, S, 3*H*D] gradient of the qkv projection.
//
// What bounds it on the card.  As for the forward (mha_fwd.cu): at the CLIP
// sequence lengths (S = 50 / 77 / 197 / 257, D = 64) one (batch, head) pair
// does ~14*S*S*D flops (s and dp twice, then dq, dk, dv) on 7*S*D elements
// of device memory, so the CUDA-core fp32 FMA rate and the shared-memory
// reads feeding it bound this version, not HBM.  The TPU kernel holds the
// whole S x S tile per head and its grid runs in order; neither carries over
// (a block has at most 227 KB, blocks run in no order), so the work is split
// into two kernels that each own their output rows and need no atomics:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kRows = 32;               // rows (query or key) per block
constexpr int kParts = 2;               // threads per row
constexpr int kThreads = kRows * kParts;
constexpr int kTile = 32;               // rows per shared-memory tile

struct Strides {
  long long batch;
  long long row;
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
                                          Strides st, int b, int col,
                                          int first, int seq) {
  const T* base = src + b * st.batch + col;
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
                                              Strides st, int b, int col,
                                              int row0, int seq) {
  const T* base = src + b * st.batch + col;
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
                                               Strides st, int b, int col,
                                               int row0, int seq) {
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
#pragma unroll
  for (int d = 0; d < D / kParts; ++d)
    stage[r * (D + 1) + part * (D / kParts) + d] = in[d];
  __syncthreads();
  T* base = dst + b * st.batch + col;
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

// ---- kernel A: dq, and the row statistics m, l, delta
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  const int col = head * D;
  const unsigned pair = pair_mask();
  // keys this block reads, and keys this row attends to
  const int n_keys = causal ? min(seq, row0 + kRows) : seq;
  const int row_keys = causal ? row + 1 : seq;

  float qf[P], dof[P];
  load_row_part<T, D>(qf, stage, q, qs, b, col, row0, seq);
  load_row_part<T, D>(dof, stage, dout, dos, b, col, row0, seq);

  // ---- pass 1: row max m and sum l of exp(s - m), online over tiles
  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int first = 0; first < n_keys; first += kTile) {
    load_tile<T, D>(k_tile, k, ks, b, col, first, seq);
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
    load_tile<T, D>(k_tile, k, ks, b, col, first, seq);
    load_tile<T, D>(v_tile, v, vs, b, col, first, seq);
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

  // ---- pass 3: ds rounded to T, dq += ds * k in fp32
  float acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] = 0.f;
  for (int first = 0; first < n_keys; first += kTile) {
    load_tile<T, D>(k_tile, k, ks, b, col, first, seq);
    load_tile<T, D>(v_tile, v, vs, b, col, first, seq);
    __syncthreads();
    if (active) {
      const int valid = min(kTile, row_keys - first);
      for (int j = 0; j < valid; ++j) {
        const float* krow = k_tile + j * D + part * P;
        const float s = row_dot<D>(qf, krow, pair) * scale;
        const float p = expf(s - m) / l;
        const float dp = row_dot<D>(dof, v_tile + j * D + part * P, pair);
        const float ds = round_to<T>(p * (dp - delta) * scale);
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

  store_row_part<T, D>(acc, stage, dq, dqs, b, col, row0, seq);
  if (active && part == 0) {
    const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
    const long long at = (static_cast<long long>(b) * heads + head) * seq + row;
    stats[at] = m;
    stats[bhs + at] = l;
    stats[2 * bhs + at] = delta;
  }
}

// ---- kernel B: dk and dv, from the statistics kernel A stored
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  const int col = head * D;
  const unsigned pair = pair_mask();
  const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
  const float* stats_row =
      stats + (static_cast<long long>(b) * heads + head) * seq;

  float kf[P], vf[P];
  load_row_part<T, D>(kf, stage, k, ks, b, col, row0, seq);
  load_row_part<T, D>(vf, stage, v, vs, b, col, row0, seq);
  float dk_acc[P], dv_acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  // causal: queries before the block's first key never attend to its keys
  for (int first = causal ? row0 : 0; first < seq; first += kTile) {
    load_tile<T, D>(q_tile, q, qs, b, col, first, seq);
    load_tile<T, D>(do_tile, dout, dos, b, col, first, seq);
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
        const float pb = round_to<T>(p);
        const float dp = row_dot<D>(vf, dorow, pair);
        const float ds = round_to<T>(p * (dp - delta_tile[i]) * scale);
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

  store_row_part<T, D>(dk_acc, stage, dk, dks, b, col, row0, seq);
  store_row_part<T, D>(dv_acc, stage, dv, dvs, b, col, row0, seq);
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

template <typename T, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  mha_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      q, k, v, dout, static_cast<T*>(a.dq), a.stats, a.heads, a.seq, a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      q, k, v, dout, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.stats,
      a.heads, a.seq, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_d<T, 8>(a, stream);
    case 16:
      return launch_d<T, 16>(a, stream);
    case 32:
      return launch_d<T, 32>(a, stream);
    case 64:
      return launch_d<T, 64>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound through ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; the last dimension must be contiguous.  `stats`
// is fp32 scratch of 3 * batch * heads * seq elements.  Launches kernel A,
// then kernel B, on `stream`; returns the cudaError_t of the launches
// (0 on success).
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
               {q_batch, q_row},
               {k_batch, k_row},
               {v_batch, v_row},
               {do_batch, do_row},
               {dq_batch, dq_row},
               {dk_batch, dk_row},
               {dv_batch, dv_row},
               scale,
               causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, head_dim, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, head_dim, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
