// The matrix product of the block-fused layer kernels on the tensor cores,
// for Hopper (sm_90a): C[M, N] = sum_k A(m, k) * B(k, n), summed in fp32,
// each sum handed to one of the layer's epilogues (megablock.cuh).  It
// serves every product of the three block entry points: the block forward
// (megablock_fwd.cu: the qkv, out-projection, fc and MLP-projection
// products), the MLP backward (megablock_mlp_bwd.cu: the fc recompute, dg
// whose epilogue makes dm, dh2, and the two weight gradients dWp and dWfc)
// and the attention backward (megablock_attn_bwd.cu: the qkv recompute, do,
// dh1, and the two weight gradients dWo and d in_proj_weight).  This header
// holds no entry point.
//
// Those kernels replace the Pallas TPU kernels
// swat_tpu/kernels/megablock.py::_fwd_kernel, ::_mlp_bwd_kernel and
// ::_attn_bwd_kernel, whose products go to the TPU's matrix unit with fp32
// sums and whose weight gradients are carried from grid step to grid step.
//
// What bounds it on the card: operations.  One ViT-B/32 layer at batch 256
// does 0.18 TFLOP in the forward, 0.30 in the MLP backward and 0.17 in the
// attention backward on ~0.15 GB of inputs and outputs, some 1,000
// operations a byte, far above the 295 at which the tensor cores and not
// the memory are the limit.  So the products go to the tensor cores and the
// loads hide behind them.
//
// Design:
//   * a block computes a BM x BN output tile with 8 warps, a depth of kDepth
//     (32) a step: bf16 128 x 128, a warp 64 x 32; fp32 128 x 64, a warp
//     32 x 32, because an fp32 output keeps two accumulators (below).  Both
//     are held to 128 registers, so that two blocks share an SM and one
//     block's epilogue or staging runs beside the other's mma.  Both keep
//     128 rows a block, the row block of the column-sum partials;
//   * the products are mma.sync.m16n8k16 (bf16 in, fp32 sums) fed by
//     ldmatrix: an operand stored k-contiguous (element (i, k) at
//     p[i * ld + k]: an activation as A, a torch [out, in] weight as B) is
//     read with ldmatrix, one stored i-contiguous (p[k * ld + i]: the
//     activations of a weight gradient, a weight read along its rows) with
//     ldmatrix.trans.  Rows in shared memory are padded by 8 elements, so
//     that the 8 rows an ldmatrix reads lie in 8 different bank groups;
//   * the tensor cores do not round a chain of mma to nearest: summed in
//     the accumulator over the 48-400 mma of a product, the error grows with
//     the depth and leans one way (on an H100 a bf16 output of the block
//     forward at the B/32 widths then differed from the plain version in 3-4
//     times as many elements as the plain version summed in another order
//     does).  So the running sum never goes through them: bf16 sums each
//     step's product (two chained k16 mma) afresh and the CUDA cores add it,
//     rounded to nearest; fp32 does so for the leading term of each k16
//     product, and chains the corrections (below 2^-8 of it) in their own
//     accumulator;
//   * bf16 operands go to shared memory as they are, by 16-byte cp.async,
//     into a ring of kStages16 (3) stages: the loads of step k + 2 fly while
//     step k is multiplied;
//   * fp32 stays full fp32 (never TF32): each value is split into three
//     exact bf16 terms hi + mid + lo, stored as three planes, and a product
//     is the six cross terms of weight >= 2^-16 (what is left out is below
//     2^-24 of the product); the leading term and the five corrections have
//     accumulators of their own, joined when the sum is done.  The split
//     needs the values in registers: a step is loaded, split and stored,
//     then multiplied, while the SM's other block multiplies (register
//     prefetch of the next step, kStages32 = 2, spills under the 128
//     registers and measured slower);
//   * the epilogue takes the sums where the accumulators hold them: lane l
//     holds rows l / 4 and l / 4 + 8 and columns 2 * (l % 4) and + 1 of each
//     m16n8 tile; pairs of columns are stored as one access when the row
//     stride is even.  The column sums of an epilogue that has them (dm ->
//     the fc bias gradient) are taken in a fixed order: a warp's rows by
//     shuffles over lanes xor 4, 8, 16, then the warps of the block in order
//     through shared memory, one partial a row block of 128;
//   * the weight gradients sum over all B*S token rows (K = 12,800 at batch
//     256) into 768 x 3072 outputs (dWp, dWfc: 144 bf16 tiles for 132 SMs,
//     barely more than one wave), 768 x 768 (dWo: 36) or 2304 x 768
//     (d in_proj_weight: 108).  So K is cut into splits (`split_count`: a
//     number that depends on M, N and K alone, for at least kSplitBlocks
//     blocks); each split writes its fp32 partial tile to scratch and one
//     join kernel adds the splits in order.  Deterministic, no atomics;
//   * ragged M, N and K edges are masked and what lies past them is read as
//     zero.  The 16-byte accesses need a base and a row stride that are
//     multiples of 16 bytes; otherwise the block loads element-wise (same
//     arithmetic).

#pragma once

#include "attention_mma.cuh"
#include "megablock.cuh"

namespace {
namespace mega {
namespace tc {

constexpr int kDepth = 32;         // depth of one shared-memory step
constexpr int kStages16 = 3, kStages32 = 1;  // bf16 ring; fp32 buffers
// split-K of the weight gradients: enough splits for kSplitBlocks blocks (4
// waves of 132 SMs), each at least kMinSplitSteps steps deep, at most
// kMaxSplits
constexpr int kSplitBlocks = 528;
constexpr int kMinSplitSteps = 8;
constexpr int kMaxSplits = 16;

// block tile (BM x BN), warps along M and N, stages, blocks an SM asked of
// the register allocator
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, WM = 2, WN = 4;
  static constexpr int kStages = kStages16, kMinBlocks = 2;
  static constexpr int kThreads = WM * WN * 32;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 128, BN = 64, WM = 4, WN = 2;
  static constexpr int kStages = kStages32, kMinBlocks = 2;
  static constexpr int kThreads = WM * WN * 32;
};

// one operand's tile of R rows (M or N) by kDepth in shared memory: a
// k-contiguous operand as [R][kDepth + 8], an i-contiguous one as
// [kDepth][R + 8]; chunks of 8 elements along the contiguous dimension,
// spread over kThreads threads
template <int R, bool kKContig, int kThreads>
struct TileMap {
  static constexpr int LD = kKContig ? kDepth + 8 : R + 8;
  static constexpr int kElems = kKContig ? R * LD : kDepth * LD;
  static constexpr int kChunks = R * kDepth / 8;
  static constexpr int kPerThread = kChunks / kThreads;
  static_assert(kChunks % kThreads == 0, "chunks must spread evenly");

  // (i, k) in the tile of the first element of chunk c
  static __device__ __forceinline__ void at(int c, int& i, int& k) {
    if (kKContig) {
      i = c / (kDepth / 8);
      k = (c % (kDepth / 8)) * 8;
    } else {
      k = c / (R / 8);
      i = (c % (R / 8)) * 8;
    }
  }
  static __device__ __forceinline__ int smem(int i, int k) {
    return kKContig ? i * LD + k : k * LD + i;
  }
  static __device__ __forceinline__ long long global(int gi, int gk,
                                                     long long ld) {
    return kKContig ? gi * ld + gk : gk * ld + gi;
  }
  // elements of the chunk at (gi, gk) inside the matrix: 0 to 8
  static __device__ __forceinline__ int valid(int gi, int gk, int n_i,
                                              int k_end) {
    if (kKContig) return gi < n_i ? min(8, k_end - gk) : 0;
    return gk < k_end ? min(8, n_i - gi) : 0;
  }
};

// bf16: one stage of a tile by cp.async (full, aligned chunks) or
// element-wise loads, zeros past the edges
template <int R, bool kKContig, int kThreads>
__device__ __forceinline__ void issue_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ p,
                                           long long ld, bool vec, int i0,
                                           int k0, int n_i, int k_end) {
  using M = TileMap<R, kKContig, kThreads>;
#pragma unroll
  for (int j = 0; j < M::kPerThread; ++j) {
    int i, k;
    M::at(threadIdx.x + j * kThreads, i, k);
    const int gi = i0 + i, gk = k0 + k;
    const int valid = M::valid(gi, gk, n_i, k_end);
    __nv_bfloat16* d = dst + M::smem(i, k);
    if (valid >= 8 && vec) {
      cp_async_16(d, p + M::global(gi, gk, ld));
    } else if (valid <= 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const __nv_bfloat16* s = p + M::global(gi, gk, ld);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = e < valid ? s[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// fp32: a tile's chunks into registers ...
template <int R, bool kKContig, int kThreads>
__device__ __forceinline__ void fetch_tile(
    float (&x)[TileMap<R, kKContig, kThreads>::kPerThread][8],
    const float* __restrict__ p, long long ld, bool vec, int i0, int k0,
    int n_i, int k_end) {
  using M = TileMap<R, kKContig, kThreads>;
#pragma unroll
  for (int j = 0; j < M::kPerThread; ++j) {
    int i, k;
    M::at(threadIdx.x + j * kThreads, i, k);
    const int gi = i0 + i, gk = k0 + k;
    const int valid = M::valid(gi, gk, n_i, k_end);
    if (valid >= 8 && vec) {
      const float4* s =
          reinterpret_cast<const float4*>(p + M::global(gi, gk, ld));
      const float4 a = __ldg(s), b = __ldg(s + 1);
      x[j][0] = a.x, x[j][1] = a.y, x[j][2] = a.z, x[j][3] = a.w;
      x[j][4] = b.x, x[j][5] = b.y, x[j][6] = b.z, x[j][7] = b.w;
    } else {
      const float* s = valid > 0 ? p + M::global(gi, gk, ld) : p;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[j][e] = e < valid ? s[e] : 0.f;
    }
  }
}

// ... then split into three bf16 planes in shared memory
template <int R, bool kKContig, int kThreads>
__device__ __forceinline__ void store_tile(
    __nv_bfloat16* dst,
    const float (&x)[TileMap<R, kKContig, kThreads>::kPerThread][8]) {
  using M = TileMap<R, kKContig, kThreads>;
#pragma unroll
  for (int j = 0; j < M::kPerThread; ++j) {
    int i, k;
    M::at(threadIdx.x + j * kThreads, i, k);
    uint32_t term[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_pair<3>(x[j][2 * e], x[j][2 * e + 1], term[e]);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(dst + pl * M::kElems + M::smem(i, k)) =
          make_uint4(term[0][pl], term[1][pl], term[2][pl], term[3][pl]);
  }
}

// the fp32 partial sums of one K split: split blockIdx.z of [splits, M, N]
struct EpiPart {
  static constexpr bool kColSum = false;
  float* c;
  long long ldc;
  long long split_stride;
  __device__ __forceinline__ float operator()(int r, int n, float s) const {
    c[blockIdx.z * split_stride + r * ldc + n] = s;
    return 0.f;
  }
  __device__ __forceinline__ float2 pair(int r, int n, float s0,
                                         float s1) const {
    store2(c + blockIdx.z * split_stride + r * ldc + n, s0, s1);
    return make_float2(0.f, 0.f);
  }
};

template <typename T, bool kAKContig, bool kBKContig>
__host__ __device__ constexpr int smem_bytes() {
  using C = Cfg<T>;
  return C::kStages * Planes<T>::n *
         (TileMap<C::BM, kAKContig, C::kThreads>::kElems +
          TileMap<C::BN, kBKContig, C::kThreads>::kElems) *
         2;
}

// The block's product over the k-steps of split blockIdx.z, then the
// epilogue.  k_per_split is a multiple of kDepth.
template <typename T, bool kAKContig, bool kBKContig, typename Epi>
__global__ void __launch_bounds__(Cfg<T>::kThreads, Cfg<T>::kMinBlocks)
    mma_gemm_kernel(const T* __restrict__ a, long long lda, bool a_vec,
                    const T* __restrict__ b, long long ldb, bool b_vec,
                    int m_total, int n_total, int k_total, int k_per_split,
                    bool pairs, Epi epi) {
  using C = Cfg<T>;
  constexpr int NP = Planes<T>::n;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages;
  constexpr int kThreads = C::kThreads;
  using TA = TileMap<BM, kAKContig, kThreads>;
  using TB = TileMap<BN, kBKContig, kThreads>;
  constexpr int kStageElems = NP * (TA::kElems + TB::kElems);
  constexpr int MT = BM / C::WM / 16;  // m16 tiles a warp
  constexpr int NT = BN / C::WN / 8;   // n8 tiles a warp
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int wm0 = wm * (BM / C::WM), wn0 = wn * (BN / C::WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k_total, k_begin + k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + kDepth - 1) / kDepth
                                    : 0;

  // [0]: the leading term (bf16: the whole sum); [1]: the corrections
  float acc[NP == 3 ? 2 : 1][MT][NT][4];
#pragma unroll
  for (int x = 0; x < (NP == 3 ? 2 : 1); ++x)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][i][j][e] = 0.f;

  // the mma of one stage: two k16 steps
  // fragments of one plane at depth kk: A of m16 tile i, B of the n8 tiles
  // j and j + 1
  auto load_a = [&](uint32_t(&r)[4], const __nv_bfloat16* sa, int i,
                    int kk) {
    const int row = wm0 + i * 16;
    if (kAKContig)
      ldmatrix_x4(r, sa + TA::smem(row + lane % 8 + 8 * ((lane / 8) % 2),
                                   kk + 8 * (lane / 16)));
    else
      ldmatrix_x4_trans(r, sa + TA::smem(row + 8 * ((lane / 8) % 2),
                                         kk + lane % 8 + 8 * (lane / 16)));
  };
  auto load_b = [&](uint32_t(&b0)[2], uint32_t(&b1)[2],
                    const __nv_bfloat16* sb, int j, int kk) {
    const int col = wn0 + j * 8;
    uint32_t r[4];
    if (kBKContig)
      ldmatrix_x4(r, sb + TB::smem(col + lane % 8 + 8 * (lane / 16),
                                   kk + 8 * ((lane / 8) % 2)));
    else
      ldmatrix_x4_trans(r, sb + TB::smem(col + 8 * (lane / 16),
                                         kk + lane % 8 + 8 * ((lane / 8) % 2)));
    b0[0] = r[0], b0[1] = r[1], b1[0] = r[2], b1[1] = r[3];
  };

  // the mma of one stage.  The tensor cores' own sum of a chain of mma is
  // not rounded to nearest, so the running sum never goes through them:
  // bf16 sums each step's product (two chained k16 mma) afresh and adds it
  // in fp32; fp32 does so for the leading term of each k16 product, and
  // chains its corrections
  auto compute = [&](int stage) {
    const __nv_bfloat16* sa = smem + stage * kStageElems;
    const __nv_bfloat16* sb = sa + NP * TA::kElems;
    if constexpr (NP == 1) {
      // B for the whole step, then one row of tiles at a time
      constexpr int H = kDepth / 16;
      uint32_t bf[H][NT][2];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NT; j += 2)
          load_b(bf[h][j], bf[h][j + 1], sb, j, 16 * h);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[H][4];
#pragma unroll
        for (int h = 0; h < H; ++h) load_a(af[h], sa, i, 16 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < H; ++h)
            mma_bf16(t, af[h], bf[h][j][0], bf[h][j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][i][j][e] += t[e];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 16) {
        uint32_t af[NP][MT][4], bf[NP][NT][2];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
            load_a(af[pl][i], sa + pl * TA::kElems, i, kk);
#pragma unroll
          for (int j = 0; j < NT; j += 2)
            load_b(bf[pl][j], bf[pl][j + 1], sb + pl * TB::kElems, j, kk);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, af[0][i], bf[0][j][0], bf[0][j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][i][j][e] += t[e];
            // hi.mid, mid.hi, hi.lo, mid.mid, lo.hi
            float(&c)[4] = acc[NP == 3 ? 1 : 0][i][j];
            mma_bf16(c, af[0][i], bf[1][j][0], bf[1][j][1]);
            mma_bf16(c, af[1][i], bf[0][j][0], bf[0][j][1]);
            mma_bf16(c, af[0][i], bf[2][j][0], bf[2][j][1]);
            mma_bf16(c, af[1][i], bf[1][j][0], bf[1][j][1]);
            mma_bf16(c, af[2][i], bf[0][j][0], bf[0][j][1]);
          }
      }
    }
  };

  if constexpr (NP == 1) {
    auto issue = [&](int stage, int step) {
      const int k0 = k_begin + step * kDepth;
      __nv_bfloat16* sa = smem + stage * kStageElems;
      issue_tile<BM, kAKContig, kThreads>(sa, a, lda, a_vec, m0, k0,
                                          m_total, k_end);
      issue_tile<BN, kBKContig, kThreads>(sa + TA::kElems, b, ldb, b_vec, n0,
                                          k0, n_total, k_end);
    };
    if constexpr (S > 1) {
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        if (s < steps) issue(s, s);
        cp_async_commit();
      }
      for (int kt = 0; kt < steps; ++kt) {
        cp_async_wait<S - 2>();
        __syncthreads();
        const int next = kt + S - 1;
        if (next < steps) issue(next % S, next);
        cp_async_commit();
        compute(kt % S);
      }
      cp_async_wait<0>();
    } else {  // no ring: load, then multiply
      for (int kt = 0; kt < steps; ++kt) {
        issue(0, kt);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        compute(0);
        __syncthreads();
      }
    }
  } else {
    float xa[TA::kPerThread][8], xb[TB::kPerThread][8];
    auto fetch = [&](int step) {
      const int k0 = k_begin + step * kDepth;
      fetch_tile<BM, kAKContig, kThreads>(xa, a, lda, a_vec, m0, k0,
                                          m_total, k_end);
      fetch_tile<BN, kBKContig, kThreads>(xb, b, ldb, b_vec, n0, k0, n_total,
                                          k_end);
    };
    auto store = [&](int stage) {
      __nv_bfloat16* sa = smem + stage * kStageElems;
      store_tile<BM, kAKContig, kThreads>(sa, xa);
      store_tile<BN, kBKContig, kThreads>(sa + NP * TA::kElems, xb);
    };
    if (steps > 0) {
      fetch(0);
      store(0);
    }
    __syncthreads();
    for (int kt = 0; kt < steps; ++kt) {
      if constexpr (S > 1) {
        // step kt + 1 into registers before step kt's mma, into the other
        // buffer after them
        const bool more = kt + 1 < steps;
        if (more) fetch(kt + 1);
        compute(kt % 2);
        if (more) store((kt + 1) % 2);
        __syncthreads();
      } else {  // no prefetch: load, split, then multiply
        if (kt > 0) {
          fetch(kt);
          store(0);
          __syncthreads();
        }
        compute(0);
        __syncthreads();
      }
    }
  }

  // ---- epilogue
  const int g = lane / 4, t = lane % 4;
  float cs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm0 + i * 16 + g + 8 * h;
      if (r >= m_total) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn0 + j * 8 + 2 * t;
        float v0 = acc[0][i][j][2 * h], v1 = acc[0][i][j][2 * h + 1];
        if constexpr (NP == 3) {
          v0 += acc[NP == 3 ? 1 : 0][i][j][2 * h];
          v1 += acc[NP == 3 ? 1 : 0][i][j][2 * h + 1];
        }
        if (pairs && c + 1 < n_total) {
          const float2 s = epi.pair(r, c, v0, v1);
          cs[j][0] += s.x;
          cs[j][1] += s.y;
        } else {
          if (c < n_total) cs[j][0] += epi(r, c, v0);
          if (c + 1 < n_total) cs[j][1] += epi(r, c + 1, v1);
        }
      }
    }
  if constexpr (Epi::kColSum) {
    // a warp's rows by shuffles, then the warps of the block in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = cs[j][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        cs[j][e] = s;
      }
    __syncthreads();  // the pipeline's shared memory is free again
    float* red = reinterpret_cast<float*>(smem_raw);  // [WM][BN]
    static_assert(C::WM * BN * 4 <= smem_bytes<T, kAKContig, kBKContig>(),
                  "reduction overflows");
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[wm * BN + wn0 + j * 8 + 2 * t + e] = cs[j][e];
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      if (n0 + c >= n_total) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < C::WM; ++w) s += red[w * BN + c];
      epi.partial[static_cast<long long>(blockIdx.y) * n_total + n0 + c] = s;
    }
  }
}

// true when p and every row start lie on 16 bytes
template <typename T>
inline bool aligned16(const T* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld * sizeof(T) % 16 == 0;
}

template <typename T, bool kAKContig, bool kBKContig, typename Epi>
cudaError_t launch(const T* a, long long lda, const T* b, long long ldb,
                   int m, int n, int k, int k_per_split, int splits, Epi epi,
                   cudaStream_t stream) {
  using C = Cfg<T>;
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<T, kAKContig, kBKContig>();
  static_assert(bytes <= kSmemLimit, "the stages overflow shared memory");
  auto kernel = mma_gemm_kernel<T, kAKContig, kBKContig, Epi>;
  // above 48 KB shared memory is asked for before a launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, bytes, stream>>>(
      a, lda, aligned16(a, lda), b, ldb, aligned16(b, ldb), m, n, k,
      k_per_split, epi.ldc % 2 == 0, epi);
  return cudaGetLastError();
}

// C = A.B into the epilogue
template <typename T, bool kAKContig, bool kBKContig, typename Epi>
cudaError_t gemm(const T* a, long long lda, const T* b, long long ldb, int m,
                 int n, int k, Epi epi, cudaStream_t stream) {
  return launch<T, kAKContig, kBKContig>(a, lda, b, ldb, m, n, k,
                                         k > 0 ? k : 1, 1, epi, stream);
}

// the splits of a weight-gradient product [m, n] over k rows and the steps
// of each: a function of (m, n, k) alone
template <typename T>
inline int split_count(int m, int n, int k, int* steps_per_split) {
  using C = Cfg<T>;
  const int tiles = ((m + C::BM - 1) / C::BM) * ((n + C::BN - 1) / C::BN);
  const int steps = (k + kDepth - 1) / kDepth;
  int want = (kSplitBlocks + tiles - 1) / tiles;
  if (want > kMaxSplits) want = kMaxSplits;
  if (want > steps / kMinSplitSteps) want = steps / kMinSplitSteps;
  if (want < 1) want = 1;
  const int per = (steps + want - 1) / want;
  *steps_per_split = per > 0 ? per : 1;
  return per > 0 ? (steps + per - 1) / per : 1;
}

// fp32 floats of split partials that a weight-gradient product needs
template <typename T>
inline long long split_floats(int m, int n, int k) {
  int per;
  const int splits = split_count<T>(m, n, k, &per);
  return splits > 1 ? static_cast<long long>(splits) * m * n : 0;
}

constexpr int kJoinThreads = 256;

__global__ void __launch_bounds__(kJoinThreads)
    split_join_kernel(const float* __restrict__ part, int splits,
                      long long count, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kJoinThreads +
                      threadIdx.x;
  if (i >= count) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[z * count + i];
  out[i] = s;
}

// out[m, n] (fp32, row stride n) = sum_k A(m, k) * B(k, n) with both
// operands i-contiguous: a weight gradient over k token rows.  With `part`
// (part_floats of scratch) K is cut into split_count splits whose partials
// one more launch joins in order; without, one split.
template <typename T>
cudaError_t gemm_wgrad(const T* a, long long lda, const T* b, long long ldb,
                       int m, int n, int k, float* out, float* part,
                       long long part_floats, cudaStream_t stream) {
  int per;
  const int splits = part != nullptr ? split_count<T>(m, n, k, &per) : 1;
  if (splits == 1)
    return tc::gemm<T, false, false>(a, lda, b, ldb, m, n, k,
                                     EpiF32{out, n}, stream);
  const long long count = static_cast<long long>(m) * n;
  if (part_floats < splits * count) return cudaErrorInvalidValue;
  cudaError_t err = launch<T, false, false>(
      a, lda, b, ldb, m, n, k, per * kDepth, splits,
      EpiPart{part, n, count}, stream);
  if (err != cudaSuccess) return err;
  split_join_kernel<<<static_cast<unsigned>((count + kJoinThreads - 1) /
                                            kJoinThreads),
                      kJoinThreads, 0, stream>>>(part, splits, count, out);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace mega
}  // namespace
