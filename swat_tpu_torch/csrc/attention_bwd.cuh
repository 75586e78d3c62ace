// Attention backward for Hopper (sm_90a): the kernel templates shared by
// the packed-head backward (mha_bwd.cu), the heads-first backward
// (flash_bwd.cu) and the block-fused attention backward
// (megablock_attn_bwd.cu).  Each source instantiates them with its own
// rounding mode and gives them its own strides; this header holds no entry
// point.
//
// It replaces the bodies of the Pallas TPU kernels
// swat_tpu/kernels/flash_attention.py::_mha_bwd_kernel (kRound = true) and
// ::_bwd_kernel (kRound = its keep_dtype).  Per (batch, head):
//   s  = q.k^T * scale in fp32, keys with col > row masked when causal;
//   p  = exp(s - m) / sum, fp32;        pb = p (rounded to T under kRound);
//   dv = pb^T . do;                     dp = do . v^T (fp32);
//   delta = rowsum(p * dp) with the fp32 p;
//   ds = p * (dp - delta) * scale, zero where masked (rounded to T under
//        kRound);
//   dq = ds . k;                        dk = ds^T . q;
// every product accumulated in fp32, each output rounded once to TOut.  q,
// k, v, do and dq, dk, dv are strided views (a batch, a head and a row
// stride each), so dq, dk and dv can be the three thirds of one
// [B, S, 3*H*D] gradient of the qkv projection, or [B, H, S, D] tensors of
// any dimension order.
//
// What bounds it on the card.  As the forward (attention_fwd.cuh), a call
// at the CLIP sequence lengths (S = 50 / 77 / 197 / 257, D = 64) does some
// 30-130 operations for each byte it must move, below the 295 at which the
// tensor cores and not the memory are the limit: it is bytes-bound on
// paper.  So the five products go to the tensor cores, the scores are
// computed as few times as the row length allows, and every operand crosses
// device memory in 16-byte accesses.
//
// Design.  All five products are mma.sync.m16n8k16 (bf16 in, fp32 out) fed
// by ldmatrix from bf16 planes in shared memory, as in the forward: bf16
// operands as they are, an fp32 operand as three exact terms hi + mid + lo
// and a product as the six cross terms of weight >= 2^-16, the leading one
// and the corrections in accumulators of their own (fp32 stays full fp32).
// p and ds go into their products as one bf16 term under kRound with bf16
// inputs (that IS the rounding point), as two (hi + lo) without kRound, as
// three with fp32 inputs.  A warp owns 16 rows; tiles are 16 x 16.
//
//   * S <= 128 (bf16) or 80 (fp32): one block a (batch, head), one warp a
//     row tile, ONE launch, no scratch (attention_bwd_head_kernel).  q, k,
//     v, do are staged once.  Phase 1, a warp owns 16 query rows: s for all
//     its keys stays in the accumulators (as in the forward), then m, l, p
//     with the final statistics; dp likewise; delta by quad shuffles; ds;
//     dq = ds.k straight from the accumulators (their layout is the A
//     operand's).  p and ds, rounded or split, go to an S x S exchange
//     buffer in shared memory (over k and v, which are done with, when it
//     fits there).  Phase 2, the same warp owns 16 KEY rows: it reads the
//     column of p and ds tiles of its keys transposed (ldmatrix.trans) and
//     sums dv = pb^T.do and dk = ds^T.q over the query tiles in order.  So
//     s and dp are computed once, each output has one owner, and there are
//     no atomics: two calls are bit-equal;
//   * longer rows (to 480): the scores of a row do not fit a warp's
//     registers, nor a head shared memory in fp32, so the work is split
//     into two kernels that each own their output rows and stream the
//     other side through shared memory in chunks of 64 rows.
//     attention_bwd_dq_kernel owns query rows: pass 1 takes m, l and
//     delta = sum(e * dp) / l in ONE online sweep over the keys, pass 2
//     recomputes s and dp for ds and dq; it stores m, 1 / l and delta in
//     fp32 scratch [3][B][H][S].  attention_bwd_dkv_kernel owns key rows:
//     it computes the transposed tiles s^T = k.q^T and dp^T = v.do^T, whose
//     accumulators are the A operand of dv += pb^T.do and dk += ds^T.q as
//     they stand.  s and dp three times in all (where the first version of
//     this header took four and three on the CUDA cores);
//   * only the key tile that holds key S - 1 and, causal, the tiles on the
//     diagonal test their keys against the mask; tiles wholly above the
//     diagonal are skipped.  Padded query rows have do = 0, hence dp = delta
//     = ds = 0 exactly, and add nothing to dk and dv;
//   * the outputs leave the accumulators in 4- or 8-byte stores (a quad
//     fills 16 or 32 contiguous bytes); views whose base or strides are not
//     multiples of 16 bytes are loaded element-wise, outputs that are not
//     multiples of a pair are stored so, same arithmetic.

#pragma once

#include "attention_mma.cuh"

// `abwd` is inline: see attention_fwd.cuh
namespace {
inline namespace abwd {

constexpr int kTile = 16;       // rows a warp, and the side of a score tile
constexpr int kLongWarps = 4;   // warps a block of the two long-row kernels
constexpr int kChunk = kLongWarps * kTile;  // rows they stream at a time
// the longest rows the one-block kernel takes (head dim 64 fills shared
// memory at these; kernels/flash_attention.py sizes the scratch by them)
constexpr int kHeadSeqBf16 = 128;
constexpr int kHeadSeqFp32 = 80;

// element strides of one [batch, head, row, D] view; D is contiguous
struct Strides {
  long long batch;
  long long row;
  long long head;
};

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

// terms p and ds go into their products as
template <typename T, bool kRound>
struct Terms {
  static constexpr int n = Planes<T>::n == 3 ? 3 : (kRound ? 1 : 2);
};

// The A operand (16 rows x DP) of a warp from rows staged at `rows` (row r
// at rows + r * (DP + 8), planes plane_stride apart).
template <int NP, int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[NP][DP / 16][4],
                                       const __nv_bfloat16* rows,
                                       int plane_stride, int lane) {
  constexpr int LD = DP + 8;
  const __nv_bfloat16* at =
      rows + (lane % 8 + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldmatrix_x4(a[pl][kk], at + pl * plane_stride + 16 * kk);
}

// c[16 x 16] = a . b^T for the 16 rows staged at `rows` (b's): c[h][e] is
// the accumulator element e of the 8-column half h, i.e. a's row
// lane / 4 + 8 * (e / 2), b's row 8 * h + 2 * (lane % 4) + e % 2.  With
// fp32 operands the six cross terms, leading one and corrections summed
// apart.
template <int NP, int DP>
__device__ __forceinline__ void mm_nt(float (&c)[2][4],
                                      const uint32_t (&a)[NP][DP / 16][4],
                                      const __nv_bfloat16* rows,
                                      int plane_stride, int lane) {
  constexpr int LD = DP + 8;
  float lead[2][4] = {}, corr[2][4] = {};
  const __nv_bfloat16* at =
      rows + (lane % 8 + 8 * (lane / 16)) * LD + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t b[NP][4];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
      ldmatrix_x4(b[pl], at + pl * plane_stride + 16 * kk);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (i + j < NP) {
          float(&acc)[2][4] = i + j == 0 ? lead : corr;
          mma_bf16(acc[0], a[i][kk], b[j][0], b[j][1]);
          mma_bf16(acc[1], a[i][kk], b[j][2], b[j][3]);
        }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[h][e] = NP == 1 ? lead[h][e] : lead[h][e] + corr[h][e];
}

// A 16 x 16 accumulator tile (the layout of mm_nt) as the A operand of the
// next product, in NA bf16 terms (1: rounded to bf16).
template <int NA>
__device__ __forceinline__ void to_a(uint32_t (&pa)[NA][4],
                                     const float (&x)[2][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // a0: row g, columns 2t..; a1: row g + 8; a2, a3: the same, columns 8 + 2t..
    uint32_t term[NA];
    split_pair<NA>(x[r / 2][2 * (r % 2)], x[r / 2][2 * (r % 2) + 1], term);
#pragma unroll
    for (int i = 0; i < NA; ++i) pa[i][r] = term[i];
  }
}

// acc[16 x DP] += a[16 x 16] . b for the 16 rows staged at `rows` (b's, DP
// wide): acc[n] holds columns [8 * n, 8 * n + 8).  a has NA terms, b NP
// planes; the leading term goes into `lead`, the others into `corr` (with
// fp32 inputs; else into `lead` too and `corr` stays untouched).
template <int NP, int NA, int DP>
__device__ __forceinline__ void mm_nn(float (&lead)[DP / 8][4],
                                      float (&corr)[DP / 8][4],
                                      const uint32_t (&pa)[NA][4],
                                      const __nv_bfloat16* rows,
                                      int plane_stride, int lane) {
  constexpr int LD = DP + 8;
  constexpr int kTerms = NA > NP ? NA : NP;
  const __nv_bfloat16* at =
      rows + (lane % 8 + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
#pragma unroll
  for (int nn = 0; nn < DP / 16; ++nn) {
    uint32_t b[NP][4];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
      ldmatrix_x4_trans(b[pl], at + pl * plane_stride + 16 * nn);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (i + j < kTerms) {
          float(&acc)[DP / 8][4] = (NP == 1 || i + j == 0) ? lead : corr;
          mma_bf16(acc[2 * nn], pa[i], b[j][0], b[j][1]);
          mma_bf16(acc[2 * nn + 1], pa[i], b[j][2], b[j][3]);
        }
  }
}

// -inf on the masked elements of the score tile of query rows from row0 and
// keys from col0 (keys at or past seq; causal: keys past the row); only a
// tile that holds such a key runs the test
__device__ __forceinline__ void mask_tile(float (&s)[2][4], int row0, int col0,
                                          int seq, bool causal, int lane) {
  const int last = col0 + kTile - 1;
  if (last >= seq || (causal && last > row0)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + lane / 4 + 8 * (e / 2);
        const int col = col0 + 8 * h + 2 * (lane % 4) + e % 2;
        if (col >= seq || (causal && col > row)) s[h][e] = -CUDART_INF_F;
      }
  }
}

// The accumulator tile of output rows [row0, row0 + 16) (lead + corr with
// fp32 inputs) -> one head's rows, rounded to TOut; rows at or past seq and
// columns at or past head_dim are left out.  pairs: two elements go in one
// store.
template <typename TOut, int NP, int DP>
__device__ __forceinline__ void store_tile(TOut* head, long long row_stride,
                                           int row0, int seq, int head_dim,
                                           const float (&lead)[DP / 8][4],
                                           const float (&corr)[DP / 8][4],
                                           int lane, bool pairs) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    if (col >= head_dim) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      if (row >= seq) continue;
      float x0 = lead[n][2 * half], x1 = lead[n][2 * half + 1];
      if (NP == 3) x0 += corr[n][2 * half], x1 += corr[n][2 * half + 1];
      TOut* to = head + row * row_stride + col;
      if (pairs) {
        store_pair(to, x0, x1);
      } else {
        to[0] = from_float<TOut>(x0);
        to[1] = from_float<TOut>(x1);
      }
    }
  }
}

// ---- rows that fit one block: dq, dk and dv of one (batch, head).
// T: the tensors' type.  DP: the head dim padded to 16.  kRound: round pb
// and ds to T, the rounding points of the TPU kernels that feed the matrix
// unit the input dtype; false keeps both in fp32.  TOut: the type dq, dk, dv
// are written in: T, or float for a caller that sums the fp32 gradients
// before it rounds them.  NT: the most row tiles (= warps = key steps whose
// scores a warp keeps in registers).  vec: every input pointer and stride
// is a multiple of 16 bytes.  pairs: every output one of two elements.
// alias: p and ds take k's and v's place.
template <typename T, int DP, bool kRound, typename TOut, int NT>
__global__ void __launch_bounds__(NT * 32)
    attention_bwd_head_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              TOut* __restrict__ dq, TOut* __restrict__ dk,
                              TOut* __restrict__ dv, int seq, int head_dim,
                              Strides qs, Strides ks, Strides vs, Strides dos,
                              Strides dqs, Strides dks, Strides dvs,
                              float scale, int causal, int vec, int pairs,
                              int alias) {
  constexpr int NP = Planes<T>::n;
  constexpr int NA = Terms<T, kRound>::n;
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int steps = blockDim.x / 32;  // row tiles = key tiles = warps
  const int head = blockIdx.y, b = blockIdx.z;
  const int s_pad = steps * kTile;
  const int g = lane / 4, t = lane % 4;

  // shared memory: q, k, v, do [plane][s_pad][LD] each, then (or over k and
  // v) p and ds [term][s_pad][LDX]
  const int plane = s_pad * LD;
  const int LDX = s_pad + 8, xplane = s_pad * LDX;
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kbuf = qbuf + NP * plane;
  __nv_bfloat16* vbuf = kbuf + NP * plane;
  __nv_bfloat16* dobuf = vbuf + NP * plane;
  __nv_bfloat16* xp = alias ? kbuf : dobuf + NP * plane;
  __nv_bfloat16* xds = alias ? vbuf : xp + NA * xplane;

  stage_rows<T, DP, 0>(qbuf, 0, plane, q + b * qs.batch + head * qs.head,
                       qs.row, 0, s_pad, seq, head_dim, vec);
  stage_rows<T, DP, 0>(kbuf, 0, plane, k + b * ks.batch + head * ks.head,
                       ks.row, 0, s_pad, seq, head_dim, vec);
  cp_async_commit();
  stage_rows<T, DP, 0>(dobuf, 0, plane,
                       dout + b * dos.batch + head * dos.head, dos.row, 0,
                       s_pad, seq, head_dim, vec);
  stage_rows<T, DP, 0>(vbuf, 0, plane, v + b * vs.batch + head * vs.head,
                       vs.row, 0, s_pad, seq, head_dim, vec);
  cp_async_commit();
  cp_async_wait<1>();  // q and k have landed, do and v may be on their way
  __syncthreads();

  // ---- phase 1: this warp's 16 query rows against the key tiles they
  // attend to (causal: up to the diagonal)
  const int row0 = warp * kTile;
  const int n_steps = causal ? warp + 1 : steps;
  const float c = scale * 1.4426950408889634f;
  uint32_t a[NP][DP / 16][4];
  float sc[NT][2][4];  // s, then p
  float dp[NT][2][4];  // dp, then ds
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  load_a<NP, DP>(a, qbuf + row0 * LD, plane, lane);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < n_steps) {
      mm_nt<NP, DP>(sc[i], a, kbuf + i * kTile * LD, plane, lane);
      mask_tile(sc[i], row0, i * kTile, seq, causal, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[i][h][e]);
    }
  }
  // exp(s * scale - m * scale) is taken as 2^(s * c - m * c)
  mx[0] = quad_max(mx[0]) * c, mx[1] = quad_max(mx[1]) * c;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < n_steps) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[i][h][e] = exp2_approx(fmaf(sc[i][h][e], c, -mx[e / 2]));
          sum[e / 2] += sc[i][h][e];
        }
    }
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

  cp_async_wait<0>();
  __syncthreads();  // do and v have landed
  // ---- dp = do.v^T, delta = rowsum(p * dp) with the fp32 p
  float delta[2] = {0.f, 0.f};
  load_a<NP, DP>(a, dobuf + row0 * LD, plane, lane);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < n_steps) {
      mm_nt<NP, DP>(dp[i], a, vbuf + i * kTile * LD, plane, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[i][h][e] *= inv[e / 2];
          delta[e / 2] = fmaf(sc[i][h][e], dp[i][h][e], delta[e / 2]);
        }
    }
  }
  delta[0] = quad_sum(delta[0]), delta[1] = quad_sum(delta[1]);

  // ---- ds = p * (dp - delta) * scale (p, hence ds, is 0 where masked);
  // dq = ds.k
  float lead[DP / 8][4] = {};
  float corr[DP / 8][4] = {};  // stays zero unless the inputs are fp32
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < n_steps) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[i][h][e] = sc[i][h][e] * (dp[i][h][e] - delta[e / 2]) * scale;
      uint32_t pa[NA][4];
      to_a<NA>(pa, dp[i]);
      mm_nn<NP, NA, DP>(lead, corr, pa, kbuf + i * kTile * LD, plane, lane);
    }
  }
  store_tile<TOut, NP, DP>(dq + b * dqs.batch + head * dqs.head, dqs.row, row0,
                           seq, head_dim, lead, corr, lane, pairs);

  // ---- p and ds, as the terms they enter dv and dk in, to the exchange
  // buffer [query][key]
  __syncthreads();  // every warp is done with k and v (alias)
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < n_steps) {
      uint32_t pa[NA][4], da[NA][4];
      to_a<NA>(pa, sc[i]);
      to_a<NA>(da, dp[i]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = (row0 + g + 8 * (r % 2)) * LDX + i * kTile +
                       8 * (r / 2) + 2 * t;
#pragma unroll
        for (int pl = 0; pl < NA; ++pl) {
          *reinterpret_cast<uint32_t*>(xp + pl * xplane + at) = pa[pl][r];
          *reinterpret_cast<uint32_t*>(xds + pl * xplane + at) = da[pl][r];
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: this warp's 16 key rows; dv = sum over the query tiles of
  // pb^T.do, dk of ds^T.q, in order (causal: from the diagonal on)
  const int key0 = warp * kTile;
  const int first = causal ? warp : 0;
  // the transposed 16 x 16 tile (keys x queries) of query tile i
  const int xat = (lane % 8 + 8 * (lane / 16)) * LDX + key0 +
                  8 * ((lane / 8) % 2);
#pragma unroll
  for (int out = 0; out < 2; ++out) {
    const __nv_bfloat16* xbuf = out == 0 ? xp : xds;
    const __nv_bfloat16* rows = out == 0 ? dobuf : qbuf;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) lead[n][e] = corr[n][e] = 0.f;
    for (int i = first; i < steps; ++i) {
      uint32_t pa[NA][4];
#pragma unroll
      for (int pl = 0; pl < NA; ++pl)
        ldmatrix_x4_trans(pa[pl], xbuf + pl * xplane + i * kTile * LDX + xat);
      mm_nn<NP, NA, DP>(lead, corr, pa, rows + i * kTile * LD, plane, lane);
    }
    if (out == 0)
      store_tile<TOut, NP, DP>(dv + b * dvs.batch + head * dvs.head, dvs.row,
                               key0, seq, head_dim, lead, corr, lane, pairs);
    else
      store_tile<TOut, NP, DP>(dk + b * dks.batch + head * dks.head, dks.row,
                               key0, seq, head_dim, lead, corr, lane, pairs);
  }
}

// ---- longer rows, kernel A: dq of kChunk query rows a block, and their
// statistics m * scale * log2 e, 1 / l and delta into `stats`
// [3][B][H][S].  k and v stream through shared memory in chunks of kChunk
// keys, twice: pass 0 takes m, l and sum(e * dp) in one online sweep, pass 1
// recomputes s and dp for ds and dq.
template <typename T, int DP, bool kRound, typename TOut>
__global__ void __launch_bounds__(kLongWarps * 32)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout, TOut* __restrict__ dq,
                            float* __restrict__ stats, int heads, int seq,
                            int head_dim, Strides qs, Strides ks, Strides vs,
                            Strides dos, Strides dqs, float scale, int causal,
                            int vec, int pairs) {
  constexpr int NP = Planes<T>::n;
  constexpr int NA = Terms<T, kRound>::n;
  constexpr int LD = DP + 8;
  constexpr int plane = kChunk * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dobuf = qbuf + NP * plane;
  __nv_bfloat16* kbuf = dobuf + NP * plane;
  __nv_bfloat16* vbuf = kbuf + NP * plane;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int head = blockIdx.y, b = blockIdx.z;
  const int block_row0 = blockIdx.x * kChunk;
  const int row0 = block_row0 + warp * kTile;
  const int g = lane / 4;
  const T* kh = k + b * ks.batch + head * ks.head;
  const T* vh = v + b * vs.batch + head * vs.head;
  // keys this block reads and keys this warp's rows attend to
  const int kv_block = causal ? min(seq, block_row0 + kChunk) : seq;
  const int kv_warp = row0 >= seq ? 0 : (causal ? min(seq, row0 + kTile) : seq);

  stage_rows<T, DP, 0>(qbuf, 0, plane, q + b * qs.batch + head * qs.head,
                       qs.row, block_row0, kChunk, seq, head_dim, vec);
  stage_rows<T, DP, 0>(dobuf, 0, plane,
                       dout + b * dos.batch + head * dos.head, dos.row,
                       block_row0, kChunk, seq, head_dim, vec);

  const float c = scale * 1.4426950408889634f;
  // per thread and row (g, g + 8): the running maximum (scaled by c) and the
  // thread's share of l and of sum(e * dp); after pass 0 the row's m, 1 / l
  // and delta
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float lead[DP / 8][4] = {};
  float corr[DP / 8][4] = {};  // stays zero unless the inputs are fp32
  for (int pass = 0; pass < 2; ++pass) {
    for (int key0 = 0; key0 < kv_block; key0 += kChunk) {
      __syncthreads();  // the chunk before this one has been read
      stage_rows<T, DP, 0>(kbuf, 0, plane, kh, ks.row, key0, kChunk, seq,
                           head_dim, vec);
      stage_rows<T, DP, 0>(vbuf, 0, plane, vh, vs.row, key0, kChunk, seq,
                           head_dim, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int i = 0; i < kLongWarps && key0 + i * kTile < kv_warp; ++i) {
        uint32_t a[NP][DP / 16][4];
        float s[2][4], dp[2][4];
        load_a<NP, DP>(a, qbuf + warp * kTile * LD, plane, lane);
        mm_nt<NP, DP>(s, a, kbuf + i * kTile * LD, plane, lane);
        mask_tile(s, row0, key0 + i * kTile, seq, causal, lane);
        load_a<NP, DP>(a, dobuf + warp * kTile * LD, plane, lane);
        mm_nt<NP, DP>(dp, a, vbuf + i * kTile * LD, plane, lane);
        if (pass == 0) {
          float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[h][e]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // every row has key 0 unmasked in its first tile: m is finite
            // from there on
            const float m_new = fmaxf(m[r], quad_max(mx[r]) * c);
            const float shrink = exp2_approx(m[r] - m_new);
            l[r] *= shrink, delta[r] *= shrink, m[r] = m_new;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ex = exp2_approx(fmaf(s[h][e], c, -m[e / 2]));
              l[e / 2] += ex;
              delta[e / 2] = fmaf(ex, dp[h][e], delta[e / 2]);
            }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p =
                  exp2_approx(fmaf(s[h][e], c, -m[e / 2])) * l[e / 2];
              dp[h][e] = p * (dp[h][e] - delta[e / 2]) * scale;
            }
          uint32_t pa[NA][4];
          to_a<NA>(pa, dp);
          mm_nn<NP, NA, DP>(lead, corr, pa, kbuf + i * kTile * LD, plane,
                            lane);
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = 1.f / quad_sum(l[r]);
        delta[r] = quad_sum(delta[r]) * l[r];
      }
    }
  }
  store_tile<TOut, NP, DP>(dq + b * dqs.batch + head * dqs.head, dqs.row, row0,
                           seq, head_dim, lead, corr, lane, pairs);
  if (lane % 4 == 0) {
    const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
    float* mine = stats + (static_cast<long long>(b) * heads + head) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < seq) {
        mine[row] = m[r];
        mine[bhs + row] = l[r];
        mine[2 * bhs + row] = delta[r];
      }
    }
  }
}

// ---- longer rows, kernel B: dk and dv of kChunk key rows a block, from the
// statistics kernel A stored.  q and do stream through shared memory in
// chunks of kChunk query rows (causal: from the block's first key on); a
// warp computes the transposed tiles s^T = k.q^T and dp^T = v.do^T of its 16
// keys, whose accumulators are the A operand of dv += pb^T.do and
// dk += ds^T.q.
template <typename T, int DP, bool kRound, typename TOut>
__global__ void __launch_bounds__(kLongWarps * 32)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             TOut* __restrict__ dk, TOut* __restrict__ dv,
                             const float* __restrict__ stats, int heads,
                             int seq, int head_dim, Strides qs, Strides ks,
                             Strides vs, Strides dos, Strides dks, Strides dvs,
                             float scale, int causal, int vec, int pairs) {
  constexpr int NP = Planes<T>::n;
  constexpr int NA = Terms<T, kRound>::n;
  constexpr int LD = DP + 8;
  constexpr int plane = kChunk * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vbuf = kbuf + NP * plane;
  __nv_bfloat16* qbuf = vbuf + NP * plane;
  __nv_bfloat16* dobuf = qbuf + NP * plane;
  float* row_stats = reinterpret_cast<float*>(dobuf + NP * plane);  // [3][kChunk]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int head = blockIdx.y, b = blockIdx.z;
  const int block_key0 = blockIdx.x * kChunk;
  const int key0 = block_key0 + warp * kTile;
  const int g = lane / 4, t = lane % 4;
  const T* qh = q + b * qs.batch + head * qs.head;
  const T* doh = dout + b * dos.batch + head * dos.head;
  const long long bhs = static_cast<long long>(gridDim.z) * heads * seq;
  const float* head_stats =
      stats + (static_cast<long long>(b) * heads + head) * seq;

  stage_rows<T, DP, 0>(kbuf, 0, plane, k + b * ks.batch + head * ks.head,
                       ks.row, block_key0, kChunk, seq, head_dim, vec);
  stage_rows<T, DP, 0>(vbuf, 0, plane, v + b * vs.batch + head * vs.head,
                       vs.row, block_key0, kChunk, seq, head_dim, vec);

  const float c = scale * 1.4426950408889634f;
  float dv_lead[DP / 8][4] = {}, dk_lead[DP / 8][4] = {};
  float dv_corr[DP / 8][4] = {}, dk_corr[DP / 8][4] = {};  // fp32 inputs only
  for (int q0 = causal ? block_key0 : 0; q0 < seq; q0 += kChunk) {
    __syncthreads();  // the chunk before this one has been read
    stage_rows<T, DP, 0>(qbuf, 0, plane, qh, qs.row, q0, kChunk, seq,
                         head_dim, vec);
    stage_rows<T, DP, 0>(dobuf, 0, plane, doh, dos.row, q0, kChunk, seq,
                         head_dim, vec);
    cp_async_commit();
    // a padded query row: p = 1, delta = 0 (its do is 0, so it adds nothing)
    for (int i = threadIdx.x; i < 3 * kChunk; i += blockDim.x) {
      const int row = q0 + i % kChunk, what = i / kChunk;
      row_stats[i] = row < seq ? head_stats[what * bhs + row]
                               : (what == 1 ? 1.f : 0.f);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (key0 >= seq) continue;  // a warp past the last key only stages
    for (int i = 0; i < kLongWarps && q0 + i * kTile < seq; ++i) {
      const int qt0 = q0 + i * kTile;  // the tile's first query row
      if (causal && qt0 + kTile - 1 < key0) continue;  // wholly masked
      uint32_t a[NP][DP / 16][4];
      float st[2][4], dpt[2][4];  // [keys x queries]
      load_a<NP, DP>(a, kbuf + warp * kTile * LD, plane, lane);
      mm_nt<NP, DP>(st, a, qbuf + i * kTile * LD, plane, lane);
      load_a<NP, DP>(a, vbuf + warp * kTile * LD, plane, lane);
      mm_nt<NP, DP>(dpt, a, dobuf + i * kTile * LD, plane, lane);
      const bool diagonal = causal && qt0 < key0 + kTile - 1;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = i * kTile + 8 * h + 2 * t + e % 2;  // query in chunk
          const float p =
              diagonal && q0 + col < key0 + g + 8 * (e / 2)
                  ? 0.f
                  : exp2_approx(fmaf(st[h][e], c, -row_stats[col])) *
                        row_stats[kChunk + col];
          st[h][e] = p;
          dpt[h][e] = p * (dpt[h][e] - row_stats[2 * kChunk + col]) * scale;
        }
      uint32_t pa[NA][4];
      to_a<NA>(pa, st);
      mm_nn<NP, NA, DP>(dv_lead, dv_corr, pa, dobuf + i * kTile * LD, plane,
                        lane);
      to_a<NA>(pa, dpt);
      mm_nn<NP, NA, DP>(dk_lead, dk_corr, pa, qbuf + i * kTile * LD, plane,
                        lane);
    }
  }
  store_tile<TOut, NP, DP>(dv + b * dvs.batch + head * dvs.head, dvs.row, key0,
                           seq, head_dim, dv_lead, dv_corr, lane, pairs);
  store_tile<TOut, NP, DP>(dk + b * dks.batch + head * dks.head, dks.row, key0,
                           seq, head_dim, dk_lead, dk_corr, lane, pairs);
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float* stats;  // fp32 scratch [3][B][H][S]; unused where one block takes a head
  int batch, seq, heads;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
  int causal;
};

// true when rows of `seq` go through the one-block kernel (no scratch)
template <typename T>
inline bool one_block(int seq) {
  return seq <= (Planes<T>::n == 3 ? kHeadSeqFp32 : kHeadSeqBf16);
}

// raises the dynamic shared memory an instantiation may use, once
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <typename T, int DP, bool kRound, typename TOut, int NT>
cudaError_t launch_head(const Args& a, int head_dim, int vec, int pairs,
                        cudaStream_t stream) {
  constexpr int NP = Planes<T>::n, NA = Terms<T, kRound>::n, LD = DP + 8;
  const int steps = (a.seq + kTile - 1) / kTile, s_pad = steps * kTile;
  // p and ds take k's and v's place when a row of theirs is no longer
  const int alias = NA * (s_pad + 8) <= NP * LD;
  const int smem = 2 * (4 * NP * s_pad * LD +
                        (alias ? 0 : 2 * NA * s_pad * (s_pad + 8)));
  auto kernel = attention_bwd_head_kernel<T, DP, kRound, TOut, NT>;
  static int granted = kSmemDefault;  // of this instantiation
  const cudaError_t err = grant_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1, a.heads, a.batch), steps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<TOut*>(a.dq), static_cast<TOut*>(a.dk),
      static_cast<TOut*>(a.dv), a.seq, head_dim, a.qs, a.ks, a.vs, a.dos,
      a.dqs, a.dks, a.dvs, a.scale, a.causal, vec, pairs, alias);
  return cudaGetLastError();
}

template <typename T, int DP, bool kRound, typename TOut>
cudaError_t launch_long(const Args& a, int head_dim, int vec, int pairs,
                        cudaStream_t stream) {
  if (a.stats == nullptr) return cudaErrorInvalidValue;
  constexpr int NP = Planes<T>::n, LD = DP + 8;
  constexpr int smem_a = 2 * 4 * NP * kChunk * LD;
  constexpr int smem_b = smem_a + 3 * kChunk * 4;
  auto kernel_a = attention_bwd_dq_kernel<T, DP, kRound, TOut>;
  auto kernel_b = attention_bwd_dkv_kernel<T, DP, kRound, TOut>;
  static int granted_a = kSmemDefault, granted_b = kSmemDefault;
  cudaError_t err = grant_smem(kernel_a, smem_a, granted_a);
  if (err != cudaSuccess) return err;
  err = grant_smem(kernel_b, smem_b, granted_b);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kChunk - 1) / kChunk, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  kernel_a<<<grid, kLongWarps * 32, smem_a, stream>>>(
      q, k, v, dout, static_cast<TOut*>(a.dq), a.stats, a.heads, a.seq,
      head_dim, a.qs, a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal, vec, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel_b<<<grid, kLongWarps * 32, smem_b, stream>>>(
      q, k, v, dout, static_cast<TOut*>(a.dk), static_cast<TOut*>(a.dv),
      a.stats, a.heads, a.seq, head_dim, a.qs, a.ks, a.vs, a.dos, a.dks,
      a.dvs, a.scale, a.causal, vec, pairs);
  return cudaGetLastError();
}

template <typename T, int DP, bool kRound, typename TOut>
cudaError_t launch_dp(const Args& a, int head_dim, cudaStream_t stream) {
  const int vec = aligned_to(a.q, a.qs, sizeof(T), 16) &&
                  aligned_to(a.k, a.ks, sizeof(T), 16) &&
                  aligned_to(a.v, a.vs, sizeof(T), 16) &&
                  aligned_to(a.dout, a.dos, sizeof(T), 16);
  const int pairs = aligned_to(a.dq, a.dqs, sizeof(TOut), 2 * sizeof(TOut)) &&
                    aligned_to(a.dk, a.dks, sizeof(TOut), 2 * sizeof(TOut)) &&
                    aligned_to(a.dv, a.dvs, sizeof(TOut), 2 * sizeof(TOut));
  if (!one_block<T>(a.seq))
    return launch_long<T, DP, kRound, TOut>(a, head_dim, vec, pairs, stream);
  if (a.seq <= 4 * kTile)
    return launch_head<T, DP, kRound, TOut, 4>(a, head_dim, vec, pairs, stream);
  if (a.seq <= 5 * kTile)
    return launch_head<T, DP, kRound, TOut, 5>(a, head_dim, vec, pairs, stream);
  if constexpr (Planes<T>::n == 1)
    return launch_head<T, DP, kRound, TOut, 8>(a, head_dim, vec, pairs, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool kRound, typename TOut = T>
cudaError_t launch(const Args& a, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 8:
    case 16:
      return launch_dp<T, 16, kRound, TOut>(a, head_dim, stream);
    case 32:
      return launch_dp<T, 32, kRound, TOut>(a, head_dim, stream);
    case 64:
      return launch_dp<T, 64, kRound, TOut>(a, head_dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace abwd
}  // namespace
