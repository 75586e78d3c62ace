// Attention forward for Hopper (sm_90a): the kernel template shared by the
// packed-head forward (mha_fwd.cu), the heads-first forward (flash_fwd.cu)
// and the two block-fused layer kernels that attend (megablock_fwd.cu,
// megablock_attn_bwd.cu).  Each source instantiates it with its own
// rounding mode and gives it its own strides; this header holds no entry
// point.
//
// It replaces the bodies of the Pallas TPU kernels
// swat_tpu/kernels/flash_attention.py::_mha_fwd_kernel (kRoundP = true) and
// ::_fwd_kernel (kRoundP = false).  Per (batch, head): s = q.k^T * scale
// with fp32 accumulation, keys at col >= S (and col > row when causal)
// masked out, fp32 softmax, p normalised with the FINAL row maximum and sum,
// then (kRoundP) rounded to the input dtype, out = p.v accumulated in fp32
// and rounded to the input dtype once.
//
// What bounds it on the card.  The CLIP towers attend over short sequences
// (S = 50 / 77 / 197 / 257, head dim 64): a call does about 25 operations
// for each byte it must move, far below the 295 at which the card's tensor
// cores, and not its memory, are the limit.  So the call is bytes-bound on
// paper, and the design's job is to keep everything else out of the way of
// the loads: the products go to the tensor cores, q.k^T is computed once,
// and every operand crosses device memory once per block in 16-byte
// accesses.
//
// Design:
//   * a warp owns a tile of 16 query rows; a block is the warps that cover
//     one (batch, head) or, for long S, an equal share of its row tiles;
//     grid (row-tile groups, H, B).  S = 50 is 4 warps with 14 idle rows;
//   * q, k and v of the head are staged ONCE per block into shared memory as
//     bf16, rows padded to DP + 8 elements (ldmatrix then reads 8 rows from
//     8 different bank groups), keys padded to a multiple of 16 and head
//     dims 8 to 16 with zeros.  bf16 inputs arrive by 16-byte cp.async
//     straight from the strided views (v in a second group that lands while
//     q.k^T runs); fp32 inputs by 16-byte loads, each value split on the way
//     into three bf16 terms hi + mid + lo (24 mantissa bits: the split is
//     exact) stored as three planes, k first and v in its place once q.k^T
//     is done;
//   * both products are mma.sync.m16n8k16 (bf16 in, fp32 out) fed by
//     ldmatrix.  bf16 operands map exactly (a product of two bf16 values is
//     exact in fp32).  fp32 stays full fp32: a product of two split
//     operands is the six cross terms of weight >= 2^-16 (hi.hi, hi.mid,
//     mid.hi, hi.lo, mid.mid, lo.hi), what is left out is below 2^-24 of
//     the product, an fp32 rounding; the leading term and the five
//     corrections have accumulators of their own, joined at the end;
//   * one pass over the keys: the scores stay in the mma accumulator
//     registers, 4 or 8 steps of 16 keys a warp (NT).  A row longer than
//     128 keys is shared by 2-4 warps, each with an equal run of its key
//     steps (kShared): they exchange their row maxima, then their row sums,
//     through shared memory, so every one of them normalises with the
//     FINAL statistics, and the first adds the others' partial outputs in a
//     fixed order.  Row maximum and sum by quad shuffles,
//     p = exp2((s - m) * scale * log2 e) * (1 / l), and the accumulator
//     layout of p is the A-operand layout of p.v, so p never moves between
//     threads.  kRoundP rounds p to bf16 as it is packed; the unrounded p of
//     the heads-first kernel goes in as two bf16 terms hi + lo (what is left
//     out is below 2^-16 of p, 2^-8 of the bf16 output's last bit), the
//     fp32 p as three;
//   * only the key tile that holds key S - 1 and, causal, the tile on the
//     diagonal test their keys against the mask; causal: a warp stops at
//     the tile that holds its last row, a block stages keys up to its last
//     row only;
//   * the output tile goes back through the tile's slice of the q staging
//     and leaves in 16-byte stores;
//   * q, k, v and o are strided views (batch, head and row stride in
//     elements, unit last stride), read and written in place.  The
//     16-byte accesses need base pointers and strides that are multiples of
//     16 bytes; `launch` checks that and otherwise has the kernel take
//     element-wise loads and stores, same arithmetic;
//   * shared memory bounds S: `plan_launch` picks the row tiles a block and
//     lets v take k's place when both do not fit; `launch` returns
//     cudaErrorInvalidValue when one row tile does not fit (fp32, head dim
//     64: S > 480).

#pragma once

#include "attention_mma.cuh"

// `afwd` is inline: a source that includes this header alone names its
// members unqualified; one that also includes attention_bwd.cuh (which
// defines some of the same names) qualifies them
namespace {
inline namespace afwd {

constexpr int kTile = 16;            // query rows a warp, keys a step
constexpr int kMaxWarps = 16;        // warps a block

// element strides of one [batch, head, row, D] view; D is contiguous
struct Strides {
  long long batch;
  long long row;
  long long head;
};

// The 16 x 16 tile q.k^T of one warp for keys [16 * step, 16 * step + 16),
// not yet scaled: s[h][e] is the accumulator element e of the 8-key half h,
// i.e. row lane / 4 + 8 * (e / 2), key 8 * h + 2 * (lane % 4) + e % 2; -inf
// where the key is masked (only the tile that holds key S - 1 and, causal,
// the tile on the diagonal have such keys: the others skip the test).
template <int NP, int DP>
__device__ __forceinline__ void score_tile(float (&s)[2][4],
                                           const uint32_t (&qa)[NP][DP / 16][4],
                                           const __nv_bfloat16* kbuf,
                                           int plane_stride, int step,
                                           int row0, int seq, bool causal,
                                           int lane) {
  constexpr int LD = DP + 8;
  float lead[2][4] = {}, corr[2][4] = {};
  const __nv_bfloat16* at =
      kbuf + (kTile * step + lane % 8 + 8 * (lane / 16)) * LD +
      8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t kb[NP][4];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
      ldmatrix_x4(kb[pl], at + pl * plane_stride + 16 * kk);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (i + j < NP) {
          float(&acc)[2][4] = i + j == 0 ? lead : corr;
          mma_bf16(acc[0], qa[i][kk], kb[j][0], kb[j][1]);
          mma_bf16(acc[1], qa[i][kk], kb[j][2], kb[j][3]);
        }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[h][e] = NP == 1 ? lead[h][e] : lead[h][e] + corr[h][e];
  const int last = kTile * step + kTile - 1;  // the tile's last key
  if (last >= seq || (causal && last > row0)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + lane / 4 + 8 * (e / 2);
        const int col = kTile * step + 8 * h + 2 * (lane % 4) + e % 2;
        if (col >= seq || (causal && col > row)) s[h][e] = -CUDART_INF_F;
      }
  }
}

// out += p . v for keys [16 * step, 16 * step + 16): p in the layout of
// score_tile, out[n] the accumulator of output columns [8 * n, 8 * n + 8).
// p goes in as NPP bf16 terms (1: rounded to bf16), v as its NP planes; the
// leading term accumulates into `lead`, the others into `corr` (with fp32
// inputs; else into `lead` too and `corr` stays untouched).
template <int NP, int NPP, int DP>
__device__ __forceinline__ void pv_tile(float (&lead)[DP / 8][4],
                                        float (&corr)[DP / 8][4],
                                        const float (&p)[2][4],
                                        const __nv_bfloat16* vbuf,
                                        int plane_stride, int step, int lane) {
  constexpr int LD = DP + 8;
  constexpr int kTerms = NPP > NP ? NPP : NP;
  uint32_t pa[NPP][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // a0: row g, keys 2t..; a1: row g + 8; a2, a3: the same, keys 8 + 2t..
    uint32_t term[NPP];
    split_pair<NPP>(p[r / 2][2 * (r % 2)], p[r / 2][2 * (r % 2) + 1], term);
#pragma unroll
    for (int i = 0; i < NPP; ++i) pa[i][r] = term[i];
  }
  const __nv_bfloat16* at =
      vbuf + (kTile * step + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
      8 * (lane / 16);
#pragma unroll
  for (int nn = 0; nn < DP / 16; ++nn) {
    uint32_t vb[NP][4];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
      ldmatrix_x4_trans(vb[pl], at + pl * plane_stride + 16 * nn);
#pragma unroll
    for (int i = 0; i < NPP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (i + j < kTerms) {
          float(&acc)[DP / 8][4] = (NP == 1 || i + j == 0) ? lead : corr;
          mma_bf16(acc[2 * nn], pa[i], vb[j][0], vb[j][1]);
          mma_bf16(acc[2 * nn + 1], pa[i], vb[j][2], vb[j][3]);
        }
  }
}

// T: the tensors' type.  DP: the head dim padded to 16 (head_dim itself is
// 8, 16, 32 or 64).  kRoundP: round the normalised p to T before p.v (the
// packed-head TPU kernel's rounding point); false keeps the fp32 p (the
// heads-first one's).  NT: steps of 16 keys whose scores a warp keeps in
// registers.  kShared: a row tile is shared by `parts` warps, each taking an
// equal run of its key steps (else a warp owns its tile and `parts` is 1).
// vec: every pointer and stride is a multiple of 16 bytes.  alias_v: v is
// staged over k once q.k^T is done.
// A block is at most 4 warps with NT = 4, 8 with NT = 8, kMaxWarps when
// shared; fp32 inputs are held to 128 registers a thread (their split
// terms would take 135-172, and the warps an SM then loses cost more than
// the 24-184 bytes a thread that spill: on an H100 at the text shape 0.84 ms
// unbounded against 0.42 ms, kernels/_ablate.py), bf16 inputs take 80-128
// unasked.
template <typename T, int DP, bool kRoundP, int NT, bool kShared>
__global__ void __launch_bounds__(
    kShared ? kMaxWarps * 32 : NT * 32,
    Planes<T>::n == 3 ? (kShared ? 1 : kMaxWarps / NT) : 0)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int seq,
                         int head_dim, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, int causal, int parts_arg,
                         int vec, int alias_v) {
  constexpr int NP = Planes<T>::n;
  const int parts = kShared ? parts_arg : 1;
  // terms p goes into p.v as: the rounded p is one bf16 value, the fp32 p
  // of bf16 inputs two, of fp32 inputs three
  constexpr int NPP = NP == 3 ? 3 : (kRoundP ? 1 : 2);
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tile = warp / parts, part = warp % parts;
  const int n_tiles = blockDim.x / 32 / parts;
  const int head = blockIdx.y, b = blockIdx.z;
  const int block_row0 = blockIdx.x * n_tiles * kTile;
  const int kv_cap = (seq + kTile - 1) / kTile * kTile;
  // keys this block reads: all of them, or up to its last row when causal
  const int kv_block =
      causal ? min(seq, block_row0 + n_tiles * kTile) : seq;
  const int kv_rows = (kv_block + kTile - 1) / kTile * kTile;

  // shared memory: q [tile][plane][16][LD], k [plane][kv_cap][LD], v the
  // same (or in k's place); with parts > 1 the row maxima and sums
  // [tile][part][16] of each part and the partial outputs
  // [tile][part - 1][DP / 8][lane] of all parts but the first
  const int q_tile = NP * kTile * LD, kv_plane = kv_cap * LD;
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kbuf = qbuf + n_tiles * q_tile;
  __nv_bfloat16* vbuf = alias_v ? kbuf : kbuf + NP * kv_plane;
  float* part_max = reinterpret_cast<float*>(vbuf + NP * kv_plane);
  float* part_sum = part_max + n_tiles * parts * kTile;
  float4* part_out =
      reinterpret_cast<float4*>(part_sum + n_tiles * parts * kTile);

  const T* qh = q + b * qs.batch + head * qs.head;
  const T* kh = k + b * ks.batch + head * ks.head;
  const T* vh = v + b * vs.batch + head * vs.head;

  stage_rows<T, DP, kTile>(qbuf, q_tile, kTile * LD, qh, qs.row, block_row0,
                           n_tiles * kTile, seq, head_dim, vec);
  stage_rows<T, DP, 0>(kbuf, 0, kv_plane, kh, ks.row, 0, kv_rows, seq,
                       head_dim, vec);
  cp_async_commit();
  if (!alias_v) {
    stage_rows<T, DP, 0>(vbuf, 0, kv_plane, vh, vs.row, 0, kv_rows, seq,
                         head_dim, vec);
    cp_async_commit();
    cp_async_wait<1>();  // q and k have landed, v may be on its way
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // this warp's rows, and its run of their key steps; a warp past the last
  // row, or with no step left for it, only stages and keeps the barriers
  const int row0 = block_row0 + tile * kTile;
  const bool live = row0 < seq;
  const int kv_tile = !live ? 0 : (causal ? min(seq, row0 + kTile) : seq);
  const int tile_steps = (kv_tile + kTile - 1) / kTile;
  const int per_part = (tile_steps + parts - 1) / parts;
  const int step0 = part * per_part;
  const int n_steps = max(0, min(per_part, tile_steps - step0));
  __nv_bfloat16* qw = qbuf + tile * q_tile;
  const int g = lane / 4;  // this thread's rows are g and g + 8
  float* my_max = part_max + (tile * parts + part) * kTile;
  float* my_sum = part_sum + (tile * parts + part) * kTile;

  // ---- s = q.k^T, masked; m = row max
  // exp(s * scale - m * scale) is taken as 2^(s * c - m * c): the scaling
  // rides in the exponent's multiply-add, and the maximum is taken first
  const float c = scale * 1.4426950408889634f;
  float sc[NT][2][4];
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (n_steps > 0) {
    uint32_t qa[NP][DP / 16][4];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldmatrix_x4(qa[pl][kk], qw + pl * kTile * LD +
                                    (lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                                    16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n_steps) {
        score_tile<NP, DP>(sc[i], qa, kbuf, kv_plane, step0 + i, row0, seq,
                           causal, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[i][h][e]);
      }
    }
    mx[0] = quad_max(mx[0]), mx[1] = quad_max(mx[1]);
  }
  if (parts > 1) {  // the row's maximum over all its parts
    if (lane % 4 == 0) my_max[g] = mx[0], my_max[g + 8] = mx[1];
    __syncthreads();
    for (int pt = 0; pt < parts; ++pt) {
      const float* theirs = part_max + (tile * parts + pt) * kTile;
      mx[0] = fmaxf(mx[0], theirs[g]), mx[1] = fmaxf(mx[1], theirs[g + 8]);
    }
  }

  // ---- p~ = exp((s - m) * scale); l = row sum
  float sum[2] = {0.f, 0.f};
  if (n_steps > 0) {
    mx[0] *= c, mx[1] *= c;
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
    sum[0] = quad_sum(sum[0]), sum[1] = quad_sum(sum[1]);
  }
  if (parts > 1 && lane % 4 == 0) my_sum[g] = sum[0], my_sum[g + 8] = sum[1];

  if (alias_v) {
    __syncthreads();  // every warp is done with k
    stage_rows<T, DP, 0>(vbuf, 0, kv_plane, vh, vs.row, 0, kv_rows, seq,
                         head_dim, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (parts > 1) {  // the row's sum, joined in one order by all its parts
    sum[0] = sum[1] = 0.f;
    for (int pt = 0; pt < parts; ++pt) {
      const float* theirs = part_sum + (tile * parts + pt) * kTile;
      sum[0] += theirs[g], sum[1] += theirs[g + 8];
    }
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};

  // ---- out = p.v with p = p~ / l (rounded to T under kRoundP)
  float lead[DP / 8][4] = {};
  float corr[DP / 8][4] = {};  // stays zero unless the inputs are fp32
  if (n_steps > 0) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n_steps) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][h][e] *= inv[e / 2];
        pv_tile<NP, NPP, DP>(lead, corr, sc[i], vbuf, kv_plane, step0 + i,
                             lane);
      }
    }
  }
  if constexpr (NP == 3) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) lead[n][e] += corr[n][e];
  }
  if (parts > 1) {  // the first part adds the others' outputs, in order
    float4* mine = part_out + ((tile * (parts - 1) + part - 1) * (DP / 8)) * 32;
    if (part > 0) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        mine[n * 32 + lane] =
            make_float4(lead[n][0], lead[n][1], lead[n][2], lead[n][3]);
    }
    __syncthreads();
    if (part == 0) {
      for (int pt = 1; pt < parts; ++pt) {
        const float4* theirs =
            part_out + ((tile * (parts - 1) + pt - 1) * (DP / 8)) * 32;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const float4 x = theirs[n * 32 + lane];
          lead[n][0] += x.x, lead[n][1] += x.y;
          lead[n][2] += x.z, lead[n][3] += x.w;
        }
      }
    }
  }
  if (!live || part > 0) return;

  // ---- out rows: registers -> the tile's q staging -> 16-byte stores
  T* ow = reinterpret_cast<T*>(qw);  // 16 x LD of T fits the NP bf16 planes
  static_assert(sizeof(T) <= 2 * NP, "output tile overflows the q staging");
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    store_pair(ow + g * LD + col, lead[n][0], lead[n][1]);
    store_pair(ow + (g + 8) * LD + col, lead[n][2], lead[n][3]);
  }
  __syncwarp();
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int chunks = head_dim / kPer;
  T* oh = o + b * os.batch + head * os.head;
  for (int i = lane; i < kTile * chunks; i += 32) {
    const int r = i / chunks, cc = (i % chunks) * kPer;
    if (row0 + r >= seq) continue;
    const T* from = ow + r * LD + cc;
    T* to = oh + (row0 + r) * os.row + cc;
    if (vec) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) to[e] = from[e];
    }
  }
}

// what a launch takes: the steps of 16 keys a warp keeps in registers (the
// kernel's NT), the warps that share a row tile, the row tiles a block,
// the blocks a (batch, head), whether v takes k's place, bytes of shared
// memory; tiles == 0: no fit
struct Plan {
  int nt;
  int parts;
  int tiles;
  int groups;
  int alias_v;
  int smem;
};

// A warp keeps at most 8 steps (128 keys) of scores, so a longer row is
// shared by ceil(steps / 8) warps.  Then the most row tiles a block that
// kMaxWarps and shared memory allow: every block stages the head's k and v
// anew.  bf16 inputs keep k and v side by side when that costs no extra
// block (v's cp.async lands while q.k^T runs); fp32 inputs, whose three
// planes take three times the room, let v follow k through one buffer,
// which doubles the blocks an SM holds (measured on an H100 at the B/32
// image shape by kernels/_ablate.py: 0.110 ms against 0.166 ms side by
// side).
inline Plan plan_launch(int seq, int planes, int dp) {
  const int steps = (seq + kTile - 1) / kTile, kv_cap = steps * kTile;
  const int ld = dp + 8;
  const int nt = steps <= 4 ? 4 : 8;
  const int parts = (steps + nt - 1) / nt;
  // a row tile's q planes, its parts' maxima and sums, their partial outputs
  const int per_tile = planes * kTile * ld * 2 +
                       (parts > 1 ? 2 * parts * kTile * 4 +
                                        (parts - 1) * (dp / 8) * 32 * 16
                                  : 0);
  const long long kv = 2LL * planes * kv_cap * ld;  // bytes of k, or of v
  Plan best{nt, parts, 0, 0, 0, 0};
  if (parts > kMaxWarps) return best;
  for (int pass = 0; pass < 2; ++pass) {
    const int alias_v = planes == 3 ? 1 - pass : pass;
    const long long room = kSmemLimit - (alias_v ? 1 : 2) * kv;
    if (room < per_tile) continue;
    const int fit = static_cast<int>(room / per_tile);
    const int most = fit < kMaxWarps / parts ? fit : kMaxWarps / parts;
    const int groups = (steps + most - 1) / most;
    if (best.tiles == 0 || groups < best.groups) {
      const int tiles = (steps + groups - 1) / groups;
      best = Plan{nt, parts, tiles, groups, alias_v,
                  static_cast<int>((alias_v ? 1 : 2) * kv + tiles * per_tile)};
    }
  }
  return best;
}

template <typename T, int DP, bool kRoundP, int NT, bool kShared>
cudaError_t launch_as(const Plan& plan, const T* q, const T* k, const T* v,
                      T* o, int batch, int seq, int heads, int head_dim,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, DP, kRoundP, NT, kShared>;
  static int granted = kSmemDefault;  // of this instantiation
  if (plan.smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
    granted = plan.smem;
  }
  const int vec = aligned_to(q, qs, sizeof(T), 16) &&
                  aligned_to(k, ks, sizeof(T), 16) &&
                  aligned_to(v, vs, sizeof(T), 16) &&
                  aligned_to(o, os, sizeof(T), 16);
  const dim3 grid(plan.groups, heads, batch);
  kernel<<<grid, plan.tiles * plan.parts * 32, plan.smem, stream>>>(
      q, k, v, o, seq, head_dim, qs, ks, vs, os, scale, causal, plan.parts,
      vec, plan.alias_v);
  return cudaGetLastError();
}

template <typename T, int DP, bool kRoundP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, T* o, int batch,
                      int seq, int heads, int head_dim, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, int causal,
                      cudaStream_t stream) {
  const Plan plan = plan_launch(seq, Planes<T>::n, DP);
  if (plan.tiles == 0) return cudaErrorInvalidValue;
  if (plan.nt == 4)
    return launch_as<T, DP, kRoundP, 4, false>(
        plan, q, k, v, o, batch, seq, heads, head_dim, qs, ks, vs, os, scale,
        causal, stream);
  if (plan.parts == 1)
    return launch_as<T, DP, kRoundP, 8, false>(
        plan, q, k, v, o, batch, seq, heads, head_dim, qs, ks, vs, os, scale,
        causal, stream);
  return launch_as<T, DP, kRoundP, 8, true>(
      plan, q, k, v, o, batch, seq, heads, head_dim, qs, ks, vs, os, scale,
      causal, stream);
}

template <typename T, bool kRoundP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq, int heads, int head_dim, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (head_dim) {
    case 8:
    case 16:
      return launch_dp<T, 16, kRoundP>(qp, kp, vp, op, batch, seq, heads,
                                       head_dim, qs, ks, vs, os, scale,
                                       causal, stream);
    case 32:
      return launch_dp<T, 32, kRoundP>(qp, kp, vp, op, batch, seq, heads,
                                       head_dim, qs, ks, vs, os, scale,
                                       causal, stream);
    case 64:
      return launch_dp<T, 64, kRoundP>(qp, kp, vp, op, batch, seq, heads,
                                       head_dim, qs, ks, vs, os, scale,
                                       causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace afwd
}  // namespace
