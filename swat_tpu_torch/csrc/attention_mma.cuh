// Building blocks of the attention templates for Hopper (sm_90a), shared by
// attention_fwd.cuh and attention_bwd.cuh: ldmatrix / mma.sync / cp.async
// wrappers, the exact split of an fp32 value into bf16 terms, the staging
// of the rows of one head into shared memory as bf16 planes, and the quad
// reductions of the mma accumulator layout.  It holds no kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>
#include <stdint.h>

// `amma` is inline: both templates name its members unqualified
namespace {
inline namespace amma {

constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use
constexpr int kSmemDefault = 49152;  // ... without asking for more

// bf16 planes an operand of type T is staged as
template <typename T>
struct Planes;
template <>
struct Planes<__nv_bfloat16> {
  static constexpr int n = 1;
};
template <>
struct Planes<float> {
  static constexpr int n = 3;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, from each matrix, the pair at row l / 4, columns
// 2 * (l % 4) and + 1 (transposed: rows 2 * (l % 4) and + 1, column l / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p))
      : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(shared_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// two fp32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float low_half(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float high_half(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// (x0, x1) as kTerms packed bf16 pairs whose sum is (x0, x1): each term is
// what is left of the value, rounded to bf16 (the subtraction is exact)
template <int kTerms>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&out)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    out[i] = pack_bf16(x0, x1);
    if (i + 1 < kTerms) {
      x0 -= low_half(out[i]);
      x1 -= high_half(out[i]);
    }
  }
}

// 8 consecutive elements of one row -> one 16-byte chunk of each plane
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static __device__ __forceinline__ void copy(__nv_bfloat16* dst, int,
                                              const __nv_bfloat16* src,
                                              bool vec) {
    if (vec) {
      cp_async_16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
  static __device__ __forceinline__ void zero(__nv_bfloat16* dst, int) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
};

template <>
struct Chunk<float> {
  static __device__ __forceinline__ void copy(__nv_bfloat16* dst,
                                              int plane_stride,
                                              const float* src, bool vec) {
    float x[8];
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = src[e];
    }
    uint32_t term[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair<3>(x[2 * i], x[2 * i + 1], term[i]);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(dst + pl * plane_stride) =
          make_uint4(term[0][pl], term[1][pl], term[2][pl], term[3][pl]);
  }
  static __device__ __forceinline__ void zero(__nv_bfloat16* dst,
                                              int plane_stride) {
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(dst + pl * plane_stride) =
          make_uint4(0u, 0u, 0u, 0u);
  }
};

// Rows [first, first + n_rows) of one head -> shared memory, by the whole
// block.  Row r lands at dst + r * (DP + 8) or, with kGroupRows (the q
// tiles, one group a warp), at dst + (r / kGroupRows) * group_stride +
// (r % kGroupRows) * (DP + 8); its planes lie plane_stride apart (elements);
// rows at or past `seq` and columns at or past head_dim read as zero.
// Consecutive threads take consecutive 16-byte chunks of a row.
template <typename T, int DP, int kGroupRows>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int group_stride,
                                           int plane_stride, const T* src,
                                           long long row_stride, int first,
                                           int n_rows, int seq, int head_dim,
                                           bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;
  // a thread keeps its chunk column and walks down the rows (a block's
  // threads are a multiple of 32, CH divides 8)
  const int c = (threadIdx.x % CH) * 8;
  const int row_step = blockDim.x / CH;
  const bool in_head = c < head_dim;
  int r = threadIdx.x / CH;
  const T* from = src + (first + r) * row_stride + c;
  const long long from_step = row_step * row_stride;
#pragma unroll 2
  for (; r < n_rows; r += row_step, from += from_step) {
    __nv_bfloat16* d =
        dst + c +
        (kGroupRows > 0 ? (r / kGroupRows) * group_stride +
                              (r % kGroupRows) * LD
                        : r * LD);
    if (in_head && first + r < seq)
      Chunk<T>::copy(d, plane_stride, from, vec);
    else
      Chunk<T>::zero(d, plane_stride);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the special-function unit (2 ulp; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_pair(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x0,
                                           float x1) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
}

// true when the view's base and its three strides are multiples of `bytes`
template <typename St>
inline bool aligned_to(const void* p, St st, size_t itemsize, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
         st.batch * itemsize % bytes == 0 && st.row * itemsize % bytes == 0 &&
         st.head * itemsize % bytes == 0;
}

}  // namespace amma
}  // namespace
