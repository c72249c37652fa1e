// float32 products on the tensor cores as 3xTF32, for the float32 attention
// kernels (K2 in mha_bwd.cu; K7, K9 and K8 in flash_attn.cu): mma.sync
// m16n8k8 with tf32 operands and float32 accumulation, the split of a
// float32 operand into two tf32 halves, and the cp.async staging, A-fragment
// loads, products and stores over float32 rows staged with pitch HD + 4.
//
// What it computes. A float32 x splits into big = tf32(x), rounded to
// nearest with ties away from zero (tf32_rna), and small = x - big, which is
// exact in float32 and which the tensor core reads truncated to tf32 (it
// ignores an operand's 13 low bits), so x = big + small to within 2^-21 |x|
// (rounding small too would make it 2^-22, for two more instructions an
// element). A product a * b is taken as a_small * b_big + a_big *
// b_small + a_big * b_big, the two correction terms first (the order of
// CUTLASS's OpMultiplyAddFastF32), each product exact in the tensor core
// and summed in float32. What is dropped is a_small * b_small (~2^-22 |a b|)
// and the halves' truncation (~2^-21 each), so a sum of k products lands
// within a few units of 2^-22 of the sum of |a b| of its float32 result,
// against the 2^-11 of one tf32 product. A sum's order inside the tensor
// core is the hardware's, not the CUDA cores' left-to-right one.
//
// Fragment layout of mma.sync m16n8k8 tf32 (lane = 4 * g + tq): A holds
// rows g and g + 8 of columns tq and tq + 4 (a0 = (g, tq), a1 = (g + 8, tq),
// a2 = (g, tq + 4), a3 = (g + 8, tq + 4)); B holds column g of rows tq and
// tq + 4; C holds rows g and g + 8 of columns 2tq and 2tq + 1 (c0 = (g, 2tq),
// c1 = (g, 2tq + 1), c2 = (g + 8, 2tq), c3 = (g + 8, 2tq + 1)).
//
// A C tile is the A operand of a next product without a shuffle when the
// reduction index is permuted: C column 2tq serves as A column tq and 2tq + 1
// as tq + 4 (a = {c0, c2, c1, c3}), and B's rows are read in the same
// permuted order (b0 from row 2tq, b1 from row 2tq + 1). A sum over k is the
// same under any permutation applied to both operands.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"  // cp.async

namespace {

// x rounded to tf32, nearest with ties away from zero, with the 13 bits
// below tf32's mantissa cleared: half a tf32 unit added to the magnitude
// bits, a carry into the exponent rounding up (to infinity past the largest
// float, as cvt.rna.tf32.f32 does). The same bits as cvt.rna for every input
// but a NaN's payload, in two integer instructions; on sm_90 cvt.rna
// compiles to several, which made the splits most of a tile's work
// (-DTHEIA_TF32_CVT_RNA builds cvt.rna instead, to time it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
#ifdef THEIA_TF32_CVT_RNA
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
#else
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
}

// x = big + small + O(2^-21 |x|): big = tf32(x); small = x - big, exact in
// float32, is passed as it is, and the tensor core reads it truncated to
// tf32 (it ignores an operand's 13 low bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&big)[N], uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// d += a * b for one m16n8k8 tile of tf32 operands. Not volatile: it has no
// effect but its outputs, so the compiler may interleave independent ones.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the correction terms, then big * big. kSmallAFirst
// false issues a_big * b_small before a_small * b_big, so that a product
// taken transposed (A and B swapped) adds the same terms in the same order.
template <bool kSmallAFirst = true>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2], const uint32_t (&b_small)[2]) {
  if (kSmallAFirst) {
    mma_tf32_1688(d, a_small, b_big[0], b_big[1]);
    mma_tf32_1688(d, a_big, b_small[0], b_small[1]);
  } else {
    mma_tf32_1688(d, a_big, b_small[0], b_small[1]);
    mma_tf32_1688(d, a_small, b_big[0], b_big[1]);
  }
  mma_tf32_1688(d, a_big, b_big[0], b_big[1]);
}

// B fragments of a float32 tensor staged in shared memory with row pitch P,
// split into tf32 halves:
//   rows: B[k][n] = x[(row0 + n) * P + col0 + k] (b0 at row g, column tq);
//   cols: B[k][n] = x[(row0 + perm(k)) * P + col0 + n], k permuted as a C
//         tile's columns are when that tile is an A operand (b0 at row 2tq,
//         b1 at row 2tq + 1, column g).
// With P = 4 mod 16 (and P = 4 or 20 mod 32 for `rows`) both read 32
// distinct banks.
template <int P>
__device__ __forceinline__ void b_rows(const float* x, int row0, int col0, uint32_t (&big)[2], uint32_t (&small)[2]) {
  const int lane = threadIdx.x & 31;
  const float* p = x + (row0 + (lane >> 2)) * P + col0 + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

template <int P>
__device__ __forceinline__ void b_cols(const float* x, int row0, int col0, uint32_t (&big)[2], uint32_t (&small)[2]) {
  const int lane = threadIdx.x & 31;
  const float* p = x + (row0 + 2 * (lane & 3)) * P + col0 + (lane >> 2);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[P], big[1], small[1]);
}

// A C tile (one m16n8 accumulator) as the A operand of the next product,
// with the permuted reduction index above, split into tf32 halves.
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_tf32(a, big, small);
}

// Copy `rows` token rows of a slab (row r at src + r * stride) into shared
// rows of pitch HD + 4 with cp.async, as one commit group; rows from T up to
// `rows` become zeros.
template <int HD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int64_t stride, int t, int rows) {
  constexpr int kVecs = HD / 4;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    float* d = dst + r * (HD + 4) + c;
    if (r < t) {
      cp_async16(d, src + r * stride + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_commit();
}

// The A fragment of rows r0 .. r0 + 15 of a slab (token stride ts) at
// columns col .. col + 7, from global memory; rows past T are zeros.
__device__ __forceinline__ void load_a_f32(float (&a)[4], const float* x, int64_t ts, int r0, int t, int col) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
  const float* pa = x + ra * ts + col + (lane & 3);
  const float* pb = x + rb * ts + col + (lane & 3);
  a[0] = ra < t ? pa[0] : 0.f;
  a[1] = rb < t ? pb[0] : 0.f;
  a[2] = ra < t ? pa[4] : 0.f;
  a[3] = rb < t ? pb[4] : 0.f;
}

// The A operand of an HD-deep product over rows r0 .. r0 + 15 of a slab,
// read once from global memory and kept as float32 (HD / 2 registers a
// thread), split into tf32 halves at each use (three instructions an
// element, which costs less than the registers the halves would hold).
template <int HD>
struct RowsA {
  float raw[HD / 8][4];

  __device__ __forceinline__ void load(const float* x, int64_t ts, int r0, int t) {
#pragma unroll
    for (int s = 0; s < HD / 8; ++s) load_a_f32(raw[s], x, ts, r0, t, 8 * s);
  }
};

// c (an 8-column tile) = A times rows n*8 .. n*8 + 7 of a staged [.][HD + 4]
// tensor, transposed: C[i][j] = sum_d A[i][d] X[n*8 + j][d].
template <bool kSmallAFirst, int HD>
__device__ __forceinline__ void mma_rows_f32(float (&c)[4], const RowsA<HD>& a, const float* xs, int n) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
    split_tf32(a.raw[s], a_big, a_small);
    b_rows<HD + 4>(xs, 8 * n, 8 * s, b_big, b_small);
    mma_3xtf32<kSmallAFirst>(c, a_big, a_small, b_big, b_small);
  }
}

// acc[HD / 8 tiles] += C (a 16 x 8 accumulator tile over rows n*8 ..
// n*8 + 7 of a staged [.][HD + 4] tensor, as the A operand) times those rows.
template <int HD>
__device__ __forceinline__ void mma_cols_f32(float (&acc)[HD / 8][4], const float (&c)[4], const float* xs, int n) {
  uint32_t a_big[4], a_small[4];
  c_as_a(c, a_big, a_small);
#pragma unroll
  for (int m = 0; m < HD / 8; ++m) {
    uint32_t b_big[2], b_small[2];
    b_cols<HD + 4>(xs, 8 * n, 8 * m, b_big, b_small);
    mma_3xtf32(acc[m], a_big, a_small, b_big, b_small);
  }
}

// Stores 16 rows (r0 ..) of an [HD]-wide accumulator, rows past T skipped.
template <int HD>
__device__ __forceinline__ void store_rows_f32(float* x, int64_t ts, int r0, int t, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = n * 8 + 2 * (lane & 3);
    if (ra < t) *reinterpret_cast<float2*>(x + ra * ts + d) = make_float2(acc[n][0], acc[n][1]);
    if (rb < t) *reinterpret_cast<float2*>(x + rb * ts + d) = make_float2(acc[n][2], acc[n][3]);
  }
}

}  // namespace
