// float32 products on the tensor cores as 3xTF32, for the float32 attention
// kernels (mha_bwd.cu): mma.sync m16n8k8 with tf32 operands and float32
// accumulation, and the split of a float32 operand into two tf32 halves.
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

}  // namespace
