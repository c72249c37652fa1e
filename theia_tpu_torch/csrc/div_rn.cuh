// p / l for the softmax of the bf16 attention forward (mha_fwd.cu), rounded
// to the nearest float exactly as the IEEE division rounds it, without the
// special-function unit.
//
// div_rn takes rl = 1 / l (one IEEE division a row) and computes q = p * rl,
// the residual p - l * q (exact in one fma) and q + residual * rl, rounded
// once: the correction the compiler's own division runs after an
// approximate reciprocal from the special-function unit. That unit gives 16
// results a clock per SM; at ~200 quotients a row its reciprocals cost K1
// more than all of its products (PERF.md, section 6). `python -m
// theia_tpu_torch.tools.check_div_rn` holds div_rn against the IEEE
// division on the card for every pair of 23-bit mantissas of p and l in
// [1, 2); scaling p or l by a power of two scales every step exactly, so
// that covers every p >= kDivRnMin and l in [1, 256], the range of a
// softmax over at most 256 keys (p <= 1 <= l). p = 0 gives 0. A smaller
// nonzero p takes div_ieee.

#pragma once

namespace {

constexpr float kDivRnMin = 0x1p-90f;

__device__ __forceinline__ float div_rn(float p, float l, float rl) {
  const float q = p * rl;
  return fmaf(fmaf(-l, q, p), rl, q);
}

// The IEEE division, kept out of the common path: an asm statement is never
// executed speculatively.
__device__ __forceinline__ float div_ieee(float p, float l) {
  float d;
  asm volatile("div.rn.f32 %0, %1, %2;\n" : "=f"(d) : "f"(p), "f"(l));
  return d;
}

}  // namespace
