// bf16 building blocks of the attention kernels (mha_fwd.cu, mha_bwd.cu and
// flash_attn.cu, through wgmma_bf16.cuh and mma_tf32.cuh): cp.async copies,
// their commit and wait, and the rounding of two floats to a packed bf16
// pair.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 16 bytes global -> shared without a round trip through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats rounded to bf16 (nearest even), lo in the low 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
