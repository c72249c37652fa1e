// bf16 building blocks of the attention kernels: cp.async and bf16 packing
// for all of them (mha_fwd.cu and mha_bwd.cu through wgmma_bf16.cuh,
// flash_attn.cu), and for the bf16 flash kernels (flash_attn.cu) mma.sync
// m16n8k16 with float32 accumulation, transposing ldmatrix, and the
// A-fragment loads, products and stores over rows staged with pitch HD + 8.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + tq): A holds rows g
// and g + 8, columns 2tq, 2tq + 1 (and + 8); B holds columns g, rows 2tq,
// 2tq + 1 (and + 8); C holds rows g and g + 8, columns 2tq, 2tq + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way: lane
// l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `rows` token rows of a slab (row r at src + r * stride) into shared
// rows of pitch HD + 8 with cp.async, as one commit group; rows from T up
// to `rows` become zeros.
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t stride,
                                           int t, int rows) {
  constexpr int kVecs = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    __nv_bfloat16* d = dst + r * (HD + 8) + c;
    if (r < t) {
      cp_async16(d, src + r * stride + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
}

// A fragments of 16 rows of a slab (rows r0 .. r0 + 15, token stride ts),
// straight from global memory; rows past T are zeros.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const __nv_bfloat16* x, int64_t ts, int r0,
                                       int t) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const int d = s * 16 + c;
    a[s][0] = ra < t ? load_u32(x + ra * ts + d) : 0u;
    a[s][1] = rb < t ? load_u32(x + rb * ts + d) : 0u;
    a[s][2] = ra < t ? load_u32(x + ra * ts + d + 8) : 0u;
    a[s][3] = rb < t ? load_u32(x + rb * ts + d + 8) : 0u;
  }
}

// acc (an 8-column tile) += A (16 rows x HD) times rows n*8 .. n*8 + 7 of a
// staged [.][HD + 8] tensor, transposed: C[i][j] += sum_d A[i][d] X[n*8 + j][d].
template <int HD>
__device__ __forceinline__ void mma_rows(float (&acc)[4], const uint32_t (&a)[HD / 16][4],
                                         const __nv_bfloat16* xs, int n) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = xs + (n * 8 + (lane >> 2)) * (HD + 8) + 2 * (lane & 3);
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) mma_bf16_16816(acc, a[s], load_u32(row + s * 16), load_u32(row + s * 16 + 8));
}

// acc[HD / 8 tiles] += A (16 x 16, as four packed registers) times rows
// j*16 .. j*16 + 15 of a staged [.][HD + 8] tensor; its B fragments come
// from a transposing ldmatrix, two 8-column tiles at a time.
template <int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 8][4], const uint32_t (&a)[4], const __nv_bfloat16* xs,
                                         int j) {
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, xs + (j * 16 + lrow) * (HD + 8) + n * 8 + lcol);
    mma_bf16_16816(acc[n], a, b[0], b[1]);
    mma_bf16_16816(acc[n + 1], a, b[2], b[3]);
  }
}

// Stores 16 rows (r0 ..) of an [HD]-wide accumulator as bf16, rows past T skipped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* x, int64_t ts, int r0, int t, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = n * 8 + 2 * (lane & 3);
    if (ra < t) *reinterpret_cast<uint32_t*>(x + ra * ts + d) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < t) *reinterpret_cast<uint32_t*>(x + rb * ts + d) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

}  // namespace
