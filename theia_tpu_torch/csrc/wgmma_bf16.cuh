// Hopper warpgroup matrix multiply (wgmma) building blocks for the bf16
// attention forward (mha_fwd.cu), backward (mha_bwd.cu) and flash kernels
// (flash_attn.cu): wgmma.mma_async
// with float32 accumulation, m64n32k16 and m64n64k16 with A in shared
// memory (and A B^T over a head dim of them) and m64nNk16 with A in
// registers for N = 16..128 step 16, its fence / commit / wait,
// shared-memory matrix descriptors for the 128-byte swizzle, and cp.async
// staging of token rows into that layout.
//
// Register layouts, per warp w of the warpgroup (lane = 4 * g + tq): the A
// fragment (64 x 16) is mma.sync m16n8k16's A for rows 16w .. 16w + 15; the
// accumulator of an m64nN product holds, for each n8 tile i, d[4i + e] =
// row 16w + g + 8 * (e >= 2), column 8i + 2tq + (e & 1), mma.sync's C layout.
//
// Shared-memory layout of an operand (wgmma's 128-byte swizzle): a tensor of
// rows of hd bf16 is held as round64(hd) / 64 atoms, atom a holding columns
// 64a .. 64a + 63 of every row as a [rows][64] block of 128-byte rows; the
// 16-byte chunk c of row r lands at chunk c ^ (r % 8). Atoms start on
// 1024-byte boundaries, the period of the swizzle, so the hardware's XOR of
// address bits [4,7) with bits [7,10) finds each chunk.
//   - As a K-major operand (B[n][k] = row n, column k: K in S = Q K^T, and
//     Q the same way as its A): 8-row groups 1024 bytes apart (SBO); a k16
//     step is the descriptor's start moved 32 bytes along the row, and the
//     next atom past k = 64.
//   - As an MN-major B operand (B[k][n] = row k, column n, the transpose
//     bit set; O = P V): 8-row groups along k 1024 bytes apart (SBO), atoms
//     along n one atom's size apart (LBO); a k16 step is 16 rows further.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

__host__ __device__ constexpr int round64(int x) { return (x + 63) & ~63; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`, with
// leading and stride byte offsets `lbo`, `sbo` (multiples of 16).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Copy rows 0 .. rows - 1 of a slab (row r at src + r * stride, HD bf16
// wide) into `dst` in the swizzled atom layout above, atom a at dst + a *
// rows * 128 bytes, with cp.async by the block's kThreads threads as one
// commit group; rows from T up to `rows` become zeros. Columns from HD up
// to round64(HD) are left unwritten: no product reads them.
template <int HD, int kThreads>
__device__ __forceinline__ void stage_sw128(unsigned char* dst, const __nv_bfloat16* src, int64_t stride, int t,
                                            int rows) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  if constexpr (kThreads % kChunks == 0 && (kThreads / kChunks) % 8 == 0) {
    // a thread keeps one chunk column, and its rows step by a multiple of
    // 8, so its swizzled offset within a row never changes
    constexpr int kRowStep = kThreads / kChunks;
    const int c = threadIdx.x % kChunks;
    int r = threadIdx.x / kChunks;
    unsigned char* d = dst + (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    const __nv_bfloat16* s = src + r * stride + c * 8;
    for (; r < rows; r += kRowStep, d += kRowStep * 128, s += kRowStep * stride) {
      if (r < t) {
        cp_async16(d, s);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      unsigned char* d = dst + (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
      if (r < t) {
        cp_async16(d, src + r * stride + c * 8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cp_async_commit();
}

// Make this thread's generic-proxy writes to shared memory (cp.async, stores)
// visible to wgmma, which reads through the async proxy; a barrier after it
// publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Order register writes (A fragments, accumulators) before the wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep a register the compiler sees as written here: placed after
// wgmma_wait on the accumulators and the A fragments, it stops the compiler
// from reading or reusing them while a wgmma may still be writing or reading.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(x[i]);
}

template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(x[i][e]);
}

// d (64 x 64, float32) = A (64 x 16 bf16, K-major, the descriptor a) * B
// (16 x 64 bf16, the descriptor b) + (scale_d ? d : 0); TransB = 1 reads B
// MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

// The same, m64n32k16: d is 64 x 32.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

// d (64 x 2F, float32) = A B^T over HD: A the 64 rows at shared address a
// and B the 2F rows at b, both K-major in swizzle atoms a_atom and b_atom
// bytes apart; issued, not committed.
template <int HD, int F>
__device__ __forceinline__ void wgmma_abt(float (&d)[F], uint32_t a, uint32_t a_atom, uint32_t b, uint32_t b_atom) {
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const uint32_t col = (s % 4) * 32;
    wgmma_ss<0>(d, desc_sw128(a + (s / 4) * a_atom + col, 16, 1024), desc_sw128(b + (s / 4) * b_atom + col, 16, 1024),
                s > 0);
  }
}

// d (64 x N, float32) = A (64 x 16 bf16, registers) * B (16 x N bf16, the
// descriptor b) + (scale_d ? d : 0); TransB = 1 reads B MN-major. One
// overload per N, chosen by the size of d (N / 2 floats a thread).
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}


}  // namespace
