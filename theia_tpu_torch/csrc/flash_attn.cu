// Flash attention for Hopper (sm_90a): forward (K7), dQ (K9) and dK, dV (K8).
//
// Replaces the three Pallas kernels of JAX's TPU flash attention library
// (jax/experimental/pallas/ops/tpu/flash_attention.py, reached from
// theia_tpu/ops/attention.py::_flash_attention):
//   K7 _flash_attention_kernel     (pallas_call at :758) -> flash_fwd_*;
//   K9 _flash_attention_dq_kernel  (pallas_call at :1456) -> flash_dq_*;
//   K8 _flash_attention_dkv_kernel (pallas_call at :1121) -> flash_dkv_*.
// Q, K, V, O, dO and the gradients are [B, T, H, hd] with unit stride over hd
// and heads hd apart, and any batch and token strides: Q, K, V are read in
// place in the packed QKV projection and dQ, dK, dV written in place in its
// packed gradient. Any T >= 1, hd a multiple of 16 up to 128, any B * H.
// For each (batch, head) slab, [T, hd], with bf() the rounding to the input
// dtype (the identity in float32) and every product accumulated in float32:
//   forward:  S = Q K^T * scale over key tiles of 64; a running row max m and
//             sum l (the online softmax); P = exp(S - m) rounded, O += bf(P) V
//             with O and l rescaled by exp(m_old - m) when m grows; at the end
//             O / l, and lse = m + log(l) (float32, [B * H, T]);
//   dQ:       di = rowsum(O * dO) in float32, stored for dK/dV; over key tiles
//             P = exp(S - lse), dP = dO V^T, dS = (dP - di) * P * scale,
//             dQ += bf(dS) K;
//   dK, dV:   over query tiles, the same P and dS, dV += bf(P)^T dO,
//             dK += bf(dS)^T Q.
// These are the library's numerics: its backward rebuilds P from the saved
// max and sum and takes di from the output (flash_attention.py:273-275), not
// K2's rowsum(dP * P). The TPU library masks padded keys with a finite mask
// value over T padded to 128; here the tiles are masked by bounds, which
// gives the same result on the real rows.
//
// What bounds it on the H100. At [16, 785, 12, 64] bf16 the forward does
// 30 GFLOP against 39 MB of input and output, ~800 FLOP a byte, so the
// tensor cores are the limit (31 us at 989 TFLOP/s); the backward passes
// likewise (45 and 61 GFLOP). At T = 197 all three are bound by their
// bytes, a few microseconds. Nothing of size T x T leaves the SM: a block
// owns 64 rows (queries, or keys in the dK/dV pass; 128 queries in the bf16
// forward) and streams the other side through shared memory in tiles of 64
// (32 queries in the bf16 dK/dV pass).
//
// bf16 forward, wgmma (flash_fwd_bf16): two warpgroups (256 threads) own
//   128 query rows of a slab, 64 each, and share the block's Q, staged once,
//   and a ring of THEIA_K7_BF16_STAGES K and V tiles of 64 keys, all staged
//   by cp.async in wgmma's 128-byte swizzle (wgmma_bf16.cuh). One barrier a
//   tile publishes its slots and frees those whose products have retired in
//   both warpgroups; the copies of the tiles ahead fill them. S = Q K^T is
//   m64n64k16 with Q and K both K-major in shared memory (Q held in
//   registers, 16 to 32 more a thread, was no faster); its accumulators
//   are mma.sync's C layout per warp, so the online softmax is the quad
//   shuffles of the mma.sync kernels; bf(P), packed from them, is the
//   register A of O += P V, m64n(hd)k16 with V the MN-major B (the
//   transpose bit), as in K1. With
//   THEIA_K7_BF16_PIPE, tile j + 1's S and softmax run while the tensor
//   cores work on tile j's P V (two sets of P fragments, one of S).
//   What bounds it: at [16, 785] neither the tensor cores (36.6 GFLOP
//   padded to 128-row blocks, 37 us) nor the K and V staging, which 128-row
//   blocks halve against 64-row ones (~286 MB through L2; waiting for every
//   copy at every tile costs nothing), but the softmax's instructions: an
//   exact expf is 8 of the ~14 a score, 645 a tile a thread with the
//   loop's own, which the schedulers issue at under 60% of their rate
//   between the tile's barrier and its products' waits (PERF.md, section
//   6). So rows past T
//   are computed on zero-filled Q, but a warp wholly past T skips its
//   softmax, and the last tile's 8-key groups wholly past T skip their
//   exp; keys past T are zero-filled and masked to -inf.
//
// bf16 dQ and dK/dV, wgmma (flash_dq_bf16, flash_dkv_bf16): the forward's
//   design, each pass owning one reduction direction. dQ: a warpgroup owns
//   64 query rows of a slab (THEIA_K9_BF16_WG of them a block), whose Q and
//   dO are staged once, and streams K and V through a ring of
//   THEIA_K9_BF16_STAGES tiles of 64 keys, one barrier a tile; di =
//   rowsum(O * dO) is formed first, from global memory while the first
//   copies land. S = Q K^T and dP = dO V^T are m64n64k16 products with A
//   and B in shared memory, committed as two groups so that dP is in flight
//   during P's expf; dS, rounded to bf16 in the accumulator layout, is the
//   register A of dQ += dS K with K the MN-major B, as P is of O += P V.
//   S, dP and dQ take 96 floats a thread at hd 64, ~167 registers: 3
//   blocks of 128 threads a SM, where 2 blocks of 256 at 128 registers
//   spilled. dK/dV is K2 bf16's column pass over a streamed query ring: a
//   warpgroup owns 64 keys (THEIA_K8_BF16_WG of them a block), whose K and
//   V are staged once and are the A in shared memory of S^T = K Q^T and
//   dP^T = V dO^T (m64n32k16); each of the THEIA_K8_BF16_STAGES slots holds
//   32 queries' Q and dO and their lse and di; P^T and dS^T, rounded to
//   bf16 in the accumulator layout, are the register A of dV += P^T dO and
//   dK += dS^T Q (dO and Q the MN-major B); 4 blocks of 128 threads a SM at
//   128 registers at hd 64. Keys past T are zero-filled and masked to P = 0
//   in dQ's last tile, queries past T likewise in dK/dV's; rows past T are
//   computed on zeros and never stored. What bounds them at [16, 785, 12,
//   64]: not HBM (117 MB, 35 us) nor the tensor cores (dQ's 51 GFLOP of
//   padded products take 52 us of its ~170, dK/dV's 65 take 66 of ~225).
//   What is left is each block staging its slab's whole other side (~0.5
//   GB through L2 a pass) and the exact expf of every score with the
//   elementwise work around it, between a tile's barrier and its
//   products' waits; their shares are not measured (PERF.md, section 6).
//
// float32, tensor cores as 3xTF32 (flash_fwd_f32, flash_dq_f32,
//   flash_dkv_f32): no tensor-core instruction multiplies in full float32,
//   so each product is three tf32 mma.sync m16n8k8 over operands split into
//   big and small halves (mma_tf32.cuh), ~2^-21 relative, as in K2's float32
//   passes. At [16, 785, 12, 64] the forward does 30 GFLOP and the backward
//   pair 106: 0.45 and 1.58 ms at the CUDA cores' 67 TFLOP/s, 0.18 and 0.64
//   ms as three tf32 products at the tensor cores' 495. A block owns 64 rows
//   (queries in the forward and dQ, keys in dK/dV) and streams the other
//   side in double-buffered cp.async tiles of 64, rows past T zero-filled
//   and masked by bounds. Each 16-row group is two warps that take
//   alternate 8-column tiles of a streamed tile and add their partial sums
//   once, at the end, in part order. The block's own rows (Q; Q and dO; K
//   and V) are staged once in shared memory and each k-step's A fragment is
//   read there, so a thread holds only its accumulators and its S (and dP)
//   tiles. Forward: S = Q K^T, then the online softmax on the accumulators,
//   each warp keeping the running max, sum and O over its own keys; P,
//   still in the accumulators, is the A operand of O += P V with V read
//   down columns (c_as_a, b_cols), so P never leaves registers; at the end
//   the two warps of a group meet once, each part's sum and O rescaled by
//   exp(m_part - m) to the group's max m. dQ: S = Q K^T, dP = dO V^T, then
//   dS, in the accumulators, is the A operand of dQ += dS K in the same
//   way. dK, dV: S^T = K Q^T and dP^T = V dO^T issue their correction terms
//   transposed, so S and dP add the dQ pass's terms in its order and, with
//   the scale multiply pinned and the exact expf, P and dS are the numbers
//   the dQ pass forms (the forward forms S in the dQ pass's order); P^T and
//   dS^T are the A operands of dV += P^T dO and dK += dS^T Q. The choices of
//   the block's shape are -D switches (THEIA_FLASH_F32_SPLIT,
//   THEIA_FLASH_F32_HELD_A, THEIA_FLASH_FWD_F32_SHARED_MAX), timed in
//   PERF.md.
//
// No atomics: each pass owns one reduction direction, so the results are
// deterministic. TMA, clusters, a producer warp and persistent blocks are
// later work, as is wgmma for the float32 kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kTile = 64;  // rows a block owns; keys or queries a streamed tile holds
constexpr int kMaxHd = 128;

struct Strides {
  int64_t b;
  int64_t t;
};

// Token r of head h of batch entry b of a tensor with strides s starts at
// element b * s.b + r * s.t + h * hd.
struct Layout {
  int t;
  int heads;
  int hd;
  Strides qkv;   // q, k, v
  Strides out;   // o
  Strides dout;  // dO
  Strides grad;  // dq, dk, dv

  __device__ __forceinline__ int64_t head(const Strides& s, int slab) const {
    return static_cast<int64_t>(slab / heads) * s.b + static_cast<int64_t>(slab % heads) * hd;
  }
};

// Sum over the 4 lanes of a fragment row group (lanes 4g .. 4g + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 K7: wgmma
// ---------------------------------------------------------------------------

// The forward's block shape may be set with -D to time the alternatives
// (tools/time_mha_bwd.py --kernel flash_fwd --dtype bfloat16 --ablations);
// the defaults are the fastest measured.
//   THEIA_K7_BF16_WG: warpgroups a block, each owning 64 query rows (2 or 1).
//   THEIA_K7_BF16_STAGES: slots of the K and V ring (2 to 4).
//   THEIA_K7_BF16_PIPE: 1 runs tile j + 1's S = Q K^T and softmax (into a
//     second set of P fragments) while tile j's P V is in flight; 0 runs
//     each tile's S, softmax and P V in turn.
#ifndef THEIA_K7_BF16_WG
#define THEIA_K7_BF16_WG 2
#endif
#ifndef THEIA_K7_BF16_STAGES
#define THEIA_K7_BF16_STAGES 3
#endif
#ifndef THEIA_K7_BF16_PIPE
#define THEIA_K7_BF16_PIPE 1
#endif

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kFwdWgs = THEIA_K7_BF16_WG;
constexpr int kFwdThreads = kFwdWgs * kWgThreads;
constexpr int kFwdRows = kFwdWgs * kTile;     // query rows a block
constexpr int kStages = THEIA_K7_BF16_STAGES;
constexpr int kAhead = THEIA_K7_BF16_PIPE;    // key tiles S = Q K^T runs ahead of P V
static_assert(kFwdWgs == 1 || kFwdWgs == 2, "a block has 1 or 2 warpgroups");
static_assert(kStages >= 2 && kStages <= 4, "the ring has 2 to 4 slots");
static_assert(kAhead == 0 || kAhead == 1, "THEIA_K7_BF16_PIPE is 0 or 1");

// Blocks a SM the launch bounds ask for: 512 threads (128 registers a
// thread) where hd <= 64 leaves room for them in registers and shared
// memory, else one block, which may take up to 255 registers.
template <int HD>
__host__ __device__ constexpr int fwd_bf16_min_blocks() {
  return HD <= 64 ? 4 / kFwdWgs : 1;
}

// Shared memory: 1 KB to align the base to the swizzle's period, the
// block's kFwdRows Q rows, then the ring's kStages K tiles and kStages V
// tiles of 64 rows, each in round64(hd) / 64 swizzle atoms of 128-byte rows.
size_t smem_bytes_fwd_bf16(int hd) {
  return 1024 + static_cast<size_t>(round64(hd) / 64) * (kFwdRows + 2 * kStages * kTile) * 128;
}

// 16 bytes global -> shared, of which the first src_bytes (16, or 0) are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, of which the first src_bytes (4, or 0) are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

// Tile i of a slab's K, V, Q or dO (rows kRows i .., token stride ts) into
// ring slot i % kSlots, in the swizzled atom layout of stage_sw128 (atoms
// kRows rows apart), by the block's kThreads threads with cp.async, not
// committed; rows from T on are zero-filled by the copy (src-size 0, row
// 0's address), and past the last tile nothing is copied. Each thread
// copies the same chunks of every tile, a fixed count.
template <int HD, int kThreads, int kSlots, int kRows>
__device__ __forceinline__ void copy_tile(uint32_t ring, const bf16* x, int64_t ts, int i, int t) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  constexpr int kAll = kRows * kChunks;
  constexpr uint32_t kTileBytes = round64(HD) / 64 * kRows * 128;
  if (i * kRows < t) {
    const uint32_t slot = ring + static_cast<unsigned>(i) % kSlots * kTileBytes;
    const bf16* tile = x + static_cast<int64_t>(i) * kRows * ts;
    const int rows = t - i * kRows;
#pragma unroll
    for (int i0 = 0; i0 < kAll; i0 += kThreads) {
      const unsigned e = i0 + threadIdx.x;
      if (kAll % kThreads == 0 || e < kAll) {
        const int r = e / kChunks, c = e % kChunks;
        const bool in = r < rows;
        cp_async16_zfill(slot + (c >> 3) * kRows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                         tile + (in ? r : 0) * ts + c * 8, in ? 16 : 0);
      }
    }
  }
}

// K7's ring: tile i of K or V (64 keys) as one cp.async commit group, an
// empty one past the last tile, so that every thread counts the same groups.
template <int HD>
__device__ __forceinline__ void stage_ring(uint32_t ring, const bf16* x, int64_t ts, int i, int t) {
  copy_tile<HD, kFwdThreads, kStages, kTile>(ring, x, ts, i, t);
  cp_async_commit();
}

// d (64 rows x 64 keys, float32) = Q K^T over HD: a warpgroup's Q rows at
// shared address qa (swizzle atoms q_atom bytes apart) and a ring slot's K
// tile at ka, both K-major, m64n64k16 with A in shared memory; issued and
// committed, not waited for. (Also dP = dO V^T.)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&d)[32], uint32_t qa, uint32_t q_atom, uint32_t ka) {
  wgmma_fence();
  wgmma_abt<HD>(d, qa, q_atom, ka, kTile * 128);
  wgmma_commit();
}

// A warp's online softmax over key tile key0 .. key0 + 63, on the retired
// accumulators sc of S = Q K^T: element e is row (e & 2 ? b : a), key key0
// + 8 (e >> 2) + 2 tq + (e & 1). S * scale; in the last tile (kMask) keys
// from T masked to -inf, and the 8-key groups wholly past T skip their
// exp (p = 0). The row maxima m raised to the tile's (the same in the 4
// lanes of a row) and the correction al = exp(m_old - m) by which the sums
// l (here) and O (rescale_o) are rescaled; p = exp(S - m), summed
// unrounded into l; bf(p) packed into pa, the register A fragments of O +=
// P V: the S tiles 2s and 2s + 1 (8 keys each) are k16 step s.
template <bool kMask>
__device__ __forceinline__ void softmax_p(float (&sc)[32], uint32_t (&pa)[kTile / 16][4], float& m_a, float& m_b,
                                          float& l_a, float& l_b, float& al_a, float& al_b, int key0, int t,
                                          float scale) {
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = __fmul_rn(sc[e], scale);
  if constexpr (kMask) {
    // element e's key lies below T when 8 (e >> 2) + (e & 1) < keys
    const int keys = t - key0 - 2 * static_cast<int>(threadIdx.x & 3);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (8 * (e >> 2) + (e & 1) >= keys) sc[e] = -INFINITY;
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  // Every tile holds a key < T, so the new maxima are finite; the first
  // tile's correction exp(-inf) is 0.
  const float mn_a = fmaxf(m_a, quad_max(mx_a));
  const float mn_b = fmaxf(m_b, quad_max(mx_b));
  al_a = expf(m_a - mn_a);
  al_b = expf(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  l_a *= al_a;
  l_b *= al_b;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (kMask && 8 * i >= t - key0) {  // no key of the group is below T: a branch uniform over the block
      sc[4 * i] = sc[4 * i + 1] = sc[4 * i + 2] = sc[4 * i + 3] = 0.f;
      continue;
    }
    sc[4 * i] = expf(sc[4 * i] - m_a);  // masked keys: 0
    sc[4 * i + 1] = expf(sc[4 * i + 1] - m_a);
    sc[4 * i + 2] = expf(sc[4 * i + 2] - m_b);
    sc[4 * i + 3] = expf(sc[4 * i + 3] - m_b);
    l_a += sc[4 * i] + sc[4 * i + 1];
    l_b += sc[4 * i + 2] + sc[4 * i + 3];
  }
#pragma unroll
  for (int s = 0; s < kTile / 16; ++s) {
    pa[s][0] = pack_bf16(sc[8 * s], sc[8 * s + 1]);
    pa[s][1] = pack_bf16(sc[8 * s + 2], sc[8 * s + 3]);
    pa[s][2] = pack_bf16(sc[8 * s + 4], sc[8 * s + 5]);
    pa[s][3] = pack_bf16(sc[8 * s + 6], sc[8 * s + 7]);
  }
}

// O of rows a and b scaled by their corrections al_a, al_b.
template <int HD>
__device__ __forceinline__ void rescale_o(float (&acc)[HD / 2], float al_a, float al_b) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    acc[4 * i] *= al_a;
    acc[4 * i + 1] *= al_a;
    acc[4 * i + 2] *= al_b;
    acc[4 * i + 3] *= al_b;
  }
}

// O += P V over a 64-key tile: pa the register A fragments, the ring slot's
// V at vt the MN-major B (the transpose bit), m64n(HD)k16; `first` sets O
// (scale_d 0). Issued and committed, not waited for. (Also K9's dQ += dS K.)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], const uint32_t (&pa)[kTile / 16][4], uint32_t vt,
                                         bool first) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kTile / 16; ++s) {
    wgmma_rs<1>(acc, pa[s], desc_sw128(vt + s * 16 * 128, kTile * 128, 1024), !first || s > 0);
  }
  wgmma_commit();
}

// K7, the bf16 forward. A block owns kFwdRows query rows of one slab: one
// warpgroup each 64, sharing the block's Q (staged once) and a ring of
// kStages K and V tiles of 64 keys, staged by cp.async in wgmma's 128-byte
// swizzle. Each tile takes one barrier: it publishes the tile's slots and
// frees those that every warpgroup's products have retired, which the
// next tiles' copies then fill. With kAhead, K tile j + 1 lands with V
// tile j, and tile j + 1's S = Q K^T and softmax run while the tensor
// cores work on tile j's P V. Every loop and branch around a product is
// uniform over the block: rows past T are computed on zero-filled Q (a
// warpgroup wholly past T too) and only their stores are skipped; a warp
// wholly past T also skips its softmax, which holds no product. Keys past
// T are zero-filled and masked to -inf.
template <int HD>
__global__ void __launch_bounds__(kFwdThreads, fwd_bf16_min_blocks<HD>())
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   bf16* __restrict__ o, float* __restrict__ lse, Layout lay, int q_blocks, float scale) {
  constexpr int kAtoms = round64(HD) / 64;
  constexpr uint32_t kRowAtom = kFwdRows * 128;          // bytes of a swizzle atom of the block's Q
  constexpr uint32_t kTileBytes = kAtoms * kTile * 128;  // of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t kaddr = smem_addr(qs) + kAtoms * kRowAtom;  // [kStages] K tiles
  const uint32_t vaddr = kaddr + kStages * kTileBytes;        // [kStages] V tiles
  const int t = lay.t;
  // head-major: the row blocks of a slab run together and share its K, V in L2
  const int slab = blockIdx.x / q_blocks;
  const int row0 = (blockIdx.x - slab * q_blocks) * kFwdRows;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  const int n = (t + kTile - 1) / kTile;  // key tiles

  // cp.async groups, in order: Q (and K tile 0 with kAhead), then for each
  // step i = 0, 1, ...: K tile i + kAhead and V tile i. Steps 0 ..
  // kStages - 2 are staged here, step j + kStages - 1 by tile j, and step
  // j has landed before tile j's barrier.
  stage_sw128<HD, kFwdThreads>(qs, q + in_off + row0 * ts, ts, t - row0, kFwdRows);
  if constexpr (kAhead) stage_ring<HD>(kaddr, kh, ts, 0, t);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage_ring<HD>(kaddr, kh, ts, i + kAhead, t);
    stage_ring<HD>(vaddr, vh, ts, i, t);
  }

  const int wg = threadIdx.x / kWgThreads;
  const uint32_t qaddr = smem_addr(qs) + wg * kTile * 128;  // this warpgroup's 64 rows
  const int warp_row0 = row0 + wg * kTile + ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 rows
  // A warp whose rows all lie past T skips its softmax and rescales (a
  // branch uniform over the warp, around no product): its products run on
  // P = 0, and their rows are never stored.
  const bool warp_live = warp_row0 < t;
  float sc[32];                               // S of a tile
  uint32_t pa[kTile / 16][4] = {}, pb[kTile / 16][4] = {};  // bf(P) of two tiles with kAhead; pa alone without
  float acc[HD / 2];  // O, mma.sync's C layout per warp; set by the first P V (scale_d 0)
  float m_a = -INFINITY, m_b = -INFINITY;  // running row maxima of rows a = rw, b = rw + 8
  float l_a = 0.f, l_b = 0.f;              // running sums over this lane's keys
  float al_a, al_b;                        // the last softmax's corrections of O
  const auto slot = [](int j) { return static_cast<unsigned>(j) % kStages * kTileBytes; };  // of tile j in the ring
  const auto issue_s = [&](int j) { issue_qk<HD>(sc, qaddr, kRowAtom, kaddr + slot(j)); };
  if constexpr (kAhead) {
    cp_async_wait<2 * (kStages - 1)>();
    fence_proxy_async();
    __syncthreads();  // Q and K tile 0 are in shared memory
    issue_s(0);
    wgmma_wait<0>();  // before tile 0's barrier, after which K tile 0's slot is restaged
    fence_all(sc);
    if (warp_live) softmax_p<true>(sc, pa, m_a, m_b, l_a, l_b, al_a, al_b, 0, t, scale);  // tile 0 may be the last
  }

  // Key tile j: its barrier and the next step's copies; without kAhead, S
  // = Q K^T of tile j and its softmax into p; O rescaled (past tile 0) and
  // O += P V with p; with kAhead, p holds tile j's bf(P) already, tile j +
  // 1's S and softmax (into p_next) run during the P V, and O is rescaled
  // to tile j + 1's maxima once the P V has retired. Every product has
  // retired at the end. `soft` says which softmax the call runs: of a
  // full tile (kFull), of the last tile, masked (kMasked), or none (kNone:
  // with kAhead, tile j is the last).
  constexpr int kFull = 0, kMasked = 1, kNone = 2;
  const auto tile = [&](int j, uint32_t(&p)[kTile / 16][4], uint32_t(&p_next)[kTile / 16][4], auto soft) {
    constexpr int kSoft = decltype(soft)::value;
    cp_async_wait<2 * (kStages - 2)>();
    fence_proxy_async();
    __syncthreads();  // step j is in shared memory; every product of tile j - 1 has retired
    stage_ring<HD>(kaddr, kh, ts, j + kStages - 1 + kAhead, t);
    stage_ring<HD>(vaddr, vh, ts, j + kStages - 1, t);
    if constexpr (!kAhead) {
      issue_s(j);
      wgmma_wait<0>();
      fence_all(sc);
      if (warp_live) softmax_p<kSoft == kMasked>(sc, p, m_a, m_b, l_a, l_b, al_a, al_b, j * kTile, t, scale);
    } else if constexpr (kSoft != kNone) {
      issue_s(j + 1);
    }
    if (!kAhead && j > 0 && warp_live) rescale_o<HD>(acc, al_a, al_b);
    issue_pv<HD>(acc, p, vaddr + slot(j), j == 0);
    if constexpr (kAhead && kSoft != kNone) {
      wgmma_wait<1>();  // tile j + 1's S; its P V still runs
      fence_all(sc);
      if (warp_live) {
        softmax_p<kSoft == kMasked>(sc, p_next, m_a, m_b, l_a, l_b, al_a, al_b, (j + 1) * kTile, t, scale);
      }
    }
    wgmma_wait<0>();
    fence_all(acc);
    fence_all(p);
    if (kAhead && kSoft != kNone && warp_live) rescale_o<HD>(acc, al_a, al_b);  // to tile j + 1's maxima
  };
  using Full = std::integral_constant<int, kFull>;
  using Masked = std::integral_constant<int, kMasked>;
  using None = std::integral_constant<int, kNone>;
  if constexpr (kAhead) {
    // unrolled by two, so that the two P fragments swap roles by name; the
    // last two tiles' calls run the masked softmax and none
    const auto last_two = [&](int j, uint32_t(&p)[kTile / 16][4], uint32_t(&p_next)[kTile / 16][4]) {
      tile(j, p, p_next, Masked{});
      tile(j + 1, p_next, p, None{});
    };
    int j = 0;
    for (; j + 3 < n; j += 2) {
      tile(j, pa, pb, Full{});
      tile(j + 1, pb, pa, Full{});
    }
    if (n - j == 3) {
      tile(j, pa, pb, Full{});
      last_two(j + 1, pb, pa);
    } else if (n - j == 2) {
      last_two(j, pa, pb);
    } else {
      tile(j, pa, pb, None{});
    }
  } else {
    for (int j = 0; j + 1 < n; ++j) tile(j, pa, pb, Full{});
    tile(n - 1, pa, pb, Masked{});
  }

  // O / l and lse = m + log(l) for the rows below T
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const int tq = threadIdx.x & 3;
  const int row_a = warp_row0 + ((threadIdx.x & 31) >> 2);
  const int row_b = row_a + 8;
  bf16* oh = o + lay.head(lay.out, slab);
  const int64_t ots = lay.out.t;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * tq;
    if (row_a < t) {
      *reinterpret_cast<uint32_t*>(oh + row_a * ots + d) = pack_bf16(acc[4 * i] / l_a, acc[4 * i + 1] / l_a);
    }
    if (row_b < t) {
      *reinterpret_cast<uint32_t*>(oh + row_b * ots + d) = pack_bf16(acc[4 * i + 2] / l_b, acc[4 * i + 3] / l_b);
    }
  }
  if (tq == 0) {
    float* ls = lse + static_cast<int64_t>(slab) * t;
    if (row_a < t) ls[row_a] = m_a + logf(l_a);
    if (row_b < t) ls[row_b] = m_b + logf(l_b);
  }
}

// ---------------------------------------------------------------------------
// bf16 K9 and K8: wgmma
// ---------------------------------------------------------------------------

// The backward's block shapes may be set with -D to time the alternatives
// (tools/time_mha_bwd.py --kernel flash_bwd --dtype bfloat16 --ablations);
// the defaults are the fastest measured.
//   THEIA_K9_BF16_WG: warpgroups a dQ block, each owning 64 query rows (1 or 2).
//   THEIA_K9_BF16_STAGES: slots of the dQ pass's K and V ring (2 to 4).
//   THEIA_K8_BF16_WG: warpgroups a dK/dV block, each owning 64 keys (1 or 2).
//   THEIA_K8_BF16_N: queries a step of the dK/dV pass (32 or 64).
//   THEIA_K8_BF16_STAGES: slots of its ring of query tiles (2 to 4).
#ifndef THEIA_K9_BF16_WG
#define THEIA_K9_BF16_WG 1
#endif
#ifndef THEIA_K9_BF16_STAGES
#define THEIA_K9_BF16_STAGES 2
#endif
#ifndef THEIA_K8_BF16_WG
#define THEIA_K8_BF16_WG 1
#endif
#ifndef THEIA_K8_BF16_N
#define THEIA_K8_BF16_N 32
#endif
#ifndef THEIA_K8_BF16_STAGES
#define THEIA_K8_BF16_STAGES 4
#endif

constexpr int kDqWgs = THEIA_K9_BF16_WG;
constexpr int kDqThreads = kDqWgs * kWgThreads;
constexpr int kDqRows = kDqWgs * kTile;  // query rows a dQ block
constexpr int kDqStages = THEIA_K9_BF16_STAGES;
constexpr int kDkvWgs = THEIA_K8_BF16_WG;
constexpr int kDkvThreads = kDkvWgs * kWgThreads;
constexpr int kDkvKeys = kDkvWgs * kTile;  // keys a dK/dV block
constexpr int kDkvN = THEIA_K8_BF16_N;     // queries a tile of its ring
constexpr int kDkvStages = THEIA_K8_BF16_STAGES;
static_assert(kDqWgs == 1 || kDqWgs == 2, "a dQ block has 1 or 2 warpgroups");
static_assert(kDqStages >= 2 && kDqStages <= 4, "the dQ ring has 2 to 4 slots");
static_assert(kDkvWgs == 1 || kDkvWgs == 2, "a dK/dV block has 1 or 2 warpgroups");
static_assert(kDkvN == 32 || kDkvN == 64, "the dK/dV pass steps over 32 or 64 queries");
static_assert(kDkvStages >= 2 && kDkvStages <= 4, "the dK/dV ring has 2 to 4 slots");
static_assert(2 * kDkvN <= kDkvThreads, "a thread copies each query's lse or di");

// Blocks a SM the launch bounds ask for. dQ holds S and dP (32 floats
// each) and dQ (HD / 2) a thread, 96 floats at hd 64, which take ~167
// registers with the rest: 3 blocks of 128 threads (170 registers a
// thread) at hd <= 64; with 2 warpgroups, 2 blocks of 256 (128 registers,
// which spill). dK/dV holds dK and dV (HD / 2 each) and S^T and dP^T
// (kDkvN / 2 each), within 96 floats at hd 64 and 32 queries a step: 512
// threads a SM at 128 registers. Above, one block, which may take up to 255
// registers.
template <int HD>
__host__ __device__ constexpr int dq_bf16_min_blocks() {
  return HD <= 64 ? (kDqWgs == 1 ? 3 : 2) : 1;
}

template <int HD>
__host__ __device__ constexpr int dkv_bf16_min_blocks() {
  return HD + kDkvN <= 96 ? 4 / kDkvWgs : 1;
}

// Shared memory of dQ: 1 KB to align the base to the swizzle's period, the
// block's Q and dO rows, then the ring's kDqStages K tiles and kDqStages V
// tiles of 64 keys, each in round64(hd) / 64 swizzle atoms of 128-byte rows.
size_t smem_bytes_dq_bf16(int hd) {
  return 1024 + static_cast<size_t>(round64(hd) / 64) * (2 * kDqRows + 2 * kDqStages * kTile) * 128;
}

// Of dK/dV: the block's K and V rows, the ring's kDkvStages Q tiles and
// kDkvStages dO tiles of kDkvN queries, then each slot's lse and di.
size_t smem_bytes_dkv_bf16(int hd) {
  return 1024 + static_cast<size_t>(round64(hd) / 64) * (2 * kDkvKeys + 2 * kDkvStages * kDkvN) * 128 +
         kDkvStages * 2 * kDkvN * sizeof(float);
}

// This lane's part of rowsum(x * y) over row r of two slabs (token strides
// xs, ys) in float32: lane tq of a fragment row group takes the 16-byte
// chunks tq, tq + 4, ...; 0 for a row from T on.
template <int HD>
__device__ __forceinline__ float row_dot(const bf16* x, int64_t xs, const bf16* y, int64_t ys, int r, int t) {
  float sum = 0.f;
  if (r < t) {
#pragma unroll
    for (int i = 0; i < (HD / 8 + 3) / 4; ++i) {
      const int c = 4 * i + static_cast<int>(threadIdx.x & 3);
      if (c < HD / 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(x + r * xs + c * 8);
        const uint4 b = *reinterpret_cast<const uint4*>(y + r * ys + c * 8);
        const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
          const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[e]));
          sum = fmaf(fa.y, fb.y, fmaf(fa.x, fb.x, sum));
        }
      }
    }
  }
  return sum;
}

// The register A fragments of a product that sums over the columns of a
// 64 x 2F accumulator, from x(e), its element e rounded to bf16: the n8
// tiles 2s and 2s + 1 are k16 step s (mma.sync's C layout is its A layout).
template <int F, typename X>
__device__ __forceinline__ void pack_a(uint32_t (&a)[F / 8][4], X x) {
#pragma unroll
  for (int s = 0; s < F / 8; ++s) {
    a[s][0] = pack_bf16(x(8 * s), x(8 * s + 1));
    a[s][1] = pack_bf16(x(8 * s + 2), x(8 * s + 3));
    a[s][2] = pack_bf16(x(8 * s + 4), x(8 * s + 5));
    a[s][3] = pack_bf16(x(8 * s + 6), x(8 * s + 7));
  }
}

// K9's P = exp(S scale - lse) in place on the retired accumulators sc of S
// = Q K^T over key tile key0 .. key0 + 63 (element e: row e & 2 ? b : a,
// key key0 + 8 (e >> 2) + 2 tq + (e & 1)), the scale multiply pinned as
// the plain version rounds it. In the last tile (kMask) keys from T give P
// = 0 (their zero-filled K gives S = 0, and exp(-lse) may overflow), and
// the 8-key groups wholly past T skip their expf.
template <bool kMask>
__device__ __forceinline__ void dq_probs(float (&sc)[32], float lse_a, float lse_b, int key0, int t, float scale) {
  const int keys = t - key0 - 2 * static_cast<int>(threadIdx.x & 3);  // element e's key is below T when 8 (e >> 2) + (e & 1) < keys
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (kMask && 8 * i >= t - key0) {  // no key of the group is below T: a branch uniform over the block
      sc[4 * i] = sc[4 * i + 1] = sc[4 * i + 2] = sc[4 * i + 3] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 4 * i; e < 4 * i + 4; ++e) {
      const float p = expf(__fmul_rn(sc[e], scale) - ((e & 2) ? lse_b : lse_a));
      sc[e] = !kMask || 8 * i + (e & 1) < keys ? p : 0.f;
    }
  }
}

// K9, the bf16 dQ. A block owns kDqRows query rows of one slab, one
// warpgroup each 64, sharing the block's Q and dO (staged once) and a ring
// of kDqStages K and V tiles of 64 keys, all staged by cp.async in wgmma's
// 128-byte swizzle. First each row's di = rowsum(O * dO), in float32 from
// global memory while the copies land, stored for K8. Then for each key
// tile, behind one barrier: S = Q K^T and dP = dO V^T (m64n64k16, A and B
// in shared memory), two commit groups, so that dP is in flight during the
// expf of P = exp(S scale - lse); dS = (dP - di) P scale, rounded to bf16
// in the accumulator layout, is the register A of dQ += dS K, m64n(HD)k16
// with K the MN-major B (the transpose bit), as P is of K7's O += P V.
// Every loop and branch around a product is uniform over the block: rows
// past T are computed on zero-filled Q and dO with lse 0 (P finite, dS 0)
// and never stored, and a warp wholly past T skips its elementwise work.
template <int HD>
__global__ void __launch_bounds__(kDqThreads, dq_bf16_min_blocks<HD>())
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ di, bf16* __restrict__ dq, Layout lay, int q_blocks, float scale) {
  constexpr int kAtoms = round64(HD) / 64;
  constexpr uint32_t kRowAtom = kDqRows * 128;           // bytes of a swizzle atom of the block's Q or dO
  constexpr uint32_t kTileBytes = kAtoms * kTile * 128;  // of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* os = qs + kAtoms * kRowAtom;
  const uint32_t kaddr = smem_addr(os) + kAtoms * kRowAtom;  // [kDqStages] K tiles
  const uint32_t vaddr = kaddr + kDqStages * kTileBytes;      // [kDqStages] V tiles
  const int t = lay.t;
  // head-major: the row blocks of a slab run together and share its K, V in L2
  const int slab = blockIdx.x / q_blocks;
  const int row0 = (blockIdx.x - slab * q_blocks) * kDqRows;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  const bf16* doh = dout + lay.head(lay.dout, slab);
  const int n = (t + kTile - 1) / kTile;  // key tiles

  // cp.async groups, in order: Q, dO, then K and V tile i for i = 0, 1,
  // ...: tiles 0 .. kDqStages - 2 here, tile j + kDqStages - 1 by tile j
  // (an empty group past the last tile).
  const auto stage = [&](int i) {
    copy_tile<HD, kDqThreads, kDqStages, kTile>(kaddr, kh, ts, i, t);
    copy_tile<HD, kDqThreads, kDqStages, kTile>(vaddr, vh, ts, i, t);
    cp_async_commit();
  };
  stage_sw128<HD, kDqThreads>(qs, q + in_off + row0 * ts, ts, t - row0, kDqRows);
  stage_sw128<HD, kDqThreads>(os, doh + row0 * lay.dout.t, lay.dout.t, t - row0, kDqRows);
#pragma unroll
  for (int i = 0; i < kDqStages - 1; ++i) stage(i);

  const int wg = threadIdx.x / kWgThreads;
  const int tq = threadIdx.x & 3;
  const int warp_row0 = row0 + wg * kTile + ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 rows
  const int row_a = warp_row0 + ((threadIdx.x & 31) >> 2);
  const int row_b = row_a + 8;
  const bf16* oh = o + lay.head(lay.out, slab);
  const float di_a = quad_sum(row_dot<HD>(oh, lay.out.t, doh, lay.dout.t, row_a, t));
  const float di_b = quad_sum(row_dot<HD>(oh, lay.out.t, doh, lay.dout.t, row_b, t));
  const float* ls = lse + static_cast<int64_t>(slab) * t;
  const float lse_a = row_a < t ? ls[row_a] : 0.f;
  const float lse_b = row_b < t ? ls[row_b] : 0.f;
  if (tq == 0) {
    float* dst = di + static_cast<int64_t>(slab) * t;
    if (row_a < t) dst[row_a] = di_a;
    if (row_b < t) dst[row_b] = di_b;
  }

  const uint32_t qaddr = smem_addr(qs) + wg * kTile * 128;  // this warpgroup's 64 rows
  const uint32_t oaddr = smem_addr(os) + wg * kTile * 128;
  const bool warp_live = warp_row0 < t;
  float acc[HD / 2];  // dQ; set by the first tile's product (scale_d 0)
  const auto slot = [](int j) { return static_cast<unsigned>(j) % kDqStages * kTileBytes; };  // of tile j
  const auto tile = [&](int j, auto last) {
    cp_async_wait<kDqStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j is in shared memory; every product of tile j - 1 has retired
    stage(j + kDqStages - 1);
    float sc[32], dp[32];        // S, then P, and dP of the tile
    uint32_t da[kTile / 16][4];  // bf(dS), the register A of dQ += dS K (0 in a warp wholly past T)
    issue_qk<HD>(sc, qaddr, kRowAtom, kaddr + slot(j));
    issue_qk<HD>(dp, oaddr, kRowAtom, vaddr + slot(j));  // in flight during P's expf
    wgmma_wait<1>();
    fence_all(sc);
    if (warp_live) dq_probs<decltype(last)::value>(sc, lse_a, lse_b, j * kTile, t, scale);
    wgmma_wait<0>();
    fence_all(dp);
    pack_a<32>(da, [&](int e) { return warp_live ? (dp[e] - ((e & 2) ? di_b : di_a)) * sc[e] * scale : 0.f; });
    issue_pv<HD>(acc, da, kaddr + slot(j), j == 0);  // dQ += dS K
    wgmma_wait<0>();
    fence_all(acc);
    fence_all(da);
  };
  for (int j = 0; j + 1 < n; ++j) tile(j, std::false_type{});
  tile(n - 1, std::true_type{});

  bf16* dqh = dq + lay.head(lay.grad, slab);
  const int64_t gts = lay.grad.t;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * tq;
    if (row_a < t) *reinterpret_cast<uint32_t*>(dqh + row_a * gts + d) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
    if (row_b < t) *reinterpret_cast<uint32_t*>(dqh + row_b * gts + d) = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// K8, the bf16 dK and dV: K2 bf16's column pass over a ring of query tiles.
// A block owns kDkvKeys keys of one slab, one warpgroup each 64, whose K and
// V rows are staged once; the queries stream through a ring of kDkvStages
// slots, each holding kDkvN queries' Q and dO (in wgmma's 128-byte swizzle)
// and their lse and di, one cp.async group a tile. For each tile, behind
// one barrier: S^T = K Q^T and dP^T = V dO^T (m64n(kDkvN)k16, K and V the A
// and Q and dO the K-major B, in shared memory), two commit groups; P^T =
// exp(S^T scale - lse), rounded to bf16 in the accumulator layout, is the
// register A of dV += P^T dO, and dS^T = (dP^T - di) P^T scale, rounded
// likewise, of dK += dS^T Q (dO and Q the MN-major B). Queries past T are
// zero-filled (lse and di 0) and in the last tile masked to P = 0; keys
// past T are computed on zeros and never stored, and a warp whose 16 keys
// all lie past T skips its elementwise work.
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, dkv_bf16_min_blocks<HD>())
    flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, Layout lay, int k_blocks, float scale) {
  constexpr int N = kDkvN;
  constexpr int kAtoms = round64(HD) / 64;
  constexpr uint32_t kKeyAtom = kDkvKeys * 128;       // bytes of a swizzle atom of the block's K or V
  constexpr uint32_t kQAtom = N * 128;                // of a Q or dO tile
  constexpr uint32_t kTileBytes = kAtoms * kQAtom;    // a Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + kAtoms * kKeyAtom;
  const uint32_t qring = smem_addr(vs) + kAtoms * kKeyAtom;  // [kDkvStages] Q tiles
  const uint32_t oring = qring + kDkvStages * kTileBytes;     // [kDkvStages] dO tiles
  const uint32_t sring = oring + kDkvStages * kTileBytes;     // [kDkvStages][2][N] floats: lse, di
  const float* stats = reinterpret_cast<const float*>(ks + (sring - smem_addr(ks)));
  const int t = lay.t;
  const int slab = blockIdx.x / k_blocks;
  const int k0 = (blockIdx.x - slab * k_blocks) * kDkvKeys;
  const int64_t ts = lay.qkv.t;
  const int64_t dts = lay.dout.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* qh = q + in_off;
  const bf16* doh = dout + lay.head(lay.dout, slab);
  const float* lh = lse + static_cast<int64_t>(slab) * t;
  const float* dh = di + static_cast<int64_t>(slab) * t;
  const int n = (t + N - 1) / N;  // query tiles

  // cp.async groups, in order: K, V, then query tile i for i = 0, 1, ...:
  // tiles 0 .. kDkvStages - 2 here, tile j + kDkvStages - 1 by tile j (an
  // empty group past the last tile). Queries from T on are zero-filled, lse
  // and di included.
  const auto stage = [&](int i) {
    copy_tile<HD, kDkvThreads, kDkvStages, N>(qring, qh, ts, i, t);
    copy_tile<HD, kDkvThreads, kDkvStages, N>(oring, doh, dts, i, t);
    if (i * N < t && threadIdx.x < 2 * N) {
      const int qi = i * N + static_cast<int>(threadIdx.x % N);
      const bool in = qi < t;
      cp_async4_zfill(sring + (static_cast<unsigned>(i) % kDkvStages * 2 * N + threadIdx.x) * 4,
                      (threadIdx.x < N ? lh : dh) + (in ? qi : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  stage_sw128<HD, kDkvThreads>(ks, k + in_off + k0 * ts, ts, t - k0, kDkvKeys);
  stage_sw128<HD, kDkvThreads>(vs, v + in_off + k0 * ts, ts, t - k0, kDkvKeys);
#pragma unroll
  for (int i = 0; i < kDkvStages - 1; ++i) stage(i);

  const int wg = threadIdx.x / kWgThreads;
  const int tq = threadIdx.x & 3;
  const uint32_t kaddr = smem_addr(ks) + wg * kTile * 128;  // this warpgroup's 64 keys
  const uint32_t vaddr = smem_addr(vs) + wg * kTile * 128;
  const int warp_k0 = k0 + wg * kTile + ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 keys
  const bool warp_live = warp_k0 < t;
  float dv_acc[HD / 2], dk_acc[HD / 2];  // set by the first tile's products (scale_d 0)
  const auto tile = [&](int j, auto last) {
    constexpr bool kMask = decltype(last)::value;
    cp_async_wait<kDkvStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j is in shared memory; every product of tile j - 1 has retired
    stage(j + kDkvStages - 1);
    const unsigned slot = static_cast<unsigned>(j) % kDkvStages;
    const uint32_t qt = qring + slot * kTileBytes, ot = oring + slot * kTileBytes;
    const float* st = stats + slot * 2 * N;  // the tile's lse, then its di
    // S^T and dP^T: element e is key row e & 2 ? b : a, query j N + 8 (e >> 2) + 2 tq + (e & 1)
    float s[N / 2], dp[N / 2];
    uint32_t pa[N / 16][4], da[N / 16][4];  // bf(P^T) and bf(dS^T), the register A of dV and dK
    wgmma_fence();
    wgmma_abt<HD>(s, kaddr, kKeyAtom, qt, kQAtom);
    wgmma_commit();
    wgmma_abt<HD>(dp, vaddr, kKeyAtom, ot, kQAtom);  // in flight during P's expf
    wgmma_commit();
    wgmma_wait<1>();
    fence_all(s);
    // the queries of the last tile from T on give P = 0; its 8-query groups
    // wholly past T skip their expf, as does a warp whose keys all lie past T
    const int queries = t - j * N - 2 * tq;
    if (warp_live) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        if (kMask && 8 * i >= t - j * N) {  // a branch uniform over the block
          s[4 * i] = s[4 * i + 1] = s[4 * i + 2] = s[4 * i + 3] = 0.f;
          continue;
        }
        const float2 l = *reinterpret_cast<const float2*>(st + 8 * i + 2 * tq);
#pragma unroll
        for (int e = 4 * i; e < 4 * i + 4; ++e) {
          const float p = expf(__fmul_rn(s[e], scale) - ((e & 1) ? l.y : l.x));
          s[e] = !kMask || 8 * i + (e & 1) < queries ? p : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_all(dp);
    pack_a<N / 2>(pa, [&](int e) { return warp_live ? s[e] : 0.f; });
    pack_a<N / 2>(da, [&](int e) {
      const float2 d = *reinterpret_cast<const float2*>(st + N + 8 * (e >> 2) + 2 * tq);
      return warp_live ? (dp[e] - ((e & 1) ? d.y : d.x)) * s[e] * scale : 0.f;
    });
    // dV += P^T dO and dK += dS^T Q: dO and Q the MN-major B (queries down,
    // dims across), one m64n(HD)k16 wgmma per 16 queries each
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      wgmma_rs<1>(dv_acc, pa[i], desc_sw128(ot + i * 16 * 128, kQAtom, 1024), j > 0 || i > 0);
    }
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      wgmma_rs<1>(dk_acc, da[i], desc_sw128(qt + i * 16 * 128, kQAtom, 1024), j > 0 || i > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dv_acc);
    fence_all(dk_acc);
    fence_all(pa);
    fence_all(da);
  };
  for (int j = 0; j + 1 < n; ++j) tile(j, std::false_type{});
  tile(n - 1, std::true_type{});

  const int ra = warp_k0 + ((threadIdx.x & 31) >> 2);
  const int rb = ra + 8;
  const int64_t g_off = lay.head(lay.grad, slab);
  const int64_t gts = lay.grad.t;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * tq;
    if (ra < t) {
      *reinterpret_cast<uint32_t*>(dk + g_off + ra * gts + d) = pack_bf16(dk_acc[4 * i], dk_acc[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + g_off + ra * gts + d) = pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
    }
    if (rb < t) {
      *reinterpret_cast<uint32_t*>(dk + g_off + rb * gts + d) = pack_bf16(dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
      *reinterpret_cast<uint32_t*>(dv + g_off + rb * gts + d) = pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// The block shape may be set with -D to time the alternatives
// (tools/time_mha_bwd.py --kernel flash_fwd|flash_bwd --ablations); the
// defaults are the fastest measured.
//   THEIA_FLASH_F32_SPLIT: warps that share a 16-row group, each taking
//     every SPLIT-th 8-column tile of a streamed tile (1 or 2); their
//     partial sums meet once, at the end, in part order.
//   THEIA_FLASH_F32_HELD_A: 1 holds the A operand of the block's own rows
//     (Q in K7; Q, dO in dQ; K, V in dK/dV) in registers as float32, 0
//     stages those rows once in shared memory and reads each k-step's
//     fragment there.
//   THEIA_FLASH_FWD_F32_SHARED_MAX: in K7 with SPLIT 2, 1 has the two warps
//     of a row group exchange each tile's row maxima through shared memory
//     behind a named barrier of the pair, so that both rescale by one
//     running max; 0 lets each keep its own max, sum and O over its keys,
//     and the two meet once, at the end.
#ifndef THEIA_FLASH_F32_SPLIT
#define THEIA_FLASH_F32_SPLIT 2
#endif
#ifndef THEIA_FLASH_F32_HELD_A
#define THEIA_FLASH_F32_HELD_A 0
#endif
#ifndef THEIA_FLASH_FWD_F32_SHARED_MAX
#define THEIA_FLASH_FWD_F32_SHARED_MAX 0
#endif

constexpr int kF32Split = THEIA_FLASH_F32_SPLIT;
constexpr bool kF32HeldA = THEIA_FLASH_F32_HELD_A != 0;
constexpr bool kFwdSharedMax = THEIA_FLASH_FWD_F32_SHARED_MAX != 0 && kF32Split == 2;
constexpr int kF32Threads = 32 * (kTile / 16) * kF32Split;
constexpr int kF32Cols = kTile / 8 / kF32Split;  // 8-column tiles of a streamed tile a warp takes
static_assert(kF32Split == 1 || kF32Split == 2, "a part's partial sums are parked in the staging buffers");

// Blocks a SM the launch bounds ask for: two of 256 threads (128 registers a
// thread) where the staged A operand leaves room for it.
template <int HD>
__host__ __device__ constexpr int f32_min_blocks() {
  return !kF32HeldA && kF32Split == 2 && HD <= 64 ? 2 : 1;
}

// Shared memory: two double-buffered streamed [kTile][HD + 4] tiles, the
// block's own two (unless held in registers), and in dK/dV the streamed
// tiles' lse and di, [2][2][kTile].
template <int HD>
size_t smem_bytes_bwd_f32(bool dkv) {
  return ((kF32HeldA ? 4 : 6) * static_cast<size_t>(kTile) * (HD + 4) + (dkv ? 4 * kTile : 0)) * sizeof(float);
}

// K7's: K and V double-buffered, the block's Q rows (unless held in
// registers), and with kFwdSharedMax the row groups' tile maxima,
// [groups][2][16].
template <int HD>
size_t smem_bytes_fwd_f32() {
  return ((kF32HeldA ? 4 : 5) * static_cast<size_t>(kTile) * (HD + 4) + (kFwdSharedMax ? 2 * kTile : 0)) *
         sizeof(float);
}

// The A operand of a warp's 16 rows, held in registers as float32 (RowsA,
// from global memory) and read a k-step at a time.
template <int HD>
struct HeldA : RowsA<HD> {
  __device__ __forceinline__ void frag(int s, float (&a)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = this->raw[s][e];
  }
};

// The same read from the block's rows staged in shared memory (pitch HD + 4,
// 32 distinct banks as b_rows); `rows` is the warp's first row.
template <int HD>
struct StagedA {
  const float* rows;

  __device__ __forceinline__ void frag(int s, float (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    const float* p = rows + (lane >> 2) * (HD + 4) + 8 * s + (lane & 3);
    a[0] = p[0];
    a[1] = p[8 * (HD + 4)];
    a[2] = p[4];
    a[3] = p[8 * (HD + 4) + 4];
  }
};

template <int HD>
using OwnA = std::conditional_t<kF32HeldA, HeldA<HD>, StagedA<HD>>;

// The block's A operand for the 16 rows r0 .. of x (token stride ts): loaded
// into registers, or pointed at its rows staged at `staged` (row b0 first).
template <int HD>
__device__ __forceinline__ void own_a(OwnA<HD>& a, const float* x, int64_t ts, int r0, int t, const float* staged,
                                      int b0) {
  if constexpr (kF32HeldA) {
    a.load(x, ts, r0, t);
  } else {
    a.rows = staged + (r0 - b0) * (HD + 4);
  }
}

// 4 bytes global -> shared (cp.async.ca: .cg takes only 16).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

// lse and di of the queries r .. r + kTile - 1 into dst[2][kTile], as one
// commit group; queries from T on become zeros.
__device__ __forceinline__ void stage_stats(float* dst, const float* lse, const float* di, int r, int t) {
  for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
    const int qi = r + (i & (kTile - 1));
    if (qi < t) {
      cp_async4(dst + i, (i < kTile ? lse : di) + qi);
    } else {
      dst[i] = 0.f;
    }
  }
  cp_async_commit();
}

// Whether a warp's 8-column tile i holds a row of a streamed tile that has
// `rows` rows below T. A tile past them would add only zeros: a streamed
// tile's last (kPartial) pass skips it; the full tiles run without the test,
// which costs more inside the unrolled k-steps than the work it saves.
template <bool kPartial>
__device__ __forceinline__ bool live_cols(int i, int part, int rows) {
  return !kPartial || 8 * (kF32Split * i + part) < rows;
}

// S (or S^T) and dP (or dP^T) over a warp's kF32Cols 8-column tiles n =
// kF32Split i + part of a streamed tile: x's A operand against the rows of
// xs, y's against the rows of ys, a k-step at a time, so that one k-step of
// each A operand is split and live (tiles live_cols skips stay 0).
// kSmallAFirst as mma_3xtf32.
template <bool kPartial, bool kSmallAFirst, int HD>
__device__ __forceinline__ void scores_f32(float (&sc)[kF32Cols][4], float (&dp)[kF32Cols][4], const OwnA<HD>& x,
                                           const float* xs, const OwnA<HD>& y, const float* ys, int part, int rows) {
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    float a[4];
    uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
    x.frag(s, a);
    split_tf32(a, a_big, a_small);
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      if (live_cols<kPartial>(i, part, rows)) {
        b_rows<HD + 4>(xs, 8 * (kF32Split * i + part), 8 * s, b_big, b_small);
        mma_3xtf32<kSmallAFirst>(sc[i], a_big, a_small, b_big, b_small);
      }
    }
    y.frag(s, a);
    split_tf32(a, a_big, a_small);
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      if (live_cols<kPartial>(i, part, rows)) {
        b_rows<HD + 4>(ys, 8 * (kF32Split * i + part), 8 * s, b_big, b_small);
        mma_3xtf32<kSmallAFirst>(dp[i], a_big, a_small, b_big, b_small);
      }
    }
  }
}

// A part's accumulator into (park) or added from (unpark) red[HD / 8][4][32],
// lane-major, so each access reads 32 distinct banks.
template <int HD>
__device__ __forceinline__ void park(float* red, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < HD / 8; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(m * 4 + e) * 32 + lane] = acc[m][e];
  }
}

template <int HD>
__device__ __forceinline__ void unpark(const float* red, float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < HD / 8; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] += red[(m * 4 + e) * 32 + lane];
  }
}

// A warp's work on one streamed key tile of K7 (`rows` keys below T): S =
// Q K^T * scale on its 8-key tiles, keys past T masked by bounds (a
// zero-filled key gives S = 0, not -inf); the online softmax of rows g and
// g + 8 over them: the running maxima m (the same in a row's 4 lanes), this
// lane's sums l and O rescaled by exp(m_old - m) when m grows; then O += P V
// with each P tile, still in the accumulators, as the A operand of its 8
// keys and V read down columns (c_as_a, b_cols). With kFwdSharedMax the
// pair's tile maxima meet in xch (the group's [2][16]) behind named barrier
// `bar`.
template <bool kPartial, int HD>
__device__ __forceinline__ void fwd_tile(float (&acc)[HD / 8][4], float (&m)[2], float (&l)[2], const OwnA<HD>& qa,
                                         const float* kt, const float* vt, int part, int rows, float scale,
                                         float* xch, int bar) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  // element e of tile i is row g + 8 (e >> 1), key 8n + 2tq + (e & 1)
  float sc[kF32Cols][4];
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    float a[4];
    uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
    qa.frag(s, a);
    split_tf32(a, a_big, a_small);
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      if (live_cols<kPartial>(i, part, rows)) {
        b_rows<HD + 4>(kt, 8 * (kF32Split * i + part), 8 * s, b_big, b_small);
        mma_3xtf32(sc[i], a_big, a_small, b_big, b_small);
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int key0 = 8 * (kF32Split * i + part) + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the scale multiply pinned, as K9 and K8 form S * scale
      sc[i][e] = !kPartial || key0 + (e & 1) < rows ? __fmul_rn(sc[i][e], scale) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  if constexpr (kFwdSharedMax) {
    const int g = lane >> 2;
    if (tq == 0) {
      xch[part * 16 + g] = mx[0];
      xch[part * 16 + g + 8] = mx[1];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
    mx[0] = fmaxf(mx[0], xch[(part ^ 1) * 16 + g]);
    mx[1] = fmaxf(mx[1], xch[(part ^ 1) * 16 + g + 8]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], mx[r]);
    // A warp none of whose keys so far is below T (the second of a pair at
    // T <= 8) keeps m = -inf; exp's argument is taken against 0 there, so
    // that its P and correction are 0, not exp(-inf + inf) = NaN.
    base[r] = mn == -INFINITY ? 0.f : mn;
    const float al = expf(m[r] - base[r]);
    m[r] = mn;
    l[r] *= al;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][2 * r] *= al;
      acc[n][2 * r + 1] *= al;
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[i][e] = expf(sc[i][e] - base[e >> 1]);  // masked keys: 0
      l[e >> 1] += sc[i][e];
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    if (live_cols<kPartial>(i, part, rows)) mma_cols_f32<HD>(acc, sc[i], vt, kF32Split * i + part);
  }
}

// K7, the float32 forward. A block owns 64 query rows, staged once in
// shared memory (unless held); each row group (16 rows) is kF32Split warps.
// Over the key tiles (K and V double-buffered with cp.async): fwd_tile on
// the warp's 8-key tiles. At the end the two warps of a row group meet
// once, in part order: m = max(m0, m1), and each part's l and O rescaled by
// exp(mi - m) and added (with kFwdSharedMax, m0 = m1 and the factors are
// 1); then O / l and lse = m + log(l) for the rows below T.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, f32_min_blocks<HD>())
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ o, float* __restrict__ lse, Layout lay, int q_tiles, float scale) {
  constexpr int kPitch = HD + 4;
  constexpr int kBuf = kTile * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [2][kTile][kPitch]
  float* vs = ks + 2 * kBuf;                   // [2][kTile][kPitch]
  float* own = vs + 2 * kBuf;                  // [kTile][kPitch]: the block's Q rows, unless held
  const int t = lay.t;
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / kF32Split;
  const int part = warp - group * kF32Split;
  const int b0 = (blockIdx.x - slab * q_tiles) * kTile;
  const int r0 = b0 + group * 16;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const float* qh = q + in_off;
  const float* kh = k + in_off;
  const float* vh = v + in_off;
  float* xch = own + (kF32HeldA ? 0 : kBuf) + group * 32;  // the group's tile maxima (kFwdSharedMax)
  const int k_tiles = (t + kTile - 1) / kTile;

  if constexpr (!kF32HeldA) stage_rows_f32<HD>(own, qh + b0 * ts, ts, t - b0, kTile);
  stage_rows_f32<HD>(ks, kh, ts, t, kTile);
  stage_rows_f32<HD>(vs, vh, ts, t, kTile);
  OwnA<HD> qa;
  own_a<HD>(qa, qh, ts, r0, t, own, b0);

  float m[2] = {-INFINITY, -INFINITY};  // running maxima of rows g and g + 8 over this warp's keys
  float l[2] = {0.f, 0.f};              // running sums over this lane's keys
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = 0; j < k_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < k_tiles) {
      const int r = (j + 1) * kTile;
      stage_rows_f32<HD>(ks + (cur ^ 1) * kBuf, kh + r * ts, ts, t - r, kTile);
      stage_rows_f32<HD>(vs + (cur ^ 1) * kBuf, vh + r * ts, ts, t - r, kTile);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and the block's Q rows) are in shared memory
    if (r0 < t) {
      const int rows = t - j * kTile;  // keys of the tile below T
      if (rows >= kTile) {
        fwd_tile<false, HD>(acc, m, l, qa, ks + cur * kBuf, vs + cur * kBuf, part, rows, scale, xch, 1 + group);
      } else {
        fwd_tile<true, HD>(acc, m, l, qa, ks + cur * kBuf, vs + cur * kBuf, part, rows, scale, xch, 1 + group);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if constexpr (kF32Split > 1) {
    float* red = reinterpret_cast<float*>(smem) + group * (16 * HD + 128);  // the staging is free now
    float* stat = red + 16 * HD;                                            // [m_a, m_b, l_a, l_b][32]
    if (part == 1) {
      park<HD>(red, acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stat[r * 32 + lane] = m[r];
        stat[(2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (part == 1 || r0 >= t) return;
    float f0[2], f1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = stat[r * 32 + lane];
      const float mn = fmaxf(m[r], m1);  // finite: part 0 holds key 0
      f0[r] = expf(m[r] - mn);
      f1[r] = expf(m1 - mn);
      l[r] = l[r] * f0[r] + stat[(2 + r) * 32 + lane] * f1[r];
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * f0[e >> 1] + red[(n * 4 + e) * 32 + lane] * f1[e >> 1];
    }
  }
  if (r0 >= t) return;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= l[e >> 1];
  }
  store_rows_f32<HD>(o + lay.head(lay.out, slab), lay.out.t, r0, t, acc);
  if ((lane & 3) == 0) {
    float* ls = lse + static_cast<int64_t>(slab) * t;
    const int row_a = r0 + (lane >> 2);
    if (row_a < t) ls[row_a] = m[0] + logf(l[0]);
    if (row_a + 8 < t) ls[row_a + 8] = m[1] + logf(l[1]);
  }
}

// A warp's work on one streamed key tile of K9 (`rows` keys below T): S =
// Q K^T and dP = dO V^T on its 8-key tiles, P = exp(S * scale - lse), dS =
// (dP - di) * P * scale in the accumulators, and dQ += dS K.
template <bool kPartial, int HD>
__device__ __forceinline__ void dq_tile(float (&acc)[HD / 8][4], const OwnA<HD>& qa, const OwnA<HD>& oa,
                                        const float* kt, const float* vt, int part, int rows, float lse_a, float lse_b,
                                        float di_a, float di_b, float scale) {
  const int tq = threadIdx.x & 3;
  // element e of tile i is row (e < 2 ? a : b), key 8n + 2tq + (e & 1)
  float sc[kF32Cols][4], dp[kF32Cols][4];
  scores_f32<kPartial, true, HD>(sc, dp, qa, kt, oa, vt, part, rows);
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int key0 = 8 * (kF32Split * i + part) + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // zero-filled keys give S = 0 and P = exp(-lse) != 0: masked by bounds
      const float p = key0 + (e & 1) < rows ? expf(__fmul_rn(sc[i][e], scale) - (e < 2 ? lse_a : lse_b)) : 0.f;
      sc[i][e] = (dp[i][e] - (e < 2 ? di_a : di_b)) * p * scale;  // dS, as dK/dV forms it
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    if (live_cols<kPartial>(i, part, rows)) mma_cols_f32<HD>(acc, sc[i], kt, kF32Split * i + part);
  }
}

// K9, dQ. A block owns 64 query rows; each row group (16 rows) is
// kF32Split warps. Over the key tiles (K and V double-buffered with
// cp.async): S = Q K^T and dP = dO V^T on the warp's 8-key tiles, P =
// exp(S * scale - lse), dS = (dP - di) * P * scale in the accumulators, and
// dQ += dS K with each dS tile as the A operand of its 8 keys (c_as_a) and
// K read down columns (b_cols).
template <int HD>
__global__ void __launch_bounds__(kF32Threads, f32_min_blocks<HD>())
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ di, float* __restrict__ dq, Layout lay, int q_tiles, float scale) {
  constexpr int kPitch = HD + 4;
  constexpr int kBuf = kTile * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [2][kTile][kPitch]
  float* vs = ks + 2 * kBuf;                   // [2][kTile][kPitch]
  float* own = vs + 2 * kBuf;                  // [2][kTile][kPitch]: the block's Q and dO rows, unless held
  const int t = lay.t;
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int group = warp / kF32Split;
  const int part = warp - group * kF32Split;
  const int b0 = (blockIdx.x - slab * q_tiles) * kTile;
  const int r0 = b0 + group * 16;
  const int row_a = r0 + (lane >> 2);
  const int row_b = row_a + 8;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const float* qh = q + in_off;
  const float* kh = k + in_off;
  const float* vh = v + in_off;
  const float* doh = dout + lay.head(lay.dout, slab);
  const int k_tiles = (t + kTile - 1) / kTile;

  if constexpr (!kF32HeldA) {
    stage_rows_f32<HD>(own, qh + b0 * ts, ts, t - b0, kTile);
    stage_rows_f32<HD>(own + kBuf, doh + b0 * lay.dout.t, lay.dout.t, t - b0, kTile);
  }
  stage_rows_f32<HD>(ks, kh, ts, t, kTile);
  stage_rows_f32<HD>(vs, vh, ts, t, kTile);
  OwnA<HD> qa, oa;
  own_a<HD>(qa, qh, ts, r0, t, own, b0);
  own_a<HD>(oa, doh, lay.dout.t, r0, t, own + kBuf, b0);
  if constexpr (!kF32HeldA) {
    cp_async_wait<2>();
    __syncthreads();  // the block's own rows are in shared memory
  }
  // di = rowsum(O * dO) in float32 for rows g and g + 8, stored for dK/dV; and lse
  float di_a = 0.f, di_b = 0.f;
  {
    const float* oh = o + lay.head(lay.out, slab);
#pragma unroll
    for (int s = 0; s < HD / 8; ++s) {
      float x[4], y[4];
      load_a_f32(x, oh, lay.out.t, r0, t, 8 * s);
      oa.frag(s, y);
      di_a = fmaf(x[2], y[2], fmaf(x[0], y[0], di_a));
      di_b = fmaf(x[3], y[3], fmaf(x[1], y[1], di_b));
    }
  }
  di_a = quad_sum(di_a);
  di_b = quad_sum(di_b);
  const float* ls = lse + static_cast<int64_t>(slab) * t;
  const float lse_a = row_a < t ? ls[row_a] : 0.f;
  const float lse_b = row_b < t ? ls[row_b] : 0.f;
  if (part == 0 && tq == 0) {
    float* dst = di + static_cast<int64_t>(slab) * t;
    if (row_a < t) dst[row_a] = di_a;
    if (row_b < t) dst[row_b] = di_b;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int m = 0; m < HD / 8; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  for (int j = 0; j < k_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < k_tiles) {
      const int r = (j + 1) * kTile;
      stage_rows_f32<HD>(ks + (cur ^ 1) * kBuf, kh + r * ts, ts, t - r, kTile);
      stage_rows_f32<HD>(vs + (cur ^ 1) * kBuf, vh + r * ts, ts, t - r, kTile);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in shared memory
    if (r0 < t) {
      const int rows = t - j * kTile;  // keys of the tile below T
      if (rows >= kTile) {
        dq_tile<false, HD>(acc, qa, oa, ks + cur * kBuf, vs + cur * kBuf, part, rows, lse_a, lse_b, di_a, di_b, scale);
      } else {
        dq_tile<true, HD>(acc, qa, oa, ks + cur * kBuf, vs + cur * kBuf, part, rows, lse_a, lse_b, di_a, di_b, scale);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if constexpr (kF32Split > 1) {
    float* red = reinterpret_cast<float*>(smem) + group * 16 * HD;  // the staging is free now
    if (part == 1) park<HD>(red, acc);
    __syncthreads();
    if (part == 1) return;
    unpark<HD>(red, acc);
  }
  if (r0 < t) store_rows_f32<HD>(dq + lay.head(lay.grad, slab), lay.grad.t, r0, t, acc);
}

// A warp's work on one streamed query tile of K8 (`rows` queries below T,
// their lse and di at lt[0 .. kTile) and lt[kTile ..)): S^T = K Q^T and
// dP^T = V dO^T on its 8-query tiles, then P^T and dS^T in the accumulators
// as the A operands of dV += P^T dO and dK += dS^T Q.
template <bool kPartial, int HD>
__device__ __forceinline__ void dkv_tile(float (&ak)[HD / 8][4], float (&av)[HD / 8][4], const OwnA<HD>& ka,
                                         const OwnA<HD>& va, const float* qt, const float* ot, const float* lt,
                                         int part, int rows, float scale) {
  const int tq = threadIdx.x & 3;
  const float* dt = lt + kTile;
  // element e of tile i is key (e < 2 ? a : b), query 8n + 2tq + (e & 1)
  float sc[kF32Cols][4], dp[kF32Cols][4];
  scores_f32<kPartial, false, HD>(sc, dp, ka, qt, va, ot, part, rows);
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    const int q0 = 8 * (kF32Split * i + part) + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + (e & 1);
      const float p = qi < rows ? expf(__fmul_rn(sc[i][e], scale) - lt[qi]) : 0.f;  // as K9 rounds it
      dp[i][e] = (dp[i][e] - dt[qi]) * p * scale;
      sc[i][e] = p;
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) {
    if (live_cols<kPartial>(i, part, rows)) {
      mma_cols_f32<HD>(av, sc[i], ot, kF32Split * i + part);
      mma_cols_f32<HD>(ak, dp[i], qt, kF32Split * i + part);
    }
  }
}

// K8, dK and dV. A block owns 64 keys; each key group (16) is kF32Split
// warps. Over the query tiles (Q, dO, lse, di double-buffered with
// cp.async): S^T = K Q^T and dP^T = V dO^T on the warp's 8-query tiles, with
// the correction terms issued transposed (mma_3xtf32<false>), so that P and
// dS are the numbers K9 forms; then P^T and dS^T in the accumulators are the
// A operands of dV += P^T dO and dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, f32_min_blocks<HD>())
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, Layout lay, int k_tiles, float scale) {
  constexpr int kPitch = HD + 4;
  constexpr int kBuf = kTile * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);       // [2][kTile][kPitch]
  float* os = qs + 2 * kBuf;                        // [2][kTile][kPitch]: dO
  float* own = os + 2 * kBuf;                       // [2][kTile][kPitch]: the block's K and V rows, unless held
  float* stat = own + (kF32HeldA ? 0 : 2 * kBuf);  // [2][2][kTile]: lse, di
  const int t = lay.t;
  const int slab = blockIdx.x / k_tiles;
  const int warp = threadIdx.x >> 5;
  const int group = warp / kF32Split;
  const int part = warp - group * kF32Split;
  const int b0 = (blockIdx.x - slab * k_tiles) * kTile;
  const int k0 = b0 + group * 16;
  const int64_t ts = lay.qkv.t;
  const int64_t dts = lay.dout.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const float* qh = q + in_off;
  const float* oh = dout + lay.head(lay.dout, slab);
  const float* lh = lse + static_cast<int64_t>(slab) * t;
  const float* dh = di + static_cast<int64_t>(slab) * t;
  const int q_tiles = (t + kTile - 1) / kTile;

  if constexpr (!kF32HeldA) {
    stage_rows_f32<HD>(own, k + in_off + b0 * ts, ts, t - b0, kTile);
    stage_rows_f32<HD>(own + kBuf, v + in_off + b0 * ts, ts, t - b0, kTile);
  }
  // query tile r into buffer b: Q, dO, then lse and di (three commit groups)
  const auto stage = [&](int b, int r) {
    stage_rows_f32<HD>(qs + b * kBuf, qh + r * ts, ts, t - r, kTile);
    stage_rows_f32<HD>(os + b * kBuf, oh + r * dts, dts, t - r, kTile);
    stage_stats(stat + b * 2 * kTile, lh, dh, r, t);
  };
  stage(0, 0);
  OwnA<HD> ka, va;
  own_a<HD>(ka, k + in_off, ts, k0, t, own, b0);
  own_a<HD>(va, v + in_off, ts, k0, t, own + kBuf, b0);

  float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
  for (int m = 0; m < HD / 8; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) av[m][e] = ak[m][e] = 0.f;
  }
  for (int j = 0; j < q_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < q_tiles) {
      stage(cur ^ 1, (j + 1) * kTile);
      cp_async_wait<3>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and the block's own rows) are in shared memory
    if (k0 < t) {
      const int rows = t - j * kTile;  // queries of the tile below T
      const float* lt = stat + cur * 2 * kTile;
      if (rows >= kTile) {
        dkv_tile<false, HD>(ak, av, ka, va, qs + cur * kBuf, os + cur * kBuf, lt, part, rows, scale);
      } else {
        dkv_tile<true, HD>(ak, av, ka, va, qs + cur * kBuf, os + cur * kBuf, lt, part, rows, scale);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if constexpr (kF32Split > 1) {
    float* red = reinterpret_cast<float*>(smem) + group * 32 * HD;  // the staging is free now
    if (part == 1) {
      park<HD>(red, ak);
      park<HD>(red + 16 * HD, av);
    }
    __syncthreads();
    if (part == 1) return;
    unpark<HD>(red, ak);
    unpark<HD>(red + 16 * HD, av);
  }
  if (k0 >= t) return;
  const int64_t g_off = lay.head(lay.grad, slab);
  store_rows_f32<HD>(dk + g_off, lay.grad.t, k0, t, ak);
  store_rows_f32<HD>(dv + g_off, lay.grad.t, k0, t, av);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Opt in to the dynamic shared memory a launch needs (above 48 KB it must be
// asked for); a size past the device's limit fails here.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) (void)cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

// Launch `kernel` over `blocks` blocks of `threads` with `smem` bytes.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The arguments every entry point checks: shapes in range, strides (in
// elements) non-negative and 16-byte aligned, and a grid that fits.
bool valid(int batch, int heads, int t, int hd, int dtype, const int64_t* strides, int n_strides) {
  const int64_t align = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (batch < 1 || heads < 1 || t < 1 || hd < 16 || hd > kMaxHd || hd % 16 != 0 || (dtype != 0 && dtype != 1)) {
    return false;
  }
  for (int i = 0; i < n_strides; ++i) {
    if (strides[i] < 0 || strides[i] % align != 0) return false;
  }
  const int64_t blocks = static_cast<int64_t>(batch) * heads * ((t + kTile - 1) / kTile);
  return blocks <= 0x7fffffff;
}

// bf16 K7 over `slabs` slabs: blocks of kFwdRows query rows.
template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int slabs, const Layout& lay,
             float scale, cudaStream_t s) {
  const int q_blocks = (lay.t + kFwdRows - 1) / kFwdRows;
  return launch(flash_fwd_bf16<HD>, slabs * q_blocks, kFwdThreads, smem_bytes_fwd_bf16(HD), s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<bf16*>(o), lse, lay, q_blocks, scale);
}

// bf16 K9 over `slabs` slabs: blocks of kDqRows query rows.
template <int HD>
int dq_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
            float* di, void* dq, int slabs, const Layout& lay, float scale, cudaStream_t s) {
  const int q_blocks = (lay.t + kDqRows - 1) / kDqRows;
  return launch(flash_dq_bf16<HD>, slabs * q_blocks, kDqThreads, smem_bytes_dq_bf16(HD), s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), lay,
                q_blocks, scale);
}

// bf16 K8 over `slabs` slabs: blocks of kDkvKeys keys.
template <int HD>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* di,
             void* dk, void* dv, int slabs, const Layout& lay, float scale, cudaStream_t s) {
  const int k_blocks = (lay.t + kDkvKeys - 1) / kDkvKeys;
  return launch(flash_dkv_bf16<HD>, slabs * k_blocks, kDkvThreads, smem_bytes_dkv_bf16(HD), s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lay,
                k_blocks, scale);
}

template <int HD>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int blocks, int tiles, const Layout& lay,
            float scale, cudaStream_t s) {
  return launch(flash_fwd_f32<HD>, blocks, kF32Threads, smem_bytes_fwd_f32<HD>(), s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o), lse, lay, tiles,
                scale);
}

template <int HD>
int dq_f32(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* di,
           void* dq, int blocks, int tiles, const Layout& lay, float scale, cudaStream_t s) {
  return launch(flash_dq_f32<HD>, blocks, kF32Threads, smem_bytes_bwd_f32<HD>(false), s,
                static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(o), static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), lay,
                tiles, scale);
}

template <int HD>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* di,
            void* dk, void* dv, int blocks, int tiles, const Layout& lay, float scale, cudaStream_t s) {
  return launch(flash_dkv_f32<HD>, blocks, kF32Threads, smem_bytes_bwd_f32<HD>(true), s,
                static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv), lay,
                tiles, scale);
}

// Resident blocks per SM of `kernel` launched with `threads` threads and
// `smem` bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative
// cudaError_t if the query failed.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The same for float32 K7, K9 or K8 (kernel = 7, 9 or 8) at head dim HD.
template <int HD>
int f32_blocks_per_sm(int kernel) {
  switch (kernel) {
    case 7: return blocks_per_sm(flash_fwd_f32<HD>, kF32Threads, smem_bytes_fwd_f32<HD>());
    case 9: return blocks_per_sm(flash_dq_f32<HD>, kF32Threads, smem_bytes_bwd_f32<HD>(false));
    default: return blocks_per_sm(flash_dkv_f32<HD>, kF32Threads, smem_bytes_bwd_f32<HD>(true));
  }
}

// The same for bf16 K7 at head dim HD, with the threads of a block in *threads.
template <int HD>
int fwd_bf16_blocks_per_sm(int* threads) {
  *threads = kFwdThreads;
  return blocks_per_sm(flash_fwd_bf16<HD>, kFwdThreads, smem_bytes_fwd_bf16(HD));
}

// The same for bf16 K9 or K8 (kernel = 9 or 8) at head dim HD, with the
// threads of a block in *threads.
template <int HD>
int bwd_bf16_blocks_per_sm(int kernel, int* threads) {
  if (kernel == 9) {
    *threads = kDqThreads;
    return blocks_per_sm(flash_dq_bf16<HD>, kDqThreads, smem_bytes_dq_bf16(HD));
  }
  *threads = kDkvThreads;
  return blocks_per_sm(flash_dkv_bf16<HD>, kDkvThreads, smem_bytes_dkv_bf16(HD));
}

// Calls fn<HD>(args...) for the runtime head dim (a multiple of 16 up to 128).
#define THEIA_FLASH_BY_HD(fn, hd, ...)                 \
  switch (hd) {                                        \
    case 16: return fn<16>(__VA_ARGS__);               \
    case 32: return fn<32>(__VA_ARGS__);               \
    case 48: return fn<48>(__VA_ARGS__);               \
    case 64: return fn<64>(__VA_ARGS__);               \
    case 80: return fn<80>(__VA_ARGS__);               \
    case 96: return fn<96>(__VA_ARGS__);               \
    case 112: return fn<112>(__VA_ARGS__);             \
    default: return fn<128>(__VA_ARGS__);              \
  }

}  // namespace

extern "C" {

// K7. q, k, v: [batch, t, heads, hd] with strides (in_bstride, in_tstride);
// o: the same shape with (out_bstride, out_tstride). Every tensor has unit
// stride over hd and heads hd apart; strides are in elements (a stride of a
// dimension of size 1 is never used); pointers and strides are 16-byte
// aligned. lse: float32 [batch * heads, t], contiguous. dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for arguments out of range).
int theia_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int heads, int t,
                    int hd, int64_t in_bstride, int64_t in_tstride, int64_t out_bstride, int64_t out_tstride,
                    int dtype, float scale, void* stream) {
  const int64_t strides[4] = {in_bstride, in_tstride, out_bstride, out_tstride};
  if (!valid(batch, heads, t, hd, dtype, strides, 4)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{t, heads, hd, {in_bstride, in_tstride}, {out_bstride, out_tstride}, {0, 0}, {0, 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int tiles = (t + kTile - 1) / kTile;
    THEIA_FLASH_BY_HD(fwd_f32, hd, q, k, v, o, lse, batch * heads * tiles, tiles, lay, scale, s)
  }
  THEIA_FLASH_BY_HD(fwd_bf16, hd, q, k, v, o, lse, batch * heads, lay, scale, s)
}

// K9. q, k, v as for K7; o: K7's output with strides (out_bstride,
// out_tstride); dout: the gradient of o with (do_bstride, do_tstride); dq:
// with (grad_bstride, grad_tstride). lse: K7's float32 [batch * heads, t];
// di: float32 [batch * heads, t] that this kernel writes (rowsum(o * dout))
// for K8. Returns as theia_flash_fwd.
int theia_flash_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                   float* di, void* dq, int batch, int heads, int t, int hd, int64_t in_bstride, int64_t in_tstride,
                   int64_t out_bstride, int64_t out_tstride, int64_t do_bstride, int64_t do_tstride,
                   int64_t grad_bstride, int64_t grad_tstride, int dtype, float scale, void* stream) {
  const int64_t strides[8] = {in_bstride,  in_tstride,  out_bstride,  out_tstride,
                              do_bstride, do_tstride, grad_bstride, grad_tstride};
  if (!valid(batch, heads, t, hd, dtype, strides, 8)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{t, heads, hd, {in_bstride, in_tstride}, {out_bstride, out_tstride}, {do_bstride, do_tstride},
                   {grad_bstride, grad_tstride}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int tiles = (t + kTile - 1) / kTile;
    THEIA_FLASH_BY_HD(dq_f32, hd, q, k, v, o, dout, lse, di, dq, batch * heads * tiles, tiles, lay, scale, s)
  }
  THEIA_FLASH_BY_HD(dq_bf16, hd, q, k, v, o, dout, lse, di, dq, batch * heads, lay, scale, s)
}

// K8. q, k, v, dout, lse as for K9; di: K9's output; dk, dv: with
// (grad_bstride, grad_tstride). Returns as theia_flash_fwd.
int theia_flash_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* di,
                    void* dk, void* dv, int batch, int heads, int t, int hd, int64_t in_bstride, int64_t in_tstride,
                    int64_t do_bstride, int64_t do_tstride, int64_t grad_bstride, int64_t grad_tstride, int dtype,
                    float scale, void* stream) {
  const int64_t strides[6] = {in_bstride, in_tstride, do_bstride, do_tstride, grad_bstride, grad_tstride};
  if (!valid(batch, heads, t, hd, dtype, strides, 6)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{t, heads, hd, {in_bstride, in_tstride}, {0, 0}, {do_bstride, do_tstride},
                   {grad_bstride, grad_tstride}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int tiles = (t + kTile - 1) / kTile;
    THEIA_FLASH_BY_HD(dkv_f32, hd, q, k, v, dout, lse, di, dk, dv, batch * heads * tiles, tiles, lay, scale, s)
  }
  THEIA_FLASH_BY_HD(dkv_bf16, hd, q, k, v, dout, lse, di, dk, dv, batch * heads, lay, scale, s)
}

// Resident blocks per SM of the float32 K7, K9 or K8 (kernel = 7, 9 or 8)
// at head dim hd, with the threads of one of their blocks in *threads; a
// negative cudaError_t if the query failed.
int theia_flash_f32_blocks_per_sm(int hd, int kernel, int* threads) {
  if (hd < 16 || hd > kMaxHd || hd % 16 != 0 || kernel < 7 || kernel > 9) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  *threads = kF32Threads;
  THEIA_FLASH_BY_HD(f32_blocks_per_sm, hd, kernel)
}

// Resident blocks per SM of the bf16 K7 at head dim hd, with the threads of
// one of its blocks in *threads; a negative cudaError_t if the query failed.
int theia_flash_fwd_bf16_blocks_per_sm(int hd, int* threads) {
  if (hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  THEIA_FLASH_BY_HD(fwd_bf16_blocks_per_sm, hd, threads)
}

// Resident blocks per SM of the bf16 K9 or K8 (kernel = 9 or 8) at head
// dim hd, with the threads of one of their blocks in *threads; a negative
// cudaError_t if the query failed.
int theia_flash_bwd_bf16_blocks_per_sm(int hd, int kernel, int* threads) {
  if (hd < 16 || hd > kMaxHd || hd % 16 != 0 || (kernel != 8 && kernel != 9)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  THEIA_FLASH_BY_HD(bwd_bf16_blocks_per_sm, hd, kernel, threads)
}

}  // extern "C"
