// Multi-head attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces theia_tpu/ops/attention.py::_mha_bwd_kernel (launched by
// _pallas_mha_bwd, the backward of the _pallas_mha custom_vjp). Q, K, V and
// the gradients dQ, dK, dV are [B, T, H, hd] with unit stride over hd and
// heads hd apart, and any batch and token strides (views into the packed
// QKV projection and into its packed gradient); dO has strides of its own.
// For each (batch, head) slab, [T, hd], the TPU kernel's math:
//   S = Q K^T * scale in float32, P = softmax(S) in float32;
//   dV = bf(P)^T dO;  dP = dO V^T in float32;
//   dS = P * (dP - rowsum(dP * P)) * scale;  dQ = bf(dS) K;  dK = bf(dS)^T Q;
// where bf() rounds to the input dtype (what astype(v.dtype) does; the
// identity for float32) and every product accumulates in float32. The row
// sum is over dP * P with dP = dO V^T, as in the JAX kernel, not
// FlashAttention's rowsum(dO * O): the two differ once P rounds to bf16.
//
// What bounds it on the H100. At [16*12, 197, 64] bf16 the kernel must move
// ~34 MB (10 us at 3.35 TB/s) and do 4.8 GFLOP (5 us on the tensor cores):
// memory. Each slab is small (T <= 256), so what a version does about it
// is keep every T x T quantity out of device memory and read Q, K, V, dO
// where they lie. In float32 the same 4.8 GFLOP take 71 us at the CUDA
// cores' 67 TFLOP/s, and 29 us as three tf32 products each at the tensor
// cores' 495: operations, so float32 runs on the tensor cores too.
//
// The design problem is the two reduction directions: dQ sums over keys,
// dK and dV over queries. The TPU kernel holds the whole T x T P and dS of
// a slab in VMEM; a Hopper block cannot hold both. So the backward is two
// passes, each a kernel that owns one direction and needs no atomics (the
// results are deterministic):
//   row pass: recomputes a row's S and P, forms dP and rowsum(dP * P),
//     writes dQ, and stores the row's max, sum and row sum (12 bytes);
//   column pass: recomputes P and dS for its keys from those statistics,
//     and writes dK and dV.
//
// bf16, wgmma (mha_bwd_rows_bf16<HD, NC>, mha_bwd_cols_bf16<HD>): both
//   passes issue Hopper's warpgroup products over operands staged once a
//   block by cp.async in wgmma's 128-byte swizzle (wgmma_bf16.cuh), with the
//   numerics above: S rounded by __fmul_rn, the exact expf, P = p / l the
//   IEEE quotient from one reciprocal a row (div_rn.cuh), sums in float32.
//   Row pass: a block owns 64 query rows of a slab and kRowWgs warpgroups,
//   each with NC chunks of 64 keys. S = Q K^T and dP = dO V^T are m64n64k16
//   products with both operands in shared memory, the first chunk's dP in
//   flight during the softmax; the row max, sum and rowsum(dP * P) meet
//   between the warpgroups through shared memory, in part order. dP is
//   formed once a chunk: the last chunk's stays in registers for dS, an
//   earlier one is parked in shared memory (Q's area, free once S has
//   retired). dS, rounded to bf16 in the accumulator layout, is the register
//   A of dQ = dS K (K the MN-major B, the transpose bit); the warpgroups'
//   partial dQ meet in part order through the staging area. Column pass: a
//   warpgroup owns 64 keys, kColWgs of them a block, sharing Q and dO (each
//   the K-major B of one product and the MN-major B of another) and the
//   rows' max, sum, 1 / sum and row sum; it steps over kColN queries at a
//   time: S^T = K Q^T and dP^T = V dO^T (K and V the A in shared memory),
//   then P^T and dS^T in the accumulator layout, rounded to bf16, are the
//   register A of dV += P^T dO and dK += dS^T Q. 7 products in all, the
//   least the math needs; no atomics.
//   What bounds it on the H100, at [16*12, 197, 64]: neither the bytes nor
//   the tensor cores (~10.5 GFLOP of products padded to 64-row tiles, 11
//   us at the dense peak), but each
//   block's staging (every row block stages its slab's K and V, every column
//   block its Q and dO: ~95 MB through L2 in all) and the softmax's
//   elementwise work (an expf through the special-function unit and ~25
//   other instructions a score, on 256 x 256 padded scores a slab for 197 x
//   197 real ones) at 16 resident warps a SM. Two blocks of 256 threads a
//   SM in both passes let one block's staging overlap the other's
//   arithmetic, so 2 warpgroups a row block beat 4 (one block of 512
//   threads a SM, whose staging nothing hides; PERF.md, section 6).
//
// float32, tensor cores as 3xTF32 (mha_bwd_rows_f32, mha_bwd_cols_f32):
//   no tensor-core instruction multiplies in full float32, so each product
//   is three tf32 mma.sync m16n8k8 over operands split into big and small
//   halves (mma_tf32.cuh), ~2^-21 relative, against the 2^-11 of one tf32
//   product. On the H100 these passes are bound by latency, not by the
//   tensor cores: more resident warps and fewer instructions moved them,
//   more independent chains of products did not (PERF.md, section 6), so
//   the design goes for resident warps and few instructions.
//   Row pass: 4 warps share a group of 16 query rows, part p holding key
//   tiles p, p + 4, ...: a thread keeps 4 floats of S, then P, for each of
//   its tiles (32 registers at T = 256), which fits 16 warps a block in the
//   128 registers a thread that one block of 512 threads may use (hd <= 64;
//   8 warps above). S = Q K^T is formed a k-step at a time over the warp's
//   tiles, so one k-step of Q is live; the parts' maxima, sums and row sums
//   meet in shared memory behind a named barrier of the group. dP = dO V^T
//   is formed once a tile, kept for dS, and summed into rowsum(dP * P). dQ
//   = dS K takes each dS tile straight from the accumulators as its A
//   operand, with the reduction index permuted and K's B fragments read
//   down columns in the same order; parts 1..3 park their partial dQ in
//   dQ, dK and dV, which part 0 adds in part order (the column pass writes
//   dK and dV afterwards). Column pass: a warp owns 16 keys and streams over
//   8-query tiles, 8 warps a block (one block a SM: K, V and the dK, dV
//   accumulators take ~250 registers a thread); S^T = K Q^T and dP^T = V dO^T
//   put P^T and dS^T in the
//   accumulator layout that is the A operand of dV = P^T dO and dK = dS^T Q,
//   so nothing is transposed through shared memory. Both passes add S's and
//   dP's terms in one order (the column pass issues its correction terms
//   transposed), with the scale multiply pinned (__fmul_rn), the exact expf
//   and the IEEE division, so a P and a dS are the same numbers in both. The
//   other operand (dO in the row pass, K and V in the column pass) is read
//   once from global memory, kept in registers as float32 and split at each
//   use; for HD >= 112 the column pass takes dV and dK in two sweeps
//   over the queries (S^T formed twice), so that no sweep holds more than
//   three HD-wide fragments a thread. K and V (Q and dO) are staged whole
//   with cp.async (K and V as two groups, so that S starts before V has
//   arrived) in rows of pitch HD + 4 floats, which reads 32 distinct
//   banks both along rows (B of S and dP: address g * pitch + tq) and down
//   columns (B of dQ, dK, dV: 2tq * pitch + g). A block needs 2 *
//   round8(T) * (HD + 4) * 4 bytes and a little more: hd = 112 takes T <=
//   240 and hd = 128 T <= 216 within the card's 227 KB; past that the
//   launch returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "div_rn.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxT = 256;
constexpr int kMaxHd = 128;
constexpr int kMaxKeyTiles = kMaxT / 8;

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
  Strides dout;  // dO
  Strides grad;  // dq, dk, dv

  __device__ __forceinline__ int64_t head(const Strides& s, int slab) const {
    return static_cast<int64_t>(slab / heads) * s.b + static_cast<int64_t>(slab % heads) * hd;
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

// The passes' block shapes may be set with -D (THEIA_K2_BF16_ROW_SPLIT,
// THEIA_K2_BF16_COL_N, THEIA_K2_BF16_COL_WG) to time the alternatives
// (tools/time_mha_bwd.py --dtype bfloat16 --ablations); the defaults are the
// fastest measured.
#ifndef THEIA_K2_BF16_ROW_SPLIT
#define THEIA_K2_BF16_ROW_SPLIT 2
#endif
#ifndef THEIA_K2_BF16_COL_N
#define THEIA_K2_BF16_COL_N 32
#endif
#ifndef THEIA_K2_BF16_COL_WG
#define THEIA_K2_BF16_COL_WG 2
#endif

constexpr int kWgThreads = 128;                   // one warpgroup
constexpr int kTile = 64;                         // rows of a wgmma tile: a row-pass block's queries, a chunk of keys
constexpr int kRowWgs = THEIA_K2_BF16_ROW_SPLIT;  // warpgroups a row-pass block, each with 1/kRowWgs of the keys
constexpr int kRowMaxChunks = kMaxT / (kRowWgs * kTile);  // 64-key chunks a warpgroup holds at T = 256
constexpr int kColN = THEIA_K2_BF16_COL_N;        // queries a step of the column pass
constexpr int kColWgs = THEIA_K2_BF16_COL_WG;     // warpgroups a column-pass block, 64 keys each
constexpr int kPartPitch = 8;                     // floats of padding a row of a partial dQ in shared memory
static_assert(kRowWgs == 2 || kRowWgs == 4, "the row pass splits the keys over 2 or 4 warpgroups");
static_assert(kColN == 32 || kColN == 64, "the column pass steps over 32 or 64 queries");
static_assert(kColWgs == 1 || kColWgs == 2, "a column-pass block has 1 or 2 warpgroups");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row pass shared memory: dO (64 rows), K and V (kRowWgs * nc chunks of 64
// keys each, zeros past T) and Q (64 rows), each in round64(hd) / 64
// swizzle atoms of 128-byte rows. Once S has retired, the dP of chunks 0 ..
// nc - 2 (32 floats a thread and chunk) is parked from Q's area on; once
// every product has retired, the partial dQ of every warpgroup,
// [kRowWgs][64][hd + kPartPitch] floats, takes the area from its start.
// Then the warpgroups' row max, sum and row sum [3][kRowWgs][64], and 1 KB
// to align the base to the swizzle's period.
__host__ __device__ constexpr int rows_staging_bytes(int hd, int nc) {
  const int staged = round64(hd) / 64 * (2 * kTile + 2 * kRowWgs * nc * kTile) * 128;
  const int parked = staged - round64(hd) / 64 * kTile * 128 + (nc - 1) * kRowWgs * kWgThreads * 32 * 4;
  const int partial = kRowWgs * kTile * (hd + kPartPitch) * 4;
  const int used = staged > parked ? staged : parked;
  return used > partial ? used : partial;
}

size_t smem_bytes_rows_bf16(int hd, int nc) {
  return 1024 + rows_staging_bytes(hd, nc) + 3 * kRowWgs * kTile * sizeof(float);
}

// Column pass shared memory: K and V (kColWgs * 64 keys each), then Q and
// dO (T rounded up to kColN queries each, zeros past T), in swizzle atoms;
// then each query's max, sum, 1 / sum and row sum as a float4.
size_t smem_bytes_cols_bf16(int t, int hd) {
  const size_t tn = round_up(t, kColN);
  return 1024 + static_cast<size_t>(round64(hd) / 64) * (2 * kColWgs * kTile + 2 * tn) * 128 + tn * sizeof(float4);
}

// A p that div_rn does not cover (div_rn.cuh); p = 0 divides exactly.
__device__ __forceinline__ bool below_div_rn(float p) { return p > 0.f && p < kDivRnMin; }

// a = op(a, the other lanes' a) over the 4 lanes of a fragment row group; b the same.
template <typename Op>
__device__ __forceinline__ void quad_reduce(float& a, float& b, Op op) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    a = op(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = op(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
}

// The row pass's warpgroups combine their values a, b of rows rw and rw + 8
// through red[kRowWgs][64], in part order, so that all of them end with the
// same numbers.
template <typename Op>
__device__ __forceinline__ void meet_parts(float* red, int wg, int rw, float& a, float& b, Op op) {
  if ((threadIdx.x & 3) == 0) {
    red[wg * kTile + rw] = a;
    red[wg * kTile + rw + 8] = b;
  }
  __syncthreads();
  a = red[rw];
  b = red[rw + 8];
#pragma unroll
  for (int p = 1; p < kRowWgs; ++p) {
    a = op(a, red[p * kTile + rw]);
    b = op(b, red[p * kTile + rw + 8]);
  }
}

// Row pass: a block owns 64 query rows of one slab and kRowWgs warpgroups,
// warpgroup w holding keys w * NC * 64 .. (w + 1) * NC * 64 - 1. Every loop
// that issues a wgmma has a bound known to the compiler and no branch
// around a product depends on the warp: a wgmma under a branch ptxas cannot
// prove uniform is serialized (ptxas C7520). Keys past T are masked to
// -inf, rows past T are computed on zeros and never stored.
template <int HD, int NC>
__global__ void __launch_bounds__(kRowWgs * kWgThreads, 4 / kRowWgs)
    mha_bwd_rows_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, Layout lay, int row_blocks,
                      float scale) {
  constexpr int kThreads = kRowWgs * kWgThreads;
  constexpr int kKeys = kRowWgs * NC * kTile;   // keys staged
  constexpr uint32_t kRowAtom = kTile * 128;    // bytes of a swizzle atom of Q or dO
  constexpr uint32_t kKeyAtom = kKeys * 128;    // of K or V
  constexpr int kAtoms = round64(HD) / 64;
  constexpr int kKeySteps = NC * kTile / 16;    // k16 steps of dQ = dS K a warpgroup
  constexpr int kPitch = HD + kPartPitch;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* os = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = os + kAtoms * kRowAtom;
  unsigned char* vs = ks + kAtoms * kKeyAtom;
  unsigned char* qs = vs + kAtoms * kKeyAtom;
  float4* parked = reinterpret_cast<float4*>(qs);  // [NC - 1][8][kThreads], once S has retired
  float* part = reinterpret_cast<float*>(os);  // [kRowWgs][64][kPitch], once every product has retired
  float* red = reinterpret_cast<float*>(os + rows_staging_bytes(HD, NC));  // [3][kRowWgs][64]
  const int t = lay.t;

  const int slab = blockIdx.x / row_blocks;  // head-major: a slab's row blocks share its K and V in L2
  const int row0 = (blockIdx.x - slab * row_blocks) * kTile;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const int64_t ts = lay.qkv.t;
  const __nv_bfloat16* doh = dout + lay.head(lay.dout, slab) + row0 * lay.dout.t;
  stage_sw128<HD, kThreads>(qs, q + in_off + row0 * ts, ts, t - row0, kTile);  // copy groups 1, 2: Q, K
  stage_sw128<HD, kThreads>(ks, k + in_off, ts, t, kKeys);
  stage_sw128<HD, kThreads>(os, doh, lay.dout.t, t - row0, kTile);  // 3, 4: dO, V, in flight during S
  stage_sw128<HD, kThreads>(vs, v + in_off, ts, t, kKeys);
  cp_async_wait<2>();
  fence_proxy_async();
  __syncthreads();  // Q and K are in shared memory

  // S = Q K^T over this warpgroup's keys: sc[c][4i + e] is row (e < 2 ?
  // rw : rw + 8), key key0 + 64c + 8i + 2tq + (e & 1).
  const int wg = threadIdx.x / kWgThreads;
  const int key0 = wg * NC * kTile;
  const uint32_t qaddr = smem_addr(qs), oaddr = smem_addr(os);
  const uint32_t kaddr = smem_addr(ks) + key0 * 128, vaddr = smem_addr(vs) + key0 * 128;
  float sc[NC][32];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) wgmma_abt<HD>(sc[c], qaddr, kRowAtom, kaddr + c * kTile * 128, kKeyAtom);
  wgmma_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // dO and V are in shared memory
  float dp[32];
  wgmma_fence();
  wgmma_abt<HD>(dp, oaddr, kRowAtom, vaddr, kKeyAtom);  // dP = dO V^T of chunk 0, during the softmax
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_all(sc[c]);

  // Softmax over each row in float32: a row's keys are spread over the 4
  // lanes of its group in each warpgroup, so max and sum finish with two
  // xor-shuffles and one exchange between the warpgroups.
  const int tq = threadIdx.x & 3;
  const int rw = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);  // row - row0
  const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
  const auto sum2 = [](float x, float y) { return x + y; };
  float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = key0 + c * kTile + 8 * (e >> 2) + 2 * tq + (e & 1);
      sc[c][e] = key < t ? __fmul_rn(sc[c][e], scale) : -INFINITY;  // as the column pass rounds it
      if (e & 2) {
        m_b = fmaxf(m_b, sc[c][e]);
      } else {
        m_a = fmaxf(m_a, sc[c][e]);
      }
    }
  }
  quad_reduce(m_a, m_b, fmax2);
  meet_parts(red, wg, rw, m_a, m_b, fmax2);
  float l_a = 0.f, l_b = 0.f;
  bool tiny = false;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[c][e] = expf(sc[c][e] - ((e & 2) ? m_b : m_a));  // 0 for a key past T (S = -inf)
      tiny = tiny || below_div_rn(sc[c][e]);
      if (e & 2) {
        l_b += sc[c][e];
      } else {
        l_a += sc[c][e];
      }
    }
  }
  quad_reduce(l_a, l_b, sum2);
  meet_parts(red + kRowWgs * kTile, wg, rw, l_a, l_b, sum2);

  // P = p / l in float32, the IEEE quotient: div_rn from one reciprocal a
  // row, or, where a p of the warp lies below its range, the IEEE division
  // itself, in a loop over a local copy (one division in the code, nothing
  // live across it) after which div_rn divides by 1.
  float dl_a = l_a, dl_b = l_b, rl_a = 1.f / l_a, rl_b = 1.f / l_b;
  if (__any_sync(0xffffffffu, tiny)) {
    float p_local[NC * 32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) p_local[c * 32 + e] = sc[c][e];
#pragma unroll 1
    for (int i = 0; i < NC * 32; ++i) p_local[i] = div_ieee(p_local[i], (i & 2) ? l_b : l_a);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[c][e] = p_local[c * 32 + e];
    dl_a = dl_b = rl_a = rl_b = 1.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[c][e] = (e & 2) ? div_rn(sc[c][e], dl_b, rl_b) : div_rn(sc[c][e], dl_a, rl_a);

  // rowsum(dP * P), dP = dO V^T formed once a chunk: the last chunk's stays
  // in registers for dS; where P and dP of every chunk would pass the
  // registers (NC = 2), the earlier chunks' are parked in shared memory,
  // each thread reading back only what it wrote (Q's area is free: every
  // warpgroup's S retired before the max met).
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c > 0) {
      wgmma_fence();
      wgmma_abt<HD>(dp, oaddr, kRowAtom, vaddr + c * kTile * 128, kKeyAtom);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_all(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (e & 2) {
        rs_b += dp[e] * sc[c][e];
      } else {
        rs_a += dp[e] * sc[c][e];
      }
    }
    if (c < NC - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        parked[(c * 8 + i) * kThreads + threadIdx.x] = make_float4(dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
      }
    }
  }
  quad_reduce(rs_a, rs_b, sum2);
  meet_parts(red + 2 * kRowWgs * kTile, wg, rw, rs_a, rs_b, sum2);

  // dS = P (dP - rowsum) scale, rounded to bf16 in the accumulator layout:
  // the S tiles 2j and 2j + 1 (of 8 keys each) are the A fragment of k16
  // step j of dQ = dS K.
  uint32_t da[kKeySteps][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float dpc[32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = c < NC - 1 ? parked[(c * 8 + i) * kThreads + threadIdx.x]
                                  : make_float4(dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
      dpc[4 * i] = x.x;
      dpc[4 * i + 1] = x.y;
      dpc[4 * i + 2] = x.z;
      dpc[4 * i + 3] = x.w;
    }
    const auto ds = [&](int e) { return sc[c][e] * (dpc[e] - ((e & 2) ? rs_b : rs_a)) * scale; };
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * c + jj, e = 8 * jj;
      da[j][0] = pack_bf16(ds(e), ds(e + 1));
      da[j][1] = pack_bf16(ds(e + 2), ds(e + 3));
      da[j][2] = pack_bf16(ds(e + 4), ds(e + 5));
      da[j][3] = pack_bf16(ds(e + 6), ds(e + 7));
    }
  }

  // dQ = dS K over this warpgroup's keys: K is the MN-major B operand (keys
  // down, dims across), one m64n(HD)k16 wgmma per 16 keys.
  float acc[HD / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j) {
    wgmma_rs<1>(acc, da[j], desc_sw128(kaddr + j * 16 * 128, kKeyAtom, 1024), j > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(acc);
  fence_all(da);

  // The warpgroups' partial dQ meet through shared memory, in part order.
  __syncthreads();  // every product of the block has retired: the staging area is free
  float* mine = part + wg * kTile * kPitch;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * tq;
    *reinterpret_cast<float2*>(mine + rw * kPitch + d) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(mine + (rw + 8) * kPitch + d) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  __nv_bfloat16* dqh = dq + lay.head(lay.grad, slab);
  for (int i = threadIdx.x; i < kTile * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    const int d = (i - r * (HD / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(part + r * kPitch + d);
#pragma unroll
    for (int p = 1; p < kRowWgs; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(part + (p * kTile + r) * kPitch + d);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    if (row0 + r < t) {
      *reinterpret_cast<uint2*>(dqh + (row0 + r) * lay.grad.t + d) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
  }
  if (wg == 0 && tq == 0) {
    float* st = stats + static_cast<int64_t>(slab) * 3 * t;
    const int ra = row0 + rw;
    const int rb = ra + 8;
    if (ra < t) {
      st[ra] = m_a;
      st[t + ra] = l_a;
      st[2 * t + ra] = rs_a;
    }
    if (rb < t) {
      st[rb] = m_b;
      st[t + rb] = l_b;
      st[2 * t + rb] = rs_b;
    }
  }
}

// Registers: at HD + kColN <= 96 (the dV, dK, S^T and dP^T accumulators
// within 96 floats a thread) the column pass keeps 2 blocks of 256 threads
// (4 of 128) a SM at 128 registers; above, ptxas may take up to 255.
template <int HD>
__host__ __device__ constexpr int col_min_blocks() {
  return HD + kColN <= 96 ? 512 / (kColWgs * kWgThreads) : 1;
}

// Column pass: a warpgroup owns 64 keys, kColWgs of them a block, sharing
// Q and dO (staged once, each the K-major B of one product and the
// MN-major B of another) and the row statistics. Queries past T have max
// +inf, so their p = exp(-inf) = 0; keys past T are computed on zeros and
// never stored.
template <int HD>
__global__ void __launch_bounds__(kColWgs * kWgThreads, col_min_blocks<HD>())
    mha_bwd_cols_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      const float* __restrict__ stats, Layout lay, int key_blocks, float scale) {
  constexpr int kThreads = kColWgs * kWgThreads;
  constexpr int kKeys = kColWgs * kTile;      // keys a block
  constexpr uint32_t kKeyAtom = kKeys * 128;  // bytes of a swizzle atom of K or V
  constexpr int kAtoms = round64(HD) / 64;
  constexpr int N = kColN;
  extern __shared__ unsigned char smem_raw[];
  const int t = lay.t;
  const int tn = round_up(t, N);           // queries staged
  const uint32_t q_atom = tn * 128;        // bytes of a swizzle atom of Q or dO
  unsigned char* ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + kAtoms * kKeyAtom;
  unsigned char* qs = vs + kAtoms * kKeyAtom;
  unsigned char* os = qs + kAtoms * q_atom;
  float4* qst = reinterpret_cast<float4*>(os + kAtoms * q_atom);  // [tn]: max, sum, 1 / sum, row sum

  const int slab = blockIdx.x / key_blocks;
  const int k0 = (blockIdx.x - slab * key_blocks) * kKeys;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const int64_t ts = lay.qkv.t;
  stage_sw128<HD, kThreads>(ks, k + in_off + k0 * ts, ts, t - k0, kKeys);
  stage_sw128<HD, kThreads>(vs, v + in_off + k0 * ts, ts, t - k0, kKeys);
  stage_sw128<HD, kThreads>(qs, q + in_off, ts, t, tn);
  stage_sw128<HD, kThreads>(os, dout + lay.head(lay.dout, slab), lay.dout.t, t, tn);
  const float* st = stats + static_cast<int64_t>(slab) * 3 * t;
  for (int i = threadIdx.x; i < tn; i += kThreads) {
    qst[i] = i < t ? make_float4(st[i], st[t + i], 1.f / st[t + i], st[2 * t + i]) : make_float4(INFINITY, 1.f, 1.f, 0.f);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // K, V, Q, dO and the statistics are in shared memory

  // Over steps of N queries: S^T = K Q^T and dP^T = V dO^T (element e of a
  // thread is key row (e < 2 ? rw : rw + 8), query q0 + 8i + 2tq + (e & 1)
  // for e in 4i .. 4i + 3), then P^T and dS^T in that layout, rounded to
  // bf16, as the register A operands of dV += P^T dO and dK += dS^T Q.
  const int wg = threadIdx.x / kWgThreads;
  const uint32_t kaddr = smem_addr(ks) + wg * kTile * 128, vaddr = smem_addr(vs) + wg * kTile * 128;
  const uint32_t qaddr = smem_addr(qs), oaddr = smem_addr(os);
  const int tq = threadIdx.x & 3;
  float dv_acc[HD / 2], dk_acc[HD / 2];  // set by the first step's products (scale_d 0)
  uint32_t pa[N / 16][4], da[N / 16][4];
  for (int q0 = 0; q0 < tn; q0 += N) {
    float s[N / 2], dp[N / 2];
    wgmma_fence();
    wgmma_abt<HD>(s, kaddr, kKeyAtom, qaddr + q0 * 128, q_atom);
    wgmma_commit();
    wgmma_abt<HD>(dp, vaddr, kKeyAtom, oaddr + q0 * 128, q_atom);  // during P^T
    wgmma_commit();
    wgmma_wait<1>();  // S^T, and the last step's dV and dK
    fence_all(s);
    fence_all(pa);
    const auto query = [&](int e) { return q0 + 8 * (e >> 2) + 2 * tq + (e & 1); };

    // P^T = p / l: the row pass's max and sum, the IEEE quotient (div_rn
    // with the query's 1 / l, or the IEEE division where a p of the warp
    // lies below div_rn's range)
    bool tiny = false;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      s[e] = expf(__fmul_rn(s[e], scale) - qst[query(e)].x);  // as the row pass rounds it; 0 past T
      tiny = tiny || below_div_rn(s[e]);
    }
    if (__any_sync(0xffffffffu, tiny)) {
      float p_local[N / 2];
#pragma unroll
      for (int e = 0; e < N / 2; ++e) p_local[e] = s[e];
#pragma unroll 1
      for (int e = 0; e < N / 2; ++e) p_local[e] = div_ieee(p_local[e], qst[query(e)].y);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) s[e] = p_local[e];
    } else {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const float4 x = qst[query(e)];
        s[e] = div_rn(s[e], x.y, x.z);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int e = 8 * j;
      pa[j][0] = pack_bf16(s[e], s[e + 1]);
      pa[j][1] = pack_bf16(s[e + 2], s[e + 3]);
      pa[j][2] = pack_bf16(s[e + 4], s[e + 5]);
      pa[j][3] = pack_bf16(s[e + 6], s[e + 7]);
    }

    wgmma_wait<0>();  // dP^T
    fence_all(dp);
    fence_all(da);
    const auto ds = [&](int e) { return s[e] * (dp[e] - qst[query(e)].w) * scale; };
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int e = 8 * j;
      da[j][0] = pack_bf16(ds(e), ds(e + 1));
      da[j][1] = pack_bf16(ds(e + 2), ds(e + 3));
      da[j][2] = pack_bf16(ds(e + 4), ds(e + 5));
      da[j][3] = pack_bf16(ds(e + 6), ds(e + 7));
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q the MN-major B (queries
    // down, dims across), one m64n(HD)k16 wgmma per 16 queries each
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wgmma_rs<1>(dv_acc, pa[j], desc_sw128(oaddr + (q0 + 16 * j) * 128, q_atom, 1024), q0 > 0 || j > 0);
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wgmma_rs<1>(dk_acc, da[j], desc_sw128(qaddr + (q0 + 16 * j) * 128, q_atom, 1024), q0 > 0 || j > 0);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_all(dv_acc);
  fence_all(dk_acc);
  fence_all(pa);
  fence_all(da);

  const int rw = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int ra = k0 + wg * kTile + rw;
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

// The row pass's block shape may be set with -D (THEIA_K2_ROW_SPLIT,
// THEIA_K2_ROW_WARPS) to time the alternatives (tools/time_mha_bwd.py
// --ablations); the defaults are the fastest measured.
#ifndef THEIA_K2_ROW_SPLIT
#define THEIA_K2_ROW_SPLIT 4
#endif

constexpr int kRowSplit = THEIA_K2_ROW_SPLIT;  // warps that share a 16-row group, each with 1/kRowSplit of the keys
constexpr int kRowMaxWarps = 16;
static_assert(kRowSplit <= 4, "parts 1 .. kRowSplit - 1 park their dQ in dQ, dK and dV");

// Warps a row-pass block: 16 (one block a SM at 128 registers a thread) up
// to hd = 64, 8 above, where S, dP, dO and dQ's fragments pass 128.
template <int HD>
__host__ __device__ constexpr int row_warps() {
#ifdef THEIA_K2_ROW_WARPS
  return THEIA_K2_ROW_WARPS;
#else
  return HD <= 64 ? 16 : 8;
#endif
}

template <int HD>
__host__ __device__ constexpr int row_rows() {  // rows a row-pass block
  return 16 * row_warps<HD>() / kRowSplit;
}

constexpr int kColWarps = 8;                     // warps a column-pass block
constexpr int kColKeys = 16 * kColWarps;         // keys a column-pass block
constexpr int kColTwoSweepsMinHd = 112;          // dV and dK in two sweeps from this head dim

__host__ __device__ constexpr int round8(int t) { return (t + 7) & ~7; }

// Shared memory: two staged [round8(T)][HD + 4] float32 tensors, and in the
// column pass the row statistics [3][round8(T)], in the row pass the key
// parts' max, sum and row sum [3][kRowMaxWarps][16].
size_t smem_bytes_f32(int t, int hd, bool cols) {
  const size_t t8 = round8(t);
  return (2 * t8 * (hd + 4) + 3 * (cols ? t8 : kRowMaxWarps * 16)) * sizeof(float);
}

// The KS warps of a row group (named barrier 1 + group) combine their
// partial values a, b of rows g and g + 8 in part order, through red[KS][16],
// so that all of them end with the same numbers.
template <typename Op>
__device__ __forceinline__ void combine_parts(float* red, int group, int part, float& a, float& b, Op op) {
  constexpr int KS = kRowSplit;
  if constexpr (KS > 1) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    if ((lane & 3) == 0) {
      red[part * 16 + g] = a;
      red[part * 16 + g + 8] = b;
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(KS * 32) : "memory");
    a = red[g];
    b = red[g + 8];
#pragma unroll
    for (int p = 1; p < KS; ++p) {
      a = op(a, red[p * 16 + g]);
      b = op(b, red[p * 16 + g + 8]);
    }
  }
}

// acc += 16 rows (r0 ..) of an [HD]-wide tensor in global memory, read past
// L1 (another warp wrote them), rows past T skipped.
template <int HD>
__device__ __forceinline__ void add_rows_f32(float (&acc)[HD / 8][4], const float* x, int64_t ts, int r0, int t) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = n * 8 + 2 * (lane & 3);
    if (ra < t) {
      const float2 y = __ldcg(reinterpret_cast<const float2*>(x + ra * ts + d));
      acc[n][0] += y.x;
      acc[n][1] += y.y;
    }
    if (rb < t) {
      const float2 y = __ldcg(reinterpret_cast<const float2*>(x + rb * ts + d));
      acc[n][2] += y.x;
      acc[n][3] += y.y;
    }
  }
}

// A row group is KS = kRowSplit warps that own the same 16 query rows;
// part p of a group holds key tiles p, p + KS, ... Their partial maxima,
// sums and row sums meet in shared memory; their partial dQ sums in global
// memory, parts 1 .. 3 parking theirs in dQ, dK and dV (which the column
// pass writes afterwards) for part 0 to add in part order.
template <int HD>
__global__ void __launch_bounds__(row_warps<HD>() * 32)
    mha_bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, float* dq, float* dk, float* dv, float* __restrict__ stats,
                     Layout lay, int row_blocks, float scale) {
  constexpr int KS = kRowSplit;
  static_assert(row_warps<HD>() <= kRowMaxWarps && row_warps<HD>() % KS == 0, "a block holds whole row groups");
  constexpr int kPitch = HD + 4;
  constexpr int kTiles = kMaxKeyTiles / KS;  // key tiles a warp holds at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t8 = round8(t);
  float* ks = reinterpret_cast<float*>(smem);  // [t8][kPitch]
  float* vs = ks + t8 * kPitch;                // [t8][kPitch]
  float* red = vs + t8 * kPitch;               // [3][kRowMaxWarps / KS][KS][16]: the parts' max, sum, row sum

  const int slab = blockIdx.x / row_blocks;  // head-major: a slab's blocks share its K, V in L2
  const int64_t in_off = lay.head(lay.qkv, slab);
  stage_rows_f32<HD>(ks, k + in_off, lay.qkv.t, t, t8);  // a commit group each: S needs K only
  stage_rows_f32<HD>(vs, v + in_off, lay.qkv.t, t, t8);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int group = warp / KS;
  const int part = warp - group * KS;
  const int r0 = (blockIdx.x - slab * row_blocks) * row_rows<HD>() + group * 16;
  cp_async_wait<1>();
  __syncthreads();  // K is in shared memory
  if (r0 >= t) {  // the group's KS warps leave together, once their part of V has landed
    cp_async_wait<0>();
    asm volatile("bar.arrive 15, %0;\n" ::"r"(row_warps<HD>() * 32) : "memory");
    return;
  }

  // S = Q K^T a k-step at a time over this warp's key tiles, so that one
  // k-step of Q is live: tile i holds keys 8n .. 8n+7, n = KS i + part;
  // element e of a tile is row (e < 2 ? a : b), key 8n + 2*tq + (e & 1).
  // Then P in place.
  const int key_tiles = t8 / 8;
  float sc[kTiles][4] = {};
#pragma unroll 1
  for (int s = 0; s < HD / 8; ++s) {
    float a[4];
    uint32_t a_big[4], a_small[4];
    load_a_f32(a, q + in_off, lay.qkv.t, r0, t, 8 * s);
    split_tf32(a, a_big, a_small);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      if (KS * i + part < key_tiles) {
        uint32_t b_big[2], b_small[2];
        b_rows<kPitch>(ks, 8 * (KS * i + part), 8 * s, b_big, b_small);
        mma_3xtf32(sc[i], a_big, a_small, b_big, b_small);
      }
    }
  }
  RowsA<HD> oa;  // loaded once S is formed, to keep registers free for it
  oa.load(dout + lay.head(lay.dout, slab), lay.dout.t, r0, t);
  const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
  const auto sum2 = [](float x, float y) { return x + y; };
  float* red_group = red + group * KS * 16;
  constexpr int kRedStride = kRowMaxWarps * 16;  // between the max, sum and row-sum slots
  float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int n = KS * i + part;
    if (n < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1);
        sc[i][e] = key < t ? __fmul_rn(sc[i][e], scale) : -INFINITY;  // as the column pass rounds it
      }
      m_a = fmaxf(m_a, fmaxf(sc[i][0], sc[i][1]));
      m_b = fmaxf(m_b, fmaxf(sc[i][2], sc[i][3]));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, off));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, off));
  }
  combine_parts(red_group, group, part, m_a, m_b, fmax2);
  float l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int n = KS * i + part;
    if (n < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1);
        sc[i][e] = key < t ? expf(sc[i][e] - (e < 2 ? m_a : m_b)) : 0.f;
      }
      l_a += sc[i][0] + sc[i][1];
      l_b += sc[i][2] + sc[i][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  combine_parts(red_group + kRedStride, group, part, l_a, l_b, sum2);

  cp_async_wait<0>();
  asm volatile("bar.sync 15, %0;\n" ::"r"(row_warps<HD>() * 32) : "memory");  // every thread's V is in shared memory
  // P, dP = dO V^T one 8-key tile at a time (kept), and rowsum(dP * P).
  float dp[kTiles][4];
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int n = KS * i + part;
    if (n < key_tiles) {
      sc[i][0] /= l_a;
      sc[i][1] /= l_a;
      sc[i][2] /= l_b;
      sc[i][3] /= l_b;
      mma_rows_f32<true>(dp[i], oa, vs, n);
      rs_a += dp[i][0] * sc[i][0] + dp[i][1] * sc[i][1];
      rs_b += dp[i][2] * sc[i][2] + dp[i][3] * sc[i][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  combine_parts(red_group + 2 * kRedStride, group, part, rs_a, rs_b, sum2);

  // dS in place of P; then dQ = dS K, each dS tile the A operand of its 8
  // keys.
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    if (KS * i + part < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = sc[i][e] * (dp[i][e] - (e < 2 ? rs_a : rs_b)) * scale;
    }
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int n = KS * i + part;
    if (n < key_tiles) mma_cols_f32<HD>(acc, sc[i], ks, n);
  }
  const int64_t g_off = lay.head(lay.grad, slab);
  if constexpr (KS > 1) {
    float* const parked[3] = {dq + g_off, dk + g_off, dv + g_off};
    if (part > 0) store_rows_f32<HD>(parked[part - 1], lay.grad.t, r0, t, acc);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(KS * 32) : "memory");
    if (part > 0) return;
#pragma unroll
    for (int p = 1; p < KS; ++p) add_rows_f32<HD>(acc, parked[p - 1], lay.grad.t, r0, t);
  }
  store_rows_f32<HD>(dq + g_off, lay.grad.t, r0, t, acc);
  if (tq == 0) {
    float* st = stats + static_cast<int64_t>(slab) * 3 * t;
    const int ra = r0 + g;
    const int rb = ra + 8;
    if (ra < t) {
      st[ra] = m_a;
      st[t + ra] = l_a;
      st[2 * t + ra] = rs_a;
    }
    if (rb < t) {
      st[rb] = m_b;
      st[t + rb] = l_b;
      st[2 * t + rb] = rs_b;
    }
  }
}

// One sweep of a column-pass warp over the 8-query tiles of its slab: S^T =
// K Q^T and (for dK) dP^T = V dO^T for its 16 keys k0 .., then P^T and dS^T
// as the A operands of dV = P^T dO and dK = dS^T Q; stores what it formed.
template <int HD, bool kDV, bool kDK>
__device__ __forceinline__ void cols_sweep(const float* qs, const float* os, const float* mst, int t,
                                           const float* kg, const float* vg, int64_t ts, int k0, float* dk, float* dv,
                                           int64_t gts, float scale) {
  constexpr int kSteps = HD / 8;
  const int t8 = round8(t);
  const int tq = (threadIdx.x & 31) & 3;
  RowsA<HD> ka, va;
  ka.load(kg, ts, k0, t);
  if constexpr (kDK) va.load(vg, ts, k0, t);
  float av[kDV ? kSteps : 1][4], ak[kDK ? kSteps : 1][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDV) av[n][e] = 0.f;
      if constexpr (kDK) ak[n][e] = 0.f;
    }
  }
  for (int n = 0; n < t8 / 8; ++n) {
    // row e of the tile is key (e < 2 ? a : b), query 8n + 2*tq + (e & 1);
    // the correction terms are issued transposed (<false>), so S and dP add
    // the row pass's terms in its order
    float s4[4], d4[4] = {0.f, 0.f, 0.f, 0.f};
    mma_rows_f32<false>(s4, ka, qs, n);
    if constexpr (kDK) mma_rows_f32<false>(d4, va, os, n);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = n * 8 + 2 * tq + (e & 1);
      p[e] = qi < t ? expf(__fmul_rn(s4[e], scale) - mst[qi]) / mst[t8 + qi] : 0.f;  // as the row pass rounds it
      ds[e] = p[e] * (d4[e] - mst[2 * t8 + qi]) * scale;
    }
    if constexpr (kDV) mma_cols_f32<HD>(av, p, os, n);
    if constexpr (kDK) mma_cols_f32<HD>(ak, ds, qs, n);
  }
  if constexpr (kDV) store_rows_f32<HD>(dv, gts, k0, t, av);
  if constexpr (kDK) store_rows_f32<HD>(dk, gts, k0, t, ak);
}

template <int HD>
__global__ void __launch_bounds__(kColWarps * 32)
    mha_bwd_cols_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
                     const float* __restrict__ stats, Layout lay, int key_blocks, float scale) {
  constexpr int kPitch = HD + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t8 = round8(t);
  float* qs = reinterpret_cast<float*>(smem);  // [t8][kPitch]
  float* os = qs + t8 * kPitch;                // [t8][kPitch]
  float* mst = os + t8 * kPitch;               // [3][t8]: max, sum, row sum

  const int slab = blockIdx.x / key_blocks;
  const int64_t in_off = lay.head(lay.qkv, slab);
  stage_rows_f32<HD>(qs, q + in_off, lay.qkv.t, t, t8);
  stage_rows_f32<HD>(os, dout + lay.head(lay.dout, slab), lay.dout.t, t, t8);
  const float* st = stats + static_cast<int64_t>(slab) * 3 * t;
  for (int i = threadIdx.x; i < 3 * t8; i += blockDim.x) {
    const int which = i / t8;
    const int qi = i - which * t8;
    mst[i] = qi < t ? st[which * t + qi] : (which == 1 ? 1.f : 0.f);
  }
  const int k0 = (blockIdx.x - slab * key_blocks) * kColKeys + (threadIdx.x >> 5) * 16;
  cp_async_wait<0>();
  __syncthreads();  // Q, dO and the statistics are in shared memory
  if (k0 >= t) return;

  const int64_t g_off = lay.head(lay.grad, slab);
  float* dkp = dk + g_off;
  float* dvp = dv + g_off;
  if constexpr (HD >= kColTwoSweepsMinHd) {  // K, V, dK and dV fragments together would pass the registers
    cols_sweep<HD, true, false>(qs, os, mst, t, k + in_off, v + in_off, lay.qkv.t, k0, dkp, dvp, lay.grad.t, scale);
    cols_sweep<HD, false, true>(qs, os, mst, t, k + in_off, v + in_off, lay.qkv.t, k0, dkp, dvp, lay.grad.t, scale);
  } else {
    cols_sweep<HD, true, true>(qs, os, mst, t, k + in_off, v + in_off, lay.qkv.t, k0, dkp, dvp, lay.grad.t, scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) (void)cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

// f(std::integral_constant<int, hd>{}) for hd in 16..128 step 16.
template <typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

// Both float32 passes; a T whose staging passes the card's shared memory
// fails in cudaFuncSetAttribute (cudaErrorInvalidValue) before either runs.
template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
               float* stats, int slabs, const Layout& lay, float scale, cudaStream_t stream) {
  const int row_blocks = (lay.t + row_rows<HD>() - 1) / row_rows<HD>();
  const int key_blocks = (lay.t + kColKeys - 1) / kColKeys;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(dout);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  const size_t smem_r = smem_bytes_f32(lay.t, HD, false);
  const size_t smem_c = smem_bytes_f32(lay.t, HD, true);
  cudaError_t err = allow_smem(mha_bwd_rows_f32<HD>, smem_r);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_cols_f32<HD>, smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_rows_f32<HD><<<slabs * row_blocks, row_warps<HD>() * 32, smem_r, stream>>>(
      qp, kp, vp, op, dqp, dkp, dvp, stats, lay, row_blocks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_cols_f32<HD><<<slabs * key_blocks, kColWarps * 32, smem_c, stream>>>(qp, kp, vp, op, dkp, dvp, stats, lay,
                                                                             key_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int NC>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* stats, int slabs, const Layout& lay, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int row_blocks = (lay.t + kTile - 1) / kTile;
  const int key_blocks = (lay.t + kColWgs * kTile - 1) / (kColWgs * kTile);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const size_t smem_r = smem_bytes_rows_bf16(HD, NC);
  const size_t smem_c = smem_bytes_cols_bf16(lay.t, HD);
  cudaError_t err = allow_smem(mha_bwd_rows_bf16<HD, NC>, smem_r);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_cols_bf16<HD>, smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_rows_bf16<HD, NC><<<slabs * row_blocks, kRowWgs * kWgThreads, smem_r, stream>>>(
      qp, kp, vp, op, static_cast<bf16*>(dq), stats, lay, row_blocks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_cols_bf16<HD><<<slabs * key_blocks, kColWgs * kWgThreads, smem_c, stream>>>(
      qp, kp, vp, op, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, lay, key_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, nc>{}) for the bf16 row pass's 64-key
// chunks a warpgroup at T = t.
template <typename F>
int with_row_chunks(int t, F&& f) {
  if constexpr (kRowMaxChunks > 1) {
    if (t > kRowWgs * kTile) return f(std::integral_constant<int, kRowMaxChunks>{});
  }
  return f(std::integral_constant<int, 1>{});
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, k, v: [batch, t, heads, hd] with strides (in_bstride, in_tstride);
// dout: the same shape with (do_bstride, do_tstride); dq, dk, dv: the same
// shape with (out_bstride, out_tstride). Every tensor has unit stride over
// hd and heads hd apart; strides are in elements (a stride of a dimension
// of size 1 is never used); pointers and strides are 16-byte aligned.
// stats: float32 scratch of batch * heads * 3 * t elements. dtype: 0 =
// float32, 1 = bfloat16. Launches the row pass, then the column pass, on
// `stream` and returns the first cudaError_t (0 on success).
int theia_mha_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                  float* stats, int batch, int heads, int t, int hd, int64_t in_bstride, int64_t in_tstride,
                  int64_t do_bstride, int64_t do_tstride, int64_t out_bstride, int64_t out_tstride, int dtype,
                  float scale, void* stream) {
  const int64_t align = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const int64_t strides[6] = {in_bstride, in_tstride, do_bstride, do_tstride, out_bstride, out_tstride};
  if (batch < 1 || heads < 1 || t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const int64_t stride : strides) {
    if (stride < 0 || stride % align != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay{t, heads, hd, {in_bstride, in_tstride}, {do_bstride, do_tstride}, {out_bstride, out_tstride}};
  const int slabs = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_hd(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    if (dtype == 0) return launch_f32<HD>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    return with_row_chunks(t, [&](auto nc) {
      return launch_bf16<HD, decltype(nc)::value>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    });
  });
}

// Resident blocks per SM of the float32 row pass (cols = 0) or column pass
// (cols = 1) at T tokens and head dim hd
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with the threads of one
// of its blocks in *threads; a negative cudaError_t if the query failed.
int theia_mha_bwd_f32_blocks_per_sm(int t, int hd, int cols, int* threads) {
  if (t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    *threads = cols ? kColWarps * 32 : row_warps<HD>() * 32;
    return cols ? blocks_per_sm(mha_bwd_cols_f32<HD>, *threads, smem_bytes_f32(t, HD, true))
                : blocks_per_sm(mha_bwd_rows_f32<HD>, *threads, smem_bytes_f32(t, HD, false));
  });
}

// The same for the bf16 passes.
int theia_mha_bwd_bf16_blocks_per_sm(int t, int hd, int cols, int* threads) {
  if (t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    if (cols) {
      *threads = kColWgs * kWgThreads;
      return blocks_per_sm(mha_bwd_cols_bf16<HD>, *threads, smem_bytes_cols_bf16(t, HD));
    }
    *threads = kRowWgs * kWgThreads;
    return with_row_chunks(t, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      return blocks_per_sm(mha_bwd_rows_bf16<HD, NC>, *threads, smem_bytes_rows_bf16(HD, NC));
    });
  });
}

}  // extern "C"
