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
// bf16, tensor cores (mha_bwd_rows_bf16, mha_bwd_cols_bf16): mma.sync
//   m16n8k16 with K1's building blocks (mma_bf16.cuh). Row pass: a warp
//   owns 16 query rows and keeps their S in registers (as mha_fwd_bf16);
//   dP = dO V^T is formed twice per 8-key tile, once for the row sum and
//   once for dS, whose bf16 tiles are the A operand of dQ = dS K (K's B
//   fragments from a transposing ldmatrix). Column pass: a warp owns 16
//   keys and streams over 16-query steps: S^T = K Q^T and dP^T = V dO^T put
//   P^T and dS^T in the accumulator layout that is the A operand of
//   dV = P^T dO and dK = dS^T Q, so nothing is transposed through shared
//   memory and no row reduction is needed. Q, dO (or K, V) are staged with
//   cp.async in rows padded by 16 bytes.
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

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxT = 256;
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
  Strides dout;  // dO
  Strides grad;  // dq, dk, dv

  __device__ __forceinline__ int64_t head(const Strides& s, int slab) const {
    return static_cast<int64_t>(slab / heads) * s.b + static_cast<int64_t>(slab % heads) * hd;
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // rows (keys) a block
constexpr int kMaxKeyTiles = kMaxT / 8;

// Shared memory: two staged [round16(T)][HD + 8] bf16 tensors, and in the
// column pass the row statistics [3][round16(T)].
size_t smem_bytes_bf16(int t, int hd, bool cols) {
  const size_t t16 = round16(t);
  return 2 * t16 * (hd + 8) * sizeof(__nv_bfloat16) + (cols ? 3 * t16 * sizeof(float) : 0);
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    mha_bwd_rows_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, Layout lay, int row_blocks,
                      float scale) {
  constexpr int kPitch = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t16 = round16(t);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [t16][kPitch]
  __nv_bfloat16* vs = ks + t16 * kPitch;                       // [t16][kPitch]

  const int slab = blockIdx.x / row_blocks;  // head-major: a slab's blocks share its K, V in L2
  const int64_t in_off = lay.head(lay.qkv, slab);
  stage_rows<HD>(ks, k + in_off, lay.qkv.t, t, t16);
  stage_rows<HD>(vs, v + in_off, lay.qkv.t, t, t16);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = (blockIdx.x - slab * row_blocks) * kTcRows + warp * 16;
  uint32_t qa[HD / 16][4], oa[HD / 16][4];
  load_a<HD>(qa, q + in_off, lay.qkv.t, r0, t);
  load_a<HD>(oa, dout + lay.head(lay.dout, slab), lay.dout.t, r0, t);
  cp_async_wait<0>();
  __syncthreads();  // K and V are in shared memory
  if (r0 >= t) return;

  // S = Q K^T: tile n holds keys 8n .. 8n+7; element e of a tile is row
  // (e < 2 ? a : b), key 8n + 2*tq + (e & 1). Then P in place, float32.
  const int key_tiles = t16 / 8;
  float sc[kMaxKeyTiles][4];
#pragma unroll
  for (int n = 0; n < kMaxKeyTiles; ++n) {
    sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if (n < key_tiles) mma_rows<HD>(sc[n], qa, ks, n);
  }
  float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < kMaxKeyTiles; ++n) {
    if (n < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1);
        sc[n][e] = key < t ? __fmul_rn(sc[n][e], scale) : -INFINITY;  // as the column pass rounds it
      }
      m_a = fmaxf(m_a, fmaxf(sc[n][0], sc[n][1]));
      m_b = fmaxf(m_b, fmaxf(sc[n][2], sc[n][3]));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, off));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, off));
  }
  float l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxKeyTiles; ++n) {
    if (n < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1);
        sc[n][e] = key < t ? expf(sc[n][e] - (e < 2 ? m_a : m_b)) : 0.f;
      }
      l_a += sc[n][0] + sc[n][1];
      l_b += sc[n][2] + sc[n][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // P, and rowsum(dP * P) with dP = dO V^T one 8-key tile at a time.
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxKeyTiles; ++n) {
    if (n < key_tiles) {
      sc[n][0] /= l_a;
      sc[n][1] /= l_a;
      sc[n][2] /= l_b;
      sc[n][3] /= l_b;
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows<HD>(dp, oa, vs, n);
      rs_a += dp[0] * sc[n][0] + dp[1] * sc[n][1];
      rs_b += dp[2] * sc[n][2] + dp[3] * sc[n][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }

  // dQ = bf(dS) K over 16-key steps; dP is formed again, tile by tile.
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxKeyTiles / 2; ++j) {
    if (2 * j < key_tiles) {
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows<HD>(dp, oa, vs, 2 * j + h);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[h][e] = sc[2 * j + h][e] * (dp[e] - (e < 2 ? rs_a : rs_b)) * scale;
      }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      mma_cols<HD>(acc, da, ks, j);
    }
  }
  store_rows<HD>(dq + lay.head(lay.grad, slab), lay.grad.t, r0, t, acc);
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

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    mha_bwd_cols_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      const float* __restrict__ stats, Layout lay, int key_blocks, float scale) {
  constexpr int kPitch = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t16 = round16(t);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [t16][kPitch]
  __nv_bfloat16* os = qs + t16 * kPitch;                       // [t16][kPitch]
  float* mst = reinterpret_cast<float*>(os + t16 * kPitch);   // [3][t16]: max, sum, row sum

  const int slab = blockIdx.x / key_blocks;
  const int64_t in_off = lay.head(lay.qkv, slab);
  stage_rows<HD>(qs, q + in_off, lay.qkv.t, t, t16);
  stage_rows<HD>(os, dout + lay.head(lay.dout, slab), lay.dout.t, t, t16);
  const float* st = stats + static_cast<int64_t>(slab) * 3 * t;
  for (int i = threadIdx.x; i < 3 * t16; i += blockDim.x) {
    const int which = i / t16;
    const int qi = i - which * t16;
    mst[i] = qi < t ? st[which * t + qi] : (which == 1 ? 1.f : 0.f);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int k0 = (blockIdx.x - slab * key_blocks) * kTcRows + warp * 16;
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a<HD>(ka, k + in_off, lay.qkv.t, k0, t);
  load_a<HD>(va, v + in_off, lay.qkv.t, k0, t);
  cp_async_wait<0>();
  __syncthreads();  // Q, dO and the statistics are in shared memory
  if (k0 >= t) return;

  // Over 16-query steps: tiles of S^T = K Q^T and dP^T = V dO^T (rows are
  // this warp's keys, element e is query 8n + 2*tq + (e & 1)), then P^T and
  // dS^T, rounded to bf16, as the A operands of dV = P^T dO, dK = dS^T Q.
  float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.f;
    ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
  }
  for (int j = 0; j < t16 / 16; ++j) {
    float p[2][4], ds[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * j + h;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows<HD>(s4, ka, qs, n);
      mma_rows<HD>(d4, va, os, n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * tq + (e & 1);
        const float pv = qi < t ? expf(__fmul_rn(s4[e], scale) - mst[qi]) / mst[t16 + qi] : 0.f;
        p[h][e] = pv;
        ds[h][e] = pv * (d4[e] - mst[2 * t16 + qi]) * scale;
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
    mma_cols<HD>(av, pa, os, j);
    mma_cols<HD>(ak, da, qs, j);
  }
  const int64_t g_off = lay.head(lay.grad, slab);
  store_rows<HD>(dk + g_off, lay.grad.t, k0, t, ak);
  store_rows<HD>(dv + g_off, lay.grad.t, k0, t, av);
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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                float* stats, int slabs, const Layout& lay, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int blocks = (lay.t + kTcRows - 1) / kTcRows;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const size_t smem_r = smem_bytes_bf16(lay.t, HD, false);
  cudaError_t err = allow_smem(mha_bwd_rows_bf16<HD>, smem_r);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_rows_bf16<HD><<<slabs * blocks, kTcWarps * 32, smem_r, stream>>>(qp, kp, vp, op, static_cast<bf16*>(dq),
                                                                             stats, lay, blocks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_c = smem_bytes_bf16(lay.t, HD, true);
  err = allow_smem(mha_bwd_cols_bf16<HD>, smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_cols_bf16<HD><<<slabs * blocks, kTcWarps * 32, smem_c, stream>>>(
      qp, kp, vp, op, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, lay, blocks, scale);
  return static_cast<int>(cudaGetLastError());
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
    return dtype == 0 ? launch_f32<HD>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s)
                      : launch_bf16<HD>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
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

}  // extern "C"
