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
// owns 64 rows (queries, or keys in the dK/dV pass) and streams the other
// side through shared memory in tiles of 64.
//
// bf16, tensor cores (flash_*_bf16): four warps, each owning 16 rows, run
//   mma.sync m16n8k16 with the building blocks of K1 and K2 (mma_bf16.cuh).
//   The streamed tiles are double-buffered with cp.async: tile j + 1 is in
//   flight while tile j is used. Forward and dQ hold their rows' Q (and dO)
//   as A fragments; the S accumulators of two 8-key tiles are the A fragment
//   of bf(P) (or bf(dS)) for the next 16-key step, and V's (K's) B fragments
//   come from a transposing ldmatrix, as in K1. The dK/dV pass computes
//   S^T = K Q^T and dP^T = V dO^T, whose accumulators are the A operands of
//   dV = P^T dO and dK = dS^T Q, as K2's column pass does.
//
// float32, CUDA cores (flash_*_f32): no tensor-core instruction multiplies
//   in full float32, so the products run as FMAs, as in K1 and K2: 16 warps
//   of 4 rows a block, lane j owning keys (or queries) j and j + 32 of a
//   tile, then dims j, j + 32, ... of the outputs. Tiles are staged once per
//   step (no double buffer). Both backward passes compute S and dP in one
//   dot-product order, so P and dS agree between them.
//
// No atomics: each pass owns one reduction direction, so the results are
// deterministic. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the 4 lanes of a fragment row group (lanes 4g .. 4g + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kSteps = kTile / 16;  // 16-wide k steps of a tile

// Two double-buffered tiles of [kTile][HD + 8] bf16, plus `floats` float32
// values a buffer (the dK/dV pass's lse and di of its query tile).
size_t smem_bytes_bf16(int hd, int floats) {
  return 2 * (2 * static_cast<size_t>(kTile) * (hd + 8) * sizeof(bf16) + floats * sizeof(float));
}

// Stage the tile of rows [r, r + kTile) of two tensors (row i at base + i * ts)
// as two cp.async groups; rows from T on become zeros.
template <int HD>
__device__ __forceinline__ void stage_pair(bf16* xs, bf16* ys, const bf16* x, const bf16* y, int64_t ts, int r,
                                           int t) {
  stage_rows<HD>(xs, x + r * ts, ts, t - r, kTile);
  stage_rows<HD>(ys, y + r * ts, ts, t - r, kTile);
}

// float32 dot of the bf16 A fragments of 16 rows of two tensors: the
// partial sums of rows g and g + 8 over this lane's columns.
template <int HD>
__device__ __forceinline__ void frag_dot(float& da, float& db, const uint32_t (&x)[HD / 16][4],
                                         const uint32_t (&y)[HD / 16][4]) {
  da = db = 0.f;
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[s][e]));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[s][e]));
      const float p = fmaf(a.y, b.y, a.x * b.x);
      if (e & 1) {
        db += p;
      } else {
        da += p;
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   bf16* __restrict__ o, float* __restrict__ lse, Layout lay, int q_tiles, float scale) {
  constexpr int kBuf = kTile * (HD + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kTile][HD + 8]
  bf16* vs = ks + 2 * kBuf;                  // [2][kTile][HD + 8]
  const int t = lay.t;
  // head-major: the query tiles of a slab run together and share its K, V in L2
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int r0 = (blockIdx.x - slab * q_tiles) * kTile + warp * 16;
  const int row_a = r0 + (lane >> 2);
  const int row_b = row_a + 8;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  const int k_tiles = (t + kTile - 1) / kTile;

  stage_pair<HD>(ks, vs, kh, vh, ts, 0, t);
  uint32_t qa[HD / 16][4];
  load_a<HD>(qa, q + in_off, ts, r0, t);

  float m_a = -INFINITY, m_b = -INFINITY;  // running row maxima (the same in the 4 lanes of a row)
  float l_a = 0.f, l_b = 0.f;              // running sums over this lane's keys
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < k_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < k_tiles) {
      stage_pair<HD>(ks + (cur ^ 1) * kBuf, vs + (cur ^ 1) * kBuf, kh, vh, ts, (j + 1) * kTile, t);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in shared memory
    const bf16* kt = ks + cur * kBuf;
    const bf16* vt = vs + cur * kBuf;
    if (r0 < t) {
      // S = Q K^T * scale: tile n holds keys 8n .. 8n + 7 of the tile;
      // element e is row (e < 2 ? a : b), key 8n + 2 tq + (e & 1).
      const int key0 = j * kTile;
      float sc[kTile / 8][4];
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        mma_rows<HD>(sc[n], qa, kt, n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = key0 + n * 8 + 2 * tq + (e & 1) < t ? sc[n][e] * scale : -INFINITY;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
      }
      // Every tile holds a key < T, so the new maxima are finite; the first
      // tile's correction exp(-inf) is 0.
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = expf(m_a - mn_a);
      const float al_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = expf(sc[n][e] - (e < 2 ? m_a : m_b));  // masked keys: 0
        l_a += sc[n][0] + sc[n][1];
        l_b += sc[n][2] + sc[n][3];
      }
      // O += bf(P) V over 16-key steps
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * s][0], sc[2 * s][1]), pack_bf16(sc[2 * s][2], sc[2 * s][3]),
                                pack_bf16(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                                pack_bf16(sc[2 * s + 1][2], sc[2 * s + 1][3])};
        mma_cols<HD>(acc, pa, vt, s);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if (r0 >= t) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] /= l_a;
    acc[n][1] /= l_a;
    acc[n][2] /= l_b;
    acc[n][3] /= l_b;
  }
  store_rows<HD>(o + lay.head(lay.out, slab), lay.out.t, r0, t, acc);
  if (tq == 0) {
    float* ls = lse + static_cast<int64_t>(slab) * t;
    if (row_a < t) ls[row_a] = m_a + logf(l_a);
    if (row_b < t) ls[row_b] = m_b + logf(l_b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ di, bf16* __restrict__ dq, Layout lay, int q_tiles, float scale) {
  constexpr int kBuf = kTile * (HD + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kTile][HD + 8]
  bf16* vs = ks + 2 * kBuf;                  // [2][kTile][HD + 8]
  const int t = lay.t;
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int r0 = (blockIdx.x - slab * q_tiles) * kTile + warp * 16;
  const int row_a = r0 + (lane >> 2);
  const int row_b = row_a + 8;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  const int k_tiles = (t + kTile - 1) / kTile;

  stage_pair<HD>(ks, vs, kh, vh, ts, 0, t);
  uint32_t qa[HD / 16][4], oa[HD / 16][4];
  load_a<HD>(qa, q + in_off, ts, r0, t);
  load_a<HD>(oa, dout + lay.head(lay.dout, slab), lay.dout.t, r0, t);
  // di = rowsum(O * dO) in float32, from O's fragments in dO's layout
  float di_a, di_b;
  {
    uint32_t xa[HD / 16][4];
    load_a<HD>(xa, o + lay.head(lay.out, slab), lay.out.t, r0, t);
    frag_dot<HD>(di_a, di_b, xa, oa);
  }
  di_a = quad_sum(di_a);
  di_b = quad_sum(di_b);
  const float* ls = lse + static_cast<int64_t>(slab) * t;
  const float lse_a = row_a < t ? ls[row_a] : 0.f;
  const float lse_b = row_b < t ? ls[row_b] : 0.f;
  if (tq == 0) {
    float* dst = di + static_cast<int64_t>(slab) * t;
    if (row_a < t) dst[row_a] = di_a;
    if (row_b < t) dst[row_b] = di_b;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = 0; j < k_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < k_tiles) {
      stage_pair<HD>(ks + (cur ^ 1) * kBuf, vs + (cur ^ 1) * kBuf, kh, vh, ts, (j + 1) * kTile, t);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in shared memory
    const bf16* kt = ks + cur * kBuf;
    const bf16* vt = vs + cur * kBuf;
    if (r0 < t) {
      const int key0 = j * kTile;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        float ds[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * s + h;
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows<HD>(s4, qa, kt, n);
          mma_rows<HD>(d4, oa, vt, n);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = key0 + n * 8 + 2 * tq + (e & 1) < t;
            const float p = in ? expf(s4[e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
            ds[h][e] = (d4[e] - (e < 2 ? di_a : di_b)) * p * scale;
          }
        }
        const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
        mma_cols<HD>(acc, da, kt, s);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if (r0 < t) store_rows<HD>(dq + lay.head(lay.grad, slab), lay.grad.t, r0, t, acc);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, Layout lay, int k_tiles, float scale) {
  constexpr int kBuf = kTile * (HD + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);          // [2][kTile][HD + 8]
  bf16* os = qs + 2 * kBuf;                          // [2][kTile][HD + 8]: dO
  float* stat = reinterpret_cast<float*>(os + 2 * kBuf);  // [2][2][kTile]: lse, di
  const int t = lay.t;
  const int slab = blockIdx.x / k_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int k0 = (blockIdx.x - slab * k_tiles) * kTile + warp * 16;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const bf16* qh = q + in_off;
  const bf16* oh = dout + lay.head(lay.dout, slab);
  const float* lh = lse + static_cast<int64_t>(slab) * t;
  const float* dh = di + static_cast<int64_t>(slab) * t;
  const int q_tiles = (t + kTile - 1) / kTile;

  // lse and di of query tile r into stat buffer b; rows from T on are never read
  auto stage_stats = [&](int b, int r) {
    for (int i = threadIdx.x; i < 2 * kTile; i += kTcThreads) {
      const int qi = r + (i & (kTile - 1));
      stat[b * 2 * kTile + i] = qi < t ? (i < kTile ? lh[qi] : dh[qi]) : 0.f;
    }
  };
  stage_rows<HD>(qs, qh, ts, t, kTile);
  stage_rows<HD>(os, oh, lay.dout.t, t, kTile);
  stage_stats(0, 0);
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a<HD>(ka, k + in_off, ts, k0, t);
  load_a<HD>(va, v + in_off, ts, k0, t);

  float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.f;
    ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
  }
  for (int j = 0; j < q_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < q_tiles) {
      const int r = (j + 1) * kTile;
      stage_rows<HD>(qs + (cur ^ 1) * kBuf, qh + r * ts, ts, t - r, kTile);
      stage_rows<HD>(os + (cur ^ 1) * kBuf, oh + r * lay.dout.t, lay.dout.t, t - r, kTile);
      stage_stats(cur ^ 1, r);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in shared memory
    const bf16* qt = qs + cur * kBuf;
    const bf16* ot = os + cur * kBuf;
    const float* lt = stat + cur * 2 * kTile;
    const float* dt = lt + kTile;
    if (k0 < t) {
      const int q0 = j * kTile;
      // Over 16-query steps: tiles of S^T = K Q^T and dP^T = V dO^T (rows
      // are this warp's keys; element e is query 8n + 2 tq + (e & 1)).
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        float p[2][4], ds[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * s + h;
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows<HD>(s4, ka, qt, n);
          mma_rows<HD>(d4, va, ot, n);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = n * 8 + 2 * tq + (e & 1);
            const float pv = q0 + qi < t ? expf(s4[e] * scale - lt[qi]) : 0.f;
            p[h][e] = pv;
            ds[h][e] = (d4[e] - dt[qi]) * pv * scale;
          }
        }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
        mma_cols<HD>(av, pa, ot, s);
        mma_cols<HD>(ak, da, qt, s);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  if (k0 >= t) return;
  const int64_t g_off = lay.head(lay.grad, slab);
  store_rows<HD>(dk + g_off, lay.grad.t, k0, t, ak);
  store_rows<HD>(dv + g_off, lay.grad.t, k0, t, av);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                    // rows (keys in the dK/dV pass) a warp
constexpr int kPerLane = kTile / 32;        // keys (queries) of a tile a lane owns
constexpr int kDimsPerLane = kMaxHd / 32;   // output dims a lane owns
static_assert(kWarps * kRows == kTile, "a block owns one tile of rows");

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc + a . b over four elements, in element order (every pass uses this
// one order, so S and dP come out the same in both backward passes).
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

// Rows [r, r + kTile) of a slab (row i at src + i * stride) into shared rows
// of pitch hd + 4; rows from T on become zeros.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int64_t stride, int r, int t, int hd) {
  const int quads = hd / 4;
  for (int i = threadIdx.x; i < kTile * quads; i += kThreads) {
    const int rr = i / quads;
    const int c = (i - rr * quads) * 4;
    *reinterpret_cast<float4*>(dst + rr * (hd + 4) + c) =
        r + rr < t ? load4(src + (r + rr) * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// kRows rows (r0 ..) of a slab into a warp's [kRows][hd] buffer; rows from T on are zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int r0, int t, int hd) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < kRows * hd; idx += 32) {
    const int rr = idx / hd;
    const int d = idx - rr * hd;
    dst[idx] = r0 + rr < t ? src[(r0 + rr) * stride + d] : 0.f;
  }
}

// Shared memory of the float32 kernels: `tiles` staged [kTile][hd + 4]
// tiles, `stats` floats, and per warp `row_bufs` [kRows][hd] buffers and
// `key_bufs` [kRows][kTile] buffers.
size_t smem_bytes_f32(int hd, int tiles, int stats, int row_bufs, int key_bufs) {
  return (static_cast<size_t>(tiles) * kTile * (hd + 4) + stats +
          static_cast<size_t>(kWarps) * kRows * (row_bufs * hd + key_bufs * kTile)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ o, float* __restrict__ lse, Layout lay, int q_tiles, float scale) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int hd = lay.hd;
  const int pitch = hd + 4;
  float* ks = reinterpret_cast<float*>(smem);  // [kTile][pitch]
  float* vs = ks + kTile * pitch;              // [kTile][pitch]
  float* qbuf = vs + kTile * pitch;            // [kWarps][R][hd]
  float* pbuf = qbuf + kWarps * R * hd;        // [kWarps][R][kTile]
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x - slab * q_tiles) * kTile + warp * R;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  float* qw = qbuf + warp * R * hd;
  float* pw = pbuf + warp * R * kTile;
  load_rows(qw, q + in_off, ts, r0, t, hd);

  float m[R], l[R], acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }
  for (int key0 = 0; key0 < t; key0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(ks, k + in_off, ts, key0, t, hd);
    stage_tile(vs, v + in_off, ts, key0, t, hd);
    __syncthreads();
    if (r0 >= t) continue;
    // S = Q K^T for R rows at once; lane owns keys lane + 32 i of the tile
    float s[R][kPerLane];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) s[r][i] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = load4(qw + r * hd + d);  // broadcast
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float4 kv = load4(ks + (lane + 32 * i) * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][i] = dot4(qv[r], kv, s[r][i]);
      }
    }
    // the online softmax; P into the warp's buffer
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        s[r][i] = key0 + lane + 32 * i < t ? s[r][i] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
      const float mn = fmaxf(m[r], warp_max(mx));  // finite: the tile holds a key < T
      const float al = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= al;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= al;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float p = expf(s[r][i] - mn);
        l[r] += p;
        pw[r * kTile + lane + 32 * i] = p;
      }
    }
    __syncwarp();
    // O += P V: lane owns dims lane + 32 i, for R rows at once
    for (int j = 0; j < kTile; j += 4) {
      float4 p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = load4(pw + r * kTile + j);  // broadcast
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * pitch;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) {
            const float vv = vrow[d];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float pj = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
              acc[r][i] = fmaf(pj, vv, acc[r][i]);
            }
          }
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }
  if (r0 >= t) return;
  float* oh = o + lay.head(lay.out, slab);
  float* ls = lse + static_cast<int64_t>(slab) * t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    const float lr = warp_sum(l[r]);
    if (row < t) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) oh[row * lay.out.t + d] = acc[r][i] / lr;
      }
      if (lane == 0) ls[row] = m[r] + logf(lr);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ di, float* __restrict__ dq, Layout lay, int q_tiles, float scale) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int hd = lay.hd;
  const int pitch = hd + 4;
  float* ks = reinterpret_cast<float*>(smem);  // [kTile][pitch]
  float* vs = ks + kTile * pitch;              // [kTile][pitch]
  float* qbuf = vs + kTile * pitch;            // [kWarps][R][hd]
  float* obuf = qbuf + kWarps * R * hd;        // [kWarps][R][hd]: dO
  float* dsbuf = obuf + kWarps * R * hd;       // [kWarps][R][kTile]
  const int slab = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x - slab * q_tiles) * kTile + warp * R;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const int64_t o_off = lay.head(lay.out, slab);
  float* qw = qbuf + warp * R * hd;
  float* ow = obuf + warp * R * hd;
  float* dsw = dsbuf + warp * R * kTile;
  load_rows(qw, q + in_off, ts, r0, t, hd);
  load_rows(ow, dout + lay.head(lay.dout, slab), lay.dout.t, r0, t, hd);
  __syncwarp();

  // di = rowsum(O * dO) in float32, stored for the dK/dV pass; and lse
  float dir[R], lr[R];
  const float* ls = lse + static_cast<int64_t>(slab) * t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    float x = 0.f;
    if (row < t) {
      for (int d = lane; d < hd; d += 32) x = fmaf(o[o_off + row * lay.out.t + d], ow[r * hd + d], x);
    }
    dir[r] = warp_sum(x);
    lr[r] = row < t ? ls[row] : 0.f;
    if (lane == 0 && row < t) di[static_cast<int64_t>(slab) * t + row] = dir[r];
  }

  float acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int key0 = 0; key0 < t; key0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(ks, k + in_off, ts, key0, t, hd);
    stage_tile(vs, v + in_off, ts, key0, t, hd);
    __syncthreads();
    if (r0 >= t) continue;
    // S = Q K^T and dP = dO V^T for R rows; lane owns keys lane + 32 i
    float s[R][kPerLane], dp[R][kPerLane];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) s[r][i] = dp[r][i] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[R], ov[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qv[r] = load4(qw + r * hd + d);  // broadcast
        ov[r] = load4(ow + r * hd + d);
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float4 kv = load4(ks + (lane + 32 * i) * pitch + d);
        const float4 vv = load4(vs + (lane + 32 * i) * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][i] = dot4(qv[r], kv, s[r][i]);
          dp[r][i] = dot4(ov[r], vv, dp[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float p = key0 + lane + 32 * i < t ? expf(s[r][i] * scale - lr[r]) : 0.f;
        dsw[r * kTile + lane + 32 * i] = (dp[r][i] - dir[r]) * p * scale;
      }
    __syncwarp();
    // dQ += dS K: lane owns dims lane + 32 i, for R rows
    for (int j = 0; j < kTile; ++j) {
      float dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dsv[r] = dsw[r * kTile + j];  // broadcast
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float kv = ks[j * pitch + d];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][i] = fmaf(dsv[r], kv, acc[r][i]);
        }
      }
    }
    __syncwarp();  // dS is read before the next tile overwrites it
  }
  if (r0 >= t) return;
  const int64_t g_off = lay.head(lay.grad, slab);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    if (row < t) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) dq[g_off + row * lay.grad.t + d] = acc[r][i];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, Layout lay, int k_tiles, float scale) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int hd = lay.hd;
  const int pitch = hd + 4;
  float* qs = reinterpret_cast<float*>(smem);  // [kTile][pitch]
  float* os = qs + kTile * pitch;              // [kTile][pitch]: dO
  float* lt = os + kTile * pitch;              // [kTile]: lse
  float* dt = lt + kTile;                      // [kTile]: di
  float* kbuf = dt + kTile;                    // [kWarps][R][hd]
  float* vbuf = kbuf + kWarps * R * hd;        // [kWarps][R][hd]
  float* pbuf = vbuf + kWarps * R * hd;        // [kWarps][R][kTile]
  float* dsbuf = pbuf + kWarps * R * kTile;    // [kWarps][R][kTile]
  const int slab = blockIdx.x / k_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x - slab * k_tiles) * kTile + warp * R;
  const int64_t ts = lay.qkv.t;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const int64_t do_off = lay.head(lay.dout, slab);
  const float* lh = lse + static_cast<int64_t>(slab) * t;
  const float* dh = di + static_cast<int64_t>(slab) * t;
  float* kw = kbuf + warp * R * hd;
  float* vw = vbuf + warp * R * hd;
  float* pw = pbuf + warp * R * kTile;
  float* dsw = dsbuf + warp * R * kTile;
  load_rows(kw, k + in_off, ts, c0, t, hd);
  load_rows(vw, v + in_off, ts, c0, t, hd);

  float av[R][kDimsPerLane], ak[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) av[r][i] = ak[r][i] = 0.f;
  for (int q0 = 0; q0 < t; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(qs, q + in_off, ts, q0, t, hd);
    stage_tile(os, dout + do_off, lay.dout.t, q0, t, hd);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < t;
      lt[i] = in ? lh[q0 + i] : 0.f;
      dt[i] = in ? dh[q0 + i] : 0.f;
    }
    __syncthreads();
    if (c0 >= t) continue;
    // S and dP for R keys; lane owns queries lane + 32 i of the tile, in the
    // dQ pass's element order: S[i][j] = sum_d q[i][d] k[j][d]
    float s[R][kPerLane], dp[R][kPerLane];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) s[r][i] = dp[r][i] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 kv[R], vv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        kv[r] = load4(kw + r * hd + d);  // broadcast
        vv[r] = load4(vw + r * hd + d);
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float4 qv = load4(qs + (lane + 32 * i) * pitch + d);
        const float4 ov = load4(os + (lane + 32 * i) * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][i] = dot4(qv, kv[r], s[r][i]);
          dp[r][i] = dot4(ov, vv[r], dp[r][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int qi = lane + 32 * i;
      const bool in = q0 + qi < t;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = in ? expf(s[r][i] * scale - lt[qi]) : 0.f;
        pw[r * kTile + qi] = p;
        dsw[r * kTile + qi] = (dp[r][i] - dt[qi]) * p * scale;
      }
    }
    __syncwarp();
    // dV += P^T dO and dK += dS^T Q: lane owns dims lane + 32 i, for R keys
    for (int qi = 0; qi < kTile; ++qi) {
      float pv[R], dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pv[r] = pw[r * kTile + qi];  // broadcast
        dsv[r] = dsw[r * kTile + qi];
      }
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float ov = os[qi * pitch + d];
          const float qv = qs[qi * pitch + d];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            av[r][i] = fmaf(pv[r], ov, av[r][i]);
            ak[r][i] = fmaf(dsv[r], qv, ak[r][i]);
          }
        }
      }
    }
    __syncwarp();  // P and dS are read before the next tile overwrites them
  }
  if (c0 >= t) return;
  const int64_t g_off = lay.head(lay.grad, slab);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = c0 + r;
    if (key < t) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          dk[g_off + key * lay.grad.t + d] = ak[r][i];
          dv[g_off + key * lay.grad.t + d] = av[r][i];
        }
      }
    }
  }
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

template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int blocks, int tiles,
             const Layout& lay, float scale, cudaStream_t s) {
  return launch(flash_fwd_bf16<HD>, blocks, kTcThreads, smem_bytes_bf16(HD, 0), s, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, lay, tiles,
                scale);
}

template <int HD>
int dq_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
            float* di, void* dq, int blocks, int tiles, const Layout& lay, float scale, cudaStream_t s) {
  return launch(flash_dq_bf16<HD>, blocks, kTcThreads, smem_bytes_bf16(HD, 0), s, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), lay, tiles, scale);
}

template <int HD>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* di,
             void* dk, void* dv, int blocks, int tiles, const Layout& lay, float scale, cudaStream_t s) {
  return launch(flash_dkv_bf16<HD>, blocks, kTcThreads, smem_bytes_bf16(HD, 2 * kTile), s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lay, tiles,
                scale);
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
  const int tiles = (t + kTile - 1) / kTile;
  const int blocks = batch * heads * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(flash_fwd_f32, blocks, kThreads, smem_bytes_f32(hd, 2, 0, 1, 1), s, static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o), lse, lay,
                  tiles, scale);
  }
  THEIA_FLASH_BY_HD(fwd_bf16, hd, q, k, v, o, lse, blocks, tiles, lay, scale, s)
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
  const int tiles = (t + kTile - 1) / kTile;
  const int blocks = batch * heads * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(flash_dq_f32, blocks, kThreads, smem_bytes_f32(hd, 2, 0, 2, 1), s, static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v), static_cast<const float*>(o),
                  static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), lay, tiles, scale);
  }
  THEIA_FLASH_BY_HD(dq_bf16, hd, q, k, v, o, dout, lse, di, dq, blocks, tiles, lay, scale, s)
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
  const int tiles = (t + kTile - 1) / kTile;
  const int blocks = batch * heads * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(flash_dkv_f32, blocks, kThreads, smem_bytes_f32(hd, 2, 2 * kTile, 2, 2), s,
                  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv), lay,
                  tiles, scale);
  }
  THEIA_FLASH_BY_HD(dkv_bf16, hd, q, k, v, dout, lse, di, dk, dv, blocks, tiles, lay, scale, s)
}

}  // extern "C"
