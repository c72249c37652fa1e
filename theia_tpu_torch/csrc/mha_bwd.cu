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
// where they lie.
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
// float32, CUDA cores (mha_bwd_rows, mha_bwd_cols): no tensor-core
//   instruction multiplies in full float32, so the products run as FMAs. A
//   warp owns 4 rows (keys), a lane keys (queries) lane, lane + 32, ...;
//   the staged tensors keep rows padded by 4 elements. Both passes compute
//   S and dP with one dot-product order and one expf, with the scale
//   multiply pinned (__fmul_rn), so a P and a dS are the same numbers in
//   both. A launch uses the most warps (8, 4 or 2) whose buffers fit the
//   card's shared memory; float32 hd = 112 above T = 224 and hd = 128 above
//   T = 196 fit none and return cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxT = 256;
constexpr int kMaxHd = 128;
constexpr int kRows = 4;                  // rows (row pass) or keys (column pass) per warp
constexpr int kPerLane = kMaxT / 32;      // keys (row pass) or queries (column pass) per lane
constexpr int kDimsPerLane = kMaxHd / 32;
constexpr int kMaxWarps = 8;

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

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc + a . b over four elements, in element order (both passes use this
// one order, so S and dP come out the same in both).
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

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

__host__ __device__ constexpr int round4(int t) { return (t + 3) & ~3; }

// Copy `rows` token rows of a slab (row r at src + r * stride) into shared
// rows of pitch hd + 4; rows from T up to `rows` become zeros.
__device__ __forceinline__ void stage_quads(float* dst, const float* src, int64_t stride, int t, int rows, int hd) {
  const int pitch = hd + 4;
  const int quads = hd / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i / quads;
    const int c = (i - r * quads) * 4;
    *reinterpret_cast<float4*>(dst + r * pitch + c) =
        r < t ? *reinterpret_cast<const float4*>(src + r * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Shared memory of either pass: two staged [round4(T)][hd + 4] tensors,
// the column pass's row statistics [3][round4(T)], and per warp kRows rows
// of hd (two of them) and of round4(T) (one in the row pass, two in the
// column pass); all float32.
size_t smem_bytes(int t, int hd, int warps, bool cols) {
  const size_t t4 = round4(t);
  size_t bytes = 2 * t4 * (hd + 4) * sizeof(float);
  if (cols) bytes += 3 * t4 * sizeof(float);
  bytes += static_cast<size_t>(warps) * kRows * (2 * hd + (cols ? 2 : 1) * t4) * sizeof(float);
  return bytes;
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: row pass (dQ and the row statistics)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxWarps * 32)
    mha_bwd_rows(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ stats, Layout lay,
                 float scale, int rows_per_block) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int hd = lay.hd;
  const int pitch = hd + 4;
  const int t4 = round4(t);
  const int warps = blockDim.x >> 5;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + t4 * pitch;
  float* qbuf = vs + t4 * pitch;         // [warps][R][hd]
  float* obuf = qbuf + warps * R * hd;                      // [warps][R][hd]
  float* dsbuf = obuf + warps * R * hd;                     // [warps][R][t4]

  const int slab = blockIdx.x;
  const int64_t in_off = lay.head(lay.qkv, slab);
  stage_quads(ks, k + in_off, lay.qkv.t, t, t4, hd);
  stage_quads(vs, v + in_off, lay.qkv.t, t, t4, hd);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(t, row_begin + rows_per_block);
  const int r0 = row_begin + warp * R;
  if (r0 >= row_end) return;  // no block-wide barrier follows
  float* qw = qbuf + warp * R * hd;
  float* ow = obuf + warp * R * hd;
  float* dsw = dsbuf + warp * R * t4;

  const int64_t do_off = lay.head(lay.dout, slab);
  for (int idx = lane; idx < R * hd; idx += 32) {
    const int rr = idx / hd;
    const int d = idx - rr * hd;
    const int row = r0 + rr;
    const bool in = row < row_end;
    qw[idx] = in ? q[in_off + row * lay.qkv.t + d] : 0.f;
    ow[idx] = in ? dout[do_off + row * lay.dout.t + d] : 0.f;
  }
  __syncwarp();

  // S = Q K^T and dP = dO V^T for R rows at once; lane owns keys lane + 32 i.
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
      const int j = lane + 32 * i;
      if (j < t) {
        const float4 kv = load4(ks + j * pitch + d);
        const float4 vv = load4(vs + j * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][i] = dot4(qv[r], kv, s[r][i]);
          dp[r][i] = dot4(ov[r], vv, dp[r][i]);
        }
      }
    }
  }

  // Per row: softmax, the row sum of dP * P, and dS.
  float* st = stats + static_cast<int64_t>(slab) * 3 * t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      s[r][i] = j < t ? __fmul_rn(s[r][i], scale) : -INFINITY;  // never fused into the exp's argument
      m = fmaxf(m, s[r][i]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      s[r][i] = j < t ? expf(s[r][i] - m) : 0.f;
      l += s[r][i];
    }
    l = warp_sum(l);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < t) {
        s[r][i] = s[r][i] / l;  // P
        rs += dp[r][i] * s[r][i];
      }
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < t4) dsw[r * t4 + j] = j < t ? s[r][i] * (dp[r][i] - rs) * scale : 0.f;
    }
    const int row = r0 + r;
    if (lane == 0 && row < row_end) {
      st[row] = m;
      st[t + row] = l;
      st[2 * t + row] = rs;
    }
  }
  __syncwarp();

  // dQ = dS K: lane owns dims lane + 32 i, for R rows at once.
  float acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int j = 0; j < t; ++j) {
    float dsv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dsv[r] = dsw[r * t4 + j];  // broadcast
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
  const int64_t g_off = lay.head(lay.grad, slab);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    if (row < row_end) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) dq[g_off + row * lay.grad.t + d] = acc[r][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: column pass (dK and dV)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxWarps * 32)
    mha_bwd_cols(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
                 const float* __restrict__ stats, Layout lay, float scale, int keys_per_block) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int hd = lay.hd;
  const int pitch = hd + 4;
  const int t4 = round4(t);
  const int warps = blockDim.x >> 5;
  float* qs = reinterpret_cast<float*>(smem);
  float* os = qs + t4 * pitch;
  float* mst = os + t4 * pitch;  // [3][t4]: max, sum, rowsum
  float* kbuf = mst + 3 * t4;                              // [warps][R][hd]
  float* vbuf = kbuf + warps * R * hd;                     // [warps][R][hd]
  float* pbuf = vbuf + warps * R * hd;                     // [warps][R][t4]
  float* dsbuf = pbuf + warps * R * t4;                    // [warps][R][t4]

  const int slab = blockIdx.x;
  const int64_t in_off = lay.head(lay.qkv, slab);
  const int64_t do_off = lay.head(lay.dout, slab);
  stage_quads(qs, q + in_off, lay.qkv.t, t, t4, hd);
  stage_quads(os, dout + do_off, lay.dout.t, t, t4, hd);
  const float* st = stats + static_cast<int64_t>(slab) * 3 * t;
  for (int i = threadIdx.x; i < 3 * t; i += blockDim.x) {
    const int which = i / t;
    mst[which * t4 + (i - which * t)] = st[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key_begin = blockIdx.y * keys_per_block;
  const int key_end = min(t, key_begin + keys_per_block);
  const int c0 = key_begin + warp * R;
  if (c0 >= key_end) return;  // no block-wide barrier follows
  float* kw = kbuf + warp * R * hd;
  float* vw = vbuf + warp * R * hd;
  float* pw = pbuf + warp * R * t4;
  float* dsw = dsbuf + warp * R * t4;
  for (int idx = lane; idx < R * hd; idx += 32) {
    const int rr = idx / hd;
    const int d = idx - rr * hd;
    const int key = c0 + rr;
    const bool in = key < key_end;
    kw[idx] = in ? k[in_off + key * lay.qkv.t + d] : 0.f;
    vw[idx] = in ? v[in_off + key * lay.qkv.t + d] : 0.f;
  }
  __syncwarp();

  // S and dP for R keys at once; lane owns queries lane + 32 i. Same
  // element order as the row pass: S[i][j] = sum_d q[i][d] k[j][d].
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
      const int qi = lane + 32 * i;
      if (qi < t) {
        const float4 qv = load4(qs + qi * pitch + d);
        const float4 ov = load4(os + qi * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][i] = dot4(qv, kv[r], s[r][i]);
          dp[r][i] = dot4(ov, vv[r], dp[r][i]);
        }
      }
    }
  }

  // P and dS with the row pass's statistics.
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int qi = lane + 32 * i;
    if (qi < t4) {
      const bool in = qi < t;
      const float m = in ? mst[qi] : 0.f;
      const float l = in ? mst[t4 + qi] : 1.f;
      const float rs = in ? mst[2 * t4 + qi] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = in ? expf(__fmul_rn(s[r][i], scale) - m) / l : 0.f;  // as the row pass rounds it
        pw[r * t4 + qi] = in ? p : 0.f;
        dsw[r * t4 + qi] = in ? p * (dp[r][i] - rs) * scale : 0.f;
      }
    }
  }
  __syncwarp();

  // dV = P^T dO and dK = dS^T Q: lane owns dims lane + 32 i, for R keys.
  float av[R][kDimsPerLane], ak[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) av[r][i] = ak[r][i] = 0.f;
  for (int qi = 0; qi < t; ++qi) {
    float pv[R], dsv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pv[r] = pw[r * t4 + qi];  // broadcast
      dsv[r] = dsw[r * t4 + qi];
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
  const int64_t g_off = lay.head(lay.grad, slab);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = c0 + r;
    if (key < key_end) {
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
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) (void)cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

// The most warps (8, 4 or 2) whose shared memory fits the device; 0 if none.
int pick_warps(int t, int hd, bool cols, size_t limit) {
  for (int w = kMaxWarps; w >= 2; w >>= 1) {
    if (smem_bytes(t, hd, w, cols) <= limit) return w;
  }
  return 0;
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
               float* stats, int slabs, const Layout& lay, float scale, cudaStream_t stream) {
  int dev = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t = lay.t;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(dout);

  const int wr = pick_warps(t, lay.hd, false, limit);
  const int wc = pick_warps(t, lay.hd, true, limit);
  if (wr == 0 || wc == 0) return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem_r = smem_bytes(t, lay.hd, wr, false);
  err = allow_smem(mha_bwd_rows, smem_r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = wr * kRows;
  const dim3 grid_r(slabs, (t + rows - 1) / rows);
  mha_bwd_rows<<<grid_r, wr * 32, smem_r, stream>>>(qp, kp, vp, op, static_cast<float*>(dq), stats, lay, scale,
                                                    rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_c = smem_bytes(t, lay.hd, wc, true);
  err = allow_smem(mha_bwd_cols, smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int keys = wc * kRows;
  const dim3 grid_c(slabs, (t + keys - 1) / keys);
  mha_bwd_cols<<<grid_c, wc * 32, smem_c, stream>>>(qp, kp, vp, op, static_cast<float*>(dk),
                                                    static_cast<float*>(dv), stats, lay, scale, keys);
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
  if (dtype == 0) return launch_f32(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
  switch (hd) {
    case 16: return launch_bf16<16>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 32: return launch_bf16<32>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 48: return launch_bf16<48>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 64: return launch_bf16<64>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 80: return launch_bf16<80>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 96: return launch_bf16<96>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    case 112: return launch_bf16<112>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
    default: return launch_bf16<128>(q, k, v, dout, dq, dk, dv, stats, slabs, lay, scale, s);
  }
}

}  // extern "C"
