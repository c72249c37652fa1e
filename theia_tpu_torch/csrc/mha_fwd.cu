// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces theia_tpu/ops/attention.py::_mha_fwd_kernel (launched by
// _pallas_call_fwd). Q, K, V and O are [B, T, H, hd] with unit stride over
// hd and heads hd apart, and any batch and token strides: Q, K, V may be views into
// the packed QKV projection ([B, T, 3, H, hd]), so nothing is copied into a
// per-head layout first. For each (batch, head) slab, [T, hd]:
//   S = Q K^T * scale, accumulated in float32;
//   m = the row max; p = expf(S - m); l = sum of p;
//   P = p / l (a division), rounded to V's dtype (this matters in bf16);
//   O = P V accumulated in float32 and stored in Q's dtype.
// Inputs are float32 or bf16, T <= 256, hd <= 128 and a multiple of 16.
//
// The TPU kernel kept the whole T x T score block in VMEM. Here nothing of
// size T x T leaves the SM: a block stages one head's K and V in shared
// memory and serves up to 64 query rows from them; each row's scores stay
// in registers until its P V is done; the row max and sum are warp
// shuffles. The whole key row is in registers at once (T <= 256), so P is
// normalised by the final max and sum before it is rounded, exactly as the
// TPU kernel rounds it (an online softmax would round P against a running
// max instead). Two implementations, chosen by dtype:
//
// bf16, wgmma (mha_fwd_bf16<HD, NCW>): two warpgroups (256 threads) own 64
//   query rows of one head and split its keys in halves. Q, K and V go into
//   shared memory with cp.async in wgmma's 128-byte-swizzled layout
//   (wgmma_bf16.cuh); V's copy is in flight during S = Q K^T. Each
//   warpgroup computes its half of S as NCW chunks of m64n64k16 wgmma (A = Q
//   and B = K, both K-major descriptors), all issued before one wait; the
//   accumulators are mma.sync's C layout per warp, so a row's max and sum
//   are two xor-shuffles in each warpgroup and one exchange through shared
//   memory. P = p / l (div_rn: the IEEE quotient from one reciprocal a row)
//   rounded to bf16 is already the register A fragment of O = P V, one
//   m64n(hd)k16 wgmma per 16 keys with V as the MN-major B (the transpose
//   bit); warpgroup 1 hands its float32 partial O to warpgroup 0 through
//   shared memory, which adds and stores. Splitting the keys halves the
//   score registers (64 a thread at T <= 256), so 2 blocks a SM run without
//   spills under 128 registers; one warpgroup holding whole rows needed
//   ~200 and spilled under the 168 that 3 blocks allow (PERF.md, section 6).
//   What bounds it on the H100: at [64,197,12,64] the bytes (77.5 MB, 23 us)
//   and the operations (7.6 GFLOP, 8 us) lie well below its time. Each of a
//   head's row blocks stages the whole K and V (~4x the unique bytes through
//   L2), and each block runs load, S, softmax (~16 instructions a score,
//   expf and the division included), P V and store in turn, with 2 blocks a
//   SM to overlap them. Blocks are ordered head-major so the row blocks of a
//   head share its K and V in L2.
//
// float32, CUDA cores (mha_fwd_f32): no tensor-core instruction multiplies
//   in full float32, so the products run as FMAs. Lane j owns keys j, j+32,
//   ...; a warp owns kRowsPerWarp = 4 rows, so each K and V element read from
//   shared memory feeds 4 rows. Measured latency-bound (one resident block
//   per SM): ~1.5x the time of the cuBLAS-based plain version at B = 64.
//
// The ragged edge (T = 197, 204) is masked per key and per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "div_rn.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxT = 256;
constexpr int kMaxHd = 128;

// Where a slab lives: token r of head h of batch entry b starts at element
// b * bstride + r * tstride + h * hd. Q, K and V share the in_ strides; O has
// the out_ strides.
struct Layout {
  int t;
  int heads;
  int64_t in_bstride;
  int64_t in_tstride;
  int64_t out_bstride;
  int64_t out_tstride;

  __device__ __forceinline__ size_t in_head(int slab, int hd) const {
    return static_cast<size_t>(slab / heads) * in_bstride + static_cast<size_t>(slab % heads) * hd;
  }
  __device__ __forceinline__ size_t out_head(int slab, int hd) const {
    return static_cast<size_t>(slab / heads) * out_bstride + static_cast<size_t>(slab % heads) * hd;
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kTcThreads = 2 * kWgThreads;
constexpr int kTcRowsPerBlock = 64;
constexpr int kKeyChunk = 64;  // keys per wgmma of S = Q K^T
constexpr int kMaxWgChunks = kMaxT / (2 * kKeyChunk);

// Shared memory: 64 rows of Q, then K and V as 2 * ncw * 64 rows each (T
// rounded up to whole chunks of both warpgroups, zeros past T), each in
// round64(hd) / 64 swizzle atoms of 128-byte rows; 1 KB to align the base to
// 1024 bytes; and the row maxima and sums the two warpgroups exchange.
// The float32 partial O of warpgroup 1, [64][hd + 8], reuses Q's and K's
// space once S is done.
constexpr int kOPitch = 8;  // floats of padding a row of partial O
size_t smem_bytes_bf16(int ncw, int hd) {
  return static_cast<size_t>(round64(hd) / 64) * (kTcRowsPerBlock + 4 * ncw * kKeyChunk) * 128 + 1024 +
         4 * kTcRowsPerBlock * sizeof(float);
}

// One block owns 64 query rows of one head and has two warpgroups, each of
// which takes half of the keys: NCW = round128(T) / 128 chunks of 64 keys
// each. A whole row's scores then take 32 * NCW registers a thread, so the
// block runs without spills under the 128 registers that 2 blocks of 256
// threads a SM allow. Every loop that issues a wgmma has a bound known to the
// compiler: a wgmma under a branch it cannot prove uniform is serialized
// (ptxas C7520).
template <int HD, int NCW>
__global__ void __launch_bounds__(kTcThreads, 2)
    mha_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Layout lay,
                 int row_blocks, float scale) {
  constexpr int kDimSteps = HD / 16;  // k16 steps of S = Q K^T
  constexpr int kKeys = 2 * NCW * kKeyChunk;
  constexpr int kKeySteps = NCW * kKeyChunk / 16;  // k16 steps of O = P V a warpgroup
  constexpr int kAtomBytes = kKeys * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + round64(HD) / 64 * kTcRowsPerBlock * 128;
  unsigned char* vs = ks + round64(HD) / 64 * kAtomBytes;
  float* row_max = reinterpret_cast<float*>(vs + round64(HD) / 64 * kAtomBytes);  // [2][64]
  float* row_sum = row_max + 2 * kTcRowsPerBlock;                                  // [2][64]
  float* o_part = reinterpret_cast<float*>(qs);  // [64][HD + kOPitch], after S
  const int t = lay.t;

  // Blocks are ordered head-major, so the row blocks of one head run
  // together and share its K and V in L2.
  const int head = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x - head * row_blocks) * kTcRowsPerBlock;
  const int64_t rs = lay.in_tstride;
  const size_t in_head = lay.in_head(head, HD);
  stage_sw128<HD, kTcThreads>(qs, q + in_head + row0 * rs, rs, t - row0, kTcRowsPerBlock);  // copy group 1: Q
  stage_sw128<HD, kTcThreads>(ks, k + in_head, rs, t, kKeys);                                // copy group 2: K
  stage_sw128<HD, kTcThreads>(vs, v + in_head, rs, t, kKeys);  // copy group 3: V, in flight during Q K^T
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();  // Q and K are in shared memory

  // S = Q K^T over this warpgroup's keys, 64 a chunk, all issued before the
  // first wait: sc[c][4i + e] is row (e < 2 ? row_a : row_b), key
  // key0 + 64c + 8i + 2tq + (e & 1).
  const int wg = threadIdx.x / kWgThreads;
  const int key0 = wg * NCW * kKeyChunk;
  const uint32_t qaddr = smem_addr(qs), kaddr = smem_addr(ks);
  float sc[NCW][32];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NCW; ++c) {
#pragma unroll
    for (int s = 0; s < kDimSteps; ++s) {
      const uint32_t qa = qaddr + (s / 4) * kTcRowsPerBlock * 128 + (s % 4) * 32;
      const uint32_t ka = kaddr + (s / 4) * kAtomBytes + (key0 + c * kKeyChunk) * 128 + (s % 4) * 32;
      wgmma_ss<0>(sc[c], desc_sw128(qa, 16, 1024), desc_sw128(ka, 16, 1024), s > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NCW; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_operand(sc[c][e]);

  // Softmax over each row in float32: a row's keys are spread over the 4
  // lanes of its group in each warpgroup, so max and sum finish with two
  // xor-shuffles and one exchange between the warpgroups. The block skips
  // as a whole the 8-key tiles past T (P = 0 there) and the warps whose 16
  // rows all lie past T (their P is never stored); only the one tile that T
  // cuts is masked key by key.
  const int tq = threadIdx.x & 3;  // fragment column pair of this lane
  const int rw = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);  // row_a - row0
  const bool warp_live = row0 + (rw & ~15) < t;
  float m_a = -INFINITY, m_b = -INFINITY;
  if (warp_live) {
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int tile = key0 + c * kKeyChunk + 8 * (e >> 2);
        if (tile + 8 <= t) {
          sc[c][e] *= scale;
        } else if (tile < t) {
          sc[c][e] = tile + 2 * tq + (e & 1) < t ? sc[c][e] * scale : -INFINITY;
        }
        if (tile < t) {
          if (e & 2) {
            m_b = fmaxf(m_b, sc[c][e]);
          } else {
            m_a = fmaxf(m_a, sc[c][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, off));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, off));
  }
  if (tq == 0) {
    row_max[wg * kTcRowsPerBlock + rw] = m_a;
    row_max[wg * kTcRowsPerBlock + rw + 8] = m_b;
  }
  __syncthreads();
  m_a = fmaxf(m_a, row_max[(1 - wg) * kTcRowsPerBlock + rw]);
  m_b = fmaxf(m_b, row_max[(1 - wg) * kTcRowsPerBlock + rw + 8]);

  // p = exp(S - m); p_min, the least p of a real key, tells whether any
  // quotient p / l needs the IEEE division (div_rn)
  float l_a = 0.f, l_b = 0.f, p_min = 1.f;
  if (warp_live) {
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int tile = key0 + c * kKeyChunk + 8 * (e >> 2);
        if (tile < t) {
          sc[c][e] = expf(sc[c][e] - ((e & 2) ? m_b : m_a));  // 0 for a key past T (S = -inf)
          if (tile + 8 <= t) {
            p_min = fminf(p_min, sc[c][e]);
          } else if (tile + 2 * tq + (e & 1) < t) {
            p_min = fminf(p_min, sc[c][e]);
          }
          if (e & 2) {
            l_b += sc[c][e];
          } else {
            l_a += sc[c][e];
          }
        } else {
          sc[c][e] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  if (tq == 0) {
    row_sum[wg * kTcRowsPerBlock + rw] = l_a;
    row_sum[wg * kTcRowsPerBlock + rw + 8] = l_b;
  }
  __syncthreads();
  l_a = row_sum[rw] + row_sum[kTcRowsPerBlock + rw];  // the same order in both warpgroups
  l_b = row_sum[rw + 8] + row_sum[kTcRowsPerBlock + rw + 8];

  // P, divided by the row sums and rounded to bf16: the S tiles 2j and
  // 2j + 1 (of 8 keys each) are the A fragment of k16 step j of O = P V.
  uint32_t pa[kKeySteps][4];
  if (warp_live) {
    float rl_a = 1.f / l_a, rl_b = 1.f / l_b;
    if (__any_sync(0xffffffffu, p_min < kDivRnMin)) {
      // Rare: a p below div_rn's range. Every p of the warp becomes its IEEE
      // quotient, in a loop over a local copy (one division in the code,
      // nothing live across it), and the packing below divides by 1.
      float p_local[NCW * 32];
#pragma unroll
      for (int c = 0; c < NCW; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) p_local[c * 32 + e] = sc[c][e];
#pragma unroll 1
      for (int i = 0; i < NCW * 32; ++i) p_local[i] = div_ieee(p_local[i], (i & 2) ? l_b : l_a);
#pragma unroll
      for (int c = 0; c < NCW; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[c][e] = p_local[c * 32 + e];
      l_a = l_b = rl_a = rl_b = 1.f;
    }
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) {
      const int c = j / 4, e = 8 * (j % 4);
      pa[j][0] = pack_bf16(div_rn(sc[c][e], l_a, rl_a), div_rn(sc[c][e + 1], l_a, rl_a));
      pa[j][1] = pack_bf16(div_rn(sc[c][e + 2], l_b, rl_b), div_rn(sc[c][e + 3], l_b, rl_b));
      pa[j][2] = pack_bf16(div_rn(sc[c][e + 4], l_a, rl_a), div_rn(sc[c][e + 5], l_a, rl_a));
      pa[j][3] = pack_bf16(div_rn(sc[c][e + 6], l_b, rl_b), div_rn(sc[c][e + 7], l_b, rl_b));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0u;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // V is in shared memory

  // O = P V over this warpgroup's keys: V is the MN-major B operand (keys
  // down, dims across), one m64n(HD)k16 wgmma per 16 keys, all issued before
  // one wait.
  const uint32_t vaddr = smem_addr(vs) + key0 * 128;
  float acc[HD / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j) {
    wgmma_rs<1>(acc, pa[j], desc_sw128(vaddr + j * 16 * 128, kAtomBytes, 1024), j > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) fence_operand(acc[e]);
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(pa[j][e]);

  // O = warpgroup 0's partial + warpgroup 1's, through shared memory.
  constexpr int kP = HD + kOPitch;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int d = i * 8 + 2 * tq;
      *reinterpret_cast<float2*>(o_part + rw * kP + d) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(o_part + (rw + 8) * kP + d) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  __syncthreads();
  if (wg == 1) return;
  const int row_a = row0 + rw;
  const int row_b = row_a + 8;
  __nv_bfloat16* oh = o + lay.out_head(head, HD);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * tq;
    const float2 pa_ = *reinterpret_cast<const float2*>(o_part + rw * kP + d);
    const float2 pb_ = *reinterpret_cast<const float2*>(o_part + (rw + 8) * kP + d);
    if (row_a < t) {
      *reinterpret_cast<uint32_t*>(oh + row_a * lay.out_tstride + d) = pack_bf16(acc[4 * i] + pa_.x, acc[4 * i + 1] + pa_.y);
    }
    if (row_b < t) {
      *reinterpret_cast<uint32_t*>(oh + row_b * lay.out_tstride + d) =
          pack_bf16(acc[4 * i + 2] + pb_.x, acc[4 * i + 3] + pb_.y);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kKeysPerLane = kMaxT / 32;
constexpr int kDimsPerLane = kMaxHd / 32;

__host__ __device__ constexpr int round4(int t) { return (t + 3) & ~3; }

// Shared memory: K and V as [round4(T)][hd + 4] (16-byte padded rows), then
// per warp kRowsPerWarp query rows [hd] and probability rows [round4(T)].
size_t smem_bytes_f32(int t, int hd) {
  return (2 * static_cast<size_t>(round4(t)) * (hd + 4) +
          static_cast<size_t>(kWarps) * kRowsPerWarp * (hd + round4(t))) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    mha_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ o, Layout lay, int hd, float scale, int rows_per_block) {
  constexpr int R = kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int pitch = hd + 4;
  const int t4 = round4(t);
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + t4 * pitch;
  float* qbuf = vs + t4 * pitch;        // [kWarps][R][hd]
  float* pbuf = qbuf + kWarps * R * hd;  // [kWarps][R][t4]

  const int64_t rs = lay.in_tstride;
  const float* qh = q + lay.in_head(blockIdx.x, hd);
  const float* kh = k + lay.in_head(blockIdx.x, hd);
  const float* vh = v + lay.in_head(blockIdx.x, hd);
  float* oh = o + lay.out_head(blockIdx.x, hd);

  // Stage K and V (rows t..t4-1 as zeros): 16-byte vectors, neighbouring
  // threads on neighbouring addresses.
  const int vecs = hd / 4;
  for (int i = threadIdx.x; i < t4 * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(ks + r * pitch + c) =
        r < t ? *reinterpret_cast<const float4*>(kh + r * rs + c) : zero;
    *reinterpret_cast<float4*>(vs + r * pitch + c) =
        r < t ? *reinterpret_cast<const float4*>(vh + r * rs + c) : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(t, row_begin + rows_per_block);
  const int r0 = row_begin + warp * R;
  if (r0 >= row_end) return;  // no block-wide barrier follows
  float* qw = qbuf + warp * R * hd;
  float* pw = pbuf + warp * R * t4;

  for (int idx = lane; idx < R * hd; idx += 32) {
    const int rr = idx / hd;
    const int row = r0 + rr;
    qw[idx] = row < row_end ? qh[row * rs + idx - rr * hd] : 0.f;
  }
  __syncwarp();

  // Scores: lane owns keys lane + 32*i, for R rows at once.
  float s[R][kKeysPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[r][i] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 qv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) qv[r] = *reinterpret_cast<const float4*>(qw + r * hd + d);  // broadcast
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < t) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + j * pitch + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][i] = fmaf(qv[r].x, kv.x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv.y, s[r][i]);
          s[r][i] = fmaf(qv[r].z, kv.z, s[r][i]);
          s[r][i] = fmaf(qv[r].w, kv.w, s[r][i]);
        }
      }
    }
  }

  // Softmax of each row, masked past T; P is zero from T up to t4.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      s[r][i] = j < t ? s[r][i] * scale : -INFINITY;
      m = fmaxf(m, s[r][i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      s[r][i] = j < t ? expf(s[r][i] - m) : 0.f;
      l += s[r][i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < t4) pw[r * t4 + j] = j < t ? s[r][i] / l : 0.f;
    }
  }
  __syncwarp();

  // O = P V: lane owns dims lane + 32*i, for R rows at once.
  float acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int j = 0; j < t4; j += 4) {
    float4 p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = *reinterpret_cast<const float4*>(pw + r * t4 + j);  // broadcast
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
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    if (row < row_end) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) oh[row * lay.out_tstride + d] = acc[r][i];
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

template <int HD, int NCW>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int slabs, const Layout& lay,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16(NCW, HD);
  const cudaError_t err = allow_smem(mha_fwd_bf16<HD, NCW>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (lay.t + kTcRowsPerBlock - 1) / kTcRowsPerBlock;
  mha_fwd_bf16<HD, NCW><<<slabs * row_blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lay, row_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of mha_fwd_bf16<HD, NCW> (its block size and
// shared memory), or a negated cudaError_t.
template <int HD, int NCW>
int blocks_per_sm_bf16() {
  const size_t smem = smem_bytes_bf16(NCW, HD);
  cudaError_t err = allow_smem(mha_fwd_bf16<HD, NCW>, smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mha_fwd_bf16<HD, NCW>, kTcThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// f(std::integral_constant<int, hd>{}, std::integral_constant<int, ncw>{})
// for hd in 16..128 step 16 and ncw = round128(t) / 128 in 1..2.
template <int HD, typename F>
int with_nc(int t, F&& f) {
  if (t <= 2 * kKeyChunk) return f(std::integral_constant<int, HD>{}, std::integral_constant<int, 1>{});
  return f(std::integral_constant<int, HD>{}, std::integral_constant<int, kMaxWgChunks>{});
}

template <typename F>
int with_hd_nc(int hd, int t, F&& f) {
  switch (hd) {
    case 16: return with_nc<16>(t, f);
    case 32: return with_nc<32>(t, f);
    case 48: return with_nc<48>(t, f);
    case 64: return with_nc<64>(t, f);
    case 80: return with_nc<80>(t, f);
    case 96: return with_nc<96>(t, f);
    case 112: return with_nc<112>(t, f);
    default: return with_nc<128>(t, f);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int slabs, const Layout& lay,
               int hd, float scale, cudaStream_t stream) {
  const int t = lay.t;
  const size_t smem = smem_bytes_f32(t, hd);
  const cudaError_t err = allow_smem(mha_fwd_f32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Split the T rows evenly over the fewest blocks of at most kRowsPerBlock
  // rows, in whole groups of kRowsPerWarp.
  const int blocks_y = (t + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rows = (t + blocks_y - 1) / blocks_y;
  const int rows_per_block = (rows + kRowsPerWarp - 1) / kRowsPerWarp * kRowsPerWarp;
  const dim3 grid(slabs, blocks_y);
  mha_fwd_f32<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                static_cast<const float*>(v), static_cast<float*>(o), lay,
                                                hd, scale, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, t, heads, hd] as described by Layout: unit stride over
// hd, heads hd apart, batch and token strides in elements (a stride of a
// dimension of size 1 is never used). Pointers and strides are 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`. Every
// bf16 shape in range fits in shared memory; float32 shapes whose staged K,
// V and row buffers exceed the 227 KB a block may use return
// cudaErrorInvalidValue (hd <= 64 fits every T <= 256; hd = 128 fits T <= 152).
int theia_mha_fwd(const void* q, const void* k, const void* v, void* o, int batch, int heads, int t,
                  int hd, int64_t in_bstride, int64_t in_tstride, int64_t out_bstride,
                  int64_t out_tstride, int dtype, float scale, void* stream) {
  const int64_t align = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const int64_t strides[4] = {in_bstride, in_tstride, out_bstride, out_tstride};
  if (batch < 1 || heads < 1 || t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const int64_t stride : strides) {
    if (stride < 0 || stride % align != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay{t, heads, in_bstride, in_tstride, out_bstride, out_tstride};
  const int slabs = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, o, slabs, lay, hd, scale, s);
  return with_hd_nc(hd, t, [&](auto h, auto nc) {
    return launch_bf16<decltype(h)::value, decltype(nc)::value>(q, k, v, o, slabs, lay, scale, s);
  });
}

// Resident blocks per SM of the bf16 kernel at T = t and head dim hd
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negated cudaError_t.
int theia_mha_fwd_bf16_blocks_per_sm(int t, int hd) {
  if (t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd_nc(hd, t, [](auto h, auto nc) { return blocks_per_sm_bf16<decltype(h)::value, decltype(nc)::value>(); });
}

const char* theia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
