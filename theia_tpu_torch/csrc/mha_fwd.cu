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
// Inputs are float32 or bf16, T <= 256, hd <= 128 and a multiple of 16; every
// such shape fits a block's shared memory.
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
// float32, tensor cores as 3xTF32 (mha_fwd_f32<HD>): no tensor-core
//   instruction multiplies in full float32, so each product is three tf32
//   mma.sync m16n8k8 over operands split into big and small halves
//   (mma_tf32.cuh), ~2^-21 relative. At [64,197,12,64] the products are 7.6
//   GFLOP: 114 us at the CUDA cores' 67 TFLOP/s, 46 us as three tf32
//   products at the tensor cores' 495, as long as the bytes take (155 MB).
//   The design is K2's float32 row pass (mha_bwd.cu) without dP: kSplit = 2
//   warps share a group of 16 query rows, part p holding key tiles p, p + 2,
//   ... of 8 keys, so a thread keeps 4 floats of S, then P, a tile (64
//   registers at T = 256) and 16 warps a block fit the 128 registers a
//   thread of a 512-thread block may use (hd <= 64; 8 warps above). S, the
//   row max, exp and sum are the row pass's in the same order, and P = p / l
//   is the same IEEE quotient (div_rn from one reciprocal a row where it is
//   exact, else the division), so P is the number the backward recomputes.
//   O = P V takes each P tile from the accumulators as its A operand; part 1
//   parks its partial O in shared memory, where part 0 adds it
//   (deterministic, no atomics). Q's rows, K and V are staged with cp.async
//   in rows of pitch HD + 4 (32 distinct banks both along rows, for Q's A
//   and S's B, and down columns, for P V's B): K and V whole, V landing
//   during S, where they fit in 227 KB; else (hd 112 past T = 216, hd 128
//   past 184) K alone, and V restaged into K's place once every warp has
//   formed S, landing during the softmax. So every T <= 256 fits at every
//   head dim. A warp's key tiles go in groups of 4 under one branch, S
//   issuing each term of 3xTF32 for the whole group before the next. What
//   holds it on the H100 (PERF.md, section 6): not the tensor cores nor the
//   bytes but latency at 16 resident warps a SM (one block), with ~4 other
//   instructions a product (operand splits, shared-memory loads) and the
//   softmax's exact expf; grouping the tiles and div_rn each took time off
//   (the ablations of tools/time_mha_bwd.py --kernel mha_fwd).
//
// The ragged edge (T = 197, 204) is masked per key and per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "div_rn.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
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
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// The block shape, the staging, the grouping of key tiles and the division
// may be set with -D (THEIA_K1_F32_SPLIT, THEIA_K1_F32_WARPS,
// THEIA_K1_F32_RESTAGE, THEIA_K1_F32_GROUP, THEIA_K1_F32_DIV_RN) to time the
// alternatives (tools/time_mha_bwd.py --kernel mha_fwd --ablations); the
// defaults are the fastest measured.
#ifndef THEIA_K1_F32_SPLIT
#define THEIA_K1_F32_SPLIT 2
#endif
#ifndef THEIA_K1_F32_GROUP
#define THEIA_K1_F32_GROUP 4
#endif
#ifndef THEIA_K1_F32_RESTAGE
#define THEIA_K1_F32_RESTAGE 0
#endif
#ifndef THEIA_K1_F32_DIV_RN
#define THEIA_K1_F32_DIV_RN 1
#endif

constexpr int kSplit = THEIA_K1_F32_SPLIT;     // warps that share a 16-row group, each with 1/kSplit of the keys
constexpr bool kDivRn = THEIA_K1_F32_DIV_RN;  // P = p / l by div_rn where it is exact, else `/` throughout
constexpr int kMaxKeyTiles = kMaxT / 8;
static_assert(kMaxKeyTiles % kSplit == 0, "the parts hold whole key tiles");
// A warp's key tiles go in groups of kSGroup under one branch (the last
// group's tiles past T each under its own), and S issues each term of 3xTF32
// for the group's tiles before the next: a branch a tile left the scheduler
// one tile's chain of 3 dependent products at a time
constexpr int kSGroup = THEIA_K1_F32_GROUP;
static_assert(kMaxKeyTiles / kSplit % kSGroup == 0, "the parts hold whole groups of tiles");
constexpr size_t kMaxSmem = 232448;  // the 227 KB a block of sm_90 may opt in to

// Warps a block: 16 (one block of 512 threads a SM at 128 registers a
// thread) up to hd = 64, 8 above, where O's accumulators pass 128.
template <int HD>
__host__ __device__ constexpr int f32_warps() {
#ifdef THEIA_K1_F32_WARPS
  return THEIA_K1_F32_WARPS;
#else
  return HD <= 64 ? 16 : 8;
#endif
}

template <int HD>
__host__ __device__ constexpr int f32_rows() {  // query rows a block
  return 16 * f32_warps<HD>() / kSplit;
}

__host__ __device__ constexpr int round8(int t) { return (t + 7) & ~7; }

// Shared memory, in floats: a first region that holds K as [round8(T)][HD +
// 4], then V where it is restaged there, then the parts' partial O
// ([groups][kSplit - 1][16 * HD]); V as [round8(T)][HD + 4] where it has a
// region of its own (`apart`); the parts' row maxima and sums
// [2][warps][16]; and the block's Q rows, [rows][HD + 4].
template <int HD>
struct F32Smem {
  static constexpr int kParked = f32_warps<HD>() / kSplit * (kSplit - 1) * 16 * HD;
  int v, red, q, total;

  __host__ __device__ F32Smem(int t, bool apart) {
    const int staged = round8(t) * (HD + 4);
    const int first = staged > kParked ? staged : kParked;
    v = apart ? first : 0;
    red = first + (apart ? staged : 0);
    q = red + 2 * f32_warps<HD>() * 16;
    total = q + f32_rows<HD>() * (HD + 4);
  }
};

// V gets a region of its own, and lands during S = Q K^T, where it fits;
// else (hd 112 past T = 216, hd 128 past 184) it is restaged into K's place
// once every warp has formed S, and lands during the softmax.
template <int HD>
bool f32_apart(int t) {
  return !THEIA_K1_F32_RESTAGE && F32Smem<HD>(t, true).total * sizeof(float) <= kMaxSmem;
}

template <int HD>
size_t smem_bytes_f32(int t) {
  return F32Smem<HD>(t, f32_apart<HD>(t)).total * sizeof(float);
}

// f(i) for the tiles i < live of a warp's N, in order, kSGroup of them
// under one branch where all of them are live.
template <int N, typename F>
__device__ __forceinline__ void for_live_tiles(int live, F&& f) {
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += kSGroup) {
    if (i0 + kSGroup <= live) {
#pragma unroll
      for (int i = i0; i < i0 + kSGroup; ++i) f(i);
    } else {
#pragma unroll
      for (int i = i0; i < i0 + kSGroup; ++i) {
        if (i < live) f(i);
      }
    }
  }
}

// The kSplit warps of a row group (named barrier 1 + group) combine their
// partial values a, b of rows g and g + 8 in part order through red[kSplit][16],
// so that all of them end with the same numbers (K2's row pass does the same).
template <typename Op>
__device__ __forceinline__ void combine_parts(float* red, int group, int part, float& a, float& b, Op op) {
  constexpr int KS = kSplit;
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

// A row group is kSplit warps that own the same 16 query rows; part p of a
// group holds key tiles p, p + kSplit, ... of 8 keys each: S = Q K^T (a
// k-step at a time over its tiles, Q's A fragments read from the block's
// rows in shared memory), then P in place in the accumulators. The parts'
// maxima and sums meet behind the group's named barrier. O = P V takes each
// P tile straight from the accumulators as its A operand (mma_cols_f32);
// parts 1 .. kSplit - 1 park their partial O in shared memory, where part 0
// adds them in part order and stores. Warps whose rows lie past T skip the
// work but reach every barrier of the block and copy their share of Q, K
// and V.
template <int HD>
__global__ void __launch_bounds__(f32_warps<HD>() * 32)
    mha_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ o, Layout lay, int row_blocks, float scale, bool apart) {
  constexpr int KS = kSplit;
  constexpr int kWarpsF32 = f32_warps<HD>();
  constexpr int kRows = f32_rows<HD>();
  constexpr int kPitch = HD + 4;
  constexpr int kTiles = kMaxKeyTiles / KS;  // key tiles a warp holds at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t8 = round8(t);
  const int key_tiles = t8 / 8;
  const F32Smem<HD> at(t, apart);
  float* ks = reinterpret_cast<float*>(smem);  // K; V where restaged; the parked O
  float* vs = ks + at.v;
  float* red = ks + at.red;  // [2][kWarpsF32][16]: the parts' max and sum
  float* qs = ks + at.q;

  const int slab = blockIdx.x / row_blocks;  // head-major: a slab's blocks share its K, V in L2
  const int row0 = (blockIdx.x - slab * row_blocks) * kRows;
  const size_t in_off = lay.in_head(slab, HD);
  const int64_t ts = lay.in_tstride;
  // a commit group each, in the order the block needs them: Q and K for S, V
  stage_rows_f32<HD>(qs, q + in_off + row0 * ts, ts, t - row0, kRows);
  stage_rows_f32<HD>(ks, k + in_off, ts, t, t8);
  if (apart) {
    stage_rows_f32<HD>(vs, v + in_off, ts, t, t8);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // Q and K are in shared memory

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int group = warp / KS;
  const int part = warp - group * KS;
  const int r0 = row0 + group * 16;
  const bool live = r0 < t;  // uniform over the group

  // S = Q K^T: tile i holds keys 8n .. 8n+7, n = KS i + part; element e of a
  // tile is row (e < 2 ? a : b), key 8n + 2*tq + (e & 1). The terms, their
  // order and the scale's rounding are K2's row pass's, so P is the number
  // the backward recomputes.
  float sc[kTiles][4] = {};
  const int live_tiles = (key_tiles - part + KS - 1) / KS;  // this warp's tiles below T
  if (live) {
#pragma unroll
    for (int s = 0; s < HD / 8; ++s) {
      const float* qa = qs + (group * 16 + (lane >> 2)) * kPitch + 8 * s + tq;
      const float a[4] = {qa[0], qa[8 * kPitch], qa[4], qa[8 * kPitch + 4]};
      uint32_t a_big[4], a_small[4];
      split_tf32(a, a_big, a_small);
#pragma unroll
      for (int i0 = 0; i0 < kTiles; i0 += kSGroup) {
        if (i0 + kSGroup <= live_tiles) {
          // mma_3xtf32's terms in its order, each for the whole group
          uint32_t b_big[kSGroup][2], b_small[kSGroup][2];
#pragma unroll
          for (int j = 0; j < kSGroup; ++j) b_rows<kPitch>(ks, 8 * (KS * (i0 + j) + part), 8 * s, b_big[j], b_small[j]);
#pragma unroll
          for (int j = 0; j < kSGroup; ++j) mma_tf32_1688(sc[i0 + j], a_small, b_big[j][0], b_big[j][1]);
#pragma unroll
          for (int j = 0; j < kSGroup; ++j) mma_tf32_1688(sc[i0 + j], a_big, b_small[j][0], b_small[j][1]);
#pragma unroll
          for (int j = 0; j < kSGroup; ++j) mma_tf32_1688(sc[i0 + j], a_big, b_big[j][0], b_big[j][1]);
        } else {
#pragma unroll
          for (int i = i0; i < i0 + kSGroup; ++i) {
            if (i < live_tiles) {
              uint32_t b_big[2], b_small[2];
              b_rows<kPitch>(ks, 8 * (KS * i + part), 8 * s, b_big, b_small);
              mma_3xtf32(sc[i], a_big, a_small, b_big, b_small);
            }
          }
        }
      }
    }
  }
  if (!apart) {
    __syncthreads();  // every warp is done with K
    stage_rows_f32<HD>(ks, v + in_off, ts, t, t8);  // V in K's place, in flight during the softmax
  }

  // P = exp(S * scale - m) / l, masked past T: the exact expf and the IEEE
  // quotient.
  if (live) {
    const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
    const auto sum2 = [](float x, float y) { return x + y; };
    float* red_group = red + group * KS * 16;
    float m_a = -INFINITY, m_b = -INFINITY;
    for_live_tiles<kTiles>(live_tiles, [&](int i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = (KS * i + part) * 8 + 2 * tq + (e & 1);
        sc[i][e] = key < t ? __fmul_rn(sc[i][e], scale) : -INFINITY;
      }
      m_a = fmaxf(m_a, fmaxf(sc[i][0], sc[i][1]));
      m_b = fmaxf(m_b, fmaxf(sc[i][2], sc[i][3]));
    });
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, off));
      m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, off));
    }
    combine_parts(red_group, group, part, m_a, m_b, fmax2);  // finite: part 0 holds key 0
    float l_a = 0.f, l_b = 0.f;
    float p_min = 1.f;  // the least p of a key below T: whether a quotient needs the IEEE division
    for_live_tiles<kTiles>(live_tiles, [&](int i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = (KS * i + part) * 8 + 2 * tq + (e & 1);
        sc[i][e] = key < t ? expf(sc[i][e] - (e < 2 ? m_a : m_b)) : 0.f;
        if (key < t) p_min = fminf(p_min, sc[i][e]);
      }
      l_a += sc[i][0] + sc[i][1];
      l_b += sc[i][2] + sc[i][3];
    });
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    combine_parts(red_group + kWarpsF32 * 16, group, part, l_a, l_b, sum2);
    // P = p / l: div_rn from one reciprocal a row (p = 0 past T stays 0),
    // or, where a p of the warp lies below div_rn's range, the division.
    if (kDivRn && !__any_sync(0xffffffffu, p_min < kDivRnMin)) {
      const float rl_a = 1.f / l_a, rl_b = 1.f / l_b;
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = div_rn(sc[i][e], e < 2 ? l_a : l_b, e < 2 ? rl_a : rl_b);
      }
    } else {
      for_live_tiles<kTiles>(live_tiles, [&](int i) {
        sc[i][0] /= l_a;
        sc[i][1] /= l_a;
        sc[i][2] /= l_b;
        sc[i][3] /= l_b;
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V is in shared memory (and K is free where V has a region of its own)

  // O = P V over this warp's key tiles.
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (live) for_live_tiles<kTiles>(live_tiles, [&](int i) { mma_cols_f32<HD>(acc, sc[i], vs, KS * i + part); });
  if constexpr (KS > 1) {
    if (!apart) __syncthreads();  // every warp is done with V before the parts park O in its place
    if (!live) return;
    // parked in K's place, in the fragments' own layout: a warp's 32 lanes
    // on 32 consecutive floats
    float* parked = ks + group * (KS - 1) * 16 * HD;
    if (part > 0) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) parked[(part - 1) * 16 * HD + (n * 4 + e) * 32 + lane] = acc[n][e];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(KS * 32) : "memory");
    if (part > 0) return;
#pragma unroll
    for (int p = 1; p < KS; ++p)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += parked[(p - 1) * 16 * HD + (n * 4 + e) * 32 + lane];
  } else if (!live) {
    return;
  }
  store_rows_f32<HD>(o + lay.out_head(slab, HD), lay.out_tstride, r0, t, acc);
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

// Resident blocks per SM of a kernel with `threads` a block and `smem` bytes
// of dynamic shared memory, or a negated cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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

// f(std::integral_constant<int, hd>{}, std::integral_constant<int, ncw>{})
// for the bf16 kernel: ncw = round128(t) / 128 in 1..2.
template <typename F>
int with_hd_nc(int hd, int t, F&& f) {
  return with_hd(hd, [&](auto h) {
    if (t <= 2 * kKeyChunk) return f(h, std::integral_constant<int, 1>{});
    return f(h, std::integral_constant<int, kMaxWgChunks>{});
  });
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int slabs, const Layout& lay, float scale,
               cudaStream_t stream) {
  const bool apart = f32_apart<HD>(lay.t);
  const size_t smem = smem_bytes_f32<HD>(lay.t);
  const cudaError_t err = allow_smem(mha_fwd_f32<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (lay.t + f32_rows<HD>() - 1) / f32_rows<HD>();
  mha_fwd_f32<HD><<<slabs * row_blocks, f32_warps<HD>() * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o),
      lay, row_blocks, scale, apart);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, t, heads, hd] as described by Layout: unit stride over
// hd, heads hd apart, batch and token strides in elements (a stride of a
// dimension of size 1 is never used). Pointers and strides are 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`. Every
// shape in range fits in shared memory, in both dtypes.
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
  if (dtype == 0) {
    return with_hd(hd, [&](auto h) { return launch_f32<decltype(h)::value>(q, k, v, o, slabs, lay, scale, s); });
  }
  return with_hd_nc(hd, t, [&](auto h, auto nc) {
    return launch_bf16<decltype(h)::value, decltype(nc)::value>(q, k, v, o, slabs, lay, scale, s);
  });
}

// Resident blocks per SM of the bf16 kernel at T = t and head dim hd
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negated cudaError_t.
int theia_mha_fwd_bf16_blocks_per_sm(int t, int hd) {
  if (t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd_nc(hd, t, [](auto h, auto nc) {
    constexpr int HD = decltype(h)::value, NCW = decltype(nc)::value;
    return blocks_per_sm(mha_fwd_bf16<HD, NCW>, kTcThreads, smem_bytes_bf16(NCW, HD));
  });
}

// The same for the float32 kernel, with the threads of one of its blocks in
// *threads.
int theia_mha_fwd_f32_blocks_per_sm(int t, int hd, int* threads) {
  if (t < 1 || t > kMaxT || hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    *threads = f32_warps<HD>() * 32;
    return blocks_per_sm(mha_fwd_f32<HD>, *threads, smem_bytes_f32<HD>(t));
  });
}

const char* theia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
