// K12: attention with SAM's decomposed relative-position bias, float32, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes SAM's attention with
// XLA (theia_tpu/foundation/sam.py `_decomposed_attn`), and the port ran
// the same in plain PyTorch. This kernel is its float32 forward, for both
// of SAM ViT-H's layer kinds: 14 x 14 windows (T = 196, B' = batch x 25
// windows, the grid padded from 64 to 70 with zero tokens, which take part
// unmasked as HF SamVisionLayer's do) and global layers over the 64 x 64
// grid (T = 4096). For each (batch entry, head) slab, [T, hd], over the S x
// S token grid (T = S^2, token r at row r / S, column r % S):
//   S[q, k] = (q . k) * scale + rel_h[q, k / S] + rel_w[q, k % S]
//   O[q]    = softmax_k(S[q, k]) V
// with rel_h[q, ky] = q . rel_pos_h[qy - ky + S - 1] and rel_w likewise
// over columns (HF `add_decomposed_rel_pos`). The two bias terms come from
// the caller as the products of every query with every row of the tables,
// ph[q, i] = q . rel_pos_h[i] and pw[q, i] = q . rel_pos_w[i] (i < 2S - 1;
// ops/attention.py `relpos_tables`, two batched matrix products), and the
// kernel gathers ph[q, qy - ky + S - 1] + pw[q, qx - kx + S - 1] for each
// score: the gather index is the kernel's, the products are cuBLAS's.
// Writing the scores' bias instead would be a [T, T] tensor a slab, the
// traffic this kernel exists to avoid.
//
// What bounds it on the H100. At SAM-H's batch of 32 a global call does
// 2.75 TFLOP (q k^T and p v) against 2.7 GB of q, k, v and o: the tensor
// cores are the limit, 5.55 ms at TF32's 495 TFLOP/s, three times that as
// 3xTF32. A window call does 157 GFLOP against 3.2 GB: its bytes bound it,
// 0.96 ms at 3.35 TB/s. The plain version writes the [B' H, T, T] float32
// scores to memory and passes over them about eight times (1 GiB blocks of
// query rows in the global layers).
//
// Design: K7's float32 forward (flash_attn.cu flash_fwd_f32) with the bias
// added to the scores in registers. A block owns 64 query rows of a slab,
// staged once in shared memory, and streams K and V through double-buffered
// cp.async tiles of 64 keys; each 16-row group is two warps that take
// alternate 8-key tiles and keep their own running max, sum and O (the
// online softmax), meeting once at the end. Products are 3xTF32 mma.sync
// (mma_tf32.cuh), the float32 precision of K1, K2 and K7-K9; each tile's
// P V is summed apart and added to O rounded to nearest (pv_tile), which
// keeps a 4096-key row as exact as a 196-key one. After a tile's
// q k^T each score is scaled, then ph and pw are added in HF's order (the
// operations pinned so they are not fused into one rounding), read with
// __ldg from the caller's tables, which stay in L1 and L2: a thread's two
// query rows read 2S - 1 values of each. Keys past T (the last window tile)
// are masked to -inf; rows past T are computed on zeros and not stored.
// No atomics, so the result is deterministic. A global call has 32 x 16 x
// 64 blocks, a window call 800 x 16 x 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

// Blocks a SM the launch bounds ask for where hd <= 80: 2 holds a thread to
// 128 registers; 1 leaves the compiler up to 255 (timed by
// tools/time_relpos_attn.py).
#ifndef THEIA_K12_MIN_BLOCKS
#define THEIA_K12_MIN_BLOCKS 2
#endif

namespace {

constexpr int kTile = 64;   // query rows a block owns; keys a streamed tile holds
constexpr int kSplit = 2;   // warps that share a 16-row group
constexpr int kThreads = 32 * (kTile / 16) * kSplit;
constexpr int kCols = kTile / 8 / kSplit;  // 8-key tiles of a streamed tile a warp takes
constexpr int kMaxHd = 128;

template <int HD>
__host__ __device__ constexpr int min_blocks() {
  return HD <= 80 ? THEIA_K12_MIN_BLOCKS : 1;
}

// Token r of head h of slab (b, h) of q, k, v starts at b * in_b + r * in_t +
// h * hd (o: out_b, out_t); the bias tables' row of that token at
// h * tab_h + b * tab_b + r * tab_t, 2S - 1 entries.
struct RelposLayout {
  int t;
  int heads;
  int side;
  float inv_side;
  int64_t in_b, in_t;
  int64_t out_b, out_t;
  int64_t tab_h, tab_b, tab_t;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// i / side for 0 <= i < 2^20, exact: (i + 0.5) / side is at least 0.5 / side
// from an integer, far more than the float product's error.
__device__ __forceinline__ int div_side(int i, float inv_side) {
  return __float2int_rz((static_cast<float>(i) + 0.5f) * inv_side);
}

// The A fragment of a warp's 16 query rows, read a k-step at a time from the
// block's rows staged in shared memory (pitch HD + 4, 32 distinct banks).
template <int HD>
struct StagedQ {
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

// A lane's two query rows (g and g + 8 of its group): where their bias
// tables' rows start, offset so that row[-ky] is ph[q, qy - ky + S - 1] and
// col[-kx] is pw[q, qx - kx + S - 1].
struct RowBias {
  const float* row[2];
  const float* col[2];
};

// O = O * al + P V over a warp's 8-key tiles of one streamed tile, one
// 8-column block of O at a time: the tile's P V is summed in a fresh
// accumulator (3xTF32, each P tile, still in registers, the A operand of
// its 8 keys and V read down columns), then added to O in the CUDA cores,
// rounded to nearest. The tensor cores' float32 accumulation is not
// round-to-nearest: summed in O itself across the 64 tiles of a global
// layer, its error grew with the 768 products chained into each element
// (rel L2 1.5e-5 against the plain version at [32, 4096, 16, 80]); here a
// chain is one tile's 12. Each P tile is split into its tf32 halves once
// and held (32 registers); split again for each block of O it spilled and
// ran 4% slower.
template <bool kPartial, int HD>
__device__ __forceinline__ void pv_tile(float (&acc)[HD / 8][4], const float (&al)[2], const float (&p)[kCols][4],
                                        const float* vt, int part, int rows) {
  uint32_t p_big[kCols][4], p_small[kCols][4];
#pragma unroll
  for (int i = 0; i < kCols; ++i) c_as_a(p[i], p_big[i], p_small[i]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (!kPartial || 8 * (kSplit * i + part) < rows) {
        uint32_t b_big[2], b_small[2];
        b_cols<HD + 4>(vt, 8 * (kSplit * i + part), 8 * n, b_big, b_small);
        mma_3xtf32(t, p_big[i], p_small[i], b_big, b_small);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], al[e >> 1], t[e]);
  }
}

// A warp's work on one streamed key tile (keys key0 .., `rows` of them below
// T): S = Q K^T on its 8-key tiles, each score scaled and its two bias
// terms added, keys past T masked to -inf; the online softmax of rows g and
// g + 8 over them; then O = O * exp(m_old - m) + P V (pv_tile).
template <bool kPartial, int HD>
__device__ __forceinline__ void relpos_tile(float (&acc)[HD / 8][4], float (&m)[2], float (&l)[2],
                                            const StagedQ<HD>& qa, const float* kt, const float* vt, int part,
                                            int key0, int rows, float scale, const RowBias& rb, int side,
                                            float inv_side) {
  const int tq = threadIdx.x & 3;
  // element e of tile i is row g + 8 (e >> 1), key 8 (kSplit i + part) + 2tq + (e & 1)
  float sc[kCols][4];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
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
    for (int i = 0; i < kCols; ++i) {
      if (!kPartial || 8 * (kSplit * i + part) < rows) {
        b_rows<HD + 4>(kt, 8 * (kSplit * i + part), 8 * s, b_big, b_small);
        mma_3xtf32(sc[i], a_big, a_small, b_big, b_small);
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * (kSplit * i + part) + 2 * tq + (e & 1);
      if (!kPartial || kk < rows) {
        const int key = key0 + kk;
        const int ky = div_side(key, inv_side);
        const int kx = key - ky * side;
        const int r = e >> 1;
        // (q k^T) * scale + rel_h + rel_w, each rounding kept
        sc[i][e] = __fadd_rn(__fadd_rn(__fmul_rn(sc[i][e], scale), __ldg(rb.row[r] - ky)), __ldg(rb.col[r] - kx));
      } else {
        sc[i][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float base[2], al[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], mx[r]);
    // a warp none of whose keys so far is below T keeps m = -inf; exp's
    // argument is taken against 0 there, so that P and the correction are 0
    base[r] = mn == -INFINITY ? 0.f : mn;
    al[r] = expf(m[r] - base[r]);
    m[r] = mn;
    l[r] *= al[r];
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[i][e] = expf(sc[i][e] - base[e >> 1]);  // masked keys: 0
      l[e >> 1] += sc[i][e];
    }
  }
  pv_tile<kPartial, HD>(acc, al, sc, vt, part, rows);
}

// K12. A block owns 64 query rows of slab blockIdx.x / q_tiles; over the key
// tiles (K and V double-buffered with cp.async) relpos_tile on the warp's
// 8-key tiles; at the end the two warps of a row group meet once, in part
// order: m = max(m0, m1), each part's l and O rescaled by exp(mi - m) and
// added; then O / l for the rows below T.
template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
    relpos_attn_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ ph, const float* __restrict__ pw, float* __restrict__ o,
                    RelposLayout lay, int q_tiles, float scale) {
  constexpr int kPitch = HD + 4;
  constexpr int kBuf = kTile * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [2][kTile][kPitch]
  float* vs = ks + 2 * kBuf;                   // [2][kTile][kPitch]
  float* qs = vs + 2 * kBuf;                   // [kTile][kPitch]: the block's Q rows
  const int t = lay.t;
  const int side = lay.side;
  const int slab = blockIdx.x / q_tiles;
  const int b = slab / lay.heads;
  const int h = slab - b * lay.heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / kSplit;
  const int part = warp - group * kSplit;
  const int b0 = (blockIdx.x - slab * q_tiles) * kTile;
  const int r0 = b0 + group * 16;
  const int64_t ts = lay.in_t;
  const int64_t in_off = b * lay.in_b + static_cast<int64_t>(h) * HD;
  const float* qh = q + in_off;
  const float* kh = k + in_off;
  const float* vh = v + in_off;
  const int k_tiles = (t + kTile - 1) / kTile;

  stage_rows_f32<HD>(qs, qh + b0 * ts, ts, t - b0, kTile);
  stage_rows_f32<HD>(ks, kh, ts, t, kTile);
  stage_rows_f32<HD>(vs, vh, ts, t, kTile);
  const StagedQ<HD> qa{qs + (r0 - b0) * kPitch};

  RowBias rb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(r0 + (lane >> 2) + 8 * r, t - 1);  // a row past T reads the last row's, unused
    const int qy = div_side(row, lay.inv_side);
    const int qx = row - qy * side;
    const int64_t at = h * lay.tab_h + b * lay.tab_b + row * lay.tab_t + side - 1;
    rb.row[r] = ph + at + qy;
    rb.col[r] = pw + at + qx;
  }

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
        relpos_tile<false, HD>(acc, m, l, qa, ks + cur * kBuf, vs + cur * kBuf, part, j * kTile, rows, scale, rb,
                               side, lay.inv_side);
      } else {
        relpos_tile<true, HD>(acc, m, l, qa, ks + cur * kBuf, vs + cur * kBuf, part, j * kTile, rows, scale, rb,
                              side, lay.inv_side);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is staged again
  }
  float* red = reinterpret_cast<float*>(smem) + group * (16 * HD + 128);  // the staging is free now
  float* stat = red + 16 * HD;                                            // [m_a, m_b, l_a, l_b][32]
  if (part == 1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
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
    f1[r] = m1 == -INFINITY ? 0.f : expf(m1 - mn);
    l[r] = l[r] * f0[r] + stat[(2 + r) * 32 + lane] * f1[r];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * f0[e >> 1] + red[(n * 4 + e) * 32 + lane] * f1[e >> 1];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= l[e >> 1];
  }
  store_rows_f32<HD>(o + b * lay.out_b + static_cast<int64_t>(h) * HD, lay.out_t, r0, t, acc);
}

// Shared memory: K and V double-buffered and the block's Q rows.
template <int HD>
size_t smem_bytes() {
  return 5 * static_cast<size_t>(kTile) * (HD + 4) * sizeof(float);
}

template <int HD>
cudaError_t allow_smem() {
  const cudaError_t err = cudaFuncSetAttribute(relpos_attn_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes<HD>()));
  if (err != cudaSuccess) (void)cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* ph, const float* pw, float* o, int blocks,
           int q_tiles, const RelposLayout& lay, float scale, cudaStream_t s) {
  const cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_attn_f32<HD><<<blocks, kThreads, smem_bytes<HD>(), s>>>(q, k, v, ph, pw, o, lay, q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int blocks_per_sm(int* threads) {
  *threads = kThreads;
  cudaError_t err = allow_smem<HD>();
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, relpos_attn_f32<HD>, kThreads, smem_bytes<HD>());
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Calls fn<HD>(args...) for the runtime head dim (a multiple of 16 up to 128).
#define THEIA_RELPOS_BY_HD(fn, hd, ...)    \
  switch (hd) {                            \
    case 16: return fn<16>(__VA_ARGS__);   \
    case 32: return fn<32>(__VA_ARGS__);   \
    case 48: return fn<48>(__VA_ARGS__);   \
    case 64: return fn<64>(__VA_ARGS__);   \
    case 80: return fn<80>(__VA_ARGS__);   \
    case 96: return fn<96>(__VA_ARGS__);   \
    case 112: return fn<112>(__VA_ARGS__); \
    default: return fn<128>(__VA_ARGS__);  \
  }

}  // namespace

extern "C" {

// K12 over `batch` entries (windows included) of `heads` heads on a side x
// side grid (T = side^2). q, k, v: [batch, T, heads, hd] float32 with
// strides (in_b, in_t) in elements, unit stride over hd and heads hd apart
// (views into a packed QKV projection qualify); o: the same shape with
// (out_b, out_t). ph, pw: float32, the products of each query with each of
// the 2 side - 1 rows of rel_pos_h and rel_pos_w, the row of token r of
// head h of entry b at h * tab_h + b * tab_b + r * tab_t. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
int theia_relpos_attn(const float* q, const float* k, const float* v, const float* ph, const float* pw, float* o,
                      int batch, int heads, int side, int hd, int64_t in_b, int64_t in_t, int64_t out_b,
                      int64_t out_t, int64_t tab_h, int64_t tab_b, int64_t tab_t, float scale, void* stream) {
  const int64_t t = static_cast<int64_t>(side) * side;
  const int64_t strides[4] = {in_b, in_t, out_b, out_t};
  if (batch < 1 || heads < 1 || side < 1 || t >= (1 << 20) || hd < 16 || hd > kMaxHd || hd % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int64_t s : strides) {
    if (s < 0 || s % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows
  }
  if (tab_h < 0 || tab_b < 0 || tab_t < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = static_cast<int>((t + kTile - 1) / kTile);
  const int64_t blocks = static_cast<int64_t>(batch) * heads * q_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const RelposLayout lay{static_cast<int>(t), heads, side, 1.0f / static_cast<float>(side),
                         in_b, in_t, out_b, out_t, tab_h, tab_b, tab_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  THEIA_RELPOS_BY_HD(launch, hd, q, k, v, ph, pw, o, static_cast<int>(blocks), q_tiles, lay, scale, s)
}

// Resident blocks per SM of K12 at head dim hd, with the threads of one of
// its blocks in *threads; a negative cudaError_t if the query failed.
int theia_relpos_attn_blocks_per_sm(int hd, int* threads) {
  if (hd < 16 || hd > kMaxHd || hd % 16 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  THEIA_RELPOS_BY_HD(blocks_per_sm, hd, threads)
}

}  // extern "C"
