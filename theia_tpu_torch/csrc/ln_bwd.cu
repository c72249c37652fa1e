// LayerNormSpatial backward for Hopper (sm_90a): the per-sample and
// per-position sums (K3) and dx (K4).
//
// Replaces theia_tpu/ops/ln_pallas.py::_stats_kernel and ::_dx_kernel
// (launched by _bwd_kernels, the backward of the ln_spatial_pallas
// custom_vjp). The forward normalised each sample over all of (H, W, C):
// xhat = (x - mean) * r with float32 mean and r = rsqrt(var + eps). Given
// the output gradient g and the affine weight w, the backward is
//   s1[b] = sum_e g*w,  s2[b] = sum_e g*w*xhat       (over e = (s, c))
//   dw[e] = sum_b g*xhat,  db[e] = sum_b g
//   dx = r * (g*w - (s1 + xhat*s2) / N),  N = H*W*C.
// All arithmetic is float32 in registers, as in ln_pallas._autodiff_bwd
// (the TPU kernel does its elementwise work in bf16; here it costs nothing,
// since the kernels are bound by device memory), and w is read in float32
// as _autodiff_bwd takes it (the TPU kernel rounds it to x's dtype first).
// dx is stored in x's dtype, dw and db in float32.
//
// Layout. The maps are NCHW tensors in channels_last memory, so a sample
// is one contiguous run of N = S*C elements (S = H*W, C fastest). Both
// kernels read w, and K3 writes dw, db, in the parameter's own (C, H, W)
// float32 layout (position fastest). The kernels read the maps in place;
// they never form the [S, B, C] view the TPU kernel used for XLA's
// batch-minor layout. Any B, S and C: where C is a multiple of 8 a thread
// moves 8-element vectors (16 bytes of bf16, 32 of float32; the maps must
// then be 16-byte aligned), else one element (C = 60, 120 bytes a bf16 row,
// as the policy heads' LayerNorms have), with the same tiling and the same
// order of every sum.
//
// What bounds them: device memory. At [16, 64, 64, 768] bf16, K3 must read
// g and x (201 MB) and w (12.6 MB) and write dw and db in float32 (25 MB),
// 71 us at 3.35 TB/s; K4 reads g, x, w and writes dx, 315 MB, 94 us. At the
// 16x16 sites (15 MB, 4.5 us) a launch's own cost is a large share, so K3
// is one launch: no copy of w, no finishing kernel, no memset.
//
// K3 (ln_bwd_stats_sm90). The TPU kernel walks a sequential grid over
// position chunks with all samples in a block and carries s1, s2 in VMEM
// scratch. Here a tile is P whole positions x up to 128 channels (P = 16
// at C = 768, 6 channel tiles): each of a block's 256 threads owns one
// vector of V channels of it (V = 8, or 1 where C is not a multiple of 8), and every tile is a block (96 at 16x16, 1,536 at
// 64x64), so the blocks' phases overlap on each SM.
//   - w's tile is staged through shared memory by 4-byte cp.async,
//     transposed to the maps' position-major order (pitch + 4 floats: no
//     bank conflicts), in flight with the first sample's loads.
//   - A thread walks the batch with the next THEIA_K3_SLOTS
//     samples' 16-byte loads of g and x in flight, keeps its vector's dw
//     and db partials in registers (64 a thread, 4 blocks a SM, no spills)
//     and reduces each sample's s1, s2 partials over its warp (shuffles)
//     into shared memory; every 32 samples the block adds them over its
//     warps, in order, into part[., b, tile].
//   - The dw, db sums go through shared memory and are stored transposed
//     (position fastest).
//   - Each block fences its part writes and takes a ticket on its group of
//     32 tiles; the last block of a group adds the group's columns of part
//     into the group's column and takes a ticket on the kernel's counter;
//     the last of those adds the groups' columns into s1 and s2 (with one
//     group, its last block adds them into s1 and s2 directly). Each
//     counter is reset to 0 by its last user.
// Every sum is taken in an order fixed by the shapes alone, so the
// results are bit-for-bit the same whichever block finishes last. The
// counters are one buffer per device and stream (ops/ln_pallas.py), so
// no two launches in flight share one; as they reset themselves, the
// launch can later be captured in a CUDA graph. The -D switches THEIA_K3_BLOCKS_PER_SM,
// THEIA_K3_SLOTS and THEIA_K3_TILE_C build the ablations that
// tools/time_ln_bwd.py times.
//
// K4 (ln_bwd_dx_sm90; replaces theia_tpu/ops/ln_pallas.py::_dx_kernel).
// dx is elementwise, so bytes bound it: g and x read, dx written, w read
// once (315 MB, 94 us at [16, 64, 64, 768] bf16; 839 MB, 250 us at 2048
// channels). The TPU kernel's block was [positions, all B, C] with w's
// chunk loaded once; here a block owns one of K3's tiles (16 positions x
// 128 channels at C = 768, one vector a thread) and walks the batch:
//   - w's tile is staged from its (C, H, W) layout through shared memory
//     by 4-byte cp.async, transposed as K3 stages it, and held in
//     registers across the samples: w is read once, not once a sample, and
//     the caller makes no [S, C] copy of it (one device operation a call).
//   - Each sample's mean, r, s1 and s2 are loaded once a block into shared
//     memory (32 samples at a time; the first 32 in flight with the first
//     samples' loads) and read as one float4; the per-sample and
//     per-element offsets are multiplications, never a 64-bit division.
//     A block of one sample keeps them in registers, and at S = 1 w is
//     read where it lies ((C, 1, 1) is [S, C]): no barrier on that path.
//   - The next THEIA_K4_SLOTS samples' 16-byte loads of g and x are in
//     flight while a sample computes; g, x are read and dx written with
//     evict-first hints (ld/st.global.cs): each of their bytes is touched
//     once, and w's tiles, which the blocks of a split batch read again,
//     keep their place in L2.
//   - The divide by N is a multiply by its reciprocal (1 ulp of the term;
//     THEIA_K4_DIV=1 divides).
//   - Where the tiles are fewer than THEIA_K4_SPLIT_TARGET a SM (96 at
//     16x16 and 768 channels), the grid's second dimension splits the
//     batch, so every SM holds blocks.
// Each dx element is computed by one thread from its own inputs, so the
// results do not depend on the tiling or the split and are the same on
// every call. The -D switches THEIA_K4_BLOCKS_PER_SM (and _F32_), THEIA_K4_SLOTS,
// THEIA_K4_SPLIT_TARGET, THEIA_K4_STREAMING and THEIA_K4_DIV build the
// ablations that tools/time_ln_bwd.py times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef THEIA_K3_BLOCKS_PER_SM
#define THEIA_K3_BLOCKS_PER_SM 4  // resident blocks a SM the registers are capped for (__launch_bounds__)
#endif
#ifndef THEIA_K3_SLOTS
#define THEIA_K3_SLOTS 1  // samples (1, 2 or 4) whose loads a thread keeps in flight while it adds one up
#endif
#ifndef THEIA_K3_TILE_C
#define THEIA_K3_TILE_C 128  // channels a tile at most; positions a tile = 256 threads / (channels / 8)
#endif
#ifndef THEIA_K4_BLOCKS_PER_SM
#define THEIA_K4_BLOCKS_PER_SM 4  // resident blocks a SM bf16 K4's registers are capped for (__launch_bounds__)
#endif
#ifndef THEIA_K4_F32_BLOCKS_PER_SM
#define THEIA_K4_F32_BLOCKS_PER_SM 3  // the same for float32 K4 (4 spills: its loads in flight take twice the registers)
#endif
#ifndef THEIA_K4_SLOTS
#define THEIA_K4_SLOTS 2  // samples (1, 2 or 4) whose loads of g and x a K4 thread keeps in flight
#endif
#ifndef THEIA_K4_SPLIT_TARGET
#define THEIA_K4_SPLIT_TARGET 2  // blocks a SM K4's grid reaches by splitting the batch where tiles are fewer (0: never)
#endif
#ifndef THEIA_K4_STREAMING
#define THEIA_K4_STREAMING 3  // evict-first (.cs): 1 g and x's reads, 2 dx's writes, 3 both, 0 neither
#endif
#ifndef THEIA_K4_DIV
#define THEIA_K4_DIV 0  // 1: divide by N as the plain version does; 0: multiply by its reciprocal
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // elements a thread on the vector path (the other path takes 1)

constexpr int kMinBlocks = THEIA_K3_BLOCKS_PER_SM;
constexpr int kBatchChunk = 32;  // samples whose s1, s2 partials a block holds between two flushes
constexpr int kSlots = THEIA_K3_SLOTS;
static_assert(kSlots == 1 || kSlots == 2 || kSlots == 4, "a chunk of samples is whole rounds of the slots");
constexpr int kGroup = 32;       // tiles whose s1, s2 partials the last of their blocks adds up
constexpr int kMaxTiles = 65535;  // tiles a launch at most, which sizes the counter
constexpr int kCounterWords = 1 + (kMaxTiles + kGroup - 1) / kGroup;
constexpr int kTileC = THEIA_K3_TILE_C;
static_assert(kTileC % kVec == 0 && kTileC / kVec <= kThreads, "a tile's position is whole vectors, one a thread");
template <typename T>
constexpr int dx_min_blocks() {
  return sizeof(T) == 4 ? THEIA_K4_F32_BLOCKS_PER_SM : THEIA_K4_BLOCKS_PER_SM;
}
constexpr int kDxSlots = THEIA_K4_SLOTS;
static_assert(kDxSlots == 1 || kDxSlots == 2 || kDxSlots == 4, "a chunk of samples is whole rounds of the slots");

__device__ __forceinline__ void load8(const float* p, float (&out)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void unpack8(const uint4 u, float (&out)[kVec]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// one element: the path for shapes whose rows are not whole 16-byte vectors
__device__ __forceinline__ void load1(const float* p, float (&out)[1]) { out[0] = *p; }

// V elements from p (V = 8: a 16-byte aligned vector)
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == kVec) {
    load8(p, out);
  } else {
    static_assert(V == 1, "a thread takes 8 elements or 1");
    load1(p, out);
  }
}

// V elements of a map as they arrive from memory, held until used
template <typename T, int V>
struct Raw;
template <>
struct Raw<__nv_bfloat16, kVec> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void unpack(float (&out)[kVec]) const { unpack8(u, out); }
};
template <>
struct Raw<float, kVec> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float (&out)[kVec]) const {
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
};
template <>
struct Raw<__nv_bfloat16, 1> {
  unsigned short u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = __ldg(reinterpret_cast<const unsigned short*>(p)); }
  __device__ __forceinline__ void unpack(float (&out)[1]) const { out[0] = __bfloat162float(__ushort_as_bfloat16(u)); }
};
template <>
struct Raw<float, 1> {
  float a;
  __device__ __forceinline__ void load(const float* p) { a = __ldg(p); }
  __device__ __forceinline__ void unpack(float (&out)[1]) const { out[0] = a; }
};

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) { store8(p, v); }
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }

// K4's reads of g and x and its writes of dx, which nothing in the kernel
// touches again: evict-first (.cs) as THEIA_K4_STREAMING says
template <typename U>
__device__ __forceinline__ U ld_stream(const U* p) {
#if THEIA_K4_STREAMING & 1
  return __ldcs(p);
#else
  return __ldg(p);
#endif
}

template <typename U>
__device__ __forceinline__ void st_stream(U* p, U v) {
#if THEIA_K4_STREAMING & 2
  __stcs(p, v);
#else
  *p = v;
#endif
}

// V elements of a map as they arrive from memory (Raw's registers, loaded by ld_stream)
template <typename T, int V>
struct Streamed;
template <>
struct Streamed<__nv_bfloat16, kVec> : Raw<__nv_bfloat16, kVec> {
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = ld_stream(reinterpret_cast<const uint4*>(p)); }
};
template <>
struct Streamed<float, kVec> : Raw<float, kVec> {
  __device__ __forceinline__ void load(const float* p) {
    a = ld_stream(reinterpret_cast<const float4*>(p));
    b = ld_stream(reinterpret_cast<const float4*>(p) + 1);
  }
};
template <>
struct Streamed<__nv_bfloat16, 1> : Raw<__nv_bfloat16, 1> {
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = ld_stream(reinterpret_cast<const unsigned short*>(p));
  }
};
template <>
struct Streamed<float, 1> : Raw<float, 1> {
  __device__ __forceinline__ void load(const float* p) { a = ld_stream(p); }
};

__device__ __forceinline__ void store_stream(float* p, const float (&v)[kVec]) {
  st_stream(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  st_stream(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  st_stream(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void store_stream(float* p, const float (&v)[1]) { st_stream(p, v[0]); }

__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const float (&v)[1]) {
  st_stream(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
}

// 4 bytes from device memory into shared memory, in flight until
// cp_async_wait_all (no register holds it)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K3's tiling of s positions x c channels, v channels a thread
struct StatsTiles {
  int cvecs;   // v-channel vectors of a tile's position
  int p;       // positions a tile
  int ctiles;  // tiles across the channels
  int tiles;
};

// the channels a thread takes: 8 where a position's channels are whole 8-vectors, else 1
__host__ __device__ inline int stats_vec(int c) { return c % kVec == 0 ? kVec : 1; }

// the channels of a tile at v channels a thread: one element a thread
// leaves at most kThreads
__host__ __device__ constexpr int tile_channels(int v) { return v == kVec || kTileC <= kThreads ? kTileC : kThreads; }

// the tiling at V channels a thread (V a compile-time constant in the
// kernels, so the vector path's arithmetic is that of a kernel for V = 8 alone)
template <int V>
__host__ __device__ inline StatsTiles stats_tiles_for(int s, int c) {
  constexpr int tc = tile_channels(V);
  StatsTiles t;
  t.cvecs = (c < tc ? c : tc) / V;
  t.p = kThreads / t.cvecs;
  t.ctiles = (c + tc - 1) / tc;
  t.tiles = ((s + t.p - 1) / t.p) * t.ctiles;
  return t;
}

__host__ __device__ inline StatsTiles stats_tiles(int s, int c) {
  return stats_vec(c) == kVec ? stats_tiles_for<kVec>(s, c) : stats_tiles_for<1>(s, c);
}

// K3's dynamic shared memory for tiles of cvecs vectors of v channels: w's
// tile and the dw, db sums ([p] rows of the tile's width + 4 floats each)
// and the per-sample s1, s2 partials of each warp ([2][kBatchChunk][kWarps]).
__host__ __device__ constexpr size_t stats_smem(int cvecs, int v) {
  return (3 * static_cast<size_t>(kThreads / cvecs) * (cvecs * v + 4) + 2 * kBatchChunk * kWarps) * sizeof(float);
}
// largest at one vector a position (256 positions a tile)
static_assert(stats_smem(1, kVec) <= 48 * 1024 && stats_smem(1, 1) <= 48 * 1024,
              "K3 launches within the default dynamic shared memory");

// dst[row * dst_pitch] = the sum of src[row * pitch + col0 + k] over k <
// ncols, for every row < rows: tpr threads a row (a power of 2 within a
// warp) over the columns in a fixed order, then a shuffle tree. Reads with
// __ldcg: other blocks wrote src during this launch.
__device__ __forceinline__ void sum_rows(const float* src, int pitch, int col0, int ncols, int rows, float* dst,
                                         int dst_pitch) {
  int tpr = 32;
  while (tpr > 1 && tpr * rows > kThreads) tpr >>= 1;
  const int sub = threadIdx.x & (tpr - 1);
  for (int row0 = 0; row0 < rows; row0 += kThreads / tpr) {
    const int row = row0 + static_cast<int>(threadIdx.x) / tpr;
    float a = 0.f;
    if (row < rows) {
      const float* r = src + static_cast<int64_t>(row) * pitch + col0;
#pragma unroll 4
      for (int k = sub; k < ncols; k += tpr) a += __ldcg(r + k);
    }
    for (int off = tpr / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (sub == 0 && row < rows) dst[static_cast<int64_t>(row) * dst_pitch] = a;
  }
}

// dw, db of a tile's cv channels from sdw, sdb ([p][pitch],
// position-major), stored position fastest: consecutive threads take
// consecutive positions of one channel.
__device__ __forceinline__ void store_tile(const float* sdw, const float* sdb, float* __restrict__ dw,
                                           float* __restrict__ db, int cv, int pitch, int pv, int s, int s0,
                                           int c0) {
  for (int e = threadIdx.x; e < cv * pv; e += kThreads) {
    const int ch = e / pv;
    const int p = e - ch * pv;
    const int64_t o = static_cast<int64_t>(c0 + ch) * s + s0 + p;
    dw[o] = sdw[p * pitch + ch];
    db[o] = sdb[p * pitch + ch];
  }
}

// K3. g, x: [batch, s, c] (c fastest); w, dw, db: [c, s] float32; mean,
// rstd: [batch]; part: [2, batch, tiles + groups] scratch (the blocks' s1,
// s2 partials, then their groups'); counter: kCounterWords words, 0
// between launches; sums: [2, batch] (s1, then s2). One block a tile, V
// channels a thread (V = stats_vec(c)): the kernel ln_bwd_stats_sm90 takes
// 8, ln_bwd_stats_scalar 1.
template <typename T, int V>
__device__ __forceinline__ void stats_tile(const T* __restrict__ g, const T* __restrict__ x,
                                           const float* __restrict__ w, const float* __restrict__ mean,
                                           const float* __restrict__ rstd, float* __restrict__ part,
                                           unsigned int* __restrict__ counter, float* __restrict__ sums,
                                           float* __restrict__ dw, float* __restrict__ db, int batch, int s, int c) {
  extern __shared__ float4 smem4[];
  __shared__ bool last_block;
  float* smem = reinterpret_cast<float*>(smem4);
  const StatsTiles tiling = stats_tiles_for<V>(s, c);
  const int pitch = tiling.cvecs * V + 4;
  float* ws = smem;  // [p][pitch]: w of the tile, position-major
  float* sdw = ws + tiling.p * pitch;  // the tile's dw, db sums
  float* sdb = sdw + tiling.p * pitch;
  float* red1 = sdb + tiling.p * pitch;  // [kBatchChunk][kWarps]
  float* red2 = red1 + kBatchChunk * kWarps;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int tile = blockIdx.x;
  const int s0 = (tile / tiling.ctiles) * tiling.p;
  const int c0 = (tile % tiling.ctiles) * tile_channels(V);
  const int pv = min(tiling.p, s - s0);          // positions of this tile
  const int cv = min(tile_channels(V), c - c0);  // channels of this tile
  const int tp = t / tiling.cvecs;       // this thread's position and vector in the tile
  const int tq = t - tp * tiling.cvecs;
  const bool valid = tp < pv && tq * V < cv;
  const int soff = tp * pitch + tq * V;
  const int64_t step = static_cast<int64_t>(s) * c;  // a sample
  const T* gt = g + (s0 + tp) * c + c0 + tq * V;
  const T* xt = x + (gt - g);
  const int groups = (gridDim.x + kGroup - 1) / kGroup;
  const int part_pitch = gridDim.x + groups;

  // w's tile, transposed into position-major order by 4-byte copies in
  // flight with the first sample's loads
  for (int e = t; e < cv * pv; e += kThreads) {
    const int ch = e / pv;  // consecutive threads: consecutive positions of one channel
    const int p = e - ch * pv;
    cp_async4(ws + p * pitch + ch, w + static_cast<int64_t>(c0 + ch) * s + s0 + p);
  }
  float wv[V], dwa[V], dba[V];
#pragma unroll
  for (int e = 0; e < V; ++e) wv[e] = dwa[e] = dba[e] = 0.f;
  Raw<T, V> gr[kSlots], xr[kSlots];  // the loads of samples j, j + 1, ... in flight
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (valid && d < batch) {
      gr[d].load(gt + d * step);
      xr[d].load(xt + d * step);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (valid) load_vec<V>(ws + soff, wv);

  for (int j0 = 0; j0 < batch; j0 += kBatchChunk) {
    const int nj = min(kBatchChunk, batch - j0);
    for (int jr = 0; jr < nj; jr += kSlots) {
#pragma unroll
      for (int d = 0; d < kSlots; ++d) {  // sample j sits in slot j % kSlots = d
        const int jj = jr + d;
        if (jj >= nj) break;
        const int j = j0 + jj;
        const float m = __ldg(mean + j);
        const float r = __ldg(rstd + j);
        float p1 = 0.f, p2 = 0.f;
        if (valid) {
          float gv[V], xv[V];
          gr[d].unpack(gv);
          xr[d].unpack(xv);
          if (j + kSlots < batch) {
            gr[d].load(gt + (j + kSlots) * step);
            xr[d].load(xt + (j + kSlots) * step);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh = (xv[e] - m) * r;
            const float gw = gv[e] * wv[e];
            p1 += gw;
            p2 += gw * xh;
            dwa[e] += gv[e] * xh;
            dba[e] += gv[e];
          }
        }
        p1 = warp_sum(p1);
        p2 = warp_sum(p2);
        if (lane == 0) {
          red1[jj * kWarps + warp] = p1;
          red2[jj * kWarps + warp] = p2;
        }
      }
    }
    __syncthreads();
    // this block's s1, s2 partials of the chunk's samples, the warps in order
    if (t < nj) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        a1 += red1[t * kWarps + q];
        a2 += red2[t * kWarps + q];
      }
      const int b = j0 + t;
      part[static_cast<int64_t>(b) * part_pitch + tile] = a1;
      part[static_cast<int64_t>(batch + b) * part_pitch + tile] = a2;
      __threadfence();
    }
    __syncthreads();  // red1, red2 are refilled by the next chunk
  }
  // this block's ticket on its group of kGroup tiles, in flight while it stores dw, db
  const int group = tile / kGroup;
  const int group_tiles = min(kGroup, static_cast<int>(gridDim.x) - group * kGroup);
  unsigned int ticket = 0;
  if (t == 0) ticket = atomicAdd(counter + 1 + group, 1u);

  // dw, db through shared memory, stored position fastest
  if (valid) {
    store_vec(sdw + soff, dwa);
    store_vec(sdb + soff, dba);
  }
  __syncthreads();
  store_tile(sdw, sdb, dw, db, cv, pitch, pv, s, s0, c0);

  // s1, s2 in two levels, so the last block to finish adds few numbers:
  // the last block of each group of kGroup tiles adds the group's columns
  // of part into the group's column (into sums where there is one group),
  // and the last of those adds the groups' columns into sums; each counter
  // is reset by its last user
  if (t == 0) last_block = ticket == static_cast<unsigned int>(group_tiles - 1);
  __syncthreads();
  if (last_block && groups == 1) {
    __threadfence();
    sum_rows(part, part_pitch, 0, group_tiles, 2 * batch, sums, 1);
    if (t == 0) counter[1] = 0u;  // ready for the next launch on the stream
  } else if (last_block) {
    __threadfence();
    sum_rows(part, part_pitch, group * kGroup, group_tiles, 2 * batch, part + gridDim.x + group, part_pitch);
    __threadfence();
    __syncthreads();  // every thread has read last_block and written its rows
    if (t == 0) {
      counter[1 + group] = 0u;
      last_block = atomicAdd(counter, 1u) == static_cast<unsigned int>(groups - 1);
    }
    __syncthreads();
    if (last_block) {
      __threadfence();
      sum_rows(part + gridDim.x, part_pitch, 0, groups, 2 * batch, sums, 1);
      if (t == 0) *counter = 0u;  // ready for the next launch on the stream
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ln_bwd_stats_sm90(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ mean, const float* __restrict__ rstd, float* __restrict__ part,
                      unsigned int* __restrict__ counter, float* __restrict__ sums, float* __restrict__ dw,
                      float* __restrict__ db, int batch, int s, int c) {
  stats_tile<T, kVec>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ln_bwd_stats_scalar(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ mean, const float* __restrict__ rstd, float* __restrict__ part,
                        unsigned int* __restrict__ counter, float* __restrict__ sums, float* __restrict__ dw,
                        float* __restrict__ db, int batch, int s, int c) {
  stats_tile<T, 1>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c);
}

// K4's dynamic shared memory for tiles of cvecs vectors of v channels: the
// per-sample mean, r, s1, s2 of kBatchChunk samples, then w's tile ([p]
// rows of the tile's width + 4 floats each, as K3 stages it)
__host__ __device__ constexpr size_t dx_smem(int cvecs, int v) {
  return kBatchChunk * sizeof(float4) + static_cast<size_t>(kThreads / cvecs) * (cvecs * v + 4) * sizeof(float);
}
static_assert(dx_smem(1, kVec) <= 48 * 1024 && dx_smem(1, 1) <= 48 * 1024,
              "K4 launches within the default dynamic shared memory");

// K4. g, x, dx: [batch, s, c] (c fastest); w: [c, s] float32; mean, rstd,
// s1, s2: [batch]. dx = r * (g*w - (s1 + xhat*s2) / count). One block a
// K3 tile (blockIdx.x) and a run of `per` samples (blockIdx.y), V
// channels a thread (V = stats_vec(c), or 1 where the maps are not 16-byte
// aligned): the kernel ln_bwd_dx_sm90 takes 8, ln_bwd_dx_scalar 1.
template <typename T, int V>
__device__ __forceinline__ void dx_tile(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                                        const float* __restrict__ mean, const float* __restrict__ rstd,
                                        const float* __restrict__ s1, const float* __restrict__ s2, T* __restrict__ dx,
                                        int batch, int s, int c, int per, float count) {
  extern __shared__ float4 smem4[];
  float4* consts = smem4;  // [kBatchChunk]: mean, r, s1, s2 of a chunk's samples
  float* ws = reinterpret_cast<float*>(smem4 + kBatchChunk);  // [p][pitch]: w of the tile, position-major
  const StatsTiles tiling = stats_tiles_for<V>(s, c);
  const int pitch = tiling.cvecs * V + 4;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int s0 = (tile / tiling.ctiles) * tiling.p;
  const int c0 = (tile % tiling.ctiles) * tile_channels(V);
  const int pv = min(tiling.p, s - s0);          // positions of this tile
  const int cv = min(tile_channels(V), c - c0);  // channels of this tile
  const int tp = t / tiling.cvecs;               // this thread's position and vector in the tile
  const int tq = t - tp * tiling.cvecs;
  const bool valid = tp < pv && tq * V < cv;
  const int b0 = blockIdx.y * per;     // this block's samples: b0 .. b0 + nb - 1
  const int nb = min(per, batch - b0);
  const int64_t step = static_cast<int64_t>(s) * c;  // a sample
  const int64_t at = b0 * step + static_cast<int64_t>(s0 + tp) * c + c0 + tq * V;
  const T* gt = g + at;
  const T* xt = x + at;
  T* dt = dx + at;
#if THEIA_K4_DIV
  const float scale = count;
#else
  const float scale = __frcp_rn(count);
#endif
  // a block of one sample keeps its constants in registers (every thread
  // loads them), and at S = 1 w's (C, 1, 1) tile is contiguous and is read
  // where it lies: a one-sample block of a 1x1 map has no barrier
  const bool one = nb == 1;
  const bool direct = s == 1;

  // w's tile, transposed into position-major order by 4-byte copies in
  // flight with the first samples' loads
  if (!direct) {
    for (int e = t; e < cv * pv; e += kThreads) {
      const int ch = e / pv;  // consecutive threads: consecutive positions of one channel
      const int p = e - ch * pv;
      cp_async4(ws + p * pitch + ch, w + static_cast<int64_t>(c0 + ch) * s + s0 + p);
    }
  }
  Streamed<T, V> gr[kDxSlots], xr[kDxSlots];  // the loads of samples j, j + 1, ... in flight
#pragma unroll
  for (int d = 0; d < kDxSlots; ++d) {
    if (valid && d < nb) {
      gr[d].load(gt + d * step);
      xr[d].load(xt + d * step);
    }
  }
  // the first chunk's constants, in flight with the loads above
  float4 kc;
  if (one || t < min(kBatchChunk, nb)) {
    const int b = one ? b0 : b0 + t;
    kc = make_float4(__ldg(mean + b), __ldg(rstd + b), __ldg(s1 + b), __ldg(s2 + b));
  }
  float wv[V];
  if (direct && valid) {
#pragma unroll
    for (int e = 0; e < V; ++e) wv[e] = __ldg(w + c0 + tq * V + e);
  }
  cp_async_wait_all();
  for (int j0 = 0; j0 < nb; j0 += kBatchChunk) {
    const int nj = min(kBatchChunk, nb - j0);
    if (j0) {
      __syncthreads();  // every thread has read the previous chunk's constants
      const int b = b0 + j0 + t;
      if (t < nj) kc = make_float4(__ldg(mean + b), __ldg(rstd + b), __ldg(s1 + b), __ldg(s2 + b));
    }
    if (!one && t < nj) consts[t] = kc;
    if (!(one && direct)) __syncthreads();
    if (j0 == 0 && valid && !direct) load_vec<V>(ws + tp * pitch + tq * V, wv);
    for (int jr = 0; jr < nj; jr += kDxSlots) {
#pragma unroll
      for (int d = 0; d < kDxSlots; ++d) {  // sample j sits in slot j % kDxSlots = d
        const int jj = jr + d;
        if (jj >= nj) break;
        const int j = j0 + jj;
        if (!valid) continue;
        const float4 k = one ? kc : consts[jj];  // mean, r, s1, s2
        float gv[V], xv[V], out[V];
        gr[d].unpack(gv);
        xr[d].unpack(xv);
        if (j + kDxSlots < nb) {
          gr[d].load(gt + (j + kDxSlots) * step);
          xr[d].load(xt + (j + kDxSlots) * step);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (xv[e] - k.x) * k.y;
#if THEIA_K4_DIV
          out[e] = k.y * (gv[e] * wv[e] - (k.z + xh * k.w) / scale);
#else
          out[e] = k.y * (gv[e] * wv[e] - (k.z + xh * k.w) * scale);
#endif
        }
        store_stream(dt + j * step, out);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, dx_min_blocks<T>())
    ln_bwd_dx_sm90(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ s1,
                   const float* __restrict__ s2, T* __restrict__ dx, int batch, int s, int c, int per, float count) {
  dx_tile<T, kVec>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, per, count);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, dx_min_blocks<T>())
    ln_bwd_dx_scalar(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ s1,
                     const float* __restrict__ s2, T* __restrict__ dx, int batch, int s, int c, int per, float count) {
  dx_tile<T, 1>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, per, count);
}

template <typename T, int V>
int launch_stats_v(const void* g, const void* x, const float* w, const float* mean, const float* rstd, float* part,
                   unsigned int* counter, float* sums, float* dw, float* db, int batch, int s, int c,
                   cudaStream_t stream) {
  const StatsTiles t = stats_tiles(s, c);
  auto kernel = V == kVec ? ln_bwd_stats_sm90<T> : ln_bwd_stats_scalar<T>;
  kernel<<<t.tiles, kThreads, stats_smem(t.cvecs, V), stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), w, mean, rstd, part, counter, sums, dw, db, batch, s, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stats(const void* g, const void* x, const float* w, const float* mean, const float* rstd, float* part,
                 unsigned int* counter, float* sums, float* dw, float* db, int batch, int s, int c,
                 cudaStream_t stream) {
  if (stats_vec(c) == kVec)
    return launch_stats_v<T, kVec>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c, stream);
  return launch_stats_v<T, 1>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K4's grid: one block a tile (x) times runs of `per` samples (y), the
// batch split where the tiles alone would leave fewer than
// THEIA_K4_SPLIT_TARGET blocks a SM of the current device
struct DxGrid {
  int tiles;
  int splits;
  int per;
};

DxGrid dx_grid(int batch, int s, int c, bool vec) {
  DxGrid d;
  d.tiles = (vec ? stats_tiles_for<kVec>(s, c) : stats_tiles_for<1>(s, c)).tiles;
  int want = 1;
  int dev = 0, sms = 0;
  if (THEIA_K4_SPLIT_TARGET > 0 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    want = (THEIA_K4_SPLIT_TARGET * sms + d.tiles - 1) / d.tiles;
  want = want < 1 ? 1 : (want > batch ? batch : want);
  d.per = (batch + want - 1) / want;
  d.splits = (batch + d.per - 1) / d.per;
  return d;
}

template <typename T, int V>
int launch_dx_v(const void* g, const void* x, const float* w, const float* mean, const float* rstd, const float* s1,
                const float* s2, void* dx, int batch, int s, int c, int64_t count, cudaStream_t stream) {
  const DxGrid d = dx_grid(batch, s, c, V == kVec);
  auto kernel = V == kVec ? ln_bwd_dx_sm90<T> : ln_bwd_dx_scalar<T>;
  kernel<<<dim3(d.tiles, d.splits), kThreads, dx_smem(stats_tiles_for<V>(s, c).cvecs, V), stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), w, mean, rstd, s1, s2, static_cast<T*>(dx), batch, s, c,
      d.per, static_cast<float>(count));
  return static_cast<int>(cudaGetLastError());
}

// K4 takes 8-element vectors where C is whole vectors and the maps are
// 16-byte aligned, else one element a thread
template <typename T>
int launch_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd, const float* s1,
              const float* s2, void* dx, int batch, int s, int c, int64_t count, cudaStream_t stream) {
  if (stats_vec(c) == kVec && aligned16(g) && aligned16(x) && aligned16(dx))
    return launch_dx_v<T, kVec>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, count, stream);
  return launch_dx_v<T, 1>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, count, stream);
}

bool bad_dx_args(int batch, int s, int c, int64_t count, int dtype) {
  return batch < 1 || s < 1 || c < 1 || count < 1 || (dtype != 0 && dtype != 1) ||
         static_cast<int64_t>(s) * c > 0x7fffffff;
}

bool bad_stats_args(int batch, int s, int c, int dtype) {
  return batch < 1 || s < 1 || c < 1 || (dtype != 0 && dtype != 1) ||
         static_cast<int64_t>(s) * c > 0x7fffffff || stats_tiles(s, c).tiles > kMaxTiles;
}

// the vector path of K3 reads g and x by 16-byte loads
bool misaligned_stats(const void* g, const void* x, int c) {
  return stats_vec(c) == kVec && !(aligned16(g) && aligned16(x));
}

}  // namespace

extern "C" {

// The width of K3's part scratch ([2, batch, width] float32) for batch
// samples of s positions and c channels.
int theia_ln_bwd_stats_parts(int batch, int s, int c) {
  if (bad_stats_args(batch, s, c, 0)) return -static_cast<int>(cudaErrorInvalidValue);
  const int tiles = stats_tiles(s, c).tiles;
  return tiles + (tiles + kGroup - 1) / kGroup;
}

// The words of K3's counter.
int theia_ln_bwd_stats_counter_words() { return kCounterWords; }

// K3, one launch. g, x: [batch, s, c] of dtype (0 = float32, 1 =
// bfloat16), 16-byte aligned where c is a multiple of 8; w, dw, db: (c, s) float32; mean, rstd: [batch]
// float32; part: [2, batch, theia_ln_bwd_stats_parts] float32 scratch;
// counter: theia_ln_bwd_stats_counter_words unsigned words, 0 before the
// first launch (each launch leaves them 0); sums: [2, batch] float32, s1
// then s2. Launches that share a counter
// must share a stream. Returns the launch's cudaError_t on `stream` (0 on
// success).
int theia_ln_bwd_stats(const void* g, const void* x, const float* w, const float* mean, const float* rstd,
                       float* part, unsigned int* counter, float* sums, float* dw, float* db, int batch, int s, int c,
                       int dtype, void* stream) {
  if (bad_stats_args(batch, s, c, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned_stats(g, x, c)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stats<float>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c, st);
  return launch_stats<__nv_bfloat16>(g, x, w, mean, rstd, part, counter, sums, dw, db, batch, s, c, st);
}

// K3's occupancy for s positions and c channels in dtype: resident
// blocks a SM (the return value), the threads of a block and the grid's
// blocks.
int theia_ln_bwd_stats_blocks_per_sm(int s, int c, int dtype, int* threads, int* blocks) {
  if (bad_stats_args(1, s, c, dtype)) return -static_cast<int>(cudaErrorInvalidValue);
  const StatsTiles t = stats_tiles(s, c);
  const bool vec = stats_vec(c) == kVec;
  const size_t smem = stats_smem(t.cvecs, stats_vec(c));
  int resident = 0;
  cudaError_t err;
  if (dtype == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, vec ? ln_bwd_stats_sm90<float> : ln_bwd_stats_scalar<float>, kThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, vec ? ln_bwd_stats_sm90<__nv_bfloat16> : ln_bwd_stats_scalar<__nv_bfloat16>, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *threads = kThreads;
  *blocks = t.tiles;
  return resident;
}

// K4: dx [batch, s, c] in the dtype of g and x (0 = float32, 1 =
// bfloat16), from K3's s1 and s2; w: (c, s) float32, the parameter's own
// layout (4-byte aligned; no copy); mean, rstd, s1, s2: [batch] float32;
// count: the normaliser N of the formula, s * c for a whole sample, more
// where the sample's channels are split over ranks and s1, s2 were summed
// over them. Any batch, s and c; 16-byte loads where c is a multiple of 8
// and g, x and dx are 16-byte aligned. Returns the launch's cudaError_t on
// `stream` (0 on success).
int theia_ln_bwd_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd,
                    const float* s1, const float* s2, void* dx, int batch, int s, int c, int64_t count, int dtype,
                    void* stream) {
  if (bad_dx_args(batch, s, c, count, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, count, st);
  return launch_dx<__nv_bfloat16>(g, x, w, mean, rstd, s1, s2, dx, batch, s, c, count, st);
}

// K4's occupancy for batch samples of s positions and c channels in dtype
// (16-byte aligned maps): resident blocks a SM (the return value), the
// threads of a block and the grid's blocks (tiles x batch splits).
int theia_ln_bwd_dx_blocks_per_sm(int batch, int s, int c, int dtype, int* threads, int* blocks) {
  if (bad_dx_args(batch, s, c, 1, dtype)) return -static_cast<int>(cudaErrorInvalidValue);
  const bool vec = stats_vec(c) == kVec;
  const DxGrid d = dx_grid(batch, s, c, vec);
  const size_t smem = dx_smem(stats_tiles(s, c).cvecs, stats_vec(c));
  int resident = 0;
  cudaError_t err;
  if (dtype == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, vec ? ln_bwd_dx_sm90<float> : ln_bwd_dx_scalar<float>, kThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, vec ? ln_bwd_dx_sm90<__nv_bfloat16> : ln_bwd_dx_scalar<__nv_bfloat16>, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *threads = kThreads;
  *blocks = d.tiles * d.splits;
  return resident;
}

}  // extern "C"
