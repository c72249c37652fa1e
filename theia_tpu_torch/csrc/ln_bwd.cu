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
// is one contiguous run of N = S*C elements (S = H*W, C fastest). K3 reads
// w and writes dw, db in the parameter's own (C, H, W) layout (position
// fastest); K4 takes w as [S, C] float32. The kernels read the maps in
// place; they never form the [S, B, C] view the TPU kernel used for XLA's
// batch-minor layout. Any B, S and C: where C is a multiple of 8 a thread
// moves 8-element vectors (16 bytes of bf16, 32 of float32; the maps must
// then be 16-byte aligned), else one element (C = 60, 120 bytes a bf16 row,
// as the policy heads' LayerNorms have), with the same tiling and the same
// order of every sum. K4 takes 8-element vectors wherever a sample's N is a
// multiple of 8 and its pointers are 16-byte aligned, else one element.
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
// K4 (ln_bwd_dx) streams g, x and w once more, one vector of V elements a
// thread, grid-stride.

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[kVec]) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

// one element: the path for shapes whose rows are not whole 16-byte vectors
__device__ __forceinline__ void load1(const float* p, float (&out)[1]) { out[0] = *p; }
__device__ __forceinline__ void load1(const __nv_bfloat16* p, float (&out)[1]) { out[0] = __bfloat162float(*p); }

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

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) { store8(p, v); }
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[kVec]) { store8(p, v); }
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) { *p = __float2bfloat16_rn(v[0]); }

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

// K4. dx = r * (g*w - (s1 + xhat*s2) / count), one V-element vector a
// thread, grid-stride over [batch, n]; w: [n] (= [S, C]) float32. The
// kernel ln_bwd_dx takes V = 8, ln_bwd_dx_scalar 1.
template <typename T, int V>
__device__ __forceinline__ void dx_rows(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                                        const float* __restrict__ mean, const float* __restrict__ rstd,
                                        const float* __restrict__ s1, const float* __restrict__ s2, T* __restrict__ dx,
                                        int batch, int64_t n, float count) {
  const int64_t per_sample = n / V;
  const int64_t total = static_cast<int64_t>(batch) * per_sample;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int b = static_cast<int>(i / per_sample);
    const int64_t e = (i - b * per_sample) * V;
    const int64_t at = static_cast<int64_t>(b) * n + e;
    float gv[V], xv[V], wv[V], out[V];
    load_vec<V>(g + at, gv);
    load_vec<V>(x + at, xv);
    load_vec<V>(w + e, wv);
    const float m = mean[b];
    const float r = rstd[b];
    const float a = s1[b];
    const float c = s2[b];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (xv[k] - m) * r;
      out[k] = r * (gv[k] * wv[k] - (a + xh * c) / count);
    }
    store_vec(dx + at, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_dx(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ s1,
              const float* __restrict__ s2, T* __restrict__ dx, int batch, int64_t n, float count) {
  dx_rows<T, kVec>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_dx_scalar(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ s1,
                     const float* __restrict__ s2, T* __restrict__ dx, int batch, int64_t n, float count) {
  dx_rows<T, 1>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count);
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

template <typename T, int V>
int launch_dx_v(const void* g, const void* x, const float* w, const float* mean, const float* rstd, const float* s1,
                const float* s2, void* dx, int batch, int64_t n, int64_t count, cudaStream_t stream) {
  const int64_t vecs = static_cast<int64_t>(batch) * (n / V);
  const int64_t want = (vecs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (int64_t{1} << 30) ? want : (int64_t{1} << 30));
  auto kernel = V == kVec ? ln_bwd_dx<T> : ln_bwd_dx_scalar<T>;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(x), w, mean, rstd, s1, s2,
                                          static_cast<T*>(dx), batch, n, static_cast<float>(count));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K4 takes 8-element vectors where a sample is whole vectors and every
// pointer is 16-byte aligned, else one element a thread
template <typename T>
int launch_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd, const float* s1,
              const float* s2, void* dx, int batch, int64_t n, int64_t count, cudaStream_t stream) {
  if (n % kVec == 0 && aligned16(g) && aligned16(x) && aligned16(w) && aligned16(dx))
    return launch_dx_v<T, kVec>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count, stream);
  return launch_dx_v<T, 1>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count, stream);
}

bool bad_args(int batch, int64_t n, int64_t count, int dtype) {
  return batch < 1 || n < 1 || count < 1 || (dtype != 0 && dtype != 1);
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

// K4: dx [batch, n] in the dtype of g and x, from K3's s1 and s2; w: [n]
// (= [S, C]) float32; count: the normaliser N of the formula, n for a
// whole sample, more where the sample's channels are split over ranks and
// s1, s2 were summed over them. Any n; 16-byte loads where n is a
// multiple of 8 and the pointers are 16-byte aligned.
int theia_ln_bwd_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd,
                    const float* s1, const float* s2, void* dx, int batch, int64_t n, int64_t count, int dtype,
                    void* stream) {
  if (bad_args(batch, n, count, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count, s);
  return launch_dx<__nv_bfloat16>(g, x, w, mean, rstd, s1, s2, dx, batch, n, count, s);
}

}  // extern "C"
