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
// is one contiguous run of N = S*C elements (S = H*W, C fastest), and w is
// handed over as [S, C] float32. The kernels read the maps in place;
// they never form the [S, B, C] view the TPU kernel used for XLA's
// batch-minor layout. Since s1, s2 sum over all (s, c) and dw, db are per
// (s, c), a block owns a contiguous range of e, whatever the position
// boundaries: any B, S and C with C a multiple of 8.
//
// What bounds it: device memory. At [16, 64, 64, 768] bf16, K3 must read
// g and x (201 MB) and w (12.6 MB) and write dw and db in float32 (25 MB),
// 71 us at 3.35 TB/s; K4 reads g, x, w and writes dx, 315 MB, 94 us.
//
// Carried state. The TPU kernel carries s1 and s2 across its sequential
// grid in VMEM scratch; Hopper blocks run in parallel and in no order. K3
// (ln_bwd_stats): each block owns 2048 elements of e (8 a thread, 16-byte
// loads), keeps their dw and db in registers while it loops over the
// batch, and finishes them; for each sample it reduces its partial s1, s2
// (warp shuffles, then shared memory) and writes them to a [B, blocks]
// float32 scratch. A second small kernel (ln_bwd_finish, one block a
// sample) adds each sample's partials in a fixed order, so s1 and s2 are
// deterministic. K4 (ln_bwd_dx) then streams g, x and w once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                          // elements a thread
constexpr int kElemsPerBlock = kThreads * kVec;  // K3's range of e a block
constexpr int kBatchChunk = 32;                  // samples reduced between two barriers

__device__ __forceinline__ void load8(const float* p, float (&out)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

int partial_blocks(int64_t n) { return static_cast<int>((n + kElemsPerBlock - 1) / kElemsPerBlock); }

// K3. g, x: [batch, n]; w: [n]; mean, rstd: [batch]; part1, part2:
// [batch, gridDim.x]; dw, db: [n] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_stats(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ mean, const float* __restrict__ rstd, float* __restrict__ part1,
                 float* __restrict__ part2, float* __restrict__ dw, float* __restrict__ db, int batch,
                 int64_t n) {
  __shared__ float red1[kWarps][kBatchChunk];
  __shared__ float red2[kWarps][kBatchChunk];
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const bool active = e < n;  // n is a multiple of kVec
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float wv[kVec], dwa[kVec], dba[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) wv[i] = dwa[i] = dba[i] = 0.f;
  if (active) load8(w + e, wv);

  for (int b0 = 0; b0 < batch; b0 += kBatchChunk) {
    const int nb = min(kBatchChunk, batch - b0);
    for (int bb = 0; bb < nb; ++bb) {
      const int b = b0 + bb;
      float p1 = 0.f, p2 = 0.f;
      if (active) {
        float gv[kVec], xv[kVec];
        load8(g + static_cast<int64_t>(b) * n + e, gv);
        load8(x + static_cast<int64_t>(b) * n + e, xv);
        const float m = mean[b];
        const float r = rstd[b];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xh = (xv[i] - m) * r;
          const float gw = gv[i] * wv[i];
          p1 += gw;
          p2 += gw * xh;
          dwa[i] += gv[i] * xh;
          dba[i] += gv[i];
        }
      }
      p1 = warp_sum(p1);
      p2 = warp_sum(p2);
      if (lane == 0) {
        red1[warp][bb] = p1;
        red2[warp][bb] = p2;
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        s1 += red1[k][threadIdx.x];
        s2 += red2[k][threadIdx.x];
      }
      const int64_t at = static_cast<int64_t>(b0 + threadIdx.x) * gridDim.x + blockIdx.x;
      part1[at] = s1;
      part2[at] = s2;
    }
    __syncthreads();  // red1/red2 are refilled by the next chunk
  }
  if (active) {
    store8(dw + e, dwa);
    store8(db + e, dba);
  }
}

// The second step of K3: s1[b], s2[b] = the sums of row b of part1, part2
// ([batch, blocks]), always in the same order. One block a sample.
__global__ void __launch_bounds__(kThreads)
    ln_bwd_finish(const float* __restrict__ part1, const float* __restrict__ part2, float* __restrict__ s1,
                  float* __restrict__ s2, int blocks) {
  __shared__ float red1[kWarps];
  __shared__ float red2[kWarps];
  const int b = blockIdx.x;
  float a1 = 0.f, a2 = 0.f;
  for (int k = threadIdx.x; k < blocks; k += kThreads) {
    a1 += part1[static_cast<int64_t>(b) * blocks + k];
    a2 += part2[static_cast<int64_t>(b) * blocks + k];
  }
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red1[warp] = a1;
    red2[warp] = a2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      t1 += red1[k];
      t2 += red2[k];
    }
    s1[b] = t1;
    s2[b] = t2;
  }
}

// K4. dx = r * (g*w - (s1 + xhat*s2) / count), one 8-element vector a
// thread, grid-stride over [batch, n].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_dx(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ s1,
              const float* __restrict__ s2, T* __restrict__ dx, int batch, int64_t n, float count) {
  const int64_t per_sample = n / kVec;
  const int64_t total = static_cast<int64_t>(batch) * per_sample;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int b = static_cast<int>(i / per_sample);
    const int64_t e = (i - b * per_sample) * kVec;
    const int64_t at = static_cast<int64_t>(b) * n + e;
    float gv[kVec], xv[kVec], wv[kVec], out[kVec];
    load8(g + at, gv);
    load8(x + at, xv);
    load8(w + e, wv);
    const float m = mean[b];
    const float r = rstd[b];
    const float a = s1[b];
    const float c = s2[b];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float xh = (xv[k] - m) * r;
      out[k] = r * (gv[k] * wv[k] - (a + xh * c) / count);
    }
    store8(dx + at, out);
  }
}

template <typename T>
int launch_stats(const void* g, const void* x, const float* w, const float* mean, const float* rstd, float* part1,
                 float* part2, float* s1, float* s2, float* dw, float* db, int batch, int64_t n,
                 cudaStream_t stream) {
  const int blocks = partial_blocks(n);
  ln_bwd_stats<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                                   w, mean, rstd, part1, part2, dw, db,
                                                   batch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_finish<<<batch, kThreads, 0, stream>>>(part1, part2, s1, s2, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd, const float* s1,
              const float* s2, void* dx, int batch, int64_t n, cudaStream_t stream) {
  const int64_t vecs = static_cast<int64_t>(batch) * (n / kVec);
  const int64_t want = (vecs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (int64_t{1} << 30) ? want : (int64_t{1} << 30));
  ln_bwd_dx<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                                w, mean, rstd, s1, s2, static_cast<T*>(dx),
                                                batch, n, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int batch, int64_t n, int dtype) { return batch < 1 || n < kVec || n % kVec != 0 || (dtype != 0 && dtype != 1); }

}  // namespace

extern "C" {

// Number of K3 blocks for n elements a sample: the width of the part1 and
// part2 scratch ([batch, blocks] float32) that theia_ln_bwd_stats takes.
int theia_ln_bwd_partials(int64_t n) { return partial_blocks(n); }

// K3 and its finishing step. g, x: [batch, n] (16-byte aligned) of dtype
// (0 = float32, 1 = bfloat16); w, dw, db: [n] float32; mean, rstd, s1, s2:
// [batch] float32; n a multiple of 8. Returns the first
// cudaError_t of the two launches on `stream` (0 on success).
int theia_ln_bwd_stats(const void* g, const void* x, const float* w, const float* mean, const float* rstd,
                       float* part1, float* part2, float* s1, float* s2, float* dw, float* db, int batch,
                       int64_t n, int dtype, void* stream) {
  if (bad_args(batch, n, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stats<float>(g, x, w, mean, rstd, part1, part2, s1, s2, dw, db, batch, n, s);
  return launch_stats<__nv_bfloat16>(g, x, w, mean, rstd, part1, part2, s1, s2, dw, db, batch, n, s);
}

// K4: dx [batch, n] in the dtype of g and x, from K3's s1 and s2.
int theia_ln_bwd_dx(const void* g, const void* x, const float* w, const float* mean, const float* rstd,
                    const float* s1, const float* s2, void* dx, int batch, int64_t n, int dtype, void* stream) {
  if (bad_args(batch, n, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(g, x, w, mean, rstd, s1, s2, dx, batch, n, s);
  return launch_dx<__nv_bfloat16>(g, x, w, mean, rstd, s1, s2, dx, batch, n, s);
}

}  // extern "C"
