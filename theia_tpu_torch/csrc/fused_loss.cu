// Fused distillation-loss sums for Hopper (sm_90a): the five per-sample
// sums in one pass (K5) and d pred in one more (K6).
//
// Replaces theia_tpu/ops/fused_loss.py::_fwd_kernel (launched by
// _loss_sums_impl) and ::_bwd_kernel (launched by _loss_sums_bwd, the
// backward of the loss_sums custom_vjp). For [B, D] pred p and target t,
// with d = p - t, all in float32:
//   K5: s[b] = (sum d*d, sum smoothL1(d; beta), sum p*t, sum p*p, sum t*t)
//   K6: dp = g0*2d + g1*clip(d/beta, -1, 1) + g2*t + g3*2p    (g = ds, [B, 5])
// smoothL1(d) = 0.5*|d|^2/beta where |d| < beta, else |d| - 0.5*beta. p and
// t are float32 or bf16 each (bf16 pred from the heads against float32
// targets is the recipe's case); a bf16 value converts to float32 exactly
// in registers, so no float32 copy of pred is ever made. dp is stored in
// pred's dtype: one rounding of the float32 result, which is what JAX's
// float32 dp followed by the VJP of astype gives.
//
// What bounds them: device memory. At the recipe (Theia-Base cddsv, B=16,
// D = 256*{1280,1024,1024} and 4096*{256,32}: 32.5M elements a step, bf16
// p and float32 t) K5 reads 6 bytes an element, 195 MB, 58 us at 3.35
// TB/s; K6 reads 6 and writes 2, 260 MB, 78 us. 10 flops an element are
// nothing beside that.
//
// Carried state. The TPU kernel walks a sequential (sample, row block) grid
// and carries the five sums in its output block; Hopper blocks run in no
// order, and one block a sample would fill 16 of 132 SMs. K5 splits each
// sample into chunks of kChunk elements, one block each (grid [chunks,
// samples]); a block keeps five float32 sums a thread, reduces them (warp
// shuffles, then shared memory, always in the same order) and writes one
// partial row [5] for its (sample, chunk). A second small kernel
// (loss_sums_finish, one warp a sample) adds a sample's partials in a fixed
// order. No atomics: the sums are deterministic.
//
// Loads. Where D is a multiple of 8 and the rows 16-byte aligned, a thread
// reads 8 consecutive elements of each input per step: one 16-byte load of
// bf16, two of float32. Otherwise (any D >= 1) it reads one element at a
// time, still coalesced across the warp.
//
// K6 uses __fmul_rn/__fadd_rn, so no multiply-add is contracted: it rounds
// each operation in the order the plain PyTorch version does, and at beta = 1
// (where PyTorch's division by a scalar, a multiply by its reciprocal, is
// exact too) the two agree bit for bit on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                               // elements a thread reads per step
constexpr int kSteps = 4;                             // vector steps a thread takes in K5
constexpr int kChunk = kThreads * kVec * kSteps;      // elements of a sample one K5 block sums
constexpr int kSums = 5;
constexpr int kMaxGridY = 65535;

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
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
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

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void accumulate(float p, float t, float beta, float (&s)[kSums]) {
  const float d = p - t;
  const float ad = fabsf(d);
  s[0] += d * d;
  s[1] += ad < beta ? 0.5f * ad * ad / beta : ad - 0.5f * beta;
  s[2] += p * t;
  s[3] += p * p;
  s[4] += t * t;
}

__device__ __forceinline__ float grad1(float p, float t, float g0x2, float g1, float g2, float g3x2, float beta) {
  const float d = __fsub_rn(p, t);
  const float clipped = fminf(fmaxf(__fdiv_rn(d, beta), -1.f), 1.f);
  float out = __fadd_rn(__fmul_rn(g0x2, d), __fmul_rn(g1, clipped));
  out = __fadd_rn(out, __fmul_rn(g2, t));
  return __fadd_rn(out, __fmul_rn(g3x2, p));
}

int64_t chunks(int64_t d) { return (d + kChunk - 1) / kChunk; }

// K5. pred, target: [batch, d]; part: [batch, gridDim.x, 5] float32 partial
// sums of each (sample, chunk). Samples are strided over gridDim.y.
template <typename P, typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    loss_sums_partial(const P* __restrict__ pred, const T* __restrict__ target, float* __restrict__ part,
                      int batch, int64_t d, float beta) {
  __shared__ float red[kSums][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = start + kChunk < d ? start + kChunk : d;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const P* p = pred + static_cast<int64_t>(b) * d;
    const T* t = target + static_cast<int64_t>(b) * d;
    float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (kVector) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int64_t e = start + (static_cast<int64_t>(i) * kThreads + threadIdx.x) * kVec;
        if (e < end) {  // d, start and end are multiples of kVec
          float pv[kVec], tv[kVec];
          load8(p + e, pv);
          load8(t + e, tv);
#pragma unroll
          for (int k = 0; k < kVec; ++k) accumulate(pv[k], tv[k], beta, s);
        }
      }
    } else {
      for (int64_t e = start + threadIdx.x; e < end; e += kThreads) accumulate(load1(p + e), load1(t + e), beta, s);
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const float v = warp_sum(s[k]);
      if (lane == 0) red[k][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < kSums) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[threadIdx.x][w];
      part[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kSums + threadIdx.x] = v;
    }
    __syncthreads();  // red is refilled by the next sample
  }
}

// The second step of K5: out[b] = the sum of sample b's partial rows, one
// warp a sample, always in the same order.
__global__ void __launch_bounds__(32)
    loss_sums_finish(const float* __restrict__ part, float* __restrict__ out, int blocks) {
  const int64_t b = blockIdx.x;
  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < blocks; k += 32) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) s[j] += part[(b * blocks + k) * kSums + j];
  }
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const float v = warp_sum(s[j]);
    if (threadIdx.x == 0) out[b * kSums + j] = v;
  }
}

// K6. dp [batch, d] in pred's dtype, grid-stride over the elements (vectors
// of kVec where kVector).
template <typename P, typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    loss_sums_bwd(const P* __restrict__ pred, const T* __restrict__ target, const float* __restrict__ g,
                  P* __restrict__ dp, int batch, int64_t d, float beta) {
  constexpr int kWidth = kVector ? kVec : 1;
  const int64_t per_sample = d / kWidth;
  const int64_t total = static_cast<int64_t>(batch) * per_sample;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t b = i / per_sample;
    const int64_t at = i * kWidth;  // = b*d + the element's offset in its row
    const float* gb = g + b * kSums;
    const float g0x2 = __fmul_rn(gb[0], 2.f), g1 = gb[1], g2 = gb[2], g3x2 = __fmul_rn(gb[3], 2.f);
    if constexpr (kVector) {
      float pv[kVec], tv[kVec], out[kVec];
      load8(pred + at, pv);
      load8(target + at, tv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) out[k] = grad1(pv[k], tv[k], g0x2, g1, g2, g3x2, beta);
      store8(dp + at, out);
    } else {
      store1(dp + at, grad1(load1(pred + at), load1(target + at), g0x2, g1, g2, g3x2, beta));
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename P, typename T>
int launch_fwd(const void* pred, const void* target, float* part, float* out, int batch, int64_t d, float beta,
               bool vector, cudaStream_t stream) {
  const int blocks = static_cast<int>(chunks(d));
  const dim3 grid(blocks, batch < kMaxGridY ? batch : kMaxGridY);
  const P* p = static_cast<const P*>(pred);
  const T* t = static_cast<const T*>(target);
  if (vector) {
    loss_sums_partial<P, T, true><<<grid, kThreads, 0, stream>>>(p, t, part, batch, d, beta);
  } else {
    loss_sums_partial<P, T, false><<<grid, kThreads, 0, stream>>>(p, t, part, batch, d, beta);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_sums_finish<<<batch, 32, 0, stream>>>(part, out, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename T>
int launch_bwd(const void* pred, const void* target, const float* g, void* dp, int batch, int64_t d, float beta,
               bool vector, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(batch) * (vector ? d / kVec : d);
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (int64_t{1} << 20) ? want : (int64_t{1} << 20));
  const P* p = static_cast<const P*>(pred);
  const T* t = static_cast<const T*>(target);
  P* out = static_cast<P*>(dp);
  if (vector) {
    loss_sums_bwd<P, T, true><<<blocks, kThreads, 0, stream>>>(p, t, g, out, batch, d, beta);
  } else {
    loss_sums_bwd<P, T, false><<<blocks, kThreads, 0, stream>>>(p, t, g, out, batch, d, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int batch, int64_t d, int pred_dtype, int target_dtype) {
  return batch < 1 || d < 1 || chunks(d) > INT32_MAX || (pred_dtype != 0 && pred_dtype != 1) ||
         (target_dtype != 0 && target_dtype != 1);
}

}  // namespace

extern "C" {

// Number of K5 chunks a sample of d elements is cut into: the middle width
// of the [batch, chunks, 5] float32 scratch that theia_loss_sums_fwd takes.
int theia_loss_sums_partials(int64_t d) { return static_cast<int>(chunks(d)); }

// K5 and its finishing step. pred, target: contiguous [batch, d], dtype 0 =
// float32, 1 = bfloat16 each; part: scratch as above; out: [batch, 5]
// float32. Returns the first cudaError_t of the two launches on `stream`.
int theia_loss_sums_fwd(const void* pred, const void* target, float* part, float* out, int batch, int64_t d,
                        int pred_dtype, int target_dtype, float beta, void* stream) {
  if (bad_args(batch, d, pred_dtype, target_dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector = d % kVec == 0 && aligned(pred) && aligned(target);
  if (pred_dtype == 0 && target_dtype == 0)
    return launch_fwd<float, float>(pred, target, part, out, batch, d, beta, vector, s);
  if (pred_dtype == 0)
    return launch_fwd<float, __nv_bfloat16>(pred, target, part, out, batch, d, beta, vector, s);
  if (target_dtype == 0)
    return launch_fwd<__nv_bfloat16, float>(pred, target, part, out, batch, d, beta, vector, s);
  return launch_fwd<__nv_bfloat16, __nv_bfloat16>(pred, target, part, out, batch, d, beta, vector, s);
}

// K6. pred, target as for K5; g: [batch, 5] float32; dp: [batch, d] in
// pred's dtype.
int theia_loss_sums_bwd(const void* pred, const void* target, const float* g, void* dp, int batch, int64_t d,
                        int pred_dtype, int target_dtype, float beta, void* stream) {
  if (bad_args(batch, d, pred_dtype, target_dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector = d % kVec == 0 && aligned(pred) && aligned(target) && aligned(dp);
  if (pred_dtype == 0 && target_dtype == 0)
    return launch_bwd<float, float>(pred, target, g, dp, batch, d, beta, vector, s);
  if (pred_dtype == 0)
    return launch_bwd<float, __nv_bfloat16>(pred, target, g, dp, batch, d, beta, vector, s);
  if (target_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(pred, target, g, dp, batch, d, beta, vector, s);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(pred, target, g, dp, batch, d, beta, vector, s);
}

}  // extern "C"
