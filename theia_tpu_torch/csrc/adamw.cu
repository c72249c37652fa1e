// K10: the masked AdamW step over every parameter of a model in one launch
// (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to XLA,
// which fuses it. The port's plain version, MaskedAdamW.update_plain
// (train/optim.py), runs ~34 PyTorch ops for each of a model's tensors
// (9,074 launches a step for Theia-Base's 268), and the card waits on the
// host through most of them. K10 is one launch over a table of the
// tensors, and the only work left on the host is gathering its pointers.
//
// Arithmetic. Bit for bit the plain version's: every operation is rounded
// as PyTorch's separate kernels round it, in the same order, with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, which nvcc never
// contracts into an FMA. With the update in the grad's dtype T (float32,
// or bfloat16 where each op's float32 result is rounded to bf16):
//   mu1 = b1*mu + (1-b1)*g,  nu1 = b2*nu + ((1-b2)*g)*g
//   under a mask m: mu1 = m*mu1 + (1-m)*mu (nu1 likewise), count += int(m)
//   bc = count > 0 ? 1 - pow(b, count) : 1   (the new count)
//   step = (mu1/bc1) / (sqrt(nu1/bc2) + eps) [+ wd*p where decay applies]
//   u = (-lr)*step, or ((-lr)*m)*step under a mask [* translator factor]
//   p = p + u;  mu, nu stored in their own dtype (__float2bfloat16_rn)
// The scalars arrive as the float32 values PyTorch computes with: 1 - b1,
// 1 - b2, eps and wd rounded once from the host's doubles; pow's base is
// b rounded to T, as torch.pow rounds its wrapped scalar. A tensor whose
// mask is 0 is not touched at all: parameter, moments and count keep
// their bits.
//
// What bounds it: device memory. With float32 p and g and bf16 moments an
// element moves 20 bytes (read and write p, read g, read and write mu and
// nu): Theia-Base's 188.1M elements are 3.76 GB, 1.12 ms at 3.35 TB/s.
// The design moves each byte once, with enough bytes in flight:
//   - One flattened index space of fixed chunks (kChunk elements) over all
//     tensors; a tensor's chunks start at its descriptor's chunk0 (a
//     prefix sum the host builds once per set of shapes). A persistent
//     grid (a few blocks a SM) walks the chunks in strides of the grid;
//     a block finds its first tensor by binary search and then moves
//     forward, recomputing a tensor's constants (count, mask, bias
//     corrections, lr) only when it enters a new tensor.
//   - A thread loads all kUnroll of its 4-element vectors of p, g, mu and
//     nu (16-byte loads of float32, 8-byte of bf16) before it updates and
//     stores them. A tensor whose length or addresses break that
//     alignment takes one element a thread, still coalesced.
//   - A gradient laid out otherwise than its contiguous parameter is read
//     in place, gathered in p's order by its sizes and strides (up to 4-d):
//     the recipe's 3x3 conv weights get channels_last gradients from
//     cuDNN, and the patch embedding's comes from a matmul as [kh][c][o][kw].
//     A warp's 128 elements of p are then short runs of g that neighbouring
//     warps read too, so L1 and L2 serve the rest of each sector.
//   - The descriptors travel as one __grid_constant__ parameter (up to
//     32,764 bytes from CUDA 12.1 on sm_70+), so a launch needs no copy to
//     the device; the host splits the tensors over several launches only
//     past kMaxTensors.
//   - Counts. Every block reads the counts of the tensors it updates; the
//     last block to finish (a ticket on a counter, like K3's) advances all
//     of them, so no block reads a count another block has advanced, and
//     resets the counter to 0 for the next launch on the stream.
//   - lr is read through a pointer from the schedule's 0-dim device
//     tensor: the host never reads a device value and never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "K10 passes its descriptors as a kernel parameter of up to 32,764 bytes, which needs CUDA 12.1"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kUnroll = 2;
constexpr int kChunk = kThreads * kVec * kUnroll;  // elements a chunk covers (train/optim.py CHUNK)
constexpr int kParamBytes = 32764;

// descriptor flags (train/optim.py)
constexpr int kDecay = 1;      // weight decay applies
constexpr int kScale = 2;      // the translator LR factor applies
constexpr int kMasked = 4;     // the call's mask names this tensor
constexpr int kStrided = 8;    // g is strided: gathered by size and stride

struct TensorDesc {            // 96 bytes; train/optim.py DESC
  void* p;
  const void* g;
  void* mu;
  void* nu;
  int* count;                  // int32, 0-dim
  const float* mask;           // float32, 0-dim, or null: mask_value
  long long n;                 // elements
  int chunk0;                  // this tensor's first chunk
  int flags;
  float mask_value;
  int size[3];                 // kStrided: p's sizes but the first, as 4-d (n < 2^31)
  int stride[4];               // kStrided: g's strides in elements, as 4-d (offsets < 2^31)
};

struct Header {
  const float* lr;             // float32, 0-dim, or null: neg_lr
  unsigned int* counter;       // one word, 0 between launches
  float neg_lr, b1, b2, c1, c2, eps, wd, factor;
  int n, chunks;
};

constexpr int kMaxTensors = (kParamBytes - static_cast<int>(sizeof(Header))) / static_cast<int>(sizeof(TensorDesc));

struct Params {
  Header h;
  TensorDesc t[kMaxTensors];
};
static_assert(sizeof(TensorDesc) == 96, "train/optim.py DESC mirrors TensorDesc");
static_assert(sizeof(Params) <= kParamBytes, "K10's descriptors must fit one kernel parameter");

// ---------------------------------------------------------------- rounding
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <typename T>
__device__ __forceinline__ float rmul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float radd(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float rsub(float a, float b) { return rnd<T>(__fsub_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float rdiv(float a, float b) { return rnd<T>(__fdiv_rn(a, b)); }

// 1 - pow(b, count) in T for count > 0, else 1: torch.where(count > 0,
// 1.0 - b**count.to(T), 1.0), with b the float32 value of the Python float
template <typename T>
__device__ __forceinline__ float bias_correction(float b, int count) {
  if (count <= 0) return 1.f;
  return rsub<T>(1.f, rnd<T>(powf(rnd<T>(b), rnd<T>(static_cast<float>(count)))));
}

// ------------------------------------------------------------ loads, stores
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void load4(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kVec]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename X>
__device__ __forceinline__ bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(X)) == 0;
}

// ------------------------------------------------------------- the update
// A tensor's constants, computed when a block enters it.
struct Coef {
  float m, one_m;              // the mask in T, and 1 - m (masked only)
  float bc1, bc2;
  float a;                     // -lr, or (-lr)*m, in the dtype the step multiplies it in
  bool masked, decay, scale, skip;
};

template <typename T>
__device__ Coef coefficients(const Header& h, const TensorDesc& d, float neg_lr) {
  Coef k;
  k.masked = d.flags & kMasked;
  k.decay = d.flags & kDecay;
  k.scale = d.flags & kScale;
  k.m = k.masked ? rnd<T>(d.mask ? *d.mask : d.mask_value) : 1.f;
  k.one_m = rsub<T>(1.f, k.m);
  k.skip = k.masked && k.m == 0.f;
  const int count = *d.count + (k.masked ? static_cast<int>(k.m) : 1);
  k.bc1 = bias_correction<T>(h.b1, count);
  k.bc2 = bias_correction<T>(h.b2, count);
  // (-lr) * step takes a device lr in T and a host lr as PyTorch's float
  // scalar; (-lr) * m is a 0-dim tensor, rounded to T either way
  k.a = k.masked ? rmul<T>(neg_lr, k.m) : (h.lr ? rnd<T>(neg_lr) : neg_lr);
  return k;
}

// one element: p, mu and nu in and out, mu and nu as values of T
template <typename T>
__device__ __forceinline__ void adamw1(float& p, float g, float& mu, float& nu, const Header& h, const Coef& k) {
  float m1 = radd<T>(rmul<T>(h.b1, mu), rmul<T>(h.c1, g));
  float n1 = radd<T>(rmul<T>(h.b2, nu), rmul<T>(rmul<T>(h.c2, g), g));
  if (k.masked) {
    m1 = radd<T>(rmul<T>(k.m, m1), rmul<T>(k.one_m, mu));
    n1 = radd<T>(rmul<T>(k.m, n1), rmul<T>(k.one_m, nu));
  }
  float step = rdiv<T>(rdiv<T>(m1, k.bc1), radd<T>(rnd<T>(__fsqrt_rn(rdiv<T>(n1, k.bc2))), h.eps));
  if (k.decay) step = radd<T>(step, rmul<T>(h.wd, p));
  float u = rmul<T>(k.a, step);
  if (k.scale) u = rmul<T>(u, h.factor);
  p = radd<T>(p, u);
  mu = m1;
  nu = n1;
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery's division by invariant integers), d >= 1 fixed per tensor
struct FastDiv {
  int d;
  unsigned int m;
  int s;
  __device__ __forceinline__ void set(int divisor) {
    d = divisor;
    for (s = 0; (1u << s) < static_cast<unsigned int>(d); ++s) {
    }
    m = static_cast<unsigned int>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned int>(n), m) + static_cast<unsigned int>(n)) >> s);
  }
};

// a strided gradient's layout as a block keeps it while it walks the
// tensor: p's sizes but the first (as 4-d) and g's strides
struct Gather {
  FastDiv size[3];
  int stride[4];
};

__device__ __forceinline__ void gather_layout(const TensorDesc& d, Gather& gl) {
#pragma unroll
  for (int i = 0; i < 3; ++i) gl.size[i].set(d.size[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) gl.stride[i] = d.stride[i];
}

// g's offset of element e of a strided gradient, e counted in p's order;
// advance() moves it to e + 1
struct StridedIndex {
  int i1, i2, i3, off;
  __device__ __forceinline__ StridedIndex(int e, const Gather& gl) {
    int rest = gl.size[2](e);
    i3 = e - rest * gl.size[2].d;
    int next = gl.size[1](rest);
    i2 = rest - next * gl.size[1].d;
    rest = gl.size[0](next);
    i1 = next - rest * gl.size[0].d;
    off = rest * gl.stride[0] + i1 * gl.stride[1] + i2 * gl.stride[2] + i3 * gl.stride[3];
  }
  __device__ __forceinline__ void advance(const Gather& gl) {
    off += gl.stride[3];
    if (++i3 < gl.size[2].d) return;
    i3 = 0;
    off += gl.stride[2] - gl.size[2].d * gl.stride[3];
    if (++i2 < gl.size[1].d) return;
    i2 = 0;
    off += gl.stride[1] - gl.size[1].d * gl.stride[2];
    if (++i1 < gl.size[0].d) return;
    i1 = 0;
    off += gl.stride[0] - gl.size[0].d * gl.stride[1];
  }
};

// elements [start, end) of a tensor. kStrided: g is laid out otherwise than
// the contiguous p and is gathered in p's order (its short runs are shared
// by neighbouring threads through L1)
template <typename T, typename M, bool kStrided>
__device__ void update_run(const Header& h, const TensorDesc& d, const Coef& k, const Gather& gl, long long start,
                           long long end) {
  T* __restrict__ p = static_cast<T*>(d.p) + start;
  const T* __restrict__ g = static_cast<const T*>(d.g) + (kStrided ? 0 : start);
  M* __restrict__ mu = static_cast<M*>(d.mu) + start;
  M* __restrict__ nu = static_cast<M*>(d.nu) + start;
  const int len = static_cast<int>(end - start);
  const bool vec = aligned<T>(p) && aligned<M>(mu) && aligned<M>(nu) && (kStrided || aligned<T>(g));
  const int vlen = vec ? len & ~(kVec - 1) : 0;
  if (vlen > 0) {
    float pv[kUnroll][kVec], gv[kUnroll][kVec], mv[kUnroll][kVec], nv[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = (u * kThreads + threadIdx.x) * kVec;
      if (e < vlen) {
        load4(p + e, pv[u]);
        if constexpr (kStrided) {
          StridedIndex at(static_cast<int>(start) + e, gl);
#pragma unroll
          for (int j = 0; j < kVec; ++j, at.advance(gl)) gv[u][j] = load1(g + at.off);
        } else {
          load4(g + e, gv[u]);
        }
        load4(mu + e, mv[u]);
        load4(nu + e, nv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = (u * kThreads + threadIdx.x) * kVec;
      if (e < vlen) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          mv[u][j] = rnd<T>(mv[u][j]);
          nv[u][j] = rnd<T>(nv[u][j]);
          adamw1<T>(pv[u][j], gv[u][j], mv[u][j], nv[u][j], h, k);
        }
        store4(p + e, pv[u]);
        store4(mu + e, mv[u]);
        store4(nu + e, nv[u]);
      }
    }
  }
  for (int e = vlen + threadIdx.x; e < len; e += kThreads) {
    float pe = load1(p + e), me = rnd<T>(load1(mu + e)), ne = rnd<T>(load1(nu + e));
    const float ge = kStrided ? load1(g + StridedIndex(static_cast<int>(start) + e, gl).off) : load1(g + e);
    adamw1<T>(pe, ge, me, ne, h, k);
    store1(p + e, pe);
    store1(mu + e, me);
    store1(nu + e, ne);
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads) adamw_sm90(const __grid_constant__ Params P) {
  __shared__ bool last;
  const Header h = P.h;  // in registers through the element loops
  const float neg_lr = h.lr ? -*h.lr : h.neg_lr;
  // the last tensor whose chunk0 <= blockIdx.x (empty tensors own no chunk)
  int t = 0;
  for (int lo = 0, hi = h.n - 1; lo <= hi;) {
    const int mid = (lo + hi) >> 1;
    if (P.t[mid].chunk0 <= static_cast<int>(blockIdx.x)) t = mid, lo = mid + 1;
    else hi = mid - 1;
  }
  int entered = -1;
  Coef k;
  Gather gl;
  for (int c = blockIdx.x; c < h.chunks; c += gridDim.x) {
    while (t + 1 < h.n && P.t[t + 1].chunk0 <= c) ++t;
    const TensorDesc& d = P.t[t];
    if (t != entered) {
      k = coefficients<T>(h, d, neg_lr);
      if (d.flags & kStrided) gather_layout(d, gl);
      entered = t;
    }
    if (k.skip) continue;
    const long long start = static_cast<long long>(c - d.chunk0) * kChunk, end = min(start + kChunk, d.n);
    if (d.flags & kStrided) update_run<T, M, true>(h, d, k, gl, start, end);
    else update_run<T, M, false>(h, d, k, gl, start, end);
  }
  // this block has read every count it needs; the last block advances them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(h.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < h.n; i += kThreads) {
    const TensorDesc& d = P.t[i];
    if (d.flags & kMasked) {
      *d.count += static_cast<int>(rnd<T>(d.mask ? *d.mask : d.mask_value));
    } else {
      *d.count += 1;
    }
  }
  if (threadIdx.x == 0) *h.counter = 0;
}

// bias_correction over counts, for the card test's check against torch
template <typename T>
__global__ void adamw_bias_corrections(const int* count, float* out, int n, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = bias_correction<T>(b, count[i]);
}

// resident blocks a SM of adamw_sm90<T, M> (cached: one card type a
// process), or a negated cudaError_t
template <typename T, typename M>
int resident_blocks() {
  static int resident = 0;
  if (resident == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, adamw_sm90<T, M>, kThreads, 0) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  return resident;
}

// f(T{}, M{}) for the dtype codes of p and g (T) and of the moments (M)
template <typename F>
int by_dtypes(int dtype, int moment_dtype, F&& f) {
  if (dtype == 0 && moment_dtype == 0) return f(float{}, float{});
  if (dtype == 0) return f(float{}, __nv_bfloat16{});
  if (moment_dtype == 0) return f(__nv_bfloat16{}, float{});
  return f(__nv_bfloat16{}, __nv_bfloat16{});
}

// a persistent grid: every resident block of every SM, at most a block a chunk
template <typename T, typename M>
int launch(const Params& P, cudaStream_t stream) {
  const int resident = resident_blocks<T, M>();
  if (resident < 0) return -resident;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int grid = P.h.chunks < 1 ? 1 : (P.h.chunks < resident * sms ? P.h.chunks : resident * sms);
  adamw_sm90<T, M><<<grid, kThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The layout the host builds descriptors for: elements a chunk, tensors a
// launch, bytes a descriptor.
void theia_adamw_layout(int* chunk, int* max_tensors, int* desc_bytes) {
  *chunk = kChunk;
  *max_tensors = kMaxTensors;
  *desc_bytes = static_cast<int>(sizeof(TensorDesc));
}

// K10 over n <= theia_adamw_layout's max_tensors descriptors (host
// memory, TensorDesc layout, chunk0 a prefix over the chunks, `chunks` in
// all). dtype: p and g, moment_dtype: mu and nu, each 0 = float32, 1 =
// bfloat16. lr: a float32 device scalar, or null for neg_lr = -lr. counter:
// one unsigned word, 0 before the first launch on `stream` (each launch
// leaves it 0). Returns the launch's cudaError_t (0 on success).
int theia_adamw(const void* descs, int n, int chunks, const float* lr, float neg_lr, float b1, float b2, float c1,
                float c2, float eps, float wd, float factor, int dtype, int moment_dtype, unsigned int* counter,
                void* stream) {
  if (n < 1 || n > kMaxTensors || chunks < 0 || (dtype != 0 && dtype != 1) ||
      (moment_dtype != 0 && moment_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.h = Header{lr, counter, neg_lr, b1, b2, c1, c2, eps, wd, factor, n, chunks};
  const TensorDesc* d = static_cast<const TensorDesc*>(descs);
  for (int i = 0; i < n; ++i) {
    if ((d[i].flags & kStrided) && (d[i].n > INT32_MAX || d[i].size[0] < 1 || d[i].size[1] < 1 || d[i].size[2] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    P.t[i] = d[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtypes(dtype, moment_dtype, [&](auto t, auto m) { return launch<decltype(t), decltype(m)>(P, s); });
}

// K10's bias correction 1 - pow(b, count) (1 where count <= 0) in dtype
// (0 = float32, 1 = bfloat16) for n int32 device counts into float32 out.
int theia_adamw_bias_corrections(const int* count, float* out, int n, float b, int dtype, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (dtype == 0) adamw_bias_corrections<float><<<blocks, kThreads, 0, s>>>(count, out, n, b);
  else adamw_bias_corrections<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(count, out, n, b);
  return static_cast<int>(cudaGetLastError());
}

// Resident K10 blocks a SM for dtype and moment_dtype (the grid is this
// times the SMs, at most the chunks), or a negated cudaError_t.
int theia_adamw_blocks_per_sm(int dtype, int moment_dtype) {
  if ((dtype != 0 && dtype != 1) || (moment_dtype != 0 && moment_dtype != 1))
    return -static_cast<int>(cudaErrorInvalidValue);
  return by_dtypes(dtype, moment_dtype, [](auto t, auto m) { return resident_blocks<decltype(t), decltype(m)>(); });
}

}  // extern "C"
