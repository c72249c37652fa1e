// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces theia_tpu/ops/attention.py::_mha_fwd_kernel (launched by
// _pallas_call_fwd). Q, K, V and O are [B, T, H, hd] with unit stride over
// hd and heads hd apart, and any batch and token strides: Q, K, V may be views into
// the packed QKV projection ([B, T, 3, H, hd]), so nothing is copied into a
// per-head layout first. For each (batch, head) slab, [T, hd]:
//   S = Q K^T * scale, accumulated in float32;
//   P = softmax(S) in float32, row max subtracted, P = exp(S - m) / sum;
//   P is rounded to V's dtype (this matters in bf16);
//   O = P V accumulated in float32 and stored in Q's dtype.
// Inputs are float32 or bf16, T <= 256, hd <= 128 and a multiple of 16.
//
// What bounds it on the H100. At T ~ 200 and hd = 64 a head does
// ~4*T^2*hd = 10 MFLOP over ~4*T*hd*bytes of input and output (50 KB in
// bf16), ~200 FLOP per byte, so device memory is not the limit: the T x T
// row work is. The TPU kernel kept the whole T x T score block in VMEM.
// Here nothing of size T x T leaves the SM: a block stages one head's K
// and V in shared memory once and serves up to 64 query rows from them;
// each row's scores stay in registers until its P V is done; the row max
// and sum are warp shuffles. The whole key row is in registers at once (T
// <= 256), so P is normalised by the final max and sum before it is
// rounded, exactly as the TPU kernel rounds it (an online softmax would
// round P against a running max instead). Two implementations, chosen by
// dtype:
//
// bf16, tensor cores (mha_fwd_bf16): a warp owns 16 query rows and runs
//   mma.sync m16n8k16 (bf16 in, float32 accumulate) for S = Q K^T and for
//   O = P V. The S accumulators of two neighbouring 8-key tiles are exactly
//   the A fragment of P for the next 16-key step, so P goes from registers
//   to the tensor cores without touching shared memory. K and V are staged
//   with cp.async (V's copy overlaps Q K^T); V's B fragments come from a
//   transposing ldmatrix. Row pitches are padded by 16 bytes, which makes
//   every fragment load conflict-free. Blocks are ordered head-major so the
//   row blocks of a head share its K and V in L2.
//
// float32, CUDA cores (mha_fwd_f32): no tensor-core instruction multiplies
//   in full float32, so the products run as FMAs. Lane j owns keys j, j+32,
//   ...; a warp owns kRowsPerWarp = 4 rows, so each K and V element read from
//   shared memory feeds 4 rows. Measured latency-bound (one resident block
//   per SM): ~1.5x the time of the cuBLAS-based plain version at B = 64.
//
// The ragged edge (T = 197, 204) is masked per key and per row. TMA staging
// and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRowsPerBlock = 16 * kTcWarps;
constexpr int kMaxKeyTiles = kMaxT / 8;

// Shared memory: K and V, each [round16(T)][HD + 8].
size_t smem_bytes_bf16(int t, int hd) {
  return 2 * static_cast<size_t>(round16(t)) * (hd + 8) * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    mha_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Layout lay,
                 int row_blocks, float scale) {
  constexpr int kDimSteps = HD / 16;  // k16 steps of S = Q K^T
  constexpr int kDimTiles = HD / 8;   // n8 tiles of O
  constexpr int kPitch = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = lay.t;
  const int t16 = round16(t);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [t16][kPitch]
  __nv_bfloat16* vs = ks + t16 * kPitch;                       // [t16][kPitch]

  // Blocks are ordered head-major, so the row blocks of one head run
  // together and share its K and V in L2.
  const int head = blockIdx.x / row_blocks;
  const int64_t rs = lay.in_tstride;
  const __nv_bfloat16* qh = q + lay.in_head(head, HD);
  __nv_bfloat16* oh = o + lay.out_head(head, HD);
  stage_rows<HD>(ks, k + lay.in_head(head, HD), rs, t, t16);  // copy group 1: K
  stage_rows<HD>(vs, v + lay.in_head(head, HD), rs, t, t16);  // copy group 2: V, in flight during Q K^T

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and B column) of this lane
  const int tq = lane & 3;  // fragment column pair of this lane
  const int r0 = (blockIdx.x - head * row_blocks) * kTcRowsPerBlock + warp * 16;
  const bool active = r0 < t;
  const int row_a = r0 + g;
  const int row_b = r0 + g + 8;

  // Q as A fragments, straight from global memory; rows past T are zeros.
  uint32_t qa[kDimSteps][4];
#pragma unroll
  for (int s = 0; s < kDimSteps; ++s) {
    const int d = s * 16 + 2 * tq;
    qa[s][0] = row_a < t ? load_u32(qh + row_a * rs + d) : 0u;
    qa[s][1] = row_b < t ? load_u32(qh + row_b * rs + d) : 0u;
    qa[s][2] = row_a < t ? load_u32(qh + row_a * rs + d + 8) : 0u;
    qa[s][3] = row_b < t ? load_u32(qh + row_b * rs + d + 8) : 0u;
  }
  cp_async_wait<1>();
  __syncthreads();  // K is in shared memory

  // S = Q K^T: tile n holds keys 8n .. 8n+7; element e of a tile is row
  // (e < 2 ? row_a : row_b), key 8n + 2*tq + (e & 1).
  const int key_tiles = t16 / 8;
  float sc[kMaxKeyTiles][4];
  float l_a = 0.f, l_b = 0.f;
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxKeyTiles; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      if (n < key_tiles) {
        const __nv_bfloat16* krow = ks + (n * 8 + g) * kPitch + 2 * tq;
#pragma unroll
        for (int s = 0; s < kDimSteps; ++s) {
          mma_bf16_16816(sc[n], qa[s], load_u32(krow + s * 16), load_u32(krow + s * 16 + 8));
        }
      }
    }

    // Softmax over each row in float32: a row's keys are spread over the 4
    // lanes of its group, so max and sum finish with two xor-shuffles.
    float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kMaxKeyTiles; ++n) {
      if (n < key_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * tq + (e & 1);
          sc[n][e] = key < t ? sc[n][e] * scale : -INFINITY;
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
  }
  cp_async_wait<0>();
  __syncthreads();  // V is in shared memory
  if (!active) return;

  // O = P V over 16-key steps: the S tiles 2j and 2j+1, divided by the row
  // sums and rounded to bf16, are the A fragment of step j; V's B fragments
  // for two dim tiles at a time come from one transposing ldmatrix.
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // key within the step
  const int lcol = (lane >> 4) * 8;                      // dim tile of the pair
  float acc[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxKeyTiles / 2; ++j) {
    if (2 * j < key_tiles) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * j][0] / l_a, sc[2 * j][1] / l_a),
          pack_bf16(sc[2 * j][2] / l_b, sc[2 * j][3] / l_b),
          pack_bf16(sc[2 * j + 1][0] / l_a, sc[2 * j + 1][1] / l_a),
          pack_bf16(sc[2 * j + 1][2] / l_b, sc[2 * j + 1][3] / l_b),
      };
#pragma unroll
      for (int n = 0; n < kDimTiles; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (j * 16 + lrow) * kPitch + n * 8 + lcol);
        mma_bf16_16816(acc[n], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) {
    const int d = n * 8 + 2 * tq;
    if (row_a < t) *reinterpret_cast<uint32_t*>(oh + row_a * lay.out_tstride + d) = pack_bf16(acc[n][0], acc[n][1]);
    if (row_b < t) *reinterpret_cast<uint32_t*>(oh + row_b * lay.out_tstride + d) = pack_bf16(acc[n][2], acc[n][3]);
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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int slabs, const Layout& lay,
                float scale, cudaStream_t stream) {
  const int t = lay.t;
  const size_t smem = smem_bytes_bf16(t, HD);
  const cudaError_t err = allow_smem(mha_fwd_bf16<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (t + kTcRowsPerBlock - 1) / kTcRowsPerBlock;
  mha_fwd_bf16<HD><<<slabs * row_blocks, kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lay, row_blocks, scale);
  return static_cast<int>(cudaGetLastError());
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
  switch (hd) {
    case 16: return launch_bf16<16>(q, k, v, o, slabs, lay, scale, s);
    case 32: return launch_bf16<32>(q, k, v, o, slabs, lay, scale, s);
    case 48: return launch_bf16<48>(q, k, v, o, slabs, lay, scale, s);
    case 64: return launch_bf16<64>(q, k, v, o, slabs, lay, scale, s);
    case 80: return launch_bf16<80>(q, k, v, o, slabs, lay, scale, s);
    case 96: return launch_bf16<96>(q, k, v, o, slabs, lay, scale, s);
    case 112: return launch_bf16<112>(q, k, v, o, slabs, lay, scale, s);
    default: return launch_bf16<128>(q, k, v, o, slabs, lay, scale, s);
  }
}

const char* theia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
