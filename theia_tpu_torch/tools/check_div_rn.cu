// div_rn (csrc/div_rn.cuh) against the IEEE division for every pair of
// 23-bit mantissas of p and l in [1, 2): 2^46 quotients. Prints the count of
// those that differ and exits 1 if any does. Built and run by
// check_div_rn.py.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "div_rn.cuh"

__device__ unsigned long long mismatches;
__device__ uint32_t example_p, example_l;

// Thread i takes the l of mantissa i and the p of every mantissa in [p_begin, p_end).
__global__ void check(int p_begin, int p_end) {
  const uint32_t ml = blockIdx.x * blockDim.x + threadIdx.x;
  const float l = __uint_as_float(0x3f800000u | ml);
  const float rl = 1.f / l;
  unsigned long long n = 0;
  for (int mp = p_begin; mp < p_end; ++mp) {
    const float p = __uint_as_float(0x3f800000u | static_cast<uint32_t>(mp));
    if (div_rn(p, l, rl) != p / l) {
      ++n;
      example_p = mp;
      example_l = ml;
    }
  }
  if (n) atomicAdd(&mismatches, n);
}

int main() {
  constexpr int kMantissas = 1 << 23;
  constexpr int kLaunches = 64;  // the p range in slices, so that no launch runs long
  constexpr int kStep = kMantissas / kLaunches;
  for (int i = 0; i < kLaunches; ++i) check<<<kMantissas / 256, 256>>>(i * kStep, (i + 1) * kStep);
  const cudaError_t err = cudaDeviceSynchronize();
  unsigned long long n = 0;
  uint32_t xp = 0, xl = 0;
  cudaMemcpyFromSymbol(&n, mismatches, sizeof(n));
  cudaMemcpyFromSymbol(&xp, example_p, sizeof(xp));
  cudaMemcpyFromSymbol(&xl, example_l, sizeof(xl));
  if (err != cudaSuccess) {
    printf("check_div_rn: %s\n", cudaGetErrorString(err));
    return 1;
  }
  printf("check_div_rn: 2^46 mantissa pairs, %llu quotients differ from the IEEE division", n);
  if (n) printf(" (e.g. p mantissa %u, l mantissa %u)", xp, xl);
  printf("\n");
  return n ? 1 : 0;
}
