// Pieces shared by the port's two fused IR-SE unit kernels
// (fused_irse_unit.cu, fused_irse_unit_sm90.cu): the bn1 affine as the TPU
// kernel rounds it, and the deterministic reduction of the SE partial sums.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// bn1 affine in f32 without FMA contraction, as the plain version computes
// it (the caller zeroes pixels outside the image).
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// sums[b][co] = sum over tiles of partials[b][tile][co], in tile order.
__global__ void reduce_tile_sums(const float* __restrict__ partials,
                                 float* __restrict__ sums, int n_tiles,
                                 int cout) {
  const int b = blockIdx.y;
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  if (co >= cout) return;
  const float* p = partials + (size_t)b * n_tiles * cout + co;
  float acc = 0.f;
  for (int t = 0; t < n_tiles; ++t) acc += p[(size_t)t * cout];
  sums[(size_t)b * cout + co] = acc;
}

}  // namespace
