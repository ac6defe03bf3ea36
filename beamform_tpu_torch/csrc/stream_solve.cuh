// The tile size and the complex and warp helpers shared by the per-(frame,
// bin) solves (tri_solve.cuh: the MVDR and LCMV stream kernels and the fused
// MVDR/LCMV kernel) and the fused GSS kernel (gss_stream.cu).
//
// A solve block takes kBins bins x kFrames frames with kThreads threads.
// shfl and group_sum exchange values within a group of MP lanes (a power of
// two, at most 32) of a warp; no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf_stream {

constexpr int kThreads = 256;
constexpr int kBins = 8;      // bins per block
constexpr int kFrames = 32;   // frames per block; kBins * kFrames problems

template <int MP>
__device__ __forceinline__ float2 shfl(unsigned mask, float2 v, int src) {
  return make_float2(__shfl_sync(mask, v.x, src, MP),
                     __shfl_sync(mask, v.y, src, MP));
}

template <int MP>
__device__ __forceinline__ float2 group_sum(unsigned mask, float2 v) {
#pragma unroll
  for (int off = MP / 2; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(mask, v.x, off, MP);
    v.y += __shfl_xor_sync(mask, v.y, off, MP);
  }
  return v;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

}  // namespace bf_stream
