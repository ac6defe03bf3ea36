// The streaming LCMV kernel's template and its launch code (lcmv_stream.cu
// has the design): lcmv_stream.cu instantiates it for problem sizes MP 4
// and 8, lcmv_stream_16.cu for 16 and lcmv_stream_32.cu for 32, so that
// the package's build compiles the sizes in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_solve.cuh"

namespace bf_lcmv {

#define BF_LCMV_ARGS                                                       \
  const float2 *spec, const int64_t *ib, const float2 *hist,               \
      const float2 *c, const int64_t *idx, const uint8_t *gate, float2 *y, \
      int B, int T, int M, int NB, int NIB, int W, int U, int S,           \
      cudaStream_t st

// launch_lanes<16> and <32>, each in its own source
cudaError_t launch_16(BF_LCMV_ARGS);
cudaError_t launch_32(BF_LCMV_ARGS);

namespace {

using namespace bf_tri;

// two blocks of 256 threads an SM (128 registers a thread) up to 16 rows
// and 8 slots; past that the X scratch's shared memory or the factor's
// size leaves room for one, with 255 registers
template <int MP, int SP>
__global__ void __launch_bounds__(kThreads, (MP <= 16 && SP <= 8) ? 2 : 1)
    lcmv_stream_kernel(const float2* __restrict__ spec,
                       const int64_t* __restrict__ ib,
                       const float2* __restrict__ hist,
                       const float2* __restrict__ c,
                       const int64_t* __restrict__ idx,
                       const uint8_t* __restrict__ gate,
                       float2* __restrict__ y, int T, int M, int NB, int NIB,
                       int W, int U, int S) {
  using Sh = Shape<MP>;
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  float2* xs = smem;                        // [kFrames + W][kBins][LD]
  const int b0 = blockIdx.x * kBins;
  const int t0 = blockIdx.y * kFrames;
  // stream blockIdx.z: its plane of the (T, B, M, NB) spectra, its rows of
  // hist, idx, gate and y
  const int sb = blockIdx.z;
  spec += (size_t)sb * M * NB;
  hist += (size_t)sb * W * M * NIB;
  idx += (size_t)sb * T;
  gate += (size_t)sb * T * NIB;
  y += (size_t)sb * T * NIB;
  stage_spec<MP>(xs, spec, ib, hist, T, M, NB, NIB, W, b0, t0,
                 (size_t)gridDim.z * M * NB);
  __syncthreads();

  const int slot = threadIdx.x / Sh::H;
  const int l = threadIdx.x % Sh::H;                // rows l, MP - 1 - l
  const int rh = MP - 1 - l;
  float2* cb = smem + tile_elems<MP>(W) + slot * Sh::CB;
  // X of this problem, [a][m]
  float2* xp = smem + tile_elems<MP>(W) + cbuf_elems<MP>() + slot * SP * MP;
  // this problem's lanes within the warp: its shuffles, ballots and warp
  // barriers name only them, so the problems sharing a warp may branch
  // apart (a skipped zero column in one, a solve in another)
  const unsigned grp = group_mask<MP>();
  for (int it = 0; it < kBins * kFrames / Sh::kSlots; ++it) {
    const int p = slot + it * Sh::kSlots;
    const int bb = p % kBins;
    const int lt = p / kBins;
    const int t = t0 + lt;
    const int bin = b0 + bb;
    const bool valid = t < T && bin < NIB;
    const size_t out = (size_t)t * NIB + bin;
    const bool act = valid && gate[out];
    const unsigned mask = __ballot_sync(0xffffffffu, act) & grp;
    const float2* xrow = frame<MP>(xs, lt + W, bb);
    const float2 xl = xrow[l], xh = xrow[rh];
    if (!act) {
      if (valid && l == 0) y[out] = make_float2(0.01f * xl.x, 0.01f * xl.y);
      continue;
    }
    Factor<MP> f;
    covariance_factor<MP>(mask, xs, cb, lt, bb, l, M, W, f);
    const int64_t u = idx[t];
    const bool bad = u < 0 || u >= U;
    const float2* cu = c + (size_t)(bad ? 0 : u) * S * M * NIB + bin;
    const float2 yv = lcmv_apply<MP, SP>(mask, xs, lt, bb, l, M, W, S, f, cu,
                                         NIB, bad, xl, xh, xp, true);
    if (l == 0) y[out] = yv;
  }
}

template <int MP, int SP>
cudaError_t launch_lcmv(const float2* spec, const int64_t* ib,
                        const float2* hist, const float2* c,
                        const int64_t* idx, const uint8_t* gate, float2* y,
                        int B, int T, int M, int NB, int NIB, int W, int U,
                        int S, cudaStream_t st) {
  const size_t smem = ((size_t)tile_elems<MP>(W) + cbuf_elems<MP>()
                       + (size_t)Shape<MP>::kSlots * SP * MP) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lcmv_stream_kernel<MP, SP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((NIB + kBins - 1) / kBins, (T + kFrames - 1) / kFrames,
                  B);
  lcmv_stream_kernel<MP, SP><<<grid, kThreads, smem, st>>>(
      spec, ib, hist, c, idx, gate, y, T, M, NB, NIB, W, U, S);
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_lanes(const float2* spec, const int64_t* ib,
                         const float2* hist, const float2* c,
                         const int64_t* idx, const uint8_t* gate, float2* y,
                         int B, int T, int M, int NB, int NIB, int W, int U,
                         int S, cudaStream_t st) {
#define BF_LCMV_SP(SPV)                                                    \
  if (S <= SPV && SPV <= MP)                                               \
    return launch_lcmv<MP, (SPV <= MP ? SPV : MP)>(                        \
        spec, ib, hist, c, idx, gate, y, B, T, M, NB, NIB, W, U, S, st);
  BF_LCMV_SP(1)
  BF_LCMV_SP(2)
  BF_LCMV_SP(4)
  BF_LCMV_SP(8)
  BF_LCMV_SP(16)
#undef BF_LCMV_SP
  return cudaErrorInvalidValue;
}

}  // namespace

}  // namespace bf_lcmv
