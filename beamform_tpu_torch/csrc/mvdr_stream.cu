// Streaming MVDR solve for Hopper (sm_90a), bound with ctypes.
//
// mvdr_stream_kernel replaces beamform_tpu/kernels/mvdr_stream.py:_kernel
// (reached through mvdr_stream_pallas / mvdr_stream_planes_pallas). For
// every in-band bin b and frame t whose energy gate passes (mvdr.cpp:84-96):
//
//   R   = (sum of x x^H over the W frames before t) .* (ones + 0.001 I)
//   u   = R^-1 d          Cholesky, then one iterative-refinement pass
//   y   = (u^H x_t) / conj(d^H u)          i.e. w = u / (d^H u), y = w^H x_t
//
// and y = 0.01 * x_t[mic 0] where the gate fails (mvdr.cpp:96), selected by
// a branch, never by a multiply: a cold-start covariance is singular and
// its solve is NaN. "The frames before t" are hist (the W in-band frames
// before the chunk) followed by the chunk's own frames.
//
// Design. The TPU kernel marches the frame axis serially (a TPU grid runs
// in order) with a sliding covariance sum. On this card a serial chain
// would leave most SMs idle: at the main path's shapes (16 mics, 678
// in-band bins, 1407 frames, W = 10) it is 1417 dependent frames over 678
// bins. But R_t depends on nothing except the W frames before t, so every
// (frame, bin) pair is an independent problem: 954 k 16 x 16 Hermitian
// solves. Each block takes 8 bins x 32 frames, stages those frames and
// their W-frame history once into shared memory (coalesced along bins,
// read straight from the analysis output's (T, M, NB) layout at the band's
// bin indices, so no gathered copy of the spectra is made), and recomputes
// each window sum directly. A problem is solved by MP lanes (M rounded up
// to a power of two, at most 32): lane i owns row i of R in registers, the
// right-looking Cholesky keeps the trailing block Hermitian so lane i also
// holds column entry A[i][k], and the factor, the two triangular solves and
// the dot products exchange values by warp shuffles within the MP lanes.
// No sum depends on where a chunk starts, so chunked output equals offline
// output bit for bit. The result agrees with the TPU kernel's sliding and
// epoch sums at float32 round-off, not bit for bit.
//
// What bounds it: arithmetic and shuffle latency, not bytes. Each problem
// costs about 40 k flop (window sum, factor, four triangular solves, one
// residual) against 1.3 KB of spectra read once per block; the per-lane
// chains of dependent shuffles are what the card waits on.
//
// Rows beyond M are an identity block (zero spectra, unit diagonal, zero
// steering), so the M x M solve is unchanged. Pivots use 1.f / sqrtf(),
// not rsqrtf(); no fast-math intrinsics. The staging, the window
// covariance with its factor and the refined solve are in stream_solve.cuh.
//
// The index tensors are checked here, not on the host (which would cost a
// synchronisation per call). Neither is dereferenced out of range: a bin
// index outside [0, NB) makes every output of its bin NaN, a steering
// index outside [0, U) every solved output of its frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_solve.cuh"

namespace {

using namespace bf_stream;

template <int MP>
__global__ void __launch_bounds__(kThreads)
    mvdr_stream_kernel(const float2* __restrict__ spec,
                       const int64_t* __restrict__ ib,
                       const float2* __restrict__ hist,
                       const float2* __restrict__ d,
                       const int64_t* __restrict__ w_idx,
                       const uint8_t* __restrict__ gate,
                       float2* __restrict__ y, int T, int M, int NB, int NIB,
                       int W, int U) {
  extern __shared__ float2 xs[];  // [kFrames + W][MP][kBins]
  const int b0 = blockIdx.x * kBins;
  const int t0 = blockIdx.y * kFrames;
  const float nan = __int_as_float(0x7fc00000);
  stage_frames<MP>(xs, spec, ib, hist, T, M, NB, NIB, W, b0, t0);
  __syncthreads();

  constexpr int kSlots = kThreads / MP;
  const int slot = threadIdx.x / MP;
  const int i = threadIdx.x % MP;                   // row of R
  for (int it = 0; it < kBins * kFrames / kSlots; ++it) {
    const int p = slot + it * kSlots;
    const int bb = p % kBins;
    const int lt = p / kBins;
    const int t = t0 + lt;
    const int bin = b0 + bb;
    const bool valid = t < T && bin < NIB;
    const size_t out = (size_t)t * NIB + bin;
    const bool act = valid && gate[out];
    const unsigned mask = __ballot_sync(0xffffffffu, act);
    const float2 xt = xs[((lt + W) * MP + i) * kBins + bb];
    if (!act) {
      if (valid && i == 0) y[out] = make_float2(0.01f * xt.x, 0.01f * xt.y);
      continue;
    }

    float2 a[MP], r[MP];
    float linv;
    covariance_cholesky<MP>(mask, xs, lt, bb, i, M, W, a, r, linv);

    float2 di = make_float2(0.f, 0.f);
    const int64_t ui = w_idx[t];
    if (ui < 0 || ui >= U)
      di = make_float2(nan, nan);
    else if (i < M)
      di = d[((size_t)ui * M + i) * NIB + bin];
    const float2 u = refined_solve<MP>(mask, a, r, linv, i, di);

    const float2 den = group_sum<MP>(mask, cmul_conj(u, di));   // d^H u
    const float2 num = group_sum<MP>(mask, cmul_conj(xt, u));   // u^H x
    if (i == 0) {
      const float s = 1.f / (den.x * den.x + den.y * den.y);
      y[out] = make_float2((num.x * den.x - num.y * den.y) * s,
                           (num.y * den.x + num.x * den.y) * s);
    }
  }
}

template <int MP>
cudaError_t launch_stream(const float2* spec, const int64_t* ib,
                          const float2* hist, const float2* d,
                          const int64_t* w_idx, const uint8_t* gate,
                          float2* y, int T, int M, int NB, int NIB, int W,
                          int U, cudaStream_t st) {
  const size_t smem = (size_t)(kFrames + W) * MP * kBins * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvdr_stream_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((NIB + kBins - 1) / kBins, (T + kFrames - 1) / kFrames);
  mvdr_stream_kernel<MP><<<grid, kThreads, smem, st>>>(
      spec, ib, hist, d, w_idx, gate, y, T, M, NB, NIB, W, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// spec (T, M, NB) complex64; ib (NIB,) int64 bin indices into NB; hist
// (W, M, NIB), d (U, M, NIB) complex64; w_idx (T,) int64 into U; gate
// (T, NIB) bool; y (T, NIB) complex64 out. 1 <= M <= 32, W >= 1. An index
// out of range gives NaN outputs. Returns the launch's cudaGetLastError().
int bf_mvdr_stream(const void* spec, const void* ib, const void* hist,
                   const void* d, const void* w_idx, const void* gate,
                   void* y, int T, int M, int NB, int NIB, int W, int U,
                   void* stream) {
  const float2* s = (const float2*)spec;
  const int64_t* b = (const int64_t*)ib;
  const float2* h = (const float2*)hist;
  const float2* dv = (const float2*)d;
  const int64_t* wi = (const int64_t*)w_idx;
  const uint8_t* g = (const uint8_t*)gate;
  float2* out = (float2*)y;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 4)
    return (int)launch_stream<4>(s, b, h, dv, wi, g, out, T, M, NB, NIB, W, U,
                                 st);
  if (M <= 8)
    return (int)launch_stream<8>(s, b, h, dv, wi, g, out, T, M, NB, NIB, W, U,
                                 st);
  if (M <= 16)
    return (int)launch_stream<16>(s, b, h, dv, wi, g, out, T, M, NB, NIB, W, U,
                                  st);
  if (M <= 32)
    return (int)launch_stream<32>(s, b, h, dv, wi, g, out, T, M, NB, NIB, W, U,
                                  st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
