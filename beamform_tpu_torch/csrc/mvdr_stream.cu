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
// solves. The kernel is the LCMV stream kernel (lcmv_stream.cuh) at one
// constraint, less its inner system and its X scratch: a block takes 8 bins
// x 32 frames and stages those frames and their W-frame history once into
// shared memory (read straight from the analysis output's (T, M, NB)
// layout at the band's bin indices, so no gathered copy of the spectra is
// made), and MP / 2 lanes solve one problem, lane l holding rows l and
// MP - 1 - l of R's lower triangle and of its Cholesky factor
// (tri_solve.cuh; MP = M rounded up to a power of two, at least 4), so at
// 16 mics a warp solves four problems. The refined solve and the two sums
// over lanes are tri_solve.cuh's mvdr_terms, as in the fused kernel's
// refined MVDR form. Each window sum is recomputed from the frames it
// covers, so chunked output equals offline output bit for bit. The result
// agrees with the TPU kernel's sliding and epoch sums at float32
// round-off, not bit for bit.
//
// What bounds it: instruction issue, not bytes. A problem at 16 mics costs
// about 40 k flop (window sum, factor, four triangular solves, one
// residual) against 1.3 KB of spectra read once per block; the factor's
// column broadcasts serve four problems a warp, and the backward solves'
// sums over lanes and the refinement's residual are the shuffles left. On
// an NVIDIA H100 80GB HBM3 at 700 W, at 16 mics, 678 bins, 1,407 frames and
// W = 10 (97.85% of the pairs solved), a call takes 1.74–1.83 ms, 486–511
// SM-cycles a solved problem (3.54 ms with two problems a warp and a full
// row of R a lane; PERF.md section 6).
//
// Streams. One launch serves B streams, the grid's z index the stream: the
// spectra are the (T, B, M, NB) analysis output of all B * M channels, read
// in place, hist, w_idx, gate and y carry a leading stream axis, and the
// steering d is shared. A single stream is B = 1.
//
// Rows beyond M are an identity block (zero spectra, unit diagonal, zero
// steering), so the M x M solve is unchanged. Pivots use 1.f / sqrtf(),
// not rsqrtf(); no fast-math intrinsics.
//
// The index tensors are checked here, not on the host (which would cost a
// synchronisation per call). Neither is dereferenced out of range: a bin
// index outside [0, NB) makes every output of its bin NaN, a steering
// index outside [0, U) every solved output of its frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_solve.cuh"

namespace {

using namespace bf_tri;

// two blocks of 256 threads an SM (128 registers a thread) up to 16 rows
template <int MP>
__global__ void __launch_bounds__(kThreads, MP <= 16 ? 2 : 1)
    mvdr_stream_kernel(const float2* __restrict__ spec,
                       const int64_t* __restrict__ ib,
                       const float2* __restrict__ hist,
                       const float2* __restrict__ d,
                       const int64_t* __restrict__ w_idx,
                       const uint8_t* __restrict__ gate,
                       float2* __restrict__ y, int T, int M, int NB, int NIB,
                       int W, int U) {
  using Sh = Shape<MP>;
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  float2* xs = smem;                        // [kFrames + W][kBins][LD]
  const int b0 = blockIdx.x * kBins;
  const int t0 = blockIdx.y * kFrames;
  const float nan = __int_as_float(0x7fc00000);
  // stream blockIdx.z: its plane of the (T, B, M, NB) spectra, its rows of
  // hist, w_idx, gate and y
  const int sb = blockIdx.z;
  spec += (size_t)sb * M * NB;
  hist += (size_t)sb * W * M * NIB;
  w_idx += (size_t)sb * T;
  gate += (size_t)sb * T * NIB;
  y += (size_t)sb * T * NIB;
  stage_spec<MP>(xs, spec, ib, hist, T, M, NB, NIB, W, b0, t0,
                 (size_t)gridDim.z * M * NB);
  __syncthreads();

  const int slot = threadIdx.x / Sh::H;
  const int l = threadIdx.x % Sh::H;                // rows l, MP - 1 - l
  const int rh = MP - 1 - l;
  float2* cb = smem + tile_elems<MP>(W) + slot * Sh::CB;
  // this problem's lanes within the warp: its shuffles and warp barriers
  // name only them, so the problems sharing a warp may branch apart
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
    const int64_t u = w_idx[t];
    float2 dl = make_float2(0.f, 0.f), dh = dl;
    if (u < 0 || u >= U) {
      dl = dh = make_float2(nan, nan);
    } else {
      const float2* du = d + (size_t)u * M * NIB + bin;
      if (l < M) dl = du[(size_t)l * NIB];
      if (rh < M) dh = du[(size_t)rh * NIB];
    }
    float2 num, den;
    mvdr_terms<MP>(mask, xs, lt, bb, l, W, f, dl, dh, xl, xh, num, den);
    if (l == 0) {
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
                          float2* y, int B, int T, int M, int NB, int NIB,
                          int W, int U, cudaStream_t st) {
  const size_t smem =
      ((size_t)tile_elems<MP>(W) + cbuf_elems<MP>()) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvdr_stream_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((NIB + kBins - 1) / kBins, (T + kFrames - 1) / kFrames,
                  B);
  mvdr_stream_kernel<MP><<<grid, kThreads, smem, st>>>(
      spec, ib, hist, d, w_idx, gate, y, T, M, NB, NIB, W, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B streams in one launch: spec (T, B, M, NB) complex64 (the analysis
// output of the B * M channels); ib (NIB,) int64 bin indices into NB; hist
// (B, W, M, NIB) complex64; d (U, M, NIB) complex64, shared; w_idx (B, T)
// int64 into U; gate (B, T, NIB) bool; y (B, T, NIB) complex64 out.
// 1 <= B <= 65535, 1 <= M <= 32, W >= 1. An index out of range gives NaN
// outputs. Returns the launch's cudaGetLastError().
int bf_mvdr_stream(const void* spec, const void* ib, const void* hist,
                   const void* d, const void* w_idx, const void* gate,
                   void* y, int B, int T, int M, int NB, int NIB, int W,
                   int U, void* stream) {
  const float2* s = (const float2*)spec;
  const int64_t* b = (const int64_t*)ib;
  const float2* h = (const float2*)hist;
  const float2* dv = (const float2*)d;
  const int64_t* wi = (const int64_t*)w_idx;
  const uint8_t* g = (const uint8_t*)gate;
  float2* out = (float2*)y;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (M <= 4)
    return (int)launch_stream<4>(s, b, h, dv, wi, g, out, B, T, M, NB,
                                 NIB, W, U, st);
  if (M <= 8)
    return (int)launch_stream<8>(s, b, h, dv, wi, g, out, B, T, M, NB,
                                 NIB, W, U, st);
  if (M <= 16)
    return (int)launch_stream<16>(s, b, h, dv, wi, g, out, B, T, M, NB,
                                  NIB, W, U, st);
  if (M <= 32)
    return (int)launch_stream<32>(s, b, h, dv, wi, g, out, B, T, M, NB,
                                  NIB, W, U, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
