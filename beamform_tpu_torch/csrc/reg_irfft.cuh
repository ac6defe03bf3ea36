// The inverse real FFT of one frame on the register FFT (reg_fft.cuh), for
// Hopper (sm_90a): a real frame of n points from its half spectrum X[0..h]
// (h = n / 2, X[0] and X[h] real) through one complex FFT of h points, so
// that an n-point synthesis costs an h-point transform.
//
// The packing (the even and odd samples as the real and imaginary parts of
// one complex signal): for k < h
//
//   E[k] = X[k] + conj(X[h - k]),   D[k] = X[k] - conj(X[h - k]),
//   Z[k] = E[k] + i e^{+2 pi i k / n} D[k],
//
// then z = IDFT_h(Z) (the unnormalised sum) gives n x[2m] = Re z[m] and
// n x[2m + 1] = Im z[m]. The inverse is the forward transform of the
// conjugate, IDFT(Z) = conj(FFT(conj Z)), so reg_fft.cuh's fft<R3> runs it
// as it is: thread j of a frame's group holds conj(Z[j + s h / 16]) for
// s < 16, and after the FFT the frame's point m is conj(z[m]) in natural
// order in shared memory. Each thread reads X[k] and X[h - k] for its own
// points straight from device memory (the second read of a bin comes from
// L1 or L2), so the load is one pass with no bit reversal and no barrier.
//
// The pre-twiddles e^{+2 pi i k / n} (k < h) come from a host table
// computed in float64 (kernels/wola.py synthesis_plan), as do the FFT's
// pass twiddles. No fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

#include "reg_fft.cuh"

namespace bf_irfft {

// X[kk] of the extended layout y (hop + 2 bins: bin hop + 1 is the shadow
// conj(X[hop - 1])) folded to the Hermitian half spectrum
// (models/common.py fold_ext): bin hop - 1 the blend (y[hop - 1] +
// conj(y[hop + 1])) / 2, bins 0 and hop their real part. ``shadow`` is
// y[hop + 1].
template <int hop>
__device__ __forceinline__ float2 fold(const float2* __restrict__ y, int kk,
                                       float2 shadow) {
  float2 v = __ldg(y + kk);
  if (kk == hop - 1)
    v = make_float2(0.5f * (v.x + shadow.x), 0.5f * (v.y - shadow.y));
  if (kk == 0 || kk == hop) v.y = 0.f;
  return v;
}

// Thread j's points of conj(Z) for the half-length inverse of the frame
// whose extended bins y holds (h = hop = 256 R3 points, h / 16 threads a
// frame), into v: point j + s h / 16 in v[s].
template <int R3>
__device__ __forceinline__ void load_packed(const float2* __restrict__ y,
                                            const float2* __restrict__ pre,
                                            int j, float2 (&v)[bf_fft::kPts]) {
  constexpr int h = 256 * R3;
  constexpr int tpf = h / bf_fft::kPts;
  const float2 shadow = __ldg(y + h + 1);
#pragma unroll
  for (int s = 0; s < bf_fft::kPts; ++s) {
    const int k = j + s * tpf;
    const float2 a = fold<h>(y, k, shadow);
    const float2 b = fold<h>(y, h - k, shadow);
    const float2 w = __ldg(pre + k);
    const float2 e = make_float2(a.x + b.x, a.y - b.y);     // a + conj(b)
    const float2 d = make_float2(a.x - b.x, a.y + b.y);     // a - conj(b)
    const float2 p = bf_fft::cmul(w, d);
    v[s] = make_float2(e.x - p.y, -(e.y + p.x));            // conj(e + i p)
  }
}

// Thread j's points of conj(X) over the full n = 256 points (the Hermitian
// mirror of the folded half spectrum), for the full-length inverse at
// nfft 256, below the register FFT's smallest size for the half-length
// one: point j + 16 s in v[s].
__device__ __forceinline__ void load_full256(const float2* __restrict__ y,
                                             int j,
                                             float2 (&v)[bf_fft::kPts]) {
  constexpr int n = 256, hop = 128;
  const float2 shadow = __ldg(y + hop + 1);
#pragma unroll
  for (int s = 0; s < bf_fft::kPts; ++s) {
    const int k = j + s * (n / bf_fft::kPts);
    const float2 a = fold<hop>(y, k <= hop ? k : n - k, shadow);
    v[s] = k <= hop ? make_float2(a.x, -a.y) : a;   // conj(X[k]), X[n-k]
  }
}

// Samples 2p and 2p + 1 of a frame, times ``scale``, from the FFT's output
// z (padded, natural order) of the half-length inverse: conj(z[p]) holds
// them as its real and imaginary parts.
__device__ __forceinline__ float2 half_pair(const float2* z, int p,
                                            float scale) {
  const float2 f = z[bf_fft::pad(p)];
  return make_float2(__fmul_rn(f.x, scale), __fmul_rn(-f.y, scale));
}

// The same pair from the full-length inverse: the real parts of points 2p
// and 2p + 1.
__device__ __forceinline__ float2 full_pair(const float2* z, int p,
                                            float scale) {
  return make_float2(__fmul_rn(z[bf_fft::pad(2 * p)].x, scale),
                     __fmul_rn(z[bf_fft::pad(2 * p + 1)].x, scale));
}

}  // namespace bf_irfft
