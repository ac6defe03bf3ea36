// A complex FFT held in registers, for Hopper (sm_90a): each thread holds
// kPts = 16 points of an n-point frame (n a power of two in [256, 4096]),
// runs radix-16 and radix-R butterflies on them in registers, and meets the
// block's other threads only between passes, through shared memory.
//
// The passes are Stockham's autosort form (Govindaraju et al., "High
// performance discrete Fourier transforms on graphics processors", 2008):
// pass (R, Ns) reads point b + r n/R (r < R) for butterfly b, multiplies it
// by exp(-2 pi i (b mod Ns) r / (Ns R)), takes an R-point DFT and writes
// output r to (b / Ns) Ns R + (b mod Ns) + r Ns. After the passes (16, 1),
// (16, 16) and, for n > 256, (n / 256, 256) the frame is in natural order:
// no bit-reversed load, and the first pass reads straight from the input,
// thread j taking the points j + s n / 16 (s < 16), so that consecutive
// threads read consecutive samples. Whatever pass a thread is
// in, it reads the points j + s n / 16 (s < 16) of the shared frame.
//
// Shared memory holds a frame at padded addresses i + i / 16: the strided
// writes of the first pass (16 j + r) and every row of 16 consecutive
// points then fall in distinct banks. The inter-pass twiddles come from a
// host table (kernels/wola.py analysis_plan, float64 cast to float32), laid
// out [r][b mod Ns] per pass so that a warp reads consecutive entries; the
// twiddles inside a radix-16 butterfly are the constants below. No
// fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace bf_fft {

constexpr int kPts = 16;   // points a thread holds

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// v * exp(-2 pi i e / 16) for e in [0, 8); e is a constant after unrolling
__device__ __forceinline__ float2 mul_w16(float2 v, int e) {
  constexpr float c1 = 0.923879532511286756f;   // cos(pi / 8)
  constexpr float s1 = 0.382683432365089772f;   // sin(pi / 8)
  constexpr float h = 0.707106781186547524f;    // cos(pi / 4)
  switch (e) {
    case 0: return v;
    case 1: return cmul(v, make_float2(c1, -s1));
    case 2: return cmul(v, make_float2(h, -h));
    case 3: return cmul(v, make_float2(s1, -c1));
    case 4: return make_float2(v.y, -v.x);
    case 5: return cmul(v, make_float2(-s1, -c1));
    case 6: return cmul(v, make_float2(-h, -h));
    default: return cmul(v, make_float2(-c1, -s1));
  }
}

__host__ __device__ constexpr int ilog2c(int n) {
  return n <= 1 ? 0 : 1 + ilog2c(n / 2);
}

// In-register R-point DFT (R a power of two, at most 16), natural order in
// and out: radix-2 Stockham stages on constant indices.
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
#pragma unroll
  for (int l = 0; l < ilog2c(R); ++l) {
    const int ns = 1 << l;
    float2 b[R];
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int k = j % ns;
      const float2 u = a[j];
      const float2 w = mul_w16(a[j + R / 2], k * (8 / ns));
      const int d = (j / ns) * 2 * ns + k;
      b[d] = make_float2(u.x + w.x, u.y + w.y);
      b[d + ns] = make_float2(u.x - w.x, u.y - w.y);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = b[j];
  }
}

// the padded shared-memory address of point i, and a padded frame's size
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int padded(int n) { return n + n / 16; }

// Thread j's points j + s * tpf (tpf = n / 16) of the frame z, into v.
template <int tpf>
__device__ __forceinline__ void gather(const float2* z, int j,
                                       float2 (&v)[kPts]) {
#pragma unroll
  for (int s = 0; s < kPts; ++s) v[s] = z[pad(j + s * tpf)];
}

// The n-point FFT, n = 256 R3, of the frame whose points j + s * n / 16
// thread j holds in v, for the n / 16 threads of one group. Leaves the
// spectrum in natural order in z (padded). The block synchronises inside:
// every thread of the block calls it, and z is free on entry (no thread
// still reads it).
template <int R3>
__device__ __forceinline__ void fft(float2 (&v)[kPts], float2* z,
                                    const float2* __restrict__ tw, int j) {
  constexpr int tpf = 16 * R3;
  // pass (16, 1): no twiddles; butterfly j, outputs to 16 j + r
  dft<16>(v);
#pragma unroll
  for (int r = 0; r < kPts; ++r) z[pad(16 * j + r)] = v[r];
  __syncthreads();
  // pass (16, 16): butterfly j
  gather<tpf>(z, j, v);
  const int k2 = j & 15;
#pragma unroll
  for (int r = 1; r < kPts; ++r) v[r] = cmul(v[r], __ldg(tw + r * 16 + k2));
  dft<16>(v);
  __syncthreads();                          // every read of pass 2 is done
  const int base2 = (j >> 4) * 256 + k2;
#pragma unroll
  for (int r = 0; r < kPts; ++r) z[pad(base2 + 16 * r)] = v[r];
  __syncthreads();
  if constexpr (R3 > 1) {
    // pass (R3, 256): butterflies b = j + q n / 16 (q < 16 / R3), which
    // read and write the same points b + 256 r: in place, no barrier
    // between the reads and the writes
    constexpr int Q = kPts / R3;
    gather<tpf>(z, j, v);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int b = j + q * tpf;
      float2 a[R3];
#pragma unroll
      for (int r = 0; r < R3; ++r) {
        a[r] = v[q + r * Q];
        if (r > 0) a[r] = cmul(a[r], __ldg(tw + 256 + r * 256 + b));
      }
      dft<R3>(a);
#pragma unroll
      for (int r = 0; r < R3; ++r) z[pad(b + 256 * r)] = a[r];
    }
    __syncthreads();
  }
}

}  // namespace bf_fft
