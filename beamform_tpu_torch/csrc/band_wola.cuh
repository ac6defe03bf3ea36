// Device code shared by the WOLA kernels (wola.cu) and the two fused
// audio-to-audio kernels (mega_stream.cu, gss_stream.cu): the fused kernels'
// band-limited analysis on the register FFT (reg_fft.cuh) with its gate
// statistic's inputs, the radix-2 FFT of one frame held in shared memory,
// the half-spectrum synthesis of one frame on it, and the grid barrier and
// grid size of the persistent fused kernels.
//
// Analysis (beamform_tpu/kernels/mega_stream.py:121-158): frame t of
// [tail | x] under the periodic sqrt-Hann window, nfft-point DFT of two real
// channels per complex FFT; the fused kernels keep only the band's bins.
//
// Half-spectrum synthesis (mega_stream.py:104-118, 161-184): y[0] once and
// 2 * y[k] for 0 < k < nfft / 2, inverse DFT, real part, x 1 / nfft, the
// synthesis window, 50% overlap-add. By linearity this equals the inverse of
// the Hermitian spectrum built from y (with Re y[0]) when y vanishes at the
// Nyquist bin, so it is right only for bands below Nyquist; the fused
// kernels' capacity rules (kernels/mega_stream.py mega_fits,
// kernels/gss_stream.py gss_fits) refuse the others. The overlap-add goes
// with atomicAdd into a zeroed output: each sample receives exactly two
// addends, so the sum does not depend on the order blocks run in.
//
// Twiddles and the window come from tables computed in float64 on the host
// and cast to float32. No fast-math intrinsics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reg_fft.cuh"

namespace bf_band {

constexpr int kThreads = 256;

// log2 of a power of two, on the host
inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

__device__ __forceinline__ int bitrev(int i, int log2n) {
  return (int)(__brev((unsigned)i) >> (32 - log2n));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int idx, bool inverse) {
  float2 w = tw[idx];
  if (inverse) w.y = -w.y;
  return w;
}

// In-place radix-2 decimation-in-time FFT of n = 2^log2n points held in
// shared memory in bit-reversed order; leaves natural order. tw[j] =
// exp(-2 pi i j / n) for j < n/2; ``inverse`` conjugates the twiddles
// (unnormalised inverse). Two radix-2 stages at a time run in registers on
// four points (the same butterflies in the same order), which halves the
// shared-memory round trips and barriers; an odd last stage runs alone.
// Every thread of the block takes part; ends with a barrier.
__device__ inline void fft_inplace(float2* s, const float2* __restrict__ tw,
                                   int n, int log2n, bool inverse) {
  int lh = 0;
  for (; lh + 1 < log2n; lh += 2) {
    const int half = 1 << lh;
    const int s1 = n >> (lh + 1);            // twiddle stride of stage lh
    const int s2 = n >> (lh + 2);            // and of stage lh + 1
    for (int q = threadIdx.x; q < (n >> 2); q += blockDim.x) {
      const int j = q & (half - 1);
      const int i0 = ((q >> lh) << (lh + 2)) + j;
      const float2 w1 = twiddle(tw, j * s1, inverse);
      const float2 bw = cmul(s[i0 + half], w1);
      const float2 dw = cmul(s[i0 + 3 * half], w1);
      const float2 a = s[i0];
      const float2 c = s[i0 + 2 * half];
      const float2 a1 = cadd(a, bw), b1 = csub(a, bw);
      const float2 c1 = cadd(c, dw), d1 = csub(c, dw);
      const float2 cw = cmul(c1, twiddle(tw, j * s2, inverse));
      const float2 dw2 = cmul(d1, twiddle(tw, (j + half) * s2, inverse));
      s[i0] = cadd(a1, cw);
      s[i0 + 2 * half] = csub(a1, cw);
      s[i0 + half] = cadd(b1, dw2);
      s[i0 + 3 * half] = csub(b1, dw2);
    }
    __syncthreads();
  }
  if (lh < log2n) {
    const int half = 1 << lh;
    const int s1 = n >> (lh + 1);
    for (int b = threadIdx.x; b < (n >> 1); b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> lh) << (lh + 1)) + j;
      const float2 u = s[i0];
      const float2 vw = cmul(s[i0 + half], twiddle(tw, j * s1, inverse));
      s[i0] = cadd(u, vw);
      s[i0 + half] = csub(u, vw);
    }
    __syncthreads();
  }
}

// Channel pairs a block of kThreads threads transforms at once in
// analyze_pairs: one group of n / 16 threads each, for n = 256 R3.
template <int R3>
__host__ __device__ constexpr int analysis_pairs() {
  return kThreads / (16 * R3);
}

// The band analysis of frame t (of the call) for the channel pairs q0 ..
// q0 + G - 1, G = analysis_pairs<R3>(): frame t of [tail | x] (x is
// (M, T * hop), tail (M, hop)) under the window, one complex FFT per pair
// (reg_fft.cuh, ptw its pass twiddles), the band's bins ib split into the
// frame plane dst: mic c, in-band bin jb at c * NIB + jb (kBinMajor false)
// or jb * M + c (true); X_0[0] into *dc when q0 is 0 and dc is not null. A
// bin outside [1, n / 2) gives NaN. Every thread of the block calls it (the
// FFT synchronises the block); sh holds G padded frames.
template <int R3, bool kBinMajor>
__device__ __noinline__ void analyze_pairs(
    float2* sh, const float* __restrict__ x, const float* __restrict__ tail,
    const float* __restrict__ win, const float2* __restrict__ ptw,
    const int64_t* __restrict__ ib, float2* __restrict__ dst,
    float* __restrict__ dc, int M, int T, int NIB, int t, int q0) {
  constexpr int n = 256 * R3;
  constexpr int hop = n / 2;
  constexpr int tpf = n / bf_fft::kPts;     // threads per pair
  constexpr int G = analysis_pairs<R3>();
  constexpr int ld = bf_fft::padded(n);
  const int g = threadIdx.x / tpf;
  const int j = threadIdx.x - g * tpf;
  const int P = (M + 1) / 2;
  const int pr = q0 + g;
  const size_t S = (size_t)T * hop;
  float2 v[bf_fft::kPts];
  if (pr < P) {
    // points j + s n / 16: the first half from hop t of [tail | x], the
    // second from hop t + 1
    const int c0 = 2 * pr;
    const bool pair = c0 + 1 < M;
    const float* lo0 = t == 0 ? tail + (size_t)c0 * hop
                              : x + c0 * S + (size_t)(t - 1) * hop;
    const float* hi0 = x + c0 * S + (size_t)t * hop;
    const size_t dlo = t == 0 ? hop : S;        // to the pair's second row
#pragma unroll
    for (int s = 0; s < bf_fft::kPts; ++s) {
      const int i = j + s * tpf;
      const float* src = s < bf_fft::kPts / 2 ? lo0 + i : hi0 + i - hop;
      const size_t d = s < bf_fft::kPts / 2 ? dlo : S;
      const float w = __ldg(win + i);
      const float a = __ldg(src);
      const float b = pair ? __ldg(src + d) : 0.f;
      v[s] = make_float2(a * w, b * w);
    }
  } else {
#pragma unroll
    for (int s = 0; s < bf_fft::kPts; ++s) v[s] = make_float2(0.f, 0.f);
  }
  bf_fft::fft<R3>(v, sh + g * ld, ptw, j);
  // X_c0[k] = (Z[k] + conj(Z[n-k])) / 2, X_c0+1[k] = (Z[k] - conj(Z[n-k])) / 2i
  const float nan = __int_as_float(0x7fc00000);
  for (int q = threadIdx.x; q < G * NIB; q += kThreads) {
    // bin-major: the pairs of one bin in neighbouring threads, so that a
    // warp writes whole rows of mics
    const int gq = kBinMajor ? q % G : q / NIB;
    const int jb = kBinMajor ? q / G : q - gq * NIB;
    const int c0 = 2 * (q0 + gq);
    if (c0 >= M) continue;
    const int64_t k = ib[jb];
    float2 a = make_float2(nan, nan), b = a;
    if (k >= 1 && k < hop) {
      const float2 z = sh[gq * ld + bf_fft::pad((int)k)];
      const float2 m = sh[gq * ld + bf_fft::pad(n - (int)k)];
      a = make_float2(0.5f * (z.x + m.x), 0.5f * (z.y - m.y));
      b = make_float2(0.5f * (z.y + m.y), -0.5f * (z.x - m.x));
    }
    if (kBinMajor) {
      dst[(size_t)jb * M + c0] = a;
      if (c0 + 1 < M) dst[(size_t)jb * M + c0 + 1] = b;
    } else {
      dst[(size_t)c0 * NIB + jb] = a;
      if (c0 + 1 < M) dst[(size_t)(c0 + 1) * NIB + jb] = b;
    }
  }
  if (dc != nullptr && q0 == 0 && threadIdx.x == 0) *dc = sh[0].x;  // X_0[0]
  __syncthreads();                                    // sh is reused
}

// analyze_pairs at the FFT length 2 * hop (256 .. 4096); q0 is a multiple
// of the pairs a block holds at once, kThreads * 16 / (2 * hop).
template <bool kBinMajor>
__device__ __forceinline__ void analyze_band(
    int hop, float2* sh, const float* __restrict__ x,
    const float* __restrict__ tail, const float* __restrict__ win,
    const float2* __restrict__ ptw, const int64_t* __restrict__ ib,
    float2* __restrict__ dst, float* __restrict__ dc, int M, int T, int NIB,
    int t, int q0) {
#define BF_ANALYZE(R3)                                                     \
  analyze_pairs<R3, kBinMajor>(sh, x, tail, win, ptw, ib, dst, dc, M, T,   \
                               NIB, t, q0)
  switch (hop) {
    case 128: BF_ANALYZE(1); break;
    case 256: BF_ANALYZE(2); break;
    case 512: BF_ANALYZE(4); break;
    case 1024: BF_ANALYZE(8); break;
    default: BF_ANALYZE(16); break;
  }
#undef BF_ANALYZE
}

// The half spectrum of one output frame into s in bit-reversed order:
// s[0] = dc (real), s[ib[j]] = (ib[j] == 0 ? 1 : 2) * y[j], zero elsewhere.
// ib holds distinct bins in [0, n / 2); a bin outside makes the frame NaN.
// Ends with a barrier.
__device__ inline void load_half_spectrum(float2* s, int n, int log2n,
                                          float dc,
                                          const float2* __restrict__ y,
                                          const int64_t* __restrict__ ib,
                                          int NIB) {
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    s[k] = make_float2(k == 0 ? dc : 0.f, 0.f);     // bitrev(0) == 0
  __syncthreads();
  bool bad = false;
  for (int j = threadIdx.x; j < NIB; j += blockDim.x) {
    const int64_t k = ib[j];
    if (k < 0 || k >= n / 2) {
      bad = true;
      continue;
    }
    const float f = k == 0 ? 1.f : 2.f;
    const float2 v = y[j];
    s[bitrev((int)k, log2n)] = make_float2(f * v.x, f * v.y);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0)
    s[0] = make_float2(__int_as_float(0x7fc00000), 0.f);
  __syncthreads();
}

// Inverse FFT of the half spectrum in s, real part x 1 / n, synthesis
// window, and the 50% overlap-add of frame t into out (T * hop, zero on
// entry): the first half onto hop t, the second onto hop t + 1, or into
// new_prev (hop) for the last frame; frame 0 also adds the carry out_prev.
__device__ inline void synthesize_frame(float2* s,
                                        const float2* __restrict__ tw,
                                        const float* __restrict__ win,
                                        const float* __restrict__ out_prev,
                                        float* __restrict__ out,
                                        float* __restrict__ new_prev, int T,
                                        int hop, int log2n, int t) {
  const int n = 2 * hop;
  fft_inplace(s, tw, n, log2n, true);
  const float inv_n = 1.0f / (float)n;       // exact: n is a power of two
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float p = s[i].x * inv_n * win[i];
    if (i < hop) {
      atomicAdd(out + (size_t)t * hop + i, p);
    } else if (t + 1 < T) {
      atomicAdd(out + (size_t)(t + 1) * hop + (i - hop), p);
    } else {
      new_prev[i - hop] = p;
    }
  }
  if (t == 0) {
    for (int i = threadIdx.x; i < hop; i += blockDim.x)
      atomicAdd(out + i, out_prev[i]);
  }
  __syncthreads();                           // s is reused
}

// A barrier across every block of a cooperatively launched grid, whose
// global-memory writes before it are visible to every block after it.
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

// Blocks of a persistent grid and the multiprocessors' room for them: the
// grid a cooperative launch of ``kernel`` with ``smem`` bytes of dynamic
// shared memory can hold resident at once, or 0 with the error in ``err``.
template <typename K>
inline int resident_grid(K kernel, size_t smem, cudaError_t& err) {
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return 0;
  if (per_sm < 1) {
    err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  return per_sm * sms;
}

}  // namespace bf_band
