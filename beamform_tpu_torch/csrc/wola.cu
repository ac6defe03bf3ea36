// Fused WOLA analysis and synthesis for Hopper (sm_90a), bound with ctypes.
//
// wola_analysis_kernel replaces beamform_tpu/kernels/wola_pallas.py:_fwd_kernel
// (reached through rfft_hops_pallas / stft_planes): frame assembly from the
// previous and current hop, periodic sqrt-Hann window, nfft-point DFT, the
// full-DFT bin prefix 0..h+1 (bin h+1 is the shadow bin conj(X[h-1]) of the
// extended layout), and optionally the energy-gate statistic
// sum_c |X| / (C * nfft) (mvdr.cpp:79-82), all in one launch.
//
// wola_inv_kernel replaces wola_pallas.py:_inv_kernel (reached through
// irfft_ola_batch_pallas / istft_ext_fused) together with the fold and
// Hermitian mirror that XLA runs before it (wola_pallas.py:417-423): the
// shadow blend at h-1, Re() at bins 0 and h, inverse DFT x 1/nfft,
// synthesis window and the 50% overlap-add with the one-hop carry out_prev.
//
// The analysis is bound by memory bytes: at the main-path size (16 mics,
// 48 kHz, 30 s, hop 1024) it reads about 92 MB of input and writes about
// 185 MB of extended spectra, at ~5 flop per byte. Its FFT (reg_fft.cuh)
// holds 16 points a thread in registers and exchanges them through
// conflict-free padded shared memory only between its 2-3 passes; the
// first pass loads straight from the natural (C, S) layout, consecutive
// threads on consecutive samples; the frame's size is a template
// parameter, so every offset is an immediate. Two real channels share one
// complex FFT. A block takes one frame: every channel pair of it, up to
// 256 / (n / 16) pairs at once and chunk after chunk, or, with fewer
// frames than four blocks an SM and no gate statistic, one chunk of pairs,
// so that the grid still fills the card. The hop a frame shares with the
// previous one was read by a neighbouring block a moment before, so it
// comes from L2 and the input crosses HBM about once. With the gate
// statistic the thread that splits bin k of every pair sums |X_c| over
// c = 0..C-1 in that order: one launch, deterministic, no second pass over
// the spectra; so with it the grid is T blocks, fewer than the card's 132
// SMs below 132 frames (a 64-frame streaming chunk). On an H100 at 16 mics
// and 1,407 frames of nfft 2048 one call through the wrapper takes 0.167
// ms (0.187 with the statistic; byte bound 0.083 ms; the radix-2 kernels
// it replaced 0.449 ms, 0.542 with the statistic).
//
// The synthesis runs the radix-2 stages of band_wola.cuh (shared with the
// fused kernels, mega_stream.cu and gss_stream.cu) on one frame held in
// shared memory in bit-reversed order. Blocks are independent, so the
// overlap-add, which the TPU carried across its sequential grid, is done
// with atomicAdd into a zeroed output: each output sample receives exactly
// two addends, and a + b == b + a, so the result does not depend on the
// order blocks run in.
//
// Twiddles and the window come from tables computed in float64 on the host
// and cast to float32. No fast-math intrinsics: the budget is 1e-5 of peak.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"
#include "reg_fft.cuh"

namespace {

using bf_band::kThreads;
using bf_band::bitrev;
using bf_band::ilog2;

constexpr int kAnaThreads = 256;
// frames from which a block walks every channel pair of its frame: four
// blocks for each of the H100's 132 SMs
constexpr int kWalkFrames = 4 * 132;

// grid (T, pair blocks), n = 256 R3: block (t, y) transforms frame t of
// the channel pairs 2p, 2p+1 for p in chunks [y * cpb, (y + 1) * cpb) of G
// pairs, one pair per group of n / 16 threads, as one complex signal
// z = x_2p + i x_2p+1, and splits the spectra:
// X_2p[k] = (Z[k] + conj(Z[n-k])) / 2 and X_2p+1[k] = (Z[k] - conj(Z[n-k])) / 2i.
// Frame t is samples [t*hop, t*hop + n) of [tail | x]; spec is
// (T, C, hop + 2) complex64. An odd last channel pairs with zeros. With
// mag (one pair block holding every chunk), mag[t, k] = scale *
// sum_c |X_c[k]|, summed in channel order.
template <int R3>
__global__ void __launch_bounds__(kAnaThreads, 2)
wola_analysis_kernel(const float* __restrict__ x,
                     const float* __restrict__ tail,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     float2* __restrict__ spec, float* __restrict__ mag,
                     int C, int T, int G, int cpb, float scale) {
  // the frame's size is the template's, so that every offset of the
  // register FFT is an immediate
  constexpr int n = 256 * R3;
  constexpr int hop = n / 2;
  constexpr int tpf = n / bf_fft::kPts;       // threads per frame
  constexpr int ld = bf_fft::padded(n);
  extern __shared__ float2 sh[];
  const int g = threadIdx.x / tpf;
  const int j = threadIdx.x - g * tpf;
  const int t = blockIdx.x;
  const int P = (C + 1) / 2;
  constexpr int nb = hop + 2;
  const size_t S = (size_t)T * hop;
  float* acc = reinterpret_cast<float*>(sh + G * ld);   // nb, with mag
  const int chunk0 = blockIdx.y * cpb;
  const int chunk1 = min(chunk0 + cpb, (P + G - 1) / G);
  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int p = chunk * G + g;
    float2 v[bf_fft::kPts];
    if (p < P) {
      // points j + s n / 16: the first half from hop t of [tail | x], the
      // second from hop t + 1
      const int c0 = 2 * p;
      const bool pair = c0 + 1 < C;
      const float* lo0 = t == 0 ? tail + (size_t)c0 * hop
                                : x + c0 * S + (size_t)(t - 1) * hop;
      const float* hi0 = x + c0 * S + (size_t)t * hop;
      const size_t dlo = t == 0 ? hop : S;    // to the pair's second row
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
    if (chunk > chunk0) __syncthreads();      // the last split read sh
    bf_fft::fft<R3>(v, sh + g * ld, tw, j);
    // the split: the thread of bin k takes it for every pair of the chunk
    const int npair = min(G, P - chunk * G);
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      float m = (mag != nullptr && chunk > chunk0) ? acc[k] : 0.f;
      const int pk = bf_fft::pad(k), pm = bf_fft::pad((n - k) & (n - 1));
      for (int q = 0; q < npair; ++q) {
        const float2 z = sh[q * ld + pk];
        const float2 zm = sh[q * ld + pm];
        const float2 a = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
        const float2 b = make_float2(0.5f * (z.y + zm.y),
                                     -0.5f * (z.x - zm.x));
        const int c = 2 * (chunk * G + q);
        float2* out = spec + ((size_t)t * C + c) * nb + k;
        out[0] = a;
        if (c + 1 < C) out[nb] = b;
        if (mag != nullptr) {
          m += sqrtf(a.x * a.x + a.y * a.y);
          if (c + 1 < C) m += sqrtf(b.x * b.x + b.y * b.y);
        }
      }
      if (mag != nullptr) {
        if (chunk + 1 == chunk1) mag[(size_t)t * nb + k] = m * scale;
        else acc[k] = m;
      }
    }
  }
}

// grid (T, C): y is (C, T, hop + 2) complex64 in the extended layout; out
// (C, T*hop) must be zero on entry; new_prev (C, hop) receives the second
// half of frame T-1.
__global__ void __launch_bounds__(kThreads)
wola_inv_kernel(const float2* __restrict__ y,
                const float* __restrict__ out_prev,
                const float* __restrict__ win, const float2* __restrict__ tw,
                float* __restrict__ out, float* __restrict__ new_prev,
                int C, int T, int hop, int log2n) {
  extern __shared__ float2 s[];
  const int h = hop;
  const int n = 2 * h;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const float2* yc = y + ((size_t)c * T + t) * (h + 2);
  // fold (models/common.py fold_ext) + Hermitian mirror, in bit-reversed
  // order for the DIT stages
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int kk = (k <= h) ? k : n - k;
    float2 v = yc[kk];
    if (kk == h - 1) {
      const float2 sh = yc[h + 1];
      v = make_float2(0.5f * (v.x + sh.x), 0.5f * (v.y - sh.y));
    }
    if (kk == 0 || kk == h) v.y = 0.0f;
    if (k > h) v.y = -v.y;
    s[bitrev(k, log2n)] = v;
  }
  __syncthreads();
  bf_band::synthesize_frame(s, tw, win, out_prev + (size_t)c * h,
                            out + (size_t)c * T * h, new_prev + (size_t)c * h,
                            T, h, log2n, t);
}

template <int R3>
cudaError_t launch_analysis(const float* x, const float* tail,
                            const float* win, const float2* tw,
                            float2* spec, float* mag, int C, int T,
                            cudaStream_t st) {
  constexpr int n = 256 * R3;
  constexpr int tpf = n / bf_fft::kPts;
  const int P = (C + 1) / 2;
  // pairs a block holds at once
  const int G = P < kAnaThreads / tpf ? P : kAnaThreads / tpf;
  const int chunks = (P + G - 1) / G;
  // one block walks every chunk of its frame: fewer, longer blocks, whose
  // loads overlap the last chunk's stores; with mag it must (the sum over
  // channels stays in one thread). Without mag and with few frames each
  // chunk is its own block, so that the grid still fills the card.
  const int cpb = (mag != nullptr || T >= kWalkFrames) ? chunks : 1;
  const size_t smem = sizeof(float2) * G * bf_fft::padded(n)
                      + (mag != nullptr ? sizeof(float) * (n / 2 + 2) : 0);
  dim3 grid(T, (chunks + cpb - 1) / cpb);
  wola_analysis_kernel<R3><<<grid, G * tpf, smem, st>>>(
      x, tail, win, tw, spec, mag, C, T, G, cpb, 1.0f / (float)(C * n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (C, T*hop), tail (C, hop), win (2*hop), tw the pass tables of
// kernels/wola.py analysis_plan (complex), spec (T, C, hop+2) complex64,
// mag (T, hop+2) or null. Returns the launch's cudaGetLastError().
int bf_wola_analysis(const float* x, const float* tail, const float* win,
                     const void* tw, void* spec, float* mag, int C, int T,
                     int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float2* t2 = (const float2*)tw;
  float2* sp = (float2*)spec;
  switch (2 * hop) {
    case 256: return (int)launch_analysis<1>(x, tail, win, t2, sp, mag, C, T, st);
    case 512: return (int)launch_analysis<2>(x, tail, win, t2, sp, mag, C, T, st);
    case 1024: return (int)launch_analysis<4>(x, tail, win, t2, sp, mag, C, T, st);
    case 2048: return (int)launch_analysis<8>(x, tail, win, t2, sp, mag, C, T, st);
    case 4096: return (int)launch_analysis<16>(x, tail, win, t2, sp, mag, C, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y (C, T, hop+2) complex64, out_prev (C, hop), win (2*hop), tw (hop)
// complex; out (C, T*hop), new_prev (C, hop).
int bf_wola_synthesis(const void* y, const float* out_prev, const float* win,
                      const void* tw, float* out, float* new_prev, int C,
                      int T, int hop, void* stream) {
  const int n = 2 * hop;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)C * T * hop *
                                    sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T, C);
  wola_inv_kernel<<<grid, kThreads, n * sizeof(float2), st>>>(
      (const float2*)y, out_prev, win, (const float2*)tw, out, new_prev, C,
      T, hop, ilog2(n));
  return (int)cudaGetLastError();
}

}  // extern "C"
