// Fused WOLA analysis and synthesis for Hopper (sm_90a), bound with ctypes.
//
// wola_fwd_kernel replaces beamform_tpu/kernels/wola_pallas.py:_fwd_kernel
// (reached through rfft_hops_pallas / stft_planes): frame assembly from the
// previous and current hop, periodic sqrt-Hann window, nfft-point DFT, the
// full-DFT bin prefix 0..h+1 (bin h+1 is the shadow bin conj(X[h-1]) of the
// extended layout), and optionally the energy-gate statistic
// sum_c |X| / (C * nfft) (mvdr.cpp:79-82) in a second, deterministic pass.
//
// wola_inv_kernel replaces wola_pallas.py:_inv_kernel (reached through
// irfft_ola_batch_pallas / istft_ext_fused) together with the fold and
// Hermitian mirror that XLA runs before it (wola_pallas.py:417-423): the
// shadow blend at h-1, Re() at bins 0 and h, inverse DFT x 1/nfft,
// synthesis window and the 50% overlap-add with the one-hop carry out_prev.
//
// The work is bound by memory bytes, not arithmetic: at the main-path size
// (16 mics, 48 kHz, 30 s, hop 1024) the analysis reads about 92 MB of input
// and writes about 185 MB of extended spectra, a radix-2 FFT does only
// ~5 flop per byte moved. Design, simple first: one block holds one whole
// nfft-point complex frame in shared memory (16 KB at nfft 2048), loads
// coalesced samples straight from the natural (C, S) layout in bit-reversed
// order, runs the radix-2 stages two at a time in registers, and writes
// each output once. The analysis packs two real channels into one complex
// frame, so one FFT serves two channels. Blocks are independent, so the
// overlap-add, which the TPU carried across its sequential grid, is done
// with atomicAdd into a zeroed output: each output sample receives exactly
// two addends, and a + b == b + a, so the result does not depend on the
// order blocks run in.
//
// Twiddles and the window come from tables computed in float64 on the host
// and cast to float32. No fast-math intrinsics: the budget is 1e-5 of peak.
// The FFT, the split of a channel pair and the overlap-add are in
// band_wola.cuh, shared with the fused kernels (mega_stream.cu,
// gss_stream.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"

namespace {

using bf_band::kThreads;
using bf_band::bitrev;
using bf_band::ilog2;

// grid (T, ceil(C / 2)): one block transforms frame t of the channel pair
// (2p, 2p+1) as one complex signal z = x_2p + i x_2p+1 and splits the
// spectra: X_2p[k] = (Z[k] + conj(Z[n-k])) / 2 and
// X_2p+1[k] = (Z[k] - conj(Z[n-k])) / 2i. Frame t is samples
// [t*hop, t*hop + nfft) of [tail | x]; spec is (T, C, hop + 2) complex64.
// An odd last channel pairs with zeros.
__global__ void __launch_bounds__(kThreads)
wola_fwd_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                const float* __restrict__ win, const float2* __restrict__ tw,
                float2* __restrict__ spec, int C, int T, int hop,
                int log2n) {
  extern __shared__ float2 s[];
  const int n = 2 * hop;
  const int t = blockIdx.x;
  const int c0 = 2 * blockIdx.y;
  const bool pair = c0 + 1 < C;
  bf_band::analyze_pair(s, x, tail, win, tw, C, T, hop, log2n, t, c0);
  const int nb = hop + 2;
  float2* out = spec + ((size_t)t * C + c0) * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float2 a, b;
    bf_band::split_bin(s, n, k, a, b);
    out[k] = a;
    if (pair) out[nb + k] = b;
  }
}

// grid (ceil(nb / kThreads), T): mag[t, k] = scale * sum_c |spec[t, c, k]|,
// summed over channels in a fixed order (no atomics).
__global__ void __launch_bounds__(kThreads)
wola_mag_kernel(const float2* __restrict__ spec, float* __restrict__ mag,
                int C, int nb, float scale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (k >= nb) return;
  const float2* p = spec + (size_t)t * C * nb + k;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float2 v = p[(size_t)c * nb];
    acc += sqrtf(v.x * v.x + v.y * v.y);
  }
  mag[(size_t)t * nb + k] = acc * scale;
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

}  // namespace

extern "C" {

const char* bf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (C, T*hop), tail (C, hop), win (2*hop), tw (hop) complex, spec
// (T, C, hop+2) complex64, mag (T, hop+2) or null. Returns the launch's
// cudaGetLastError().
int bf_wola_analysis(const float* x, const float* tail, const float* win,
                     const void* tw, void* spec, float* mag, int C, int T,
                     int hop, void* stream) {
  const int n = 2 * hop;
  const int log2n = ilog2(n);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(T, (C + 1) / 2);
  wola_fwd_kernel<<<grid, kThreads, n * sizeof(float2), st>>>(
      x, tail, win, (const float2*)tw, (float2*)spec, C, T, hop, log2n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || mag == nullptr) return (int)err;
  const int nb = hop + 2;
  dim3 grid2((nb + kThreads - 1) / kThreads, T);
  wola_mag_kernel<<<grid2, kThreads, 0, st>>>(
      (const float2*)spec, mag, C, nb, 1.0f / (float)(C * n));
  return (int)cudaGetLastError();
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
