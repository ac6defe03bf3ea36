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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
__device__ void fft_inplace(float2* s, const float2* __restrict__ tw, int n,
                            int log2n, bool inverse) {
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
  const float* x0 = x + (size_t)c0 * T * hop;
  const float* x1 = x0 + (size_t)T * hop;
  const float* t0 = tail + (size_t)c0 * hop;
  const float* t1 = t0 + hop;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int e = t * hop + i;               // index into [tail | x]
    const float w = win[i];
    const float v0 = (e < hop) ? t0[e] : x0[e - hop];
    const float v1 = !pair ? 0.0f : (e < hop) ? t1[e] : x1[e - hop];
    s[bitrev(i, log2n)] = make_float2(v0 * w, v1 * w);
  }
  __syncthreads();
  fft_inplace(s, tw, n, log2n, false);
  const int nb = hop + 2;
  float2* out = spec + ((size_t)t * C + c0) * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    const float2 z = s[k];
    const float2 m = s[(n - k) & (n - 1)];
    out[k] = make_float2(0.5f * (z.x + m.x), 0.5f * (z.y - m.y));
    if (pair) {
      out[nb + k] = make_float2(0.5f * (z.y + m.y), -0.5f * (z.x - m.x));
    }
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
  fft_inplace(s, tw, n, log2n, true);
  const float inv_n = 1.0f / (float)n;       // exact: n is a power of two
  float* oc = out + (size_t)c * T * h;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float p = s[i].x * inv_n * win[i];
    if (i < h) {
      atomicAdd(oc + (size_t)t * h + i, p);
    } else if (t + 1 < T) {
      atomicAdd(oc + (size_t)(t + 1) * h + (i - h), p);
    } else {
      new_prev[(size_t)c * h + (i - h)] = p;
    }
  }
  if (t == 0) {
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      atomicAdd(oc + i, out_prev[(size_t)c * h + i]);
  }
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
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
