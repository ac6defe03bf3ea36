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
// The synthesis is latency-bound at one channel (1,407 frames of nfft 2048
// are ~17 MB, 0.005 ms of bytes); at 16 channels its byte bound is 0.083
// ms (277 MB). It runs the
// inverse real FFT on the register FFT at half length (reg_irfft.cuh: fold
// and pre-twiddle on load, one complex FFT of nfft / 2 points, the even and
// odd samples as its real and imaginary parts; at nfft 256, below the
// register FFT's smallest size, the full-length transform of the Hermitian
// mirror). A block owns a few consecutive frames of one channel and
// recomputes the one before them, so it writes its hops whole with plain
// stores: one launch, no atomics, no zeroed output, and each sample the
// same two addends in the same order wherever a call starts. The radix-2
// stages of band_wola.cuh, which this kernel ran before (six barriered
// rounds on a bit-reversed frame of nfft points), still serve the fused
// kernels' synthesis.
//
// Twiddles and the window come from tables computed in float64 on the host
// and cast to float32. No fast-math intrinsics: the budget is 1e-5 of peak.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reg_fft.cuh"
#include "reg_irfft.cuh"

namespace {

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
// mag, mag[t, k] = scale * sum_c |X_c[k]|, summed in channel order; with
// kStreams, the channels form C / CG streams of CG channels and mag[t, g,
// k] sums stream g's channels, in channel order, a block's chunks starting
// at a stream's first channel (one stream takes the kernel without
// kStreams, whose split loop keeps the single sum).
template <int R3, bool kStreams>
__global__ void __launch_bounds__(kAnaThreads, 2)
wola_analysis_kernel(const float* __restrict__ x,
                     const float* __restrict__ tail,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     float2* __restrict__ spec, float* __restrict__ mag,
                     int C, int CG, int T, int G, int cpb, float scale) {
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
    // the stream of the chunk's first channel, and where it ends
    const int g0 = kStreams ? 2 * chunk * G / CG : 0;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      float m = (mag != nullptr && chunk > chunk0) ? acc[k] : 0.f;
      int si = g0, gend = (g0 + 1) * CG;        // the stream in progress
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
        if (mag != nullptr && !kStreams) {
          m += sqrtf(a.x * a.x + a.y * a.y);
          if (c + 1 < C) m += sqrtf(b.x * b.x + b.y * b.y);
        } else if (mag != nullptr) {
          // a stream's sum is written at its last channel
          m += sqrtf(a.x * a.x + a.y * a.y);
          if (c + 1 == gend) {
            mag[((size_t)t * (C / CG) + si++) * nb + k] = m * scale;
            m = 0.f;
            gend += CG;
          }
          if (c + 1 < C) {
            m += sqrtf(b.x * b.x + b.y * b.y);
            if (c + 2 == gend) {
              mag[((size_t)t * (C / CG) + si++) * nb + k] = m * scale;
              m = 0.f;
              gend += CG;
            }
          }
        }
      }
      if (mag != nullptr && !kStreams) {
        if (chunk + 1 == chunk1) mag[(size_t)t * nb + k] = m * scale;
        else acc[k] = m;
      } else if (mag != nullptr && chunk + 1 < chunk1) {
        acc[k] = m;
      }
    }
  }
}

// Threads a synthesis block: 256, or four frames' groups where a frame
// takes more than 64 threads (nfft 4096).
template <int R3>
__host__ __device__ constexpr int syn_threads() {
  return 16 * R3 > 64 ? 4 * 16 * R3 : 256;
}

// grid (ceil(T / G), C): block (b, c) owns frames t0 .. t0 + G - 1 (t0 =
// b G) of channel c and writes their hops with plain stores. Its NG = G + 1
// groups of n' / 16 threads each transform one frame, frame t0 - 1 + g,
// on the register FFT of n' = 256 R3 points: the half-length inverse
// (reg_irfft.cuh) for nfft = 2 n' (kHalf), the full-length one at nfft
// 256. Group 0 recomputes frame t0 - 1, whose second half overlaps hop t0;
// at t0 = 0 the carry out_prev takes its place. Hop t is then
// win[i] x_t[i] + win[hop + i] x_{t-1}[hop + i], the same two float32
// addends whichever block computes the frames, so the output does not
// depend on the grid or on where a call starts. y is (C, T, hop + 2)
// complex64 in the extended layout; out (C, T * hop); new_prev (C, hop)
// receives the second half of frame T - 1. tw holds the FFT's pass
// twiddles and, for kHalf, the pre-twiddles after them. Three blocks of
// 256 threads an SM: the register FFT then fits in 80 registers without
// spilling (at two blocks it took 128 and spilled 8 B), and 16 channels
// run 10% faster (0.1448 against 0.1603 ms at nfft 2048, 1,407 frames, on
// an H100).
template <int R3, bool kHalf>
__global__ void __launch_bounds__(syn_threads<R3>(),
                                  syn_threads<R3>() > 256 ? 1 : 3)
wola_inv_kernel(const float2* __restrict__ y,
                const float* __restrict__ out_prev,
                const float* __restrict__ win, const float2* __restrict__ tw,
                float* __restrict__ out, float* __restrict__ new_prev,
                int T) {
  constexpr int np = 256 * R3;                // FFT points
  constexpr int hop = kHalf ? np : np / 2;
  constexpr int tpf = np / bf_fft::kPts;      // threads a frame
  constexpr int G = syn_threads<R3>() / tpf - 1;
  constexpr int ld = bf_fft::padded(np);
  constexpr int half = hop / 2;               // sample pairs a hop
  // rows of the pass table (kernels/wola.py analysis_plan at np points)
  constexpr int pass_rows = 256 + (R3 > 1 ? 256 * R3 : 0);
  constexpr float inv_n = 1.0f / (float)(2 * hop);  // exact: a power of two
  extern __shared__ float2 sh[];
  const int g = threadIdx.x / tpf;
  const int j = threadIdx.x - g * tpf;
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * G;
  const int t = t0 - 1 + g;
  float2 v[bf_fft::kPts];
  if (t >= 0 && t < T) {
    const float2* yt = y + ((size_t)c * T + t) * (hop + 2);
    if constexpr (kHalf) bf_irfft::load_packed<R3>(yt, tw + pass_rows, j, v);
    else bf_irfft::load_full256(yt, j, v);
  } else {
#pragma unroll
    for (int s = 0; s < bf_fft::kPts; ++s) v[s] = make_float2(0.f, 0.f);
  }
  bf_fft::fft<R3>(v, sh + g * ld, tw, j);    // ends with a barrier
  auto pair = [&](int grp, int p) {
    const float2* z = sh + grp * ld;
    return kHalf ? bf_irfft::half_pair(z, p, inv_n)
                 : bf_irfft::full_pair(z, p, inv_n);
  };
  const float2* win2 = reinterpret_cast<const float2*>(win);
  float* oc = out + (size_t)c * T * hop;
  const int nown = min(G, T - t0);
  for (int q = threadIdx.x; q < nown * half; q += blockDim.x) {
    const int f = q / half + 1;               // the group of frame t0 + f - 1
    const int p = q - (f - 1) * half;
    const int tf = t0 + f - 1;
    const float2 wa = __ldg(win2 + p), wb = __ldg(win2 + half + p);
    const float2 a = pair(f, p);
    float2 b;
    if (tf == 0) {
      const float* pc = out_prev + (size_t)c * hop + 2 * p;
      b = make_float2(__ldg(pc), __ldg(pc + 1));   // any alignment
    } else {
      const float2 x = pair(f - 1, half + p);
      b = make_float2(__fmul_rn(x.x, wb.x), __fmul_rn(x.y, wb.y));
    }
    reinterpret_cast<float2*>(oc + (size_t)tf * hop)[p] =
        make_float2(__fadd_rn(__fmul_rn(a.x, wa.x), b.x),
                    __fadd_rn(__fmul_rn(a.y, wa.y), b.y));
  }
  if (T - 1 - t0 < G) {                       // this block owns frame T - 1
    const int f = T - t0;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const float2 wb = __ldg(win2 + half + p);
      const float2 x = pair(f, half + p);
      reinterpret_cast<float2*>(new_prev + (size_t)c * hop)[p] =
          make_float2(__fmul_rn(x.x, wb.x), __fmul_rn(x.y, wb.y));
    }
  }
}

template <int R3, bool kHalf>
cudaError_t launch_synthesis(const float2* y, const float* out_prev,
                             const float* win, const float2* tw, float* out,
                             float* new_prev, int C, int T, cudaStream_t st) {
  constexpr int threads = syn_threads<R3>();
  constexpr int tpf = 16 * R3;
  constexpr int G = threads / tpf - 1;
  constexpr size_t smem =
      sizeof(float2) * (threads / tpf) * bf_fft::padded(256 * R3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wola_inv_kernel<R3, kHalf>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + G - 1) / G, C);
  wola_inv_kernel<R3, kHalf><<<grid, threads, smem, st>>>(
      y, out_prev, win, tw, out, new_prev, T);
  return cudaGetLastError();
}

template <int R3>
cudaError_t launch_analysis(const float* x, const float* tail,
                            const float* win, const float2* tw,
                            float2* spec, float* mag, int C, int CG, int T,
                            cudaStream_t st) {
  constexpr int n = 256 * R3;
  constexpr int tpf = n / bf_fft::kPts;
  const int P = (C + 1) / 2;
  // pairs a block holds at once
  const int G = P < kAnaThreads / tpf ? P : kAnaThreads / tpf;
  const int chunks = (P + G - 1) / G;
  // one block walks every chunk of its frame: fewer, longer blocks, whose
  // loads overlap the last chunk's stores; with mag it must walk at least
  // a stream's chunks (the sum over a stream's channels stays in one
  // thread), and walks exactly those where a stream is whole chunks, or
  // one chunk where a chunk holds whole streams. Without mag and with few
  // frames each chunk is its own block, so that the grid still fills the
  // card.
  int cpb = (mag != nullptr || T >= kWalkFrames) ? chunks : 1;
  const bool streams = mag != nullptr && CG < C;
  if (streams) {
    if (CG % (2 * G) == 0) cpb = CG / (2 * G);
    else if ((2 * G) % CG == 0) cpb = 1;
  }
  const size_t smem = sizeof(float2) * G * bf_fft::padded(n)
                      + (mag != nullptr ? sizeof(float) * (n / 2 + 2) : 0);
  dim3 grid(T, (chunks + cpb - 1) / cpb);
  if (streams)
    wola_analysis_kernel<R3, true><<<grid, G * tpf, smem, st>>>(
        x, tail, win, tw, spec, mag, C, CG, T, G, cpb,
        1.0f / (float)(CG * n));
  else
    wola_analysis_kernel<R3, false><<<grid, G * tpf, smem, st>>>(
        x, tail, win, tw, spec, mag, C, CG, T, G, cpb,
        1.0f / (float)(CG * n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (C, T*hop), tail (C, hop), win (2*hop), tw the pass tables of
// kernels/wola.py analysis_plan (complex), spec (T, C, hop+2) complex64,
// mag (T, C / CG, hop+2) or null: the gate statistic of each stream of CG
// channels (CG divides C). Returns the launch's cudaGetLastError().
int bf_wola_analysis(const float* x, const float* tail, const float* win,
                     const void* tw, void* spec, float* mag, int C, int CG,
                     int T, int hop, void* stream) {
  if (C < 1 || CG < 1 || C % CG) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* t2 = (const float2*)tw;
  float2* sp = (float2*)spec;
#define BF_ANA(R3) \
  (int)launch_analysis<R3>(x, tail, win, t2, sp, mag, C, CG, T, st)
  switch (2 * hop) {
    case 256: return BF_ANA(1);
    case 512: return BF_ANA(2);
    case 1024: return BF_ANA(4);
    case 2048: return BF_ANA(8);
    case 4096: return BF_ANA(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BF_ANA
}

// y (C, T, hop+2) complex64, out_prev (C, hop), win (2*hop), tw the tables
// of kernels/wola.py synthesis_plan (complex: the pass twiddles, then for
// nfft >= 512 the pre-twiddles); out (C, T*hop), new_prev (C, hop). One
// launch; returns its cudaGetLastError().
int bf_wola_synthesis(const void* y, const float* out_prev, const float* win,
                      const void* tw, float* out, float* new_prev, int C,
                      int T, int hop, void* stream) {
  if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* y2 = (const float2*)y;
  const float2* t2 = (const float2*)tw;
#define BF_SYN(R3, HALF)                                                    \
  (int)launch_synthesis<R3, HALF>(y2, out_prev, win, t2, out, new_prev, C, \
                                  T, st)
  switch (2 * hop) {
    case 256: return BF_SYN(1, false);
    case 512: return BF_SYN(1, true);
    case 1024: return BF_SYN(2, true);
    case 2048: return BF_SYN(4, true);
    case 4096: return BF_SYN(8, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BF_SYN
}

}  // extern "C"
