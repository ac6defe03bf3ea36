// Phase-mask, MPF and MCRA kernels for Hopper (sm_90a), bound with ctypes.
//
// phase_mask_kernel replaces beamform_tpu/kernels/phase_mask.py:_phase_kernel
// (reached through phase_mask_pallas). Per (frame t, bin b), with the
// steering row u = w_idx[t] (phase.cpp:70-134):
//
//   a_m   = conj(w[u, m, b]) * x[t, m, b]          aligned product per mic
//   phi_m = atan2(Im a_m, Re a_m)
//   diff  = mean over the M(M-1)/2 pairs of |phi_i - phi_j|, wrapped
//           (d > pi -> 2 pi - d)
//   mag   = mean over mics of |x[t, m, b]|
//   y     = (mag / nfft > mag_threshold && diff < min_phase ? mag
//            : mag * mag_mult) * x0 / |x0|,   y[t, 0] = x[t, 0, 0]
//
// mpf_beams_kernel and mpf_march_kernel replace phase_mask.py:_mpf_kernel
// (reached through phasempf_march_pallas): the same front end and the dual
// SOI / interference beams (phasempf.cpp:210-248), written per (t, b) as
// four planes (SOI magnitude, interference power, mic 0's unit phase), then
// the buggy frequency smoothing (bin 1 x 0.75, bin 0 = |X0[0]|,
// phasempf.cpp:144-153) and the per-frame MCRA + MPF march
// (phasempf.cpp:140-191, 255-295) with the state in registers. One call of
// the wrapper is the two launches.
//
// mcra_march_kernel replaces the lax.scan of beamform_tpu/models/mcra.py,
// which has no Pallas kernel: the MCRA recurrence (mcra.cpp:95-124) per bin
// over the frames and the spectral subtraction at mic 0's phase
// (mcra.cpp:125-127). It shares mcra_step with mpf_march_kernel: the same
// algebra with |X|^2 in the place of the SOI power.
//
// What bounds them on this card. The front end reads the spectra once
// (T*M*NB*8 bytes: 185 MB at the main shape, 16 mics x 1026 bins x 1407
// frames) and does ~1,000 float32 operations per (t, b) (16 atan2 and 120
// pair terms), so it is bound by bytes, ~0.055 ms at 3.35 TB/s. Design: one
// thread per (t, b), consecutive threads on consecutive bins, so each mic's
// load is coalesced over the (T, M, NB) layout; the thread reads its own
// steering row through w_idx (no per-frame weight tensor is gathered); the
// M aligned phases stay in registers (the mic loop is unrolled to MAXM, a
// template parameter, so they are registers and not local memory) and the
// pairs are walked there; the output phase is x0 / |x0|, no trigonometry.
// atan2 is CUDA's atan2f (at most 3 ulp), not a port of the TPU kernel's
// Cephes polynomial: either rounds differently from torch.atan2, and a
// binary mask flips only where a bin's mean pair distance lies within
// ~1e-6 rad of the threshold.
//
// The marches are bound by latency, not bytes: NB independent bins (1026)
// each walk T dependent frames, and only ~9 blocks' worth of threads exist.
// The design keeps the march out of the front end's launch, so the front
// end fills all 132 SMs; one warp per block spreads the bins over 33 SMs;
// each thread loads the inputs of kAhead frames before it steps through
// them, so kAhead loads are in flight instead of one. The intermediate
// planes (4 x T x NB float32, 23 MB at the main shape) fit in the 50 MB L2.
//
// The state is float32 rows, one per field; current_L and first_L (scalars
// of the reference) are repeated in every bin, and each thread keeps its
// own copy, as the TPU kernel does. A w_idx entry outside [0, U) is never
// dereferenced: its frame's outputs are NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinThreads = 128;   // bins per block, (frame, bin) kernels
constexpr int kMarchThreads = 32;  // bins per block, marches
constexpr int kAhead = 8;          // frames a march loads ahead
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kOnlyNoise = 1, kOnlyMcra = 2, kDcZero = 4;

struct FrontCoef {
  float inv_m, inv_pairs;
};

struct PhaseCoef {
  float min_phase_rad, mag_threshold, mag_mult, inv_nfft;
};

struct McraCoef {
  float a_s, one_m_a_s, a_d, one_m_a_d, a_d2, delta, big_l;
};

struct MpfCoef {
  McraCoef mc;
  float mpf_as, one_m_mpf_as, eta, gam, rev_c, amp, floor;
};

// Per (t, b): the mean wrapped pair distance of the aligned phases, the mean
// |x| over mics and x0 (phase_mask.py:_aligned_and_stats). xs and ws point
// at mic 0 of bin b; mic m is m * NB further.
template <int MAXM>
__device__ __forceinline__ void front_end(const float2* __restrict__ xs,
                                          const float2* __restrict__ ws,
                                          int M, int NB, FrontCoef c,
                                          float& diff_mean, float& mag_mean,
                                          float2& x0) {
  float ph[MAXM];
  float mag = 0.f;
  x0 = xs[0];
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
    ph[i] = 0.f;
    if (i < M) {
      const float2 x = xs[(size_t)i * NB];
      const float2 w = ws[(size_t)i * NB];
      ph[i] = atan2f(w.x * x.y - w.y * x.x, w.x * x.x + w.y * x.y);
      mag += sqrtf(x.x * x.x + x.y * x.y);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAXM - 1; ++i) {
#pragma unroll
    for (int j = i + 1; j < MAXM; ++j) {
      if (j < M) {
        const float d = fabsf(ph[i] - ph[j]);
        acc += d > kPi ? kTwoPi - d : d;
      }
    }
  }
  diff_mean = acc * c.inv_pairs;
  mag_mean = mag * c.inv_m;
}

// x / |x|, and 1 where x is 0: cos and sin of atan2(x) without trigonometry
__device__ __forceinline__ float2 unit_phase(float2 x) {
  const float a = sqrtf(x.x * x.x + x.y * x.y);
  if (a > 0.f) {
    const float inv = 1.f / a;
    return make_float2(x.x * inv, x.y * inv);
  }
  return make_float2(1.f, 0.f);
}

// One MCRA step of one bin (mcra.cpp:95-124); cur_l and first_l are the
// reference's scalars, as floats.
__device__ __forceinline__ void mcra_step(float& s_prev, float& s_tmp,
                                          float& s_min, float& lam,
                                          float& cur_l, float& first_l,
                                          float s_f, float sq,
                                          const McraCoef& c) {
  const float s = c.a_s * s_prev + c.one_m_a_s * s_f;
  const bool roll = cur_l > c.big_l;
  s_min = roll ? fminf(s_tmp, s) : fminf(s_min, s);
  s_tmp = roll ? s : fminf(s_tmp, s);
  cur_l = roll ? 1.f : cur_l + 1.f;
  first_l = roll ? 0.f : first_l;
  const bool first = first_l > 0.f;
  const float inv_l = 1.f / cur_l;
  if (first || s < s_min * c.delta || lam > sq) {
    lam = (first && inv_l > c.a_d) ? inv_l * lam + (1.f - inv_l) * sq
                                   : c.a_d2 * lam + c.one_m_a_d * sq;
  }
  s_prev = s;
}

// grid T * nbb blocks (nbb = ceil(NB / kBinThreads)): block -> (t, bins)
template <int MAXM>
__global__ void __launch_bounds__(kBinThreads)
    phase_mask_kernel(const float2* __restrict__ spec,
                      const float2* __restrict__ w,
                      const int64_t* __restrict__ w_idx,
                      float2* __restrict__ y, int M, int NB, int U, int nbb,
                      FrontCoef fc, PhaseCoef c) {
  const int t = blockIdx.x / nbb;
  const int b = (blockIdx.x % nbb) * kBinThreads + threadIdx.x;
  if (b >= NB) return;
  const int64_t u = w_idx[t];
  float2* out = y + (size_t)t * NB + b;
  if (u < 0 || u >= U) {
    const float nan = __int_as_float(0x7fc00000);
    *out = make_float2(nan, nan);
    return;
  }
  float diff, mag;
  float2 x0;
  front_end<MAXM>(spec + (size_t)t * M * NB + b, w + (size_t)u * M * NB + b,
                  M, NB, fc, diff, mag, x0);
  if (b == 0) {                                   // phase.cpp:87
    *out = x0;
    return;
  }
  const bool keep = mag * c.inv_nfft > c.mag_threshold &&
                    diff < c.min_phase_rad;
  const float m = keep ? mag : mag * c.mag_mult;
  const float2 e = unit_phase(x0);
  *out = make_float2(m * e.x, m * e.y);
}

// planes (4, T, NB): SOI magnitude; interference power (0 at bin 0);
// mic 0's unit phase, re and im (X0[0] itself at bin 0)
template <int MAXM>
__global__ void __launch_bounds__(kBinThreads)
    mpf_beams_kernel(const float2* __restrict__ spec,
                     const float2* __restrict__ w,
                     const int64_t* __restrict__ w_idx,
                     float* __restrict__ planes, int M, int T, int NB, int U,
                     int nbb, FrontCoef fc, float min_phase_rad,
                     float min_mag) {
  const int t = blockIdx.x / nbb;
  const int b = (blockIdx.x % nbb) * kBinThreads + threadIdx.x;
  if (b >= NB) return;
  const size_t o = (size_t)t * NB + b;
  const size_t plane = (size_t)T * NB;
  const int64_t u = w_idx[t];
  if (u < 0 || u >= U) {
    const float nan = __int_as_float(0x7fc00000);
    for (int k = 0; k < 4; ++k) planes[k * plane + o] = nan;
    return;
  }
  float diff, mag;
  float2 x0;
  front_end<MAXM>(spec + (size_t)t * M * NB + b, w + (size_t)u * M * NB + b,
                  M, NB, fc, diff, mag, x0);
  const bool is_soi = diff < min_phase_rad;
  const float soi_mag = is_soi ? mag : mag * min_mag;
  const float int_mag = is_soi ? mag * min_mag : mag;
  const float2 e = b == 0 ? x0 : unit_phase(x0);
  planes[o] = soi_mag;
  planes[plane + o] = b == 0 ? 0.f : int_mag * int_mag;
  planes[2 * plane + o] = e.x;
  planes[3 * plane + o] = e.y;
}

// one thread per bin over the T frames; rows (9, NB): s_prev, s_tmp, s_min,
// lam_noise, z, lam_rev0, lam_rev1, current_L, first_L
__global__ void __launch_bounds__(kMarchThreads)
    mpf_march_kernel(const float* __restrict__ planes,
                     const float* __restrict__ rows_in,
                     float2* __restrict__ y, float* __restrict__ rows_out,
                     int T, int NB, MpfCoef c, int flags) {
  const int b = blockIdx.x * kMarchThreads + threadIdx.x;
  if (b >= NB) return;
  const size_t plane = (size_t)T * NB;
  float st[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) st[r] = rows_in[(size_t)r * NB + b];
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    float soi_mag[kAhead], int_sq[kAhead], er[kAhead], ei[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        const size_t o = (size_t)(t0 + k) * NB + b;
        soi_mag[k] = planes[o];
        int_sq[k] = planes[plane + o];
        er[k] = planes[2 * plane + o];
        ei[k] = planes[3 * plane + o];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        const float soi_sq = b == 0 ? 0.f : soi_mag[k] * soi_mag[k];
        const float s_f = b == 0 ? sqrtf(er[k] * er[k] + ei[k] * ei[k])
                          : b == 1 ? soi_sq * 0.75f : soi_sq;
        mcra_step(st[0], st[1], st[2], st[3], st[7], st[8], s_f, soi_sq,
                  c.mc);
        st[4] = c.mpf_as * st[4] + c.one_m_mpf_as * int_sq[k];
        const float leak = c.eta * st[4];
        st[5] = c.gam * st[5] + c.rev_c * soi_sq;
        st[6] = c.gam * st[6] + c.rev_c * int_sq[k];
        const float lam = sqrtf(st[3] + leak + st[5] + st[6]);
        float mag;
        if (flags & kOnlyNoise) {
          mag = lam * c.amp;
        } else {
          mag = (soi_mag[k] - ((flags & kOnlyMcra) ? sqrtf(st[3]) : lam)) *
                c.amp;
          if (mag < 0.f) mag = c.floor;
        }
        float2 out = make_float2(mag * er[k], mag * ei[k]);
        if (b == 0)
          out = (flags & kDcZero) ? make_float2(0.f, 0.f)
                                  : make_float2(er[k], ei[k]);
        y[(size_t)(t0 + k) * NB + b] = out;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 9; ++r) rows_out[(size_t)r * NB + b] = st[r];
}

// one thread per bin over the T frames; rows (6, NB): s_prev, s_tmp, s_min,
// lam, current_L, first_L
__global__ void __launch_bounds__(kMarchThreads)
    mcra_march_kernel(const float* __restrict__ s_f,
                      const float* __restrict__ sq,
                      const float2* __restrict__ x,
                      const float* __restrict__ rows_in,
                      float2* __restrict__ y, float* __restrict__ rows_out,
                      int T, int NB, McraCoef c, float amp, int flags) {
  const int b = blockIdx.x * kMarchThreads + threadIdx.x;
  if (b >= NB) return;
  float st[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) st[r] = rows_in[(size_t)r * NB + b];
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    float f[kAhead], p[kAhead];
    float2 xv[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        const size_t o = (size_t)(t0 + k) * NB + b;
        f[k] = s_f[o];
        p[k] = sq[o];
        xv[k] = x[o];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        mcra_step(st[0], st[1], st[2], st[3], st[4], st[5], f[k], p[k], c);
        const float noise = sqrtf(st[3]);
        const float mx = sqrtf(xv[k].x * xv[k].x + xv[k].y * xv[k].y);
        const float mag =
            (flags & kOnlyNoise) ? noise * amp : fmaxf(mx - noise, 0.f) * amp;
        const float2 e = unit_phase(xv[k]);
        float2 out = make_float2(mag * e.x, mag * e.y);
        if (b == 0)
          out = (flags & kDcZero) ? make_float2(0.f, 0.f) : xv[k];
        y[(size_t)(t0 + k) * NB + b] = out;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) rows_out[(size_t)r * NB + b] = st[r];
}

FrontCoef front_coef(int M) {
  return FrontCoef{(float)(1.0 / M), (float)(1.0 / (M * (M - 1) / 2))};
}

McraCoef mcra_coef(const float* v) {
  return McraCoef{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
}

}  // namespace

extern "C" {

// spec (T, M, NB) complex64, w (U, M, NB) complex64, w_idx (T,) int64;
// y (T, NB) complex64. coef: min_phase_rad, mag_threshold, mag_mult,
// 1 / nfft. 2 <= M <= 32.
int bf_phase_mask(const void* spec, const void* w, const int64_t* w_idx,
                  void* y, int M, int T, int NB, int U, const float* coef,
                  void* stream) {
  if (M < 2 || M > 32 || T < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  const int nbb = (NB + kBinThreads - 1) / kBinThreads;
  const PhaseCoef c{coef[0], coef[1], coef[2], coef[3]};
  const FrontCoef fc = front_coef(M);
  cudaStream_t st = (cudaStream_t)stream;
  const float2* s = (const float2*)spec;
  const float2* wv = (const float2*)w;
  float2* out = (float2*)y;
  const dim3 grid((unsigned)T * nbb);
  if (M <= 4)
    phase_mask_kernel<4><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, out, M,
                                                       NB, U, nbb, fc, c);
  else if (M <= 8)
    phase_mask_kernel<8><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, out, M,
                                                       NB, U, nbb, fc, c);
  else if (M <= 16)
    phase_mask_kernel<16><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, out, M,
                                                        NB, U, nbb, fc, c);
  else
    phase_mask_kernel<32><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, out, M,
                                                        NB, U, nbb, fc, c);
  return (int)cudaGetLastError();
}

// spec, w, w_idx as bf_phase_mask; rows_in / rows_out (9, NB) float32;
// planes (4, T, NB) float32 scratch; y (T, NB) complex64. coef:
// min_phase_rad, min_mag, the 7 MCRA constants (alphaS, 1 - alphaS,
// alphaD, 1 - alphaD, alphaD2, delta, L), MPF alphaS, 1 - MPF alphaS,
// eta, gamma, 1 - gamma / delta, out_amp, noise_floor. flags: 1
// out_only_noise, 2 out_only_mcra, 4 bug_dc_zero.
int bf_mpf_march(const void* spec, const void* w, const int64_t* w_idx,
                 const float* rows_in, float* planes, void* y,
                 float* rows_out, int M, int T, int NB, int U,
                 const float* coef, int flags, void* stream) {
  if (M < 2 || M > 32 || T < 1 || NB < 2) return (int)cudaErrorInvalidValue;
  const int nbb = (NB + kBinThreads - 1) / kBinThreads;
  const FrontCoef fc = front_coef(M);
  const float mp = coef[0], mm = coef[1];
  const MpfCoef c{mcra_coef(coef + 2), coef[9], coef[10], coef[11],
                  coef[12], coef[13], coef[14], coef[15]};
  cudaStream_t st = (cudaStream_t)stream;
  const float2* s = (const float2*)spec;
  const float2* wv = (const float2*)w;
  const dim3 grid((unsigned)T * nbb);
  if (M <= 4)
    mpf_beams_kernel<4><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, planes,
                                                      M, T, NB, U, nbb, fc,
                                                      mp, mm);
  else if (M <= 8)
    mpf_beams_kernel<8><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, planes,
                                                      M, T, NB, U, nbb, fc,
                                                      mp, mm);
  else if (M <= 16)
    mpf_beams_kernel<16><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, planes,
                                                       M, T, NB, U, nbb, fc,
                                                       mp, mm);
  else
    mpf_beams_kernel<32><<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, planes,
                                                       M, T, NB, U, nbb, fc,
                                                       mp, mm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mpf_march_kernel<<<(NB + kMarchThreads - 1) / kMarchThreads, kMarchThreads,
                     0, st>>>(planes, rows_in, (float2*)y, rows_out, T, NB, c,
                              flags);
  return (int)cudaGetLastError();
}

// s_f, sq (T, NB) float32, x (T, NB) complex64, rows_in / rows_out (6, NB)
// float32; y (T, NB) complex64. coef: the 7 MCRA constants, out_amp. flags:
// 1 out_only_noise, 4 bug_dc_zero.
int bf_mcra_march(const float* s_f, const float* sq, const void* x,
                  const float* rows_in, void* y, float* rows_out, int T,
                  int NB, const float* coef, int flags, void* stream) {
  if (T < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  mcra_march_kernel<<<(NB + kMarchThreads - 1) / kMarchThreads,
                      kMarchThreads, 0, (cudaStream_t)stream>>>(
      s_f, sq, (const float2*)x, rows_in, (float2*)y, rows_out, T, NB,
      mcra_coef(coef), coef[7], flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
