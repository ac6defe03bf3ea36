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
// mpf_beams_kernel and the MPF march replace phase_mask.py:_mpf_kernel
// (reached through phasempf_march_pallas): the same front end and the dual
// SOI / interference beams (phasempf.cpp:210-248), written per (t, b) as
// four planes (SOI magnitude, interference power, mic 0's unit phase), then
// the buggy frequency smoothing (bin 1 x 0.75, bin 0 = |X0[0]|,
// phasempf.cpp:144-153) and the per-frame MCRA + MPF march
// (phasempf.cpp:140-191, 255-295). One call of the wrapper is the two
// launches.
//
// The MCRA march replaces the lax.scan of beamform_tpu/models/mcra.py,
// which has no Pallas kernel: the MCRA recurrence (mcra.cpp:95-124) per bin
// over the frames and the spectral subtraction at mic 0's phase
// (mcra.cpp:125-127). Both marches are march.cuh's march_kernel, which
// holds the MCRA algebra once: MpfNode and McraNode give it their inputs,
// MPF's other recurrences and their outputs.
//
// What bounds them on this card. The front end reads the spectra once
// (T*M*NB*8 bytes: 185 MB at the main shape, 16 mics x 1026 bins x 1407
// frames), so it is bound by bytes, ~0.055 ms at 3.35 TB/s; its ~1,000
// float32 instructions a (t, b) at 16 mics (16 atan2, 120 pair terms)
// take about as long at full issue rate, so the design cuts instructions
// until the loads set the pace. One thread per (t, b) over a flat grid
// (no block of a frame's last few bins), consecutive threads on
// consecutive bins, so each mic's load is coalesced over the (T, M, NB)
// layout; the thread reads its own steering row through w_idx (no
// per-frame weight tensor is gathered) and puts all of its 2M loads in
// flight before the first atan2. The mic count is a template constant
// (4, 8, 16, 32, the main path's 16 among them): with a runtime count each
// of the 120 pair terms carried its own `j < M` guard, and the kernel ran
// 30% more instructions (2,280 SASS against 1,752) and 24% longer. Other
// counts run the next larger size with the guards. The M aligned phases
// stay in registers. atan2 is the TPU kernel's branch-free form (two range
// reductions, Cephes' odd polynomial of degree 9, the octant and quadrant
// as selects, IEEE signed zeros), its one division the reciprocal fast
// path with an exact fallback for a denominator outside [2^-125, 2^126);
// a pair's wrapped distance is min(|d|, 2 pi - |d|), d = phi_i - phi_j,
// summed as it is (four instructions a pair: the three-instruction form
// pi - |pi - |d|| with pairs x pi added once cancels where the masks
// decide, near 10 and 30 degrees, and was 13-20x further from float64
// than this sum at 16 and 32 mics). atan2 rounds otherwise than
// torch.atan2, in the last bits of the mean: a binary mask flips only
// where a bin's mean pair distance lies within ~1e-6 rad of the
// threshold. The output phase is x0 / |x0|, no
// trigonometry.
//
// The marches are bound by latency, not bytes: NB independent bins (1026)
// each walk T dependent frames. Only lam (lam_noise in MPF) depends on its
// own last value through a non-linear gate, so march.cuh keeps a frame's
// serial chain to lam alone (a multiply, an add and a select in one warp)
// and moves the loads, the other recurrences, the counter and the output to
// other warps of the block, a segment of 32 frames ahead or behind, through
// rings in shared memory. The march stays a launch of its own after the
// front end: the front end fills all 132 SMs, the march 33 (a block per 32
// bins), and the intermediate planes (4 x T x NB float32, 23 MB at the main
// shape) stay in the 50 MB L2.
//
// The state is float32 rows, one per field; current_L and first_L (scalars
// of the reference) are repeated in every bin, and read from bin 0. A w_idx
// entry outside [0, U) is never dereferenced: its frame's outputs are NaN.
//
// Streams. Each kernel serves B streams in one launch, as the JAX
// package's vmap gives each pallas_call a grid axis. The spectra are
// (T, B, M, NB), the B streams' analysis of one launch, read in place;
// w_idx (B, T) indexes one shared (U, M, NB) steering; the outputs are
// (B, T, NB), which the synthesis takes as B channels. The front ends'
// flat grid covers B T NB threads in the output's order; the marches' grid
// is (bin groups, B), and the state's vectors are (B, NB) with current_L
// and first_L (B,). MCRA's inputs are (T, B, NB), mic 0's analysis of the
// B streams, a frame's rows B NB apart. One stream (B = 1) is the same
// layout without the axis: each stream's output equals its own launch's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "atan2_fast.cuh"
#include "march.cuh"

namespace {

constexpr int kBinThreads = 128;   // bins per block, (frame, bin) kernels
using march::kLanes;
using march::kSeg;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kOnlyNoise = 1, kOnlyMcra = 2, kDcZero = 4;

struct FrontCoef {
  float inv_m, inv_pairs;   // 1 / M, 1 / (M (M - 1) / 2)
};

struct PhaseCoef {
  float min_phase_rad, mag_threshold, mag_mult, inv_nfft;
};

// Per (t, b): the mean wrapped pair distance of the aligned phases, the mean
// |x| over mics and x0 (phase_mask.py:_aligned_and_stats). xs and ws point
// at mic 0 of bin b; mic m is m * NB further. kExact: M == MAXM, no guards.
template <int MAXM, bool kExact>
__device__ __forceinline__ void front_end(const float2* __restrict__ xs,
                                          const float2* __restrict__ ws,
                                          int M, int NB, FrontCoef c,
                                          float& diff_mean, float& mag_mean,
                                          float2& x0) {
  float2 xv[MAXM], wv[MAXM];
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {            // every load in flight first
    xv[i] = make_float2(0.f, 0.f);
    wv[i] = xv[i];
    if (kExact || i < M) {
      xv[i] = __ldcs(xs + (size_t)i * NB);    // read once: evict first
      wv[i] = __ldg(ws + (size_t)i * NB);
    }
  }
  x0 = xv[0];
  float ph[MAXM];
  float mag = 0.f;
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
    const float2 x = xv[i], w = wv[i];
    ph[i] = 0.f;
    if (kExact || i < M) {
      ph[i] = bf_math::atan2_fast(w.x * x.y - w.y * x.x,
                                  w.x * x.x + w.y * x.y);
      mag += sqrtf(x.x * x.x + x.y * x.y);
    }
  }
  // sum of the wrapped pair distances
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAXM - 1; ++i) {
#pragma unroll
    for (int j = i + 1; j < MAXM; ++j) {
      if (kExact || j < M) {
        const float d = fabsf(ph[i] - ph[j]);
        acc += fminf(d, kTwoPi - d);
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

// Thread q of the flat grid takes (stream s, frame t, bin b), q = (s T +
// t) NB + b < B T NB: the output's (B, T, NB) order, consecutive threads
// on consecutive bins. One stream skips the second division.
__device__ __forceinline__ bool flat_stb(int B, int T, int NB, int& s,
                                         int& t, int& b) {
  const unsigned q = blockIdx.x * kBinThreads + threadIdx.x;
  if (q >= (unsigned)B * (unsigned)T * (unsigned)NB) return false;
  const unsigned r = q / (unsigned)NB;
  b = (int)(q - r * (unsigned)NB);
  if (B == 1) {
    s = 0;
    t = (int)r;
  } else {
    s = (int)(r / (unsigned)T);
    t = (int)(r - (unsigned)s * (unsigned)T);
  }
  return true;
}

template <int MAXM, bool kExact>
__global__ void __launch_bounds__(kBinThreads)
    phase_mask_kernel(const float2* __restrict__ spec,
                      const float2* __restrict__ w,
                      const int64_t* __restrict__ w_idx,
                      float2* __restrict__ y, int M, int T, int NB, int U,
                      int B, FrontCoef fc, PhaseCoef c) {
  int s, t, b;
  if (!flat_stb(B, T, NB, s, t, b)) return;
  const size_t st = (size_t)s * T + t;
  const int64_t u = w_idx[st];
  float2* out = y + st * NB + b;
  if (u < 0 || u >= U) {
    const float nan = __int_as_float(0x7fc00000);
    *out = make_float2(nan, nan);
    return;
  }
  float diff, mag;
  float2 x0;
  front_end<MAXM, kExact>(spec + ((size_t)t * B + s) * M * NB + b,
                          w + (size_t)u * M * NB + b, M, NB, fc, diff, mag,
                          x0);
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

// planes (4, B, T, NB): SOI magnitude; interference power (0 at bin 0);
// mic 0's unit phase, re and im (X0[0] itself at bin 0)
template <int MAXM, bool kExact>
__global__ void __launch_bounds__(kBinThreads)
    mpf_beams_kernel(const float2* __restrict__ spec,
                     const float2* __restrict__ w,
                     const int64_t* __restrict__ w_idx,
                     float* __restrict__ planes, int M, int T, int NB, int U,
                     int B, FrontCoef fc, float min_phase_rad,
                     float min_mag) {
  int s, t, b;
  if (!flat_stb(B, T, NB, s, t, b)) return;
  const size_t st = (size_t)s * T + t;
  const size_t o = st * NB + b;
  const size_t plane = (size_t)B * T * NB;
  const int64_t u = w_idx[st];
  if (u < 0 || u >= U) {
    const float nan = __int_as_float(0x7fc00000);
    for (int k = 0; k < 4; ++k) planes[k * plane + o] = nan;
    return;
  }
  float diff, mag;
  float2 x0;
  front_end<MAXM, kExact>(spec + ((size_t)t * B + s) * M * NB + b,
                          w + (size_t)u * M * NB + b, M, NB, fc, diff, mag,
                          x0);
  const bool is_soi = diff < min_phase_rad;
  const float soi_mag = is_soi ? mag : mag * min_mag;
  const float int_mag = is_soi ? mag * min_mag : mag;
  const float2 e = b == 0 ? x0 : unit_phase(x0);
  planes[o] = soi_mag;
  planes[plane + o] = b == 0 ? 0.f : int_mag * int_mag;
  planes[2 * plane + o] = e.x;
  planes[3 * plane + o] = e.y;
}

// Launch a front-end kernel at the mic count's size: ``launch(m, exact)``
// with integral constants, M a template constant at 4, 8, 16 and 32, the
// next larger size with guards otherwise.
template <class L>
cudaError_t by_mics(int M, L launch) {
  using std::integral_constant;
  constexpr std::true_type exact{};
  constexpr std::false_type guarded{};
  switch (M) {
    case 4: launch(integral_constant<int, 4>{}, exact); break;
    case 8: launch(integral_constant<int, 8>{}, exact); break;
    case 16: launch(integral_constant<int, 16>{}, exact); break;
    case 32: launch(integral_constant<int, 32>{}, exact); break;
    default:
      if (M < 4) launch(integral_constant<int, 4>{}, guarded);
      else if (M < 8) launch(integral_constant<int, 8>{}, guarded);
      else if (M < 16) launch(integral_constant<int, 16>{}, guarded);
      else launch(integral_constant<int, 32>{}, guarded);
  }
  return cudaGetLastError();
}

// The MPF march on the beams' planes (march.cuh's march_kernel). Inputs
// per (t, b): SOI magnitude, interference power, mic 0's unit phase (re,
// im); state vectors: s_prev, s_tmp, s_min, lam_noise, z, lam_rev0,
// lam_rev1. Beside the MCRA recurrence on the SOI power
// (bin 1 x 0.75 in s_f, bin 0's s_f |X0[0]|), the extra warp marches z,
// lam_rev0 and lam_rev1, none of which feeds lam_noise.
struct MpfNode {
  static constexpr int kInPlanes = 4, kVecs = 7;
  static constexpr bool kExtra = true;
  const float* planes;
  const float* vin[kVecs];
  const int* cur_in;
  const unsigned char* first_in;
  float2* y;
  float* vout[kVecs];
  int* cur_out;
  unsigned char* first_out;
  int T, NB, B;
  march::McraCoef c;
  float mpf_as, one_m_mpf_as, eta, gam, rev_c, amp, floor;
  int flags;

  // stream s's frames of the (4, B, T, NB) planes
  __device__ void load(float (*in)[kSeg][kLanes], int s, int t0, int nf,
                       int b0, int lane) const {
    const size_t plane = (size_t)B * T * NB;
    const float* row = planes + ((size_t)s * T + t0) * NB;
#pragma unroll
    for (int q = 0; q < kInPlanes; ++q)
      march::load_rows(in[q], row + q * plane, NB, NB, nf, b0, lane);
  }

  // bin 0's s_f, |X0[0]|, of frame k
  __device__ float dc(float (*in)[kSeg][kLanes], int k) const {
    const float er = in[2][k][0], ei = in[3][k][0];
    return __fsqrt_rn(__fadd_rn(__fmul_rn(er, er), __fmul_rn(ei, ei)));
  }

  __device__ static float soi_sq(float (*in)[kSeg][kLanes], int k, int col,
                                 int b) {
    const float m = in[0][k][col];
    return march::sel(b == 0, 0.f, __fmul_rn(m, m));
  }

  __device__ float sq_in(float (*in)[kSeg][kLanes], int k, int col,
                         int b) const {
    return soi_sq(in, k, col, b);
  }

  __device__ float sf_in(float (*in)[kSeg][kLanes], int k, int col, int b,
                         float dc0) const {
    const float p = soi_sq(in, k, col, b);
    return march::sel(b == 0, dc0, march::sel(b == 1, __fmul_rn(p, 0.75f), p));
  }

  __device__ float2 extra_in(float (*in)[kSeg][kLanes], int k, int col,
                             int b) const {
    return make_float2(soi_sq(in, k, col, b), in[1][k][col]);
  }

  // x: (SOI power, interference power); st[4..6]: z, lam_rev0, lam_rev1 ->
  // (leak, rev0, rev1) for out
  __device__ float4 extra_step(float2 x, float* st) const {
    st[4] = __fadd_rn(__fmul_rn(mpf_as, st[4]), __fmul_rn(one_m_mpf_as, x.y));
    st[5] = __fadd_rn(__fmul_rn(gam, st[5]), __fmul_rn(rev_c, x.x));
    st[6] = __fadd_rn(__fmul_rn(gam, st[6]), __fmul_rn(rev_c, x.y));
    return make_float4(__fmul_rn(eta, st[4]), st[5], st[6], 0.f);
  }

  // lambda = sqrt(lam_noise + leak + rev0 + rev1); the SOI magnitude less
  // it (or less sqrt(lam_noise), or lambda alone), floored, at mic 0's phase
  template <bool kExact>
  __device__ float2 out(float (*in)[kSeg][kLanes], float4 e, float lam,
                        int k, int col, int b, bool& ok) const {
    const float er = in[2][k][col], ei = in[3][k][col];
    const float l = march::sqrt_rn<kExact>(
        __fadd_rn(__fadd_rn(__fadd_rn(lam, e.x), e.y), e.z), ok);
    const float sub =
        (flags & kOnlyMcra) ? march::sqrt_rn<kExact>(lam, ok) : l;
    const float m = __fmul_rn(__fsub_rn(in[0][k][col], sub), amp);
    const float mag =
        (flags & kOnlyNoise) ? __fmul_rn(l, amp) : (m < 0.f ? floor : m);
    const float2 dc = (flags & kDcZero) ? make_float2(0.f, 0.f)
                                        : make_float2(er, ei);
    return b == 0 ? dc : make_float2(__fmul_rn(mag, er), __fmul_rn(mag, ei));
  }
};

// The MCRA march (march.cuh's march_kernel). Inputs per (t, s, b), each
// (T, B, NB): s_f, sq and x (a float2 plane in the room of two); state
// vectors: s_prev, s_tmp, s_min, lam. Output: (|x| - sqrt(lam))+ x / |x|.
struct McraNode {
  static constexpr int kInPlanes = 4, kVecs = 4;
  static constexpr bool kExtra = false;
  const float* s_f;
  const float* sq;
  const float2* x;
  const float* vin[kVecs];
  const int* cur_in;
  const unsigned char* first_in;
  float2* y;
  float* vout[kVecs];
  int* cur_out;
  unsigned char* first_out;
  int T, NB, B;
  march::McraCoef c;
  float amp;
  int flags;

  __device__ static float2 (*xs(float (*in)[kSeg][kLanes]))[kLanes] {
    return reinterpret_cast<float2 (*)[kLanes]>(in[2]);
  }

  // stream s's frames: rows B NB apart
  __device__ void load(float (*in)[kSeg][kLanes], int s, int t0, int nf,
                       int b0, int lane) const {
    const size_t ld = (size_t)B * NB, o = t0 * ld + (size_t)s * NB;
    march::load_rows(in[0], s_f + o, ld, NB, nf, b0, lane);
    march::load_rows(in[1], sq + o, ld, NB, nf, b0, lane);
    march::load_rows(xs(in), x + o, ld, NB, nf, b0, lane);
  }

  __device__ float dc(float (*)[kSeg][kLanes], int) const { return 0.f; }

  __device__ float sf_in(float (*in)[kSeg][kLanes], int k, int col, int,
                         float) const {
    return in[0][k][col];
  }

  __device__ float sq_in(float (*in)[kSeg][kLanes], int k, int col,
                         int) const {
    return in[1][k][col];
  }

  __device__ float2 extra_in(float (*)[kSeg][kLanes], int, int, int) const {
    return float2{};
  }

  __device__ float4 extra_step(float2, float*) const { return float4{}; }

  // (|x| - sqrt(lam))+ (or sqrt(lam) alone) at x's phase, x / |x| (1 at
  // x = 0)
  template <bool kExact>
  __device__ float2 out(float (*in)[kSeg][kLanes], float4, float lam, int k,
                        int col, int b, bool& ok) const {
    const float2 v = xs(in)[k][col];
    const float noise = march::sqrt_rn<kExact>(lam, ok);
    const float a = march::sqrt_rn<kExact>(
        __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), ok);
    const float mag = (flags & kOnlyNoise)
                          ? __fmul_rn(noise, amp)
                          : __fmul_rn(fmaxf(__fsub_rn(a, noise), 0.f), amp);
    bool ok_inv = true;
    const float inv = march::rcp_rn<kExact>(a, ok_inv);
    ok &= ok_inv || !(a > 0.f);
    const float2 o =
        a > 0.f ? make_float2(__fmul_rn(mag, __fmul_rn(v.x, inv)),
                              __fmul_rn(mag, __fmul_rn(v.y, inv)))
                : make_float2(mag, 0.f);
    const float2 dc = (flags & kDcZero) ? make_float2(0.f, 0.f) : v;
    return b == 0 ? dc : o;
  }
};

// one block per kLanes bins of a stream, its rings in dynamic shared memory
template <class Node>
cudaError_t launch_march(const Node& nd, cudaStream_t st) {
  constexpr int bytes = (int)sizeof(march::Smem<Node>);
  const cudaError_t e = cudaFuncSetAttribute(
      march::march_kernel<Node>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((nd.NB + kLanes - 1) / kLanes), (unsigned)nd.B);
  march::march_kernel<Node><<<grid, march::kThreads, bytes, st>>>(nd);
  return cudaGetLastError();
}

// A march kernel's resources: out = registers a thread, dynamic shared
// memory a block (bytes), local memory a thread (bytes: spills), resident
// blocks an SM.
template <class Node>
cudaError_t march_resources(int* out) {
  constexpr int bytes = (int)sizeof(march::Smem<Node>);
  cudaError_t e = cudaFuncSetAttribute(
      march::march_kernel<Node>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, march::march_kernel<Node>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, march::march_kernel<Node>, march::kThreads, bytes);
  out[0] = a.numRegs;
  out[1] = bytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return e;
}

// the launch's sizes in range: 2^31 (stream, frame, bin) threads of the
// flat grid, 65535 streams of the march's grid
bool streams_fit(int B, int T, int NB) {
  return B >= 1 && B <= 65535 && (size_t)B * T * NB < (1u << 31);
}

FrontCoef front_coef(int M) {
  const int pairs = M * (M - 1) / 2;
  return FrontCoef{(float)(1.0 / M), (float)(1.0 / pairs)};
}

march::McraCoef mcra_coef(const float* v) {
  return march::McraCoef{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
}

}  // namespace

extern "C" {

// spec (T, B, M, NB) complex64, w (U, M, NB) complex64, w_idx (B, T)
// int64; y (B, T, NB) complex64 (one stream: (T, M, NB), (T,), (T, NB)).
// coef: min_phase_rad, mag_threshold, mag_mult, 1 / nfft. 2 <= M <= 32.
int bf_phase_mask(const void* spec, const void* w, const int64_t* w_idx,
                  void* y, int M, int T, int NB, int U, int B,
                  const float* coef, void* stream) {
  if (M < 2 || M > 32 || T < 1 || NB < 1 || !streams_fit(B, T, NB))
    return (int)cudaErrorInvalidValue;
  const PhaseCoef c{coef[0], coef[1], coef[2], coef[3]};
  const FrontCoef fc = front_coef(M);
  cudaStream_t st = (cudaStream_t)stream;
  const float2* s = (const float2*)spec;
  const float2* wv = (const float2*)w;
  float2* out = (float2*)y;
  const dim3 grid((unsigned)(((size_t)B * T * NB + kBinThreads - 1) /
                             kBinThreads));
  return (int)by_mics(M, [&](auto m, auto exact) {
    phase_mask_kernel<decltype(m)::value, decltype(exact)::value>
        <<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, out, M, T, NB, U, B, fc,
                                       c);
  });
}

// spec, w, w_idx as bf_phase_mask; the state: vec_in / vec_out 7 float32
// (B, NB) vectors (s_prev, s_tmp, s_min, lam_noise, z, lam_rev0,
// lam_rev1), current_L int32 and first_L bool (B,), in and out; planes
// (4, B, T, NB) float32 scratch; y (B, T, NB) complex64. coef: min_phase_rad, min_mag, the
// 7 MCRA constants (alphaS, 1 - alphaS, alphaD, 1 - alphaD, alphaD2,
// delta, L), MPF alphaS, 1 - MPF alphaS, eta, gamma, 1 - gamma / delta,
// out_amp, noise_floor. flags: 1 out_only_noise, 2 out_only_mcra, 4
// bug_dc_zero.
int bf_mpf_march(const void* spec, const void* w, const int64_t* w_idx,
                 const float* const* vec_in, const int* cur_in,
                 const unsigned char* first_in, float* planes, void* y,
                 float* const* vec_out, int* cur_out,
                 unsigned char* first_out, int M, int T, int NB, int U,
                 int B, const float* coef, int flags, void* stream) {
  if (M < 2 || M > 32 || T < 1 || NB < 2 || !streams_fit(B, T, NB))
    return (int)cudaErrorInvalidValue;
  const FrontCoef fc = front_coef(M);
  const float mp = coef[0], mm = coef[1];
  cudaStream_t st = (cudaStream_t)stream;
  const float2* s = (const float2*)spec;
  const float2* wv = (const float2*)w;
  const dim3 grid((unsigned)(((size_t)B * T * NB + kBinThreads - 1) /
                             kBinThreads));
  const cudaError_t err = by_mics(M, [&](auto m, auto exact) {
    mpf_beams_kernel<decltype(m)::value, decltype(exact)::value>
        <<<grid, kBinThreads, 0, st>>>(s, wv, w_idx, planes, M, T, NB, U, B,
                                       fc, mp, mm);
  });
  if (err != cudaSuccess) return (int)err;
  MpfNode nd{};
  nd.planes = planes;
  for (int r = 0; r < MpfNode::kVecs; ++r) {
    nd.vin[r] = vec_in[r];
    nd.vout[r] = vec_out[r];
  }
  nd.cur_in = cur_in;
  nd.first_in = first_in;
  nd.y = (float2*)y;
  nd.cur_out = cur_out;
  nd.first_out = first_out;
  nd.T = T;
  nd.NB = NB;
  nd.B = B;
  nd.c = mcra_coef(coef + 2);
  nd.mpf_as = coef[9];
  nd.one_m_mpf_as = coef[10];
  nd.eta = coef[11];
  nd.gam = coef[12];
  nd.rev_c = coef[13];
  nd.amp = coef[14];
  nd.floor = coef[15];
  nd.flags = flags;
  return (int)launch_march(nd, st);
}

// s_f, sq (T, B, NB) float32, x (T, B, NB) complex64; the state: vec_in /
// vec_out 4 float32 (B, NB) vectors (s_prev, s_tmp, s_min, lam),
// current_L int32 and first_L bool (B,), in and out; y (B, T, NB)
// complex64 (one stream: (T, NB) inputs and output, scalars). coef: the 7
// MCRA constants, out_amp. flags: 1 out_only_noise, 4 bug_dc_zero.
int bf_mcra_march(const float* s_f, const float* sq, const void* x,
                  const float* const* vec_in, const int* cur_in,
                  const unsigned char* first_in, void* y,
                  float* const* vec_out, int* cur_out,
                  unsigned char* first_out, int T, int NB, int B,
                  const float* coef, int flags, void* stream) {
  if (T < 1 || NB < 1 || !streams_fit(B, T, NB))
    return (int)cudaErrorInvalidValue;
  McraNode nd{};
  nd.s_f = s_f;
  nd.sq = sq;
  nd.x = (const float2*)x;
  for (int r = 0; r < McraNode::kVecs; ++r) {
    nd.vin[r] = vec_in[r];
    nd.vout[r] = vec_out[r];
  }
  nd.cur_in = cur_in;
  nd.first_in = first_in;
  nd.y = (float2*)y;
  nd.cur_out = cur_out;
  nd.first_out = first_out;
  nd.T = T;
  nd.NB = NB;
  nd.B = B;
  nd.c = mcra_coef(coef);
  nd.amp = coef[7];
  nd.flags = flags;
  return (int)launch_march(nd, (cudaStream_t)stream);
}

// march_resources of the MPF (node 0) or the MCRA march (node 1): out[4]
int bf_march_resources(int node, int* out) {
  return (int)(node == 0 ? march_resources<MpfNode>(out)
                         : march_resources<McraNode>(out));
}

}  // extern "C"
