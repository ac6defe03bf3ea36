// Fused audio-to-audio MVDR/LCMV for Hopper (sm_90a), bound with ctypes.
//
// mega_kernel replaces beamform_tpu/kernels/mega_stream.py:_kernel (reached
// through mvdr_mega / lcmv_mega): raw audio hops in, beamformed audio out,
// in one launch. Per frame t of the call (mvdr.cpp:62-115, lcmv.cpp:108-138):
//
//   analysis   frame t of [tail | x], sqrt-Hann window, nfft-point DFT, only
//              the band's bins ib; gate statistic sum_m |X_m| / (M * nfft)
//   solve      where the gate passes: R = (sum of x x^H over the W frames
//              before t) .* (ones + 0.001 I); MVDR u = R^-1 d,
//              y = (u^H x_t) / conj(d^H u) (0 where d^H u == 0); LCMV the
//              constraint-space solve (lcmv_apply below); the
//              solves unrefined unless ``refine``, as the TPU kernel
//   combine    gated off: 0.01 * x_t[mic 0]; bin 0: x_t[mic 0] passed
//              through; other bins 0
//   synthesis  the half spectrum (band_wola.cuh), window, 50% overlap-add
//
// "The W frames before t" are the carried history (W in-band frames), then
// the call's own frames; the returned history is the last W in-band frames,
// oldest first. The TPU kernel skips the solve of a frame with no passing
// bin and masks per bin in the combine; solving only the passing (frame,
// bin) pairs gives the same output, and is what this kernel does. LCMV with
// one constraint slot takes the MVDR form, as on the TPU (mega_stream.py:257).
//
// Design. The TPU kernel marches frames in order with the spectra in VMEM.
// Here one persistent grid, launched cooperatively so that every block is
// resident, walks segments of at most SEG frames, and a grid barrier
// separates the stages of a segment:
//
//   A  analysis of segment s (one block per frame and channel pair, two
//      real channels per complex FFT in shared memory), overlapped with the
//      synthesis of segment s - 1 (one block per frame)
//   -- grid barrier --
//   B  the solves of segment s: every (frame, bin) pair is an independent
//      problem, as in mvdr_stream.cu (R_t depends only on the W frames
//      before t, so no sum is carried from frame to frame and no segment
//      waits for another's march); a block stages 32 frames x 8 bins plus
//      the W-frame history into shared memory, and LP lanes solve one
//      problem with row i of R in lane i
//   -- grid barrier --
//
// The spectra never go to device memory as a whole: the in-band spectra
// live in a ring of SEG + W frames (9.2 MB at 16 mics, 678 bins, SEG 96,
// W 10) that stays in the 50 MB L2 cache, together with the segment's
// outputs y (0.5 MB); the ring's first W frames start as the carried
// history, and a segment overwrites only frames that no later solve reads.
// The overlap-add goes straight into the call's output with atomicAdd (two
// addends per sample, so the result is order-independent). The stream path
// writes the full spectra (185 MB per 30 s at 16 mics) to HBM and reads
// them back, in three launches.
//
// What bounds it: the solves, as in mvdr_stream.cu: chains of dependent warp
// shuffles in the factor and the triangular solves (~40 k flop per
// problem), not bytes (92 MB of audio in, 5.8 MB out).
//
// Index checks run here, not on the host: a bin index outside [1, nfft / 2)
// gives NaN output for its frames, a control index outside [0, U) NaN
// solves for its frame. Neither is dereferenced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"
#include "stream_solve.cuh"

namespace {

using namespace bf_stream;

struct MegaArgs {
  const float* x;         // (M, T * hop) audio
  const float* tail;      // (M, hop) analysis carry
  const float* out_prev;  // (hop,) overlap-add carry
  const float2* hist;     // (W, M, NIB) in-band history, oldest first
  const float2* ctrl;     // (U, S, M, NIB) steering (S = 1) or constraints
  const int64_t* idx;     // (T,) control row per frame
  const int64_t* ib;      // (NIB,) in-band bins
  const float* win;       // (nfft,) sqrt-Hann
  const float2* tw;       // (nfft / 2,) exp(-2 pi i j / nfft)
  float* out;             // (T * hop,) zero on entry
  float* new_prev;        // (hop,)
  float2* hist_out;       // (W, M, NIB)
  float2* ring;           // scratch (SEG + W, M, NIB): extended frame e at
                          // slot e % (SEG + W); e < W the history
  float2* ys;             // scratch (SEG, NIB): the segment's gated output
  float* dc;              // scratch (2, SEG): mic 0's bin 0 per frame
  int M, T, hop, log2n, NIB, W, U, S, SEG;
  float thr;
  int refine;
};

// 1 / p as conj(p) / |p|^2
__device__ __forceinline__ float2 crecip(float2 p) {
  const float inv_den = 1.f / (p.x * p.x + p.y * p.y);
  return make_float2(p.x * inv_den, -p.y * inv_den);
}

// lcmv_stream.cu keeps the same steps inline, always refined, rather than
// calling this function: when it called it, ptxas gave
// lcmv_stream_kernel<16, 1..4> 110-113 registers instead of 124-126 and it
// ran 8% (S = 1) to 12% (S = 3) slower on an H100 (PERF.md section 6).
//
// The constraint-space tail of one LCMV problem (lcmv.cpp:108-138,
// beamform_tpu/kernels/lcmv_stream.py constraint_space_apply) on LP lanes,
// given R's factor (a, linv) and R's row (r, read only when ``refine``):
//
//   X_a = R^-1 C_a   per slot, into the problem's scratch xp ([SP][LP] in
//                    shared memory); a zero column's solve is skipped
//   G   = C^H X      S x S; G[a][a] += 1 where column a of C is zero
//   v   = G^-1 e0    unpivoted Gauss-Jordan, then one residual step
//   y   = (X v)^H x_t
//
// Element (s, m) of the frame's constraint set at this bin is
// cu[(s * M + m) * stride]; ``bad`` (a control index out of range) makes
// every constraint NaN. Returns y in every lane of the problem. A zero
// column's solve is exactly zero for any finite factor, and with a
// non-finite factor the always-active look-direction column makes the
// output non-finite anyway. The Gauss-Jordan elimination exchanges the
// pivot row by shuffles: lane a holds row a of G and of G^-1 (LP >= S).
template <int LP, int SP>
__device__ __forceinline__ float2 lcmv_apply(
    unsigned mask, const float2 (&a)[LP], const float2 (&r)[LP], float linv,
    int i, int M, int S, const float2* __restrict__ cu, size_t stride,
    bool bad, float2 xt, float2* __restrict__ xp, bool refine) {
  const float nan = __int_as_float(0x7fc00000);
  // X_a = R^-1 C_a, slot by slot; bit a of ``zero``: column a is zero
  unsigned zero = 0;
  for (int s = 0; s < S; ++s) {
    float2 cs = make_float2(0.f, 0.f);
    if (bad)
      cs = make_float2(nan, nan);
    else if (i < M)
      cs = cu[((size_t)s * M + i) * stride];
    const bool nz = cs.x != 0.f || cs.y != 0.f;
    float2 xsol = make_float2(0.f, 0.f);
    if (__ballot_sync(mask, nz) == 0)
      zero |= 1u << s;
    else
      xsol = solve<LP>(mask, a, r, linv, i, cs, refine);
    xp[s * LP + i] = xsol;
  }
  __syncwarp(mask);

  // row i of G = C^H X (identity rows past S), and a copy for the
  // residual step
  float2 g[SP], g0[SP], gi[SP];
#pragma unroll
  for (int b = 0; b < SP; ++b) {
    g[b] = make_float2(i >= S && b == i ? 1.f : 0.f, 0.f);
    gi[b] = make_float2(b == i ? 1.f : 0.f, 0.f);
  }
  if (i < S) {
    for (int m = 0; m < M; ++m) {
      const float2 cm = bad ? make_float2(nan, nan)
                            : cu[((size_t)i * M + m) * stride];
#pragma unroll
      for (int b = 0; b < SP; ++b) {
        if (b < S) {
          const float2 q = cmul_conj(xp[b * LP + m], cm);
          g[b] = make_float2(g[b].x + q.x, g[b].y + q.y);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < SP; ++b)
      if (b == i && ((zero >> i) & 1u)) g[b].x += 1.f;
  }
#pragma unroll
  for (int b = 0; b < SP; ++b) g0[b] = g[b];

  // Gauss-Jordan on the rows: lane i holds row i of G and of G^-1; the
  // pivot row k comes by shuffles from lane k (lcmv_stream.py:45-76)
#pragma unroll
  for (int k = 0; k < SP; ++k) {
    const float2 pinv = crecip(shfl<LP>(mask, g[k], k));
    const float2 f = g[k];                          // G[i][k]
#pragma unroll
    for (int b = 0; b < SP; ++b) {
      const float2 pg = cmul(shfl<LP>(mask, g[b], k), pinv);
      const float2 pi = cmul(shfl<LP>(mask, gi[b], k), pinv);
      if (i == k) {
        g[b] = pg;
        gi[b] = pi;
      } else {
        const float2 dg = cmul(f, pg), di = cmul(f, pi);
        g[b] = make_float2(g[b].x - dg.x, g[b].y - dg.y);
        gi[b] = make_float2(gi[b].x - di.x, gi[b].y - di.y);
      }
    }
  }

  // v = G^-1 e0, then v += G^-1 (e0 - G v) (lcmv_stream.py:120-137)
  float2 v = gi[0];
  float2 res = make_float2(i == 0 ? 1.f : 0.f, 0.f);
#pragma unroll
  for (int b = 0; b < SP; ++b) {
    const float2 q = cmul(g0[b], shfl<LP>(mask, v, b));
    res = make_float2(res.x - q.x, res.y - q.y);
  }
#pragma unroll
  for (int b = 0; b < SP; ++b) {
    const float2 q = cmul(gi[b], shfl<LP>(mask, res, b));
    v = make_float2(v.x + q.x, v.y + q.y);
  }

  // w_i = sum_a X[i][a] v_a ; y = w^H x
  float2 w = make_float2(0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const float2 q = cmul(xp[s * LP + i], shfl<LP>(mask, v, s));
    w = make_float2(w.x + q.x, w.y + q.y);
  }
  const float2 y = group_sum<LP>(mask, cmul_conj(xt, w));
  __syncwarp(mask);                                 // xp is reused
  return y;
}

// The MVDR form on LP lanes: u = R^-1 d, y = (u^H x) / conj(d^H u), 0 where
// d^H u == 0 (an all-zero constraint column, mega_stream.py:206-213).
template <int LP>
__device__ __forceinline__ float2 mvdr_apply(unsigned mask,
                                             const float2 (&a)[LP],
                                             const float2 (&r)[LP],
                                             float linv, int i, float2 di,
                                             float2 xt, bool refine) {
  const float2 u = solve<LP>(mask, a, r, linv, i, di, refine);
  const float2 den = group_sum<LP>(mask, cmul_conj(u, di));   // d^H u
  const float2 num = group_sum<LP>(mask, cmul_conj(xt, u));   // u^H x
  const float d2 = den.x * den.x + den.y * den.y;
  const float s = d2 > 0.f ? 1.f / fmaxf(d2, 1e-38f) : 0.f;
  return make_float2((num.x * den.x - num.y * den.y) * s,
                     (num.y * den.x + num.x * den.y) * s);
}

// Stage B of segment ``sg`` (frames t0 .. t0 + F - 1) for one tile: bins
// b0 .. b0 + kBins - 1, segment frames f0 .. f0 + kFrames - 1.
template <int LP, int SP, bool kLcmv>
__device__ __forceinline__ void solve_tile(const MegaArgs& p, float2* smem,
                                           int t0, int F, int b0, int f0) {
  const int W = p.W, M = p.M, NIB = p.NIB;
  const int R = p.SEG + W;
  const size_t plane = (size_t)M * NIB;
  float2* xs = smem;                        // [kFrames + W][LP][kBins]
  const int ne = kFrames + W;
  for (int q = threadIdx.x; q < ne * LP * kBins; q += kThreads) {
    const int bb = q % kBins;
    const int m = (q / kBins) % LP;
    const int el = q / (kBins * LP);          // staged row: frame f0+el-W
    float2 v = make_float2(0.f, 0.f);
    if (m < M && b0 + bb < NIB && f0 + el - W < F) {
      const int e = t0 + f0 + el;             // extended frame index
      v = p.ring[(size_t)(e % R) * plane + (size_t)m * NIB + b0 + bb];
    }
    xs[q] = v;
  }
  __syncthreads();

  constexpr int kSlots = kThreads / LP;
  const int slot = threadIdx.x / LP;
  const int i = threadIdx.x % LP;
  float2* xp = smem + (size_t)ne * LP * kBins + slot * SP * LP;
  const unsigned grp =
      LP == 32 ? 0xffffffffu
               : ((1u << (LP % 32)) - 1u) << ((threadIdx.x % 32) / LP * LP);
  const float scale = 1.f / (float)(M * 2 * p.hop);
  const float nan = __int_as_float(0x7fc00000);
  for (int it = 0; it < kBins * kFrames / kSlots; ++it) {
    const int q = slot + it * kSlots;
    const int bb = q % kBins;
    const int lt = q / kBins;
    const int f = f0 + lt;
    const int bin = b0 + bb;
    const bool valid = f < F && bin < NIB;
    const float2 xt = xs[((lt + W) * LP + i) * kBins + bb];
    // gate statistic: every lane of the warp takes part
    const float mag =
        group_sum<LP>(0xffffffffu,
                      make_float2(sqrtf(xt.x * xt.x + xt.y * xt.y), 0.f)).x *
        scale;
    const bool act = valid && mag > p.thr;
    const unsigned mask = __ballot_sync(0xffffffffu, act) & grp;
    float2* yo = p.ys + (size_t)f * NIB + bin;
    if (!act) {
      if (valid && i == 0) *yo = make_float2(0.01f * xt.x, 0.01f * xt.y);
      continue;
    }
    float2 a[LP], r[LP];
    float linv;
    covariance_cholesky<LP>(mask, xs, lt, bb, i, M, W, a, r, linv);
    const int64_t u = p.idx[t0 + f];
    const bool bad = u < 0 || u >= p.U;
    const float2* cu = p.ctrl + (size_t)(bad ? 0 : u) * p.S * plane + bin;
    float2 yv;
    if (kLcmv) {
      yv = lcmv_apply<LP, SP>(mask, a, r, linv, i, M, p.S, cu, NIB, bad, xt,
                              xp, p.refine != 0);
    } else {
      float2 di = make_float2(0.f, 0.f);
      if (bad)
        di = make_float2(nan, nan);
      else if (i < M)
        di = cu[(size_t)i * NIB];
      yv = mvdr_apply<LP>(mask, a, r, linv, i, di, xt, p.refine != 0);
    }
    if (i == 0) *yo = yv;
  }
  __syncthreads();                          // xs is restaged
}

template <int LP, int SP, bool kLcmv>
__global__ void __launch_bounds__(kThreads) mega_kernel(MegaArgs p) {
  extern __shared__ float2 smem[];
  const int n = 2 * p.hop;
  const int W = p.W, M = p.M, NIB = p.NIB;
  const int R = p.SEG + W;
  const size_t plane = (size_t)M * NIB;
  const float nan = __int_as_float(0x7fc00000);
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;

  // the carried history: extended frames 0 .. W-1, ring slots 0 .. W-1
  for (size_t q = gtid; q < (size_t)W * plane; q += gstride)
    p.ring[q] = p.hist[q];

  const int nseg = (p.T + p.SEG - 1) / p.SEG;
  const int pairs = (M + 1) / 2;
  for (int sg = 0; sg <= nseg; ++sg) {
    // A: analysis of segment sg, synthesis of segment sg - 1
    const int t0 = sg * p.SEG;
    const int F = sg < nseg ? min(p.SEG, p.T - t0) : 0;
    const int tp = t0 - p.SEG;
    const int Fp = sg > 0 ? min(p.SEG, p.T - tp) : 0;
    for (int item = blockIdx.x; item < F * pairs + Fp; item += gridDim.x) {
      if (item < F * pairs) {
        const int f = item / pairs;
        const int c0 = 2 * (item % pairs);
        const int t = t0 + f;
        bf_band::analyze_pair(smem, p.x, p.tail, p.win, p.tw, M, p.T, p.hop,
                              p.log2n, t, c0);
        float2* dst = p.ring + (size_t)((W + t) % R) * plane;
        for (int j = threadIdx.x; j < NIB; j += kThreads) {
          const int64_t k = p.ib[j];
          float2 a = make_float2(nan, nan), b = a;
          if (k >= 1 && k < p.hop) bf_band::split_bin(smem, n, (int)k, a, b);
          dst[(size_t)c0 * NIB + j] = a;
          if (c0 + 1 < M) dst[(size_t)(c0 + 1) * NIB + j] = b;
        }
        if (c0 == 0 && threadIdx.x == 0)
          p.dc[(sg & 1) * p.SEG + f] = smem[0].x;   // X_0[0], real
      } else {
        const int f = item - F * pairs;
        bf_band::load_half_spectrum(smem, n, p.log2n,
                                    p.dc[((sg - 1) & 1) * p.SEG + f],
                                    p.ys + (size_t)f * NIB, p.ib, NIB);
        bf_band::synthesize_frame(smem, p.tw, p.win, p.out_prev, p.out,
                                  p.new_prev, p.T, p.hop, p.log2n, tp + f);
      }
      __syncthreads();                      // smem is reused
    }
    if (sg == nseg) break;
    bf_band::grid_sync();

    // B: the solves of segment sg
    const int ntb = (NIB + kBins - 1) / kBins;
    const int ntf = (F + kFrames - 1) / kFrames;
    for (int tile = blockIdx.x; tile < ntb * ntf; tile += gridDim.x)
      solve_tile<LP, SP, kLcmv>(p, smem, t0, F, (tile % ntb) * kBins,
                                (tile / ntb) * kFrames);
    bf_band::grid_sync();
  }

  // the last W extended frames, oldest first
  for (size_t q = gtid; q < (size_t)W * plane; q += gstride) {
    const size_t w = q / plane;
    p.hist_out[q] = p.ring[(size_t)((p.T + w) % R) * plane + q % plane];
  }
}

template <int LP, int SP, bool kLcmv>
cudaError_t launch_mega(const MegaArgs& a, cudaStream_t st) {
  const size_t tile = (size_t)(kFrames + a.W) * LP * kBins +
                      (kLcmv ? (size_t)kThreads / LP * SP * LP : 0);
  const size_t smem = (tile > (size_t)2 * a.hop ? tile : 2 * a.hop) *
                      sizeof(float2);
  cudaError_t err = cudaSuccess;
  const int grid = bf_band::resident_grid(mega_kernel<LP, SP, kLcmv>, smem,
                                          err);
  if (grid == 0) return err;
  MegaArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)mega_kernel<LP, SP, kLcmv>,
                                    dim3(grid), dim3(kThreads), params, smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_lanes(const MegaArgs& a, bool lcmv, cudaStream_t st) {
  if (!lcmv || a.S == 1) return launch_mega<LP, 1, false>(a, st);
#define BF_MEGA_SP(SPV)                                                    \
  if (a.S <= SPV && SPV <= LP)                                             \
    return launch_mega<LP, (SPV <= LP ? SPV : LP), true>(a, st);
  BF_MEGA_SP(2)
  BF_MEGA_SP(4)
  BF_MEGA_SP(8)
  BF_MEGA_SP(16)
#undef BF_MEGA_SP
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (M, T*hop), tail (M, hop), out_prev (hop,) float32; hist (W, M, NIB),
// ctrl (U, S, M, NIB) complex64; idx (T,), ib (NIB,) int64; win (2*hop)
// float32, tw (hop) complex64; out (T*hop), new_prev (hop) float32;
// hist_out (W, M, NIB) complex64; scratch ring (SEG + W, M, NIB) and ys
// (SEG, NIB) complex64, dc (2, SEG) float32. 1 <= M <= 32, 1 <= S <= 16,
// W >= 1, T >= 1, 1 <= SEG. ``lcmv`` 0 takes ctrl as MVDR steering (S = 1).
// Returns the first CUDA error of the memset, the launch or its check.
int bf_mega_stream(const void* x, const void* tail, const void* out_prev,
                   const void* hist, const void* ctrl, const void* idx,
                   const void* ib, const void* win, const void* tw, void* out,
                   void* new_prev, void* hist_out, void* ring, void* ys,
                   void* dc, int M, int T, int hop, int NIB, int W, int U,
                   int S, int SEG, float thr, int refine, int lcmv,
                   void* stream) {
  if (M < 1 || M > 32 || S < 1 || S > 16 || (!lcmv && S != 1) || W < 1 ||
      T < 1 || SEG < 1 || NIB < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)T * hop * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  MegaArgs a;
  a.x = (const float*)x;
  a.tail = (const float*)tail;
  a.out_prev = (const float*)out_prev;
  a.hist = (const float2*)hist;
  a.ctrl = (const float2*)ctrl;
  a.idx = (const int64_t*)idx;
  a.ib = (const int64_t*)ib;
  a.win = (const float*)win;
  a.tw = (const float2*)tw;
  a.out = (float*)out;
  a.new_prev = (float*)new_prev;
  a.hist_out = (float2*)hist_out;
  a.ring = (float2*)ring;
  a.ys = (float2*)ys;
  a.dc = (float*)dc;
  a.M = M;
  a.T = T;
  a.hop = hop;
  a.log2n = bf_band::ilog2(2 * hop);
  a.NIB = NIB;
  a.W = W;
  a.U = U;
  a.S = S;
  a.SEG = SEG;
  a.thr = thr;
  a.refine = refine;
  const bool l = lcmv != 0 && S > 1;
  const int lanes = l && S > M ? S : M;
  if (lanes <= 4) return (int)launch_lanes<4>(a, l, st);
  if (lanes <= 8) return (int)launch_lanes<8>(a, l, st);
  if (lanes <= 16) return (int)launch_lanes<16>(a, l, st);
  return (int)launch_lanes<32>(a, l, st);
}

}  // extern "C"
