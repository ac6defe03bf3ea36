// Fused audio-to-audio GSS (geometric source separation) for Hopper
// (sm_90a), bound with ctypes.
//
// gss_kernel replaces beamform_tpu/kernels/gss_stream.py:_kernel (reached
// through gss_mega): raw audio hops in, separated audio out, in one launch.
// Per frame t of the call and in-band bin (gss.cpp:90-156):
//
//   analysis   band_wola.cuh: sqrt-Hann, nfft-point DFT, the band's bins
//              only, gate statistic sum_m |X_m| / (M nfft)
//   reset      W <- A^H on the frame's reset flag (update_weights)
//   output     y = W x with the pre-update W; source 0 where the gate
//              passes, else 0.01 * x[mic 0]; 0 outside the band
//   update     where the gate passes (gss.cpp:124-136):
//                E y = y (sum_k |y_k|^2 - |y|^2)
//                dJ1 = 4 S_act (E y) x^H / ||x||^4
//                dJ2 = (2 / S_act) (W A - diag(act)) A^H
//                W  <- (1 - lambda mu) W - mu (dJ1 + dJ2)
//   synthesis  the half spectrum (bin 0 out of band), window, overlap-add
//
// W (S x M per bin) carries through every frame, so unlike MVDR the march
// cannot be split into independent frames: it splits only by bin. A slot
// is active in a frame when its row of A^H is nonzero (the host passes one
// bit per slot and control row); inactive slots have zero rows of A^H, and
// their rows of W are zero after every reset, so their y, their updates and
// their terms of W A are zero: the kernel skips them, and leaves their rows
// of W as they are. S_act counts the active slots.
//
// Design. One persistent grid, launched cooperatively, walks segments of at
// most SEG frames; per segment, stage A analyses the segment's frames (one
// block per frame and channel pair) and synthesises the previous segment's
// (one block per frame), a grid barrier, stage B marches the segment's
// frames for every bin, a grid barrier. In stage B, MP lanes (M rounded up
// to a power of two) own one bin for the whole call: lane m holds column m
// of W (S complex values) in registers across every segment, with A^H's
// column m for the frame's control row; each sum over mics is a shuffle
// reduction within the MP lanes. Bin j's lanes are slot j / G of block
// j % G (G blocks), so the 678 marches of the main path spread over every
// multiprocessor. The segment's in-band spectra (8.3 MB at 16 mics, 678
// bins, SEG 96) and outputs (0.5 MB) stay in the 50 MB L2 cache: the
// spectra never go to device memory as a whole.
//
// What bounds it: the march's latency, 1407 dependent frames per bin on
// the main path, each a chain of shuffle reductions (S_act + S_act^2 + 1 of
// them) and an L2 read of the frame's spectra, with few warps per
// multiprocessor to hide it; not bytes or flops.
//
// Index checks run here: a control index outside [0, U) makes the frame's
// output NaN (and a reset there W), a bin outside [1, nfft / 2) its
// spectra and output NaN. Neither is dereferenced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"
#include "stream_solve.cuh"

namespace {

using bf_band::kThreads;
using bf_stream::cmul;
using bf_stream::cmul_conj;
using bf_stream::group_sum;

struct GssArgs {
  const float* x;         // (M, T * hop) audio
  const float* tail;      // (M, hop) analysis carry
  const float* out_prev;  // (hop,) overlap-add carry
  const float2* w0;       // (NIB, S, M) demixing state
  const float2* ah;       // (U, S, M, NIB) A^H per control row
  const int* act;         // (U,) bit s: slot s of the row is active
  const int64_t* idx;     // (T,) control row per frame
  const uint8_t* reset;   // (T,) W <- A^H before the frame
  const int64_t* ib;      // (NIB,) in-band bins
  const float* win;       // (nfft,) sqrt-Hann
  const float2* tw;       // (nfft / 2,) exp(-2 pi i j / nfft)
  float* out;             // (T * hop,) zero on entry
  float* new_prev;        // (hop,)
  float2* w_out;          // (NIB, S, M)
  float2* xsc;            // scratch (SEG, M, NIB): the segment's spectra
  float2* ys;             // scratch (SEG, NIB): the segment's output
  int M, T, hop, log2n, NIB, U, S, SEG;
  float thr, mu, lam;
};

// Stage B of the segment t0 .. t0 + F - 1 for bin j on MP lanes (lane i is
// mic i); w holds column i of W.
template <int MP, int SP>
__device__ __forceinline__ void march(const GssArgs& p, unsigned grp, int i,
                                      int j, int t0, int F, float2 (&w)[SP]) {
  const int M = p.M, NIB = p.NIB, S = p.S;
  const size_t plane = (size_t)M * NIB;
  const float nan = __int_as_float(0x7fc00000);
  const float scale = 1.f / (float)(M * 2 * p.hop);
  const float one_lm = 1.f - p.lam * p.mu;
  int u_cur = -1;
  unsigned am = 0;
  float2 ahk[SP];                           // column i of A^H, this row
#pragma unroll
  for (int k = 0; k < SP; ++k) ahk[k] = make_float2(0.f, 0.f);
  float2 xn = i < M ? p.xsc[(size_t)i * NIB + j] : make_float2(0.f, 0.f);
  for (int f = 0; f < F; ++f) {
    const float2 xv = xn;
    if (f + 1 < F && i < M)                 // the next frame's read in flight
      xn = p.xsc[(size_t)(f + 1) * plane + (size_t)i * NIB + j];
    const int t = t0 + f;
    const int64_t u = p.idx[t];
    const bool bad = u < 0 || u >= p.U;
    if ((int)u != u_cur || bad) {
      u_cur = bad ? -1 : (int)u;
      am = bad ? 0u : (unsigned)p.act[u];
#pragma unroll
      for (int k = 0; k < SP; ++k) {
        float2 v = make_float2(0.f, 0.f);
        if (bad)
          v = make_float2(nan, nan);
        else if (k < S && i < M)
          v = p.ah[(((size_t)u * S + k) * M + i) * NIB + j];
        ahk[k] = v;
      }
    }
    if (p.reset[t]) {                       // update_weights, gss.cpp:90-93
#pragma unroll
      for (int k = 0; k < SP; ++k)
        if (k < S) w[k] = ahk[k];
    }

    // gate statistic and ||x||^2 in one reduction
    const float2 xs = group_sum<MP>(
        grp, make_float2(sqrtf(xv.x * xv.x + xv.y * xv.y),
                         xv.x * xv.x + xv.y * xv.y));
    const bool gate = xs.x * scale > p.thr;

    // y = W x with the pre-update W (gss.cpp:120-121), active slots only
    float2 y[SP];
    float tot = 0.f;
#pragma unroll
    for (int s = 0; s < SP; ++s) {
      y[s] = make_float2(0.f, 0.f);
      if (s < S && ((am >> s) & 1u)) {
        y[s] = group_sum<MP>(grp, cmul(w[s], xv));
        tot += y[s].x * y[s].x + y[s].y * y[s].y;
      }
    }
    if (i == 0) {
      p.ys[(size_t)f * NIB + j] =
          gate ? (bad ? make_float2(nan, nan) : y[0])
               : make_float2(0.01f * xv.x, 0.01f * xv.y);
    }
    if (!gate) continue;

    const float s_act = (float)__popc(am & (S >= 32 ? ~0u : (1u << S) - 1u));
    const float alpha = xs.y * xs.y;
    const float c1 = 4.f * s_act / fmaxf(alpha, 1e-30f);
    const float c2 = 2.f / fmaxf(s_act, 1.f);
#pragma unroll
    for (int s = 0; s < SP; ++s) {
      if (!(s < S && ((am >> s) & 1u))) continue;
      // dJ1 row s, lane i: c1 (E y)_s conj(x_i)
      const float e2 = tot - (y[s].x * y[s].x + y[s].y * y[s].y);
      const float2 ey = make_float2(y[s].x * e2, y[s].y * e2);
      const float2 d1 = cmul_conj(ey, xv);
      // dJ2 row s, lane i: sum_k ((W A)[s][k] - act_s delta_sk) A^H[k][i]
      float2 d2 = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < SP; ++k) {
        if (!(k < S && ((am >> k) & 1u))) continue;
        float2 wa = group_sum<MP>(grp, cmul_conj(w[s], ahk[k]));
        if (k == s) wa.x -= 1.f;
        const float2 q = cmul(wa, ahk[k]);
        d2 = make_float2(d2.x + q.x, d2.y + q.y);
      }
      w[s] = make_float2(
          one_lm * w[s].x - p.mu * (c1 * d1.x + c2 * d2.x),
          one_lm * w[s].y - p.mu * (c1 * d1.y + c2 * d2.y));
    }
  }
}

template <int MP, int SP>
__global__ void __launch_bounds__(kThreads) gss_kernel(GssArgs p) {
  extern __shared__ float2 smem[];
  const int n = 2 * p.hop;
  const int M = p.M, NIB = p.NIB, S = p.S;
  const size_t plane = (size_t)M * NIB;
  const float nan = __int_as_float(0x7fc00000);

  // this thread's bin and mic, for the whole call
  const int i = threadIdx.x % MP;
  const int j = (threadIdx.x / MP) * gridDim.x + blockIdx.x;
  const bool owner = j < NIB;
  const unsigned grp =
      MP == 32 ? 0xffffffffu
               : ((1u << (MP % 32)) - 1u) << ((threadIdx.x % 32) / MP * MP);
  float2 w[SP];
#pragma unroll
  for (int s = 0; s < SP; ++s)
    w[s] = owner && s < S && i < M ? p.w0[((size_t)j * S + s) * M + i]
                                   : make_float2(0.f, 0.f);

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
        bf_band::analyze_pair(smem, p.x, p.tail, p.win, p.tw, M, p.T, p.hop,
                              p.log2n, t0 + f, c0);
        float2* dst = p.xsc + (size_t)f * plane;
        for (int jj = threadIdx.x; jj < NIB; jj += kThreads) {
          const int64_t k = p.ib[jj];
          float2 a = make_float2(nan, nan), b = a;
          if (k >= 1 && k < p.hop) bf_band::split_bin(smem, n, (int)k, a, b);
          dst[(size_t)c0 * NIB + jj] = a;
          if (c0 + 1 < M) dst[(size_t)(c0 + 1) * NIB + jj] = b;
        }
      } else {
        const int f = item - F * pairs;
        bf_band::load_half_spectrum(smem, n, p.log2n, 0.f,
                                    p.ys + (size_t)f * NIB, p.ib, NIB);
        bf_band::synthesize_frame(smem, p.tw, p.win, p.out_prev, p.out,
                                  p.new_prev, p.T, p.hop, p.log2n, tp + f);
      }
      __syncthreads();                      // smem is reused
    }
    if (sg == nseg) break;
    bf_band::grid_sync();

    // B: march the segment's frames, every bin
    if (owner) march<MP, SP>(p, grp, i, j, t0, F, w);
    bf_band::grid_sync();
  }

  if (owner && i < M) {
#pragma unroll
    for (int s = 0; s < SP; ++s)
      if (s < S) p.w_out[((size_t)j * S + s) * M + i] = w[s];
  }
}

template <int MP, int SP>
cudaError_t launch_gss(const GssArgs& a, cudaStream_t st) {
  const size_t smem = (size_t)2 * a.hop * sizeof(float2);
  cudaError_t err = cudaSuccess;
  const int grid = bf_band::resident_grid(gss_kernel<MP, SP>, smem, err);
  if (grid == 0) return err;
  if ((long long)grid * (kThreads / MP) < a.NIB)
    return cudaErrorCooperativeLaunchTooLarge;    // a bin without lanes
  GssArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)gss_kernel<MP, SP>,
                                    dim3(grid), dim3(kThreads), params, smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_slots(const GssArgs& a, cudaStream_t st) {
  if (a.S <= 1) return launch_gss<MP, 1>(a, st);
  if (a.S <= 2) return launch_gss<MP, 2>(a, st);
  if (a.S <= 4) return launch_gss<MP, 4>(a, st);
  if (a.S <= 8) return launch_gss<MP, 8>(a, st);
  return launch_gss<MP, 16>(a, st);
}

}  // namespace

extern "C" {

// x (M, T*hop), tail (M, hop), out_prev (hop,) float32; w0 (NIB, S, M),
// ah (U, S, M, NIB) complex64; act (U,) int32; idx (T,), ib (NIB,) int64;
// reset (T,) bool; win (2*hop) float32, tw (hop) complex64; out (T*hop),
// new_prev (hop) float32; w_out (NIB, S, M) complex64; scratch xsc
// (SEG, M, NIB) and ys (SEG, NIB) complex64. 1 <= M <= 32, 1 <= S <= 16,
// T >= 1, SEG >= 1. Returns the first CUDA error of the memset, the launch
// or its check.
int bf_gss_stream(const void* x, const void* tail, const void* out_prev,
                  const void* w0, const void* ah, const void* act,
                  const void* idx, const void* reset, const void* ib,
                  const void* win, const void* tw, void* out, void* new_prev,
                  void* w_out, void* xsc, void* ys, int M, int T, int hop,
                  int NIB, int U, int S, int SEG, float thr, float mu,
                  float lam, void* stream) {
  if (M < 1 || M > 32 || S < 1 || S > 16 || T < 1 || SEG < 1 || NIB < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)T * hop * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  GssArgs a;
  a.x = (const float*)x;
  a.tail = (const float*)tail;
  a.out_prev = (const float*)out_prev;
  a.w0 = (const float2*)w0;
  a.ah = (const float2*)ah;
  a.act = (const int*)act;
  a.idx = (const int64_t*)idx;
  a.reset = (const uint8_t*)reset;
  a.ib = (const int64_t*)ib;
  a.win = (const float*)win;
  a.tw = (const float2*)tw;
  a.out = (float*)out;
  a.new_prev = (float*)new_prev;
  a.w_out = (float2*)w_out;
  a.xsc = (float2*)xsc;
  a.ys = (float2*)ys;
  a.M = M;
  a.T = T;
  a.hop = hop;
  a.log2n = bf_band::ilog2(2 * hop);
  a.NIB = NIB;
  a.U = U;
  a.S = S;
  a.SEG = SEG;
  a.thr = thr;
  a.mu = mu;
  a.lam = lam;
  if (M <= 4) return (int)launch_slots<4>(a, st);
  if (M <= 8) return (int)launch_slots<8>(a, st);
  if (M <= 16) return (int)launch_slots<16>(a, st);
  return (int)launch_slots<32>(a, st);
}

}  // extern "C"
