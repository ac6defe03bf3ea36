// The fused MVDR/LCMV kernel's template and its launch code (mega_stream.cu
// has the design): mega_stream.cu instantiates it for problem sizes MP 4
// and 8, mega_stream_16.cu for 16 and mega_stream_32.cu for 32, so that the
// package's build compiles the sizes in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"
#include "tri_solve.cuh"

namespace bf_mega {

using namespace bf_tri;

// B streams; each array but ctrl, ib and the tables has a leading stream
// axis, which the stages index with the stream's offsets (plain ints: a copy
// of the arguments per stream would cost the solves' registers)
struct MegaArgs {
  const float* x;         // (B, M, T * hop) audio
  const float* tail;      // (B, M, hop) analysis carry
  const float* out_prev;  // (B, hop) overlap-add carry
  const float2* hist;     // (B, W, M, NIB) in-band history, oldest first
  const float2* ctrl;     // (U, S, M, NIB) steering (S = 1) or constraints
  const int64_t* idx;     // (B, T) control row per frame
  const int64_t* ib;      // (NIB,) in-band bins
  const float* win;       // (nfft,) sqrt-Hann
  const float2* tw;       // (nfft / 2,) exp(-2 pi i j / nfft): synthesis
  const float2* ptw;      // the analysis FFT's pass twiddles
                          // (kernels/wola.py analysis_plan)
  float* out;             // (B, T * hop) zero on entry
  float* new_prev;        // (B, hop)
  float2* hist_out;       // (B, W, M, NIB)
  float2* ring;           // scratch (B, SEG + W, M, NIB): extended frame e
                          // at slot e % (SEG + W); e < W the history
  float2* ys;             // scratch (B, SEG, NIB): the segment's output
  float* dc;              // scratch (B, 2, SEG): mic 0's bin 0 per frame
  int B, M, T, hop, log2n, NIB, W, U, S, SEG;
  float thr;
  int refine;
};

// launch_lanes<16> and <32>, each in its own source
cudaError_t launch_16(const MegaArgs& a, bool lcmv, cudaStream_t st);
cudaError_t launch_32(const MegaArgs& a, bool lcmv, cudaStream_t st);

namespace {

// Stage B of segment ``sg`` (frames t0 .. t0 + F - 1) of stream sb for one
// tile: bins b0 .. b0 + kBins - 1, segment frames f0 .. f0 + kFrames - 1.
template <int MP, int SP, bool kLcmv>
__device__ __forceinline__ void solve_tile(const MegaArgs& p, float2* smem,
                                           int sb, int t0, int F, int b0,
                                           int f0) {
  using Sh = Shape<MP>;
  const int W = p.W, M = p.M, NIB = p.NIB;
  const int R = p.SEG + W;
  const size_t plane = (size_t)M * NIB;
  float2* xs = smem;                        // [kFrames + W][kBins][LD]
  const int ne = kFrames + W;
  for (int q = threadIdx.x; q < ne * MP * kBins; q += kThreads) {
    const int bb = q % kBins;
    const int m = (q / kBins) % MP;
    const int el = q / (kBins * MP);          // staged row: frame f0+el-W
    float2 v = make_float2(0.f, 0.f);
    if (m < M && b0 + bb < NIB && f0 + el - W < F) {
      const int e = t0 + f0 + el;             // extended frame index
      v = p.ring[((size_t)sb * R + e % R) * plane + (size_t)m * NIB + b0 +
                 bb];
    }
    xs[(el * kBins + bb) * Sh::LD + m] = v;
  }
  __syncthreads();

  const int slot = threadIdx.x / Sh::H;
  const int l = threadIdx.x % Sh::H;        // rows l and MP - 1 - l
  const int rh = MP - 1 - l;
  float2* cb = smem + tile_elems<MP>(W) + slot * Sh::CB;
  float2* xp = smem + tile_elems<MP>(W) + cbuf_elems<MP>() + slot * SP * MP;
  const unsigned grp = group_mask<MP>();
  const float scale = 1.f / (float)(M * 2 * p.hop);
  const float nan = __int_as_float(0x7fc00000);
  for (int it = 0; it < kBins * kFrames / Sh::kSlots; ++it) {
    const int q = slot + it * Sh::kSlots;
    const int bb = q % kBins;
    const int lt = q / kBins;
    const int f = f0 + lt;
    const int bin = b0 + bb;
    const bool valid = f < F && bin < NIB;
    const float2* xrow = frame<MP>(xs, lt + W, bb);
    const float2 xl = xrow[l], xh = xrow[rh];
    // gate statistic: every lane of the warp takes part
    const float mag =
        group_sum<Sh::H>(0xffffffffu,
                         make_float2(sqrtf(xl.x * xl.x + xl.y * xl.y) +
                                         sqrtf(xh.x * xh.x + xh.y * xh.y),
                                     0.f)).x * scale;
    const bool act = valid && mag > p.thr;
    const unsigned mask = __ballot_sync(0xffffffffu, act) & grp;
    float2* yo = p.ys + ((size_t)sb * p.SEG + f) * NIB + bin;
    if (!act) {
      if (valid && l == 0) *yo = make_float2(0.01f * xl.x, 0.01f * xl.y);
      continue;
    }
    Factor<MP> fc;
    covariance_factor<MP>(mask, xs, cb, lt, bb, l, M, W, fc);
    const int64_t u = p.idx[(size_t)sb * p.T + t0 + f];
    const bool bad = u < 0 || u >= p.U;
    const float2* cu = p.ctrl + (size_t)(bad ? 0 : u) * p.S * plane + bin;
    float2 yv;
    if constexpr (kLcmv) {
      yv = lcmv_apply<MP, SP>(mask, xs, lt, bb, l, M, W, p.S, fc, cu, NIB,
                              bad, xl, xh, xp, p.refine != 0);
    } else {
      float2 dl = make_float2(0.f, 0.f), dh = dl;
      if (bad) {
        dl = dh = make_float2(nan, nan);
      } else {
        if (l < M) dl = cu[(size_t)l * NIB];
        if (rh < M) dh = cu[(size_t)rh * NIB];
      }
      yv = mvdr_apply<MP>(mask, xs, lt, bb, l, W, fc, dl, dh, xl, xh,
                          p.refine != 0);
    }
    if (l == 0) *yo = yv;
  }
  __syncthreads();                          // xs is restaged
}

// Stage A's analysis of item ``item`` of stream sb: frame item / groups of
// the segment, the item % groups-th group of channel pairs.
__device__ __forceinline__ void analyze_item(const MegaArgs& p, float2* smem,
                                             int sb, int t0, int sg,
                                             int groups, int item) {
  const int f = item / groups;
  const int q0 = (item - f * groups) * (kThreads * 16 / (2 * p.hop));
  const int t = t0 + f;
  const int R = p.SEG + p.W;
  float2* dst = p.ring + ((size_t)sb * R + (p.W + t) % R) *
                             ((size_t)p.M * p.NIB);
  float* dc = p.dc + ((size_t)sb * 2 + (sg & 1)) * p.SEG + f;
  bf_band::analyze_band<false>(
      p.hop, smem, p.x + (size_t)sb * p.M * p.T * p.hop,
      p.tail + (size_t)sb * p.M * p.hop, p.win, p.ptw, p.ib, dst, dc, p.M,
      p.T, p.NIB, t, q0);
}

// two blocks of 256 threads an SM (128 registers a thread) up to 16 rows
// and 8 slots; past that the X scratch's shared memory or the factor's
// size leaves room for one, with 255 registers
template <int MP, int SP, bool kLcmv>
__global__ void __launch_bounds__(kThreads, (MP <= 16 && SP <= 8) ? 2 : 1)
    mega_kernel(MegaArgs p) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int n = 2 * p.hop;
  const int W = p.W, M = p.M, NIB = p.NIB;
  const int R = p.SEG + W;
  const size_t plane = (size_t)M * NIB;
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;

  // the carried history: extended frames 0 .. W-1, ring slots 0 .. W-1
  const size_t hplane = (size_t)W * plane;        // a stream's history
  for (size_t q = gtid; q < (size_t)p.B * hplane; q += gstride)
    p.ring[q / hplane * R * plane + q % hplane] = p.hist[q];

  const int nseg = (p.T + p.SEG - 1) / p.SEG;
  const int gp = kThreads * 16 / n;                 // pairs a block at once
  const int groups = ((M + 1) / 2 + gp - 1) / gp;  // of a frame
  for (int sg = 0; sg <= nseg; ++sg) {
    // A: analysis of segment sg, synthesis of segment sg - 1, of every
    // stream
    const int t0 = sg * p.SEG;
    const int F = sg < nseg ? min(p.SEG, p.T - t0) : 0;
    const int tp = t0 - p.SEG;
    const int Fp = sg > 0 ? min(p.SEG, p.T - tp) : 0;
    const int ni = F * groups + Fp;                 // items a stream
    for (int it = blockIdx.x; it < p.B * ni; it += gridDim.x) {
      const int sb = it / ni, item = it % ni;
      if (item < F * groups) {
        analyze_item(p, smem, sb, t0, sg, groups, item);
      } else {
        const int f = item - F * groups;
        const float dc = p.dc[((size_t)sb * 2 + ((sg - 1) & 1)) * p.SEG + f];
        bf_band::load_half_spectrum(smem, n, p.log2n, dc,
                                    p.ys + ((size_t)sb * p.SEG + f) * NIB,
                                    p.ib, NIB);
        bf_band::synthesize_frame(
            smem, p.tw, p.win, p.out_prev + (size_t)sb * p.hop,
            p.out + (size_t)sb * p.T * p.hop, p.new_prev + (size_t)sb * p.hop,
            p.T, p.hop, p.log2n, tp + f);
      }
    }
    if (sg == nseg) break;
    bf_band::grid_sync();

    // B: the solves of segment sg, of every stream
    const int ntb = (NIB + kBins - 1) / kBins;
    const int ntf = (F + kFrames - 1) / kFrames;
    for (int tile = blockIdx.x; tile < p.B * ntb * ntf; tile += gridDim.x) {
      const int tl = tile % (ntb * ntf);
      solve_tile<MP, SP, kLcmv>(p, smem, tile / (ntb * ntf), t0, F,
                                (tl % ntb) * kBins, (tl / ntb) * kFrames);
    }
    bf_band::grid_sync();
  }

  // the last W extended frames, oldest first
  for (size_t q = gtid; q < (size_t)p.B * hplane; q += gstride) {
    const size_t r = q % hplane;
    p.hist_out[q] = p.ring[q / hplane * R * plane +
                           (size_t)((p.T + r / plane) % R) * plane +
                           r % plane];
  }
}

// float2 elements of the dynamic shared memory of mega_kernel<MP, SP,
// kLcmv>: the larger of stage A's (the analysis FFT's padded frames, 17 x
// 256 for every nfft, or one nfft-point frame of the synthesis) and stage
// B's (the staged tile, the column buffers and LCMV's X scratch)
template <int MP, int SP, bool kLcmv>
size_t smem_elems(int W, int hop) {
  const size_t tile = (size_t)tile_elems<MP>(W) + cbuf_elems<MP>() +
                      (kLcmv ? (size_t)Shape<MP>::kSlots * SP * MP : 0);
  size_t e = (size_t)bf_fft::padded(kThreads * 16);
  if (e < (size_t)2 * hop) e = 2 * hop;
  return tile > e ? tile : e;
}

template <int MP, int SP, bool kLcmv>
cudaError_t launch_mega(const MegaArgs& a, cudaStream_t st) {
  const size_t smem = smem_elems<MP, SP, kLcmv>(a.W, a.hop) * sizeof(float2);
  cudaError_t err = cudaSuccess;
  const int grid = bf_band::resident_grid(mega_kernel<MP, SP, kLcmv>, smem,
                                          err);
  if (grid == 0) return err;
  MegaArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)mega_kernel<MP, SP, kLcmv>,
                                    dim3(grid), dim3(kThreads), params, smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_lanes(const MegaArgs& a, bool lcmv, cudaStream_t st) {
  if (!lcmv || a.S == 1) return launch_mega<MP, 1, false>(a, st);
#define BF_MEGA_SP(SPV)                                                    \
  if (a.S <= SPV && SPV <= MP)                                             \
    return launch_mega<MP, (SPV <= MP ? SPV : MP), true>(a, st);
  BF_MEGA_SP(2)
  BF_MEGA_SP(4)
  BF_MEGA_SP(8)
  BF_MEGA_SP(16)
#undef BF_MEGA_SP
  return cudaErrorInvalidValue;
}

}  // namespace

}  // namespace bf_mega
