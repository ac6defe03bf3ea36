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
//              constraint-space solve (tri_solve.cuh lcmv_apply); the
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
//   A  analysis of segment s: a block takes one frame and a group of
//      channel pairs (two real channels per complex FFT), 16 points a
//      thread in registers (reg_fft.cuh, as wola_analysis_kernel), and
//      keeps the band's bins; overlapped with the synthesis of segment
//      s - 1 (one block per frame, band_wola.cuh)
//   -- grid barrier --
//   B  the solves of segment s: every (frame, bin) pair is an independent
//      problem (R_t depends only on the W frames before t, so no sum is
//      carried from frame to frame and no segment waits for another's
//      march); a block stages 32 frames x 8 bins plus the W-frame history
//      into shared memory, and MP / 2 lanes solve one problem, lane l
//      holding rows l and MP - 1 - l of R's lower triangle (tri_solve.cuh;
//      four problems a warp at 16 mics). The MVDR form, unrefined, is two
//      forward solves in one pass (u^H x = z^H xi, d^H u = z^H z); LCMV
//      solves its constraint columns up to four at a time
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
// What bounds it: the solves' instruction issue, as in lcmv_stream.cu (the
// window covariance, the factor's column broadcasts and updates, ~40 k
// flop a problem), not bytes (92 MB of audio in, 5.8 MB out). On an NVIDIA
// H100 80GB HBM3 at 700 W an MVDR call at 16 mics, 1,407 frames and 678
// bins takes 1.72 ms: stage A 0.40 ms, stage B 1.26 ms (482 SM-cycles a
// solved problem in all; of stage B the factor 132, the window covariance
// 90, the staging 33, the forward pass 33), the grid barriers 0.06 ms
// (PERF.md section 6).
//
// Streams. One launch serves B streams, which share the control rows:
// stage A's items and stage B's tiles range over every stream's, each with
// its own audio, carries, history, control indices and scratch (the ring
// then holds B segments, 71 MB at 8 streams of 93 frames, and no longer
// fits the L2 cache), and each stream's synthesis adds only into its own
// output row. A single stream is B = 1.
//
// Index checks run here, not on the host: a bin index outside [1, nfft / 2)
// gives NaN output for its frames, a control index outside [0, U) NaN
// solves for its frame. Neither is dereferenced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mega_stream.cuh"


extern "C" {

// B streams in one launch: x (B, M, T*hop), tail (B, M, hop), out_prev
// (B, hop) float32; hist (B, W, M, NIB) complex64; ctrl (U, S, M, NIB)
// complex64, shared; idx (B, T), ib (NIB,) int64; win (2*hop) float32, tw
// (hop) complex64, ptw the pass twiddles of kernels/wola.py analysis_plan
// (complex64); out (B, T*hop), new_prev (B, hop) float32; hist_out (B, W,
// M, NIB) complex64; scratch ring (B, SEG + W, M, NIB) and ys (B, SEG, NIB)
// complex64, dc (B, 2, SEG) float32. B >= 1, 1 <= M <= 32, 1 <= S <= 16,
// W >= 1, T >= 1, 1 <= SEG. ``lcmv`` 0 takes ctrl as MVDR steering (S = 1).
// Returns the first CUDA error of the memset, the launch or its check.
int bf_mega_stream(const void* x, const void* tail, const void* out_prev,
                   const void* hist, const void* ctrl, const void* idx,
                   const void* ib, const void* win, const void* tw,
                   const void* ptw, void* out,
                   void* new_prev, void* hist_out, void* ring, void* ys,
                   void* dc, int B, int M, int T, int hop, int NIB, int W,
                   int U, int S, int SEG, float thr, int refine, int lcmv,
                   void* stream) {
  if (B < 1 || M < 1 || M > 32 || S < 1 || S > 16 || (!lcmv && S != 1) ||
      W < 1 || T < 1 || SEG < 1 || NIB < 1 || hop < 128 || hop > 2048 ||
      (hop & (hop - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * T * hop * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  bf_mega::MegaArgs a;
  a.x = (const float*)x;
  a.tail = (const float*)tail;
  a.out_prev = (const float*)out_prev;
  a.hist = (const float2*)hist;
  a.ctrl = (const float2*)ctrl;
  a.idx = (const int64_t*)idx;
  a.ib = (const int64_t*)ib;
  a.win = (const float*)win;
  a.tw = (const float2*)tw;
  a.ptw = (const float2*)ptw;
  a.out = (float*)out;
  a.new_prev = (float*)new_prev;
  a.hist_out = (float2*)hist_out;
  a.ring = (float2*)ring;
  a.ys = (float2*)ys;
  a.dc = (float*)dc;
  a.B = B;
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
  const int n = l && S > M ? S : M;                 // MP: max(M, S)
  if (n <= 4) return (int)bf_mega::launch_lanes<4>(a, l, st);
  if (n <= 8) return (int)bf_mega::launch_lanes<8>(a, l, st);
  if (n <= 16) return (int)bf_mega::launch_16(a, l, st);
  return (int)bf_mega::launch_32(a, l, st);
}

}  // extern "C"
