// Streaming LCMV solve for Hopper (sm_90a), bound with ctypes.
//
// lcmv_stream_kernel replaces beamform_tpu/kernels/lcmv_stream.py:_kernel
// (reached through lcmv_stream_pallas / lcmv_stream_planes_pallas), whose
// algebra is lcmv_stream.py:constraint_space_apply. For every in-band bin b
// and frame t whose energy gate passes (lcmv.cpp:108-138):
//
//   R   = (sum of x x^H over the W frames before t) .* (ones + 0.001 I)
//   X_a = R^-1 C_a        per constraint slot a: Cholesky, one refinement
//   G   = C^H X           S x S; G[a][a] += 1 where column a of C is zero
//   v   = G^-1 e0         unpivoted Gauss-Jordan, then one residual step
//   y   = (X v)^H x_t
//
// and y = 0.01 * x_t[mic 0] where the gate fails, selected by a branch,
// never by a multiply: a cold-start covariance is singular and its solve is
// NaN. C is (U, S, M, NIB), one constraint set per unique control row, and
// idx (T,) picks each frame's row. Inactive slots have all-zero columns
// (the fixed-capacity masked timeline); the identity added on their
// diagonal makes G block-diagonal, so v restricted to the active slots is
// exactly the smaller problem's.
//
// Design. Every (frame, bin) pair is an independent problem. A block
// stages 8 bins x 32 frames and their W-frame history once, each window sum
// is recomputed from the frames it covers (chunked output equals offline
// output bit for bit), and MP / 2 lanes solve one problem, lane l holding
// rows l and MP - 1 - l of R's lower triangle and of its Cholesky factor
// (tri_solve.cuh): MP = max(M, S) rounded up to a power of two, so at 16
// mics a warp solves four problems. The constraint columns are solved up to
// four at a time, each broadcast of the forward and backward solves and of
// the refinement carrying all of them; X goes to a small
// shared-memory scratch ([SP][MP] per problem in flight). The inner system
// is solved on slot 0 and the nonzero columns: G's entries are sums over
// the problem's lanes of C^H X at each lane's two rows, and lane a holds row
// a of G and of G^-1 for the Gauss-Jordan elimination (two rows a lane past
// MP / 2 slots). A zero column's solve is skipped: it is exactly zero for
// any finite factor, and with a non-finite factor the always-active
// look-direction column makes the output non-finite anyway.
//
// What bounds it: instruction issue, not bytes or latency alone. A
// problem at 16 mics costs about 40 k flop against 1.3 KB of spectra read
// once per block; the factor's column broadcasts are 16-byte shared-memory
// reads that serve four problems, the backward solves' sums over lanes (3
// butterfly levels a step) and the refinement's residual (one sum a staged
// frame) are the shuffles left. On an NVIDIA H100 80GB HBM3 at 700 W, at
// 16 mics, 678 bins, 1,407 frames and W = 10 (97.85% of the pairs
// solved), a call takes 1.86 ms at S = 1, 522 SM-cycles a solved problem:
// the factor 121, the refinement 101, the window covariance 77, the
// staging 69, the backward solve 48; and 4.40 ms at S = 3, where the
// refinements of its two column pairs (419) and the inner system (187)
// lead (PERF.md section 6).
//
// Streams. One launch serves B streams, the grid's z index the stream: the
// spectra are the (T, B, M, NB) analysis output of all B * M channels, read
// in place, hist, idx, gate and y carry a leading stream axis, and the
// constraint sets c are shared. A single stream is B = 1.
//
// The index tensors are checked here, not on the host: a bin index outside
// [0, NB) makes every output of its bin NaN, a control-row index outside
// [0, U) every solved output of its frame. Neither is dereferenced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lcmv_stream.cuh"

extern "C" {

// B streams in one launch: spec (T, B, M, NB) complex64 (the analysis
// output of the B * M channels); ib (NIB,) int64 bin indices into NB; hist
// (B, W, M, NIB) complex64; c (U, S, M, NIB) complex64, shared; idx (B, T)
// int64 into U; gate (B, T, NIB) bool; y (B, T, NIB) complex64 out.
// 1 <= B <= 65535, 1 <= M <= 32, 1 <= S <= 16, W >= 1. An index out of
// range gives NaN outputs. Returns the launch's cudaGetLastError().
int bf_lcmv_stream(const void* spec, const void* ib, const void* hist,
                   const void* c, const void* idx, const void* gate, void* y,
                   int B, int T, int M, int NB, int NIB, int W, int U, int S,
                   void* stream) {
  const float2* sp = (const float2*)spec;
  const int64_t* b = (const int64_t*)ib;
  const float2* h = (const float2*)hist;
  const float2* cc = (const float2*)c;
  const int64_t* ix = (const int64_t*)idx;
  const uint8_t* g = (const uint8_t*)gate;
  float2* out = (float2*)y;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || M < 1 || M > 32 || S < 1 || S > 16)
    return (int)cudaErrorInvalidValue;
  const int n = M > S ? M : S;                      // MP: max(M, S)
  if (n <= 4)
    return (int)bf_lcmv::launch_lanes<4>(sp, b, h, cc, ix, g, out, B, T,
                                         M, NB, NIB, W, U, S, st);
  if (n <= 8)
    return (int)bf_lcmv::launch_lanes<8>(sp, b, h, cc, ix, g, out, B, T,
                                         M, NB, NIB, W, U, S, st);
  if (n <= 16)
    return (int)bf_lcmv::launch_16(sp, b, h, cc, ix, g, out, B, T, M, NB, NIB,
                                   W, U, S, st);
  return (int)bf_lcmv::launch_32(sp, b, h, cc, ix, g, out, B, T, M, NB, NIB,
                                 W, U, S, st);
}

}  // extern "C"
