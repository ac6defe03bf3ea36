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
// Design. As the MVDR kernel (mvdr_stream.cu), every (frame, bin) pair is
// an independent problem: the block stages 8 bins x 32 frames and their
// W-frame history once, each window sum is recomputed from the frames it
// covers (chunked output equals offline output bit for bit), and LP lanes
// solve one problem with row i of R, and of its Cholesky factor, in lane i
// (stream_solve.cuh). LP is M or S, whichever is larger, rounded up to a
// power of two, so the S x S inner system also has one row per lane. The
// constraint columns are solved one slot at a time, each as MVDR's refined
// solve, and X goes to a small shared-memory scratch ([SP][LP] per problem
// in flight) rather than registers: lane a then forms row a of G from
// column a of C and all of X, the Gauss-Jordan elimination exchanges the
// pivot row by shuffles (lane a holding row a of G and of G^-1), and lane i
// forms w_i = sum_a X[i][a] v_a. A zero column's solve is skipped: it is
// exactly zero for any finite factor, and with a non-finite factor the
// always-active look-direction column makes the output non-finite anyway.
//
// What bounds it: as the MVDR kernel, chains of dependent warp shuffles,
// now one refined solve per active slot (~200 shuffles each) on top of the
// window sum and the factor (~140), plus 4 SP^2 shuffles for the inner
// elimination. Registers: the factor and R's row (4 LP floats) are dead by
// the time the inner system's three rows (6 SP floats) are live.
//
// The index tensors are checked here, not on the host: a bin index outside
// [0, NB) makes every output of its bin NaN, a control-row index outside
// [0, U) every solved output of its frame. Neither is dereferenced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_solve.cuh"

namespace {

using namespace bf_stream;

// 1 / p as conj(p) / |p|^2
__device__ __forceinline__ float2 crecip(float2 p) {
  const float inv_den = 1.f / (p.x * p.x + p.y * p.y);
  return make_float2(p.x * inv_den, -p.y * inv_den);
}

template <int LP, int SP>
__global__ void __launch_bounds__(kThreads)
    lcmv_stream_kernel(const float2* __restrict__ spec,
                       const int64_t* __restrict__ ib,
                       const float2* __restrict__ hist,
                       const float2* __restrict__ c,
                       const int64_t* __restrict__ idx,
                       const uint8_t* __restrict__ gate,
                       float2* __restrict__ y, int T, int M, int NB, int NIB,
                       int W, int U, int S) {
  extern __shared__ float2 smem[];
  float2* xs = smem;                        // [kFrames + W][LP][kBins]
  const int b0 = blockIdx.x * kBins;
  const int t0 = blockIdx.y * kFrames;
  const float nan = __int_as_float(0x7fc00000);
  stage_frames<LP>(xs, spec, ib, hist, T, M, NB, NIB, W, b0, t0);
  __syncthreads();

  constexpr int kSlots = kThreads / LP;
  const int slot = threadIdx.x / LP;
  const int i = threadIdx.x % LP;                   // row of R and of G
  // X of this problem, [a][i]
  float2* xp = smem + (size_t)(kFrames + W) * LP * kBins + slot * SP * LP;
  // this problem's lanes within the warp: its shuffles, ballots and warp
  // barriers name only them, so two problems sharing a warp may branch
  // apart (a skipped zero column in one, a solve in the other)
  const unsigned grp =
      LP == 32 ? 0xffffffffu
               : ((1u << (LP % 32)) - 1u) << ((threadIdx.x % 32) / LP * LP);
  for (int it = 0; it < kBins * kFrames / kSlots; ++it) {
    const int p = slot + it * kSlots;
    const int bb = p % kBins;
    const int lt = p / kBins;
    const int t = t0 + lt;
    const int bin = b0 + bb;
    const bool valid = t < T && bin < NIB;
    const size_t out = (size_t)t * NIB + bin;
    const bool act = valid && gate[out];
    const unsigned mask = __ballot_sync(0xffffffffu, act) & grp;
    const float2 xt = xs[((lt + W) * LP + i) * kBins + bb];
    if (!act) {
      if (valid && i == 0) y[out] = make_float2(0.01f * xt.x, 0.01f * xt.y);
      continue;
    }

    float2 a[LP], r[LP];
    float linv;
    covariance_cholesky<LP>(mask, xs, lt, bb, i, M, W, a, r, linv);

    // X_a = R^-1 C_a, slot by slot; bit a of ``zero``: column a is zero
    const int64_t u = idx[t];
    const bool bad = u < 0 || u >= U;
    const float2* cu = c + (size_t)(bad ? 0 : u) * S * M * NIB + bin;
    unsigned zero = 0;
    for (int s = 0; s < S; ++s) {
      float2 cs = make_float2(0.f, 0.f);
      if (bad)
        cs = make_float2(nan, nan);
      else if (i < M)
        cs = cu[((size_t)s * M + i) * NIB];
      const bool nz = cs.x != 0.f || cs.y != 0.f;
      float2 xsol = make_float2(0.f, 0.f);
      if (__ballot_sync(mask, nz) == 0)
        zero |= 1u << s;
      else
        xsol = refined_solve<LP>(mask, a, r, linv, i, cs);
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
                              : cu[((size_t)i * M + m) * NIB];
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
      const float2 f = g[k];                        // G[i][k]
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
    const float2 yv = group_sum<LP>(mask, cmul_conj(xt, w));
    if (i == 0) y[out] = yv;
    __syncwarp(mask);                               // xp is reused
  }
}

template <int LP, int SP>
cudaError_t launch_lcmv(const float2* spec, const int64_t* ib,
                        const float2* hist, const float2* c,
                        const int64_t* idx, const uint8_t* gate, float2* y,
                        int T, int M, int NB, int NIB, int W, int U, int S,
                        cudaStream_t st) {
  const size_t smem = ((size_t)(kFrames + W) * LP * kBins
                       + (size_t)kThreads / LP * SP * LP) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lcmv_stream_kernel<LP, SP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((NIB + kBins - 1) / kBins, (T + kFrames - 1) / kFrames);
  lcmv_stream_kernel<LP, SP><<<grid, kThreads, smem, st>>>(
      spec, ib, hist, c, idx, gate, y, T, M, NB, NIB, W, U, S);
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_lanes(const float2* spec, const int64_t* ib,
                         const float2* hist, const float2* c,
                         const int64_t* idx, const uint8_t* gate, float2* y,
                         int T, int M, int NB, int NIB, int W, int U, int S,
                         cudaStream_t st) {
#define BF_LCMV_SP(SPV)                                                    \
  if (S <= SPV && SPV <= LP)                                               \
    return launch_lcmv<LP, (SPV <= LP ? SPV : LP)>(                        \
        spec, ib, hist, c, idx, gate, y, T, M, NB, NIB, W, U, S, st);
  BF_LCMV_SP(1)
  BF_LCMV_SP(2)
  BF_LCMV_SP(4)
  BF_LCMV_SP(8)
  BF_LCMV_SP(16)
#undef BF_LCMV_SP
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// spec (T, M, NB) complex64; ib (NIB,) int64 bin indices into NB; hist
// (W, M, NIB), c (U, S, M, NIB) complex64; idx (T,) int64 into U; gate
// (T, NIB) bool; y (T, NIB) complex64 out. 1 <= M <= 32, 1 <= S <= 16,
// W >= 1. An index out of range gives NaN outputs. Returns the launch's
// cudaGetLastError().
int bf_lcmv_stream(const void* spec, const void* ib, const void* hist,
                   const void* c, const void* idx, const void* gate, void* y,
                   int T, int M, int NB, int NIB, int W, int U, int S,
                   void* stream) {
  const float2* sp = (const float2*)spec;
  const int64_t* b = (const int64_t*)ib;
  const float2* h = (const float2*)hist;
  const float2* cc = (const float2*)c;
  const int64_t* ix = (const int64_t*)idx;
  const uint8_t* g = (const uint8_t*)gate;
  float2* out = (float2*)y;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > 32 || S < 1 || S > 16) return (int)cudaErrorInvalidValue;
  const int n = M > S ? M : S;                      // lanes: max(M, S)
  if (n <= 4)
    return (int)launch_lanes<4>(sp, b, h, cc, ix, g, out, T, M, NB, NIB, W,
                                U, S, st);
  if (n <= 8)
    return (int)launch_lanes<8>(sp, b, h, cc, ix, g, out, T, M, NB, NIB, W,
                                U, S, st);
  if (n <= 16)
    return (int)launch_lanes<16>(sp, b, h, cc, ix, g, out, T, M, NB, NIB, W,
                                 U, S, st);
  return (int)launch_lanes<32>(sp, b, h, cc, ix, g, out, T, M, NB, NIB, W, U,
                               S, st);
}

}  // extern "C"
