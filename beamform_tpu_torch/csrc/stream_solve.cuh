// Device code of the streaming MVDR solve kernel (mvdr_stream.cu; GSS's
// kernel takes its complex helpers): the staged frame tile, the
// per-(frame, bin) window covariance with its Cholesky factor, and the
// (optionally refined) triangular solves. The LCMV stream kernel and the
// fused MVDR/LCMV kernel solve on tri_solve.cuh's layout, two rows a lane.
//
// Every (frame, bin) pair is an independent problem. A block takes kBins
// bins x kFrames frames and stages those frames plus their W-frame history
// once into shared memory, [kFrames + W][MP][kBins] (frame e < W is hist[e],
// else spec[e - W] read at the band's bin index; zeros past T, M or NIB). A
// problem is solved by MP lanes of a warp (a power of two, at most 32):
// lane i owns row i of R in registers, the right-looking Cholesky keeps the
// trailing block Hermitian so lane i also holds column entry A[i][k], and
// the factor, the triangular solves and the dot products exchange values by
// warp shuffles within the MP lanes. Rows beyond M are an identity block
// (zero spectra, unit diagonal), so the M x M solves are unchanged. Pivots
// use 1.f / sqrtf(), not rsqrtf(); no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf_stream {

constexpr int kThreads = 256;
constexpr int kBins = 8;      // bins per block
constexpr int kFrames = 32;   // frames per block; kBins * kFrames problems

template <int MP>
__device__ __forceinline__ float2 shfl(unsigned mask, float2 v, int src) {
  return make_float2(__shfl_sync(mask, v.x, src, MP),
                     __shfl_sync(mask, v.y, src, MP));
}

template <int MP>
__device__ __forceinline__ float2 group_sum(unsigned mask, float2 v) {
#pragma unroll
  for (int off = MP / 2; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(mask, v.x, off, MP);
    v.y += __shfl_xor_sync(mask, v.y, off, MP);
  }
  return v;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// Stage frames t0 .. t0 + kFrames + W - 1 of the extended sequence (hist,
// then spec at the band's bins) for bins b0 .. b0 + kBins - 1. A bin index
// outside [0, NB) stages NaN, so every output of its bin is NaN.
template <int MP>
__device__ __forceinline__ void stage_frames(float2* __restrict__ xs,
                                             const float2* __restrict__ spec,
                                             const int64_t* __restrict__ ib,
                                             const float2* __restrict__ hist,
                                             int T, int M, int NB, int NIB,
                                             int W, int b0, int t0) {
  const int ne = kFrames + W;
  const float nan = __int_as_float(0x7fc00000);
  for (int idx = threadIdx.x; idx < ne * MP * kBins; idx += kThreads) {
    const int bb = idx % kBins;
    const int m = (idx / kBins) % MP;
    const int e = t0 + idx / (kBins * MP);
    const int bin = b0 + bb;
    float2 v = make_float2(0.f, 0.f);
    if (m < M && bin < NIB) {
      if (e < W) {
        v = hist[((size_t)e * M + m) * NIB + bin];
      } else if (e - W < T) {
        const int64_t k = ib[bin];
        v = (k >= 0 && k < NB) ? spec[((size_t)(e - W) * M + m) * NB + k]
                               : make_float2(nan, nan);
      }
    }
    xs[idx] = v;
  }
}

// Row i of R = (sum of x x^H over the W staged frames before local frame
// lt, bin column bb) .* (ones + 0.001 I) into r, and its Cholesky factor:
// a[k] = L[i][k] for k < i, linv = 1 / L[i][i].
template <int MP>
__device__ __forceinline__ void covariance_cholesky(
    unsigned mask, const float2* __restrict__ xs, int lt, int bb, int i,
    int M, int W, float2 (&a)[MP], float2 (&r)[MP], float& linv) {
#pragma unroll
  for (int j = 0; j < MP; ++j) a[j] = make_float2(0.f, 0.f);
  for (int w = 0; w < W; ++w) {
    const float2* row = xs + (lt + w) * MP * kBins + bb;
    const float2 xi = row[i * kBins];
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const float2 o = cmul_conj(xi, row[j * kBins]);
      a[j] = make_float2(a[j].x + o.x, a[j].y + o.y);
    }
  }
  // R = S .* (ones + 0.001 I); real diagonal; identity rows beyond M
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    if (j == i) a[j] = make_float2(i < M ? a[j].x + 0.001f * a[j].x : 1.f,
                                   0.f);
    r[j] = a[j];
  }

  // right-looking Cholesky: a[k] becomes L[i][k] for k < i
  linv = 0.f;
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const float piv = __shfl_sync(mask, a[k].x, k, MP);
    const float il = 1.f / sqrtf(piv);
    if (i == k) linv = il;
    if (i > k) a[k] = make_float2(a[k].x * il, a[k].y * il);
#pragma unroll
    for (int j = k + 1; j < MP; ++j) {
      const float2 ljk = shfl<MP>(mask, a[k], j);  // L[j][k], in lane j
      if (i >= j) {
        const float2 p = cmul_conj(a[k], ljk);
        a[j] = make_float2(a[j].x - p.x, a[j].y - p.y);
      }
    }
  }
}

// L z = b with L's row ``i`` (strictly lower part) in l and 1/L[i][i] in
// linv; returns z_i.
template <int MP>
__device__ __forceinline__ float2 fwd_solve(unsigned mask,
                                            const float2 (&l)[MP], float linv,
                                            int i, float2 b) {
  float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const float2 zk = shfl<MP>(mask, make_float2(b.x * linv, b.y * linv), k);
    if (i == k) z = zk;
    if (i > k) {
      const float2 p = cmul(l[k], zk);
      b = make_float2(b.x - p.x, b.y - p.y);
    }
  }
  return z;
}

// L^H u = z; returns u_i.
template <int MP>
__device__ __forceinline__ float2 bwd_solve(unsigned mask,
                                            const float2 (&l)[MP], float linv,
                                            int i, float2 z) {
  float2 u = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = MP - 1; k >= 0; --k) {
    // sum over rows j > k of conj(L[j][k]) u_j
    float2 p = make_float2(0.f, 0.f);
    if (i > k) p = cmul_conj(u, l[k]);
    p = group_sum<MP>(mask, p);
    if (i == k) u = make_float2((z.x - p.x) * linv, (z.y - p.y) * linv);
  }
  return u;
}

// u = R^-1 b by the factor, then one refinement pass u += R^-1 (b - R u)
// against the kept rows r of R; returns u_i.
template <int MP>
__device__ __forceinline__ float2 refined_solve(unsigned mask,
                                                const float2 (&a)[MP],
                                                const float2 (&r)[MP],
                                                float linv, int i, float2 b) {
  float2 u = bwd_solve<MP>(mask, a, linv, i,
                           fwd_solve<MP>(mask, a, linv, i, b));
  float2 ru = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    const float2 p = cmul(r[j], shfl<MP>(mask, u, j));
    ru = make_float2(ru.x + p.x, ru.y + p.y);
  }
  const float2 c = bwd_solve<MP>(
      mask, a, linv, i,
      fwd_solve<MP>(mask, a, linv, i, make_float2(b.x - ru.x, b.y - ru.y)));
  return make_float2(u.x + c.x, u.y + c.y);
}

}  // namespace bf_stream
