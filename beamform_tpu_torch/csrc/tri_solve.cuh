// The per-(frame, bin) covariance solve of the streaming MVDR and LCMV
// kernels (mvdr_stream.cu, lcmv_stream.cu) and the fused MVDR/LCMV kernel
// (mega_stream.cu), laid out so that a warp solves several problems at once.
//
// Every (frame, bin) pair is an independent problem: R = (sum of x x^H over
// the W frames before t) .* (ones + 0.001 I), its Cholesky factor L, and
// triangular solves against it. MP is the problem's size (max(M, S) rounded
// up to a power of two, at least 4; rows past M are an identity block with
// zero spectra, so the M x M solves are unchanged). A problem takes
// H = MP / 2 lanes of a warp, and lane l holds two rows of R's lower
// triangle, rows l ("lo") and MP - 1 - l ("hi"): l + 1 and MP - l entries,
// MP + 1 in every lane. At 16 mics a warp holds four problems, so every
// shuffle, every broadcast read and every FMA instruction serves four.
//
// The staged tile. A block takes kBins bins x kFrames frames and stages
// those frames plus their W-frame history once into shared memory, frame e
// of bin bb at (e kBins + bb) LD, its MP rows contiguous (LD = MP + 2, so
// that the four problems of a warp read distinct banks). Each window sum is
// taken directly over the W frames it covers, in frame order, so no sum
// depends on where a chunk starts and chunked output equals offline output
// bit for bit.
//
// The window covariance forms the lane's two rows, 3 MP / 2 products a
// lane and a frame (the 136 entries of the lower triangle at 16 mics, and
// no more than 56 others), from 16-byte broadcast reads of the frame.
//
// The factor is right-looking. At step k the pivot comes by one shuffle
// from its row's lane; each lane scales its column-k entries and writes
// them to a column buffer in shared memory (two per problem, used in turn,
// so that one warp barrier a step orders the writes and the reads); every
// lane reads the column below the pivot with 16-byte broadcast reads and
// updates its two rows. Entries past a row's diagonal are never read, so
// the factor runs without predicates: a lane updates them anyway.
//
// The solves take up to max_rhs() right-hand sides at once, so that the
// chains of dependent shuffles of LCMV's constraint columns run side by
// side. Forward: z_k = b_k / L_kk by one shuffle per column and step, each
// lane updating its two rows. Backward (L^H u = z): a column of L is spread
// over the lanes, so each step is a sum over the problem's lanes
// (log2 H butterfly shuffles per column). One refinement pass forms the
// residual b - R u from the staged frames, R u = sum_w x_w (x_w^H u) +
// d .* u (d = 0.001 S_ii, 1 past M), so no row of R is kept in registers.
//
// Unrefined MVDR needs no backward solve: with z = L^-1 d and xi = L^-1 x_t
// (one forward pass, two columns), u^H x_t = z^H xi and d^H u = z^H z.
//
// With more than one constraint slot, LCMV's inner system sums with
// compensated float32 arithmetic (CSum): G = C^H X, the residual e0 - G v
// of its Gauss-Jordan solve and y = (X v)^H x_t. Once X is refined against
// the staged frames, those sums' rounding is what is left of the error
// where R is well conditioned (W > M), and compensating them about halves
// it; with one slot the inner system is a scalar and plain sums do.
//
// Pivots use 1.f / sqrtf(), not rsqrtf(); no fast-math intrinsics; float32
// FMAs only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_solve.cuh"

namespace bf_tri {

// stream_solve.cuh's tile size, complex products and shuffles; here the
// shuffles' width is the lanes of one problem, MP / 2
using bf_stream::cmul;
using bf_stream::cmul_conj;
using bf_stream::group_sum;
using bf_stream::kBins;
using bf_stream::kFrames;
using bf_stream::kThreads;
using bf_stream::shfl;

// right-hand sides a solve carries at once: four while the factor is
// small, two from 16 rows up (more would spill at 128 registers a thread)
template <int MP>
__host__ __device__ constexpr int max_rhs() {
  return MP <= 8 ? 4 : 2;
}

template <int MP>
struct Shape {
  static_assert(MP >= 4 && MP <= 32 && (MP & (MP - 1)) == 0, "MP");
  static constexpr int H = MP / 2;             // lanes of a problem
  static constexpr int LD = MP + 2;            // staged frame stride
  static constexpr int CB = 2 * MP + 2;        // column buffers a problem
  static constexpr int kSlots = kThreads / H;  // problems in flight a block
};

// float2 offset of the first column buffer after a tile of W history
// frames; the LCMV scratch follows the column buffers
template <int MP>
__host__ __device__ constexpr int tile_elems(int W) {
  return (kFrames + W) * kBins * Shape<MP>::LD;
}
template <int MP>
__host__ __device__ constexpr int cbuf_elems() {
  return Shape<MP>::kSlots * Shape<MP>::CB;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
// 1 / p as conj(p) / |p|^2
__device__ __forceinline__ float2 crecip(float2 p) {
  const float inv_den = 1.f / (p.x * p.x + p.y * p.y);
  return make_float2(p.x * inv_den, -p.y * inv_den);
}
__device__ __forceinline__ bool nonzero(float2 v) {
  return v.x != 0.f || v.y != 0.f;
}

// A complex sum carried as s + c: s the rounded sum, c its rounding
// errors, each term added exactly (TwoProd by an FMA, Knuth's TwoSum), so
// that the result is as if summed in twice the precision and rounded once
// (Ogita, Rump and Oishi, "Accurate sum and dot product", 2005). Float32
// operations only; the compiler neither contracts nor reassociates them
// (no fast-math).
struct CSum {
  float2 s, c;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// v += a * b, for one real product
__device__ __forceinline__ void add_prod(float& s, float& c, float a,
                                         float b) {
  const float p = __fmul_rn(a, b);
  const float e = __fmaf_rn(a, b, -p);
  float t;
  two_sum(s, p, s, t);
  c = __fadd_rn(c, __fadd_rn(e, t));
}

__device__ __forceinline__ CSum csum(float2 v) {
  return CSum{v, make_float2(0.f, 0.f)};
}

// acc += a * b (complex)
__device__ __forceinline__ void csum_mul(CSum& acc, float2 a, float2 b) {
  add_prod(acc.s.x, acc.c.x, a.x, b.x);
  add_prod(acc.s.x, acc.c.x, -a.y, b.y);
  add_prod(acc.s.y, acc.c.y, a.x, b.y);
  add_prod(acc.s.y, acc.c.y, a.y, b.x);
}

__device__ __forceinline__ float2 csum_value(const CSum& a) {
  return make_float2(__fadd_rn(a.s.x, a.c.x), __fadd_rn(a.s.y, a.c.y));
}

// the sum of a CSum over the problem's H lanes, rounded once
template <int H>
__device__ __forceinline__ float2 group_csum(unsigned mask, CSum v) {
#pragma unroll
  for (int off = H / 2; off > 0; off >>= 1) {
    const float sx = __shfl_xor_sync(mask, v.s.x, off, H);
    const float sy = __shfl_xor_sync(mask, v.s.y, off, H);
    const float cx = __shfl_xor_sync(mask, v.c.x, off, H);
    const float cy = __shfl_xor_sync(mask, v.c.y, off, H);
    float t;
    two_sum(v.s.x, sx, v.s.x, t);
    v.c.x = __fadd_rn(v.c.x, __fadd_rn(cx, t));
    two_sum(v.s.y, sy, v.s.y, t);
    v.c.y = __fadd_rn(v.c.y, __fadd_rn(cy, t));
  }
  return csum_value(v);
}

// the lanes of the warp that hold this thread's problem
template <int MP>
__device__ __forceinline__ unsigned group_mask() {
  constexpr int H = Shape<MP>::H;
  return ((1u << H) - 1u) << ((threadIdx.x % 32) & ~(H - 1));
}

// Stage frames t0 .. t0 + kFrames + W - 1 of the extended sequence (hist,
// then spec at the band's bins) for bins b0 .. b0 + kBins - 1. spec holds
// one stream's (M, NB) plane a frame, fs elements apart (M * NB times the
// streams of the analysis output it is a view of). A bin index outside
// [0, NB) stages NaN, so every output of its bin is NaN.
template <int MP>
__device__ __forceinline__ void stage_spec(float2* __restrict__ xs,
                                           const float2* __restrict__ spec,
                                           const int64_t* __restrict__ ib,
                                           const float2* __restrict__ hist,
                                           int T, int M, int NB, int NIB,
                                           int W, int b0, int t0, size_t fs) {
  constexpr int LD = Shape<MP>::LD;
  const int ne = kFrames + W;
  const float nan = __int_as_float(0x7fc00000);
  for (int q = threadIdx.x; q < ne * MP * kBins; q += kThreads) {
    const int bb = q % kBins;
    const int m = (q / kBins) % MP;
    const int el = q / (kBins * MP);
    const int e = t0 + el;
    const int bin = b0 + bb;
    float2 v = make_float2(0.f, 0.f);
    if (m < M && bin < NIB) {
      if (e < W) {
        v = hist[((size_t)e * M + m) * NIB + bin];
      } else if (e - W < T) {
        const int64_t k = ib[bin];
        v = (k >= 0 && k < NB)
                ? spec[(size_t)(e - W) * fs + (size_t)m * NB + k]
                : make_float2(nan, nan);
      }
    }
    xs[(el * kBins + bb) * LD + m] = v;
  }
}

// The factor of one problem, in the registers of lane l: hi[j] = L[MP-1-l][j]
// for j <= MP - 1 - l, lo[j] = L[l][j] for j <= l (entries past the
// diagonal are scratch), ihi / ilo = 1 / the diagonal, and dhi / dlo the
// diagonal term of R u (0.001 S_ii, 1 past M).
template <int MP>
struct Factor {
  float2 hi[MP];
  float2 lo[MP / 2];
  float ihi, ilo, dhi, dlo;
};

// The staged frame e of the problem's bin.
template <int MP>
__device__ __forceinline__ const float2* frame(const float2* xs, int e,
                                               int bb) {
  return xs + (e * kBins + bb) * Shape<MP>::LD;
}

// R of the problem at local frame lt, bin column bb (the W staged frames
// lt .. lt + W - 1 before it) and its Cholesky factor into f. cb is the
// problem's pair of column buffers (2 MP float2, 16-byte aligned).
template <int MP>
__device__ __forceinline__ void covariance_factor(unsigned mask,
                                                  const float2* xs,
                                                  float2* cb, int lt, int bb,
                                                  int l, int M, int W,
                                                  Factor<MP>& f) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
  __syncwarp(mask);             // the last problem's reads of cb are done
#pragma unroll
  for (int j = 0; j < MP; ++j) f.hi[j] = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < H; ++j) f.lo[j] = make_float2(0.f, 0.f);
  for (int w = 0; w < W; ++w) {
    const float2* row = frame<MP>(xs, lt + w, bb);
    const float2 xl = row[l], xh = row[rh];
#pragma unroll
    for (int j = 0; j < MP; j += 2) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      const float2 a = make_float2(v.x, v.y), b = make_float2(v.z, v.w);
      f.hi[j] = cadd(f.hi[j], cmul_conj(xh, a));
      f.hi[j + 1] = cadd(f.hi[j + 1], cmul_conj(xh, b));
      const int j0 = j < H ? j : 0, j1 = j + 1 < H ? j + 1 : 0;
      if (j < H) f.lo[j0] = cadd(f.lo[j0], cmul_conj(xl, a));
      if (j + 1 < H) f.lo[j1] = cadd(f.lo[j1], cmul_conj(xl, b));
    }
  }
  // R = S .* (ones + 0.001 I): real diagonal; identity rows beyond M
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    if (j == rh) {
      const float s = f.hi[j].x;
      f.dhi = rh < M ? 0.001f * s : 1.f;
      f.hi[j] = make_float2(rh < M ? s + f.dhi : 1.f, 0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (j == l) {
      const float s = f.lo[j].x;
      f.dlo = l < M ? 0.001f * s : 1.f;
      f.lo[j] = make_float2(l < M ? s + f.dlo : 1.f, 0.f);
    }
  }

  f.ihi = f.ilo = 0.f;
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const bool klo = k < H;
    const int kl = klo ? k : 0;
    const float pv = klo ? f.lo[kl].x : f.hi[k].x;
    const float piv = __shfl_sync(mask, pv, klo ? k : MP - 1 - k, H);
    const float il = 1.f / sqrtf(piv);
    if (klo) {
      if (l == k) f.ilo = il;
    } else if (rh == k) {
      f.ihi = il;
    }
    if (k + 1 < MP) {
      f.hi[k] = cscale(f.hi[k], il);
      if (klo) f.lo[kl] = cscale(f.lo[kl], il);
      float2* c = cb + (k & 1) * MP;
      c[rh] = f.hi[k];
      if (klo) c[l] = f.lo[kl];
      __syncwarp(mask);
#pragma unroll
      for (int j = (k + 1) & ~1; j < MP; j += 2) {
        const float4 v = *reinterpret_cast<const float4*>(c + j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + e;
          if (jj <= k) continue;
          const float2 cj = e ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
          f.hi[jj] = csub(f.hi[jj], cmul_conj(f.hi[k], cj));
          if (klo && jj < H) {
            const int jl = jj < H ? jj : 0;
            f.lo[jl] = csub(f.lo[jl], cmul_conj(f.lo[kl], cj));
          }
        }
      }
    }
  }
}

// L z = b for NR columns: b (the lane's two rows of each) in, z out.
template <int MP, int NR>
__device__ __forceinline__ void fwd_solve(unsigned mask, const Factor<MP>& f,
                                          int l, const float2 (&bl)[NR],
                                          const float2 (&bh)[NR],
                                          float2 (&zl)[NR],
                                          float2 (&zh)[NR]) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
  float2 rl[NR], rr[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    rl[c] = bl[c];
    rr[c] = bh[c];
    zl[c] = zh[c] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const bool klo = k < H;
    const int kl = klo ? k : 0;
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const float2 t = klo ? cscale(rl[c], f.ilo) : cscale(rr[c], f.ihi);
      const float2 zk = shfl<H>(mask, t, klo ? k : MP - 1 - k);
      if (klo) {
        if (l == k) zl[c] = zk;
        rl[c] = csub(rl[c], cmul(f.lo[kl], zk));
      } else if (rh == k) {
        zh[c] = zk;
      }
      rr[c] = csub(rr[c], cmul(f.hi[k], zk));
    }
  }
}

// L^H u = z for NR columns: z in, u out.
template <int MP, int NR>
__device__ __forceinline__ void bwd_solve(unsigned mask, const Factor<MP>& f,
                                          int l, const float2 (&zl)[NR],
                                          const float2 (&zh)[NR],
                                          float2 (&ul)[NR],
                                          float2 (&uh)[NR]) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
#pragma unroll
  for (int c = 0; c < NR; ++c) ul[c] = uh[c] = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = MP - 1; k >= 0; --k) {
    const bool klo = k < H;
    const int kl = klo ? k : 0;
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      // sum over rows j > k of conj(L[j][k]) u_j
      float2 p = make_float2(0.f, 0.f);
      if (rh > k) p = cmul_conj(uh[c], f.hi[k]);
      if (klo && l > k) p = cadd(p, cmul_conj(ul[c], f.lo[kl]));
      p = group_sum<H>(mask, p);
      if (klo) {
        if (l == k) ul[c] = cscale(csub(zl[c], p), f.ilo);
      } else if (rh == k) {
        uh[c] = cscale(csub(zh[c], p), f.ihi);
      }
    }
  }
}

// R u for NR columns from the staged frames: sum_w x_w (x_w^H u) + d .* u.
template <int MP, int NR>
__device__ __forceinline__ void apply_r(unsigned mask, const float2* xs,
                                        int lt, int bb, int l, int W,
                                        const Factor<MP>& f,
                                        const float2 (&ul)[NR],
                                        const float2 (&uh)[NR],
                                        float2 (&rl)[NR], float2 (&rr)[NR]) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    rl[c] = cscale(ul[c], f.dlo);
    rr[c] = cscale(uh[c], f.dhi);
  }
  for (int w = 0; w < W; ++w) {
    const float2* row = frame<MP>(xs, lt + w, bb);
    const float2 xl = row[l], xh = row[rh];
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const float2 d = group_sum<H>(
          mask, cadd(cmul_conj(ul[c], xl), cmul_conj(uh[c], xh)));
      rl[c] = cadd(rl[c], cmul(xl, d));
      rr[c] = cadd(rr[c], cmul(xh, d));
    }
  }
}

// u = R^-1 b for NR columns by the factor, refined once when ``refine``:
// b in, u out (in place).
template <int MP, int NR>
__device__ __forceinline__ void solve(unsigned mask, const float2* xs, int lt,
                                      int bb, int l, int W,
                                      const Factor<MP>& f, float2 (&bl)[NR],
                                      float2 (&bh)[NR], bool refine) {
  float2 zl[NR], zh[NR], ul[NR], uh[NR];
  fwd_solve<MP, NR>(mask, f, l, bl, bh, zl, zh);
  bwd_solve<MP, NR>(mask, f, l, zl, zh, ul, uh);
  if (refine) {
    float2 rl[NR], rr[NR];
    apply_r<MP, NR>(mask, xs, lt, bb, l, W, f, ul, uh, rl, rr);
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      rl[c] = csub(bl[c], rl[c]);
      rr[c] = csub(bh[c], rr[c]);
    }
    fwd_solve<MP, NR>(mask, f, l, rl, rr, zl, zh);
    bwd_solve<MP, NR>(mask, f, l, zl, zh, rl, rr);
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      ul[c] = cadd(ul[c], rl[c]);
      uh[c] = cadd(uh[c], rr[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    bl[c] = ul[c];
    bh[c] = uh[c];
  }
}

// The refined MVDR terms num = u^H x and den = d^H u with u = R^-1 d
// (refined once), d and x at the lane's two rows; in every lane of the
// problem.
template <int MP>
__device__ __forceinline__ void mvdr_terms(unsigned mask, const float2* xs,
                                           int lt, int bb, int l, int W,
                                           const Factor<MP>& f, float2 dl,
                                           float2 dh, float2 xl, float2 xh,
                                           float2& num, float2& den) {
  constexpr int H = Shape<MP>::H;
  float2 ul[1] = {dl}, uh[1] = {dh};
  solve<MP, 1>(mask, xs, lt, bb, l, W, f, ul, uh, true);
  den = group_sum<H>(mask, cadd(cmul_conj(ul[0], dl), cmul_conj(uh[0], dh)));
  num = group_sum<H>(mask, cadd(cmul_conj(xl, ul[0]), cmul_conj(xh, uh[0])));
}

// The MVDR form: y = (u^H x) / conj(d^H u) with u = R^-1 d, 0 where
// d^H u == 0 (an all-zero constraint column, mega_stream.py:206-213). d and
// x at the lane's two rows; returns y in every lane of the problem.
// Unrefined it takes z = L^-1 d and xi = L^-1 x in one forward pass:
// u^H x = z^H xi, d^H u = z^H z (real).
template <int MP>
__device__ __forceinline__ float2 mvdr_apply(unsigned mask, const float2* xs,
                                             int lt, int bb, int l, int W,
                                             const Factor<MP>& f, float2 dl,
                                             float2 dh, float2 xl, float2 xh,
                                             bool refine) {
  constexpr int H = Shape<MP>::H;
  if (!refine) {
    float2 bl[2] = {dl, xl}, bh[2] = {dh, xh}, zl[2], zh[2];
    fwd_solve<MP, 2>(mask, f, l, bl, bh, zl, zh);
    const float2 num = group_sum<H>(
        mask, cadd(cmul_conj(zl[1], zl[0]), cmul_conj(zh[1], zh[0])));
    const float den =
        group_sum<H>(mask, make_float2(zl[0].x * zl[0].x + zl[0].y * zl[0].y +
                                           zh[0].x * zh[0].x +
                                           zh[0].y * zh[0].y,
                                       0.f))
            .x;
    const float s = den > 0.f ? 1.f / den : 0.f;
    return cscale(num, s);
  }
  float2 num, den;
  mvdr_terms<MP>(mask, xs, lt, bb, l, W, f, dl, dh, xl, xh, num, den);
  const float d2 = den.x * den.x + den.y * den.y;
  const float s = d2 > 0.f ? 1.f / fmaxf(d2, 1e-38f) : 0.f;
  return make_float2((num.x * den.x - num.y * den.y) * s,
                     (num.y * den.x + num.x * den.y) * s);
}

// Rows l + h H (h < RPL) of the inner system's G = C^H X on the n
// compacted active slots sl[0 .. n) (slot 0 first): each entry a sum over
// the problem's lanes of C_a^H X_b at the lane's two rows (X from the
// scratch xp, C from device memory), G[a][a] += 1 where column a of C is
// zero; rows past n are identity.
template <int MP, int CAP, int RPL, bool kComp>
__device__ __forceinline__ void form_g(unsigned mask, int l, int M, int n,
                                       const int (&sl)[CAP], unsigned zero,
                                       const float2* __restrict__ cu,
                                       size_t stride, bool bad,
                                       const float2* xp,
                                       float2 (&g)[RPL][CAP]) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int h = 0; h < RPL; ++h)
#pragma unroll
    for (int b = 0; b < CAP; ++b) {
      const int r = l + h * H;
      g[h][b] = make_float2(r >= n && b == r ? 1.f : 0.f, 0.f);
    }
#pragma unroll
  for (int a = 0; a < CAP; ++a) {
    if (a >= n) break;
    float2 cl = make_float2(0.f, 0.f), ch = cl;
    if (bad) {
      cl = ch = make_float2(nan, nan);
    } else {
      if (l < M) cl = cu[((size_t)sl[a] * M + l) * stride];
      if (rh < M) ch = cu[((size_t)sl[a] * M + rh) * stride];
    }
#pragma unroll
    for (int b = 0; b < CAP; ++b) {
      if (b >= n) break;
      const float2* x = xp + sl[b] * MP;
      float2 e;
      if constexpr (kComp) {
        CSum d = csum(make_float2(0.f, 0.f));
        csum_mul(d, x[l], make_float2(cl.x, -cl.y));
        csum_mul(d, x[rh], make_float2(ch.x, -ch.y));
        e = group_csum<H>(mask, d);
      } else {
        e = group_sum<H>(mask,
                         cadd(cmul_conj(x[l], cl), cmul_conj(x[rh], ch)));
      }
      if (a == b && ((zero >> sl[a]) & 1u)) e.x += 1.f;
#pragma unroll
      for (int h = 0; h < RPL; ++h)
        if (l + h * H == a) g[h][b] = e;
    }
  }
}

// y = (X v)^H x for the slots' v (rows l + h H of it in v[h]): X_a at the
// lane's two rows from the scratch, summed over the problem's lanes.
template <int MP, int CAP, int RPL, bool kComp>
__device__ __forceinline__ float2 combine(unsigned mask, int l, int n,
                                          const int (&sl)[CAP],
                                          const float2* xp,
                                          const float2 (&v)[RPL], float2 xl,
                                          float2 xh) {
  constexpr int H = Shape<MP>::H;
  const int rh = MP - 1 - l;
  if constexpr (kComp) {
    CSum wl = csum(make_float2(0.f, 0.f)), wh = wl;
#pragma unroll
    for (int a = 0; a < CAP; ++a) {
      const float2 va = shfl<H>(mask, v[a / H], a % H);
      if (a < n) {
        const float2* x = xp + sl[a] * MP;
        csum_mul(wl, x[l], va);
        csum_mul(wh, x[rh], va);
      }
    }
    const float2 w0 = csum_value(wl), w1 = csum_value(wh);
    CSum y = csum(make_float2(0.f, 0.f));
    csum_mul(y, xl, make_float2(w0.x, -w0.y));
    csum_mul(y, xh, make_float2(w1.x, -w1.y));
    return group_csum<H>(mask, y);
  } else {
    float2 wl = make_float2(0.f, 0.f), wh = wl;
#pragma unroll
    for (int a = 0; a < CAP; ++a) {
      const float2 va = shfl<H>(mask, v[a / H], a % H);
      if (a < n) {
        const float2* x = xp + sl[a] * MP;
        wl = cadd(wl, cmul(x[l], va));
        wh = cadd(wh, cmul(x[rh], va));
      }
    }
    return group_sum<H>(mask, cadd(cmul_conj(xl, wl), cmul_conj(xh, wh)));
  }
}

// The inner system of LCMV (lcmv_stream.py:45-76, 120-137) for n <= CAP:
// v = G^-1 e0 by unpivoted Gauss-Jordan, lane l holding rows l + h H of G
// and of G^-1 (the pivot row k comes by shuffles from its lane), then one
// residual step v += G^-1 (e0 - G v); returns y = (X v)^H x.
template <int MP, int CAP, int RPL, bool kComp>
__device__ __forceinline__ float2 lcmv_inner(
    unsigned mask, int l, int M, int n, const int (&sl)[CAP], unsigned zero,
    const float2* __restrict__ cu, size_t stride, bool bad,
    const float2* xp, float2 xl, float2 xh) {
  constexpr int H = Shape<MP>::H;
  float2 g[RPL][CAP], gi[RPL][CAP], g0[RPL][CAP];
  form_g<MP, CAP, RPL, kComp>(mask, l, M, n, sl, zero, cu, stride, bad, xp,
                              g);
#pragma unroll
  for (int h = 0; h < RPL; ++h)
#pragma unroll
    for (int b = 0; b < CAP; ++b) {
      g0[h][b] = g[h][b];
      gi[h][b] = make_float2(b == l + h * H ? 1.f : 0.f, 0.f);
    }
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k >= n) break;
    const int kh = k / H, kl = k % H;
    const float2 pinv = crecip(shfl<H>(mask, g[kh][k], kl));
    float2 fk[RPL];
#pragma unroll
    for (int h = 0; h < RPL; ++h) fk[h] = g[h][k];     // G[r][k]
#pragma unroll
    for (int b = 0; b < CAP; ++b) {
      const float2 pg = cmul(shfl<H>(mask, g[kh][b], kl), pinv);
      const float2 pi = cmul(shfl<H>(mask, gi[kh][b], kl), pinv);
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        if (l + h * H == k) {
          g[h][b] = pg;
          gi[h][b] = pi;
        } else {
          g[h][b] = csub(g[h][b], cmul(fk[h], pg));
          gi[h][b] = csub(gi[h][b], cmul(fk[h], pi));
        }
      }
    }
  }
  float2 v[RPL], res[RPL];
  CSum rs[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h) {
    v[h] = gi[h][0];
    rs[h] = csum(make_float2(l + h * H == 0 ? 1.f : 0.f, 0.f));
  }
#pragma unroll
  for (int b = 0; b < CAP; ++b) {
    const float2 vb = shfl<H>(mask, v[b / H], b % H);
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      if constexpr (kComp)
        csum_mul(rs[h], g0[h][b], make_float2(-vb.x, -vb.y));
      else
        rs[h].s = csub(rs[h].s, cmul(g0[h][b], vb));
    }
  }
#pragma unroll
  for (int h = 0; h < RPL; ++h) res[h] = csum_value(rs[h]);
#pragma unroll
  for (int b = 0; b < CAP; ++b) {
    const float2 rb = shfl<H>(mask, res[b / H], b % H);
#pragma unroll
    for (int h = 0; h < RPL; ++h) v[h] = cadd(v[h], cmul(gi[h][b], rb));
  }
  return combine<MP, CAP, RPL, kComp>(mask, l, n, sl, xp, v, xl, xh);
}

// Gauss-Jordan elimination of rows l + h H of g, carrying one augmented
// column aug through the same steps as a column of G^-1 (its pivot-row
// value scaled by the pivot's reciprocal, the others reduced).
template <int MP, int CAP, int RPL>
__device__ __forceinline__ void eliminate(unsigned mask, int l, int n,
                                          float2 (&g)[RPL][CAP],
                                          float2 (&aug)[RPL]) {
  constexpr int H = Shape<MP>::H;
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k >= n) break;
    const int kh = k / H, kl = k % H;
    const float2 pinv = crecip(shfl<H>(mask, g[kh][k], kl));
    float2 fk[RPL];
#pragma unroll
    for (int h = 0; h < RPL; ++h) fk[h] = g[h][k];
#pragma unroll
    for (int b = 0; b < CAP; ++b) {
      const float2 pg = cmul(shfl<H>(mask, g[kh][b], kl), pinv);
#pragma unroll
      for (int h = 0; h < RPL; ++h)
        g[h][b] = l + h * H == k ? pg : csub(g[h][b], cmul(fk[h], pg));
    }
    const float2 pa = cmul(shfl<H>(mask, aug[kh], kl), pinv);
#pragma unroll
    for (int h = 0; h < RPL; ++h)
      aug[h] = l + h * H == k ? pa : csub(aug[h], cmul(fk[h], pa));
  }
}

// The inner system for n > 4 slots (SP > 4 only), as lcmv_inner without
// G^-1 in registers: v = G^-1 e0 is column 0 of G^-1 carried through the
// elimination as an augmented column (the same operations); G is formed
// again for the residual e0 - G v, and the correction G^-1 (e0 - G v) is
// one more elimination with the residual as its augmented column.
template <int MP, int CAP, int RPL, bool kComp>
__device__ __forceinline__ float2 lcmv_inner_wide(
    unsigned mask, int l, int M, int n, const int (&sl)[CAP], unsigned zero,
    const float2* __restrict__ cu, size_t stride, bool bad,
    const float2* xp, float2 xl, float2 xh) {
  constexpr int H = Shape<MP>::H;
  float2 g[RPL][CAP], v[RPL], res[RPL];
  form_g<MP, CAP, RPL, kComp>(mask, l, M, n, sl, zero, cu, stride, bad, xp,
                              g);
#pragma unroll
  for (int h = 0; h < RPL; ++h)
    v[h] = make_float2(l + h * H == 0 ? 1.f : 0.f, 0.f);
  eliminate<MP, CAP, RPL>(mask, l, n, g, v);
  form_g<MP, CAP, RPL, kComp>(mask, l, M, n, sl, zero, cu, stride, bad, xp,
                              g);
  CSum rs[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h)
    rs[h] = csum(make_float2(l + h * H == 0 ? 1.f : 0.f, 0.f));
#pragma unroll
  for (int b = 0; b < CAP; ++b) {
    const float2 vb = shfl<H>(mask, v[b / H], b % H);
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      if constexpr (kComp)
        csum_mul(rs[h], g[h][b], make_float2(-vb.x, -vb.y));
      else
        rs[h].s = csub(rs[h].s, cmul(g[h][b], vb));
    }
  }
#pragma unroll
  for (int h = 0; h < RPL; ++h) res[h] = csum_value(rs[h]);
  eliminate<MP, CAP, RPL>(mask, l, n, g, res);
#pragma unroll
  for (int h = 0; h < RPL; ++h) v[h] = cadd(v[h], res[h]);
  return combine<MP, CAP, RPL, kComp>(mask, l, n, sl, xp, v, xl, xh);
}

// The constraint-space solve of one LCMV problem (lcmv.cpp:108-138,
// beamform_tpu/kernels/lcmv_stream.py constraint_space_apply) on its lanes,
// given R's factor:
//
//   X_a = R^-1 C_a   max_rhs() slots at a time, into the problem's scratch xp
//                    ([SP][MP] in shared memory); a zero column's solve is
//                    skipped (X_a = 0)
//   G   = C^H X      S x S; G[a][a] += 1 where column a of C is zero
//   v   = G^-1 e0    unpivoted Gauss-Jordan, then one residual step
//   y   = (X v)^H x_t
//
// Element (s, m) of the frame's constraint set at this bin is
// cu[(s * M + m) * stride]; ``bad`` (a control index out of range) makes
// every constraint NaN. A zero column's solve is exactly zero for any
// finite factor, and with a non-finite factor the always-active
// look-direction column makes the output non-finite anyway. The zero
// columns other than slot 0 make G block-diagonal with an identity block,
// so the system is solved on the other slots alone (the same v there):
// with G^-1 in registers for at most 4 of them, else (SP > 4 only) with
// augmented columns.
// Returns y in every lane of the problem.
template <int MP, int SP>
__device__ __forceinline__ float2 lcmv_apply(unsigned mask, const float2* xs,
                                             int lt, int bb, int l, int M,
                                             int W, int S,
                                             const Factor<MP>& f,
                                             const float2* __restrict__ cu,
                                             size_t stride, bool bad,
                                             float2 xl, float2 xh,
                                             float2* xp, bool refine) {
  constexpr int H = Shape<MP>::H;
  constexpr int NR = SP < max_rhs<MP>() ? SP : max_rhs<MP>();
  const int rh = MP - 1 - l;
  const float nan = __int_as_float(0x7fc00000);
  unsigned zero = 0;                        // bit s: column s of C is zero
  for (int c0 = 0; c0 < S; c0 += NR) {
    float2 bl[NR], bh[NR];
    unsigned nz = 0;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int s = c0 + q;
      bl[q] = bh[q] = make_float2(0.f, 0.f);
      if (s < S) {
        if (bad) {
          bl[q] = bh[q] = make_float2(nan, nan);
        } else {
          if (l < M) bl[q] = cu[((size_t)s * M + l) * stride];
          if (rh < M) bh[q] = cu[((size_t)s * M + rh) * stride];
        }
        if (__ballot_sync(mask, nonzero(bl[q]) || nonzero(bh[q])) != 0)
          nz |= 1u << q;
        else
          zero |= 1u << s;
      }
    }
    if (nz != 0) solve<MP, NR>(mask, xs, lt, bb, l, W, f, bl, bh, refine);
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int s = c0 + q;
      if (s < S) {
        const bool z = ((nz >> q) & 1u) == 0;
        xp[s * MP + l] = z ? make_float2(0.f, 0.f) : bl[q];
        xp[s * MP + rh] = z ? make_float2(0.f, 0.f) : bh[q];
      }
    }
  }
  __syncwarp(mask);

  // the slots of the inner system: slot 0 and every nonzero column
  const unsigned act = (~zero & ((1u << S) - 1u)) | 1u;
  const int n = __popc(act);
  constexpr int CA = SP < 4 ? SP : 4;
  int sa[CA];
  unsigned rest = act;
#pragma unroll
  for (int a = 0; a < CA; ++a) {
    sa[a] = rest ? __ffs(rest) - 1 : 0;
    rest &= rest - 1u;
  }
  float2 y;
  if constexpr (SP <= 4) {
    y = lcmv_inner<MP, CA, (CA + H - 1) / H, (SP > 1)>(
        mask, l, M, n, sa, zero, cu, stride, bad, xp, xl, xh);
  } else {
    if (n <= CA) {
      y = lcmv_inner<MP, CA, (CA + H - 1) / H, true>(
          mask, l, M, n, sa, zero, cu, stride, bad, xp, xl, xh);
    } else {
      int sb[SP];
      unsigned r2 = act;
#pragma unroll
      for (int a = 0; a < SP; ++a) {
        sb[a] = r2 ? __ffs(r2) - 1 : 0;
        r2 &= r2 - 1u;
      }
      y = lcmv_inner_wide<MP, SP, (SP + H - 1) / H, true>(
          mask, l, M, n, sb, zero, cu, stride, bad, xp, xl, xh);
    }
  }
  __syncwarp(mask);                                 // xp is reused
  return y;
}

}  // namespace bf_tri
