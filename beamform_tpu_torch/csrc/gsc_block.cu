// GSC's lookahead-8 adaptive stage for Hopper (sm_90a), bound with ctypes.
//
// gsc_block_kernel replaces beamform_tpu/kernels/gsc_block.py:_kernel
// (reached through gsc_block_pallas_batched): the exact lookahead-8
// factorisation of the per-sample LMS recurrence of csrc/gsc_sample.cu
// (gsc.cpp:120-179). Within a group of 8 samples the filters g_c are frozen
// at the group's start, so for the group's sample i
//
//   out_i = d_i - sum_c <g_c, b_c(i)> - sum_{s<i} sum_c w_c[s] G_c(i, i-s)
//
// with G_c(t, l) = <b_c(t-l), b_c(t)> the window-pair Grams and
// w_c[s] = mu_c[s] out_s (0 where the VAD gate holds the filters). The 8
// base dots are independent; only a scalar chain stays serial; the rank-8
// update g_c += sum_s w_c[s] b_c(s) lands at the group's end, where NaN
// taps become 0 (the per-sample recurrence scrubs per sample: the TPU
// kernel's one semantic deviation, kept).
//
// Every power is a fresh sum over its window, not the TPU kernel's running
// sums (which did not return to 0 when a window fell silent; see
// gsc_sample.cu). The Grams are input-only: each 128-sample tile's
// G_c(t0+i, l) is the suffix sum over the previous tile's products
// u[j] u[j-l], j > i, plus the prefix sum over this tile's, j <= i, each
// formed sequentially by one thread per (channel, lag) before the tile's
// chain, so a silent window gives exactly 0. osq of the group's sample i is
// the sum of the 127 - i squared outputs before the group still in its
// window (the 120 common to the group by a warp reduction, then the 7 - i
// older ones added one by one) plus the squares of the group's first
// i + 1 outputs. The kernel reads no Gram input: it forms them from the
// register and the 8 samples before it (uold), and returns the Grams at
// the last sample. Chunks that are multiples of 128 samples give the
// output of one call bit for bit.
//
// What bounds it on this card: latency, as for gsc_sample.cu (the same
// 4 C K operations a sample, 0.17 ms of float32 peak over 30 s at 16 mics).
// The per-sample kernel waits for a dot product over 1,920 taps, two warp
// reductions and a block barrier every sample. Here, per group of 8: every
// thread forms its partials of the 8 independent base dots (its taps
// against 8 windows, offsets into the shared [uold | history | tile] row),
// the warp reduces the 8 values in 9 shuffles, one barrier; warp 0 runs
// the 8-step chain, one lane per channel (the corrections are lane-local,
// one 16-lane reduction a step); a second barrier publishes w (8 x C);
// every thread sums the rank-8 update and adds it to its taps once (one
// rounding a group, not one a sample: the filters' float32 drift over a
// long stream is the largest error of the recurrence). Two barriers a group
// where gsc_sample.cu needs one a sample. Layout as gsc_sample.cu: the
// stream is the grid axis, kNW = 8 warps, kCPW = 2 channel slots a warp,
// lane l holds taps l, l+32, l+64, l+96 of its channels in registers.
// On an H100 at 16 mics over 30 s it took 442.3 ms (307 ns a sample, 0.76
// of gsc_sample.cu's time); with the terms added to the taps one by one
// it was 10x further from float64 than its plain version (3.35e-7 against
// 3.38e-8 over 48 hops), as far as the per-sample kernel is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;                 // taps
constexpr int kT = 128;                 // samples per tile
constexpr int kL = 8;                   // lookahead group
constexpr int kNW = 8;                  // warps per stream
constexpr int kCPW = 2;                 // channel slots per warp
constexpr int kCP = kNW * kCPW;         // channel slots per stream
constexpr int kNT = 32 * kNW;
constexpr int kHist = kL + kK;          // [uold | history]
constexpr int kRow = kHist + kT;        // [uold | history | tile]
constexpr int kGP = kT * kL + 9;        // a channel's Grams, padded
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m;
};

constexpr size_t kSmemFloats =
    kCP * kRow + 2 * kK + kT + kCP * kGP + kNW * kL + kL * kCP;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the sum over lanes 0..15 (lanes 16..31 get their own half's)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// max(x, 0) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// mu0 * rsqrt(p * kinv), 0 where that is not finite
__device__ __forceinline__ float step_of(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(clamp0(p * kinv));
  return mu <= kMaxFloat ? mu : 0.f;
}

// Reduce 8 values over the warp in 9 shuffles: on return, lanes with
// lane & 3 == 0 hold in v[0] the warp's sum of value
// 4 * bit4 + 2 * bit3 + bit2 of the lane.
__device__ __forceinline__ void warp_sum8(float (&v)[kL], int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 16;
    const float send = hi ? v[k] : v[k + 4];
    const float keep = hi ? v[k + 4] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 8;
    const float send = hi ? v[k] : v[k + 2];
    const float keep = hi ? v[k + 2] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  {
    const bool hi = lane & 4;
    const float send = hi ? v[0] : v[1];
    const float keep = hi ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  v[0] += __shfl_xor_sync(kFull, v[0], 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
}

__global__ void __launch_bounds__(kNT)
    gsc_block_kernel(const float* __restrict__ in,
                     const float* __restrict__ blk_in,
                     const float* __restrict__ flt_in,
                     const float* __restrict__ lo_in,
                     const float* __restrict__ uold_in,
                     float* __restrict__ out, float* __restrict__ blk_out,
                     float* __restrict__ flt_out, float* __restrict__ lo_out,
                     float* __restrict__ gram_out,
                     float* __restrict__ uold_out, int M, int S,
                     int use_vad, Coef cf) {
  extern __shared__ float sm[];
  float* ub = sm;                  // kCP x kRow: [uold | history | tile]
  float* ob = ub + kCP * kRow;     // 2K: [last outputs | tile outputs]
  float* dz = ob + 2 * kK;         // kT: the tile's fixed beam
  float* gr = dz + kT;             // kCP x kGP: G_c(i, l) at i * kL + l
  float* red = gr + kCP * kGP;     // kNW x kL: the warps' partial dots
  float* wsh = red + kNW * kL;     // kL x kCP: the group's w_c[s]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = warp * kCPW;      // this warp's first channel
  const int b = blockIdx.x;
  const int C = M - 1;
  const float* a = in + (size_t)b * M * S;

  float g[kCPW][4];
#pragma unroll
  for (int c = 0; c < kCPW; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c0 + c;
      g[c][j] = ch < C ? flt_in[((size_t)b * C + ch) * kK + lane + 32 * j]
                       : 0.f;
    }
  }
  for (int i = tid; i < kCP * kRow; i += kNT) {
    const int ch = i / kRow, k = i % kRow;
    float v = 0.f;                    // padding channels stay zero
    if (ch < C && k < kL) v = uold_in[((size_t)b * C + ch) * kL + k];
    if (ch < C && k >= kL && k < kHist)
      v = blk_in[((size_t)b * C + ch) * kK + k - kL];
    ub[i] = v;
  }
  for (int k = tid; k < kK; k += kNT) ob[k] = lo_in[(size_t)b * kK + k];

  for (int t0 = 0; t0 < S; t0 += kT) {
    // stage the tile: blocking-matrix samples behind the history, the beam
    for (int i = tid; i < kT; i += kNT) {
      float prev = a[t0 + i];
      float sum = prev;
      for (int m = 1; m < M; ++m) {
        const float cur = a[(size_t)m * S + t0 + i];
        ub[(m - 1) * kRow + kHist + i] = cur - prev;
        sum += cur;
        prev = cur;
      }
      dz[i] = sum * cf.inv_m;
    }
    __syncthreads();
    // the tile's Grams, input only, off the chain: one thread per
    // (channel, lag); the suffix over the previous tile, then the prefix
    // over this one
    if (tid < C * kL) {
      const int ch = tid / kL, l = tid % kL;
      const float* row = ub + ch * kRow;
      float* gc = gr + ch * kGP + l;
      float acc = 0.f;
      for (int i = kT - 1; i >= 0; --i) {
        gc[i * kL] = acc;
        acc = fmaf(row[kL + i], row[kL + i - l], acc);
      }
      acc = 0.f;
      for (int i = 0; i < kT; ++i) {
        acc = fmaf(row[kHist + i], row[kHist + i - l], acc);
        gc[i * kL] += acc;
      }
    }
    __syncthreads();

    for (int tb = 0; tb < kT; tb += kL) {
      // the 8 base dots against the frozen taps: sample tb + i's window is
      // the row's [kL + tb + i + 1, kL + tb + i + kK]
      float acc[kL];
#pragma unroll
      for (int i = 0; i < kL; ++i) acc[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCPW; ++c) {
        const float* w = ub + (c0 + c) * kRow + kL + tb + 1 + lane;
#pragma unroll
        for (int i = 0; i < kL; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i] = fmaf(g[c][j], w[i + 32 * j], acc[i]);
        }
      }
      warp_sum8(acc, lane);
      // lane >> 2 = 4 bit4 + 2 bit3 + bit2: the value lane holds
      if ((lane & 3) == 0) red[warp * kL + (lane >> 2)] = acc[0];
      __syncthreads();

      if (warp == 0) {
        // base dot i on lane i: the warps' partials in a fixed order
        float base = 0.f;
        if (lane < kL) {
#pragma unroll
          for (int v = 0; v < kNW; ++v) base += red[v * kL + lane];
        }
        // the squared outputs before the group in sample i's window: the
        // 120 common ones, ob[tb + 8 .. tb + 127], then the older ones
        float sp = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          if (n < kK - kL) {
            const float v = ob[tb + kL + n];
            sp = fmaf(v, v, sp);
          }
        }
        float before[kL];
        before[kL - 1] = warp_sum(sp);
#pragma unroll
        for (int i = kL - 2; i >= 0; --i) {
          const float v = ob[tb + i + 1];
          before[i] = fmaf(v, v, before[i + 1]);
        }
        // this lane's channel's Grams over the group, lags 0..i
        const bool live = lane < C;
        const float* gc = gr + (live ? lane : 0) * kGP + tb * kL;
        float gv[kL][kL];
#pragma unroll
        for (int i = 0; i < kL; ++i) {
#pragma unroll
          for (int l = 0; l <= i; ++l) gv[i][l] = live ? gc[i * kL + l] : 0.f;
        }
        float wv[kL];
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < kL; ++i) {
          float cr = 0.f;
#pragma unroll
          for (int s = 0; s < i; ++s) cr = fmaf(wv[s], gv[i][i - s], cr);
          // lanes 16..31 hold no channel: their sum, o and q are unused
          cr = half_sum(cr);
          const float bi = __shfl_sync(kFull, base, i);
          const float o = (dz[tb + i] - bi) - cr;
          q = fmaf(o, o, q);
          const float osq = before[i] + q;
          const float bsq = gv[i][0];
          const float p = step_of(cf.mu0, osq, cf.kinv);
          const float qs = step_of(cf.mu0, bsq, cf.kinv);
          const float mu = cf.c_b * bsq < cf.c_o * osq ? p : qs;
          const bool upd = !use_vad || sqrtf(clamp0(osq) * cf.kinv) < cf.vad;
          wv[i] = live && upd ? mu * o : 0.f;
          if (lane == 0) ob[kK + tb + i] = o;
        }
        if (lane < kCP) {
#pragma unroll
          for (int i = 0; i < kL; ++i) wsh[i * kCP + lane] = wv[i];
        }
      }
      __syncthreads();

      // the rank-8 update at the group's end, then the NaN scrub. The 8
      // terms are summed before they meet the taps, as the TPU kernel
      // does: a step is small against a tap, and adding the terms to the
      // tap one by one rounds 8 times where this rounds once
#pragma unroll
      for (int c = 0; c < kCPW; ++c) {
        const float* w = ub + (c0 + c) * kRow + kL + tb + 1 + lane;
        float wc[kL];
#pragma unroll
        for (int i = 0; i < kL; ++i) wc[i] = wsh[i * kCP + c0 + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < kL; ++i) d = fmaf(wc[i], w[i + 32 * j], d);
          const float v = g[c][j] + d;
          g[c][j] = v != v ? 0.f : v;
        }
      }
    }

    // drain the outputs; the tile's last K outputs become the history, and
    // the row shifts by one tile: [uold | history] <- its last kHist
    // samples
    constexpr int kShift = (kCP * kHist + kNT - 1) / kNT;
    float keep[kShift];
#pragma unroll
    for (int r = 0; r < kShift; ++r) {
      const int e = tid + r * kNT;
      if (e < kCP * kHist) keep[r] = ub[(e / kHist) * kRow + e % kHist + kT];
    }
    __syncthreads();
    for (int i = tid; i < kT; i += kNT) {
      const float o = ob[kK + i];
      out[(size_t)b * S + t0 + i] = o;
      ob[i] = o;
    }
#pragma unroll
    for (int r = 0; r < kShift; ++r) {
      const int e = tid + r * kNT;
      if (e < kCP * kHist) ub[(e / kHist) * kRow + e % kHist] = keep[r];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCPW; ++c) {
    const int ch = c0 + c;
    if (ch < C) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        flt_out[((size_t)b * C + ch) * kK + lane + 32 * j] = g[c][j];
    }
  }
  for (int i = tid; i < C * kHist; i += kNT) {
    const int ch = i / kHist, k = i % kHist;
    const float v = ub[ch * kRow + k];
    if (k < kL)
      uold_out[((size_t)b * C + ch) * kL + k] = v;
    else
      blk_out[((size_t)b * C + ch) * kK + k - kL] = v;
  }
  // the Grams at the last sample, from the last tile's table
  for (int i = tid; i < C * kL; i += kNT)
    gram_out[(size_t)b * C * kL + i] =
        gr[(i / kL) * kGP + (kT - 1) * kL + i % kL];
  for (int k = tid; k < kK; k += kNT) lo_out[(size_t)b * kK + k] = ob[k];
}

}  // namespace

extern "C" {

// in: aligned (B, M, S) float32; blk, flt (B, M-1, 128); lo (B, 128);
// uold (B, M-1, 8); out (B, S) and the new state, gram (B, M-1, 8) the
// Grams at the last sample. coef: 1/K, mu0^2/K, mu_max^2/K, mu0,
// vad_threshold, 1/M. 2 <= M <= 16, S a positive multiple of 128.
int bf_gsc_block(const float* in, const float* blk, const float* flt,
                 const float* lo, const float* uold, float* out,
                 float* blk_out, float* flt_out, float* lo_out,
                 float* gram_out, float* uold_out, int B, int M, int S,
                 int use_vad, const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || S < kT || S % kT)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5]};
  const size_t smem = sizeof(float) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      gsc_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gsc_block_kernel<<<B, kNT, smem, (cudaStream_t)stream>>>(
      in, blk, flt, lo, uold, out, blk_out, flt_out, lo_out, gram_out,
      uold_out, M, S, use_vad, cf);
  return (int)cudaGetLastError();
}

}  // extern "C"
