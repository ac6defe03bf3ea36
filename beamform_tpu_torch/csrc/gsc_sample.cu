// GSC's faithful per-sample adaptive stage for Hopper (sm_90a), bound with
// ctypes.
//
// gsc_sample_kernel<.., false> replaces
// beamform_tpu/kernels/gsc_pallas.py:_kernel (reached through
// gsc_adaptive_pallas_batched); gsc_sample_kernel<.., true> replaces
// gsc_pallas.py:_kernel_xmu (gsc_adaptive_pallas_xmu). Per stream and per
// sample t, with C = M - 1 blocking channels of K = 128 taps
// (gsc.cpp:120-179):
//
//   u_c   = a_{c+1}[t] - a_c[t]       shifts into the register b_c (K taps)
//   out   = mean_m a_m[t] - sum_c <g_c, b_c>
//   osq   = power of the K newest outputs, bsq_c = power of b_c
//   mu_c  = mu0 / sqrt(osq / K)   if c_b bsq_c < c_o osq    (c = mu^2 / K)
//           mu0 / sqrt(bsq_c / K) otherwise; a non-finite step is 0
//   g_c  += mu_c out b_c, a NaN tap becomes 0; with use_vad only while
//           sqrt(osq / K) < vad_threshold
//
// Every power is a fresh sum over its window, as the reference's
// calculate_power takes it (gsc.cpp:150), not the TPU kernel's running
// sums: a running sum that adds and subtracts the same squares does not
// return to exactly 0 when its window falls silent, and the step of an
// all-zero window (inf, scrubbed to 0) then became a huge finite one (the
// output did not change, the mu trace did). bsq_c is input-only: each
// 128-sample tile's window sums are formed before the tile's chain, in the
// xmu mode outside the kernel (streamed packed after the audio rows), in
// the sample mode by the kernel. osq is the sum of the K - 1 outputs before
// the sample's, reduced across the warp beside its dot product, plus the
// new output's square. So chunks that are multiples of 128 samples give
// the output of one call bit for bit.
//
// What bounds it on this card: latency. The recurrence is serial over the
// samples (each output feeds the next update): ~4 C K = 7,680 operations
// a sample at 16 mics, 11 Gflop over 30 s (0.17 ms at the float32 peak),
// but every sample waits for a dot product over 1,920 taps, a reduction
// across them, the step size and the update before the next can start.
// Design: the stream is the grid axis, kNW = 8 warps per stream, kCPW = 2
// channel slots each (16 >= M - 1; a padding slot holds zeros). Lane l of
// a warp holds taps l, l+32, l+64, l+96 of its channels' filters in
// registers (8 of them). The blocking-matrix samples of a tile are staged
// into shared memory behind the K-sample history, so the window of sample
// i is the contiguous [i+1, i+K] of its channel's [history | tile] row: a
// register shift is an offset, no data moves, and the 32 lanes read 32
// consecutive words (no bank conflict). Each warp reduces its partial dot
// product by shuffles, and the partials meet in shared memory behind one
// block barrier per sample. Lane c of a warp forms its channel c's step;
// the warp's other lanes receive it by shuffle. The NaN scrub of the taps
// is deferred: a NaN tap makes the next sample's dot product NaN in every
// thread, and only then are the taps scrubbed and the dot taken again,
// which gives the faithful result without a test per tap and sample.
// On an H100 at 16 mics over 30 s, eight warps took 581 ms (403 ns a
// sample); one warp holding every channel (no barrier) 1123 ms and four
// warps 599 ms (the xmu mode: 593, 917 and 568 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;            // taps
constexpr int kT = 128;            // samples per tile
constexpr int kNW = 8;             // warps per stream
constexpr int kCPW = 2;            // channel slots per warp
constexpr int kCP = kNW * kCPW;    // channel slots per stream
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// max(x, 0) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// mu0 * rsqrt(p * kinv), 0 where that is not finite
__device__ __forceinline__ float step_of(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(clamp0(p * kinv));
  return mu <= kMaxFloat ? mu : 0.f;
}

template <bool XMU>
__global__ void __launch_bounds__(32 * kNW)
    gsc_sample_kernel(const float* __restrict__ in,
                      const float* __restrict__ blk_in,
                      const float* __restrict__ flt_in,
                      const float* __restrict__ lo_in,
                      float* __restrict__ out, float* __restrict__ blk_out,
                      float* __restrict__ flt_out,
                      float* __restrict__ lo_out, float* __restrict__ mu_out,
                      uint8_t* __restrict__ upd_out, int M, int S,
                      int use_vad, Coef cf) {
  constexpr int NT = 32 * kNW;
  extern __shared__ float sm[];
  float* ub = sm;                // kCP x 2K: [register | tile] per channel
  float* ob = ub + kCP * 2 * kK;  // 2K: [last outputs | tile outputs]
  float* dz = ob + 2 * kK;        // kT: the tile's fixed beam
  float* red = dz + kT;           // 2 x kNW: the warps' partial dots
  float* cbt = red + 2 * kNW;     // kCP x kT: c_b bsq_c
  float* qt = cbt + kCP * kT;     // kCP x kT: the q-branch steps
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = (tid >> 5) * kCPW;  // this warp's first channel
  const int b = blockIdx.x;
  const int C = M - 1;
  const int rows = XMU ? 3 * M - 2 : M;
  const float* a = in + (size_t)b * rows * S;
  const bool with_mu = mu_out != nullptr;

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
  for (int i = tid; i < kCP * kK; i += NT) {
    const int ch = i / kK, k = i % kK;
    ub[ch * 2 * kK + k] = ch < C ? blk_in[((size_t)b * C + ch) * kK + k]
                                 : 0.f;
    ub[ch * 2 * kK + kK + k] = 0.f;     // padding channels stay zero
  }
  for (int k = tid; k < kK; k += NT) ob[k] = lo_in[(size_t)b * kK + k];

  for (int t0 = 0; t0 < S; t0 += kT) {
    // stage the tile: blocking-matrix samples behind the history, the beam
    for (int i = tid; i < kT; i += NT) {
      float prev = a[t0 + i];
      float sum = prev;
      for (int m = 1; m < M; ++m) {
        const float cur = a[(size_t)m * S + t0 + i];
        ub[(m - 1) * 2 * kK + kK + i] = cur - prev;
        sum += cur;
        prev = cur;
      }
      dz[i] = sum * cf.inv_m;
      if (XMU) {
        for (int ch = 0; ch < kCP; ++ch) {
          cbt[ch * kT + i] = ch < C ? a[(size_t)(M + ch) * S + t0 + i] : 0.f;
          qt[ch * kT + i] =
              ch < C ? a[(size_t)(2 * M - 1 + ch) * S + t0 + i] : 0.f;
        }
      }
    }
    __syncthreads();
    if (!XMU) {
      // the tile's block powers, fresh windowed sums of the register
      // (input only, off the chain), and the steps they give
      for (int e = tid; e < kCP * kT; e += NT) {
        const float* x = ub + (e / kT) * 2 * kK + e % kT + 1;
        float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int n = 0; n < kK; n += 4) {
#pragma unroll
          for (int v = 0; v < 4; ++v) p4[v] = fmaf(x[n + v], x[n + v], p4[v]);
        }
        const float bsq = (p4[0] + p4[1]) + (p4[2] + p4[3]);
        cbt[e] = cf.c_b * bsq;
        qt[e] = step_of(cf.mu0, bsq, cf.kinv);
      }
      __syncthreads();
    }
    float o_prev = ob[kK - 1];            // the newest output so far

#pragma unroll 2
    for (int i = 0; i < kT; ++i) {
      // the power of the K - 1 outputs before this sample's, fresh: its
      // newest (o_prev) from registers, the rest written two samples ago
      float sp = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = lane + 32 * j;
        const float v = n < kK - 2 ? ob[i + 1 + n]
                                   : (n == kK - 2 ? o_prev : 0.f);
        sp = fmaf(v, v, sp);
      }
      float bv[kCPW][4];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kCPW; ++c) {
        const float* w = ub + (c0 + c) * 2 * kK + i + 1 + lane;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[c][j] = w[32 * j];
          acc[j] = fmaf(g[c][j], bv[c][j], acc[j]);
        }
      }
      float* slot = red + (i & 1) * kNW;
      sp = warp_sum(sp);
      float part = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
      // a second slot for odd samples: no warp overwrites a partial that
      // another may still read
      if (lane == 0) slot[tid >> 5] = part;
      __syncthreads();
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < kNW; ++v) dot += slot[v];
      if (dot != dot) {
        // the deferred scrub: a tap the last update left NaN becomes 0
        // (every thread sees the same sum, so the branch is uniform)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = 0.f;
#pragma unroll
        for (int c = 0; c < kCPW; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (g[c][j] != g[c][j]) g[c][j] = 0.f;
            acc[j] = fmaf(g[c][j], bv[c][j], acc[j]);
          }
        }
        part = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
        __syncthreads();
        if (lane == 0) slot[tid >> 5] = part;
        __syncthreads();
        dot = 0.f;
#pragma unroll
        for (int v = 0; v < kNW; ++v) dot += slot[v];
      }
      const float o = dz[i] - dot;
      const float osq = fmaf(o, o, sp);
      if (tid == 0) ob[kK + i] = o;
      o_prev = o;

      float cb = 0.f, q = 0.f;
      if (lane < kCPW) {
        cb = cbt[(c0 + lane) * kT + i];
        q = qt[(c0 + lane) * kT + i];
      }
      const float p = step_of(cf.mu0, osq, cf.kinv);
      const float mu = cb < cf.c_o * osq ? p : q;
      const bool upd = !use_vad || sqrtf(clamp0(osq) * cf.kinv) < cf.vad;
      if (with_mu && tid == 0) {
        mu_out[(size_t)b * S + t0 + i] = mu;
        upd_out[(size_t)b * S + t0 + i] = upd ? 1 : 0;
      }
      if (upd) {
        const float wl = lane < kCPW && c0 + lane < C ? mu * o : 0.f;
#pragma unroll
        for (int c = 0; c < kCPW; ++c) {
          const float wc = __shfl_sync(kFull, wl, c);
#pragma unroll
          for (int j = 0; j < 4; ++j) g[c][j] = fmaf(wc, bv[c][j], g[c][j]);
        }
      }
    }
    __syncthreads();
    // drain the outputs; the tile's last K samples become the history
    for (int i = tid; i < kT; i += NT) {
      const float o = ob[kK + i];
      out[(size_t)b * S + t0 + i] = o;
      ob[i] = o;
      for (int ch = 0; ch < C; ++ch)
        ub[ch * 2 * kK + i] = ub[ch * 2 * kK + kK + i];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCPW; ++c) {
    const int ch = c0 + c;
    if (ch < C) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t dst = ((size_t)b * C + ch) * kK + lane + 32 * j;
        flt_out[dst] = g[c][j] != g[c][j] ? 0.f : g[c][j];
      }
    }
  }
  for (int i = tid; i < C * kK; i += NT)
    blk_out[(size_t)b * C * kK + i] = ub[(i / kK) * 2 * kK + i % kK];
  for (int k = tid; k < kK; k += NT) lo_out[(size_t)b * kK + k] = ob[k];
}

template <bool XMU>
int launch(const float* in, const float* blk, const float* flt,
           const float* lo, float* out, float* blk_out, float* flt_out,
           float* lo_out, float* mu, uint8_t* upd, int B, int M, int S,
           int use_vad, Coef cf, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (kCP * 2 * kK + 2 * kK + kT + 2 * kNW + 2 * kCP * kT);
  gsc_sample_kernel<XMU><<<B, 32 * kNW, smem, st>>>(
      in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu, upd, M, S,
      use_vad, cf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: aligned (B, M, S) float32, or with xmu the packed (B, 3M-2, S)
// [audio | c_b bsq_c | q-branch steps]; blk, flt (B, M-1, 128); lo
// (B, 128); out (B, S) and the new state; mu (B, S) float32 and upd (B, S)
// bytes, or both null for no trace. coef: 1/K, mu0^2/K, mu_max^2/K, mu0,
// vad_threshold, 1/M. 2 <= M <= 16, S a positive multiple of 128.
int bf_gsc_sample(const float* in, const float* blk, const float* flt,
                  const float* lo, float* out, float* blk_out,
                  float* flt_out, float* lo_out, float* mu, uint8_t* upd,
                  int B, int M, int S, int xmu, int use_vad,
                  const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || S < kT || S % kT)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5]};
  cudaStream_t st = (cudaStream_t)stream;
  if (xmu)
    return launch<true>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                        upd, B, M, S, use_vad, cf, st);
  return launch<false>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                       upd, B, M, S, use_vad, cf, st);
}

}  // extern "C"
