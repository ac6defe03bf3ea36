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
// the sample mode by the kernel. osq is the same split, formed by every
// thread: the squares of the previous tile's outputs still in the window
// (a suffix sum per tile) plus those of this tile's outputs so far (a sum
// that restarts each tile and only adds), so a silent window gives 0. So
// chunks that are multiples of 128 samples give the output of one call
// bit for bit.
//
// What bounds it on this card: latency. The recurrence is serial over the
// samples (each output feeds the next update): ~4 C K = 7,680 operations
// a sample at 16 mics, 11 Gflop over 30 s (0.17 ms at the float32 peak),
// but every sample waits for a dot product over 1,920 taps, a reduction
// across them, the step size and the update before the next can start.
// Layout: the stream is the grid axis, kWarps = 4 warps per stream, 4
// channel slots each (16 >= M - 1; a padding slot holds zeros). Lane l of
// a warp holds taps l, l+32, l+64, l+96 of its channels' filters in
// registers. The blocking-matrix samples of a tile sit in
// shared memory behind the K-sample history, so the window of sample i is
// the contiguous [i+1, i+K] of its channel's [history | tile] row: a
// register shift is an offset, no data moves, and the 32 lanes read 32
// consecutive words (no bank conflict).
//
// The chain of one sample, and what the design keeps off it:
//   1. the dot partials (the taps against the window loaded the sample
//      before: every input-only operand of sample i + 1, its window, fixed
//      beam, c_b bsq_c and q-branch steps, is loaded while sample i's
//      reduction runs);
//   2. a 5-shuffle warp sum; lane 0 stores the warp's partial;
//   3. one block barrier, then one 128-bit load of the 4 partials and a
//      2-level tree; osq needs no reduction: every thread adds the new
//      output's square to its running tile sum and the history part;
//   4. the step: one rsqrt; the VAD test compares osq with a threshold
//      computed on the host (kernels/gsc.py vad_power_threshold), the least
//      float32 y with sqrtf(y / K) >= vad_threshold, so no sqrt is taken
//      and every decision equals sqrtf(osq / K) < vad_threshold;
//   5. each lane forms its warp's channel steps itself from broadcast
//      reads, so no shuffle broadcasts mu o;
//   6. the update FMAs.
// Per tile, the next tile's input rows are copied into shared memory by
// cp.async while the current tile's chain runs; the tile's block powers
// are a suffix sum of the history's squares plus a prefix sum of the
// tile's, two warp scans per channel slot, exactly 0 for a silent window.
// The deferred NaN scrub: a NaN tap makes the next sample's dot product
// NaN in every thread, and only then are the taps scrubbed and the dot
// taken again, which gives the faithful result without a test per tap and
// sample. On an H100 at 16 mics over 30 s it takes 358.7 ms (249 ns a
// sample, 493 cycles at 1.98 GHz; 8 warps 410 ms, 16 warps 491 ms; the
// design it replaced 572 ms).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;            // taps
constexpr int kT = 128;            // samples per tile
constexpr int kCP = 16;            // channel slots per stream
constexpr int kWarps = 4;          // warps per stream (measured: 8, 16 slower)
constexpr int NT = 32 * kWarps;    // threads per stream
constexpr int CPW = kCP / kWarps;  // channel slots per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m, vthr;
};

__device__ __forceinline__ float warp_sum(float v) {
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

// shared floats ahead of the raw rows: [history | tile] per channel slot,
// [last outputs | tile outputs], the fixed beam, osq's history part, two
// reduction slots of kWarps partials (16-byte rows), c_b bsq_c and the q
// steps
constexpr int kSmemHead = kCP * 2 * kK + 2 * kK + kT + kT + 2 * kWarps
                          + 2 * kCP * kT;

// queue the copy of tile t0's rows (rows x kT floats, 16 bytes a copy)
__device__ __forceinline__ void stage(float* raw, const float* a, int rows,
                                      int S, int t0, int tid, int nt) {
  for (int e = tid; e < rows * (kT / 4); e += nt) {
    const int r = e / (kT / 4), q = e - r * (kT / 4);
    __pipeline_memcpy_async(raw + r * kT + 4 * q,
                            a + (size_t)r * S + t0 + 4 * q, 16);
  }
  __pipeline_commit();
}

// One tile's block powers, fresh and input-only, one warp per channel
// slot: bsq_c of sample i is the history's squares after i (an inclusive
// scan of the reversed history, into cbt) plus the tile's up to i (a
// prefix scan, in registers). A warp scans 128 values 4 a lane, then the
// lanes' totals by shuffles; a silent window gives exactly 0. Then c_b
// bsq_c into cbt and the q-branch step into qt.
__device__ __forceinline__ void block_powers(const float* ub, float* cbt,
                                             float* qt, int w, int lane,
                                             int nw, const Coef& cf) {
  for (int ch = w; ch < kCP; ch += nw) {
    const float* row = ub + ch * 2 * kK;
    float vs[4], vp[4], ss = 0.f, sp = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;
      const float xs = row[kK - 1 - j], xp = row[kK + j];
      vs[q] = ss = fmaf(xs, xs, ss);
      vp[q] = sp = fmaf(xp, xp, sp);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ys = __shfl_up_sync(kFull, ss, o);
      const float yp = __shfl_up_sync(kFull, sp, o);
      if (lane >= o) {
        ss += ys;
        sp += yp;
      }
    }
    float offs = __shfl_up_sync(kFull, ss, 1);
    float offp = __shfl_up_sync(kFull, sp, 1);
    if (lane == 0) offs = offp = 0.f;
    float* cb = cbt + ch * kT;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;      // the squares after kK - 2 - j
      if (j <= kK - 2) cb[kK - 2 - j] = offs + vs[q];
    }
    if (lane == 0) cb[kT - 1] = 0.f;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * lane + q;
      const float bsq = cb[i] + (offp + vp[q]);
      qt[ch * kT + i] = step_of(cf.mu0, bsq, cf.kinv);
      cb[i] = cf.c_b * bsq;
    }
  }
}

// osq's history part for the tile's samples: hs[i] = the squares of the
// last outputs after i (ob[i+1 .. K-1]), an inclusive scan of the reversed
// history by one warp; hs[K-1] = 0.
__device__ __forceinline__ void output_suffix(const float* ob, float* hs,
                                              int lane) {
  float v[4], s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float x = ob[kK - 1 - (4 * lane + q)];
    v[q] = s = fmaf(x, x, s);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  float off = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) off = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * lane + q;       // the squares after kK - 2 - j
    if (j <= kK - 2) hs[kK - 2 - j] = off + v[q];
  }
  if (lane == 0) hs[kT - 1] = 0.f;
}

template <bool XMU>
__global__ void __launch_bounds__(NT)
    gsc_sample_kernel(const float* __restrict__ in,
                      const float* __restrict__ blk_in,
                      const float* __restrict__ flt_in,
                      const float* __restrict__ lo_in,
                      float* __restrict__ out, float* __restrict__ blk_out,
                      float* __restrict__ flt_out,
                      float* __restrict__ lo_out, float* __restrict__ mu_out,
                      uint8_t* __restrict__ upd_out, int M, int S,
                      int use_vad, Coef cf) {
  extern __shared__ __align__(16) float sm[];
  float* ub = sm;                    // kCP x 2K: [history | tile]
  float* ob = ub + kCP * 2 * kK;     // 2K: [last outputs | tile outputs]
  float* dz = ob + 2 * kK;           // kT: the tile's fixed beam
  float* hs = dz + kT;               // kT: osq's history part
  float* red = hs + kT;              // 2 x kWarps: the warps' partials
  float* cbt = red + 2 * kWarps;     // kCP x kT: c_b bsq_c
  float* qt = cbt + kCP * kT;        // kCP x kT: the q-branch steps
  float* raw = qt + kCP * kT;        // rows x kT: the next tile's input
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int c0 = w * CPW;            // this warp's first channel
  const int b = blockIdx.x;
  const int C = M - 1;
  const int rows = XMU ? 3 * M - 2 : M;
  const float* a = in + (size_t)b * rows * S;
  const bool with_mu = mu_out != nullptr;

  stage(raw, a, rows, S, 0, tid, NT);
  float g[CPW][4];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
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
    __pipeline_wait_prior(0);
    __syncthreads();                     // raw landed, the drain is done
    // the tile: blocking-matrix samples behind the history, the beam
    for (int i = tid; i < kT; i += NT) {
      float prev = raw[i];
      float sum = prev;
      for (int m = 1; m < M; ++m) {
        const float cur = raw[m * kT + i];
        ub[(m - 1) * 2 * kK + kK + i] = cur - prev;
        sum += cur;
        prev = cur;
      }
      dz[i] = sum * cf.inv_m;
    }
    if (XMU) {
      for (int e = tid; e < kCP * kT; e += NT) {
        const int ch = e / kT, i = e - ch * kT;
        cbt[e] = ch < C ? raw[(M + ch) * kT + i] : 0.f;
        qt[e] = ch < C ? raw[(2 * M - 1 + ch) * kT + i] : 0.f;
      }
    }
    __syncthreads();                     // raw is free
    if (t0 + kT < S) stage(raw, a, rows, S, t0 + kT, tid, NT);
    if (!XMU) block_powers(ub, cbt, qt, w, lane, kWarps, cf);
    if (w == kWarps - 1) output_suffix(ob, hs, lane);
    __syncthreads();
    // sample 0's input-only operands
    float bv[CPW][4], cb[CPW], q[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[c][j] = ub[(c0 + c) * 2 * kK + 1 + lane + 32 * j];
      cb[c] = cbt[(c0 + c) * kT];
      q[c] = qt[(c0 + c) * kT];
    }
    float d = dz[0], h = hs[0];
    float tp = 0.f;                      // the tile's output squares so far

#pragma unroll 2
    for (int i = 0; i < kT; ++i) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(g[c][j], bv[c][j], acc[j]);
      }
      // sample i + 1's operands, off the chain (past the tile's end they
      // are unused reads inside the buffer)
      float nv[CPW][4], ncb[CPW], nq[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nv[c][j] = ub[(c0 + c) * 2 * kK + i + 2 + lane + 32 * j];
        ncb[c] = cbt[(c0 + c) * kT + i + 1];
        nq[c] = qt[(c0 + c) * kT + i + 1];
      }
      const float nd = dz[i + 1], nh = hs[i + 1];
      float* slot = red + (i & 1) * kWarps;
      float part = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
      // a second slot for odd samples: no warp overwrites a partial that
      // another may still read
      if (lane == 0) slot[w] = part;
      __syncthreads();
      float dot;
      {
        static_assert(kWarps == 4, "one float4 of partials");
        const float4 p = reinterpret_cast<const float4*>(slot)[0];
        dot = (p.x + p.y) + (p.z + p.w);
      }
      if (dot != dot) {
        // the deferred scrub: a tap the last update left NaN becomes 0
        // (every thread sees the same sum, so the branch is uniform)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = 0.f;
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (g[c][j] != g[c][j]) g[c][j] = 0.f;
            acc[j] = fmaf(g[c][j], bv[c][j], acc[j]);
          }
        }
        part = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
        __syncthreads();
        if (lane == 0) slot[w] = part;
        __syncthreads();
        dot = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) dot += slot[v];
      }
      const float o = d - dot;
      tp = fmaf(o, o, tp);
      const float osq = h + tp;
      if (tid == 0) ob[kK + i] = o;

      const float p = step_of(cf.mu0, osq, cf.kinv);
      const float co = cf.c_o * osq;
      const bool upd = !use_vad || clamp0(osq) < cf.vthr;
      float wc[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const float mu = cb[c] < co ? p : q[c];
        wc[c] = c0 + c < C ? mu * o : 0.f;
        if (c == 0 && with_mu && tid == 0) {
          mu_out[(size_t)b * S + t0 + i] = mu;
          upd_out[(size_t)b * S + t0 + i] = upd ? 1 : 0;
        }
      }
      if (upd) {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) g[c][j] = fmaf(wc[c], bv[c][j], g[c][j]);
        }
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[c][j] = nv[c][j];
        cb[c] = ncb[c];
        q[c] = nq[c];
      }
      d = nd;
      h = nh;
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
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < CPW; ++c) {
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
  const int rows = XMU ? 3 * M - 2 : M;
  const size_t smem = sizeof(float) * (kSmemHead + rows * kT);
  auto kernel = gsc_sample_kernel<XMU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT, smem, st>>>(in, blk, flt, lo, out, blk_out, flt_out,
                                   lo_out, mu, upd, M, S, use_vad, cf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: aligned (B, M, S) float32, or with xmu the packed (B, 3M-2, S)
// [audio | c_b bsq_c | q-branch steps], 16-byte aligned; blk, flt
// (B, M-1, 128); lo (B, 128); out (B, S) and the new state; mu (B, S)
// float32 and upd (B, S) bytes, or both null for no trace. coef: 1/K,
// mu0^2/K, mu_max^2/K, mu0, vad_threshold, 1/M, and the VAD threshold on
// osq. 2 <= M <= 16, S a positive multiple of 128.
int bf_gsc_sample(const float* in, const float* blk, const float* flt,
                  const float* lo, float* out, float* blk_out,
                  float* flt_out, float* lo_out, float* mu, uint8_t* upd,
                  int B, int M, int S, int xmu, int use_vad,
                  const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || S < kT || S % kT ||
      reinterpret_cast<uintptr_t>(in) % 16)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3],
                coef[4], coef[5], coef[6]};
  cudaStream_t st = (cudaStream_t)stream;
  if (xmu)
    return launch<true>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                        upd, B, M, S, use_vad, cf, st);
  return launch<false>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                       upd, B, M, S, use_vad, cf, st);
}

}  // extern "C"
