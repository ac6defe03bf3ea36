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
// update g_c += sum_s w_c[s] b_c(s) is summed before it meets the taps (one
// rounding a group) and lands at the group's end, where NaN taps become 0
// (the per-sample recurrence scrubs per sample: the TPU kernel's one
// semantic deviation, kept).
//
// Every power is a fresh sum over its window, not the TPU kernel's running
// sums (which did not return to 0 when a window fell silent; see
// gsc_sample.cu). The Grams are input-only: each 128-sample tile's
// G_c(t0+i, l) is the suffix sum over the previous tile's products
// u[j] u[j-l], j > i, plus the prefix sum over this tile's, j <= i, so a
// silent window gives exactly 0. osq is gsc_sample.cu's split: the squares
// of the previous tile's outputs still in the window (a suffix sum per
// tile) plus a running sum of this tile's, which restarts every tile. The
// kernel reads no Gram input: it forms them from the register and the 8
// samples before it (uold), and returns the Grams at the last sample.
// Chunks that are multiples of 128 samples give the output of one call bit
// for bit.
//
// What bounds it on this card: latency, as for gsc_sample.cu (the same
// 4 C K operations a sample, 0.17 ms of float32 peak over 30 s at 16 mics).
// Layout: the stream is the grid axis, kWarps = 4 warps, 4 channel slots
// each; lane l holds taps 4l .. 4l+3 of its slots' filters, so a group's
// 8 windows are 11 consecutive words a slot, three 16-byte loads (a 3-word
// pad in front of each row aligns them). Per group of 8:
//   1. every lane forms its partials of the 8 base dots (128 FMAs) and
//      stores them; one block barrier;
//   2. warp 0 runs the chain. Lane i + 8 h takes the group's sample i and
//      half h of the slots: it sums 32 partials of sample i with 16-byte
//      reads, two shuffles add the 4 warps' sums. After step s one shuffle
//      broadcasts o_s; each lane forms osq (a suffix of the last tile's
//      squared outputs plus a running sum of this tile's, no reduction),
//      and sum_c mu_c[s] G_c(i, i-s) as p X + Y: X sums its half's Grams
//      on the osq branch, Y the others' q step times Gram, both known
//      before the step's rsqrt, one shuffle adds the halves. The VAD test
//      compares osq with the host threshold (kernels/gsc.py
//      vad_power_threshold), no sqrt. Lanes 0..15 store w_c[s];
//   3. a second barrier; every warp sums its slots' rank-8 update from w
//      and the windows it loaded in 1, adds it to the taps once, scrubs
//      NaN taps.
// Per tile: the next tile's rows are copied by cp.async while the current
// tile's chains run; the Grams of all 8 lags are two warp scans per (slot,
// lag) over 4 products a lane, the 8 lags side by side, a warp per slot.
// On an H100 80GB HBM3 at 700 W and 1,980 MHz, 16 mics over 30 s: 251.9
// ms a call, 0.697 of gsc_sample.cu's 361.4 ms in the same run; 32 streams
// of 10 s 86.1 ms. A group, stamped: base dots 414 cycles, their sums 264,
// the chain 1,473 (184 a step), the update 283, the tile's Grams and
// tables 514. The chain runs in one warp because four warps running it
// side by side were slower (298.7 ms): their reads of the step tables
// share one SM's shared-memory port.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;                 // taps
constexpr int kT = 128;                 // samples per tile
constexpr int kL = 8;                   // lookahead group
constexpr int kCP = 16;                 // channel slots per stream
constexpr int kWarps = 4;               // warps per stream
constexpr int kCPW = kCP / kWarps;      // channel slots per warp
constexpr int kNT = 32 * kWarps;
constexpr int kPad = 3;                 // aligns each group's windows
constexpr int kHist = kL + kK;          // [uold | history]
constexpr int kTile0 = kPad + kHist;    // the tile's first sample in a row
constexpr int kWin0 = kPad + kL + 1;    // tile sample 0's window in a row
constexpr int kRow = (kTile0 + kT + 3) / 4 * 4;
constexpr int kWin = 12;                // a lane's words of a group's windows
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

static_assert(kNT == kT, "one thread per tile sample in the step tables");
static_assert(kWin0 % 4 == 0 && kRow % 4 == 0, "16-byte windows");

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m, vthr;
};

// shared floats: the rows, the Grams of lags 1..7 ([lag-1][slot][t]),
// bsq ([slot][t]), c_b bsq and the q steps ([t][slot]), [last | tile]
// outputs, osq's history part, the fixed beam, the warps' partials
// ([i][warp]), the next tile's input rows, the warps' scratch of the Gram
// scans, the group's w_c[s] ([slot][s])
constexpr int kSq = kT + 4;             // a lag's row of a warp's scratch
constexpr int kRed = kNT + 4;           // a sample's row of the partials
constexpr int kSmemFloats = kCP * kRow + (kL - 1) * kCP * kT + 3 * kCP * kT
                            + 2 * kK + 2 * kT + kL * kRed + kCP * kT
                            + kWarps * kL * kSq + kCP * kL;

// max(x, 0) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// mu0 * rsqrt(p * kinv), 0 where that is not finite
__device__ __forceinline__ float step_of(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(clamp0(p * kinv));
  return mu <= kMaxFloat ? mu : 0.f;
}

// the same for p >= 0 or NaN (osq: a sum of squares)
__device__ __forceinline__ float step_nn(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(p * kinv);
  return mu <= kMaxFloat ? mu : 0.f;
}

// queue the copy of tile t0's rows (rows x kT floats, 16 bytes a copy)
__device__ __forceinline__ void stage(float* raw, const float* a, int rows,
                                      int S, int t0, int tid) {
  for (int e = tid; e < rows * (kT / 4); e += kNT) {
    const int r = e / (kT / 4), q = e - r * (kT / 4);
    __pipeline_memcpy_async(raw + r * kT + 4 * q,
                            a + (size_t)r * S + t0 + 4 * q, 16);
  }
  __pipeline_commit();
}

// a warp's inclusive scan of s over the lanes
__device__ __forceinline__ float lane_scan(float s, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  return s;
}

// One slot's Grams of the tile, lags 0..7, by one warp, the 8 lags' scans
// side by side: G(t, l) is the suffix over the history's products
// y[h] y[h-l], h > t (an inclusive scan of the reversed history,
// Q'(t) = the products from h = t on, through the warp's scratch sq, kL
// rows of kT + 4 floats whose last 4 stay 0), plus the prefix over the
// tile's products x[j] x[j-l], j <= t, 4 samples a lane. Lag 0 (bsq) goes
// to b0, lag l to gl + (l-1) * kCP * kT.
__device__ __forceinline__ void tile_grams(const float* row, float* b0,
                                           float* gl, float* sq, int lane) {
  float x[kL + 3], y[kL + 3];
  // x[e] = tile sample 4 lane + e - 7; y[e] = history sample 127 - 4 lane
  // - e (the reversed history), e = 0..10
#pragma unroll
  for (int e = 0; e < kL + 3; ++e) {
    x[e] = row[kTile0 + 4 * lane + e - (kL - 1)];
    y[e] = row[kPad + kL + kK - 1 - 4 * lane - e];
  }
  float vs[kL][4], vp[kL][4], ts[kL], tq[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    float ss = 0.f, sp = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      vs[l][q] = ss = fmaf(y[q], y[q + l], ss);
      vp[l][q] = sp = fmaf(x[q + kL - 1], x[q + kL - 1 - l], sp);
    }
    ts[l] = ss;
    tq[l] = sp;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const float ys = __shfl_up_sync(kFull, ts[l], o);
      const float yp = __shfl_up_sync(kFull, tq[l], o);
      if (lane >= o) {
        ts[l] += ys;
        tq[l] += yp;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    float offs = __shfl_up_sync(kFull, ts[l], 1);
    float offp = __shfl_up_sync(kFull, tq[l], 1);
    if (lane == 0) offs = offp = 0.f;
    // Q'(124 - 4 lane .. 127 - 4 lane)
    reinterpret_cast<float4*>(sq + l * kSq)[kT / 4 - 1 - lane] =
        make_float4(offs + vs[l][3], offs + vs[l][2], offs + vs[l][1],
                    offs + vs[l][0]);
    tq[l] = offp;
  }
  __syncwarp();
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    float* dst = l == 0 ? b0 : gl + (l - 1) * kCP * kT;
    const float4* q4 = reinterpret_cast<const float4*>(sq + l * kSq);
    const float4 lo = q4[lane], hi = q4[lane + 1];
    // G(t) = Q'(t + 1) + P(t), t = 4 lane .. 4 lane + 3
    reinterpret_cast<float4*>(dst)[lane] = make_float4(
        lo.y + (tq[l] + vp[l][0]), lo.z + (tq[l] + vp[l][1]),
        lo.w + (tq[l] + vp[l][2]), hi.x + (tq[l] + vp[l][3]));
  }
  __syncwarp();                        // sq serves the warp's next slot
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
  s = lane_scan(s, lane);
  float off = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) off = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * lane + q;       // the squares after kK - 2 - j
    if (j <= kK - 2) hs[kK - 2 - j] = off + v[q];
  }
  if (lane == 0) hs[kT - 1] = 0.f;
}

__global__ void __launch_bounds__(kNT, 1)
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
  extern __shared__ __align__(16) float sm[];
  float* ub = sm;                      // kCP x kRow: [pad|uold|history|tile]
  float* gr = ub + kCP * kRow;         // G_c(t, l) at ((l-1) kCP + c) kT + t
  float* bq = gr + (kL - 1) * kCP * kT;  // bsq_c(t) at c kT + t
  float* cbq = bq + kCP * kT;          // c_b bsq_c(t) at t kCP + c
  float* qst = cbq + kCP * kT;         // the q-branch steps, t kCP + c
  float* ob = qst + kCP * kT;          // 2K: [last outputs | tile outputs]
  float* hs = ob + 2 * kK;             // kT: osq's history part
  float* dz = hs + kT;                 // kT: the tile's fixed beam
  float* red = dz + kT;                // kL x kRed: the partials
  float* raw = red + kL * kRed;        // M x kT: the next tile's input
  float* sq = raw + kCP * kT;          // kWarps x kL x kSq: scan scratch
  float* wsh = sq + kWarps * kL * kSq; // kCP x kL: the group's w_c[s]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int c0 = w * kCPW;             // this warp's first slot
  const int si = lane & (kL - 1);      // this lane's sample of the group
  const int hf = (lane >> 3) & 1;      // and its half of the slots
  const int b = blockIdx.x;
  const int C = M - 1;
  const float* a = in + (size_t)b * M * S;

  stage(raw, a, M, S, 0, tid);
  float g[kCPW][4];
#pragma unroll
  for (int cs = 0; cs < kCPW; ++cs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c0 + cs;
      g[cs][j] = ch < C ? flt_in[((size_t)b * C + ch) * kK + 4 * lane + j]
                        : 0.f;
    }
  }
  for (int i = tid; i < kCP * kRow; i += kNT) {
    const int ch = i / kRow, k = i % kRow - kPad;
    float v = 0.f;                      // padding slots stay zero
    if (ch < C && k >= 0 && k < kL)
      v = uold_in[((size_t)b * C + ch) * kL + k];
    if (ch < C && k >= kL && k < kHist)
      v = blk_in[((size_t)b * C + ch) * kK + k - kL];
    ub[i] = v;
  }
  // the padding slots' Grams and bsq stay zero
  for (int i = tid; i < kL * kCP * kT; i += kNT) gr[i] = 0.f;
  for (int k = tid; k < kK; k += kNT) ob[k] = lo_in[(size_t)b * kK + k];
  for (int i = tid; i < kWarps * kL * kSq; i += kNT) sq[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    __pipeline_wait_prior(0);
    __syncthreads();                     // raw landed, the drain is done
    for (int i = tid; i < kT; i += kNT) {
      float prev = raw[i];
      float sum = prev;
      for (int m = 1; m < M; ++m) {
        const float cur = raw[m * kT + i];
        ub[(m - 1) * kRow + kTile0 + i] = cur - prev;
        sum += cur;
        prev = cur;
      }
      dz[i] = sum * cf.inv_m;
    }
    __syncthreads();                     // raw is free, the tile in place
    if (t0 + kT < S) stage(raw, a, M, S, t0 + kT, tid);
    for (int ch = w; ch < C; ch += kWarps)
      tile_grams(ub + ch * kRow, bq + ch * kT, gr + ch * kT,
                 sq + w * kL * kSq, lane);
    if (w == kWarps - 1) output_suffix(ob, hs, lane);
    __syncthreads();
    {
      // c_b bsq_c and the q-branch steps of sample tid, 16-byte rows
      float4* cb4 = reinterpret_cast<float4*>(cbq + tid * kCP);
      float4* q4 = reinterpret_cast<float4*>(qst + tid * kCP);
#pragma unroll
      for (int q = 0; q < kCP / 4; ++q) {
        float v[4], s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float bsq = bq[(4 * q + e) * kT + tid];
          v[e] = cf.c_b * bsq;
          s[e] = step_of(cf.mu0, bsq, cf.kinv);
        }
        cb4[q] = make_float4(v[0], v[1], v[2], v[3]);
        q4[q] = make_float4(s[0], s[1], s[2], s[3]);
      }
    }
    __syncthreads();

    float tp = 0.f;                      // the tile's output squares so far
    for (int tb = 0; tb < kT; tb += kL) {
      // the group's windows: lane l's taps against samples tb .. tb + 7
      float win[kCPW][kWin];
#pragma unroll
      for (int cs = 0; cs < kCPW; ++cs) {
        const float4* src = reinterpret_cast<const float4*>(
            ub + (c0 + cs) * kRow + kWin0 + tb + 4 * lane);
#pragma unroll
        for (int v = 0; v < kWin / 4; ++v) {
          const float4 x = src[v];
          win[cs][4 * v] = x.x;
          win[cs][4 * v + 1] = x.y;
          win[cs][4 * v + 2] = x.z;
          win[cs][4 * v + 3] = x.w;
        }
      }
      float acc[kL];
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int cs = 0; cs < kCPW; ++cs) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i] = fmaf(g[cs][j], win[cs][i + j], acc[i]);
        }
      }
      // the base dots' partials, [i][warp, lane] rows padded to 132 words
      // so the chain warp's 16-byte reads of a row meet no bank twice
#pragma unroll
      for (int i = 0; i < kL; ++i) red[i * kRed + tid] = acc[i];
      __syncthreads();

      if (w == 0) {
        // the chain, lane si on the group's sample si. Its base dot: the
        // lane sums warp hq's 32 partials, two shuffles add the 4 warps'
        const int hq = lane >> 3;
        float e;
        {
          const float4* p4 = reinterpret_cast<const float4*>(
              red + si * kRed + 32 * hq);
          float4 v[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) v[m] = p4[m];
          float t[8];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            t[m] = (v[m].x + v[m].y) + (v[m].z + v[m].w);
          float base = ((t[0] + t[1]) + (t[2] + t[3])) +
                       ((t[4] + t[5]) + (t[6] + t[7]));
          base += __shfl_xor_sync(kFull, base, 8);
          base += __shfl_xor_sync(kFull, base, 16);
          e = dz[tb + si] - base;
        }
        const int cw = kCP / 2 * hf + si;  // the slot whose w_c[s] it writes
        float cr = 0.f;                    // this lane's sample's correction
#pragma unroll
        for (int s = 0; s < kL; ++s) {
          // input-only, ahead of the step: this half's c_b bsq_c and q
          // steps, and the Grams G_c(tb + si, si - s) (lanes past s)
          const float* cbs = cbq + (tb + s) * kCP;
          const float* qss = qst + (tb + s) * kCP;
          const int lag = si > s ? si - s : 1;
          const float* gl = gr + ((lag - 1) * kCP + kCP / 2 * hf) * kT + tb
                            + si;
          float cb[kCP / 2], gv[kCP / 2], qg[kCP / 2];
#pragma unroll
          for (int q = 0; q < kCP / 8; ++q) {
            const float4 c4 = reinterpret_cast<const float4*>(cbs)[2 * hf + q];
            const float4 s4 = reinterpret_cast<const float4*>(qss)[2 * hf + q];
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              cb[4 * q + k] = cv[k];
              gv[4 * q + k] = s + 1 < kL ? gl[(4 * q + k) * kT] : 0.f;
              qg[4 * q + k] = sv[k] * gv[4 * q + k];
            }
          }
          const float mq = qss[cw];
          const float mb = cbs[cw];

          const float o = __shfl_sync(kFull, e - cr, s);
          tp = fmaf(o, o, tp);
          const float osq = hs[tb + s] + tp;
          const float co = cf.c_o * osq;
          const float p = step_nn(cf.mu0, osq, cf.kinv);
          const bool upd = !use_vad || clamp0(osq) < cf.vthr;
          if (s + 1 < kL) {
            // sum_c mu_c[s] G_c = p X + Y: X sums the Grams of the slots on
            // the osq branch, Y the others' q-step times Gram, both known
            // before the step's rsqrt; each lane of a pair sums half of
            // the slots, a shuffle adds the halves
            float x[kCP / 2], y[kCP / 2];
#pragma unroll
            for (int c = 0; c < kCP / 2; ++c) {
              const bool on = cb[c] < co;
              x[c] = on ? gv[c] : 0.f;
              y[c] = on ? 0.f : qg[c];
            }
            float X = ((x[0] + x[1]) + (x[2] + x[3])) +
                      ((x[4] + x[5]) + (x[6] + x[7]));
            float Y = ((y[0] + y[1]) + (y[2] + y[3])) +
                      ((y[4] + y[5]) + (y[6] + y[7]));
            X += __shfl_xor_sync(kFull, X, kL);
            Y += __shfl_xor_sync(kFull, Y, kL);
            const float A = fmaf(p, X, Y);
            if (si > s) cr = fmaf(upd ? o : 0.f, A, cr);
          }
          const float mw = mb < co ? p : mq;
          if (lane < kCP) wsh[cw * kL + s] = upd ? mw * o : 0.f;
          if (lane == 0) ob[kK + tb + s] = o;
        }
      }
      __syncthreads();

      // the rank-8 update, summed before it meets the taps (one rounding a
      // group), then the NaN scrub
#pragma unroll
      for (int cs = 0; cs < kCPW; ++cs) {
        const float4* w4 = reinterpret_cast<const float4*>(
            wsh + (c0 + cs) * kL);
        const float4 wa = w4[0], wb = w4[1];
        const float wv[kL] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d = 0.f;
#pragma unroll
          for (int s = 0; s < kL; ++s) d = fmaf(wv[s], win[cs][s + j], d);
          const float v = g[cs][j] + d;
          g[cs][j] = v != v ? 0.f : v;
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
      if (e < kCP * kHist)
        keep[r] = ub[(e / kHist) * kRow + kPad + kT + e % kHist];
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
      if (e < kCP * kHist) ub[(e / kHist) * kRow + kPad + e % kHist] = keep[r];
    }
  }
  __syncthreads();

#pragma unroll
  for (int cs = 0; cs < kCPW; ++cs) {
    const int ch = c0 + cs;
    if (ch < C) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        flt_out[((size_t)b * C + ch) * kK + 4 * lane + j] = g[cs][j];
    }
  }
  for (int i = tid; i < C * kHist; i += kNT) {
    const int ch = i / kHist, k = i % kHist;
    const float v = ub[ch * kRow + kPad + k];
    if (k < kL)
      uold_out[((size_t)b * C + ch) * kL + k] = v;
    else
      blk_out[((size_t)b * C + ch) * kK + k - kL] = v;
  }
  // the Grams at the last sample, from the last tile's tables
  for (int i = tid; i < C * kL; i += kNT) {
    const int ch = i / kL, l = i % kL;
    gram_out[(size_t)b * C * kL + i] =
        l == 0 ? bq[ch * kT + kT - 1] : gr[((l - 1) * kCP + ch) * kT + kT - 1];
  }
  for (int k = tid; k < kK; k += kNT) lo_out[(size_t)b * kK + k] = ob[k];
}

}  // namespace

extern "C" {

// in: aligned (B, M, S) float32, 16-byte aligned; blk, flt (B, M-1, 128);
// lo (B, 128); uold (B, M-1, 8); out (B, S) and the new state, gram
// (B, M-1, 8) the Grams at the last sample. coef: 1/K, mu0^2/K,
// mu_max^2/K, mu0, vad_threshold, 1/M, and the VAD threshold on osq.
// 2 <= M <= 16, S a positive multiple of 128.
int bf_gsc_block(const float* in, const float* blk, const float* flt,
                 const float* lo, const float* uold, float* out,
                 float* blk_out, float* flt_out, float* lo_out,
                 float* gram_out, float* uold_out, int B, int M, int S,
                 int use_vad, const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || S < kT || S % kT ||
      reinterpret_cast<uintptr_t>(in) % 16)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3],
                coef[4], coef[5], coef[6]};
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
