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
// all-zero window (inf, scrubbed to 0) then became a huge finite one.
// bsq_c is input-only (in the xmu mode c_b bsq_c and the q-branch steps
// are computed outside the kernel and streamed packed after the audio
// rows); osq is the squares of the last tile's outputs still in the window
// (a suffix sum per tile) plus a running sum of this tile's.
//
// What bounds it on this card: latency. The recurrence is serial over the
// samples (each output feeds the next update): ~4 C K = 7,680 operations a
// sample at 16 mics, 11 Gflop over 30 s (0.17 ms at the float32 peak), but
// sample t + 1's dot product needs the taps that sample t's update writes.
// A design that forms each sample's dot over the taps and reduces it
// across the block's warps pays a dot, a reduction, a block barrier, the
// step and the update per sample (493 cycles a sample on an H100).
//
// The schedule: the exact lookahead factorisation inside each 128-sample
// tile, in groups of L = kL samples. Within a group that starts at t0,
//
//   out_t = d_t - sum_c <g_c(t0), b_c(t)> - sum_{t0 <= s < t} w(s) SG(t, t-s)
//
// with w(s) = mu(s) out_s (0 where the VAD gate holds the filters) and
// SG(t, l) = sum_c <b_c(t-l), b_c(t)> the window-pair Grams summed over the
// channels, while every channel is on the osq branch (c_b bsq_c < c_o osq
// for all c: then every channel's step is the same p = mu0 / sqrt(osq / K)).
// One warp (the chain warp) runs only the scalar recurrence, every lane
// the same chain over the group's L outputs (no shuffle per step): per
// step osq, one rsqrt (of osq / K scaled by 2^32, so that no positive osq
// is subnormal), the step product and one FMA into each later output of
// the group; lane r also sums the cross-group term of the next group's
// sample r mod L (lags up to 2L - 1), handed to every lane through shared
// memory at the group's end. The other kWW = 5 warps (the workers, three channel
// slots each; lane l holds taps 4l .. 4l+3) do the tap-wide work beside
// it: while the chain runs group n they apply group n-1's rank-L update
// g_c += sum_s w(s) b_c(s) (summed before it meets the taps, NaN taps
// scrubbed), form group n+1's base dots <g_c(t0_n), b_c(t)> (reduced
// across the lanes by a transposed butterfly, across the workers by the
// chain's reads), and form the next tile's tables: bsq_c (c_b bsq_c, the
// q steps), SG for lags 1 .. 2L-1, and max_c c_b bsq_c. The hand-off is
// named barriers (bar.arrive by the producer, bar.sync by the consumer,
// two ids a direction by the group's parity); no block barrier remains
// per sample. At a tile's edge the chain waits on one block barrier while
// the workers apply the last update and dot group 0, then the workers move
// the rows up a tile among themselves.
//
// Every table is a fresh window sum: the history's products after t (a
// reverse scan of the last tile's, the products whose second factor lies
// before the register masked out) plus the tile's up to t (a scan), 4
// samples a lane, so a silent window gives exactly 0. The tables are
// input-only, formed a tile ahead into the other of two buffers. The
// pipeline restarts at every tile: the tile's first group reads the taps
// after every update of the last tile, and no correction crosses a tile's
// edge, so chunks that are multiples of 128 samples give the output of one
// call bit for bit.
//
// The per-sample semantics stay: a group whose chain meets a non-finite
// output or step product, or a step with a non-zero update where some
// channel is on the q branch (the factorised path carries only the
// channel-summed Grams), is replayed sample by sample from the taps at its
// start, with the per-sample chain (every worker's dot, a 128-thread
// barrier, the step and the update with its NaN scrub). Each block adds
// the groups it ran factorised and those it replayed to a device int64
// pair once per launch (kernels/gsc.py group_counts).
//
// On an H100 80GB HBM3 at 700 W and 1,980 MHz, 16 mics: one stream of 30 s
// 168.2 ms (116.7 ns, 231 cycles a sample; the per-sample design 361.5 ms,
// 493 cycles), 32 streams of 10 s 56.8 ms. A group of 8, stamped by
// clock64 at 32 streams of 93 hops: the chain's steps ~480-640 cycles
// (60-80 a step), its hand-off ~500 (its read of the base dots waits
// behind the workers' shared-memory traffic, up to ~2x while the table
// jobs run), the workers' update and base dots ~1,000-1,150. Measured
// slower: L = 16 (the registers), three workers (the update and dots
// ~1,250 a group), a shuffle per step (~240 cycles a step), the windows
// kept in registers across iterations (spills); the table jobs out of line
// (4% slower) and the cross-group terms handed over by shuffles (1%).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;                   // taps
constexpr int kT = 128;                   // samples per tile
constexpr int kL = 8;                     // lookahead group
constexpr int kG = kT / kL;               // groups per tile
constexpr int kLags = 2 * kL - 1;         // lags of the Gram tables
constexpr int kQuads = (kLags + 3) / 4;   // the lag jobs' quads of lags
constexpr int kCP = 15;                   // channel slots (M <= 16)
constexpr int kWW = 5;                    // worker warps
constexpr int kSPW = kCP / kWW;           // channel slots per worker warp
constexpr int kPW = (kWW + 3) / 4 * 4;    // a sample's row of partials
constexpr int NW = 32 * kWW;              // worker threads
constexpr int NT = 32 + NW;               // threads per stream
constexpr int kP = 4;                     // a row's pad: aligned windows
constexpr int kCur = kP + kK;             // the tile's first sample
constexpr int kNxt = kCur + kT;           // the next tile's first sample
constexpr int kRow = kNxt + kT;           // [pad | history | tile | next]
constexpr int kWin = kL + 4;              // a lane's words of a group's windows
constexpr int kChunk = 5;                 // channels of a lag job's chunk
constexpr int kChunks = kCP / kChunk;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;
constexpr float kTwo32 = 4294967296.f;
constexpr float kTwo16 = 65536.f;
// named barriers (0 is __syncthreads): a group's base dots are in place
// (workers arrive, the chain waits), a group's step products are in place
// (the chain arrives, the workers wait), each by the group's parity; the
// replay's per-sample barrier; the workers' own
constexpr int kBarBase = 1;
constexpr int kBarPub = 3;
constexpr int kBarRep = 5;
constexpr int kBarWork = 6;
constexpr int kPub = 32;   // a group's publication: w, tp0, bad; at 16 its
                           // cross-group terms

static_assert(kT % kL == 0 && kL % 4 == 0 && 2 * kL <= 32, "group size");
static_assert(kCP % kWW == 0 && kCP % kChunk == 0 && kRow % 4 == 0, "");
static_assert(kL + 2 <= 16 && 16 + kL <= kPub, "publication");

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m, vthr;
};

// shared floats: the rows, SG ([buf][lag-1][t]), c_b bsq and the q steps
// ([buf][slot][t]), max_c c_b bsq ([buf][t]), the fixed beam ([buf][t]),
// [last outputs | tile outputs], osq's history part, the base dots'
// partials ([buf][i][worker]), the groups' publications ([buf][kPub]), the
// replay's partials, the lag jobs' partial sums ([worker][32][lane]), the
// input rows of the next tile
constexpr int kSmemHead = kCP * kRow + 2 * kLags * kT + 4 * kCP * kT
                          + 4 * kT + 2 * kK + kT + 2 * kL * kPW + 2 * kPub
                          + 16 + kWW * 32 * 32;

__device__ __forceinline__ void bar_sync(int id, int n = NT) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(NT) : "memory");
}

// 1 / sqrt(x), a subnormal x flushed to 0 (the chain's argument is scaled
// by 2^32, so a positive osq never gives one)
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// a[lane] for lane < kL, by selects (a register array takes no index)
__device__ __forceinline__ float pick(const float (&a)[kL], int lane) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < kL; ++j) v = lane == j ? a[j] : v;
  return v;
}

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

// queue the copy of tile t0's rows (rows x kT floats, 16 bytes a copy) by
// the workers (wt = a worker's index among them)
__device__ __forceinline__ void stage(float* raw, const float* a, int rows,
                                      int S, int t0, int wt) {
  for (int e = wt; e < rows * (kT / 4); e += NW) {
    const int r = e / (kT / 4), q = e - r * (kT / 4);
    __pipeline_memcpy_async(raw + r * kT + 4 * q,
                            a + (size_t)r * S + t0 + 4 * q, 16);
  }
  __pipeline_commit();
}

// Window sums of samples t = 4 lane + q by one warp: the history's terms
// after t (y, this lane's at 4 lane + q of the last tile) plus the tile's
// up to t (x): a lane's partial sums, then a forward and a reverse scan of
// the lanes' totals. A window of zeros gives exactly 0.
__device__ __forceinline__ void window_sums4(const float (&y)[4],
                                             const float (&x)[4],
                                             float (&g)[4], int lane) {
  float xp[4], ys[4];
  xp[0] = x[0];
  xp[1] = xp[0] + x[1];
  xp[2] = xp[1] + x[2];
  xp[3] = xp[2] + x[3];
  ys[3] = 0.f;
  ys[2] = y[3];
  ys[1] = ys[2] + y[2];
  ys[0] = ys[1] + y[1];
  float sx = xp[3], sy = ys[0] + y[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float a = __shfl_up_sync(kFull, sx, o);
    const float c = __shfl_down_sync(kFull, sy, o);
    if (lane >= o) sx += a;
    if (lane + o < 32) sy += c;
  }
  float ex = __shfl_up_sync(kFull, sx, 1);
  float ey = __shfl_down_sync(kFull, sy, 1);
  if (lane == 0) ex = 0.f;
  if (lane == 31) ey = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) g[q] = (ey + ys[q]) + (ex + xp[q]);
}

__device__ __forceinline__ void unpack(const float4 v, float* d) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Worker wi's job at position j of its sequence over a tile: its slots'
// bsq (c_b bsq and the q steps; slots wi, wi + kWW, ...), then the lag
// quads a = wi, wi + kWW, ... in kChunks chunks of channels each, then
// (the last worker) max_c c_b bsq, which follows every worker's bsq jobs.
// Returns the slot (>= 0), -1 - (quad * kChunks + chunk), or kJobMax.
constexpr int kJobNone = -1000, kJobMax = -999;
__device__ __forceinline__ int job_at(int wi, int j) {
  constexpr int nb = kCP / kWW;
  if (j < nb) return wi + kWW * j;
  j -= nb;
  const int nq = (kQuads - wi + kWW - 1) / kWW;   // this worker's quads
  if (j < nq * kChunks) {
    const int a = wi + kWW * (j / kChunks);
    return -1 - (a * kChunks + j % kChunks);
  }
  j -= nq * kChunks;
  return wi == kWW - 1 && j == 0 ? kJobMax : kJobNone;
}
constexpr int kJobsMost = kCP / kWW + (kQuads + kWW - 1) / kWW * kChunks + 1;
constexpr int kUPI = (kJobsMost + kG - 1) / kG;   // jobs a worker iteration

// One job of the tables of the tile in the rows' next region (its history
// in the current region), by one worker warp, into that tile's buffers.
// A lag quad sums, for lags l = 4a + 1 .. 4a + 4 and its chunk's
// channels, the products u(t) u(t-l) of the tile and those of the history
// whose second factor lies in the last tile (the others belong to pairs no
// group reads); the partial sums carry across the quad's chunks in
// scr (this warp's, a lane's own column), and the last chunk forms SG.
template <bool XMU>
__device__ __forceinline__ void table_job(int job, const float* ub,
                                          float* sg, float* cbt, float* qt,
                                          float* mx, float* scr, int C,
                                          int lane, Coef cf) {
  const int t = 4 * lane;
  if (job >= 0) {
    if (XMU || job >= C) return;
    const float* row = ub + job * kRow;
    float a[4], h[4];
    unpack(*reinterpret_cast<const float4*>(row + kNxt + t), a);
    unpack(*reinterpret_cast<const float4*>(row + kCur + t), h);
    const float x[4] = {a[0] * a[0], a[1] * a[1], a[2] * a[2], a[3] * a[3]};
    const float y[4] = {h[0] * h[0], h[1] * h[1], h[2] * h[2], h[3] * h[3]};
    float bsq[4];
    window_sums4(y, x, bsq, lane);
    reinterpret_cast<float4*>(cbt + job * kT)[lane] =
        make_float4(cf.c_b * bsq[0], cf.c_b * bsq[1], cf.c_b * bsq[2],
                    cf.c_b * bsq[3]);
    reinterpret_cast<float4*>(qt + job * kT)[lane] = make_float4(
        step_of(cf.mu0, bsq[0], cf.kinv), step_of(cf.mu0, bsq[1], cf.kinv),
        step_of(cf.mu0, bsq[2], cf.kinv), step_of(cf.mu0, bsq[3], cf.kinv));
  } else if (job == kJobMax) {
    // the largest c_b bsq_c, NaN where one is: every channel is on the
    // osq branch iff it is below c_o osq
    const float ninf = __int_as_float(static_cast<int>(0xff800000u));
    float hi[4] = {ninf, ninf, ninf, ninf};
    for (int c = 0; c < C; ++c) {
      float v[4];
      unpack(reinterpret_cast<const float4*>(cbt + c * kT)[lane], v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hi[q] = v[q] != v[q] || hi[q] != hi[q] ? v[q] + hi[q]
                                               : fmaxf(hi[q], v[q]);
    }
    reinterpret_cast<float4*>(mx)[lane] =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
  } else if (job != kJobNone) {
    const int qa = (-1 - job) / kChunks, ck = (-1 - job) % kChunks;
    float x[4][4], y[4][4];               // [lag 4a + 1 + d][q]
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[d][q] = ck ? scr[(8 * d + q) * 32 + lane] : 0.f;
        y[d][q] = ck ? scr[(8 * d + 4 + q) * 32 + lane] : 0.f;
      }
    }
    // u(t + q - l) = v[q + 3 - d] of the words from 4 (lane - a - 1)
    const int off = 4 * (lane - qa - 1);
    for (int c = ck * kChunk; c < min(C, ck * kChunk + kChunk); ++c) {
      const float* row = ub + c * kRow;
      float an[4], vn[8], ah[4], vh[8];
      unpack(*reinterpret_cast<const float4*>(row + kNxt + t), an);
      unpack(*reinterpret_cast<const float4*>(row + kNxt + off), vn);
      unpack(*reinterpret_cast<const float4*>(row + kNxt + off + 4), vn + 4);
      unpack(*reinterpret_cast<const float4*>(row + kCur + t), ah);
      unpack(*reinterpret_cast<const float4*>(row + kCur + off), vh);
      unpack(*reinterpret_cast<const float4*>(row + kCur + off + 4), vh + 4);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int l = 4 * qa + 1 + d;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[d][q] = fmaf(an[q], vn[q + 3 - d], x[d][q]);
          const float yq = fmaf(ah[q], vh[q + 3 - d], y[d][q]);
          y[d][q] = t + q >= l ? yq : y[d][q];
        }
      }
    }
    if (ck + 1 < kChunks) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          scr[(8 * d + q) * 32 + lane] = x[d][q];
          scr[(8 * d + 4 + q) * 32 + lane] = y[d][q];
        }
      }
    } else {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int l = 4 * qa + 1 + d;
        float s[4];
        window_sums4(y[d], x[d], s, lane);
        if (l <= kLags)
          reinterpret_cast<float4*>(sg + (l - 1) * kT)[lane] =
              make_float4(s[0], s[1], s[2], s[3]);
      }
    }
  }
}

// a lane's words of the windows of the group at t0g: tap 4 lane + q of
// sample t0g + r pairs with win[r + q + 1]
__device__ __forceinline__ void load_win(const float* row, int t0g, int lane,
                                         float (&win)[kWin]) {
  const float4* src =
      reinterpret_cast<const float4*>(row + kP + t0g + 4 * lane);
#pragma unroll
  for (int v = 0; v < kWin / 4; ++v) unpack(src[v], win + 4 * v);
}

// a worker's windows of the group at t0g, every slot
__device__ __forceinline__ void load_wins(const float* rows, int t0g,
                                          int lane,
                                          float (&win)[kSPW][kWin]) {
#pragma unroll
  for (int cs = 0; cs < kSPW; ++cs)
    load_win(rows + cs * kRow, t0g, lane, win[cs]);
}

// A worker's partials of the base dots <g_c, b_c(t0g + r)> over its slots
// (a padding slot's taps and samples are 0), reduced across the warp by a
// transposed butterfly: the lanes that end with sample r's sum write it to
// part[r * kPW + wi].
__device__ __forceinline__ void base_dots(const float (&win)[kSPW][kWin],
                                          int lane,
                                          const float (&g)[kSPW][4],
                                          float* part, int wi) {
  float acc[kL];
#pragma unroll
  for (int r = 0; r < kL; ++r) acc[r] = 0.f;
#pragma unroll
  for (int cs = 0; cs < kSPW; ++cs) {
#pragma unroll
    for (int r = 0; r < kL; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[r] = fmaf(g[cs][q], win[cs][r + q + 1], acc[r]);
    }
  }
  int idx = 0;
#pragma unroll
  for (int h = kL / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = up ? acc[j] : acc[j + h];
      const float keep = up ? acc[j + h] : acc[j];
      acc[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
    if (up) idx += h;
  }
  constexpr int kRest = 32 / kL;          // lanes that share a sample
#pragma unroll
  for (int o = kRest / 2; o >= 1; o >>= 1)
    acc[0] += __shfl_xor_sync(kFull, acc[0], o);
  if ((lane & (kRest - 1)) == 0) part[idx * kPW + wi] = acc[0];
}

// a worker applies a group's rank-L update with the step products w[s]
// (the same for every channel: all were on the osq branch), a NaN tap
// becoming 0
__device__ __forceinline__ void apply_update(const float (&win)[kSPW][kWin],
                                             float (&g)[kSPW][4],
                                             const float* w) {
  float wv[kL];
#pragma unroll
  for (int v = 0; v < kL / 4; ++v)
    unpack(reinterpret_cast<const float4*>(w)[v], wv + 4 * v);
#pragma unroll
  for (int cs = 0; cs < kSPW; ++cs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float d = 0.f;
#pragma unroll
      for (int s = 0; s < kL; ++s) d = fmaf(wv[s], win[cs][s + q + 1], d);
      const float v = g[cs][q] + d;
      g[cs][q] = v != v ? 0.f : v;
    }
  }
}

// The group at t0g sample by sample from the taps at its start, by all
// NT threads (the chain warp holds no taps): every worker's dot partial,
// a barrier, then each thread forms the output, osq and the step itself;
// the workers update their taps (a NaN tap becomes 0), the chain warp
// writes the output and the mu trace. tp enters as the tile's output
// squares before the group and leaves after it.
__device__ __forceinline__ void replay_group(
    int t0g, int w, int lane, int C, int use_vad, const float* ub,
    const float* dzk, const float* hs, const float* cbk, const float* qk,
    float* ob, float* red, float (&g)[kSPW][4], float& tp, float* mu_out,
    uint8_t* upd_out, size_t obase, const Coef& cf) {
  const int c0 = (w - 1) * kSPW;
#pragma unroll 1
  for (int s = 0; s < kL; ++s) {
    const int i = t0g + s;
    float* slot = red + (s & 1) * 8;
    // tap 4 lane + q of slot cs meets this word of its row
    const float* bw = ub + c0 * kRow + kP + i + 1 + 4 * lane;
    if (w > 0) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cs = 0; cs < kSPW; ++cs) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fmaf(g[cs][q], bw[cs * kRow + q], acc[q]);
      }
      const float part = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
      if (lane == 0) slot[w - 1] = part;
    }
    bar_sync(kBarRep);
    float dot = slot[0];
#pragma unroll
    for (int v = 1; v < kWW; ++v) dot += slot[v];
    const float o = dzk[i] - dot;
    tp = fmaf(o, o, tp);
    const float osq = hs[i] + tp;
    const float p = step_of(cf.mu0, osq, cf.kinv);
    const float co = cf.c_o * osq;
    const bool upd = !use_vad || clamp0(osq) < cf.vthr;
    if (w == 0) {
      if (lane == 0) {
        ob[kK + i] = o;
        if (mu_out != nullptr) {
          mu_out[obase + i] = cbk[i] < co ? p : qk[i];
          upd_out[obase + i] = upd ? 1 : 0;
        }
      }
    } else if (upd) {
#pragma unroll
      for (int cs = 0; cs < kSPW; ++cs) {
        const int c = c0 + cs;
        if (c < C) {
          const float mu = cbk[c * kT + i] < co ? p : qk[c * kT + i];
          const float wc = mu * o;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float nv = fmaf(wc, bw[cs * kRow + q], g[cs][q]);
            g[cs][q] = nv != nv ? 0.f : nv;
          }
        }
      }
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
__global__ void __launch_bounds__(NT, 1)
    gsc_sample_kernel(const float* __restrict__ in,
                      const float* __restrict__ blk_in,
                      const float* __restrict__ flt_in,
                      const float* __restrict__ lo_in,
                      float* __restrict__ out, float* __restrict__ blk_out,
                      float* __restrict__ flt_out,
                      float* __restrict__ lo_out, float* __restrict__ mu_out,
                      uint8_t* __restrict__ upd_out,
                      unsigned long long* __restrict__ counts, int M, int S,
                      int use_vad, Coef cf) {
  extern __shared__ __align__(16) float sm[];
  float* ub = sm;                      // kCP x kRow
  float* sg = ub + kCP * kRow;         // 2 x kLags x kT
  float* cbt = sg + 2 * kLags * kT;    // 2 x kCP x kT
  float* qt = cbt + 2 * kCP * kT;      // 2 x kCP x kT
  float* mx = qt + 2 * kCP * kT;       // 2 x kT
  float* dz = mx + 2 * kT;             // 2 x kT
  float* ob = dz + 2 * kT;             // 2K: [last outputs | tile outputs]
  float* hs = ob + 2 * kK;             // kT
  float* part = hs + kT;               // 2 x kL x kPW
  float* pub = part + 2 * kL * kPW;    // 2 x kPub
  float* red = pub + 2 * kPub;         // 2 x 8
  float* scr = red + 16;               // kWW x 32 x 32
  float* raw = scr + kWW * 32 * 32;    // rows x kT
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;              // 0: the chain warp
  const int wi = w - 1;                // a worker's index
  const int wt = tid - 32;             // a worker's thread index
  const int c0 = wi * kSPW;            // a worker's first slot
  const float* rows0 = ub + c0 * kRow;
  float* wscr = scr + (w > 0 ? wi : 0) * 32 * 32;
  const int b = blockIdx.x;
  const int C = M - 1;
  const int rows = XMU ? 3 * M - 2 : M;
  const int nt = S / kT;
  const float* a = in + (size_t)b * rows * S;
  const size_t obase = (size_t)b * S;

  if (w > 0) stage(raw, a, rows, S, 0, wt);
  float g[kSPW][4];
#pragma unroll
  for (int cs = 0; cs < kSPW; ++cs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ch = c0 + cs;
      g[cs][q] = w > 0 && ch < C
                     ? flt_in[((size_t)b * C + ch) * kK + 4 * lane + q]
                     : 0.f;
    }
  }
  for (int i = tid; i < kCP * kRow; i += NT) ub[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < C * kK; i += NT)
    ub[(i / kK) * kRow + kCur + i % kK] = blk_in[(size_t)b * C * kK + i];
  for (int k = tid; k < kK; k += NT) ob[k] = lo_in[(size_t)b * kK + k];

  // sample i of the input rows in raw: blocking-matrix samples into the
  // next region, the beam, and in the xmu mode c_b bsq and the q steps
  auto convert = [&](int i, int buf) {
    float prev = raw[i];
    float sum = prev;
    for (int m = 1; m < M; ++m) {
      const float cur = raw[m * kT + i];
      ub[(m - 1) * kRow + kNxt + i] = cur - prev;
      sum += cur;
      prev = cur;
    }
    dz[buf * kT + i] = sum * cf.inv_m;
    if (XMU) {
      for (int ch = 0; ch < C; ++ch) {
        cbt[(buf * kCP + ch) * kT + i] = raw[(M + ch) * kT + i];
        qt[(buf * kCP + ch) * kT + i] = raw[(2 * M - 1 + ch) * kT + i];
      }
    }
  };
  // tile 0's tables, from the register and the tile
  __pipeline_wait_prior(0);
  __syncthreads();
  if (w > 0)
    for (int i = wt; i < kT; i += NW) convert(i, 0);
  __syncthreads();
  if (w > 0 && nt > 1) stage(raw, a, rows, S, kT, wt);
  for (int n = 0; n < kG; ++n) {
    if (w > 0) {
#pragma unroll
      for (int j = 0; j < kUPI; ++j)
        table_job<XMU>(job_at(wi, n * kUPI + j), ub, sg, cbt, qt, mx, wscr,
                       C, lane, cf);
    }
    __syncthreads();
  }

  unsigned long long n_fact = 0, n_rep = 0;
  float tp = 0.f;
  float xall[kL];                      // the chain's next-group cross terms
  // the end of tile k: its last group's update or replay
  auto finish = [&](int k) {
    const float* pf = pub + ((kG - 1) & 1) * kPub;
    const int kb = k & 1;
    if (pf[kL + 1] != 0.f) {
      tp = pf[kL];
      replay_group((kG - 1) * kL, w, lane, C, use_vad, ub, dz + kb * kT, hs,
                   cbt + kb * kCP * kT, qt + kb * kCP * kT, ob, red, g, tp,
                   mu_out, upd_out, obase + (size_t)k * kT, cf);
    } else if (w > 0) {
      float win[kSPW][kWin];
      load_wins(rows0, (kG - 1) * kL, lane, win);
      apply_update(win, g, pf);
    }
  };
  auto drain = [&](int k) {
    __syncwarp();
    for (int i = lane; i < kT; i += 32) {
      const float o = ob[kK + i];
      out[obase + (size_t)k * kT + i] = o;
      ob[i] = o;
    }
    __syncwarp();
  };

  for (int k = 0; k < nt; ++k) {
    const int kb = k & 1;
    // the tile's edge: the last tile's last group, group 0's base dots
    // (tile k still in the rows' next region), the drain and osq's history
    // part; the chain waits on this barrier alone
    __syncthreads();
    if (k > 0) finish(k - 1);
    if (w > 0) {
      float win[kSPW][kWin];
      load_wins(rows0 + kT, 0, lane, win);
      base_dots(win, lane, g, part, wi);
    } else {
      if (k > 0) drain(k - 1);
      output_suffix(ob, hs, lane);
    }
    __syncthreads();

    const float* dzk = dz + kb * kT;
    const float* sgk = sg + kb * kLags * kT;
    const float* cbk = cbt + kb * kCP * kT;
    const float* qk = qt + kb * kCP * kT;
    const float* mxk = mx + kb * kT;
    const size_t tbase = obase + (size_t)k * kT;
    if (w == 0) {
      // the chain: every lane runs the group's scalar recurrence; lane r
      // also sums the cross-group terms of the next group's sample
      // r mod kL
      tp = 0.f;
#pragma unroll
      for (int j = 0; j < kL; ++j) xall[j] = 0.f;
      bool resumed = false;
      const int rx = lane & (kL - 1);
      const float ksc = cf.kinv * kTwo32, m0s = cf.mu0 * kTwo16;
      for (int n = 0; n < kG; ++n) {
        const int t0g = n * kL;
        const bool nxt_ok = n + 1 < kG;
        // the group's input-only operands, before the barrier: hs, the
        // largest c_b bsq, the beam, the in-group Grams SG(t0g + j, d)
        // (gin[d][j], j >= d) and this lane's next-group Grams
        float hsv[kL], mxv[kL], dv[kL], sgx[kL], gin[kL][kL];
#pragma unroll
        for (int v = 0; v < kL / 4; ++v) {
          unpack(reinterpret_cast<const float4*>(hs + t0g)[v], hsv + 4 * v);
          unpack(reinterpret_cast<const float4*>(mxk + t0g)[v], mxv + 4 * v);
          unpack(reinterpret_cast<const float4*>(dzk + t0g)[v], dv + 4 * v);
        }
#pragma unroll
        for (int d = 1; d < kL; ++d) {
#pragma unroll
          for (int v = 0; v < kL / 4; ++v)
            unpack(reinterpret_cast<const float4*>(sgk + (d - 1) * kT +
                                                   t0g)[v],
                   gin[d] + 4 * v);
        }
#pragma unroll
        for (int s = 0; s < kL; ++s)
          sgx[s] = nxt_ok ? sgk[(kL + rx - s - 1) * kT + t0g + kL + rx]
                          : 0.f;
        if (n > 0 && !resumed) {
          // the cross-group terms the last group left
#pragma unroll
          for (int j = 0; j < kL; ++j)
            xall[j] = pub[((n - 1) & 1) * kPub + 16 + j];
          bar_sync(kBarBase + (n & 1));
        }
        resumed = false;
        float oe[kL];
#pragma unroll
        for (int j = 0; j < kL; ++j) {
          float pj[kPW];
#pragma unroll
          for (int v = 0; v < kPW / 4; ++v)
            unpack(reinterpret_cast<const float4*>(
                       part + ((n & 1) * kL + j) * kPW)[v], pj + 4 * v);
          float base = pj[0];
#pragma unroll
          for (int v = 1; v < kWW; ++v) base += pj[v];
          oe[j] = (dv[j] - base) - xall[j];
        }
        // the steps, branch-free: every lane the same scalar chain. chk
        // turns NaN at a non-finite output, osq / K beyond the scaled
        // range or step product; off at a non-zero update on the q branch
        const float tp0 = tp;
        float chk = 0.f, off = 0.f, xr = 0.f;
        float ws[kL], ps[kL], cs_[kL], us[kL];
#pragma unroll
        for (int s = 0; s < kL; ++s) {
          const float o = oe[s];
          const float osq = fmaf(o, o, hsv[s] + tp);
          tp = fmaf(o, o, tp);
          const float x = osq * ksc;
          const float p = m0s * rsqrt_ftz(x);
          const float co = cf.c_o * osq;
          const bool upd = !use_vad || osq < cf.vthr;
          const bool on = mxv[s] < co;
          const bool fin = p <= kMaxFloat;
          const float ou = upd ? o : 0.f;
          const float wv = on && fin ? p * ou : 0.f;
#pragma unroll
          for (int j = s + 1; j < kL; ++j)
            oe[j] = fmaf(-wv, gin[j - s][j], oe[j]);
          xr = fmaf(wv, sgx[s], xr);
          chk = fmaf(x, 0.f, chk);
          chk = fmaf(wv, 0.f, chk);
          off = fmaxf(off, on ? 0.f : fabsf(ou));
          ws[s] = wv;
          ps[s] = fin ? p : 0.f;
          cs_[s] = co;
          us[s] = upd ? 1.f : 0.f;
        }
        const bool bad = chk != chk || off > 0.f;
        float* pf = pub + (n & 1) * kPub;
        if (lane < kL) {
          ob[kK + t0g + lane] = pick(oe, lane);
          pf[lane] = pick(ws, lane);
          if (mu_out != nullptr) {
            const int i = t0g + lane;
            mu_out[tbase + i] = cbk[i] < pick(cs_, lane) ? pick(ps, lane)
                                                         : qk[i];
            upd_out[tbase + i] = pick(us, lane) != 0.f ? 1 : 0;
          }
        }
        if (lane == 0) {
          pf[kL] = tp0;
          pf[kL + 1] = bad ? 1.f : 0.f;
        }
        if (lane < kL) pf[16 + lane] = xr;
        if (bad) ++n_rep; else ++n_fact;
        if (nxt_ok) {
          __syncwarp();
          bar_arrive(kBarPub + (n & 1));
          if (bad) {
            // the workers replay the group with this warp, then form the
            // next group's base dots from the taps after it
            tp = tp0;
            bar_sync(kBarBase + ((n + 1) & 1));
            replay_group(t0g, w, lane, C, use_vad, ub, dzk, hs, cbk, qk, ob,
                         red, g, tp, mu_out, upd_out, tbase, cf);
            bar_sync(kBarRep);
#pragma unroll
            for (int j = 0; j < kL; ++j) xall[j] = 0.f;
            resumed = true;
          }
        }
      }
    } else {
      // the rows move up a tile: [history | tile] <- [tile | next], and
      // the tile after this one enters the next region
      __pipeline_wait_prior(0);
      bar_sync(kBarWork, NW);
      for (int j = wt; j < kT; j += NW) {
        for (int c = 0; c < C; ++c) {
          float* row = ub + c * kRow;
          row[kP + j] = row[kCur + j];
          row[kCur + j] = row[kNxt + j];
        }
        if (k + 1 < nt) convert(j, kb ^ 1);
      }
      bar_sync(kBarWork, NW);
      if (k + 2 < nt) stage(raw, a, rows, S, (k + 2) * kT, wt);
      for (int n = 0; n < kG; ++n) {
        if (n > 0) {
          bar_sync(kBarPub + ((n - 1) & 1));
          const float* pf = pub + ((n - 1) & 1) * kPub;
          if (pf[kL + 1] != 0.f) {
            float tpr = pf[kL];
            replay_group((n - 1) * kL, w, lane, C, use_vad, ub, dzk, hs, cbk,
                         qk, ob, red, g, tpr, mu_out, upd_out, tbase, cf);
            float wn[kSPW][kWin];
            load_wins(rows0, n * kL, lane, wn);
            base_dots(wn, lane, g, part + (n & 1) * kL * kPW, wi);
            bar_sync(kBarRep);
          } else {
            float wu[kSPW][kWin];
            load_wins(rows0, (n - 1) * kL, lane, wu);
            apply_update(wu, g, pf);
          }
        }
        if (n + 1 < kG) {
          float wd[kSPW][kWin];
          load_wins(rows0, (n + 1) * kL, lane, wd);
          base_dots(wd, lane, g, part + ((n + 1) & 1) * kL * kPW, wi);
          bar_arrive(kBarBase + ((n + 1) & 1));
        }
        if (k + 1 < nt) {
          const int nb = kb ^ 1;
#pragma unroll
          for (int j = 0; j < kUPI; ++j)
            table_job<XMU>(job_at(wi, n * kUPI + j), ub,
                           sg + nb * kLags * kT, cbt + nb * kCP * kT,
                           qt + nb * kCP * kT, mx + nb * kT, wscr, C, lane,
                           cf);
        }
      }
    }
  }
  __syncthreads();
  finish(nt - 1);
  __syncthreads();
  if (w == 0) {
    drain(nt - 1);
    if (lane == 0 && counts != nullptr) {
      atomicAdd(counts, n_fact);
      atomicAdd(counts + 1, n_rep);
    }
  }
  __syncthreads();

  if (w > 0) {
#pragma unroll
    for (int cs = 0; cs < kSPW; ++cs) {
      const int ch = c0 + cs;
      if (ch < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const size_t dst = ((size_t)b * C + ch) * kK + 4 * lane + q;
          flt_out[dst] = g[cs][q] != g[cs][q] ? 0.f : g[cs][q];
        }
      }
    }
  }
  for (int i = tid; i < C * kK; i += NT)
    blk_out[(size_t)b * C * kK + i] = ub[(i / kK) * kRow + kCur + i % kK];
  for (int k = tid; k < kK; k += NT) lo_out[(size_t)b * kK + k] = ob[k];
}

template <bool XMU>
int launch(const float* in, const float* blk, const float* flt,
           const float* lo, float* out, float* blk_out, float* flt_out,
           float* lo_out, float* mu, uint8_t* upd, unsigned long long* counts,
           int B, int M, int S, int use_vad, Coef cf, cudaStream_t st) {
  const int rows = XMU ? 3 * M - 2 : M;
  const size_t smem = sizeof(float) * (kSmemHead + rows * kT);
  auto kernel = gsc_sample_kernel<XMU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT, smem, st>>>(in, blk, flt, lo, out, blk_out, flt_out,
                              lo_out, mu, upd, counts, M, S, use_vad, cf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: aligned (B, M, S) float32, or with xmu the packed (B, 3M-2, S)
// [audio | c_b bsq_c | q-branch steps], 16-byte aligned; blk, flt
// (B, M-1, 128); lo (B, 128); out (B, S) and the new state; mu (B, S)
// float32 and upd (B, S) bytes, or both null for no trace; counts (2,)
// int64 on the device or null: the launch adds the groups it ran
// factorised to counts[0] and those it replayed to counts[1]. coef: 1/K,
// mu0^2/K, mu_max^2/K, mu0, vad_threshold, 1/M, and the VAD threshold on
// osq. 2 <= M <= 16, S a positive multiple of 128.
int bf_gsc_sample(const float* in, const float* blk, const float* flt,
                  const float* lo, float* out, float* blk_out,
                  float* flt_out, float* lo_out, float* mu, uint8_t* upd,
                  void* counts, int B, int M, int S, int xmu, int use_vad,
                  const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || S < kT || S % kT ||
      reinterpret_cast<uintptr_t>(in) % 16)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3],
                coef[4], coef[5], coef[6]};
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counts;
  if (xmu)
    return launch<true>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                        upd, c, B, M, S, use_vad, cf, st);
  return launch<false>(in, blk, flt, lo, out, blk_out, flt_out, lo_out, mu,
                       upd, c, B, M, S, use_vad, cf, st);
}

}  // extern "C"
