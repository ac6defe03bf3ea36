// Fused audio-to-audio GSS (geometric source separation) for Hopper
// (sm_90a), bound with ctypes.
//
// gss_kernel replaces beamform_tpu/kernels/gss_stream.py:_kernel (reached
// through gss_mega): raw audio hops in, separated audio out, in one launch.
// Per frame t of the call and in-band bin (gss.cpp:90-156):
//
//   analysis   band_wola.cuh: sqrt-Hann, nfft-point DFT on the register FFT,
//              the band's bins only, gate statistic sum_m |X_m| / (M nfft)
//   reset      W <- A^H on the frame's reset flag (update_weights)
//   output     y = W x with the pre-update W; source 0 where the gate
//              passes, else 0.01 * x[mic 0]; 0 outside the band
//   update     where the gate passes (gss.cpp:124-136):
//                E y = y (sum_k |y_k|^2 - |y|^2)
//                dJ1 = 4 S_act (E y) x^H / ||x||^4
//                dJ2 = (2 / S_act) (W A - diag(act)) A^H
//                W  <- (1 - lambda mu) W - mu (dJ1 + dJ2)
//   synthesis  the half spectrum (bin 0 out of band), window, overlap-add
//
// W (S x M per bin) carries through every frame, so unlike MVDR the march
// cannot be split into independent frames: it splits only by bin. A slot
// is active in a frame when its row of A^H is nonzero (the host passes one
// bit per slot and control row); inactive slots have zero rows of A^H, and
// their rows of W are zero after every reset, so their y, their updates and
// their terms of W A are zero: the kernel skips them, and leaves their rows
// of W as they are. S_act counts the active slots.
//
// Design. One persistent grid, launched cooperatively, walks segments of at
// most SEG frames in phases: phase k marches segment k - 1 (stage B, on
// the grid's first GB blocks), and on the other blocks analyses segment k
// (stage A: a block takes one frame and a group of channel pairs, 16
// points a thread in registers, as the fused MVDR/LCMV kernel) and
// synthesises segment k - 2 (one block per frame); a grid barrier ends the
// phase. The march thus overlaps the FFTs, and a segment costs one barrier.
// The spectra and outputs of two segments ((2, SEG, NIB, M): a bin's mics
// contiguous; 16.7 MB at 16 mics, 678 bins, SEG 96; and 1.0 MB) stay in the
// 50 MB L2 cache.
//
// Stage B. MP lanes (M rounded up to a power of two) own one bin for the
// whole call; bin j's lanes are slot j / GB of marching block j % GB, so
// the 678 marches of the main path spread over the marching blocks. A
// march of 1407 dependent frames is latency-bound (a march that sums each
// quantity in a butterfly of its own and loads its controls from device
// memory spends ~1,590 SM-clock cycles a frame at one slot: the
// butterflies 930, the control loads 252), so the design shortens the
// chain of one frame:
//
//   - one butterfly a frame: y_a for the n active slots and (W A)[a][b]
//     both read the pre-update W and x_t, so their partial sums over mics
//     go through one xor butterfly together (2 n + 2 n^2 floats), not
//     n + n^2 butterflies one after the other; the update then runs in
//     registers;
//   - what depends on x alone off the chain: the gate statistic and
//     ||x||^2 (so dJ1's factor 4 S_act / ||x||^4) of frame t + 1 ride in
//     frame t's butterfly (2 more floats), so that frame t + 1 starts with
//     its gate and factor known;
//   - the active slots compacted: W's and A^H's rows of the n <= 4 active
//     slots (in slot order) live in registers, the march instantiated for
//     each n, so that a 16-slot state with three active slots costs what a
//     3-slot one does. Rows of inactive slots stay in w_out (initialised
//     from w0), which takes the registers' rows back when the control row
//     changes; more than four active slots take a slower path with the
//     rows in shared memory and one butterfly per row of W A;
//   - nothing global on the chain: the segment's control rows and reset
//     flags are staged into shared memory when the segment starts, each
//     lane keeps its own spectra kRing frames ahead in a shared-memory ring
//     filled by cp.async (a lane reads only what it copied, so no barrier),
//     and the next frame's control row, flag and spectra are read while
//     this frame's update runs.
//
// Every sum over mics is a xor butterfly in the order of a group_sum of
// that quantity alone, so the march's arithmetic is the same whatever
// shares a butterfly. Chunked output equals one call's bit for bit.
//
// What bounds it: the march's latency, 1407 dependent frames per bin on
// the main path, each one butterfly and the update's short chain, with a
// few warps per multiprocessor; stage A's FFTs run beside it on the other
// blocks, and the grid barriers come on top. Not bytes or flops. On an
// NVIDIA H100 80GB HBM3 at 700 W, at 16 mics, 678 bins and 1,407 frames, a
// call takes 0.75 ms at one slot, 1.21 ms at three and 1.33 ms at 16 slots
// with three active (1.84, 3.60 and 8.27 with a butterfly per quantity and
// one block role); the marching blocks work 91% of the call at one slot,
// ~770 SM-clock cycles a frame (clock64() stamps: the butterfly 293, the
// update and the ring 328), the analysing blocks 41% (PERF.md section 6).
//
// Streams. One launch serves B streams, which share the control rows: the
// marching blocks' bin groups take the B NIB (stream, bin) pairs, in more
// than one turn where they outnumber the groups (at 8 streams of 678 bins
// and 16 mics, 198 of the 264 resident blocks march, in two turns), each
// stream's control rows and flags are staged apart, and the analysing
// blocks' items run over every stream's frames. A frame's serial chain is
// the one-stream design's; no barrier is added per stream. A single stream
// is B = 1, in the kernel's kOne form: with the pair loop and the stream
// offsets in the general form, a single stream's march spilled twice the
// bytes and took 13% longer.
//
// Index checks run here: a control index outside [0, U) makes the frame's
// output NaN (and a reset there W), a bin outside [1, nfft / 2) its
// spectra and output NaN. Neither is dereferenced.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_wola.cuh"
#include "stream_solve.cuh"

namespace {

using bf_band::kThreads;
using bf_stream::cmul;
using bf_stream::cmul_conj;

constexpr int kRing = 4;     // frames of spectra a lane has in flight
constexpr int kFast = 4;     // active slots the register path takes
constexpr int kSlots = 16;   // source slots at most
constexpr int kNone = -2;    // no control row loaded

// B streams share the control rows (ah, act); the other arrays but ib and
// the tables have a stream axis
struct GssArgs {
  const float* x;         // (B, M, T * hop) audio
  const float* tail;      // (B, M, hop) analysis carry
  const float* out_prev;  // (B, hop) overlap-add carry
  const float2* w0;       // (B, NIB, S, M) demixing state
  const float2* ah;       // (U, S, M, NIB) A^H per control row
  const int* act;         // (U,) bit s: slot s of the row is active
  const int64_t* idx;     // (B, T) control row per frame
  const uint8_t* reset;   // (B, T) W <- A^H before the frame
  const int64_t* ib;      // (NIB,) in-band bins
  const float* win;       // (nfft,) sqrt-Hann
  const float2* tw;       // (nfft / 2,) exp(-2 pi i j / nfft): synthesis
  const float2* ptw;      // the analysis FFT's pass twiddles
                          // (kernels/wola.py analysis_plan)
  float* out;             // (B, T * hop) zero on entry
  float* new_prev;        // (B, hop)
  float2* w_out;          // (B, NIB, S, M): W's rows while not in registers
  float2* xsc;            // scratch (2, B, SEG, NIB, M): two segments'
                          // spectra
  float2* ys;             // scratch (2, B, SEG, NIB): two segments' output
  int B, M, T, hop, log2n, NIB, U, S, SEG;
  float thr, mu, lam;
};

// float2 elements of stage B's shared memory: the spectra ring, with more
// than kFast slots the rows of W and A^H of the slow path; then each
// stream's SEG control rows (int) and reset flags (bytes)
__host__ __device__ constexpr int ring_elems() { return kRing * kThreads; }
__host__ __device__ constexpr int wide_elems(int S) {
  return S > kFast ? 2 * kSlots * kThreads : 0;
}

// One bin's lanes' context: lane i (mic i) of bin j of a stream.
struct Lane {
  const GssArgs& p;
  float2* ring;           // [kRing][kThreads]
  float2* wsh;            // [kSlots][kThreads] W's active rows (slow path)
  float2* ahsh;           // [kSlots][kThreads] A^H's active rows
  const int* su;          // (SEG,) control row per frame, -1 when bad
  const uint8_t* srst;    // (SEG,) reset flags
  const float2* xsc;      // the segment's spectra (SEG, NIB, M)
  float2* ys;             // the segment's output (SEG, NIB)
  unsigned grp;           // the bin's MP lanes
  int i, j, jw, F;        // jw: the (stream, bin) pair, W's row in w_out
  float scale, one_lm;
};

// The spectra ring. Each lane copies frame g's x_i into its slot with
// cp.async, one commit group per frame, and reads only what it copied, so
// no barrier is needed. Frame g + kRing goes in when frame g is done; frame
// g + 2 is read then (frame g + 1 too when a march starts at g), when at
// most kRing - 2 groups after it may still be in flight.
__device__ __forceinline__ void ring_put(const Lane& c, int g) {
  if (g < c.F && c.i < c.p.M)
    __pipeline_memcpy_async(
        c.ring + (g % kRing) * kThreads + threadIdx.x,
        c.xsc + ((size_t)g * c.p.NIB + c.j) * c.p.M + c.i, sizeof(float2));
  __pipeline_commit();
}

__device__ __forceinline__ float2 ring_peek(const Lane& c, int g) {
  __pipeline_wait_prior(kRing - 2);
  return c.i < c.p.M ? c.ring[(g % kRing) * kThreads + threadIdx.x]
                     : make_float2(0.f, 0.f);
}

// the ring at the segment's start: frames 0 .. kRing - 1 queued, frame 0
// read
__device__ __forceinline__ float2 ring_start(const Lane& c) {
  for (int g = 0; g < kRing; ++g) ring_put(c, g);
  return ring_peek(c, 0);
}

// the xor butterfly over the bin's MP lanes, every entry of v at once
template <int MP, int NV>
__device__ __forceinline__ void butterfly(unsigned grp, float (&v)[NV]) {
#pragma unroll
  for (int off = MP / 2; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < NV; ++e) v[e] += __shfl_xor_sync(grp, v[e], off, MP);
}

// What a frame's update needs from x alone: the gate (sum_m |x_m| against
// the threshold) and c1 = 4 S_act / ||x||^4 (dJ1's factor). A frame's two
// sums come either from a butterfly of their own (gate_of) or from the
// previous frame's butterfly; the operations are spelt out with the _rn
// intrinsics, so that both give the same bits and chunked output equals
// one call's.
struct Gate {
  bool pass;
  float c1;
};

// the lane's two partials of the gate: |x_i|^2 and |x_i|
__device__ __forceinline__ float2 gate_partials(float2 x) {
  const float e = __fmaf_rn(x.x, x.x, __fmul_rn(x.y, x.y));
  return make_float2(e, sqrtf(e));
}

// the gate from the sums over mics of gate_partials
__device__ __forceinline__ Gate gate_from(const Lane& c, float xx, float ax,
                                          int n) {
  return {__fmul_rn(ax, c.scale) > c.p.thr,
          __fdiv_rn(4.f * (float)n, fmaxf(__fmul_rn(xx, xx), 1e-30f))};
}

template <int MP>
__device__ __forceinline__ Gate gate_of(const Lane& c, float2 x, int n) {
  const float2 e = gate_partials(x);
  float v[2] = {e.x, e.y};
  butterfly<MP, 2>(c.grp, v);
  return gate_from(c, v[0], v[1], n);
}

__device__ __forceinline__ size_t w_at(const GssArgs& p, int j, int s,
                                       int i) {
  return ((size_t)j * p.S + s) * p.M + i;
}
__device__ __forceinline__ size_t ah_at(const GssArgs& p, int u, int s, int i,
                                        int j) {
  return (((size_t)u * p.S + s) * p.M + i) * p.NIB + j;
}

// W <- A^H at mic i for the slots that are not active in row u (their
// rows in w_out, (B NIB, S, M), at pair jw; A^H at bin j); the caller
// resets the active ones
__device__ __noinline__ void reset_inactive(float2* __restrict__ w_out,
                                            const float2* __restrict__ ah,
                                            int S, int M, int NIB, int u,
                                            unsigned am, int j, int jw,
                                            int i) {
  if (i >= M) return;
  for (int s = 0; s < S; ++s)
    if (!((am >> s) & 1u))
      w_out[((size_t)jw * S + s) * M + i] =
          ah[(((size_t)u * S + s) * M + i) * NIB + j];
}

// The output of frame f for lane 0: source 0 where the gate passes (NaN
// for a bad control row), else the passthrough
__device__ __forceinline__ void put_y(const Lane& c, int f, bool gate,
                                      float2 y0, float2 x) {
  if (c.i == 0)
    c.ys[(size_t)f * c.p.NIB + c.j] =
        gate ? y0 : make_float2(0.01f * x.x, 0.01f * x.y);
}

// Frames f .. of the segment with control row u (su[f] == u) and N <=
// kFast active slots (am; compacted in slot order in w and ah), until the
// segment ends or the control row changes; returns the first frame not
// marched, whose x (read from the ring) is left in x, as frame f's was on
// entry. The chain of a frame is its partials, one butterfly and the
// update: the butterfly also carries the next frame's gate partials (read
// from the ring two frames ahead), so that the next gate and c1 are ready
// when that frame starts.
template <int MP, int N>
__device__ __forceinline__ int march_fast(const Lane& c, int f, int u,
                                          unsigned am, float2 (&w)[kFast],
                                          float2 (&ah)[kFast], float2& x) {
  constexpr int NV = 2 * N + 2 * N * N + 2;
  const GssArgs& p = c.p;
  const bool src0 = am & 1u;                // slot 0 is active
  Gate g = gate_of<MP>(c, x, N);
  float2 xn = f + 1 < c.F ? ring_peek(c, f + 1) : make_float2(0.f, 0.f);
  float2 en = gate_partials(xn);
  bool rf = c.srst[f];
  for (;;) {
    if (rf) {                               // update_weights, gss.cpp:90-93
#pragma unroll
      for (int a = 0; a < N; ++a) w[a] = ah[a];
      if (__popc(am) < p.S)
        reset_inactive(p.w_out, p.ah, p.S, p.M, p.NIB, u, am, c.j, c.jw,
                       c.i);
    }
    // the lane's partials of y_a = W x and (W A)[a][b], and the next
    // frame's gate partials
    float v[NV];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const float2 q = cmul(w[a], x);
      v[2 * a] = q.x;
      v[2 * a + 1] = q.y;
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const float2 r = cmul_conj(w[a], ah[b]);
        v[2 * N + 2 * (a * N + b)] = r.x;
        v[2 * N + 2 * (a * N + b) + 1] = r.y;
      }
    }
    v[NV - 2] = en.x;
    v[NV - 1] = en.y;
    butterfly<MP, NV>(c.grp, v);
    float2 y[N > 0 ? N : 1];
    float tot = 0.f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      y[a] = make_float2(v[2 * a], v[2 * a + 1]);
      tot += y[a].x * y[a].x + y[a].y * y[a].y;
    }
    put_y(c, f, g.pass, N > 0 && src0 ? y[0] : make_float2(0.f, 0.f), x);

    const int fn = f + 1;
    const bool more = fn < c.F;
    const int un = more ? c.su[fn] : kNone;
    const bool rn = more && c.srst[fn];
    if (N > 0 && g.pass) {
      const float c2 = 2.f / (float)(N > 0 ? N : 1);
#pragma unroll
      for (int a = 0; a < N; ++a) {
        // dJ1 row a, lane i: c1 (E y)_a conj(x_i)
        const float e2 = tot - (y[a].x * y[a].x + y[a].y * y[a].y);
        const float2 ey = make_float2(y[a].x * e2, y[a].y * e2);
        const float2 d1 = cmul_conj(ey, x);
        // dJ2 row a, lane i: sum_b ((W A)[a][b] - delta_ab) A^H[b][i]
        float2 d2 = make_float2(0.f, 0.f);
#pragma unroll
        for (int b = 0; b < N; ++b) {
          float2 wa = make_float2(v[2 * N + 2 * (a * N + b)],
                                  v[2 * N + 2 * (a * N + b) + 1]);
          if (a == b) wa.x -= 1.f;
          const float2 r = cmul(wa, ah[b]);
          d2 = make_float2(d2.x + r.x, d2.y + r.y);
        }
        w[a] = make_float2(
            c.one_lm * w[a].x - p.mu * (g.c1 * d1.x + c2 * d2.x),
            c.one_lm * w[a].y - p.mu * (g.c1 * d1.y + c2 * d2.y));
      }
    }
    const Gate gn = gate_from(c, v[NV - 2], v[NV - 1], N);
    ring_put(c, f + kRing);                 // frame f's slot is free
    // frame f + 2's spectra and gate partials, for the next butterfly
    const float2 xnn =
        f + 2 < c.F ? ring_peek(c, f + 2) : make_float2(0.f, 0.f);
    f = fn;
    x = xn;
    if (un != u) return f;
    g = gn;
    rf = rn;
    xn = xnn;
    en = gate_partials(xnn);
  }
}

// As march_fast for n > kFast active slots: the compacted rows of W and
// A^H in shared memory (wsh, ahsh), one butterfly for y and one for each
// row of W A.
template <int MP>
__device__ __forceinline__ int march_wide(const Lane& c, int f, int u,
                                          unsigned am, int n, float2& x) {
  const GssArgs& p = c.p;
  const int tid = threadIdx.x;
  for (;;) {
    if (c.srst[f]) {
      for (int a = 0; a < n; ++a)
        c.wsh[a * kThreads + tid] = c.ahsh[a * kThreads + tid];
      if (n < p.S)
        reset_inactive(p.w_out, p.ah, p.S, p.M, p.NIB, u, am, c.j, c.jw,
                       c.i);
    }
    const Gate g = gate_of<MP>(c, x, n);
    float v[2 * kSlots];
#pragma unroll
    for (int a = 0; a < kSlots; ++a) {
      const float2 q = a < n ? cmul(c.wsh[a * kThreads + tid], x)
                             : make_float2(0.f, 0.f);
      v[2 * a] = q.x;
      v[2 * a + 1] = q.y;
    }
    butterfly<MP, 2 * kSlots>(c.grp, v);
    float tot = 0.f;
#pragma unroll
    for (int a = 0; a < kSlots; ++a)
      if (a < n) tot += v[2 * a] * v[2 * a] + v[2 * a + 1] * v[2 * a + 1];
    put_y(c, f, g.pass, (am & 1u) ? make_float2(v[0], v[1])
                                  : make_float2(0.f, 0.f), x);
    if (g.pass) {
      const float c2 = 2.f / (float)n;
      for (int a = 0; a < n; ++a) {
        float2 ya = make_float2(0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kSlots; ++q)
          if (q == a) ya = make_float2(v[2 * q], v[2 * q + 1]);
        const float2 wa_row = c.wsh[a * kThreads + tid];
        float r[2 * kSlots];
#pragma unroll
        for (int b = 0; b < kSlots; ++b) {
          const float2 e =
              b < n ? cmul_conj(wa_row, c.ahsh[b * kThreads + tid])
                    : make_float2(0.f, 0.f);
          r[2 * b] = e.x;
          r[2 * b + 1] = e.y;
        }
        butterfly<MP, 2 * kSlots>(c.grp, r);
        const float e2 = tot - (ya.x * ya.x + ya.y * ya.y);
        const float2 ey = make_float2(ya.x * e2, ya.y * e2);
        const float2 d1 = cmul_conj(ey, x);
        float2 d2 = make_float2(0.f, 0.f);
#pragma unroll
        for (int b = 0; b < kSlots; ++b) {
          if (b >= n) break;
          float2 wa = make_float2(r[2 * b], r[2 * b + 1]);
          if (a == b) wa.x -= 1.f;
          const float2 q = cmul(wa, c.ahsh[b * kThreads + tid]);
          d2 = make_float2(d2.x + q.x, d2.y + q.y);
        }
        c.wsh[a * kThreads + tid] = make_float2(
            c.one_lm * wa_row.x - p.mu * (g.c1 * d1.x + c2 * d2.x),
            c.one_lm * wa_row.y - p.mu * (g.c1 * d1.y + c2 * d2.y));
      }
    }
    const int fn = f + 1;
    const bool more = fn < c.F;
    x = more ? ring_peek(c, fn) : make_float2(0.f, 0.f);
    ring_put(c, f + kRing);
    f = fn;
    if (!more || c.su[fn] != u) return f;
  }
}

// The march state that outlives a segment: the control row loaded (kNone
// for none), its active slots, and the registers' rows of W and A^H
// (n <= kFast).
struct State {
  int u;
  unsigned am;
  int n;
  float2 w[kFast], ah[kFast];
};

// W's active rows of the loaded control row back to w_out
__device__ __forceinline__ void write_back(const Lane& c, const State& s) {
  const GssArgs& p = c.p;
  if (s.u < 0 || c.i >= p.M) return;
  unsigned rest = s.am;
  if (s.n <= kFast) {
#pragma unroll
    for (int a = 0; a < kFast; ++a) {
      if (a >= s.n) break;
      const int slot = __ffs(rest) - 1;
      rest &= rest - 1u;
      p.w_out[w_at(p, c.jw, slot, c.i)] = s.w[a];
    }
  } else {
    for (int a = 0; a < s.n; ++a) {
      const int slot = __ffs(rest) - 1;
      rest &= rest - 1u;
      p.w_out[w_at(p, c.jw, slot, c.i)] = c.wsh[a * kThreads + threadIdx.x];
    }
  }
}

// Load control row u: its active slots, their rows of W (from w_out) and of
// A^H, compacted in slot order.
__device__ __forceinline__ void load_row(const Lane& c, State& s, int u) {
  const GssArgs& p = c.p;
  s.u = u;
  s.am = (unsigned)p.act[u] & (p.S >= 32 ? ~0u : (1u << p.S) - 1u);
  s.n = __popc(s.am);
  const bool in = c.i < p.M;
  unsigned rest = s.am;
  if (s.n <= kFast) {
#pragma unroll
    for (int a = 0; a < kFast; ++a) {
      s.w[a] = s.ah[a] = make_float2(0.f, 0.f);
      if (a < s.n) {
        const int slot = __ffs(rest) - 1;
        rest &= rest - 1u;
        if (in) {
          s.w[a] = p.w_out[w_at(p, c.jw, slot, c.i)];
          s.ah[a] = p.ah[ah_at(p, u, slot, c.i, c.j)];
        }
      }
    }
  } else {
    for (int a = 0; a < s.n; ++a) {
      const int slot = __ffs(rest) - 1;
      rest &= rest - 1u;
      const int q = a * kThreads + threadIdx.x;
      c.wsh[q] = in ? p.w_out[w_at(p, c.jw, slot, c.i)]
                    : make_float2(0.f, 0.f);
      c.ahsh[q] = in ? p.ah[ah_at(p, u, slot, c.i, c.j)]
                     : make_float2(0.f, 0.f);
    }
  }
}

// Stage B of the segment for one bin's lanes.
template <int MP>
__device__ __forceinline__ void march(const Lane& c, State& s) {
  const GssArgs& p = c.p;
  float2 x = ring_start(c);
  int f = 0;
  while (f < c.F) {
    const int u = c.su[f];
    if (u < 0) {
      // a bad control row: no update; NaN output where the gate passes;
      // a reset makes every row of W NaN
      write_back(c, s);
      s.u = kNone;
      const float nan = __int_as_float(0x7fc00000);
      put_y(c, f, gate_of<MP>(c, x, 0).pass, make_float2(nan, nan), x);
      if (c.srst[f] && c.i < p.M)
        for (int sl = 0; sl < p.S; ++sl)
          p.w_out[w_at(p, c.jw, sl, c.i)] = make_float2(nan, nan);
      const float2 xn = f + 1 < c.F ? ring_peek(c, f + 1)
                                    : make_float2(0.f, 0.f);
      ring_put(c, f + kRing);
      x = xn;
      ++f;
      continue;
    }
    if (u != s.u) {
      write_back(c, s);
      load_row(c, s, u);
    }
    switch (s.n) {
      case 0: f = march_fast<MP, 0>(c, f, u, s.am, s.w, s.ah, x); break;
      case 1: f = march_fast<MP, 1>(c, f, u, s.am, s.w, s.ah, x); break;
      case 2: f = march_fast<MP, 2>(c, f, u, s.am, s.w, s.ah, x); break;
      case 3: f = march_fast<MP, 3>(c, f, u, s.am, s.w, s.ah, x); break;
      case 4: f = march_fast<MP, 4>(c, f, u, s.am, s.w, s.ah, x); break;
      default: f = march_wide<MP>(c, f, u, s.am, s.n, x); break;
    }
  }
  __pipeline_wait_prior(0);
}

// Two blocks of 256 threads an SM (128 registers a thread). The grid is
// resident; its first GB blocks march, the others analyse and synthesise,
// so that a segment's march overlaps the next segment's analysis and the
// synthesis of the one before: phase k marches segment k - 1 (spectra and
// output in the buffers of its parity), analyses segment k and
// synthesises segment k - 2, and a grid barrier ends the phase. The
// marching blocks' bin groups take the B NIB (stream, bin) pairs in turns,
// each pair's rows of W going back to w_out at the end of its march of a
// segment. kOne is one stream whose bins the groups cover at once: every
// stream offset folds away, and a group keeps its rows of W in registers
// from segment to segment, so that a single stream's march keeps the
// registers it had without a stream axis.
template <int MP, bool kOne>
__global__ void __launch_bounds__(kThreads, 2) gss_kernel(GssArgs p,
                                                          int GB) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int n = 2 * p.hop;
  const int M = p.M, NIB = p.NIB, B = kOne ? 1 : p.B;
  const size_t plane = (size_t)M * NIB;
  const size_t len = (size_t)p.T * p.hop;
  const bool marcher = (int)blockIdx.x < GB;

  // this thread's mic, and its first (stream, bin) pair; pass q takes
  // pair pr0 + q * stride
  const int i = threadIdx.x % MP;
  const int pr0 = (threadIdx.x / MP) * GB + blockIdx.x;
  const int stride = GB * (kThreads / MP);
  const int npairs = B * NIB;
  const bool owner = marcher && pr0 < npairs;
  const unsigned grp =
      MP == 32 ? 0xffffffffu
               : ((1u << (MP % 32)) - 1u) << ((threadIdx.x % 32) / MP * MP);
  float2* ahsh = smem + ring_elems() + kSlots * kThreads;
  int* su = reinterpret_cast<int*>(smem + ring_elems() + wide_elems(p.S));
  uint8_t* srst = reinterpret_cast<uint8_t*>(su + B * p.SEG);
  Lane c{p,   smem, smem + ring_elems(), ahsh,      su, srst, p.xsc, p.ys,
         grp, i,    kOne ? pr0 : pr0 % NIB, pr0,      0,
         1.f / (float)(M * 2 * p.hop),     1.f - p.lam * p.mu};
  State st;
  st.u = kNone;
  st.am = 0u;
  st.n = 0;
  // W's rows start in w_out, (B NIB, S, M) as w0
  if (marcher && i < M)
    for (int pr = pr0; pr < npairs; pr += stride)
      for (int s = 0; s < p.S; ++s)
        p.w_out[w_at(p, pr, s, i)] = p.w0[w_at(p, pr, s, i)];

  const int nseg = (p.T + p.SEG - 1) / p.SEG;
  const int gp = kThreads * 16 / n;                 // pairs a block at once
  const int groups = ((M + 1) / 2 + gp - 1) / gp;   // of a frame
  for (int k = 0; k <= nseg + 1; ++k) {
    if (marcher) {
      // the march of segment k - 1: every stream's control rows and reset
      // flags staged, then every (stream, bin) pair
      const int sg = k - 1;
      if (sg >= 0 && sg < nseg) {
        const int t0 = sg * p.SEG;
        const int F = min(p.SEG, p.T - t0);
        for (int q = threadIdx.x; q < B * F; q += kThreads) {
          const int sb = kOne ? 0 : q / F, f = kOne ? q : q % F;
          const int64_t u = p.idx[(size_t)sb * p.T + t0 + f];
          su[sb * p.SEG + f] = u < 0 || u >= p.U ? -1 : (int)u;
          srst[sb * p.SEG + f] = p.reset[(size_t)sb * p.T + t0 + f];
        }
        __syncthreads();
        for (int pr = pr0; pr < npairs; pr += stride) {
          const int sb = kOne ? 0 : pr / NIB;
          c.j = kOne ? pr : pr % NIB;
          c.jw = pr;
          c.F = F;
          c.su = su + sb * p.SEG;
          c.srst = srst + sb * p.SEG;
          c.xsc = p.xsc + ((size_t)(sg & 1) * B + sb) * p.SEG * plane;
          c.ys = p.ys + ((size_t)(sg & 1) * B + sb) * p.SEG * NIB;
          march<MP>(c, st);
          if (kOne) break;
          write_back(c, st);
          st.u = kNone;
        }
      }
    } else {
      // the analysis of segment k, the synthesis of segment k - 2, of
      // every stream
      const int t0 = k * p.SEG;
      const int F = k < nseg ? min(p.SEG, p.T - t0) : 0;
      const int tp = t0 - 2 * p.SEG;
      const int Fp = k >= 2 ? min(p.SEG, p.T - tp) : 0;
      const int ni = F * groups + Fp;               // items a stream
      for (int it = blockIdx.x - GB; it < B * ni; it += gridDim.x - GB) {
        const int sb = kOne ? 0 : it / ni, item = kOne ? it : it % ni;
        const size_t buf = (size_t)(k & 1) * B + sb;
        if (item < F * groups) {
          const int f = item / groups;
          bf_band::analyze_band<true>(
              p.hop, smem, p.x + (size_t)sb * M * len,
              p.tail + (size_t)sb * M * p.hop, p.win, p.ptw, p.ib,
              p.xsc + (buf * p.SEG + f) * plane, nullptr, M, p.T, NIB,
              t0 + f, (item - f * groups) * gp);
        } else {
          const int f = item - F * groups;
          bf_band::load_half_spectrum(smem, n, p.log2n, 0.f,
                                      p.ys + (buf * p.SEG + f) * NIB, p.ib,
                                      NIB);
          bf_band::synthesize_frame(
              smem, p.tw, p.win, p.out_prev + (size_t)sb * p.hop,
              p.out + (size_t)sb * len, p.new_prev + (size_t)sb * p.hop,
              p.T, p.hop, p.log2n, tp + f);
        }
      }
    }
    if (k <= nseg) bf_band::grid_sync();
  }

  if (owner && kOne) write_back(c, st);
}

// the larger of the analysis and synthesis blocks' (the analysis FFT's
// padded frames, or one nfft-point synthesis frame) and the marching
// blocks' (the ring, the slow path's rows, each stream's SEG control rows
// and flags)
inline size_t gss_smem(const GssArgs& a) {
  size_t smem = (size_t)bf_fft::padded(kThreads * 16) * sizeof(float2);
  if ((size_t)2 * a.hop * sizeof(float2) > smem)
    smem = (size_t)2 * a.hop * sizeof(float2);
  const size_t b = (size_t)(ring_elems() + wide_elems(a.S)) * sizeof(float2) +
                   (size_t)a.B * a.SEG * (sizeof(int) + 1);
  if (b > smem) smem = b;
  return (smem + 15) / 16 * 16;
}

template <int MP, bool kOne>
cudaError_t launch_gss(const GssArgs& a, int grid, int GB, cudaStream_t st) {
  GssArgs args = a;
  void* params[] = {&args, &GB};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)gss_kernel<MP, kOne>, dim3(grid), dim3(kThreads),
      params, gss_smem(a), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The resident grid and the marching blocks: half the grid, or as many
// blocks as the (stream, bin) pairs need; where that is all of the grid,
// three quarters march, the pairs in turns. One stream whose bins one turn
// covers takes kOne.
template <int MP>
cudaError_t launch_mp(const GssArgs& a, cudaStream_t st) {
  const size_t smem = gss_smem(a);
  const int bins = kThreads / MP;                 // bins a marching block
  const int pairs = a.B * a.NIB;
  cudaError_t err = cudaSuccess;
  int grid = bf_band::resident_grid(gss_kernel<MP, true>, smem, err);
  if (grid == 0) return err;
  int GB = grid / 2;
  if (GB * bins < pairs) GB = (pairs + bins - 1) / bins;
  if (a.B == 1 && GB < grid) return launch_gss<MP, true>(a, grid, GB, st);
  grid = bf_band::resident_grid(gss_kernel<MP, false>, smem, err);
  if (grid == 0) return err;
  GB = grid / 2;
  if (GB * bins < pairs) GB = (pairs + bins - 1) / bins;
  if (GB >= grid) GB = grid - grid / 4;
  if (GB < 1 || GB >= grid) return cudaErrorCooperativeLaunchTooLarge;
  return launch_gss<MP, false>(a, grid, GB, st);
}

}  // namespace

extern "C" {

// B streams in one launch: x (B, M, T*hop), tail (B, M, hop), out_prev
// (B, hop) float32; w0 (B, NIB, S, M) complex64; ah (U, S, M, NIB)
// complex64 and act (U,) int32, shared; idx (B, T), ib (NIB,) int64; reset
// (B, T) bool; win (2*hop) float32, tw (hop) complex64, ptw the analysis
// pass table (complex64); out (B, T*hop), new_prev (B, hop) float32; w_out
// (B, NIB, S, M) complex64; scratch xsc (2, B, SEG, NIB, M) and ys (2, B,
// SEG, NIB) complex64. B >= 1, 1 <= M <= 32, 1 <= S <= 16, T >= 1,
// SEG >= 1, hop in [128, 2048]. Returns the first CUDA error of the memset,
// the launch or its check.
int bf_gss_stream(const void* x, const void* tail, const void* out_prev,
                  const void* w0, const void* ah, const void* act,
                  const void* idx, const void* reset, const void* ib,
                  const void* win, const void* tw, const void* ptw, void* out,
                  void* new_prev, void* w_out, void* xsc, void* ys, int B,
                  int M, int T, int hop, int NIB, int U, int S, int SEG,
                  float thr, float mu, float lam, void* stream) {
  if (B < 1 || M < 1 || M > 32 || S < 1 || S > kSlots || T < 1 || SEG < 1 ||
      NIB < 1 || hop < 128 || hop > 2048)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * T * hop * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  GssArgs a;
  a.x = (const float*)x;
  a.tail = (const float*)tail;
  a.out_prev = (const float*)out_prev;
  a.w0 = (const float2*)w0;
  a.ah = (const float2*)ah;
  a.act = (const int*)act;
  a.idx = (const int64_t*)idx;
  a.reset = (const uint8_t*)reset;
  a.ib = (const int64_t*)ib;
  a.win = (const float*)win;
  a.tw = (const float2*)tw;
  a.ptw = (const float2*)ptw;
  a.out = (float*)out;
  a.new_prev = (float*)new_prev;
  a.w_out = (float2*)w_out;
  a.xsc = (float2*)xsc;
  a.ys = (float2*)ys;
  a.B = B;
  a.M = M;
  a.T = T;
  a.hop = hop;
  a.log2n = bf_band::ilog2(2 * hop);
  a.NIB = NIB;
  a.U = U;
  a.S = S;
  a.SEG = SEG;
  a.thr = thr;
  a.mu = mu;
  a.lam = lam;
  if (M <= 4) return (int)launch_mp<4>(a, st);
  if (M <= 8) return (int)launch_mp<8>(a, st);
  if (M <= 16) return (int)launch_mp<16>(a, st);
  return (int)launch_mp<32>(a, st);
}

}  // extern "C"
