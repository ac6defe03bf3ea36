// GSC's block-LMS adaptive stage (solver="blocklms") for Hopper (sm_90a),
// bound with ctypes.
//
// gsc_blocklms_kernel replaces beamform_tpu/kernels/gsc_blocklms.py:_kernel
// (reached through gsc_blocklms_pallas_batched) and computes what its plain
// formulation gsc_blocklms_scan does (gsc_blocklms.py:285-341): the
// reference's per-sample updates (gsc.cpp:162-169) accumulate over a block
// of l samples (l in 128, 256, 512, 1024) against filters frozen for the
// block, and land at its end. Per block, with ucat_c = [K = 128 register
// samples | l new blocking-matrix samples] per channel:
//
//   out[j]   = das[j] - sum_c sum_k g_c[k] ucat_c[j + k + 1]
//   osq[j]   = power of the K outputs up to j, bsq_c[j] of the K u_c up to
//              j (differences of prefix sums over the block's K + l values)
//   mu_c[j]  = mu0 / sqrt(osq / K) if mu0^2 bsq_c < mu_max^2 osq, else
//              mu0 / sqrt(bsq_c / K), 0 where not finite; 0 where the VAD
//              gate (sqrt(osq / K) >= vad_threshold) holds the filters
//   g_c[k]  += sum_j mu_c[j] out[j] ucat_c[j + k + 1], a NaN tap becomes 0
//
// What bounds it on this card: ~4 C K operations a sample as for the
// per-sample recurrence (11 Gflop over 30 s at 16 mics, 0.17 ms at the
// float32 peak), but the serial chain is one step per block, not per
// sample: 11,256 dependent blocks at l = 128. Only the outputs cross
// channels, so one stream runs on a thread-block cluster: CTA r of a
// cluster owns one or two channels (kernels/gsc_blocklms.py cluster_plan:
// one a CTA up to 8 channels, two beyond, so a cluster never passes the
// portable 8 CTAs and 32 streams fill 2 CTAs an SM), with its rows of
// ucat, its filters, their prefix of squares and its mic rows in its own
// shared memory. Per block:
//   1. each CTA forms its channels' FIR partials and publishes its share
//      of the outputs, its mics' part of the beam less its FIR, into one of
//      two slots by block parity;
//   2. one cluster barrier, split: between arrive and wait the CTA issues
//      the next block's cp.async copies and scans its rows' squares
//      (input-only);
//   3. every CTA reads all ranks' shares over distributed shared memory in
//      rank order (so every CTA forms the same outputs) and scans their
//      squares in the same pass, rank 0 writes them; the steps and its
//      channels' gradient follow with no further traffic between CTAs.
// The FIR and the gradient are the same correlation y[a] = sum_b v[b]
// x[a + b + 1]: a thread forms 8 consecutive outputs over 16 terms from a
// register window of 23 samples (0.3 shared words an FMA, six 16-byte
// loads of the row and four of v), so no float32 sum runs longer than 16
// terms before a tree of the partials (one long float32 sum over a
// channel's taps was 8x further from float64 than the plain version). The
// scans are block-wide (several rows side by side), the next block's mic
// rows land by cp.async while the current block computes. On an H100 80GB
// HBM3 at 700 W and 1,980 MHz, 16 mics over 30 s: 28.6 ms a call at l =
// 128 (8 CTAs of 2 channels, ~5,000 cycles a block, stamped: FIR 616,
// gradient 584, the share and the cluster arrive 1,393, the row scans 648,
// the outputs over distributed shared memory with their scan 818), 17.6 ms
// at l = 512; 32 streams of 10 s 14.6 ms (256 CTAs on 132 SMs).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 128;
constexpr int kNT = 256;               // threads per CTA
constexpr int kR = 8;                  // outputs a thread forms of a sum
constexpr int kTerms = 16;             // terms a thread sums of each
constexpr int kTapSplits = kK / kTerms;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m, vthr;
};

// Shared floats of a CTA at block length L with CPC channel slots (mirrored
// by kernels/gsc_blocklms.py smem_bytes): the ucat rows (3 words of pad in
// front of each, so the correlations' windows load as 16-byte words),
// their prefix of squares, [last | block] outputs and their prefix, the
// filters, mu out, this CTA's part of the beam, two published slots, the
// correlations' partials, the next block's mic rows, scan scratch.
template <int L, int CPC>
struct Layout {
  static constexpr int N = kK + L;
  static constexpr int RS = N + 4;
  static constexpr int E = (N + kNT - 1) / kNT;    // scan values a thread
  static constexpr int uc = 0;
  static constexpr int ps = uc + CPC * RS;
  static constexpr int fo = ps + CPC * N;
  static constexpr int po = fo + N;
  static constexpr int fl = po + N;
  static constexpr int ww = fl + CPC * kK;
  static constexpr int dzp = ww + CPC * L;
  static constexpr int pub = dzp + L;
  static constexpr int part = pub + 2 * L;
  static constexpr int raw = part + kTapSplits * CPC * L;
  static constexpr int scr = raw + (CPC + 1) * L;
  static constexpr int total = scr + 32;
};

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float step_of(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(clamp0(p * kinv));
  return mu <= kMaxFloat ? mu : 0.f;
}

// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), p_i = p[i * stride]
__device__ __forceinline__ float tree8(const float* p, int stride) {
  return ((p[0] + p[stride]) + (p[2 * stride] + p[3 * stride])) +
         ((p[4 * stride] + p[5 * stride]) + (p[6 * stride] + p[7 * stride]));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// queue the copy of the block at t0 of `rows` mic rows (16 bytes a copy)
template <int L>
__device__ __forceinline__ void stage(float* raw, const float* a, int rows,
                                      int S, int t0, int tid) {
  for (int e = tid; e < rows * (L / 4); e += kNT) {
    const int r = e / (L / 4), q = e - r * (L / 4);
    __pipeline_memcpy_async(raw + r * L + 4 * q,
                            a + (size_t)r * S + t0 + 4 * q, 16);
  }
  __pipeline_commit();
}

// Block-wide inclusive prefix sums of R rows side by side: v[r][q] holds
// this thread's in-thread prefix over values tid E .. tid E + E - 1 of row
// r; a warp scan of the threads' sums, then the warps' totals in order
// (through wsum, 8 R floats). Writes dst + r ds; the caller synchronises
// before reading it.
template <int E, int R>
__device__ __forceinline__ void scan_finish(const float (&v)[R][E],
                                            float* dst, int ds, int n,
                                            float* wsum, int tid) {
  const int lane = tid & 31, w = tid >> 5;
  float t[R], off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = v[r][E - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float y = __shfl_up_sync(kFull, t[r], o);
      if (lane >= o) t[r] += y;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 31) wsum[8 * r + w] = t[r];
    off[r] = __shfl_up_sync(kFull, t[r], 1);
    if (lane == 0) off[r] = 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 a = reinterpret_cast<const float4*>(wsum + 8 * r)[0];
    const float4 c = reinterpret_cast<const float4*>(wsum + 8 * r)[1];
    const float tot[7] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z};
    float base = 0.f;
#pragma unroll
    for (int u = 0; u < 7; ++u)
      if (u < w) base += tot[u];
    off[r] += base;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = tid * E + q;
      if (i < n) dst[r * ds + i] = off[r] + v[r][q];
    }
  }
}

// acc[r] = sum_{t < kTerms} v[t] x[ab + t + r + 1], r < kR, where x[i] sits
// at row[3 + i]: a register window of kR + kTerms - 1 samples. v and
// row + 4 + ab are 16-byte aligned.
__device__ __forceinline__ void corr(const float* v, const float* row, int ab,
                                     float (&acc)[kR]) {
  float vv[kTerms], xw[kR + kTerms];
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int q = 0; q < kTerms / 4; ++q) {
    const float4 f = v4[q];
    vv[4 * q] = f.x;
    vv[4 * q + 1] = f.y;
    vv[4 * q + 2] = f.z;
    vv[4 * q + 3] = f.w;
  }
  const float4* x4 = reinterpret_cast<const float4*>(row + 4 + ab);
#pragma unroll
  for (int q = 0; q < (kR + kTerms) / 4; ++q) {
    const float4 f = x4[q];
    xw[4 * q] = f.x;
    xw[4 * q + 1] = f.y;
    xw[4 * q + 2] = f.z;
    xw[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kTerms; ++t) s = fmaf(vv[t], xw[r + t], s);
    acc[r] = s;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&acc)[kR]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  d4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// a CTA per (stream, channel group); a cluster of cs CTAs per stream
template <int L, int CPC>
__global__ void __launch_bounds__(kNT, 1)
    gsc_blocklms_kernel(const float* __restrict__ a,
                        const float* __restrict__ blk_in,
                        const float* __restrict__ flt_in,
                        const float* __restrict__ lo_in,
                        float* __restrict__ out, float* __restrict__ blk_out,
                        float* __restrict__ flt_out,
                        float* __restrict__ lo_out, int M, int S,
                        int use_vad, Coef cf) {
  using Ly = Layout<L, CPC>;
  constexpr int N = Ly::N, RS = Ly::RS;
  constexpr int kSplitsJ = L / kTerms;       // the gradient's term splits
  extern __shared__ __align__(16) float sm[];
  float* uc = sm + Ly::uc;     // CPC x RS: [pad 3 | register | block | 1]
  float* ps = sm + Ly::ps;     // CPC x N: prefix of ucat^2
  float* fo = sm + Ly::fo;     // N: [last outputs | block outputs]
  float* po = sm + Ly::po;     // N: prefix of fo^2
  float* fl = sm + Ly::fl;     // CPC x K: the filters
  float* ww = sm + Ly::ww;     // CPC x L: mu * out
  float* dzp = sm + Ly::dzp;   // L: this CTA's mics' part of the beam
  float* pub = sm + Ly::pub;   // 2 x L: the published share, by parity
  float* part = sm + Ly::part; // the correlations' partials
  float* raw = sm + Ly::raw;   // (CPC + 1) x L: the next block's mic rows
  float* scr = sm + Ly::scr;   // 32: scan scratch
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int C = M - 1;
  const int ch0 = rank * CPC;                // this CTA's first channel
  const int nch = min(CPC, C - ch0);         // and how many it owns
  const int rows = nch + 1;                  // mics ch0 .. ch0 + nch
  const float* ab = a + ((size_t)b * M + ch0) * S;
  const int tid = threadIdx.x;

  stage<L>(raw, ab, rows, S, 0, tid);
  for (int i = tid; i < CPC * RS; i += kNT) {
    const int c = i / RS, k = i % RS - 3;
    float v = 0.f;                           // padding slots stay zero
    if (c < nch && k >= 0 && k < kK)
      v = blk_in[((size_t)b * C + ch0 + c) * kK + k];
    uc[i] = v;
  }
  for (int i = tid; i < CPC * kK; i += kNT)
    fl[i] = i / kK < nch ? flt_in[((size_t)b * C + ch0) * kK + i] : 0.f;
  for (int k = tid; k < kK; k += kNT) fo[k] = lo_in[(size_t)b * kK + k];

  for (int t0 = 0, n = 0; t0 < S; t0 += L, ++n) {
    // the block's rows: u_c behind the register, and this CTA's mics' sum
    // (rank 0 also holds mic 0)
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = tid; j < L; j += kNT) {
      float prev = raw[j];
      float s = rank == 0 ? prev : 0.f;
      for (int q = 0; q < nch; ++q) {
        const float cur = raw[(q + 1) * L + j];
        uc[q * RS + 3 + kK + j] = cur - prev;
        s += cur;
        prev = cur;
      }
      dzp[j] = s * cf.inv_m;
    }
    __syncthreads();
    const int par = n & 1;

    // 1. FIR partials with the frozen filters: unit (c, tap split, output
    // group), 8 outputs over 16 taps
    for (int u = tid; u < CPC * L; u += kNT) {
      const int ag = u % (L / kR), rest = u / (L / kR);
      const int bs = rest % kTapSplits, c = rest / kTapSplits;
      float acc[kR];
      corr(fl + c * kK + bs * kTerms, uc + c * RS, ag * kR + bs * kTerms, acc);
      store8(part + (c * kTapSplits + bs) * L + ag * kR, acc);
    }
    __syncthreads();
    for (int j = tid; j < L; j += kNT) {
      float f = 0.f;
#pragma unroll
      for (int c = 0; c < CPC; ++c)
        f += tree8(part + c * kTapSplits * L + j, L);
      pub[par * L + j] = dzp[j] - f;
    }
    cluster_arrive();
    if (t0 + L < S) stage<L>(raw, ab, rows, S, t0 + L, tid);

    // 2. input-only, while the other CTAs arrive: the rows' prefix of
    // squares
    {
      float v[CPC][Ly::E];
#pragma unroll
      for (int c = 0; c < CPC; ++c) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < Ly::E; ++q) {
          const int i = tid * Ly::E + q;
          const float x = i < N ? uc[c * RS + 3 + i] : 0.f;
          v[c][q] = s = fmaf(x, x, s);
        }
      }
      scan_finish<Ly::E, CPC>(v, ps, N, N, scr, tid);
    }
    cluster_wait();

    // 3. the block's outputs, every rank's share in rank order, and their
    // prefix of squares in the same pass
    {
      float v[1][Ly::E];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < Ly::E; ++q) {
        const int i = tid * Ly::E + q;
        float x = 0.f;
        if (i < kK) {
          x = fo[i];
        } else if (i < N) {
          const int j = i - kK;
          float r[kMaxCluster];
#pragma unroll
          for (int u = 0; u < kMaxCluster; ++u)
            r[u] = u < cs ? *cluster.map_shared_rank(pub + par * L + j, u)
                          : 0.f;
          x = r[0];
#pragma unroll
          for (int u = 1; u < kMaxCluster; ++u) x += r[u];
          fo[i] = x;
          if (rank == 0) out[(size_t)b * S + t0 + j] = x;
        }
        v[0][q] = s = fmaf(x, x, s);
      }
      scan_finish<Ly::E, 1>(v, po, N, N, scr + 24, tid);
    }
    __syncthreads();

    // 4. the per-sample steps against the windowed powers
    for (int i = tid; i < CPC * L; i += kNT) {
      const int c = i / L, j = i % L;
      const float osq = po[kK + j] - po[j];
      const float bsq = ps[c * N + kK + j] - ps[c * N + j];
      const float p = step_of(cf.mu0, osq, cf.kinv);
      const float q = step_of(cf.mu0, bsq, cf.kinv);
      float mu = cf.c_b * bsq < cf.c_o * osq ? p : q;
      if (use_vad && !(clamp0(osq) < cf.vthr)) mu = 0.f;
      ww[i] = mu * fo[kK + j];
    }
    __syncthreads();

    // 5. the accumulated gradient: unit (c, term split, tap group), 8 taps
    // over 16 samples
    for (int u = tid; u < CPC * L; u += kNT) {
      const int kg = u % (kK / kR), rest = u / (kK / kR);
      const int js = rest % kSplitsJ, c = rest / kSplitsJ;
      float acc[kR];
      corr(ww + c * L + js * kTerms, uc + c * RS, kg * kR + js * kTerms, acc);
      store8(part + (c * kSplitsJ + js) * kK + kg * kR, acc);
    }
    __syncthreads();

    // 6. the update, NaN taps scrubbed; the block's last K samples and
    // outputs become the registers
    if (tid < CPC * kK) {
      const int c = tid / kK, k = tid % kK;
      const float* p = part + c * kSplitsJ * kK + k;
      float gs = 0.f;
#pragma unroll
      for (int q = 0; q < kSplitsJ; q += 8) gs += tree8(p + q * kK, kK);
      const float gn = fl[tid] + gs;
      fl[tid] = gn != gn ? 0.f : gn;
      uc[c * RS + 3 + k] = uc[c * RS + 3 + L + k];
    }
    if (tid < kK) fo[tid] = fo[L + tid];
  }
  __syncthreads();

  for (int i = tid; i < nch * kK; i += kNT) {
    const size_t dst = ((size_t)b * C + ch0) * kK + i;
    flt_out[dst] = fl[i];
    blk_out[dst] = uc[(i / kK) * RS + 3 + i % kK];
  }
  if (rank == 0)
    for (int k = tid; k < kK; k += kNT) lo_out[(size_t)b * kK + k] = fo[k];
  // no CTA leaves while another may still read its published share
  cluster.sync();
}

template <int L, int CPC>
int launch(const float* a, const float* blk, const float* flt,
           const float* lo, float* out, float* blk_out, float* flt_out,
           float* lo_out, int B, int M, int S, int use_vad, int cs,
           int smem, Coef cf, cudaStream_t st) {
  if (smem != (int)sizeof(float) * Layout<L, CPC>::total)
    return (int)cudaErrorInvalidValue;
  auto kernel = gsc_blocklms_kernel<L, CPC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, blk, flt, lo, out, blk_out,
                           flt_out, lo_out, M, S, use_vad, cf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int L>
int launch_l(const float* a, const float* blk, const float* flt,
             const float* lo, float* out, float* blk_out, float* flt_out,
             float* lo_out, int B, int M, int S, int use_vad, int cs,
             int cpc, int smem, Coef cf, cudaStream_t st) {
  if (cpc == 1)
    return launch<L, 1>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B,
                        M, S, use_vad, cs, smem, cf, st);
  return launch<L, 2>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B, M,
                      S, use_vad, cs, smem, cf, st);
}

}  // namespace

extern "C" {

// a: aligned (B, M, S) float32, 16-byte aligned; blk, flt (B, M-1, 128); lo
// (B, 128); out (B, S) and the new state. l in {128, 256, 512, 1024}, S a
// positive multiple of l, 2 <= M <= 16. cs CTAs a stream of cpc channels
// each (1 or 2; every channel owned once, every CTA owns one) and smem
// bytes a CTA, as kernels/gsc_blocklms.py cluster_plan and smem_bytes give
// them. coef: 1/K, mu0^2/K, mu_max^2/K, mu0, vad_threshold, 1/M, and the
// VAD threshold on osq.
int bf_gsc_blocklms(const float* a, const float* blk, const float* flt,
                    const float* lo, float* out, float* blk_out,
                    float* flt_out, float* lo_out, int B, int M, int S, int l,
                    int use_vad, int cs, int cpc, int smem,
                    const float* coef, void* stream) {
  const int C = M - 1;
  if (M < 2 || M > 16 || B < 1 || l < kK || S < l || S % l ||
      reinterpret_cast<uintptr_t>(a) % 16 || cpc < 1 || cpc > 2 || cs < 1 ||
      cs > kMaxCluster || cs * cpc < C || (cs - 1) * cpc >= C)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3],
                coef[4], coef[5], coef[6]};
  cudaStream_t st = (cudaStream_t)stream;
  switch (l) {
    case 128:
      return launch_l<128>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B,
                           M, S, use_vad, cs, cpc, smem, cf, st);
    case 256:
      return launch_l<256>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B,
                           M, S, use_vad, cs, cpc, smem, cf, st);
    case 512:
      return launch_l<512>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B,
                           M, S, use_vad, cs, cpc, smem, cf, st);
    case 1024:
      return launch_l<1024>(a, blk, flt, lo, out, blk_out, flt_out, lo_out,
                            B, M, S, use_vad, cs, cpc, smem, cf, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
