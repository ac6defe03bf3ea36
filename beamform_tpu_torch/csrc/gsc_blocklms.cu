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
// sample: 11,256 dependent blocks at l = 128. On the TPU the FIR and the
// correlation were DFT matmuls on the matrix unit in three bf16 passes;
// here both are direct float32 sums over the frozen block from shared
// memory. Design: one block of 256 threads per stream walks the blocks in
// order, with ucat, the filters, the outputs and the power prefixes in
// shared memory (up to 220 KB at l = 1024 and 16 mics). The FIR gives each
// thread l / 128 outputs over half of the channels (the filter tap is a
// broadcast read, the window 32 consecutive words); the gradient gives each
// thread one tap of every other channel, a dot product over the block's l
// samples; one warp per row scans the squares into prefix sums. Every dot
// product runs in 8 interleaved float32 partial sums added as a tree: one
// long sequential float32 sum over a channel's taps put the output 8x
// further from float64 than the plain version's library products (1.8e-07
// against 2.3e-08 on an H100). The FIR and gradient read shared
// memory twice per multiply-add, which bounds the kernel (a register
// window over the sliding outputs would read it once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;
constexpr int kThreads = 256;
constexpr int kAcc = 8;            // interleaved partial sums of a dot product
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.402823466e38f;

struct Coef {
  float kinv, c_b, c_o, mu0, vad, inv_m;
};

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float step_of(float mu0, float p, float kinv) {
  const float mu = mu0 * rsqrtf(clamp0(p * kinv));
  return mu <= kMaxFloat ? mu : 0.f;
}

// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))
__device__ __forceinline__ float tree_sum(const float (&p)[kAcc]) {
  return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
}

// inclusive prefix sums of x^2 over n values, by one warp
__device__ void warp_prefix_sq(const float* x, float* dst, int n, int lane) {
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float v = i < n ? x[i] * x[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    v += carry;
    if (i < n) dst[i] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

// R = l / 128 outputs per FIR thread
template <int R>
__global__ void __launch_bounds__(kThreads)
    gsc_blocklms_kernel(const float* __restrict__ a,
                        const float* __restrict__ blk_in,
                        const float* __restrict__ flt_in,
                        const float* __restrict__ lo_in,
                        float* __restrict__ out, float* __restrict__ blk_out,
                        float* __restrict__ flt_out,
                        float* __restrict__ lo_out, int M, int S,
                        int use_vad, Coef cf) {
  constexpr int L = R * kK;
  constexpr int N = kK + L;          // ucat length
  extern __shared__ float sm[];
  const int C = M - 1;
  float* uc = sm;                    // C x N: [register | block] per channel
  float* ps = uc + C * N;            // C x N: prefix of squares; FIR partials
  float* ww = ps + C * N;            // C x L: mu * out
  float* fl = ww + C * L;            // C x K: the filters
  float* fo = fl + C * kK;           // N: [last outputs | block outputs]
  float* po = fo + N;                // N: prefix of fo^2
  float* dz = po + N;                // L: the block's fixed beam
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* ab = a + (size_t)b * M * S;

  for (int i = tid; i < C * kK; i += kThreads) {
    const int c = i / kK, k = i % kK;
    fl[i] = flt_in[(size_t)b * C * kK + i];
    uc[c * N + k] = blk_in[(size_t)b * C * kK + i];
  }
  for (int k = tid; k < kK; k += kThreads) fo[k] = lo_in[(size_t)b * kK + k];
  const int half = (C + 1) / 2;      // FIR: channels of each thread half
  const int h = tid / kK;            // 0 or 1
  const int jj = tid % kK;

  for (int t0 = 0; t0 < S; t0 += L) {
    for (int i = tid; i < L; i += kThreads) {
      float prev = ab[t0 + i];
      float sum = prev;
      for (int m = 1; m < M; ++m) {
        const float cur = ab[(size_t)m * S + t0 + i];
        uc[(m - 1) * N + kK + i] = cur - prev;
        sum += cur;
        prev = cur;
      }
      dz[i] = sum * cf.inv_m;
    }
    __syncthreads();

    // FIR with the frozen filters: thread (h, jj) sums outputs jj + 128 r
    // over channels [h * half, min(C, (h + 1) * half)); each channel's
    // 128 taps go into kAcc interleaved partial sums combined as a tree,
    // so no float32 sum runs longer than 16 terms
    {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const int c1 = min(C, (h + 1) * half);
      for (int c = h * half; c < c1; ++c) {
        const float* row = uc + c * N + jj + 1;
        const float* f = fl + c * kK;
        float part[R][kAcc];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int v = 0; v < kAcc; ++v) part[r][v] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < kK; k0 += kAcc) {
#pragma unroll
          for (int v = 0; v < kAcc; ++v) {
            const float gk = f[k0 + v];
#pragma unroll
            for (int r = 0; r < R; ++r)
              part[r][v] = fmaf(gk, row[k0 + v + r * kK], part[r][v]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += tree_sum(part[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) ps[h * L + jj + r * kK] = acc[r];
    }
    __syncthreads();
    for (int j = tid; j < L; j += kThreads) {
      const float o = dz[j] - (ps[j] + ps[L + j]);
      fo[kK + j] = o;
      out[(size_t)b * S + t0 + j] = o;
    }
    __syncthreads();

    // prefix sums of the squares: one warp per row (C channels, outputs)
    for (int r = warp; r <= C; r += kThreads / 32) {
      if (r < C)
        warp_prefix_sq(uc + r * N, ps + r * N, N, lane);
      else
        warp_prefix_sq(fo, po, N, lane);
    }
    __syncthreads();

    // per-sample steps against the windowed powers
    for (int i = tid; i < C * L; i += kThreads) {
      const int c = i / L, j = i % L;
      const float osq = po[kK + j] - po[j];
      const float bsq = ps[c * N + kK + j] - ps[c * N + j];
      const float p = step_of(cf.mu0, osq, cf.kinv);
      const float q = step_of(cf.mu0, bsq, cf.kinv);
      float mu = cf.c_b * bsq < cf.c_o * osq ? p : q;
      if (use_vad && !(sqrtf(clamp0(osq * cf.kinv)) < cf.vad)) mu = 0.f;
      ww[i] = mu * fo[kK + j];
    }
    __syncthreads();

    // accumulated gradient: thread (h, k) takes tap k of channels h, h+2..
    for (int c = h; c < C; c += 2) {
      const float* row = uc + c * N + jj + 1;
      const float* w = ww + c * L;
      float part[kAcc];
#pragma unroll
      for (int v = 0; v < kAcc; ++v) part[v] = 0.f;
#pragma unroll 2
      for (int j0 = 0; j0 < L; j0 += kAcc) {
#pragma unroll
        for (int v = 0; v < kAcc; ++v)
          part[v] = fmaf(w[j0 + v], row[j0 + v], part[v]);
      }
      const float gn = fl[c * kK + jj] + tree_sum(part);
      fl[c * kK + jj] = gn != gn ? 0.f : gn;
    }
    __syncthreads();

    // the block's last K samples and outputs become the registers
    for (int i = tid; i < C * kK; i += kThreads) {
      const int c = i / kK, k = i % kK;
      uc[c * N + k] = uc[c * N + L + k];
    }
    for (int k = tid; k < kK; k += kThreads) fo[k] = fo[L + k];
    __syncthreads();
  }

  for (int i = tid; i < C * kK; i += kThreads) {
    const int c = i / kK, k = i % kK;
    flt_out[(size_t)b * C * kK + i] = fl[i];
    blk_out[(size_t)b * C * kK + i] = uc[c * N + k];
  }
  for (int k = tid; k < kK; k += kThreads) lo_out[(size_t)b * kK + k] = fo[k];
}

template <int R>
int launch(const float* a, const float* blk, const float* flt,
           const float* lo, float* out, float* blk_out, float* flt_out,
           float* lo_out, int B, int M, int S, int use_vad, Coef cf,
           cudaStream_t st) {
  constexpr int L = R * kK, N = kK + L;
  const int C = M - 1;
  const size_t smem =
      sizeof(float) * (2 * C * N + C * L + C * kK + 2 * N + L);
  cudaError_t err = cudaFuncSetAttribute(
      gsc_blocklms_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gsc_blocklms_kernel<R><<<B, kThreads, smem, st>>>(
      a, blk, flt, lo, out, blk_out, flt_out, lo_out, M, S, use_vad, cf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: aligned (B, M, S) float32; blk, flt (B, M-1, 128); lo (B, 128); out
// (B, S) and the new state. l in {128, 256, 512, 1024}, S a positive
// multiple of l, 2 <= M <= 16. coef: 1/K, mu0^2, mu_max^2, mu0,
// vad_threshold, 1/M.
int bf_gsc_blocklms(const float* a, const float* blk, const float* flt,
                    const float* lo, float* out, float* blk_out,
                    float* flt_out, float* lo_out, int B, int M, int S, int l,
                    int use_vad, const float* coef, void* stream) {
  if (M < 2 || M > 16 || B < 1 || l < kK || S < l || S % l)
    return (int)cudaErrorInvalidValue;
  const Coef cf{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5]};
  cudaStream_t st = (cudaStream_t)stream;
  switch (l) {
    case 128:
      return launch<1>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B, M,
                       S, use_vad, cf, st);
    case 256:
      return launch<2>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B, M,
                       S, use_vad, cf, st);
    case 512:
      return launch<4>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B, M,
                       S, use_vad, cf, st);
    case 1024:
      return launch<8>(a, blk, flt, lo, out, blk_out, flt_out, lo_out, B, M,
                       S, use_vad, cf, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
