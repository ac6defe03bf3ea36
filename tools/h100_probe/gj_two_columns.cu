// csrc/linalg.cu's in-place elimination with two live columns a lane (lane
// l of a matrix's MP / 2 lanes holds columns l and l + MP / 2, so one
// broadcast read and one select serve two columns), unpolished, M = 16,
// for tools/h100_probe/gj_variants.py; not part of the package.
#include <cuda_runtime.h>
namespace {
constexpr int kWarps = 4;
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)p));
  return r;
}
__device__ __forceinline__ float2 cmsub(float2 b, float2 f, float2 p) {
  return make_float2(fmaf(f.y, p.y, fmaf(-f.x, p.x, b.x)),
                     fmaf(-f.y, p.x, fmaf(-f.x, p.y, b.y)));
}
template <int MP>
struct K2 {
  static constexpr int L = MP / 2;          // lanes a matrix
  static constexpr int G = 32 / L;          // matrices a warp
  static constexpr int kTile = G * MP * MP;
  static constexpr int kFbStride = MP + 2;
  static constexpr int kWarp = kTile + 2 * G * kFbStride;
  static constexpr size_t kSmem = sizeof(float2) * kWarp * kWarps;
};
template <int MP>
__global__ void __launch_bounds__(kWarps * 32, 4)
    k2_kernel(const float2* __restrict__ a, float2* __restrict__ out, int B,
              int M) {
  using S = K2<MP>;
  constexpr int L = S::L, G = S::G;
  extern __shared__ float4 sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* stage = reinterpret_cast<float2*>(sm) + warp * S::kWarp;
  const int l = lane % L, g = lane / L;
  float2* fb = stage + S::kTile + g * S::kFbStride;
  const long long tiles = ((long long)B + G - 1) / G;
  const long long stride = (long long)gridDim.x * kWarps;
  long long t = (long long)blockIdx.x * kWarps + warp;
  auto issue = [&](long long tt) {
    if (tt < tiles && tt * G + g < B) {
      const float2* src = a + (tt * G + g) * M * M;
      float2* d = stage + g * MP * MP;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = l + k * L;
        if (c < M)
#pragma unroll
          for (int r = 0; r < MP; ++r)
            if (r < M) cp_async8(d + r * MP + c, src + r * M + c);
      }
    }
    cp_async_commit();
  };
  issue(t);
  for (; t < tiles; t += stride) {
    cp_async_wait_all();
    __syncwarp();
    float2 col[2][MP];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < MP; ++r)
        col[k][r] = stage[g * MP * MP + r * MP + l + k * L];
    __syncwarp();
    issue(t + stride);
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      if (i < M) {
        const int ki = i / L, li = i % L;
        float2* f = fb + (i & 1) * G * S::kFbStride;
        const bool me = l == li;
        if (me) {
#pragma unroll
          for (int r = 0; r < MP; r += 2)
            *reinterpret_cast<float4*>(f + r) = make_float4(
                col[ki][r].x, col[ki][r].y, col[ki][r + 1].x, col[ki][r + 1].y);
        }
        __syncwarp();
        const float2 piv = f[i];
        const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
        float2 p[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool mk = k == ki && me;
          const float ax = sel(mk, 1.f, col[k][i].x), ay = sel(mk, 0.f, col[k][i].y);
          p[k] = make_float2((ax * piv.x + ay * piv.y) * inv_den,
                             (ay * piv.x - ax * piv.y) * inv_den);
        }
#pragma unroll
        for (int r = 0; r < MP; r += 2) {
          const float4 f2 = *reinterpret_cast<const float4*>(f + r);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = r + h;
            if (rr == i) continue;
            const float2 fv = h ? make_float2(f2.z, f2.w) : make_float2(f2.x, f2.y);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              if (k == ki)
                col[k][rr] = cmsub(make_float2(sel(me, 0.f, col[k][rr].x),
                                               sel(me, 0.f, col[k][rr].y)), fv, p[k]);
              else
                col[k][rr] = cmsub(col[k][rr], fv, p[k]);
            }
          }
        }
        col[0][i] = p[0];
        col[1][i] = p[1];
      }
    }
    const long long b = t * G + g;
    if (b < B) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = l + k * L;
        if (c < M) {
          float2* o = out + b * M * M + c;
#pragma unroll
          for (int r = 0; r < MP; ++r)
            if (r < M) o[r * M] = col[k][r];
        }
      }
    }
  }
  cp_async_wait_all();
}
}  // namespace
extern "C" int probe_k2(const void* a, void* out, int B, int M, void* st) {
  using S = K2<16>;
  static int blocks = 0;
  if (!blocks) {
    int per = 0, sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k2_kernel<16>, kWarps * 32, S::kSmem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = per * sms;
  }
  const long long tiles = ((long long)B + S::G - 1) / S::G;
  long long need = (tiles + kWarps - 1) / kWarps;
  const int nb = (int)(need < blocks ? need : blocks);
  k2_kernel<16><<<nb, kWarps * 32, S::kSmem, (cudaStream_t)st>>>(
      (const float2*)a, (float2*)out, B, M);
  return (int)cudaGetLastError();
}
extern "C" int probe_k2_blocks() {
  int per = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k2_kernel<16>, kWarps * 32, K2<16>::kSmem);
  return per;
}
