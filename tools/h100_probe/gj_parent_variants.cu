// The two-matrix Gauss-Jordan kernel that csrc/linalg.cu replaced (lane j
// holds column j of the working matrix and of the inverse, the factor
// column broadcast by warp shuffles, the polish a runtime flag), copied
// whole (V = 0) and with one part changed, for tools/h100_probe/
// gj_variants.py: loads and stores only (1), the inverse's half of the
// update removed (2), the shuffles replaced by a shared-memory broadcast
// of the factor column (3). M = 16 only; not part of the package.
#include <cuda_runtime.h>

namespace {

constexpr int kGjThreads = 256;

template <int MP>
__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src, MP),
                     __shfl_sync(0xffffffffu, v.y, src, MP));
}

template <int MP>
__device__ __forceinline__ void load_column(const float2* __restrict__ a,
                                            float2 (&col)[MP], bool in,
                                            size_t base, int m, int lane) {
#pragma unroll
  for (int r = 0; r < MP; ++r) {
    col[r] = make_float2(r == lane ? 1.f : 0.f, 0.f);
    if (in && r < m) col[r] = a[base + (size_t)r * m + lane];
  }
}

template <int MP, int V>
__global__ void __launch_bounds__(kGjThreads)
    gj_inverse_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                      int B, int M, int polish) {
  __shared__ float4 fbs[kGjThreads / 2 + 32];
  const int lane = threadIdx.x % MP;
  const int b = blockIdx.x * (kGjThreads / MP) + threadIdx.x / MP;
  const bool in = b < B && lane < M;
  const size_t base = (size_t)b * M * M;
  float2* fb = reinterpret_cast<float2*>(fbs) + (threadIdx.x / MP) * (MP + 2);

  float2 mat[MP], inv[MP];
  load_column<MP>(a, mat, in, base, M, lane);
#pragma unroll
  for (int r = 0; r < MP; ++r)
    inv[r] = make_float2(r == lane ? 1.f : 0.f, 0.f);

  if (V != 1) {
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      if (V == 3) {
        if (lane == i) {
#pragma unroll
          for (int r = 0; r < MP; r += 2)
            *reinterpret_cast<float4*>(fb + r) =
                make_float4(mat[r].x, mat[r].y, mat[r + 1].x, mat[r + 1].y);
        }
        __syncwarp();
      }
      const float2 piv = V == 3 ? fb[i] : shfl<MP>(mat[i], i);
      const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
      const float2 prow = make_float2(
          (mat[i].x * piv.x + mat[i].y * piv.y) * inv_den,
          (mat[i].y * piv.x - mat[i].x * piv.y) * inv_den);
      const float2 qrow = make_float2(
          (inv[i].x * piv.x + inv[i].y * piv.y) * inv_den,
          (inv[i].y * piv.x - inv[i].x * piv.y) * inv_den);
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        if (r == i) continue;
        const float2 f = V == 3 ? fb[r] : shfl<MP>(mat[r], i);
        mat[r] = make_float2(mat[r].x - (f.x * prow.x - f.y * prow.y),
                             mat[r].y - (f.x * prow.y + f.y * prow.x));
        if (V != 2)
          inv[r] = make_float2(inv[r].x - (f.x * qrow.x - f.y * qrow.y),
                               inv[r].y - (f.x * qrow.y + f.y * qrow.x));
      }
      mat[i] = prow;
      inv[i] = qrow;
      if (V == 3) __syncwarp();
    }
  } else {
#pragma unroll
    for (int r = 0; r < MP; ++r) inv[r] = mat[r];
  }

  if (V != 1 && polish) {
    float2 t[MP];
    load_column<MP>(a, mat, in, base, M, lane);
#pragma unroll
    for (int r = 0; r < MP; ++r)
      t[r] = make_float2(r == lane ? 2.f : 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const float2 x = inv[k];
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        const float2 ar = shfl<MP>(mat[r], k);
        t[r] = make_float2(t[r].x - (ar.x * x.x - ar.y * x.y),
                           t[r].y - (ar.x * x.y + ar.y * x.x));
      }
    }
#pragma unroll
    for (int r = 0; r < MP; ++r) mat[r] = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const float2 tk = t[k];
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        const float2 xr = shfl<MP>(inv[r], k);
        mat[r] = make_float2(mat[r].x + (xr.x * tk.x - xr.y * tk.y),
                             mat[r].y + (xr.x * tk.y + xr.y * tk.x));
      }
    }
#pragma unroll
    for (int r = 0; r < MP; ++r) inv[r] = mat[r];
  }

  if (in) {
#pragma unroll
    for (int r = 0; r < MP; ++r)
      if (r < M) out[base + (size_t)r * M + lane] = inv[r];
  }
}

template <int V>
int launch(const void* a, void* out, int B, int M, int polish, void* st) {
  constexpr int per_block = kGjThreads / 16;
  const int blocks = (B + per_block - 1) / per_block;
  gj_inverse_kernel<16, V><<<blocks, kGjThreads, 0, (cudaStream_t)st>>>(
      (const float2*)a, (float2*)out, B, M, polish);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M = 16 only
int probe_gj(int v, const void* a, void* out, int B, int M, int polish,
             void* st) {
  switch (v) {
    case 0: return launch<0>(a, out, B, M, polish, st);
    case 1: return launch<1>(a, out, B, M, polish, st);
    case 2: return launch<2>(a, out, B, M, polish, st);
    default: return launch<3>(a, out, B, M, polish, st);
  }
}

int probe_occupancy(int v) {
  int n = 0;
  switch (v) {
    case 0: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gj_inverse_kernel<16, 0>, kGjThreads, 0); break;
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gj_inverse_kernel<16, 1>, kGjThreads, 0); break;
    case 2: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gj_inverse_kernel<16, 2>, kGjThreads, 0); break;
    default: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gj_inverse_kernel<16, 3>, kGjThreads, 0); break;
  }
  return n;
}

}
