// Batched unpivoted complex Gauss-Jordan inverse for Hopper (sm_90a), bound
// with ctypes.
//
// gj_inverse_kernel replaces beamform_tpu/kernels/linalg.py:_gj_kernel
// (reached through gj_inverse_pallas / gj_inverse_pallas_native): B
// complex M x M matrices, Hermitian positive definite after MVDR's 1.001
// diagonal loading, inverted by M steps of unpivoted Gauss-Jordan
// elimination, optionally followed by one Newton-Schulz step
// X <- X (2I - A X). Same arithmetic as the Pallas kernel: complex division
// by the pivot as a * conj(p) / |p|^2, rank-1 row updates in the same order.
//
// What bounds it on this card: little arithmetic per byte. At the dense
// MVDR block (55,596 matrices of 16 x 16, complex64) the kernel moves
// 2 KB per matrix in and out (228 MB) and does about 32 k flop per matrix
// without the polish; the TPU kernel was also bound by memory, which is why
// it kept the whole elimination in VMEM. Here the elimination stays in
// registers: MP lanes of a warp (M rounded up to a power of two, at most
// 32) hold one matrix, lane j owning column j of the working matrix and of
// the inverse. Each step's pivot-row entry is the lane's own register; the
// factor column lives in lane i and reaches the others by warp shuffles,
// so there is no shared memory and no block barrier. Loads and stores walk
// rows, so neighbouring lanes touch neighbouring addresses. Lanes past M,
// and matrices past B, hold identity columns and are never loaded or
// stored: the ragged edge is masked, not padded in memory. The polish
// reloads A from device memory rather than keeping it in registers.
//
// No fast-math intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr int kGjThreads = 256;

template <int MP>
__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src, MP),
                     __shfl_sync(0xffffffffu, v.y, src, MP));
}

// column ``lane`` of matrix ``b``, rows 0..MP-1, identity beyond M or B
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

template <int MP>
__global__ void __launch_bounds__(kGjThreads)
    gj_inverse_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                      int B, int M, int polish) {
  const int lane = threadIdx.x % MP;                // column j
  const int b = blockIdx.x * (kGjThreads / MP) + threadIdx.x / MP;
  const bool in = b < B && lane < M;
  const size_t base = (size_t)b * M * M;

  float2 mat[MP], inv[MP];
  load_column<MP>(a, mat, in, base, M, lane);
#pragma unroll
  for (int r = 0; r < MP; ++r)
    inv[r] = make_float2(r == lane ? 1.f : 0.f, 0.f);

#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const float2 piv = shfl<MP>(mat[i], i);         // mat[i][i], in lane i
    const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
    // this lane's entry of the normalised pivot row: row_i / pivot
    const float2 prow = make_float2(
        (mat[i].x * piv.x + mat[i].y * piv.y) * inv_den,
        (mat[i].y * piv.x - mat[i].x * piv.y) * inv_den);
    const float2 qrow = make_float2(
        (inv[i].x * piv.x + inv[i].y * piv.y) * inv_den,
        (inv[i].y * piv.x - inv[i].x * piv.y) * inv_den);
#pragma unroll
    for (int r = 0; r < MP; ++r) {
      if (r == i) continue;
      const float2 f = shfl<MP>(mat[r], i);         // mat[r][i], in lane i
      mat[r] = make_float2(mat[r].x - (f.x * prow.x - f.y * prow.y),
                           mat[r].y - (f.x * prow.y + f.y * prow.x));
      inv[r] = make_float2(inv[r].x - (f.x * qrow.x - f.y * qrow.y),
                           inv[r].y - (f.x * qrow.y + f.y * qrow.x));
    }
    mat[i] = prow;
    inv[i] = qrow;
  }

  if (polish) {
    // T = 2I - A X, column ``lane``: sum over k of A[:, k] X[k][lane]
    float2 t[MP];
    load_column<MP>(a, mat, in, base, M, lane);     // mat := A
#pragma unroll
    for (int r = 0; r < MP; ++r)
      t[r] = make_float2(r == lane ? 2.f : 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const float2 x = inv[k];
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        const float2 ar = shfl<MP>(mat[r], k);      // A[r][k], in lane k
        t[r] = make_float2(t[r].x - (ar.x * x.x - ar.y * x.y),
                           t[r].y - (ar.x * x.y + ar.y * x.x));
      }
    }
    // X T, column ``lane``: sum over k of X[:, k] T[k][lane]
#pragma unroll
    for (int r = 0; r < MP; ++r) mat[r] = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const float2 tk = t[k];
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        const float2 xr = shfl<MP>(inv[r], k);      // X[r][k], in lane k
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

template <int MP>
cudaError_t launch_gj(const float2* a, float2* out, int B, int M, int polish,
                      cudaStream_t st) {
  constexpr int per_block = kGjThreads / MP;
  const int blocks = (B + per_block - 1) / per_block;
  gj_inverse_kernel<MP><<<blocks, kGjThreads, 0, st>>>(a, out, B, M, polish);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, out (B, M, M) complex64, row-major, 1 <= M <= 32. Returns the launch's
// cudaGetLastError().
int bf_gj_inverse(const void* a, void* out, int B, int M, int polish,
                  void* stream) {
  const float2* in = (const float2*)a;
  float2* o = (float2*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 4) return (int)launch_gj<4>(in, o, B, M, polish, st);
  if (M <= 8) return (int)launch_gj<8>(in, o, B, M, polish, st);
  if (M <= 16) return (int)launch_gj<16>(in, o, B, M, polish, st);
  if (M <= 32) return (int)launch_gj<32>(in, o, B, M, polish, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
