// Batched unpivoted complex Gauss-Jordan inverse for Hopper (sm_90a), bound
// with ctypes.
//
// gj_inverse_kernel replaces beamform_tpu/kernels/linalg.py:_gj_kernel
// (reached through gj_inverse_pallas / gj_inverse_pallas_native): B
// complex M x M matrices, Hermitian positive definite after MVDR's 1.001
// diagonal loading, inverted by M steps of unpivoted Gauss-Jordan
// elimination, optionally followed by one Newton-Schulz step
// X <- X (2I - A X). Same arithmetic as the Pallas kernel: complex division
// by the pivot as a * conj(p) * (1 / |p|^2), rank-1 row updates in the same
// order, the polish's sums over k in ascending order.
//
// What bounds it on this card: at the dense MVDR block (55,596 matrices of
// 16 x 16, complex64) the kernel moves 2 KB per matrix in and out (228 MB,
// 0.068 ms at 3.35 TB/s) and issues ~15 k FFMA per matrix without the
// polish, close enough that both the SM's issue slots and the memory have
// to be kept busy at once:
//
// * In place, one live column a lane. MP lanes of a warp (M rounded up to
//   a power of two, at least 4) hold one matrix; lane j holds column j of
//   A until step j, and column j of the inverse from then on. At step i
//   lane i's column is the factor column; it turns into the inverse's
//   column i (-f_r / p off the pivot row, 1 / p on it: the update of a
//   zero column, selected per lane, never a branch), and every other lane
//   updates its one column with the pivot-row entry it owns. The
//   two-matrix form (A's column and the inverse's, 32 registers a lane at
//   M = 16) spent half its FFMAs on known zeros and units. Each complex
//   update is two FMAs a component, in the Pallas kernel's term order.
// * The factor column reaches the group's lanes through shared memory:
//   lane i stores it (MP / 2 16-byte stores), one __syncwarp, and every
//   lane reads it back as 16-byte broadcasts, two buffers by step parity
//   so one __syncwarp a step suffices; groups are padded apart by 16 bytes
//   so a warp's broadcasts fall in distinct banks.
// * Loads in flight during the elimination. Each warp walks tiles of
//   32 / MP matrices over a grid sized to what the card holds resident;
//   the next tile is copied to shared memory by cp.async (each lane its
//   own column, rows MP apart) while the current one is eliminated in
//   registers.
// * The polish is a template parameter: the unpolished instantiation (the
//   MVDR and LCMV R inverses) carries none of its state. The polished one
//   double-buffers the tiles, reads A from the staged copy, not again from
//   device memory, and broadcasts X's columns through the same buffer.
//
// Entries past M, and matrices past B, are never loaded or stored (the
// ragged edge is masked, not padded in memory): their lanes and rows
// compute on stale words of the buffer, and steps past M are skipped, so
// no stored entry depends on them. Singular inputs give inf/NaN as the
// plain version does: an exact zero pivot makes every entry NaN in both.
//
// No fast-math intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr int kGjWarps = 4;          // warps a block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// p ? a : b as a select, never a branch on the lane
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)p));
  return r;
}

// b - f p and acc + x t for complex values, each component two FMAs in the
// Pallas kernel's term order (its real part b - (f.x p.x - f.y p.y) is
// b - f.x p.x + f.y p.y, rounded twice where the unfused form rounds three
// times)
__device__ __forceinline__ float2 cmsub(float2 b, float2 f, float2 p) {
  return make_float2(fmaf(f.y, p.y, fmaf(-f.x, p.x, b.x)),
                     fmaf(-f.y, p.x, fmaf(-f.x, p.y, b.y)));
}

__device__ __forceinline__ float2 cmadd(float2 acc, float2 x, float2 t) {
  return make_float2(fmaf(-x.y, t.y, fmaf(x.x, t.x, acc.x)),
                     fmaf(x.y, t.x, fmaf(x.x, t.y, acc.y)));
}

template <int MP, bool POLISH>
struct GjLayout {
  // blocks an SM that the register budget must allow: 64 registers a
  // thread for one live column of up to 16 entries, 128 at 32 or with the
  // polish's second column, 255 for both at 32
  static constexpr int kMinBlocks = MP == 32 ? (POLISH ? 2 : 4)
                                             : (POLISH && MP == 16 ? 4 : 8);
  static constexpr int kGroups = 32 / MP;        // matrices a warp tile
  static constexpr int kTile = 32 * MP;          // kGroups * MP * MP slots
  static constexpr int kStages = POLISH ? 2 : 1;
  // the factor buffers, two by step parity, each group's MP + 2 apart so
  // that a warp's 16-byte broadcasts fall in distinct banks
  static constexpr int kFbStride = MP + 2;
  static constexpr int kFb = 2 * kGroups * kFbStride;
  static constexpr int kWarp = kStages * kTile + kFb;   // float2 a warp
  static constexpr size_t kSmem = sizeof(float2) * kWarp * kGjWarps;
};

// The warp's tile ``t`` (matrices t G .. t G + G - 1) into ``dst`` by
// cp.async, each matrix at g MP^2 with rows MP apart: lane (g, j) copies
// column j of matrix g (a warp's copy is row r of its G matrices) and
// nothing past M or B. One commit group (empty past the last tile).
template <int MP>
__device__ __forceinline__ void stage_tile(const float2* __restrict__ a,
                                           float2* dst, long long t,
                                           long long tiles, int B, int M,
                                           int g, int j) {
  constexpr int G = 32 / MP;
  if (t < tiles && t * G + g < B && j < M) {
    const float2* src = a + (t * G + g) * M * M + j;
    float2* d = dst + g * MP * MP + j;
#pragma unroll
    for (int r = 0; r < MP; ++r, src += M)
      if (r < M) cp_async8(d + r * MP, src);
  }
  cp_async_commit();
}

// One Gauss-Jordan step on the lane's live column. ``fb`` is the group's
// factor buffer for this step's parity.
template <int MP>
__device__ __forceinline__ void gj_step(float2 (&col)[MP], float2* fb, int j,
                                        int i) {
  const bool me = j == i;
  if (me) {
#pragma unroll
    for (int r = 0; r < MP; r += 2)
      *reinterpret_cast<float4*>(fb + r) =
          make_float4(col[r].x, col[r].y, col[r + 1].x, col[r + 1].y);
  }
  __syncwarp();
  const float2 piv = fb[i];
  const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
  // the lane's entry of the pivot row divided by the pivot; lane i's is
  // that of the inverse's column i, a unit before this step
  const float ax = sel(me, 1.f, col[i].x), ay = sel(me, 0.f, col[i].y);
  const float2 p = make_float2((ax * piv.x + ay * piv.y) * inv_den,
                               (ay * piv.x - ax * piv.y) * inv_den);
#pragma unroll
  for (int r = 0; r < MP; r += 2) {
    const float4 f2 = *reinterpret_cast<const float4*>(fb + r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + h;
      if (rr == i) continue;
      const float2 f = h ? make_float2(f2.z, f2.w) : make_float2(f2.x, f2.y);
      // lane i's column starts from the inverse's column i: zero here
      col[rr] = cmsub(make_float2(sel(me, 0.f, col[rr].x),
                                  sel(me, 0.f, col[rr].y)), f, p);
    }
  }
  col[i] = p;
}

// X <- X (2I - A X) on the lane's column of X, with A staged in ``cur``
// (the group's matrix at g MP^2, row r at r MP) and ``cur`` then reused for
// X's columns (column k at g MP^2 + k MP). The sums run over k in
// ascending order, as the Pallas kernel's.
template <int MP>
__device__ __forceinline__ void gj_polish(float2 (&col)[MP], float2* cur,
                                          int g, int j, int M) {
  float2* mg = cur + g * MP * MP;
  float2 t[MP];
  // T = 2I - A X, column j: row r is 2 [r = j] - sum over k of A[r][k]
  // X[k][j], two entries of A's row a 16-byte broadcast
#pragma unroll
  for (int r = 0; r < MP; ++r) {
    float2 acc = make_float2(r == j ? 2.f : 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MP; k += 2) {
      if (k >= M) break;
      const float4 a2 = *reinterpret_cast<const float4*>(mg + r * MP + k);
      acc = cmsub(acc, make_float2(a2.x, a2.y), col[k]);
      if (k + 1 < M) acc = cmsub(acc, make_float2(a2.z, a2.w), col[k + 1]);
    }
    t[r] = acc;
  }
  __syncwarp();                                   // every lane is past A
#pragma unroll
  for (int r = 0; r < MP; r += 2)
    *reinterpret_cast<float4*>(mg + j * MP + r) =
        make_float4(col[r].x, col[r].y, col[r + 1].x, col[r + 1].y);
  __syncwarp();
  // X T, column j: sum over k of X[:, k] T[k][j]
#pragma unroll
  for (int r = 0; r < MP; ++r) col[r] = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    if (k >= M) break;
    const float2 tk = t[k];
#pragma unroll
    for (int r = 0; r < MP; r += 2) {
      const float4 x2 = *reinterpret_cast<const float4*>(mg + k * MP + r);
      col[r] = cmadd(col[r], make_float2(x2.x, x2.y), tk);
      col[r + 1] = cmadd(col[r + 1], make_float2(x2.z, x2.w), tk);
    }
  }
}

template <int MP, bool POLISH>
__global__ void __launch_bounds__(kGjWarps * 32,
                                  GjLayout<MP, POLISH>::kMinBlocks)
    gj_inverse_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                      int B, int M) {
  using L = GjLayout<MP, POLISH>;
  constexpr int G = L::kGroups;
  extern __shared__ float4 gj_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* stage = reinterpret_cast<float2*>(gj_smem) + warp * L::kWarp;
  const int j = lane % MP, g = lane / MP;
  float2* fb = stage + L::kStages * L::kTile + g * L::kFbStride;
  const long long tiles = ((long long)B + G - 1) / G;
  const long long stride = (long long)gridDim.x * kGjWarps;
  long long t = (long long)blockIdx.x * kGjWarps + warp;

  stage_tile<MP>(a, stage, t, tiles, B, M, g, j);
  int s = 0;
  for (; t < tiles; t += stride) {
    cp_async_wait_all();
    __syncwarp();
    float2* cur = stage + s * L::kTile;
    // entries past M (and matrices past B) are stale words of the buffer:
    // no step reads them into a stored entry
    float2 col[MP];
#pragma unroll
    for (int r = 0; r < MP; ++r) col[r] = cur[g * MP * MP + r * MP + j];
    __syncwarp();                   // every lane has read its column
    const int sn = L::kStages == 2 ? s ^ 1 : 0;
    stage_tile<MP>(a, stage + sn * L::kTile, t + stride, tiles, B, M, g, j);

#pragma unroll
    for (int i = 0; i < MP; ++i)
      if (i < M) gj_step<MP>(col, fb + (i & 1) * G * L::kFbStride, j, i);
    if constexpr (POLISH) gj_polish<MP>(col, cur, g, j, M);

    const long long b = t * G + g;
    if (b < B && j < M) {
      float2* o = out + b * M * M + j;
#pragma unroll
      for (int r = 0; r < MP; ++r, o += M)
        if (r < M) *o = col[r];
    }
    s = sn;
  }
  cp_async_wait_all();
}

// blocks of the persistent grid: as many as the card holds resident, no
// more than the tiles need (the occupancy is read once per device)
template <int MP, bool POLISH>
cudaError_t launch_tiles(const float2* a, float2* out, int B, int M,
                         cudaStream_t st) {
  using L = GjLayout<MP, POLISH>;
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    if (L::kSmem > 48 * 1024) {
      e = cudaFuncSetAttribute(gj_inverse_kernel<MP, POLISH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kSmem);
      if (e != cudaSuccess) return e;
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gj_inverse_kernel<MP, POLISH>, kGjWarps * 32, L::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long tiles = ((long long)B + L::kGroups - 1) / L::kGroups;
  const long long need = (tiles + kGjWarps - 1) / kGjWarps;
  const int blocks = (int)(need < resident[dev] ? need : resident[dev]);
  gj_inverse_kernel<MP, POLISH><<<blocks, kGjWarps * 32, L::kSmem, st>>>(
      a, out, B, M);
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_gj(const float2* a, float2* out, int B, int M, int polish,
                      cudaStream_t st) {
  return polish ? launch_tiles<MP, true>(a, out, B, M, st)
                : launch_tiles<MP, false>(a, out, B, M, st);
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
