// A branch-free float32 atan2 for Hopper (sm_90a), without CUDA's math
// library: the phase-mask front end's (phase_mask.cu), held to float64
// atan2 over a sweep of inputs by tools/h100_probe/fastpath_check.py.

#pragma once

#include <cuda_runtime.h>

namespace bf_math {

// atan2(y, x) without CUDA's math library (beamform_tpu/kernels/
// phase_mask.py atan2f): t = lo / hi of |x|, |y| folded onto
// (lo - hi) / (lo + hi) above tan(pi / 8) (the test's sign exact, by one
// FMA), Cephes' odd polynomial of degree 9 there, then the octant, x's sign
// and y's sign as selects, with IEEE's signed zeros (atan2(+-0, -0) =
// +-pi). The one division is the reciprocal's fast path (MUFU.RCP) times
// the numerator; where the denominator lies outside [2^-125, 2^126) (0,
// subnormal, huge: never on a spectrum's scale, so the branch is not taken)
// it is an exact division of lo and hi scaled by 2^+-64.
__device__ __forceinline__ float atan2_fast(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const bool fold = fmaf(-0.414213562373095049f, hi, lo) > 0.f;
  const float den = fold ? lo + hi : hi;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(den));
  float z = (fold ? lo - hi : lo) * r;
  if ((__float_as_uint(den) >> 23) - 2u > 250u) {
    const float sc = hi > 1.f ? 5.42101086e-20f : 1.84467441e19f;  // 2^-+64
    const float l = lo * sc, h = hi * sc;
    z = fold ? __fdiv_rn(l - h, l + h)
             : __fdiv_rn(l, fmaxf(h, __int_as_float(1)));     // 0 / 0 -> 0
  }
  const float s = z * z;
  const float q = ((8.05374449538e-2f * s - 1.38776856032e-1f) * s +
                   1.99777106478e-1f) * s - 3.33329491539e-1f;
  const float p = fmaf(q * s, z, z);
  float a = fold ? 0.785398163397448310f + p : p;
  a = ay > ax ? 1.57079632679489662f - a : a;
  a = signbit(x) ? 3.14159265358979323846f - a : a;
  return copysignf(a, y);
}

}  // namespace bf_math
