#!/usr/bin/env python3
"""Kernel times of the Gauss-Jordan inverse, ``csrc/linalg.cu``, and of
variants of it with one part changed, on one NVIDIA GPU.

    python3 tools/h100_probe/gj_variants.py stamp|time [--sass]

Each variant is built on its own with ``nvcc -Xptxas -v`` (registers and
spills printed), all builds side by side, into ``tools/h100_probe/build/``,
and launched through its C entry with ctypes on seeded operands at the
dense MVDR block's shape: 55,596 matrices of 16 x 16, complex64, rank-10
Hermitian covariances loaded by 1e-3 of their mean diagonal. Times are the
profiler's kernel time, the mean of 20 launches, with CUDA events over 50
back-to-back launches beside it.

``stamp``: the two-matrix kernel that ``csrc/linalg.cu`` replaced
(``gj_parent_variants.cu``): as it was, unpolished and polished; loads and
stores only; the inverse's half of the update removed; the shuffles
replaced by a shared-memory broadcast; with its blocks an SM. Then the
current kernel's blocks an SM at every lane count, and the current kernel
and its variants against the plain version (``kernels.linalg
.gj_inverse_plain``) at M 1-32, B 1-4,099, both polish values, with the
NaN positions of a zero block and of a block with a zero row and column.

``time``: the current kernel (``new``), and its variants, each a text
patch of the current source: ``paren``, each complex update in the Pallas
kernel's unfused form; ``shfl``, the factor column by warp shuffles;
``nosel``, no per-lane select of the pivot lane's zero column (wrong
values, for its cost); ``nosts``, no store of the factor column (wrong);
``noelim``, loads and stores only; ``eye``, the pivot lane loading e_i
from a shared identity in place of the selects; ``two``, two live
columns a lane (``gj_two_columns.cu``, unpolished). Also the old kernel
in the same process, ``torch.linalg.inv``, and the current kernel at M =
1, 3, 8 and 32. ``--sass`` prints each kernel's instruction counts by
opcode (cuobjdump). Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
from beamform_tpu_torch.kernels.linalg import gj_inverse_plain  # noqa: E402

BUILD = os.path.join(HERE, "build")
CUDA_BIN = "/usr/local/cuda/bin"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared"]
B, M = 55596, 16

# appended to each variant of csrc/linalg.cu: blocks an SM by instantiation
OCCUPANCY = r'''
extern "C" int probe_occupancy(int mp, int polish) {
  int n = 0;
#define Q(P, PO) if (mp == P && polish == PO) { \
    size_t s = GjLayout<P, PO>::kSmem; \
    if (s > 48 * 1024) cudaFuncSetAttribute(gj_inverse_kernel<P, PO>, \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s); \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        &n, gj_inverse_kernel<P, PO>, kGjWarps * 32, s); }
  Q(4, false) Q(4, true) Q(8, false) Q(8, true) Q(16, false) Q(16, true)
  Q(32, false) Q(32, true)
  return n;
}
'''

STEP_HEAD = "template <int MP>\n__device__ __forceinline__ void gj_step("
STEP_TAIL = "// X <- X (2I - A X) on the lane's column of X"

SHFL_STEP = r'''template <int MP>
__device__ __forceinline__ void gj_step(float2 (&col)[MP], float2* fb, int j,
                                        int i) {
  const float2 piv = make_float2(__shfl_sync(0xffffffffu, col[i].x, i, MP),
                                 __shfl_sync(0xffffffffu, col[i].y, i, MP));
  const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
  const bool me = j == i;
  const float ax = sel(me, 1.f, col[i].x), ay = sel(me, 0.f, col[i].y);
  const float2 p = make_float2((ax * piv.x + ay * piv.y) * inv_den,
                               (ay * piv.x - ax * piv.y) * inv_den);
#pragma unroll
  for (int rr = 0; rr < MP; ++rr) {
    if (rr == i) continue;
    const float2 f = make_float2(__shfl_sync(0xffffffffu, col[rr].x, i, MP),
                                 __shfl_sync(0xffffffffu, col[rr].y, i, MP));
    col[rr] = cmsub(make_float2(sel(me, 0.f, col[rr].x),
                                sel(me, 0.f, col[rr].y)), f, p);
  }
  col[i] = p;
}

'''

EYE_STEP = r'''template <int MP>
__device__ __forceinline__ void gj_step(float2 (&col)[MP], float2* fb,
                                        const float2* ei, int j, int i) {
  if (j == i) {
#pragma unroll
    for (int r = 0; r < MP; r += 2) {
      *reinterpret_cast<float4*>(fb + r) =
          make_float4(col[r].x, col[r].y, col[r + 1].x, col[r + 1].y);
      const float4 e = *reinterpret_cast<const float4*>(ei + r);
      col[r] = make_float2(e.x, e.y);
      col[r + 1] = make_float2(e.z, e.w);
    }
  }
  __syncwarp();
  const float2 piv = fb[i];
  const float inv_den = 1.f / (piv.x * piv.x + piv.y * piv.y);
  const float2 a = col[i];
  const float2 p = make_float2((a.x * piv.x + a.y * piv.y) * inv_den,
                               (a.y * piv.x - a.x * piv.y) * inv_den);
#pragma unroll
  for (int r = 0; r < MP; r += 2) {
    const float4 f2 = *reinterpret_cast<const float4*>(fb + r);
    if (r != i) col[r] = cmsub(col[r], make_float2(f2.x, f2.y), p);
    if (r + 1 != i) col[r + 1] = cmsub(col[r + 1], make_float2(f2.z, f2.w), p);
  }
  col[i] = p;
}

'''

# (old, new) text patches of csrc/linalg.cu, by variant
PATCHES = {
    "paren": (("""  return make_float2(fmaf(f.y, p.y, fmaf(-f.x, p.x, b.x)),
                     fmaf(-f.y, p.x, fmaf(-f.x, p.y, b.y)));""",
               """  return make_float2(b.x - (f.x * p.x - f.y * p.y),
                     b.y - (f.x * p.y + f.y * p.x));"""),
              ("""  return make_float2(fmaf(-x.y, t.y, fmaf(x.x, t.x, acc.x)),
                     fmaf(x.y, t.x, fmaf(x.x, t.y, acc.y)));""",
               """  return make_float2(acc.x + (x.x * t.x - x.y * t.y),
                     acc.y + (x.x * t.y + x.y * t.x));""")),
    "nosel": (("""      col[rr] = cmsub(make_float2(sel(me, 0.f, col[rr].x),
                                  sel(me, 0.f, col[rr].y)), f, p);""",
               "      col[rr] = cmsub(col[rr], f, p);"),),
    "nosts": (("""  if (me) {
#pragma unroll
    for (int r = 0; r < MP; r += 2)
      *reinterpret_cast<float4*>(fb + r) =
          make_float4(col[r].x, col[r].y, col[r + 1].x, col[r + 1].y);
  }
""", ""),),
    "noelim": (("""#pragma unroll
    for (int i = 0; i < MP; ++i)
      if (i < M) gj_step<MP>(col, fb + (i & 1) * G * L::kFbStride, j, i);""",
                "    (void)fb;"),),
    # the identity after the warps' buffers, filled before the first tile
    "eye": (("static constexpr size_t kSmem = sizeof(float2) * kWarp * kGjWarps;",
             "static constexpr size_t kSmem =\n"
             "      sizeof(float2) * (kWarp * kGjWarps + MP * MP);"),
            ("""  float2* fb = stage + L::kStages * L::kTile + g * L::kFbStride;""",
             """  float2* fb = stage + L::kStages * L::kTile + g * L::kFbStride;
  float2* eye = reinterpret_cast<float2*>(gj_smem) + kGjWarps * L::kWarp;
  for (int e = threadIdx.x; e < MP * MP; e += kGjWarps * 32)
    eye[e] = make_float2(e % (MP + 1) == 0 ? 1.f : 0.f, 0.f);
  __syncthreads();"""),
            ("      if (i < M) gj_step<MP>(col, fb + (i & 1) * G * L::kFbStride, j, i);",
             "      if (i < M)\n        gj_step<MP>(col, fb + (i & 1) * G * "
             "L::kFbStride, eye + i * MP,\n                    j, i);")),
}
STEPS = {"shfl": SHFL_STEP, "eye": EYE_STEP}
VARIANTS = ("new", "paren", "shfl", "nosel", "nosts", "noelim", "eye")


def sources() -> dict:
    """{name: .cu path}: each variant of csrc/linalg.cu with the occupancy
    entry appended, the old kernel's variants and the two-column kernel."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(ROOT, "beamform_tpu_torch", "csrc",
                           "linalg.cu")) as f:
        text = f.read()
    out = {}
    for name in VARIANTS:
        t = text
        for old, new in PATCHES.get(name, ()):
            assert old in t, (name, old)
            t = t.replace(old, new)
        if name in STEPS:
            a = t.index(STEP_HEAD)
            t = t[:a] + STEPS[name] + t[t.index(STEP_TAIL, a):]
        path = os.path.join(BUILD, f"gj_{name}.cu")
        with open(path, "w") as f:
            f.write(t + OCCUPANCY)
        out[name] = path
    out["old"] = os.path.join(HERE, "gj_parent_variants.cu")
    out["two"] = os.path.join(HERE, "gj_two_columns.cu")
    return out


def build() -> dict:
    """Every variant's library, built side by side; prints ptxas's
    registers and spills."""
    t0 = time.perf_counter()
    procs = {}
    for name, src in sources().items():
        so = os.path.join(BUILD, f"libgj_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [os.path.join(CUDA_BIN, "nvcc"), *FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        entry = ""
        for line in out.splitlines():
            if "Compiling entry" in line:
                entry = re.sub(r".*kernelIL", "", line.split("'")[1])[:14]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.split(':')[-1].strip()}")
        if proc.returncode != 0:
            print(out[-3000:])
            raise SystemExit(f"nvcc {name} failed")
        libs[name] = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs["old"].probe_gj.argtypes = [i, vp, vp, i, i, i, vp]
    libs["old"].probe_occupancy.argtypes = [i]
    libs["two"].probe_k2.argtypes = [vp, vp, i, i, vp]
    for name in VARIANTS:
        libs[name].bf_gj_inverse.argtypes = [vp, vp, i, i, i, vp]
        libs[name].probe_occupancy.argtypes = [i, i]
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def sass_stats():
    """Instruction counts by opcode of each variant's kernels."""
    keys = ("FFMA", "FMUL", "FADD", "FSEL", "LDS", "STS", "SHFL", "WARPSYNC",
            "LDGSTS", "STG", "BRA", "MUFU")
    for name in ("old", "two") + VARIANTS:
        out = subprocess.run([os.path.join(CUDA_BIN, "cuobjdump"), "-sass",
                              os.path.join(BUILD, f"libgj_{name}.so")],
                             capture_output=True, text=True).stdout
        for part in out.split("Function : ")[1:]:
            fn = re.sub(r".*kernelIL", "", part.split("\n", 1)[0])[:14]
            ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", part)
            cnt = {k: ops.count(k) for k in keys}
            print(f"sass {name} {fn}: {len(ops)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in cnt.items() if v))


def operands(b: int, m: int, seed: int, rank=None) -> torch.Tensor:
    """Seeded complex64 Hermitian matrices on the card: rank ``rank``
    covariances loaded by 1e-3 of their mean diagonal, or, without a
    rank, x x^H / m + 0.5 I."""
    rng = np.random.default_rng(seed)
    k = rank or m
    x = (rng.standard_normal((b, m, k))
         + 1j * rng.standard_normal((b, m, k))).astype(np.complex64)
    a = x @ np.conj(np.swapaxes(x, 1, 2)) / k
    if rank is None:
        a = a + 0.5 * np.eye(m, dtype=np.complex64)
    else:
        a = a + 1e-3 * np.eye(m, dtype=np.complex64) * np.trace(
            a, axis1=1, axis2=2).real[:, None, None] / m
    return torch.as_tensor(a.astype(np.complex64)).cuda().contiguous()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def events_ms(fn, n: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def prof_ms(fn, key: str = "_kernel", n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tot = sum(getattr(e, "device_time_total", 0.0)
              for e in prof.key_averages() if key in e.key)
    return tot / 1e3 / n


def run(lib, a: torch.Tensor, polish: bool) -> torch.Tensor:
    out = torch.empty_like(a)
    code = lib.bf_gj_inverse(a.data_ptr(), out.data_ptr(), a.shape[0],
                             a.shape[1], int(polish), stream())
    assert code == 0, code
    return out


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def check(libs):
    """The current kernel and its value-keeping variants against plain."""
    for name in ("new", "paren", "shfl", "eye"):
        worst = 0.0
        for m in (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32):
            for b in (1, 37, 1000, 4099):
                a = operands(b, m, m * 7 + b)
                for polish in (False, True):
                    got = run(libs[name], a, polish)
                    ref = gj_inverse_plain(a, polish)
                    worst = max(worst, rel(got, ref))
        print(f"check {name}: worst rel vs plain {worst:.3e}")
        for m in (3, 16, 32):
            a = operands(64, m, 11)
            a[:16] = 0
            a[16:32, m // 2, :] = 0
            a[16:32, :, m // 2] = 0
            for polish in (False, True):
                got = run(libs[name], a, polish)
                ref = gj_inverse_plain(a, polish)
                print(f"check {name} M={m} polish={polish}: NaN positions "
                      f"equal {torch.equal(got.isnan(), ref.isnan())}")
    a = operands(1001, M, 7)
    out = torch.empty_like(a)
    assert libs["two"].probe_k2(a.data_ptr(), out.data_ptr(), 1001, M,
                                stream()) == 0
    print(f"check two: rel vs plain {rel(out, gj_inverse_plain(a, False)):.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("stamp", "time"))
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    libs = build()
    if args.sass:
        sass_stats()
    a = operands(B, M, 3, rank=10)
    out = torch.empty_like(a)
    st = stream()
    old = libs["old"]
    if args.mode == "stamp":
        for v, label in ((0, "as it was"), (1, "loads and stores only"),
                         (2, "the inverse's update removed"),
                         (3, "shared-memory broadcast")):
            for polish in ((0, 1) if v == 0 else (0,)):
                fn = lambda: old.probe_gj(v, a.data_ptr(), out.data_ptr(),
                                          B, M, polish, st)
                print(f"old V{v} ({label}) polish={polish}: blocks/SM "
                      f"{old.probe_occupancy(v)}, profiler {prof_ms(fn):.4f}"
                      f" ms, events {events_ms(fn):.4f} ms", flush=True)
        for mp in (4, 8, 16, 32):
            print(f"new MP={mp}: blocks/SM {libs['new'].probe_occupancy(mp, 0)}"
                  f" unpolished, {libs['new'].probe_occupancy(mp, 1)} "
                  "polished")
        check(libs)
        return 0
    for rep in range(2):
        for polish in (0, 1):
            fn = lambda: old.probe_gj(0, a.data_ptr(), out.data_ptr(), B, M,
                                      polish, st)
            print(f"old polish={polish}: profiler {prof_ms(fn):.4f} ms, "
                  f"events {events_ms(fn):.4f} ms", flush=True)
            for name in VARIANTS:
                lib = libs[name]
                fn = lambda: lib.bf_gj_inverse(a.data_ptr(), out.data_ptr(),
                                               B, M, polish, st)
                print(f"{name} polish={polish}: profiler {prof_ms(fn):.4f} "
                      f"ms, events {events_ms(fn):.4f} ms", flush=True)
        fn = lambda: libs["two"].probe_k2(a.data_ptr(), out.data_ptr(), B, M,
                                          st)
        print(f"two polish=0: profiler {prof_ms(fn):.4f} ms, events "
              f"{events_ms(fn):.4f} ms", flush=True)
    for m, polish in ((1, 0), (1, 1), (3, 1), (8, 0), (32, 0), (32, 1)):
        am = operands(B, m, 5)
        om = torch.empty_like(am)
        fn = lambda: libs["new"].bf_gj_inverse(am.data_ptr(), om.data_ptr(),
                                               B, m, polish, st)
        print(f"new M={m} polish={polish}: profiler {prof_ms(fn):.4f} ms, "
              f"events {events_ms(fn):.4f} ms", flush=True)
    print(f"torch.linalg.inv: events "
          f"{events_ms(lambda: torch.linalg.inv(a)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
