"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

The sources in ``beamform_tpu_torch/csrc/*.cu`` have a plain C interface, so
one ``nvcc -shared`` call builds them in seconds (no PyTorch headers). The
library lands in ``beamform_tpu_torch/kernels/build/`` under a name keyed by
a hash of the sources and flags; it is written under a temporary name and
renamed atomically, so parallel processes never load a half-written file.

Nothing here runs at import: the first CUDA tensor that reaches a kernel
wrapper triggers the build. Machines without ``nvcc`` never get that far,
because kernel wrappers take their plain-torch path for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "beamform_tpu_torch are built from source at first use")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile (if needed) and load the kernel library, once per process.
    Returns ``{"lib": CDLL, "path": str, "seconds": float, "log": str}``;
    ``log`` is nvcc's ``-Xptxas -v`` report (empty when the library was
    already built)."""
    sources = _sources()
    path = os.path.join(BUILD_DIR, f"libbeamform_kernels_{_key(sources)}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return {"lib": lib, "path": path, "log": log,
            "seconds": time.perf_counter() - t0}


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bf_error_string.argtypes = [i]
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_wola_analysis.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.bf_wola_analysis.restype = i
    lib.bf_wola_synthesis.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.bf_wola_synthesis.restype = i


def check(lib, code: int, what: str):
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.bf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
