"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

The sources in ``beamform_tpu_torch/csrc/*.cu`` have a plain C interface, so
they build in seconds (no PyTorch headers): one ``nvcc -c`` per source, all
started together, then one link into a shared library, so the build takes
about as long as its slowest source (13.3 s for the three sources of the
MVDR slice on an 8-core H100 host, against 22 s for one ``nvcc`` of all
three). The library lands in ``beamform_tpu_torch/kernels/build/`` under a
name keyed by a hash of the flags, the sources and their shared headers
(``csrc/*.cuh``); it is written under a temporary name and renamed
atomically, so parallel processes never load a half-written file.

Nothing here runs at import: the first CUDA tensor that reaches a kernel
wrapper triggers the build. Machines without ``nvcc`` never get that far,
because kernel wrappers take their plain-torch path for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _key(csrc: str = CSRC) -> str:
    """Hash of the flags, the sources and the headers they include: a
    header edit must not load a library built from the old header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))
                       + glob.glob(os.path.join(csrc, "*.cuh"))):
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
    path = os.path.join(BUILD_DIR, f"libbeamform_kernels_{_key()}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = find_nvcc()
        tag = f"{os.getpid()}"
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
                for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in zip(sources, procs)]
        log = "".join(out for _, out, _ in outs)
        failed = [f"{os.path.basename(src)} ({rc})"
                  for src, _, rc in outs if rc != 0]
        if not failed:
            tmp = f"{path}.tmp{tag}"
            proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode})")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return {"lib": lib, "path": path, "log": log,
            "seconds": time.perf_counter() - t0}


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bf_error_string.argtypes = [i]
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_wola_analysis.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.bf_wola_analysis.restype = i
    lib.bf_wola_synthesis.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.bf_wola_synthesis.restype = i
    lib.bf_gj_inverse.argtypes = [p, p, i, i, i, p]
    lib.bf_gj_inverse.restype = i
    lib.bf_mvdr_stream.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.bf_mvdr_stream.restype = i
    lib.bf_lcmv_stream.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.bf_lcmv_stream.restype = i
    f = ctypes.c_float
    lib.bf_mega_stream.argtypes = [p] * 16 + [i] * 9 + [f, i, i, p]
    lib.bf_mega_stream.restype = i
    lib.bf_gss_stream.argtypes = [p] * 17 + [i] * 8 + [f, f, f, p]
    lib.bf_gss_stream.restype = i
    fp = ctypes.POINTER(ctypes.c_float)        # a host array of constants
    lib.bf_phase_mask.argtypes = [p] * 4 + [i] * 5 + [fp, p]
    lib.bf_phase_mask.restype = i
    lib.bf_mpf_march.argtypes = [p] * 11 + [i] * 5 + [fp, i, p]
    lib.bf_mpf_march.restype = i
    lib.bf_mcra_march.argtypes = [p] * 10 + [i] * 3 + [fp, i, p]
    lib.bf_mcra_march.restype = i
    lib.bf_march_resources.argtypes = [i, p]
    lib.bf_march_resources.restype = i
    lib.bf_gsc_sample.argtypes = [p] * 10 + [i] * 5 + [fp, p]
    lib.bf_gsc_sample.restype = i
    lib.bf_gsc_blocklms.argtypes = [p] * 8 + [i] * 8 + [fp, p]
    lib.bf_gsc_blocklms.restype = i
    lib.bf_gsc_block.argtypes = [p] * 11 + [i] * 4 + [fp, p]
    lib.bf_gsc_block.restype = i


def check(lib, code: int, what: str):
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.bf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous, and holding its values in memory
    (a lazily conjugated or negated view, ``is_conj()`` or ``is_neg()``,
    keeps the unconjugated values behind its data pointer)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the CUDA kernel "
                         f"takes {dtype}; float64 runs on the CPU only "
                         "(see ROADMAP.md §1)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{name} is a lazy conjugate or negative view; "
                         "pass t.resolve_conj().resolve_neg()")


def launch_context(device: torch.device):
    """(library, PyTorch's current stream on ``device`` as an int: the raw
    stream, without building a ``torch.cuda.Stream`` object a launch)."""
    return build()["lib"], torch._C._cuda_getCurrentRawStream(device.index)


def device_guard(device: torch.device):
    """The context every wrapper launches in: ``torch.cuda.device(device)``,
    or none where the CUDA tensor's ``device`` is already the current one,
    the usual case, so that a launch pays no device switch and switch
    back."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
