"""Batched small-matrix inverse: the CUDA Gauss-Jordan kernel's wrapper and
its plain-torch version.

Counterpart of ``beamform_tpu/kernels/linalg.py``: :func:`gauss_jordan_inv`
is the same unpivoted Gauss-Jordan arithmetic as the JAX function of that
name, and :func:`gj_inverse` replaces ``_gj_kernel`` (reached through
``gj_inverse_pallas`` / ``gj_inverse_pallas_native``). The kernel is in
``csrc/linalg.cu``.

The MVDR/LCMV covariances are Hermitian positive definite after the
reference's 1.001 diagonal loading (mvdr.cpp:87), so elimination without
pivoting is safe. Singular inputs (cold-start covariances) give inf/NaN,
like the reference's Eigen ``.inverse()`` garbage.

Layout: batch first, ``(B, M, M)`` complex64 (the contract of the JAX
package's ``gj_inverse_pallas``); the JAX package's batch-last native
layout is not offered. Routing: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. ``gj_inverse.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.utils.profiling import span

#: the kernel holds one matrix in a group of at most 32 lanes (one warp)
MAX_M = 32


def gauss_jordan_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by unpivoted Gauss-Jordan: a (..., M, M) real or
    complex, Hermitian positive definite or diagonally dominant."""
    m = a.shape[-1]
    mat = a.clone()
    inv = torch.eye(m, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for i in range(m):
        piv = mat[..., i:i + 1, i:i + 1]
        prow = mat[..., i:i + 1, :] / piv
        pirow = inv[..., i:i + 1, :] / piv
        factor = mat[..., :, i:i + 1].clone()
        factor[..., i, :] = 0
        mat = mat - factor * prow
        inv = inv - factor * pirow
        mat[..., i:i + 1, :] = prow
        inv[..., i:i + 1, :] = pirow
    return inv


def gj_inverse_plain(a: torch.Tensor, polish: bool = True) -> torch.Tensor:
    """The kernel's plain version: :func:`gauss_jordan_inv`, then the
    optional Newton-Schulz step X <- X (2I - A X)."""
    inv = gauss_jordan_inv(a)
    if not polish:
        return inv
    eye2 = 2.0 * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return inv @ (eye2 - a @ inv)


def gj_inverse(a: torch.Tensor, polish: bool = True) -> torch.Tensor:
    """Batched complex inverse, (B, M, M) -> (B, M, M).

    On CUDA: complex64, contiguous, M <= 32, launched as the hand-written
    kernel; ``polish`` runs the Newton-Schulz step inside it. Callers that
    apply the inverse to a right-hand side pass ``polish=False`` and refine
    there (x = X b; x += X (b - A x)), the same value at M^2 instead of
    2 M^3 cost.
    """
    if not a.is_cuda:
        return gj_inverse_plain(a, polish)
    with span("bf.kernel.gj_inverse"):
        if a.dim() != 3 or a.shape[1] != a.shape[2]:
            raise ValueError(f"a must be (B, M, M), got {tuple(a.shape)}")
        b, m, _ = a.shape
        if not 1 <= m <= MAX_M:
            raise ValueError(f"the CUDA Gauss-Jordan kernel takes M <= "
                             f"{MAX_M}, got {m}")
        check_tensor(a, "a", torch.complex64, (b, m, m), a.device)
        out = torch.empty_like(a)
        if b == 0:
            return out
        with device_guard(a.device):
            lib, stream = launch_context(a.device)
            code = lib.bf_gj_inverse(a.data_ptr(), out.data_ptr(), b, m,
                                     int(polish), stream)
        check(lib, code, "gj_inverse")
    gj_inverse.launches += 1
    return out


gj_inverse.launches = 0
