"""Array geometry, steering delays, frequency vectors and steering weights.

Counterpart of ``beamform_tpu/geometry.py`` (util.h:136-199 and the
per-node ``update_weights`` loops, e.g. das.cpp:27-45). Weights are a pure
function of ``(geometry, angle, freqs)``, batched over a theta timeline.

All angles are in degrees, as in the reference (0 = front, -90 = left,
90 = right, 180 = back; README.md:21).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from beamform_tpu_torch.config import ArrayConfig

V_SOUND = 343.0  # m/s (util.h:25)


@dataclass(frozen=True)
class ArrayGeometry:
    """Polar coordinates per mic, computed from the YAML coordinates
    before mic0 re-referencing (util.h:83-84)."""

    dist: np.ndarray       # (M,) float64
    angle_deg: np.ndarray  # (M,) float64

    @property
    def num_mics(self) -> int:
        return int(self.dist.shape[0])

    @staticmethod
    def from_config(cfg: ArrayConfig) -> "ArrayGeometry":
        return ArrayGeometry(
            dist=np.array([m.dist for m in cfg.mics], dtype=np.float64),
            angle_deg=np.array([m.angle_deg for m in cfg.mics],
                               dtype=np.float64),
        )

    @staticmethod
    def from_xy(xy: Sequence) -> "ArrayGeometry":
        xy = np.asarray(xy, dtype=np.float64)
        return ArrayGeometry(
            dist=np.hypot(xy[:, 0], xy[:, 1]),
            angle_deg=np.degrees(np.arctan2(xy[:, 1], xy[:, 0])),
        )


def wrap_angle_deg(a: torch.Tensor) -> torch.Tensor:
    """Single-branch wrap to (-180, 180], as util.h:151-155 does it: one
    conditional +-360, not a modulo."""
    a = torch.where(a > 180.0, a - 360.0, a)
    return torch.where(a < -180.0, a + 360.0, a)


def steering_delays(geom: ArrayGeometry, angle_deg, *,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """Far-field steering delays tau_m in seconds (util.h:136-161).

    tau_0 = 0 (mic0 is the reference); tau_m = d_m cos(phi_m - theta)/(-c).
    ``angle_deg``: scalar or any batch; output ``angle.shape + (M,)``.
    """
    angle = torch.as_tensor(angle_deg, dtype=dtype, device=device)
    dist = torch.as_tensor(geom.dist, dtype=dtype, device=angle.device)
    mic_ang = torch.as_tensor(geom.angle_deg, dtype=dtype,
                              device=angle.device)
    rel = wrap_angle_deg(mic_ang - angle[..., None])
    tau = dist * torch.cos(torch.deg2rad(rel)) / (-V_SOUND)
    tau[..., 0] = 0.0  # util.h:144-147
    return tau


def frequency_vector(nfft: int, sample_rate: float, *, exact: bool = False,
                     dtype=np.float64) -> np.ndarray:
    """Full-length frequency vector, util.h:190-199, with the reference's
    off-by-one: ``f[N/2-1]`` is overwritten to fs/2 (util.h:198) and
    ``f[N/2]`` is never written (reads 0.0 on a fresh page). ``exact=True``
    gives the standard DFT layout with ``f[N/2] = fs/2``."""
    n = int(nfft)
    f = np.zeros(n, dtype=dtype)
    k = np.arange(1, n // 2, dtype=dtype)          # 1 .. N/2-1
    f[1:n // 2] = k / n * sample_rate
    f[n // 2 + 1:] = -f[1:n // 2][::-1]
    if exact:
        f[n // 2] = sample_rate / 2.0
    else:
        f[n // 2 - 1] = sample_rate / 2.0          # util.h:198 overwrite
        f[n // 2] = 0.0                            # never initialised
    return f


def steering_weights(freqs: torch.Tensor, delays: torch.Tensor, *,
                     row0_scale=1.0) -> torch.Tensor:
    """w[m, k] = exp(-i 2 pi f_k tau_m), row 0 the constant ``row0_scale``
    (das.cpp:27-45). ``delays (..., M)`` -> weights ``(..., M, K)`` in the
    complex dtype matching ``delays``; built from cos/sin, like the JAX
    package, so both evaluate the same real arithmetic.

    ``row0_scale`` is a scalar, or a tensor of the delays' leading shape
    ``(...)`` (broadcastable to it): one mic-0 scale per steering, held
    over all bins (the LCMV constraint build gives each control row its
    own, lcmv.cpp:50-56)."""
    cdtype = (torch.complex128 if delays.dtype == torch.float64
              else torch.complex64)
    phase = -2.0 * math.pi * delays[..., :, None] * freqs[None, :]
    w = torch.complex(torch.cos(phase), torch.sin(phase)).to(cdtype)
    if torch.is_tensor(row0_scale) and row0_scale.dim():
        w[..., 0, :] = row0_scale.to(w)[..., None]
    else:
        w[..., 0, :] = row0_scale
    return w


def steering_matrix(freqs: torch.Tensor, doi_delays: torch.Tensor,
                    interf_delays: torch.Tensor, *, row0_scale=1.0,
                    active_mask=None) -> torch.Tensor:
    """Constraint/steering matrix A[k][m, s] for LCMV/GSS: column 0 the
    direction of interest, columns 1..K the interferences (lcmv.cpp:44-86).
    ``doi_delays (M,)``, ``interf_delays (S-1, M)`` -> ``(K_bins, M, S)``.
    ``active_mask (S,)`` zeroes inactive interference slots (the
    fixed-capacity masked-constraint design)."""
    all_delays = torch.cat([doi_delays[None, :], interf_delays], dim=0)
    a = steering_weights(freqs, all_delays,
                         row0_scale=row0_scale).permute(2, 1, 0)
    if active_mask is not None:
        a = a * torch.as_tensor(active_mask, device=a.device).to(a.dtype)
    return a


def steering_delays_np(geom: ArrayGeometry, angle_deg) -> np.ndarray:
    """Host-side (numpy, float64) :func:`steering_delays`."""
    angle_deg = np.asarray(angle_deg, dtype=np.float64)
    rel = geom.angle_deg - angle_deg[..., None]
    rel = np.where(rel > 180.0, rel - 360.0, rel)
    rel = np.where(rel < -180.0, rel + 360.0, rel)
    tau = geom.dist * np.cos(np.deg2rad(rel)) / (-V_SOUND)
    tau[..., 0] = 0.0
    return tau


def steering_weights_np(freqs, delays, *, row0_scale=1.0) -> np.ndarray:
    """Host-side (numpy, complex128) :func:`steering_weights`."""
    freqs = np.asarray(freqs, dtype=np.float64)
    delays = np.asarray(delays, dtype=np.float64)
    phase = -2.0 * np.pi * delays[..., :, None] * freqs[None, :]
    w = np.cos(phase) + 1j * np.sin(phase)
    w[..., 0, :] = row0_scale
    return w
