"""Plain PyTorch pieces of the reference, written from the reference
project's C++ (util.h's geometry and frequency vector, das.cpp's steering,
the WOLA of util.h:244-314) and independent of the program.

Every node of the reference runs the full complex FFT of each 2*hop
window, as the C++ does; with a real input, a frequency vector that is
mirror-symmetric over the band and a zero Nyquist output (f[N/2] reads 0,
out of band), the mirror bins carry the conjugates of bins 1..N/2-1, so
the real part of the inverse FFT equals the inverse real FFT of the half
spectrum. That is what is computed here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

V_SOUND = 343.0


class Precision:
    """The arithmetic a reference runs in. ``float64`` is the reference.
    ``tf32`` is the control: float32 storage, and the operands of every
    product of the beamformer's algebra (covariances, solves, weight and
    sum, the demixing products) rounded to TF32's 10-bit mantissa, as a
    tensor-core product takes them; FFTs stay float32."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.cplx = (torch.complex128 if name == "float64"
                     else torch.complex64)

    def op(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product sees it."""
        if self.name == "float64":
            return t
        if t.is_complex():
            return torch.view_as_complex(
                tf32_round(torch.view_as_real(t.resolve_conj().contiguous())))
        return tf32_round(t)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32``), kept in float32."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mic_polar(mics):
    """(dist, angle in degrees) of each mic from its coordinates as
    written, before any re-referencing (util.h:83-84)."""
    xy = np.array([[m["x"], m["y"]] for m in mics], dtype=np.float64)
    return (np.hypot(xy[:, 0], xy[:, 1]),
            np.degrees(np.arctan2(xy[:, 1], xy[:, 0])))


def array_mics(array: dict):
    """The ``mic0``, ``mic1``, ... entries of a configuration's array."""
    mics, i = [], 0
    while f"mic{i}" in array:
        mics.append(array[f"mic{i}"])
        i += 1
    return mics


def delays(dist, angle_deg, theta_deg) -> np.ndarray:
    """calculate_delays (util.h:136-161): tau_0 = 0, tau_i = d_i cos(phi_i
    - theta) / -c with one conditional +-360 wrap. theta (K,) -> (K, M)."""
    a = angle_deg[None, :] - np.asarray(theta_deg, np.float64)[:, None]
    a = np.where(a > 180.0, a - 360.0, a)
    a = np.where(a < -180.0, a + 360.0, a)
    tau = dist[None, :] * np.cos(np.radians(a)) / -V_SOUND
    tau[:, 0] = 0.0
    return tau


def half_freqs(nfft: int, fs: float) -> np.ndarray:
    """Bins 0..N/2 of calculate_frequency_vector (util.h:190-199), its
    quirks kept: f[N/2-1] overwritten to fs/2, f[N/2] never written (0)."""
    f = np.arange(nfft // 2 + 1, dtype=np.float64) * fs / nfft
    f[nfft // 2 - 1] = fs / 2.0
    f[nfft // 2] = 0.0
    return f


def band_bins(freqs: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """The bins j >= 1 with fmin <= |f_j| <= fmax (mvdr.cpp:84, gss.cpp's
    band test; bin 0 has f = 0)."""
    j = np.nonzero((np.abs(freqs) >= fmin) & (np.abs(freqs) <= fmax))[0]
    return j[j >= 1]


def steering(freqs_ib: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """exp(-i 2 pi f tau) over the band: tau (K, M) -> (K, M, NIB)
    complex128; mic 0 has tau 0, so its row is 1 (update_weights with
    ini = true, das.cpp:27-45)."""
    return np.exp(-2j * np.pi * tau[:, :, None] * freqs_ib[None, None, :])


def sqrt_hann(n: int, device) -> torch.Tensor:
    """The periodic sqrt-Hann window, float64."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return torch.sqrt(0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n))


def analysis(xx: torch.Tensor, hop: int, win: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    """xx (B, M, (F+1)*hop) -> the spectra of its F windows of 2*hop
    samples, a hop apart: (B, M, F, hop+1), bins 0..N/2 of the FFT."""
    frames = xx.to(prec.real).unfold(-1, 2 * hop, hop)
    return torch.fft.rfft(frames * win.to(prec.real), dim=-1).to(prec.cplx)


def gate_statistic(x_ib: torch.Tensor, nfft: int) -> torch.Tensor:
    """(B, M, F, NIB) -> (B, F, NIB): sum over mics of |X| / (M * nfft)
    (mvdr.cpp:79-82, gss.cpp's energy gate)."""
    return x_ib.abs().sum(1) / (x_ib.shape[1] * nfft)


def synthesis(y_half: torch.Tensor, win: torch.Tensor, hop: int,
              out_prev: torch.Tensor, amp: float):
    """Processed half spectra (B, F, hop+1) -> ((B, F*hop) audio, the new
    carry (B, hop)): p_f = irfft(y_f) * window, output hop f =
    out_prev + p_f[:hop] for f = 0 and p_{f-1}[hop:] + p_f[:hop] after
    (do_overlap, util.h:257-314), times ``amp``. ``out_prev`` and the new
    carry are the unscaled second half of the last window."""
    p = torch.fft.irfft(y_half, n=2 * hop, dim=-1) * win.to(y_half.real.dtype)
    first = p[..., :hop].clone()
    first[:, 0] += out_prev
    first[:, 1:] += p[:, :-1, hop:]
    return (amp * first).reshape(p.shape[0], -1), p[:, -1, hop:]


def ambiguous(stat: torch.Tensor, threshold: float,
              margin: float) -> torch.Tensor:
    """Pairs whose gate statistic lies within ``margin`` of the threshold,
    relatively: a float32 program may decide either way there."""
    return (stat - threshold).abs() <= margin * threshold


@torch.no_grad()
def gate_counts(ref, ring, block: int = 4):
    """(passed, total) in-band (frame, bin) pairs of each ring slot, as
    the window's chunks see it (after the slot before it), by the
    reference's float64 statistic and the node's threshold."""
    slots = ring.slots
    passed, total = np.zeros(slots), np.zeros(slots)
    for s in range(slots):
        x, xb = ring.chunk(s + slots), ring.before(s + slots, 1)
        for b0 in range(0, x.shape[0], block):
            xx = torch.cat([xb[b0:b0 + block], x[b0:b0 + block]], -1)
            x_ib = analysis(xx, ref.hop, ref.win, Precision("float64")) \
                .index_select(-1, ref.ib)
            gate = gate_statistic(x_ib, ref.nfft) > ref.thr
            passed[s] += float(gate.sum())
            total[s] += gate.numel()
    return passed, total
