"""Weighted overlap-add (WOLA) STFT engine on tensors.

Counterpart of ``beamform_tpu/dsp/wola.py`` (util.h:201-314), with the same
reference semantics:

* ``fft_win = 2 * hop`` with a 50% hop (util.h:261);
* a periodic sqrt-Hann window for analysis and synthesis (util.h:201-211);
* the input ring buffer starts with one hop of zeros (util.h:275-278), so
  frame ``t`` sees samples ``[(t-1)h, (t+1)h)``;
* synthesis takes ``real(ifft(Y)) * win`` (FFTW's unnormalised inverse
  divided by ``fft_win``, util.h:247-252);
* output hop t is ``second_half(p[t-1]) + first_half(p[t])`` with
  ``p[-1] = 0`` (util.h:284-286, 301-302).

These are the plain-torch framing helpers; the fused hot path is
``kernels/wola.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sqrt_hann(nfft: int, dtype=np.float64) -> np.ndarray:
    """Periodic sqrt-Hann window (util.h:201-211), computed in float64."""
    i = np.arange(nfft, dtype=np.float64)
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * i / nfft)).astype(dtype)


def _frames(ext: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., (T+1)*hop) -> (..., T, 2*hop) 50%-overlapped frames."""
    return ext.unfold(-1, 2 * hop, hop)


def frame_signal(x: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., S) with S a multiple of ``hop`` -> (..., T, 2*hop), frame ``t``
    holding samples ``[(t-1)*hop, (t+1)*hop)`` behind one hop of zeros."""
    if x.shape[-1] % hop:
        raise ValueError(f"signal length {x.shape[-1]} not a multiple of "
                         f"hop {hop}")
    return _frames(F.pad(x, (hop, 0)), hop)


def frame_signal_carry(x: torch.Tensor, hop: int, tail: torch.Tensor):
    """Streaming :func:`frame_signal`: ``tail`` (..., hop) is the previous
    chunk's last hop. Returns ((..., T, 2*hop) frames, new_tail)."""
    if x.shape[-1] % hop:
        raise ValueError(f"chunk length {x.shape[-1]} not a multiple of "
                         f"hop {hop}")
    ext = torch.cat([tail.to(x.dtype), x], dim=-1)
    return _frames(ext, hop), x[..., -hop:]


def overlap_add(processed: torch.Tensor, hop: int) -> torch.Tensor:
    """50% overlap-add of (..., T, 2*hop) windows to (..., T*hop), the t=0
    previous window being zero (util.h:284-286, 301-302)."""
    zero = processed.new_zeros(processed.shape[:-2] + (hop,))
    return overlap_add_carry(processed, hop, zero)[0]


def overlap_add_carry(processed: torch.Tensor, hop: int,
                      prev_second: torch.Tensor):
    """Streaming :func:`overlap_add`: ``prev_second`` (..., hop) is the
    previous chunk's final processed half-window. Returns
    ((..., T*hop) stream, new_prev_second)."""
    first = processed[..., :, :hop]
    second = processed[..., :, hop:]
    shifted = torch.cat([prev_second.to(processed.dtype)[..., None, :],
                         second[..., :-1, :]], dim=-2)
    out = (first + shifted).reshape(processed.shape[:-2] + (-1,))
    return out, second[..., -1, :]


def pad_to_hop(x: torch.Tensor, hop: int) -> torch.Tensor:
    """Zero-pad the last axis up to the next multiple of ``hop``."""
    rem = (-x.shape[-1]) % hop
    return F.pad(x, (0, rem)) if rem else x


def analyze(x: torch.Tensor, hop: int, window: torch.Tensor, *,
            cdtype=torch.complex64) -> torch.Tensor:
    """Window + full complex FFT of every frame, the reference's literal
    ``fftw_plan_dft_1d`` layout (das.cpp:127) used by the ``full_fft``
    audit mode: (..., S) -> (..., T, nfft)."""
    frames = frame_signal(x, hop) * window.to(x.dtype)
    return torch.fft.fft(frames.to(cdtype), dim=-1)


def synthesize(spectra: torch.Tensor, hop: int,
               window: torch.Tensor) -> torch.Tensor:
    """Inverse FFT + synthesis window + overlap-add (util.h:244-253):
    (..., T, nfft) -> (..., T*hop)."""
    y = torch.fft.ifft(spectra, dim=-1).real
    return overlap_add(y * window.to(y.dtype), hop)
