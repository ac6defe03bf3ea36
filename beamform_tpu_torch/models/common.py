"""Shared building blocks for the beamformer models (the subset the ported
nodes need).

Counterpart of ``beamform_tpu/models/common.py``: per-bin C++ loops become
batched tensor ops over ``(frames, mics, bins)``.

Extended rFFT ("shadow bin") layout. The reference's frequency vector is
not mirror-symmetric (``f[N/2-1]`` is overwritten to fs/2 while its mirror
keeps ``-(N/2-1)fs/N``, and ``f[N/2]`` reads 0; util.h:190-199), so steering
weights are non-Hermitian at one bin pair. Instead of the reference's full
N-point complex FFT the models run rFFT bins 0..N/2 plus one shadow bin, the
mirror of bin N/2-1 fed ``conj(X[N/2-1])`` and steered with ``f[N/2+1]``,
and fold at synthesis (:func:`fold_ext`). NB = N/2 + 2 bins; index N/2+1 is
the shadow.

Streaming carries: :class:`WolaCarry` is the WOLA boundary state between
chunks (the reference's ring buffers and double-buffered output windows,
util.h:265-287). A whole-file run is one chunk with a zero carry, so online
equals offline by construction.

Device routing: on CUDA the carries go through the hand-written kernels in
``kernels/wola.py`` (float32, power-of-two nfft in [256, 4096], extended
layout); any other mode raises there. On the CPU they take the framing +
``torch.fft`` path below, in float32 or float64 and either layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from beamform_tpu_torch.config import EngineConfig
from beamform_tpu_torch.dsp.wola import (frame_signal_carry,
                                         overlap_add_carry, pad_to_hop,
                                         sqrt_hann)
from beamform_tpu_torch.geometry import (ArrayGeometry, frequency_vector,
                                         steering_delays, steering_weights)
# fold_ext is part of this module's surface; it lives with the synthesis
# kernel, which fuses it
from beamform_tpu_torch.kernels.wola import (fold_ext, wola_analysis,
                                             wola_synthesis)


def dtypes_of(engine: EngineConfig):
    if engine.dtype == "float64":
        return torch.float64, torch.complex128
    return torch.float32, torch.complex64


def ext_bins(nfft: int) -> int:
    return nfft // 2 + 2


def num_bins(engine: EngineConfig) -> int:
    """Width of the active bin layout (extended rFFT or full FFT)."""
    return engine.fft_win if engine.full_fft else ext_bins(engine.fft_win)


def make_freqs_ext(engine: EngineConfig) -> np.ndarray:
    """Frequency vector in the active bin layout, quirks included: extended
    rFFT by default, the literal full-length vector under ``full_fft``."""
    f = frequency_vector(engine.fft_win, engine.sample_rate,
                         exact=engine.exact_freqs)
    if engine.full_fft:
        return f
    n = engine.fft_win
    return np.concatenate([f[:n // 2 + 1], f[n // 2 + 1:n // 2 + 2]])


def _analysis_bins(frames: torch.Tensor, engine: EngineConfig, cdtype):
    """Windowed frames -> spectra in the active layout: extended rFFT, or
    the reference's N-point complex FFT under ``full_fft`` (das.cpp:127)."""
    if engine.full_fft:
        return torch.fft.fft(frames.to(cdtype), dim=-1)
    spec = torch.fft.rfft(frames, dim=-1).to(cdtype)
    h = engine.fft_win // 2
    return torch.cat([spec, spec[..., h - 1:h].conj()], dim=-1)


def synth_frames_ext(y_ext: torch.Tensor, engine: EngineConfig):
    """Active-layout spectra -> real time frames before the window:
    fold + irFFT, or real(ifft(.)) under ``full_fft`` (util.h:244-248)."""
    if engine.full_fft:
        return torch.fft.ifft(y_ext, dim=-1).real
    return torch.fft.irfft(fold_ext(y_ext, engine.fft_win),
                           n=engine.fft_win, dim=-1)


class WolaCarry(NamedTuple):
    tail: torch.Tensor       # (..., hop): last hop of input (ring content)
    out_prev: torch.Tensor   # (..., hop): previous processed half-window


def wola_carry_init(engine: EngineConfig, num_mics: int, rdtype,
                    device=None, per_mic_out: bool = False) -> WolaCarry:
    """Zero carries; ``per_mic_out`` keeps one synthesis carry per mic,
    ``out_prev`` (M, hop), for the per-mic resynthesis (GSC)."""
    h = engine.hop
    out_shape = (num_mics, h) if per_mic_out else (h,)
    return WolaCarry(torch.zeros((num_mics, h), dtype=rdtype, device=device),
                     torch.zeros(out_shape, dtype=rdtype, device=device))


def _require_kernel_layout(engine: EngineConfig):
    if engine.full_fft:
        raise ValueError("full_fft runs on the CPU only: the CUDA WOLA "
                         "kernels emit the extended layout (see ROADMAP.md "
                         "§1)")


def stft_streams_carry(x: torch.Tensor, engine: EngineConfig,
                       window: torch.Tensor, cdtype, tail: torch.Tensor,
                       with_mag: bool = False):
    """Analysis of B streams at once: x (B, M, C*hop) + tail (B, M, hop) ->
    ((T, B, M, NB) spectra, the gate statistic of each stream (T, B, NB)
    or None, new tail (B, M, hop)). The B*M channels go through one
    analysis: on CUDA one launch of the kernel, each stream's statistic in
    the same launch."""
    b, m, s = x.shape
    hop = engine.hop
    xf, tf = x.reshape(b * m, s), tail.reshape(b * m, hop)
    mag = None
    if x.is_cuda:
        _require_kernel_layout(engine)
        spec, mag, new_tail = wola_analysis(xf.contiguous(), tf.contiguous(),
                                            with_mag=with_mag, streams=b)
    else:
        frames, new_tail = frame_signal_carry(xf, hop, tf)
        spec = _analysis_bins(frames * window, engine, cdtype).movedim(0, 1)
    t = spec.shape[0]
    spec = spec.reshape(t, b, m, spec.shape[-1])
    if with_mag:
        mag = (mag_mean_over_mics(spec, engine.fft_win) if mag is None
               else mag.view(t, b, -1))
    return spec, mag, new_tail.reshape(b, m, hop)


def istft_channels_carry(y_ext: torch.Tensor, engine: EngineConfig,
                         window: torch.Tensor, out_prev: torch.Tensor):
    """Per-channel streaming synthesis: (C, T, NB) + out_prev (C, hop) ->
    ((C, T*hop) streams, new out_prev (C, hop)). CUDA tensors go through
    the fused kernel, all channels in one launch."""
    if y_ext.is_cuda:
        _require_kernel_layout(engine)
        return wola_synthesis(y_ext.contiguous(), out_prev.contiguous())
    p = synth_frames_ext(y_ext, engine) * window
    return overlap_add_carry(p, engine.hop, out_prev)


def band_mask(freqs: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """Static in-band bin mask: fmin <= |f| <= fmax over the (quirky)
    frequency vector (mvdr.cpp:84,109). Bin 0 is handled separately by
    every node (y[0] = X0[0]) and is excluded here."""
    m = (np.abs(freqs) >= fmin) & (np.abs(freqs) <= fmax)
    m[0] = False
    return m


def mag_mean_over_mics(x_spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """(..., M, NB) -> (..., NB): mean |X| over mics / nfft, the energy-gate
    statistic (mvdr.cpp:79-82: sum |X_i| / (M * fft_win)). ``nfft`` is the
    true FFT length, independent of the bin-layout width."""
    return x_spec.abs().sum(dim=-2) / (x_spec.shape[-2] * nfft)


def theta_per_frame(theta, num_frames: int) -> np.ndarray:
    """A scalar or per-frame theta control -> a (T,) float64 timeline (the
    replacement for the ``/theta`` ROS topic). A short timeline is held at
    its last angle (ROS 'latest message wins')."""
    th = np.asarray(theta, dtype=np.float64)
    if th.ndim == 0:
        return np.full((num_frames,), float(th))
    if th.ndim != 1 or len(th) > num_frames or len(th) == 0:
        raise ValueError(
            f"theta timeline shape {th.shape} incompatible with "
            f"{num_frames} frames")
    if len(th) < num_frames:
        th = np.concatenate([th, np.full(num_frames - len(th), th[-1])])
    return th


def unique_thetas(theta_frames):
    """(unique thetas (U,) float64, per-frame index (T,) int64)."""
    th = np.atleast_1d(np.asarray(theta_frames, dtype=np.float64))
    uniq, inv = np.unique(th, return_inverse=True)
    return uniq, np.asarray(inv, dtype=np.int64).reshape(-1)


def weights_for_thetas(geom: ArrayGeometry, freqs: torch.Tensor,
                       thetas: torch.Tensor, rdtype, cdtype,
                       row0_scale=1.0) -> torch.Tensor:
    """Steering weights for a (U,) theta tensor -> (U, M, NB), evaluated
    in ``rdtype`` on the tensors' device (das.cpp:27-45)."""
    tau = steering_delays(geom, thetas.to(rdtype), dtype=rdtype,
                          device=thetas.device)
    return steering_weights(freqs.to(rdtype), tau,
                            row0_scale=row0_scale).to(cdtype)


def prepare_input(x, engine: EngineConfig, rdtype, device) -> torch.Tensor:
    """Cast (M, S) or (S,) to the compute dtype on ``device`` and pad it
    to a hop multiple."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    x = x.to(device=device, dtype=rdtype)
    if x.dim() == 1:
        x = x[None, :]
    return pad_to_hop(x, engine.hop)


def make_window(engine: EngineConfig, rdtype) -> torch.Tensor:
    """Periodic sqrt-Hann window, computed in float64 and cast."""
    return torch.as_tensor(sqrt_hann(engine.fft_win), dtype=rdtype)


def map_frame_blocks(fn, spec: torch.Tensor, w_idx: torch.Tensor, *,
                     pairs: int = 1, budget_bytes: float = 192e6):
    """Apply a stateless per-frame spectral function in frame blocks so its
    internal (F, pairs, NB) intermediates stay within ``budget_bytes``.

    ``fn((spec_block (F, M, NB), idx_block (F,)))`` returns an (F, NB)
    tensor or a tuple of them; the blocks' results are concatenated over
    frames."""
    t, _, nb = spec.shape
    fb = max(8, int(budget_bytes / (max(pairs, 1) * nb * 4)))
    if t <= fb:
        return fn((spec, w_idx))
    outs = [fn((spec[i:i + fb], w_idx[i:i + fb])) for i in range(0, t, fb)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def polar_mag_phase(z: torch.Tensor):
    """(|z|, atan2 phase) — the reference's mag/phase reconstruction
    (e.g. phase.cpp:115: mag*cos(pha) + i*mag*sin(pha))."""
    return z.abs(), torch.atan2(z.imag, z.real)


def from_mag_phase(mag: torch.Tensor, pha: torch.Tensor) -> torch.Tensor:
    return torch.complex(mag * torch.cos(pha), mag * torch.sin(pha))
