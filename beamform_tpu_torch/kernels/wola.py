"""Fused WOLA analysis and synthesis: the CUDA kernels' wrappers and their
plain-torch versions.

Counterpart of ``beamform_tpu/kernels/wola_pallas.py``: ``wola_analysis``
replaces ``_fwd_kernel`` (via ``stft_planes``) and ``wola_synthesis``
replaces ``_inv_kernel`` plus the fold and mirror before it (via
``istft_ext_fused``). The kernels are in ``csrc/wola.cu``.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises (unsupported size or dtype, bad layout, a
launch error). There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from beamform_tpu_torch.dsp.wola import frame_signal_carry, sqrt_hann
from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.utils.profiling import span

MIN_NFFT, MAX_NFFT = 256, 4096


def fold_ext(y_ext: torch.Tensor, nfft: int) -> torch.Tensor:
    """(..., NB) extended-layout bins -> (..., N/2+1) Hermitian rFFT bins:
    bin h-1 becomes the blend (y[h-1] + conj(y[h+1])) / 2 of itself and
    the shadow, and bins 0 and h keep only their real part, which is what
    real(ifft(.)) does to the self-conjugate bins."""
    h = nfft // 2
    y_r = y_ext[..., :h + 1].clone()
    y_r[..., h - 1] = 0.5 * (y_ext[..., h - 1] + y_ext[..., h + 1].conj())
    y_r[..., 0] = y_r[..., 0].real.to(y_r.dtype)
    y_r[..., h] = y_r[..., h].real.to(y_r.dtype)
    return y_r


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def wola_analysis_plain(x: torch.Tensor, tail: torch.Tensor,
                        with_mag: bool = False, streams: int = 1):
    """x (C, T*hop) + tail (C, hop) -> (spec (T, C, hop+2) complex,
    mag (T, hop+2) | None, new_tail (C, hop)).

    Frames -> periodic sqrt-Hann -> full nfft-point FFT, keeping bins
    0..h+1: bin h+1 is conj(X[h-1]), the extended layout's shadow bin.
    ``mag`` is the energy-gate statistic sum_c |X| / (C * nfft)
    (mvdr.cpp:79-82). With ``streams`` > 1 the C channels are that many
    streams of C / streams channels each, and mag (T, streams, hop+2)
    holds each stream's statistic.
    """
    hop = tail.shape[-1]
    nfft = 2 * hop
    frames, new_tail = frame_signal_carry(x, hop, tail)      # (C, T, nfft)
    win = torch.as_tensor(sqrt_hann(nfft), dtype=x.dtype, device=x.device)
    spec = torch.fft.fft(frames * win, dim=-1)[..., :hop + 2]
    spec = spec.movedim(0, 1).contiguous()                    # (T, C, NB)
    mag = None
    if with_mag and streams == 1:
        mag = spec.abs().sum(dim=1) / (x.shape[0] * nfft)
    elif with_mag:
        t, c, nb = spec.shape
        mag = (spec.view(t, streams, c // streams, nb).abs().sum(dim=2)
               / (c // streams * nfft))
    return spec, mag, new_tail


def wola_synthesis_plain(y_ext: torch.Tensor, out_prev: torch.Tensor):
    """y_ext (C, T, hop+2) complex + out_prev (C, hop) -> (out (C, T*hop),
    new_prev (C, hop)).

    :func:`fold_ext` -> inverse real FFT
    (x 1/nfft) -> synthesis window -> 50% overlap-add with the carry.
    """
    hop = y_ext.shape[-1] - 2
    nfft = 2 * hop
    p = torch.fft.irfft(fold_ext(y_ext, nfft), n=nfft, dim=-1)
    win = torch.as_tensor(sqrt_hann(nfft), dtype=p.dtype, device=p.device)
    p = p * win
    out = p[..., :hop].clone()
    out[..., 1:, :] += p[..., :-1, hop:]
    out[..., 0, :] += out_prev.to(p.dtype)
    return out.reshape(p.shape[:-2] + (-1,)), p[..., -1, hop:]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_nfft(nfft: int):
    if nfft & (nfft - 1) or not MIN_NFFT <= nfft <= MAX_NFFT:
        raise ValueError(
            f"the CUDA WOLA kernels take power-of-two nfft in "
            f"[{MIN_NFFT}, {MAX_NFFT}], got {nfft}; other sizes run on the "
            "CPU only (see ROADMAP.md §1)")


def _pass_table(passes) -> np.ndarray:
    """The twiddles of Stockham passes with Ns > 1 as one float64 (rows, 2)
    table, pass after pass, entry r * Ns + k holding exp(-2 pi i k r /
    (Ns R))."""
    parts = []
    for r_, ns in passes[1:]:
        r, k = np.meshgrid(np.arange(r_), np.arange(ns), indexing="ij")
        ang = -2.0 * np.pi * (k * r).ravel() / (ns * r_)
        parts.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
    return np.concatenate(parts)


def _fft_passes(n: int):
    """The register FFT's Stockham passes (csrc/reg_fft.cuh) at n points:
    (16, 1), (16, 16) and, above 256 points, (n / 256, 256)."""
    return [(16, 1), (16, 16)] + ([(n // 256, 256)] if n > 256 else [])


def analysis_plan(nfft: int):
    """The analysis kernel's FFT plan (csrc/reg_fft.cuh): its Stockham
    passes as (R, Ns) pairs, (16, 1), (16, 16) and, above 256 points,
    (nfft / 256, 256), and the twiddles of the passes with Ns > 1 as one
    float32 (rows, 2) table, pass after pass, entry r * Ns + k holding
    exp(-2 pi i k r / (Ns R)), computed in float64."""
    passes = _fft_passes(nfft)
    return passes, _pass_table(passes).astype(np.float32)


def synthesis_plan(nfft: int):
    """The synthesis kernel's plan (csrc/wola.cu, csrc/reg_irfft.cuh):
    (half, passes, table), ``table`` float64 (rows, 2). For nfft >= 512
    (``half``) the inverse real FFT runs as one complex FFT of nfft / 2
    points: ``passes`` are that FFT's Stockham passes and ``table`` its
    pass twiddles (:func:`analysis_plan`'s at nfft / 2, in float64)
    followed by the nfft / 2 pre-twiddles exp(+2 pi i k / nfft). At nfft
    256 the kernel transforms the full Hermitian frame: the passes and
    pass twiddles of 256 points, no pre-twiddles."""
    half = nfft >= 512
    n = nfft // 2 if half else nfft
    passes = _fft_passes(n)
    table = _pass_table(passes)
    if half:
        ang = 2.0 * np.pi * np.arange(n) / nfft
        table = np.concatenate([table, np.stack([np.cos(ang), np.sin(ang)],
                                                axis=-1)])
    return half, passes, table


@lru_cache(maxsize=8)
def _analysis_tables(nfft: int, device: torch.device):
    """(window (nfft,), the pass twiddles of :func:`analysis_plan`) as
    float32 on ``device``."""
    return (torch.as_tensor(sqrt_hann(nfft), dtype=torch.float32,
                            device=device),
            torch.as_tensor(analysis_plan(nfft)[1], device=device))


@lru_cache(maxsize=8)
def _tables(nfft: int, device: torch.device):
    """(window (nfft,), twiddles (nfft/2, 2)) as float32 on ``device``,
    computed in float64: tw[j] = exp(-2 pi i j / nfft). The fused kernels'
    radix-2 synthesis (csrc/band_wola.cuh) reads them."""
    ang = -2.0 * np.pi * np.arange(nfft // 2, dtype=np.float64) / nfft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    win = sqrt_hann(nfft)
    return (torch.as_tensor(win, dtype=torch.float32, device=device),
            torch.as_tensor(tw, dtype=torch.float32, device=device))


@lru_cache(maxsize=8)
def _synthesis_tables(nfft: int, device: torch.device):
    """(window (nfft,), :func:`synthesis_plan`'s table) as float32 on
    ``device``."""
    return (torch.as_tensor(sqrt_hann(nfft), dtype=torch.float32,
                            device=device),
            torch.as_tensor(synthesis_plan(nfft)[2], dtype=torch.float32,
                            device=device))


def wola_analysis(x: torch.Tensor, tail: torch.Tensor,
                  with_mag: bool = False, streams: int = 1):
    """Fused WOLA analysis; see :func:`wola_analysis_plain` for the
    contract. On CUDA: float32, contiguous, nfft = 2*hop a power of two in
    [256, 4096], ``streams`` dividing C; one launch, with or without
    ``mag``."""
    if not x.is_cuda:
        return wola_analysis_plain(x, tail, with_mag, streams)
    with span("bf.kernel.wola_analysis"):
        c, s = x.shape
        hop = tail.shape[-1]
        _check_nfft(2 * hop)
        if s % hop or s == 0:
            raise ValueError(f"x length {s} must be a positive multiple of "
                             f"hop {hop}")
        if streams < 1 or c % streams:
            raise ValueError(f"{c} channels do not split into {streams} "
                             "streams")
        t = s // hop
        check_tensor(x, "x", torch.float32, (c, s), x.device)
        check_tensor(tail, "tail", torch.float32, (c, hop), x.device)
        nb = hop + 2
        win, tw = _analysis_tables(2 * hop, x.device)
        spec = torch.empty((t, c, nb), dtype=torch.complex64, device=x.device)
        mag_shape = (t, nb) if streams == 1 else (t, streams, nb)
        mag = (torch.empty(mag_shape, dtype=torch.float32, device=x.device)
               if with_mag else None)
        with device_guard(x.device):
            lib, stream = launch_context(x.device)
            code = lib.bf_wola_analysis(
                x.data_ptr(), tail.data_ptr(), win.data_ptr(), tw.data_ptr(),
                spec.data_ptr(), mag.data_ptr() if with_mag else None,
                c, c // streams, t, hop, stream)
        check(lib, code, "wola_analysis")
    wola_analysis.launches += 1
    return spec, mag, x[:, -hop:].contiguous()


def wola_synthesis(y_ext: torch.Tensor, out_prev: torch.Tensor):
    """Fused WOLA synthesis; see :func:`wola_synthesis_plain` for the
    contract. On CUDA: complex64 ``y_ext`` (C, T, hop+2) and float32
    ``out_prev`` (C, hop), contiguous, nfft a power of two in
    [256, 4096]; one launch."""
    if not y_ext.is_cuda:
        return wola_synthesis_plain(y_ext, out_prev)
    with span("bf.kernel.wola_synthesis"):
        if y_ext.dim() != 3 or y_ext.shape[1] == 0:
            raise ValueError(f"y_ext must be (C, T>0, NB), got "
                             f"{tuple(y_ext.shape)}")
        c, t, nb = y_ext.shape
        hop = nb - 2
        _check_nfft(2 * hop)
        dev = y_ext.device
        check_tensor(y_ext, "y_ext", torch.complex64, (c, t, nb), dev)
        check_tensor(out_prev, "out_prev", torch.float32, (c, hop), dev)
        win, tw = _synthesis_tables(2 * hop, dev)
        out = torch.empty((c, t * hop), dtype=torch.float32, device=dev)
        new_prev = torch.empty((c, hop), dtype=torch.float32, device=dev)
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_wola_synthesis(
                y_ext.data_ptr(), out_prev.data_ptr(), win.data_ptr(),
                tw.data_ptr(), out.data_ptr(), new_prev.data_ptr(), c, t, hop,
                stream)
        check(lib, code, "wola_synthesis")
    wola_synthesis.launches += 1
    return out, new_prev


wola_analysis.launches = 0
wola_synthesis.launches = 0
