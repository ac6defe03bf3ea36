"""Sample-rate conversion of the output (``ros_output_sample_rate``).

Replaces the reference's libsamplerate SRC_SINC_FASTEST path
(rosjack.h:50, rosjack.cpp:159-187, 311-350) with the JAX package's
windowed-sinc resampler: zero-stuff by ``up``, correlate with a Kaiser
lowpass ``h`` of ``2 * 24 * max(up, down) + 1`` taps, keep every
``down``-th sample. Functionally equivalent (band-limited sinc
interpolation), not bit-identical to libsamplerate's streaming state
machine.

The zero-stuffed signal is never formed (at 48000 -> 44100 it would be
147 times the input). Output ``k`` reads the input from
``i0(k) = ceil((k * down - pad_l) / up)`` with the taps
``h[p(k) + up * q]``, ``p(k) = up * i0(k) - k * down + pad_l``. Outputs
``k`` and ``k + up`` share the phase ``p`` and start ``down`` input
samples apart, so the ``up`` output phases are one strided ``conv1d``
with ``up`` output channels, each channel's taps shifted by its own
start.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sp_signal


@lru_cache(maxsize=64)
def _design(fs_in: int, fs_out: int, taps_per_phase: int = 24):
    g = math.gcd(fs_in, fs_out)
    up, down = fs_out // g, fs_in // g
    ntaps = 2 * taps_per_phase * max(up, down) + 1
    cutoff = 1.0 / (2.0 * max(up, down))   # in units of the upsampled Nyquist
    h = sp_signal.firwin(ntaps, 2.0 * cutoff, window=("kaiser", 9.0))
    h = (h * up).astype(np.float32)
    return up, down, h


@lru_cache(maxsize=64)
def _polyphase(fs_in: int, fs_out: int):
    """(up, down, first input index of output phase 0's window, the
    (up, 1, K) conv1d weights: output phase r's taps at its own offset)."""
    up, down, h = _design(fs_in, fs_out)
    ntaps = len(h)
    pad_l = (ntaps - 1) // 2
    r = np.arange(up)
    start = -((pad_l - r * down) // up)          # ceil((r*down - pad_l)/up)
    phase = up * start - r * down + pad_l        # first tap, in [0, up)
    q = -(-(ntaps - phase) // up)                # taps of each phase
    shift = start - start.min()
    w = np.zeros((up, 1, int((shift + q).max())), np.float32)
    for i in range(up):
        w[i, 0, shift[i]:shift[i] + q[i]] = h[phase[i]::up]
    return up, down, int(start.min()), w


def resample(x, fs_in: int, fs_out: int, *, device="cuda",
             dtype=torch.float32) -> torch.Tensor:
    """x: (..., S) -> (..., ceil(S * fs_out / fs_in)) on ``device``,
    equal to the JAX package's ``resample`` (its ``conv_general_dilated``
    with ``lhs_dilation=up``, stride ``down``, padding ``(pad_l,
    pad_r)``)."""
    x = torch.as_tensor(x).to(device=device, dtype=dtype)
    if fs_in == fs_out:
        return x
    up, down, first, w = _polyphase(int(fs_in), int(fs_out))
    lead, s = x.shape[:-1], x.shape[-1]
    out_len = -(-s * up // down)
    frames = -(-out_len // up)                   # outputs per phase
    k = w.shape[-1]
    # input window [first, first + (frames - 1) * down + k), zeros outside
    stop = first + (frames - 1) * down + k
    xc = x.reshape(-1, 1, s)
    xc = xc[..., max(first, 0):min(stop, s)]
    xc = F.pad(xc, (max(-first, 0), max(stop - s, 0)))
    # no TF32: the convolution must keep float32's precision on the card
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        y = F.conv1d(xc, torch.as_tensor(w).to(xc), stride=down)
    y = y.transpose(1, 2).reshape(xc.shape[0], frames * up)[:, :out_len]
    return y.reshape(*lead, out_len)
