"""MCRA noise estimation / spectral subtraction node (Cohen & Berdugo 2002).

Reference: mcra.cpp:64-155. Operates on mic0 only. Per window: frequency
smoothing of |X|^2 with kernel [0.25, 0.5, 0.25] skipping DC
(mcra.cpp:83-92), temporal smoothing S = aS*S_prev + (1-aS)*S_f, minima
tracking every L windows, gated recursive noise update with two rates, then
spectral subtraction |X| - sqrt(lambda) at the input phase.

Faithful quirks: S_f[0] = |X(0)| (an *amplitude*, mcra.cpp:83) and the DC
output bin is never written — the loop writes y_fft[j] with j == fft_win at
mcra.cpp:127 (out of bounds); on a fresh heap the real y_fft[0] stays 0
forever, so faithful DC output is 0 (EngineConfig.bug_dc_zero).

Counterpart of ``beamform_tpu/models/mcra.py``: the mic-0 analysis (the
WOLA kernel on CUDA), the 3-tap smoothing in plain torch, the per-frame
recurrence in the MCRA march (``kernels/phase_mask.mcra_march``: the CUDA
kernel, or its plain version on the CPU, in float32 or float64) and the
synthesis. Streaming state is ``(WolaCarry of 1 mic, McraState)``.

The model's one forward (:meth:`McraModel.batched_forward`; a single
stream is a batch of one): one analysis launch of the B streams' mic 0
(each beside a zero channel, so that its spectrum rounds alike at any B),
one launch of the march for the B streams, one synthesis launch of the B
outputs.
"""

from __future__ import annotations

import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, McraParams
from beamform_tpu_torch.geometry import ArrayGeometry
# McraState and mcra_update are part of this module's surface; they live
# with the march kernel, whose plain version needs them too
from beamform_tpu_torch.kernels.phase_mask import (McraState, init_state,
                                                   mcra_march, mcra_update)
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel

__all__ = ["McraModel", "McraState", "freq_smooth", "mcra_init_state",
           "mcra_update"]


def mcra_init_state(nb: int, rdtype, device=None) -> McraState:
    return init_state(McraState, nb, rdtype, device)


def freq_smooth(sq, dc_amp):
    """3-tap smoothing skipping DC (mcra.cpp:83-92), extended-bin layout.

    S_f[j] = 0.25*sq[j-1] (if j-1 >= 1) + 0.5*sq[j] + 0.25*sq[j+1]
    (if j+1 < N) for j >= 1; S_f[0] = dc_amp (an amplitude, not a power).

    In the extended layout (NB = N/2+2, shadow at NB-1 = mirror of N/2-1)
    the stencil is right through bin N/2 (its full-layout right neighbour
    N/2+1 has |X| equal to bin N/2-1, which is what the shadow slot holds);
    the shadow's own smoothed value equals the mirror's by symmetry, set
    explicitly.
    """
    n = sq.shape[-1]
    left = torch.cat([torch.zeros_like(sq[..., :2]), sq[..., 1:n - 1]],
                     dim=-1)                  # sq[j-1] valid for j >= 2
    right = torch.cat([sq[..., 1:], torch.zeros_like(sq[..., :1])],
                      dim=-1)                 # sq[j+1] valid for j <= N-2
    s_f = 0.25 * left + 0.5 * sq + 0.25 * right
    s_f[..., n - 1] = s_f[..., n - 3]         # shadow := mirror value
    s_f[..., 0] = dc_amp
    return s_f


class McraModel(BatchableModel, nn.Module):
    name = "mcra"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: McraParams = McraParams(), device="cuda"):
        super().__init__()
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self):
        return (common.wola_carry_init(self.engine, 1, self.rdtype,
                                       self.device),
                mcra_init_state(common.num_bins(self.engine), self.rdtype,
                                self.device))

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """x (B, M, T*hop), the (unused) steering controls, state with a
        leading B -> ((B, T*hop) output, new state); mic 0 of each stream.
        mcra has no steering (mcra.cpp)."""
        carry, mstate = state
        # the analysis pairs two real channels in one complex FFT, and a
        # channel's spectrum rounds with its partner: mic 0 of each stream
        # goes in beside a zero channel, so that it rounds alike at any B
        b, _, s = x.shape
        x0 = x.new_zeros((b, 2, s))
        x0[:, 0] = x[:, 0]
        tail0 = carry.tail.new_zeros((b, 2, carry.tail.shape[-1]))
        tail0[:, :1] = carry.tail
        spec, _, tail = common.stft_streams_carry(
            x0, self.engine, self.window, self.cdtype, tail0)
        x_spec = spec[:, :, 0].contiguous()             # (T, B, NB) mic 0
        sq = x_spec.abs() ** 2
        s_f = freq_smooth(sq, x_spec[..., 0].abs())
        y, mstate = mcra_march(s_f, sq, x_spec, mstate, self.params,
                               self.engine.bug_dc_zero)    # (B, T, NB)
        out, prev = common.istft_channels_carry(y, self.engine, self.window,
                                                carry.out_prev)
        return out, (common.WolaCarry(tail[:, :1].contiguous(), prev),
                     mstate)
