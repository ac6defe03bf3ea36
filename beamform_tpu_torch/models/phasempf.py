"""Phase-masking beamformer with multi-channel post-filter (Valin 2007).

Reference: phasempf.cpp. Produces two beams per bin — SOI (mask) and
interference (complementary anti-mask) sharing the mean magnitude and the
reference mic's phase (phasempf.cpp:210-248) — then runs an embedded MCRA
noise estimate on the SOI power (phasempf.cpp:140-191) and a bi-channel
post-filter: leakage Z/lambda_leak (phasempf.cpp:255-261), reverberation
estimates for both channels (phasempf.cpp:263-266), total
lambda = sqrt(noise + leak + rev0 + rev1) (phasempf.cpp:268-270), spectral
subtraction with a noise floor (phasempf.cpp:273-295), and a time-domain
moving-average output smoother (phasempf.cpp:330-334).

Faithful quirks reproduced (all shape real output):
* the embedded MCRA's frequency smoothing reads ``out_soi_square[j]`` instead
  of ``[this_j]`` (phasempf.cpp:150) — each bin is scaled by the sum of
  in-range kernel coefficients (0.75 at the edges, 1.0 inside) instead of
  being smoothed;
* the reverberation update uses ``(1 - gamma/delta)`` (phasempf.cpp:265-266),
  not the paper's ``(1-gamma)/delta``;
* the DC output bin is never written (OOB write at phasempf.cpp:274) — with
  ``bug_dc_zero`` the DC output stays 0.

Counterpart of ``beamform_tpu/models/phasempf.py``. Strategies
(:meth:`PhasempfModel._strategy`): ``fused``, the dual beams and the
MCRA/MPF march in the MPF kernels (``kernels/phase_mask.mpf_march``: two
launches on CUDA, the plain version on the CPU) between the WOLA kernels;
``xla``, the batched dual beams in frame blocks and the march as a loop of
:func:`mpf_update`, plain torch on either device. The output smoother is
plain torch on both: the JAX package leaves it to XLA. Streaming state is
``(WolaCarry, MpfState, smoother tail (smooth_size - 1,))``.

The model's one forward (:meth:`PhasempfModel.batched_forward`; a single
stream is a batch of one): one analysis launch of the B*M channels, the
MPF kernels' one call for the B streams (``fused``) or the dual beams
over the streams' frames and the march on (B, NB) state (``xla``), one
synthesis launch of the B outputs and the smoother over (B, S).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, PhasempfParams
from beamform_tpu_torch.geometry import ArrayGeometry
# MpfState and mpf_update are part of this module's surface; they live with
# the MPF kernels, whose plain version needs them too
from beamform_tpu_torch.kernels.phase_mask import (MpfState, init_state,
                                                   march_frames, mpf_march,
                                                   mpf_out_mag, mpf_update)
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel
from beamform_tpu_torch.models.phase import (SOLVERS, mask_strategy,
                                             mean_pairwise_phase_dist,
                                             pair_indices)

__all__ = ["MpfState", "PhasempfModel", "buggy_freq_smooth", "dual_beam",
           "moving_average_causal", "moving_average_causal_carry",
           "mpf_init_state", "mpf_update"]


def mpf_init_state(nb: int, rdtype, device=None) -> MpfState:
    return init_state(MpfState, nb, rdtype, device)


def dual_beam(x_spec, weights, min_phase_rad, min_mag, ia, ib):
    """(T, M, N) -> (soi, intf) both (T, N) complex (phasempf.cpp:210-248)."""
    aligned = weights.conj() * x_spec
    aligned_phase = torch.atan2(aligned.imag, aligned.real)
    diff_mean = mean_pairwise_phase_dist(aligned_phase, ia, ib)
    mag_mean = x_spec.abs().mean(dim=-2)
    x0 = x_spec[..., 0, :]
    pha = torch.atan2(x0.imag, x0.real)
    big = common.from_mag_phase(mag_mean, pha)
    small = common.from_mag_phase(mag_mean * min_mag, pha)
    is_soi = diff_mean < min_phase_rad
    soi = torch.where(is_soi, big, small)
    intf = torch.where(is_soi, small, big)
    soi[..., 0] = x_spec[..., 0, 0]
    intf[..., 0] = x_spec[..., 0, 0]
    return soi, intf


def buggy_freq_smooth(soi_sq, dc_amp):
    """phasempf.cpp:144-153 — the [j]-instead-of-[this_j] variant: each bin
    scaled by the sum of in-range kernel coefficients.

    Extended-layout note: full-layout bin 1 and its mirror N-1 both get
    scale 0.75; here bin 1 carries both. The shadow bin (mirror of N/2-1)
    is interior in the full layout, so scale 1.0.
    """
    scale = torch.ones(soi_sq.shape[-1], dtype=soi_sq.dtype,
                       device=soi_sq.device)
    scale[1] = 0.75                     # left tap (this_j=0) out of range
    s_f = soi_sq * scale
    s_f[..., 0] = dc_amp
    return s_f


def _ma_shifted_sum(yp, size: int, n: int):
    """The sum of ``size`` shifted views along the last axis, over
    ``size``."""
    acc = yp[..., size - 1:size - 1 + n]
    for k in range(1, size):
        acc = acc + yp[..., size - 1 - k:size - 1 - k + n]
    return acc / size


def moving_average_causal(y, size: int):
    """Causal length-``size`` moving average with zero history, matching the
    shift-register smoother at phasempf.cpp:330-334."""
    if size <= 1:
        return y
    return _ma_shifted_sum(torch.cat([y.new_zeros(size - 1), y]), size,
                           y.shape[0])


def moving_average_causal_carry(y, size: int, tail):
    """Streaming variant along the last axis: ``tail`` is the previous
    (..., size-1) samples (B streams: y (B, S), tail (B, size-1)).
    Returns (smoothed, new_tail)."""
    if size <= 1:
        return y, tail
    yp = torch.cat([tail.to(y.dtype), y], dim=-1)
    return _ma_shifted_sum(yp, size, y.shape[-1]), yp[..., -(size - 1):]


class PhasempfModel(BatchableModel, nn.Module):
    name = "phasempf"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: PhasempfParams = PhasempfParams(), device="cuda"):
        super().__init__()
        if params.solver not in SOLVERS:
            raise ValueError(f"unknown phasempf solver {params.solver!r}; "
                             f"one of {', '.join(SOLVERS)}")
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))
        self.register_buffer(
            "freqs", torch.as_tensor(common.make_freqs_ext(engine),
                                     device=device))
        ia, ib = pair_indices(geom.num_mics)
        self.register_buffer("ia", ia.to(device), persistent=False)
        self.register_buffer("ib", ib.to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self):
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype, self.device),
                mpf_init_state(common.num_bins(self.engine), self.rdtype,
                               self.device),
                torch.zeros((max(self.params.smooth_size - 1, 0),),
                            dtype=self.rdtype, device=self.device))

    def _strategy(self) -> str:
        return mask_strategy(self)

    def _march_xla(self, spec, w_uniq, w_idx, mstate: MpfState):
        """The ``xla`` strategy: the dual beams in frame blocks, then the
        MCRA/MPF recurrences frame by frame. spec (T, B, M, NB), w_idx (B,
        T) and the state's vectors (B, NB) -> (y (B, T, NB), state)."""
        p = self.params
        m, nb = spec.shape[-2:]

        # chunk the stateless dual-beam mask over frame blocks (the pairwise
        # tensor is (T, M(M-1)/2, NB) otherwise), the streams' (T, B)
        # frames as one frame axis
        def mask_fn(args):
            spec_b, idx_b = args
            return dual_beam(spec_b, w_uniq[idx_b],
                             p.min_phase * math.pi / 180.0, p.min_mag,
                             self.ia, self.ib)

        soi, intf = (a.reshape(spec.shape[:-2] + (nb,)) for a in
                     common.map_frame_blocks(
                         mask_fn, spec.reshape(-1, m, nb),
                         w_idx.T.reshape(-1), pairs=len(self.ia)))
        soi_sq = soi.abs() ** 2
        soi_sq[..., 0] = 0.0                  # set only for j >= 1
        int_sq = intf.abs() ** 2
        int_sq[..., 0] = 0.0
        s_f = buggy_freq_smooth(soi_sq, soi[..., 0].abs())

        def step(st, t):
            st, lam = mpf_update(st, s_f[t], soi_sq[t], int_sq[t], p)
            return st, (lam, st.lam_noise)

        mstate, (lams, noises) = march_frames(mstate, spec.shape[0], step)
        mag_soi, pha = common.polar_mag_phase(soi)
        y = common.from_mag_phase(mpf_out_mag(mag_soi, lams, noises, p), pha)
        y[..., 0] = 0.0 if self.engine.bug_dc_zero else soi[..., 0]
        return y.movedim(0, 1), mstate

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """x (B, M, T*hop), (unique thetas (U,), index (B, T)), state with
        a leading B -> ((B, T*hop) output, new state)."""
        thetas, idx = ctrl
        p = self.params
        carry, mstate, smooth_tail = state
        spec, _, tail = common.stft_streams_carry(
            x, self.engine, self.window, self.cdtype, carry.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        if self._strategy() == "fused":
            y, mstate = mpf_march(spec, w_uniq, idx, mstate, p,
                                  self.engine.bug_dc_zero)
        else:
            y, mstate = self._march_xla(spec, w_uniq, idx, mstate)
        out, prev = common.istft_channels_carry(y, self.engine, self.window,
                                                carry.out_prev)
        out, smooth_tail = moving_average_causal_carry(out, p.smooth_size,
                                                       smooth_tail)
        return out, (common.WolaCarry(tail, prev), mstate, smooth_tail)
