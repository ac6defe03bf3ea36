"""Phase-difference masking beamformer.

Reference: phase.cpp — per bin, align each mic's phase with the steering
weights (phase.cpp:102-104), take the mean pairwise wrapped phase distance
over all mic pairs (recursive get_overall_phase_diff, phase.cpp:53-68), and
either keep the mean magnitude at the reference mic's phase or attenuate by
``mag_mult`` (phase.cpp:100-123). A low-magnitude gate
(``mag_mean/fft_win > mag_threshold``) short-circuits to attenuation.

Counterpart of ``beamform_tpu/models/phase.py``. Strategies
(:meth:`PhaseModel._strategy`): ``fused``, the WOLA analysis kernel, the
phase-mask kernel (``kernels/phase_mask.py``) and the WOLA synthesis kernel
on CUDA (the mask's plain version on the CPU); ``xla``, the batched
formulation :func:`phase_mask_spectral` in frame blocks, plain torch on
either device. The node is stateless per frame: its streaming state is the
WOLA boundary carry.

The model's one forward (:meth:`PhaseModel.batched_forward`; a single
stream is a batch of one): one analysis launch of the B*M channels, the
mask over the B streams (``fused``: one launch of the phase-mask kernel;
``xla``: the streams' frames folded into one frame axis) and one
synthesis launch of the B outputs.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, PhaseParams
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.kernels.phase_mask import phase_mask
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel

SOLVERS = ("auto", "fused", "xla")


def pair_indices(m: int):
    """The upper-triangle mic pairs (ia, ib), each (M(M-1)/2,) int64."""
    ia, ib = torch.triu_indices(m, m, offset=1)
    return ia, ib


def mean_pairwise_phase_dist(aligned_phase, ia, ib):
    """aligned_phase (..., M, N) -> (..., N): mean over pairs of the wrapped
    absolute difference (d > pi -> 2*pi - d), phase.cpp:57-61."""
    d = (aligned_phase.index_select(-2, ia)
         - aligned_phase.index_select(-2, ib)).abs()
    d = torch.where(d > math.pi, 2.0 * math.pi - d, d)
    return d.mean(dim=-2)


def phase_mask_spectral(x_spec, weights, params: PhaseParams, nfft: int,
                        ia, ib, bf16: bool = False):
    """(T, M, N) spectra + (T, M, N)|(M, N) weights -> (T, N) output bins.

    ``bf16``: the alignment products and magnitudes on bfloat16 spectra
    (the JAX package's quantized-inference experiment); atan2 and the
    output's reference phase stay in the working precision.
    """
    x0 = x_spec[..., 0, :]
    pha = torch.atan2(x0.imag, x0.real)
    if bf16:
        b = torch.bfloat16
        xr, xi = x_spec.real.to(b), x_spec.imag.to(b)
        wr, wi = weights.real.to(b), weights.imag.to(b)
        mag_mean = torch.sqrt((xr * xr + xi * xi).float()).mean(dim=-2)
        ar = (wr * xr + wi * xi).float()                 # conj(w) * x
        ai = (wr * xi - wi * xr).float()
        aligned_phase = torch.atan2(ai, ar)
    else:
        mag_mean = x_spec.abs().mean(dim=-2)             # (T, N)
        aligned = weights.conj() * x_spec
        aligned_phase = torch.atan2(aligned.imag, aligned.real)
    diff_mean = mean_pairwise_phase_dist(aligned_phase, ia, ib)

    min_phase_rad = params.min_phase * math.pi / 180.0
    keep = ((mag_mean / nfft > params.mag_threshold)
            & (diff_mean < min_phase_rad))
    mag = torch.where(keep, mag_mean, mag_mean * params.mag_mult)
    y = common.from_mag_phase(mag, pha)
    y[..., 0] = x_spec[..., 0, 0]                        # phase.cpp:87
    return y


def mask_strategy(model, bf16: bool = False) -> str:
    """The phase masks' strategy (phase and phasempf): "fused" (the kernels
    between the WOLA kernels on CUDA, their plain versions on the CPU) or
    "xla" (the batched formulation). "fused" is a float32 strategy;
    "auto" takes it on a CUDA float32 engine unless ``bf16`` asks for the
    bf16 experiment."""
    solver = model.params.solver
    if solver == "fused":
        if model.cdtype != torch.complex64:
            raise ValueError("the fused mask is a float32 strategy; use "
                             "solver='xla' with float64")
        return "fused"
    if (solver == "auto" and model.device.type == "cuda"
            and model.cdtype == torch.complex64 and not bf16):
        return "fused"
    return "xla"


class PhaseModel(BatchableModel, nn.Module):
    name = "phase"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: PhaseParams = PhaseParams(), device="cuda"):
        super().__init__()
        if params.solver not in SOLVERS:
            raise ValueError(f"unknown phase solver {params.solver!r}; one "
                             f"of {', '.join(SOLVERS)}")
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

    def stream_init(self) -> common.WolaCarry:
        return common.wola_carry_init(self.engine, self.geom.num_mics,
                                      self.rdtype, self.device)

    def _strategy(self) -> str:
        return mask_strategy(self, self.params.spectra_bf16)

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state: common.WolaCarry):
        """x (B, M, T*hop), (unique thetas (U,), index (B, T)), carries
        with a leading B -> ((B, T*hop) output, new carries)."""
        thetas, idx = ctrl
        p = self.params
        nfft = self.engine.fft_win
        spec, _, tail = common.stft_streams_carry(
            x, self.engine, self.window, self.cdtype, state.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        if self._strategy() == "fused":
            y = phase_mask(spec, w_uniq, idx, p.min_phase * math.pi / 180.0,
                           p.mag_threshold, p.mag_mult, nfft)
        else:
            # stateless per frame: the (T, B) frames as one frame axis
            t, b, m, nb = spec.shape

            def mask_fn(args):
                spec_b, idx_b = args
                return phase_mask_spectral(spec_b, w_uniq[idx_b], p, nfft,
                                           self.ia, self.ib,
                                           bf16=p.spectra_bf16)

            y = common.map_frame_blocks(
                mask_fn, spec.reshape(t * b, m, nb), idx.T.reshape(-1),
                pairs=len(self.ia)).reshape(t, b, nb).movedim(0, 1)
        out, prev = common.istft_channels_carry(y, self.engine, self.window,
                                                state.out_prev)
        return out, common.WolaCarry(tail, prev)
