"""Delay-and-sum beamformer (frequency domain).

Reference: das.cpp, per bin y(f) = w(f)^H x(f) / M (das.cpp:60-63) with
steering weights w_m(f) = exp(-i 2 pi f tau_m), mic0 = 1 (das.cpp:27-45).

Counterpart of ``beamform_tpu/models/das.py``. On CUDA the WOLA analysis and
synthesis run in the hand-written kernels (``kernels/wola.py``); the
weight-and-sum over mics stays plain torch, as the JAX package leaves it to
XLA outside any Pallas kernel. Streaming state is the WOLA boundary carry.

Its one forward (:meth:`DasModel.batched_forward`; a single stream is a
batch of one) flattens the (B, M) channels through one analysis launch and
synthesises the B outputs in one synthesis launch, steering per (stream,
frame); one steering a stream broadcasts.
"""

from __future__ import annotations

import torch
from torch import nn

from beamform_tpu_torch.config import DasParams, EngineConfig
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel


class DasModel(BatchableModel, nn.Module):
    name = "das"
    collapse_constant_steering = True

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: DasParams = DasParams(), device="cuda"):
        super().__init__()
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))
        self.register_buffer(
            "freqs", torch.as_tensor(common.make_freqs_ext(engine),
                                     device=device))

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self) -> common.WolaCarry:
        return common.wola_carry_init(self.engine, self.geom.num_mics,
                                      self.rdtype, self.device)

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state: common.WolaCarry):
        """x (B, M, T*hop), (unique thetas (U,), index (B, T) or (B, 1)),
        carries with a leading B -> ((B, T*hop) output, new carries), as
        JAX ``das.py:_forward_batched``."""
        thetas, idx = ctrl
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        spec, _, tail = common.stft_streams_carry(
            x, self.engine, self.window, self.cdtype, state.tail)
        m = spec.shape[2]                                  # (T, B, M, NB)
        w = w_uniq[idx]                                    # (B, T|1, M, NB)
        y = (w.conj() * spec.movedim(0, 1)).sum(dim=2) / m  # (B, T, NB)
        out, prev = common.istft_channels_carry(y, self.engine, self.window,
                                                state.out_prev)
        return out, common.WolaCarry(tail, prev)
