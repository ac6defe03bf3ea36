"""Utility nodes: the alignment reference and the loudest-mic reader.

Counterpart of ``beamform_tpu/models/refmic.py``; neither node has a
kernel (the JAX package leaves both to XLA), so both are plain torch on
the model's device.

* :class:`RefModel`, jack_ref.cpp:19-30: mic 0 through the identity WOLA
  path (framed behind one hop of zeros, windowed twice, overlap-added, no
  FFT), so its output lines up sample for sample with every beamformer's
  output: the reference every separation metric is taken against.
* :class:`ReadModel`, jack_read.cpp:10-43: per window, the loudest mic
  (energy sum |100 x|, the first maximum) passes through; an all-zero
  window keeps the previous pick, mic 0 at the start. The picks are formed
  on the device, a carry-forward over the chunk's windows, with no host
  loop. Its state is the last pick, an int32 0-d tensor (-1 before the
  first window), the JAX package's leaf, so checkpoints move between the
  packages.

Both nodes' one forward (``batched_forward``; a single stream, which may
come as one channel (S,), is a batch of one) takes B streams with torch
ops over a leading stream axis, with no loop over streams; their states
stack as the JAX package's vmap stacks them (``read``: a (B,) int32 pick,
-1 before a stream's first window). Neither has a steering: the controls
are unused (jack_ref.cpp, jack_read.cpp).
"""

from __future__ import annotations

import torch
from torch import nn

from beamform_tpu_torch.config import DasParams, EngineConfig
from beamform_tpu_torch.dsp.wola import frame_signal_carry, overlap_add_carry
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel


class RefModel(BatchableModel, nn.Module):
    name = "ref"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: DasParams = DasParams(), device="cuda"):
        super().__init__()
        self.engine = engine
        self.rdtype, _ = common.dtypes_of(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self) -> common.WolaCarry:
        h = self.engine.hop
        return common.WolaCarry(
            torch.zeros((h,), dtype=self.rdtype, device=self.device),
            torch.zeros((h,), dtype=self.rdtype, device=self.device))

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state: common.WolaCarry):
        """x (B, M, T*hop), the (unused) steering controls, carries (B,
        hop) -> ((B, T*hop) output, new carries): mic 0 of each stream."""
        frames, tail = frame_signal_carry(x[:, 0], self.engine.hop,
                                          state.tail)      # (B, T, 2 hop)
        p = frames * self.window * self.window
        out, prev = overlap_add_carry(p, self.engine.hop, state.out_prev)
        return out, common.WolaCarry(tail, prev)


class ReadModel(BatchableModel, nn.Module):
    name = "read"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: DasParams = DasParams(), device="cuda"):
        super().__init__()
        self.engine = engine
        self.rdtype, _ = common.dtypes_of(engine)
        # max_mic_past before the first window (jack_read.cpp:8)
        self.register_buffer("no_pick", torch.tensor(-1, dtype=torch.int32,
                                                     device=device))

    @property
    def device(self) -> torch.device:
        return self.no_pick.device

    def stream_init(self) -> torch.Tensor:
        return self.no_pick.clone()

    def _picks(self, wins, state):
        """Windows (..., M, T, hop) and the last pick (...) -> each window's
        pick (..., T) int64."""
        t = wins.shape[-2]
        energy = (wins * 100.0).abs().sum(dim=-1).transpose(-1, -2)
        # (..., T, M). jack_read.cpp:20-37: a strictly-greater scan keeps
        # the first maximum (argmax's tie rule); an all-zero window keeps
        # the previous pick, mic 0 before any
        pick = energy.argmax(dim=-1)
        pos = torch.arange(t, device=self.device)
        last = torch.where((energy > 0.0).any(dim=-1), pos,
                           -1).cummax(-1)[0]
        prev = torch.where(state < 0, 0, state).to(pick.dtype)
        return torch.where(last >= 0, pick.gather(-1, last.clamp_min(0)),
                           prev[..., None])

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state: torch.Tensor):
        """x (B, M, T*hop), the (unused) steering controls, the last picks
        (B,) int32 -> ((B, T*hop) output, the last picks)."""
        h = self.engine.hop
        b, m, s = x.shape
        t = s // h
        if t == 0:
            return x.new_zeros((b, 0)), state
        wins = x.reshape(b, m, t, h)
        picks = self._picks(wins, state)                    # (B, T)
        streams = torch.arange(b, device=self.device)[:, None]
        pos = torch.arange(t, device=self.device)
        return (wins[streams, picks, pos].reshape(b, -1),
                picks[:, -1].to(torch.int32))
