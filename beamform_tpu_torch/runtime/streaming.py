"""Streaming engine: chunked online processing with explicit state.

Every model's streaming state is an explicit (possibly nested) tuple or
NamedTuple of tensors: the WOLA boundary carry, plus e.g. MVDR's complex
covariance history. Chunked execution equals one offline call and a
session can be checkpointed mid-stream and resumed elsewhere.

The checkpoint format is the JAX package's (``beamform_tpu.runtime
.streaming``): an ``.npz`` with the state's leaves as ``leaf_0``,
``leaf_1``, ... in ``jax.tree.flatten`` order (depth first, which
``torch.utils._pytree`` shares for tuples and NamedTuples) plus
``__frames_done__`` and ``__last_theta__``, so checkpoints move between the
two packages in both directions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from beamform_tpu_torch.config import ArrayConfig, EngineConfig
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.utils.profiling import RealTimeMonitor


class StreamingSession:
    """Stateful wrapper around a model's (stream_init, process_chunk)."""

    def __init__(self, model, chunk_frames: Optional[int] = None,
                 monitor=None):
        """``monitor``: None, True (a new ``RealTimeMonitor`` at the
        model's rate) or a monitor, which times every ``process`` call up
        to the moment its output is ready on the model's device."""
        self.model = model
        self.hop = model.engine.hop
        self.chunk_frames = chunk_frames
        self.state = model.stream_init()
        self.frames_done = 0
        self._last_theta = 0.0
        if monitor is True:
            monitor = RealTimeMonitor(model.engine.sample_rate)
        self.monitor = monitor

    def process(self, x_chunk, theta=None, interference=None
                ) -> torch.Tensor:
        """Feed (M, k*hop) samples; returns (k*hop,) output samples on the
        model's device. ``theta``: scalar or per-frame (k,) timeline for
        this chunk; the default holds the previous steering (ROS
        latest-message-wins). ``interference``: optional
        ``InterferenceTimeline`` rows for this chunk (lcmv and gss; the other
        nodes refuse one)."""
        x = torch.as_tensor(x_chunk)
        if x.dim() == 1:
            x = x[None, :]
        if x.shape[-1] % self.hop:
            raise ValueError(f"chunk length {x.shape[-1]} must be a multiple "
                             f"of hop {self.hop}")
        if (self.chunk_frames is not None
                and x.shape[-1] != self.chunk_frames * self.hop):
            raise ValueError(f"chunk length {x.shape[-1]} != chunk_frames "
                             f"{self.chunk_frames} * hop {self.hop}")
        if theta is None:
            theta = self._last_theta
        if self.monitor is not None:
            self.monitor.start_chunk()
        out, self.state = self.model.process_chunk(
            x, theta, self.state, interference=interference)
        if self.monitor is not None:
            # a launch returns before the card is done: the chunk's
            # deadline is met only when its output is ready
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            self.monitor.end_chunk(x.shape[-1])
        self._last_theta = float(np.atleast_1d(
            np.asarray(theta, dtype=np.float64))[-1])
        self.frames_done += x.shape[-1] // self.hop
        return out

    # -- checkpoint / resume ------------------------------------------------

    def save(self, path: str):
        """Checkpoint the full streaming state to an .npz file."""
        leaves, _ = pytree.tree_flatten(self.state)
        arrays = {f"leaf_{i}": v.cpu().numpy() for i, v in enumerate(leaves)}
        arrays["__frames_done__"] = np.asarray(self.frames_done)
        arrays["__last_theta__"] = np.asarray(self._last_theta)
        np.savez(path, **arrays)

    def load(self, path: str):
        """Restore a checkpoint created by :meth:`save` (of either
        package)."""
        refs, spec = pytree.tree_flatten(self.state)
        with np.load(path) as data:
            self.state = pytree.tree_unflatten(
                [torch.as_tensor(data[f"leaf_{i}"]).to(ref)
                 for i, ref in enumerate(refs)], spec)
            self.frames_done = int(data["__frames_done__"])
            self._last_theta = float(data["__last_theta__"])


def open_session(model_name: str, engine: EngineConfig,
                 array_cfg: ArrayConfig, params=None,
                 chunk_frames: Optional[int] = None, *,
                 device) -> StreamingSession:
    model = get_model(model_name, engine, array_cfg, params, device=device)
    return StreamingSession(model, chunk_frames)
