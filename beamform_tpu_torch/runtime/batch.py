"""Batched multi-stream execution: many recordings of one array design on
one card.

Counterpart of ``beamform_tpu/runtime/batch.py``. Every model declares its
own batching (``beamform_tpu_torch.models.batching``): stacked carried
state, a batched step, shared or per-stream control axes. The runner only
consumes that protocol.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from beamform_tpu_torch.config import ArrayConfig, EngineConfig
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.utils.profiling import span


class BatchRunner:
    """Run one model over a batch of streams with batched carried state.

    All streams share the model configuration and geometry; theta may
    differ per stream. Everything model-specific lives behind
    ``batch_controls`` / ``batched_forward`` / ``batched_state_init``. The
    model's constants and state live on ``device`` (the card by default;
    ``device="cpu"`` asks for the CPU).
    """

    def __init__(self, model_name: str, engine: EngineConfig,
                 array_cfg: ArrayConfig,
                 params: Optional[Dict[str, Any]] = None, batch: int = 8,
                 device="cuda"):
        self.model = get_model(model_name, engine, array_cfg, params,
                               device=device)
        self.batch = batch
        self.hop = engine.hop
        self.state = self.model.batched_state_init(batch)

    def process(self, x_batch, theta=0.0) -> torch.Tensor:
        """x_batch: (B, M, k*hop) -> (B, k*hop) outputs on the model's
        device.

        theta: scalar (shared), (B,) per-stream constant angles, or (B, T)
        per-stream timelines.

        Under a profiler the call is the span ``bf.process``, holding
        ``bf.controls`` and ``bf.forward`` (``utils/profiling.py``).
        """
        with span("bf.process"):
            x = torch.as_tensor(x_batch).to(device=self.model.device,
                                            dtype=self.model.rdtype)
            b = x.shape[0]
            if x.dim() != 3 or b != self.batch:
                raise ValueError(f"x_batch must be (B={self.batch}, M, S), "
                                 f"got {tuple(x.shape)}")
            t = x.shape[-1] // self.hop
            with span("bf.controls"):
                th = np.asarray(theta, dtype=np.float64)
                if th.ndim == 0:
                    th = np.full((b, t), float(th))
                elif th.ndim == 1:
                    th = np.repeat(th[:, None], t, axis=1)
                ctrl = self.model.batch_controls(th)
            with span("bf.forward"):
                out, self.state = self.model.batched_forward(
                    x.contiguous(), ctrl, self.state)
            return out
