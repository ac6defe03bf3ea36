"""Offline (whole-file) execution: one call runs the whole dataflow graph
the reference spreads over ROS-connected processes."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from beamform_tpu_torch.config import ArrayConfig, EngineConfig
from beamform_tpu_torch.models import get_model


def run_offline(model_name: str, x, *, device,
                engine: Optional[EngineConfig] = None,
                array_cfg: Optional[ArrayConfig] = None, theta=None,
                params: Optional[Dict[str, Any]] = None,
                interference=None) -> np.ndarray:
    """Run one beamformer over a multichannel signal on ``device``.

    x: (M, S) float array. theta: scalar angle in degrees or a per-frame
    timeline (T,), default the config's ``initial_angle``. interference:
    an ``InterferenceTimeline`` for lcmv and gss (the /theta_interference
    replacement; the other nodes refuse one), default the config's static
    interference angles. Returns (S',) with S' = S rounded up to a hop
    multiple; output sample s corresponds to input sample s - hop (one
    window of latency, util.h:276-278).
    """
    engine = engine or EngineConfig()
    if array_cfg is None:
        raise ValueError("array_cfg is required")
    model = get_model(model_name, engine, array_cfg, params, device=device)
    if theta is None:
        theta = array_cfg.initial_angle
    return model.process(x, theta, interference=interference).cpu().numpy()
