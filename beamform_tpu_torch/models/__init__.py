"""Model registry: the ten processing nodes of ``beamform_tpu.models``
(``das``, ``mvdr``, ``lcmv``, ``gss``, ``gsc``, ``phase``, ``mcra``,
``phasempf``, ``ref`` and ``read``). The ``write`` node (playback) is not
ported yet (ROADMAP.md §1)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from beamform_tpu_torch.config import ArrayConfig, EngineConfig, make_params
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.models.das import DasModel
from beamform_tpu_torch.models.gsc import GscModel
from beamform_tpu_torch.models.gss import GssModel
from beamform_tpu_torch.models.lcmv import LcmvModel
from beamform_tpu_torch.models.mcra import McraModel
from beamform_tpu_torch.models.mvdr import MvdrModel
from beamform_tpu_torch.models.phase import PhaseModel
from beamform_tpu_torch.models.phasempf import PhasempfModel
from beamform_tpu_torch.models.refmic import ReadModel, RefModel

MODEL_REGISTRY: Dict[str, Any] = {"das": DasModel, "mvdr": MvdrModel,
                                  "lcmv": LcmvModel, "gss": GssModel,
                                  "gsc": GscModel, "phase": PhaseModel,
                                  "mcra": McraModel,
                                  "phasempf": PhasempfModel,
                                  "ref": RefModel, "read": ReadModel}


def get_model(name: str, engine: EngineConfig, array_cfg: ArrayConfig,
              param_overrides: Optional[Dict[str, Any]] = None,
              device="cuda"):
    """Build a model from configs the way a launch file builds a node, with
    its constants on ``device`` (the card by default; without CUDA that
    raises, and ``device="cpu"`` asks for the CPU). LCMV and GSS take the
    config's interference angles as their static set, as in the JAX
    package."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported to beamform_tpu_torch yet; "
            f"ported: {', '.join(MODEL_REGISTRY)} (see ROADMAP.md §1)")
    kw = {}
    if name in ("lcmv", "gss"):
        kw["interference_angles"] = array_cfg.interference_angles
    return MODEL_REGISTRY[name](engine, ArrayGeometry.from_config(array_cfg),
                                make_params(name, param_overrides),
                                device=device, **kw)
