"""Move state and constants from the JAX package's models into the port's.

Both helpers take plain numpy data (or anything ``np.asarray`` accepts), so
this module imports no JAX: a caller that holds a JAX model hands over its
arrays. DAS has no learned weights; its steering is derived from geometry
and compared directly by the tests.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from beamform_tpu_torch.models.common import WolaCarry


def state_from_jax(leaves: Sequence, device="cpu") -> WolaCarry:
    """The JAX ``WolaCarry``'s leaves in order (tail (M, hop), out_prev
    (hop,)) -> the port's :class:`WolaCarry` on ``device``."""
    tail, out_prev = (torch.tensor(np.asarray(a), device=device)
                      for a in leaves)
    return WolaCarry(tail, out_prev)


def constants_from_jax(model) -> Dict[str, torch.Tensor]:
    """A JAX model's host constants (``window``, ``freqs``) as a state dict
    for the port model's buffers: ``port.load_state_dict(
    constants_from_jax(jax_model))``."""
    return {name: torch.tensor(np.asarray(getattr(model, name)))
            for name in ("window", "freqs")}
