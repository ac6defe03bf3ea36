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
from torch.utils import _pytree as pytree

from beamform_tpu_torch.models.common import WolaCarry


def state_from_jax(leaves: Sequence, like=None, device="cpu"):
    """A JAX model's streaming-state leaves, in ``jax.tree.flatten`` order,
    -> the port's state.

    ``like`` is a port state of the same structure (``model.stream_init()``):
    the leaves fill it in order and take each of its leaves' dtype and
    device. Without ``like`` the leaves are DAS's ``WolaCarry`` (tail
    (M, hop), out_prev (hop,)), placed on ``device``.
    """
    if like is None:
        tail, out_prev = (torch.tensor(np.asarray(a), device=device)
                          for a in leaves)
        return WolaCarry(tail, out_prev)
    refs, spec = pytree.tree_flatten(like)
    if len(leaves) != len(refs):
        raise ValueError(f"{len(leaves)} leaves for a state of "
                         f"{len(refs)}")
    return pytree.tree_unflatten(
        [torch.tensor(np.asarray(a)).to(ref)
         for a, ref in zip(leaves, refs)], spec)


def constants_from_jax(model) -> Dict[str, torch.Tensor]:
    """A JAX model's host constants (``window``, ``freqs``) as a state dict
    for the port model's buffers: ``port.load_state_dict(
    constants_from_jax(jax_model))``."""
    return {name: torch.tensor(np.asarray(getattr(model, name)))
            for name in ("window", "freqs")}
