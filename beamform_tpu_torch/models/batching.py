"""Per-chunk control plumbing shared by the models (the part of
``beamform_tpu/models/batching.py`` that single-stream models need; the
multi-stream batching protocol, ``batch_controls`` included, is queued in
ROADMAP.md §1)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from beamform_tpu_torch.models import common
from beamform_tpu_torch.runtime.timeline import (InterferenceTimeline,
                                                 static_interference,
                                                 unique_control_rows)

CTRL_CACHE_SIZE = 16


class BatchableModel:
    """Mixin for carry-style models with ``rdtype`` and a ``device``."""

    def _cached(self, key, builder):
        """Small LRU memo of device-resident control tensors, so a stream
        that keeps its steering does not rebuild and re-upload the theta
        indices every chunk. LRU: a steering sweep cycling through more
        than ``CTRL_CACHE_SIZE`` keys evicts one entry at a time."""
        cache = self.__dict__.setdefault("_ctrl_cache", OrderedDict())
        if key in cache:
            cache.move_to_end(key)
        else:
            if len(cache) >= CTRL_CACHE_SIZE:
                cache.popitem(last=False)
            cache[key] = builder()
        return cache[key]

    def _theta_ctrl(self, theta, t: int):
        """(unique thetas (U,) in ``rdtype``, per-frame index (T,)) on the
        model's device for a chunk of ``t`` frames."""
        key = ("th", np.asarray(theta, np.float64).tobytes(), t)

        def build():
            th = common.theta_per_frame(theta, t)
            uniq, w_idx = common.unique_thetas(th)
            return (torch.as_tensor(uniq, dtype=self.rdtype,
                                    device=self.device),
                    torch.as_tensor(w_idx, device=self.device))

        return self._cached(key, build)


class BatchableConstrainedModel(BatchableModel):
    """Control rows of the interference-constrained models (LCMV, GSS): a
    model with a static interference set ``interf`` reads, per chunk, the
    unique (theta, interference angles, active, row0) rows of its control
    timeline and each frame's row index, and turns the rows into its device
    constants with ``_control_tensors``. A model with a ``capacity``
    attribute (GSS: its state holds that many interference slots) keeps
    every slot; the others drop the slots no row uses."""

    def _interf_ctrl(self, theta, t: int, interference=None):
        """(``self._control_tensors(theta (U,), angles (U, K), active
        (U, K), row0 (U,))``, the per-frame row index (T,) int64, the
        timeline's per-frame reset flags (T,) bool) for a chunk of ``t``
        frames; the rows reach the hook on the model's device in ``rdtype``,
        active as 0/1. ``interference`` is an :class:`InterferenceTimeline`
        of at least ``t`` rows (the /theta_interference replacement,
        lcmv.cpp:258-309); without one the model's static set holds, at the
        model's ``capacity`` where it has one. Without a ``capacity``, slots
        that no row of the chunk activates are dropped
        (``trim_inactive_slots``). Cached like the JAX model's controls
        (lcmv.py:371-382), by theta's bytes, T, the capacity and the
        timeline's four arrays' bytes, so a steady control builds its
        constants once and no call uploads host data."""
        capacity = getattr(self, "capacity", None)
        tlkey = (None if interference is None else
                 tuple(a.tobytes() for a in (
                     interference.angles, interference.active,
                     interference.row0, interference.reset)))
        key = ("ctrl", np.asarray(theta, np.float64).tobytes(), t, capacity,
               tlkey)

        def build():
            th = common.theta_per_frame(theta, t)
            tl = interference
            if tl is None:
                tl = static_interference(t, self.interf, capacity=capacity)
            if tl.angles.shape[0] < t:
                raise ValueError(f"interference timeline has "
                                 f"{tl.angles.shape[0]} frames, the chunk "
                                 f"{t}")
            tl = InterferenceTimeline(tl.angles[:t], tl.active[:t],
                                      tl.row0[:t], tl.reset[:t])
            u_th, u_ang, u_act, u_r0, idx = unique_control_rows(th, tl)
            if capacity is None:
                u_ang, u_act = trim_inactive_slots(u_ang, u_act)

            def dev(a):
                return torch.as_tensor(np.asarray(a, np.float64),
                                       dtype=self.rdtype, device=self.device)

            return (self._control_tensors(dev(u_th), dev(u_ang),
                                          dev(u_act), dev(u_r0)),
                    torch.as_tensor(idx.astype(np.int64),
                                    device=self.device),
                    torch.as_tensor(np.asarray(tl.reset, bool),
                                    device=self.device))

        return self._cached(key, build)


def trim_inactive_slots(angles: np.ndarray, active: np.ndarray):
    """Drop the trailing interference slots that no row activates: (U, K)
    -> (U, K'), K' one past the last slot any row uses. A slot that is
    inactive in every row adds only an identity block to the LCMV inner
    matrix, so the weights do not change; the solve gets smaller. The
    replayed timelines fill active slots as a prefix, so every unused slot
    trails."""
    used = np.nonzero(np.asarray(active).any(axis=0))[0]
    k = int(used[-1]) + 1 if len(used) else 0
    return angles[:, :k], active[:, :k]
