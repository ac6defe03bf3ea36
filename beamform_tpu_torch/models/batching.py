"""Per-chunk control plumbing shared by the models (the part of
``beamform_tpu/models/batching.py`` that single-stream DAS needs; the
multi-stream batching protocol is queued in ROADMAP.md §1)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from beamform_tpu_torch.models import common

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
