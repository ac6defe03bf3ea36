"""Per-chunk control plumbing and the declared multi-stream batching
protocol (counterpart of ``beamform_tpu/models/batching.py``).

Every model declares how it serves B streams at once, so that
``runtime/batch.BatchRunner`` never reaches into model privates:

* ``batch_axes``: for each control argument of ``_forward`` between ``x``
  and ``state``, 0 when it has a leading stream axis, None when the
  streams share it;
* ``batch_controls(thetas_bt, interference=None)``: those control
  arguments from per-stream ``(B, T)`` theta timelines;
* ``batched_forward(x, ctrl, state)``: the batched step, x (B, M, S) ->
  ((B, S) output, new state). Every node overrides it to serve the B
  streams with the launches one stream's call makes: DAS, MVDR and LCMV
  (each solver; ``dense`` one Gauss-Jordan launch a block), GSS (``mega``),
  GSC, phase, phasempf and mcra launch each kernel once a chunk, whose
  kernels take a stream axis; ``ref`` and ``read``, which have no kernel,
  run their torch ops over a leading stream axis. The default, which runs
  ``_forward`` once per stream, is kept for a future model; GSS's CPU-only
  ``scan`` solver takes it;
* ``batched_state_init(batch)``: ``stream_init()`` stacked with a leading
  B, leaves in the JAX package's order, so states convert between the two
  (``convert.state_from_jax``).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from beamform_tpu_torch.models import common
from beamform_tpu_torch.runtime.timeline import (InterferenceTimeline,
                                                 static_interference,
                                                 unique_control_rows)

CTRL_CACHE_SIZE = 16


class BatchableModel:
    """Mixin for carry-style models with ``rdtype``, a ``device``,
    ``stream_init()`` and ``_forward(x, *controls, state)``."""

    #: control args of ``_forward`` between x and state: unique thetas
    #: shared, the per-frame index per stream
    batch_axes = (None, 0)
    #: whether ``batched_forward`` takes a per-stream constant steering as
    #: a (B, 1) index, which broadcasts instead of gathering a (B, T, M, NB)
    #: weight tensor
    collapse_constant_steering = False

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

    def batch_controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> the ``_forward`` controls:
        (unique thetas (U,) in ``rdtype``, per-(stream, frame) index (B, T)
        int64; (B, 1) for one steering a stream where the model has
        ``collapse_constant_steering``, found on the host), on the model's
        device and cached like ``_theta_ctrl``."""
        if interference is not None:
            raise ValueError(
                f"{type(self).__name__} takes no interference timeline")
        th = np.asarray(thetas_bt, np.float64)
        key = ("thb", th.tobytes(), th.shape)

        def build():
            uniq, idx = unique_thetas_bt(th)
            if (self.collapse_constant_steering
                    and (idx == idx[:, :1]).all()):
                idx = idx[:, :1]
            return (torch.as_tensor(uniq, dtype=self.rdtype,
                                    device=self.device),
                    torch.as_tensor(idx, device=self.device))

        return self._cached(key, build)

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """One batched step: x (B, M, S), ctrl from :meth:`batch_controls`,
        state from :meth:`batched_state_init` -> ((B, S) output, new
        state). The default runs ``_forward`` on each stream in turn, with
        its slice of the per-stream controls (``batch_axes``), and stacks
        the outputs and states: every kernel of the model then launches
        once per stream. Every node of the package overrides it (GSS only
        on its ``mega`` path)."""
        outs, states = [], []
        for b in range(x.shape[0]):
            args = [c if ax is None else c[b]
                    for c, ax in zip(ctrl, self.batch_axes)]
            st = pytree.tree_map(lambda a, b=b: a[b], state)
            out, st = self._forward(x[b], *args, st)
            outs.append(out)
            states.append(st)
        return torch.stack(outs), stack_states(states)

    def batched_state_init(self, batch: int):
        """``stream_init()`` with a leading stream axis on every leaf
        (contiguous copies, which the kernels take)."""
        return stack_states([self.stream_init()] * batch)


def stack_states(states):
    """Per-stream states of one structure -> one state whose leaves stack
    them on a leading axis."""
    leaves = [pytree.tree_flatten(s)[0] for s in states]
    spec = pytree.tree_flatten(states[0])[1]
    return pytree.tree_unflatten([torch.stack(ls) for ls in zip(*leaves)],
                                 spec)


def unique_thetas_bt(thetas_bt):
    """(B, T) theta timelines -> (unique thetas (U,) float64, per-(stream,
    frame) index (B, T) int64)."""
    th = np.asarray(thetas_bt, dtype=np.float64)
    uniq, idx = common.unique_thetas(th.ravel())
    return uniq, idx.reshape(th.shape)


class BatchableConstrainedModel(BatchableModel):
    """Control rows of the interference-constrained models (LCMV, GSS): a
    model with a static interference set ``interf`` reads, per chunk, the
    unique (theta, interference angles, active, row0) rows of its control
    timeline and each frame's row index, and turns the rows into its device
    constants with ``_control_tensors``. A model with a ``capacity``
    attribute (GSS: its state holds that many interference slots) keeps
    every slot; the others drop the slots no row uses.

    Batched serving shares one static interference set (one array design,
    many recordings): the unique (theta, interference) control rows are
    shared, the per-frame row index is per stream."""

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

    def batch_controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> (the control tensors of the
        unique thetas under the static interference set, the per-(stream,
        frame) row index (B, T) int64), cached by the timelines."""
        if interference is not None:
            raise ValueError(
                "batched serving shares one static interference set; replay "
                "per-stream event timelines through per-stream sessions")
        th = np.asarray(thetas_bt, np.float64)
        capacity = getattr(self, "capacity", None)
        key = ("ctrlb", th.tobytes(), th.shape, capacity)

        def build():
            uniq, idx = unique_thetas_bt(th)
            tl = static_interference(len(uniq), self.interf,
                                     capacity=capacity)
            ang, act = tl.angles, tl.active
            if capacity is None:
                ang, act = trim_inactive_slots(ang, act)

            def dev(a):
                return torch.as_tensor(np.asarray(a, np.float64),
                                       dtype=self.rdtype, device=self.device)

            return (self._control_tensors(dev(uniq), dev(ang), dev(act),
                                          dev(tl.row0)),
                    torch.as_tensor(idx, device=self.device))

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
