"""Per-chunk control plumbing and the declared multi-stream batching
protocol (counterpart of ``beamform_tpu/models/batching.py``).

Every model declares how it serves B streams at once, so that
``runtime/batch.BatchRunner`` never reaches into model privates:

* ``batch_controls(thetas_bt, interference=None)``: the controls of
  ``batched_forward`` from per-stream ``(B, T)`` theta timelines;
* ``batched_forward(x, ctrl, state)``: the model's one forward, x (B, M,
  S) -> ((B, S) output, new state). DAS, MVDR and LCMV (each solver;
  ``dense`` one Gauss-Jordan launch a block), GSS (``mega``), GSC, phase,
  phasempf and mcra launch each kernel once a chunk for the B streams,
  whose kernels take a stream axis; ``ref`` and ``read``, which have no
  kernel, run their torch ops over a leading stream axis; GSS's CPU-only
  ``scan`` marches the streams in turn;
* ``batched_state_init(batch)``: ``stream_init()`` stacked with a leading
  B, leaves in the JAX package's order, so states convert between the two
  (``convert.state_from_jax``).

A single stream is a batch of one: :meth:`BatchableModel.process_chunk`
(sessions, offline runs, the CLI and the live loop) lifts its chunk, its
controls and its state to B = 1 and calls ``batched_forward``, so a
stream's output does not depend on how many streams share its call.
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
    """Mixin for carry-style models with ``engine``, ``rdtype``, a
    ``device``, ``stream_init()`` and ``batched_forward``."""

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

    def batch_controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> the ``batched_forward``
        controls: (unique thetas (U,) in ``rdtype``, per-(stream, frame)
        index (B, T) int64; (B, 1) for one steering a stream where the model
        has ``collapse_constant_steering``, found on the host), on the
        model's device, cached by the timelines."""
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

    def _controls(self, thetas_bt, interference=None):
        """The ``batched_forward`` controls of (B, T) theta timelines and,
        for the models that take one (LCMV, GSS), an interference timeline
        the streams share; the others refuse a timeline."""
        return self.batch_controls(thetas_bt, interference)

    @torch.no_grad()
    def process_chunk(self, x_chunk, theta, state, interference=None,
                      **forward_kw):
        """Streaming step of one stream, a batch of one: (M, C*hop) (or
        (C*hop,), one channel) in, ((C*hop,) out, new state). ``theta``: a
        scalar or a per-frame timeline (:func:`common.theta_per_frame`);
        ``interference``: optional ``InterferenceTimeline`` rows for this
        chunk (the /theta_interference replacement; LCMV and GSS only).
        The chunk, its controls and its state go to ``batched_forward``
        with a leading stream axis of one."""
        x = torch.as_tensor(x_chunk).to(device=self.device, dtype=self.rdtype)
        if x.dim() == 1:
            x = x[None, :]
        th = common.theta_per_frame(theta, x.shape[-1] // self.engine.hop)
        ctrl = self._controls(th[None], interference)
        out, state = self.batched_forward(
            x[None].contiguous(), ctrl,
            pytree.tree_map(lambda a: a[None], state), **forward_kw)
        return out[0], pytree.tree_map(lambda a: a[0], state)

    def process(self, x, theta=0.0, interference=None) -> torch.Tensor:
        """x: (M, S) -> (S',), S' = S rounded up to a hop multiple: one
        chunk from a fresh state."""
        x = common.prepare_input(x, self.engine, self.rdtype, self.device)
        # GSS's demixing state holds the timeline's interference slots
        kw = ({"capacity": interference.capacity}
              if interference is not None and hasattr(self, "capacity")
              else {})
        out, _ = self.process_chunk(x, theta, self.stream_init(**kw),
                                    interference)
        return out

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
    timeline and each (stream, frame)'s row index, and turns the rows into
    its device constants with ``_control_tensors``. A model with a
    ``capacity`` attribute (GSS: its state holds that many interference
    slots) keeps every slot; the others drop the slots no row uses.

    Batched serving shares one static interference set (one array design,
    many recordings): the unique (theta, interference) control rows are
    shared, the per-frame row index is per stream. A single stream
    (``process_chunk``, a batch of one) may replay an event timeline."""

    def batch_controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> :meth:`_controls` under the
        static interference set."""
        if interference is not None:
            raise ValueError(
                "batched serving shares one static interference set; replay "
                "per-stream event timelines through per-stream sessions")
        return self._controls(thetas_bt)

    def _controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> (``self._control_tensors(
        theta (U,), angles (U, K), active (U, K), row0 (U,))``, the
        per-(stream, frame) row index (B, T) int64, the per-frame reset
        flags (T,) bool); the rows reach the hook on the model's device in
        ``rdtype``, active as 0/1. Without ``interference`` the model's
        static set holds, at its ``capacity`` where it has one, and no
        frame resets. ``interference``, an :class:`InterferenceTimeline` of
        at least T rows that the streams share, replaces the set frame by
        frame (the /theta_interference replacement, lcmv.cpp:258-309), its
        reset flags with it. Without a ``capacity``, slots that no row
        activates are dropped (:func:`trim_inactive_slots`). Cached like
        the JAX model's controls (lcmv.py:371-382), by the theta
        timelines' bytes, the capacity and the interference timeline's four
        arrays' bytes, so a steady control builds its constants once and
        no call uploads host data."""
        th = np.asarray(thetas_bt, np.float64)
        capacity = getattr(self, "capacity", None)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=self.rdtype, device=self.device)

        def static():
            uniq, idx = unique_thetas_bt(th)
            tl = static_interference(len(uniq), self.interf,
                                     capacity=capacity)
            ang, act = tl.angles, tl.active
            if capacity is None:
                ang, act = trim_inactive_slots(ang, act)
            return (self._control_tensors(dev(uniq), dev(ang), dev(act),
                                          dev(tl.row0)),
                    torch.as_tensor(idx, device=self.device),
                    torch.zeros(th.shape[-1:], dtype=torch.bool,
                                device=self.device))

        def replayed():
            b, t = th.shape
            tl = interference
            if tl.angles.shape[0] < t:
                raise ValueError(f"interference timeline has "
                                 f"{tl.angles.shape[0]} frames, the chunk "
                                 f"{t}")
            # each stream's frames read the same timeline rows
            rows = InterferenceTimeline(*(np.concatenate([a[:t]] * b)
                                          for a in _arrays(tl)))
            u_th, u_ang, u_act, u_r0, idx = unique_control_rows(th.ravel(),
                                                                rows)
            if capacity is None:
                u_ang, u_act = trim_inactive_slots(u_ang, u_act)
            return (self._control_tensors(dev(u_th), dev(u_ang),
                                          dev(u_act), dev(u_r0)),
                    torch.as_tensor(idx.astype(np.int64).reshape(b, t),
                                    device=self.device),
                    torch.as_tensor(np.asarray(tl.reset[:t], bool),
                                    device=self.device))

        if interference is None:
            return self._cached(("ctrlb", th.tobytes(), th.shape, capacity),
                                static)
        tlkey = tuple(a.tobytes() for a in _arrays(interference))
        return self._cached(("ctrl", th.tobytes(), th.shape, capacity,
                             tlkey), replayed)


def _arrays(tl: InterferenceTimeline):
    return tl.angles, tl.active, tl.row0, tl.reset


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
