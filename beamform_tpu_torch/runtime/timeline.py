"""Control-plane timelines: the ROS topics become per-frame arrays.

The reference's steering control is two topics:

* ``/theta`` (std_msgs/Float32) — handled everywhere as a scalar-or-array
  theta timeline (see models' ``process``).
* ``/theta_interference`` (beamform/InterfTheta {id, angle}) — LCMV/GSS
  only, with add/move/remove semantics (lcmv.cpp:258-309, gss.cpp:288-339):

  - id in [1, K]: move interference ``id`` to ``angle``; if the new angle is
    within ``interf_angle_threshold`` of another interference, interference
    ``id`` is REMOVED instead (the vector shrinks; later ids shift down);
  - id > K: treated as a new interference; added unless within threshold of
    an existing one;
  - id < 1: ignored.

  Structural changes (add/remove) make the reference reallocate its
  constraint buffers under READY=false + 30 ms of silence
  (lcmv.cpp:271-276); since ``update_weights(ini=false)`` never writes
  constraint row 0 on the freshly zeroed buffers, the mic0 row stays ZERO
  from the first structural event on (the row0 quirk).

This module replays an event list into dense per-frame arrays for a
fixed-capacity masked constraint set — constant shapes, no reallocation, no
quiesce gap. The reference's 30 ms of silence during reallocation is a
synchronization artifact and is not reproduced.

A jax-free copy of ``beamform_tpu/runtime/timeline.py`` (numpy only), so
the port's LCMV and CLI read the same timelines; the tests hold the two
modules to equal outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

MAX_INTERFERENCES = 15  # the YAML ships 15 slots (beamform_config.yaml:44-57)


@dataclass
class InterfEvent:
    """One /theta_interference message at a point in the stream."""

    frame: int      # frame index at which the message lands
    id: int         # 1-based interference id (reference convention)
    angle: float    # degrees


@dataclass
class InterferenceTimeline:
    """Dense per-frame interference state for LCMV/GSS.

    angles:  (T, K) float64 — slot angles (value irrelevant when inactive)
    active:  (T, K) bool    — slot occupancy
    row0:    (T,)  float64  — mic0 constraint-row scale (1.0 until the first
                              structural event, then 0.0: the realloc quirk)
    reset:   (T,)  bool     — frames where the reference called
                              update_weights due to an interference message
                              (GSS resets its demixing matrices there)
    """

    angles: np.ndarray
    active: np.ndarray
    row0: np.ndarray
    reset: np.ndarray

    @property
    def capacity(self) -> int:
        return self.angles.shape[1]


class InterferenceMachine:
    """Incremental interf_theta_roscallback state machine
    (lcmv.cpp:258-309, gss.cpp:288-339) — the live-control counterpart of
    :func:`replay_interference_events`, which replays a full event list
    through one of these. Apply messages as they arrive; read out dense
    timeline rows per chunk."""

    def __init__(self, initial_angles: Sequence[float], *,
                 threshold: float = 5.0,
                 capacity: int = MAX_INTERFERENCES,
                 bug_row0_zero_after_realloc: bool = True):
        self.cur: List[float] = list(initial_angles)
        if len(self.cur) > capacity:
            raise ValueError(f"{len(self.cur)} initial interferences exceed "
                             f"the capacity {capacity}")
        self.threshold = float(threshold)
        self.capacity = int(capacity)
        self.row0_now = 1.0
        self._bug_row0 = bug_row0_zero_after_realloc

    def apply(self, id: int, angle: float) -> bool:
        """One InterfTheta message; returns True when the reference would
        have called update_weights (GSS resets its demixing state there)."""
        k = len(self.cur)
        if 1 <= id <= k:
            self.cur[id - 1] = angle                     # move
            removed = False
            for i in range(len(self.cur)):
                if i != id - 1 and abs(self.cur[i] - angle) < self.threshold:
                    del self.cur[id - 1]                 # proximity removal
                    removed = True
                    break
            if removed and self._bug_row0:
                self.row0_now = 0.0
            return True                                  # update_weights()
        if id > k:
            too_close = any(abs(a - angle) < self.threshold
                            for a in self.cur)
            if not too_close and len(self.cur) < self.capacity:
                self.cur.append(angle)                   # add
                if self._bug_row0:
                    self.row0_now = 0.0
                return True                              # update_weights()
        # id < 1: invalid, ignored (lcmv.cpp:306-308)
        return False

    def rows(self, num_frames: int,
             reset_first: bool = False) -> InterferenceTimeline:
        """Dense rows holding the current state for ``num_frames`` frames;
        ``reset_first`` marks frame 0 as an update_weights frame (a message
        landed at this chunk boundary)."""
        angles = np.zeros((num_frames, self.capacity), dtype=np.float64)
        active = np.zeros((num_frames, self.capacity), dtype=bool)
        angles[:, :len(self.cur)] = self.cur
        active[:, :len(self.cur)] = True
        row0 = np.full((num_frames,), self.row0_now, dtype=np.float64)
        reset = np.zeros((num_frames,), dtype=bool)
        if reset_first and num_frames:
            reset[0] = True
        return InterferenceTimeline(angles, active, row0, reset)


def replay_interference_events(
        num_frames: int,
        initial_angles: Sequence[float],
        events: Sequence[InterfEvent],
        *,
        threshold: float = 5.0,
        capacity: int = MAX_INTERFERENCES,
        bug_row0_zero_after_realloc: bool = True) -> InterferenceTimeline:
    """Replay the reference's interf_theta_roscallback state machine
    (lcmv.cpp:258-309) into dense per-frame arrays."""
    angles = np.zeros((num_frames, capacity), dtype=np.float64)
    active = np.zeros((num_frames, capacity), dtype=bool)
    row0 = np.ones((num_frames,), dtype=np.float64)
    reset = np.zeros((num_frames,), dtype=bool)

    sm = InterferenceMachine(
        initial_angles, threshold=threshold, capacity=capacity,
        bug_row0_zero_after_realloc=bug_row0_zero_after_realloc)
    ev_sorted = sorted(events, key=lambda e: e.frame)
    ei = 0
    for t in range(num_frames):
        while ei < len(ev_sorted) and ev_sorted[ei].frame <= t:
            e = ev_sorted[ei]
            ei += 1
            if sm.apply(e.id, e.angle):
                reset[t] = True                          # update_weights()
        angles[t, :len(sm.cur)] = sm.cur
        active[t, :len(sm.cur)] = True
        row0[t] = sm.row0_now
    return InterferenceTimeline(angles, active, row0, reset)


def static_interference(num_frames: int, angles: Sequence[float],
                        capacity: Optional[int] = None
                        ) -> InterferenceTimeline:
    """A constant interference set (the config-YAML startup state).
    Capacity defaults to exactly len(angles) — zero slots is valid (a pure
    MVDR-like constraint set)."""
    cap = capacity if capacity is not None else len(angles)
    return replay_interference_events(num_frames, angles, [], capacity=cap)


def unique_control_rows(theta: np.ndarray, tl: InterferenceTimeline):
    """Collapse per-frame (theta, interference set, row0) rows to unique
    combinations + per-frame index — the same memory-saving trick as
    unique_thetas, generalized to the full control state."""
    rows = np.concatenate(
        [theta[:, None], tl.angles, tl.active.astype(np.float64),
         tl.row0[:, None]], axis=1)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    k = tl.capacity
    u_theta = uniq[:, 0]
    u_angles = uniq[:, 1:1 + k]
    u_active = uniq[:, 1 + k:1 + 2 * k] > 0.5
    u_row0 = uniq[:, 1 + 2 * k]
    return (u_theta, u_angles, u_active, u_row0,
            np.asarray(inv, dtype=np.int32))
