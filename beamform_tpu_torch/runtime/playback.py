"""The rosjack_write playback role: ROS->JACK decoupling buffer.

The reference's ``rosjack_write`` node plays the ``jackaudio`` topic to the
speakers through a mutex-guarded 50-window circular buffer
(jack_write.cpp:7-10; rosjack.cpp:212-215, 549-577): the ROS subscriber
thread appends message windows at network cadence, the JACK RT callback
pops fixed windows at audio cadence. The buffer has independent write/read
cursors and NO occupancy tracking — an underrunning reader emits silence
(slots are zeroed on read), an overrunning writer silently overwrites the
oldest audio. That lag-adding decoupling is the whole point of the node
(jack_write.cpp:7-10).

Faithful detail: the reference wraps its cursors with ``> size`` instead of
``>= size`` (rosjack.cpp:553-556, 566-571), so they visit ``size + 1``
distinct slots — one past its own malloc. We allocate that slot for real;
the visible ring period is identical.
"""

from __future__ import annotations

import numpy as np


class Ros2JackBuffer:
    """Single-producer single-consumer decoupling ring, reference semantics.

    ``push`` never blocks and never fails (old audio is overwritten);
    ``pop`` never blocks and never fails (missing audio reads as the zeros
    left behind by previous pops). Counters expose both conditions for
    observability the reference lacks.
    """

    def __init__(self, window_size: int, windows: int = 50):
        # rosjack.cpp:213: jack_get_buffer_size(client) * 50
        self.size = int(window_size) * int(windows)
        self._buf = np.zeros(self.size + 1, dtype=np.float32)  # see module doc
        self._w = 0
        self._r = 0
        self.pushed = 0
        self.popped = 0

    @property
    def _period(self) -> int:
        return self.size + 1

    def _fill(self) -> int:
        """Windows of un-popped audio currently buffered (diagnostic)."""
        return (self._w - self._r) % self._period

    def push(self, data) -> None:
        """Append one audio message (rosjack_roscallback, rosjack.cpp:549)."""
        data = np.asarray(data, dtype=np.float32).ravel()
        n = len(data)
        if self.pushed + n - self.popped > self.size:
            self.overwrites = getattr(self, "overwrites", 0) + 1
        idx = (self._w + np.arange(n)) % self._period
        self._buf[idx] = data
        self._w = int((self._w + n) % self._period)
        self.pushed += n

    def pop(self, n: int) -> np.ndarray:
        """Take ``n`` samples for the audio callback, zeroing consumed slots
        (input_from_ros2jack_buffer, rosjack.cpp:562-577)."""
        idx = (self._r + np.arange(n)) % self._period
        out = self._buf[idx].copy()
        self._buf[idx] = 0.0
        self._r = int((self._r + n) % self._period)
        self.popped += n
        if self.popped > self.pushed:
            self.underruns = getattr(self, "underruns", 0) + 1
        return out


def play_stream(windows, window_size: int, *, buffer_windows: int = 50,
                consumer_lead: int = 0):
    """Offline emulation of the write node: feed ``windows`` (iterable of
    hop-sized float arrays) through the decoupling buffer one
    message/callback pair at a time; returns the played stream.

    ``consumer_lead``: callbacks that fire before the first message arrives
    (JACK starts as soon as the client activates — rosjack.cpp:222) — each
    one plays a window of silence, exactly the lag the reference node adds.
    """
    buf = Ros2JackBuffer(window_size, buffer_windows)
    out = []
    for _ in range(consumer_lead):
        out.append(buf.pop(window_size))
    for w in windows:
        buf.push(w)
        out.append(buf.pop(window_size))
    if consumer_lead:
        # a consumer that started early sits mid-ring; draining one full
        # ring period guarantees every written slot has been played
        for _ in range(buf.size // window_size + 2):
            out.append(buf.pop(window_size))
    return np.concatenate(out) if out else np.zeros(0, np.float32)
