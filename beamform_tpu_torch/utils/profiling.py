"""Run monitoring and tracing: the reference's observability.

The reference times each JACK callback with std::chrono (util.h:13-17),
counts xruns and dumps the count to ~/rosjack_xrun_count.txt at SIGINT
(rosjack.cpp:78-82, 290-300). Here:

* ``RealTimeMonitor`` accounts each chunk's wall time against the audio it
  carries; a chunk that takes longer than its audio misses the real-time
  deadline and counts as an xrun. The caller stops the clock only after the
  chunk's output is ready: on a CUDA device, after a synchronise
  (``StreamingSession`` does this), since a launch returns before the card
  has finished;
* ``xrt_report`` is the audio-seconds-per-second summary line;
* ``trace_to`` records a ``torch.profiler`` trace of a block of code, the
  CUDA kernels included where a card is present, as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# per-chunk wall times kept for the latency percentiles: the newest ones,
# so that an endless live loop holds a bounded history
LATENCY_HISTORY = 1 << 16


@dataclass
class RealTimeMonitor:
    sample_rate: int
    xruns: int = 0
    chunks: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    worst_ratio: float = 0.0
    _t0: Optional[float] = None
    chunk_walls: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_HISTORY))

    def start_chunk(self):
        self._t0 = time.perf_counter()

    def end_chunk(self, num_samples: int):
        if self._t0 is None:
            raise RuntimeError("end_chunk() without start_chunk()")
        wall = time.perf_counter() - self._t0
        self._t0 = None
        audio = num_samples / self.sample_rate
        self.chunks += 1
        self.audio_seconds += audio
        self.wall_seconds += wall
        self.chunk_walls.append(wall)
        ratio = wall / audio if audio > 0 else float("inf")
        self.worst_ratio = max(self.worst_ratio, ratio)
        if wall > audio:
            self.xruns += 1   # missed the real-time deadline

    @property
    def xrt(self) -> float:
        return (self.audio_seconds / self.wall_seconds
                if self.wall_seconds > 0 else float("inf"))

    def report(self) -> dict:
        return {
            "chunks": self.chunks,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "xrt": round(self.xrt, 1),
            "xruns": self.xruns,
            "worst_chunk_ratio": round(self.worst_ratio, 4),
        }

    def latency_ms(self) -> dict:
        """Median, p99 and worst of the kept chunks' wall times, in ms,
        and the worst chunk's index (0 the first chunk timed)."""
        if not self.chunk_walls:
            return {}
        w = np.asarray(self.chunk_walls) * 1e3
        return {"median": float(np.median(w)),
                "p99": float(np.percentile(w, 99)),
                "worst": float(w.max()),
                "worst_at": self.chunks - len(w) + int(w.argmax())}

    def write_xrun_count(self, path: str):
        """The SIGINT dump equivalent (rosjack.cpp:290-300)."""
        with open(path, "w") as f:
            f.write(f"{self.xruns}\n")


def xrt_report(audio_seconds: float, wall_seconds: float) -> str:
    xrt = audio_seconds / wall_seconds if wall_seconds else float("inf")
    return json.dumps({"audio_s": round(audio_seconds, 3),
                       "wall_s": round(wall_seconds, 4),
                       "xrt": round(xrt, 1)})


@contextlib.contextmanager
def trace_to(logdir: str):
    """Record a ``torch.profiler`` trace of the block, CUDA activity
    included when a card is present, and write it to
    ``logdir/trace.json`` (open in chrome://tracing or Perfetto). Yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
