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
  CUDA kernels included where a card is present, as a Chrome trace;
* ``span`` names a stretch of the serving path's host work in that trace.
  While a ``torch.profiler`` records (``trace_to``, or any other profiler
  of the process), each span is a range of that profiler, a ``cpu_op``
  event of its Chrome trace on the same clock as the card's kernels;
  otherwise it is one shared no-op, so an unprofiled call pays a flag read
  and an empty ``with``. ``bf.process``, ``bf.controls`` and
  ``bf.forward`` open in ``BatchRunner.process``; the spans inside the
  model open wherever ``batched_forward`` runs, a single stream's
  ``process_chunk`` (sessions, offline, the CLI, the live loop) included.
  The spans:

  ``bf.process``
      ``BatchRunner.process``, the whole call (``runtime/batch.py``);
  ``bf.controls``
      inside it, the theta timelines' expansion and the model's
      ``batch_controls``, its control cache included;
  ``bf.forward``
      inside it, the model's ``batched_forward``;
  ``bf.steering``
      the steering or constraint build: MVDR's ``_steering_ib`` (every
      call), LCMV's and GSS's ``_control_tensors`` (on a control-cache
      miss only), GSC's ``weights_for_thetas`` in ``batched_forward``
      (every call);
  ``bf.gsc.align``
      GSC's stage-1 product of the B*M spectra with their conjugate
      steering and its reshape to channels (``batched_forward``);
  ``bf.gsc.lookahead``
      GSC's ``gram_refresh`` of the lookahead state after the adaptive
      stage (``_adaptive``, every route);
  ``bf.kernel.<wrapper>``
      a hand-written kernel's wrapper on a CUDA tensor, from its checks
      through its output allocations and the launch to the launch's
      error check (``kernels/*.py``; the plain CPU versions have none):
      ``wola_analysis``, ``wola_synthesis``, ``mvdr_stream``,
      ``lcmv_stream``, ``mega_stream``, ``gss_mega``, ``gj_inverse``,
      ``phase_mask``, ``mpf_march``, ``mcra_march``, ``gsc_sample``,
      ``gsc_xmu``, ``gsc_block``, ``gsc_blocklms``.

  Each wrapper also counts its launches in ``.launches``, with or without
  a profiler.
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
import torch

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


_autograd_profiler = torch.autograd.profiler
if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _recording() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:   # a torch without the Python flag: the C-level one
    _recording = torch._C._autograd._profiler_enabled

#: the range a recorded span opens: the profiler's host-operation range,
#: which a Chrome trace files as ``cpu_op`` among the aten ops it holds
#: (where ``record_function`` files ``user_annotation``), so a reader of
#: the trace's host operations (``portbench/trace.py``) finds the spans
#: there; a torch without it opens ``record_function``
_range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)
#: the one span every call gets while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` records,
    else the shared no-op (it allocates nothing and calls no torch op).
    Use as ``with span("bf.forward"):``; the names are in the module's
    docstring."""
    if _recording():
        return _range(name)
    return _NO_SPAN


def xrt_report(audio_seconds: float, wall_seconds: float) -> str:
    xrt = audio_seconds / wall_seconds if wall_seconds else float("inf")
    return json.dumps({"audio_s": round(audio_seconds, 3),
                       "wall_s": round(wall_seconds, 4),
                       "xrt": round(xrt, 1)})


@contextlib.contextmanager
def trace_to(logdir: str):
    """Record a ``torch.profiler`` trace of the block, CUDA activity
    included when a card is present, and write it to
    ``logdir/trace.json`` (open in chrome://tracing or Perfetto), the
    program's spans (:func:`span`) among the host's events. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
