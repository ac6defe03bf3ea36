"""The 95th percentile over the window's chunks of the time from a chunk's
submission (when it is due, in the closed loop) until its output is on
the host (ms, host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.chunk_ms, 95)) if run.chunk_ms else None
